"""The plain reference against the port on the CPU, in float64, on the
synthetic Cook_E2 catchment of the port's setup (2,601 nodes with a lake,
storage and the outflow boundary): a single run and a 4-member ensemble.  And
the configuration's inputs, made by the benchmark, against the port's
setups/setup_cooke2 on the real mesh."""

import numpy as np
import pytest
import torch

from benchmarks.harness import assets, bench, spec
from benchmarks.reference import shakti_ref as ref


def small(small_assets, dtype="float64", members=4):
    """cooke2-ens128 on the small catchment with ``members`` members; one
    member is a single run through the port's make_step_fn."""
    cell = spec.load_cell("cooke2-ens128")
    mesh, lake = small_assets
    cell.settings.update(mesh_file=str(mesh), lake_outline_file=str(lake),
                         dtype=dtype)
    cell.traffic.update(members=members)
    return cell


@pytest.mark.parametrize("members", [1, 4])
def test_reference_step_is_the_ports(members, small_assets):
    torch.set_num_threads(2)
    model = bench.Model(small(small_assets, members=members), "cpu")
    prob = bench.reference_problem(model.fields, "cpu")
    assert prob.dirichlet.any() and prob.storage_q.abs().max() > 0
    inputs = model.inputs(20_000_000_017)
    state = model.program_state(inputs)
    s = {k: torch.as_tensor(v) for k, v in inputs.items()}
    dt0, dt = model.dts()
    for d in (dt0, dt, dt):
        state, diag = model.step(state, torch.tensor(d, dtype=torch.float64))
        assert np.all(diag["converged"])
        u = model.user_state(state)
        assert u["N"].shape[0] == members
        for m in range(members):
            before = {k: v[m] for k, v in s.items()}
            mine = ref.step(prob, before, d)
            for f in ("N", "b", "q", "melt"):
                err = (u[f][m] - mine[f]).abs().max() / mine[f].abs().max()
                # the port's Newton stops at rtol 1e-9 of the first residual
                assert err < 1e-7, (f, float(err))
            r = ref.judge(prob, before, {k: v[m] for k, v in u.items()}, d)
            assert r["n_resid"] < 1e-9 and r["b_err"] < 1e-9, r
        s = u


def test_fields_are_setup_cooke2s(monkeypatch):
    """On the real mesh: the same nodes, triangles, lake, outflow nodes
    and initial gap as the port's setup, and the synthetic fields that its
    setup interpolates from a grid, evaluated exactly."""
    from shakti_tpu_torch.mesh import geometry
    from shakti_tpu_torch.setups import setup_cooke2
    cell = spec.load_cell("cooke2-ens128")
    s, fv = cell.settings, cell.config.fields(cell.settings)
    monkeypatch.setenv("SHAKTI_MESH_DIR", str(spec.ROOT / "assets" /
                                              "cooke2_synth"))
    md = setup_cooke2.initialize(days=1, results_name=None)
    assert fv["nodes"].shape == (s["n_nodes"], 2)
    assert fv["cells"].shape == (s["n_cells"], 3)
    np.testing.assert_array_equal(fv["nodes"], md.nodes)
    np.testing.assert_array_equal(fv["cells"], md.cells)
    np.testing.assert_array_equal(fv["storage"], md.lake_bdry)
    assert fv["storage"].sum() > 0
    np.testing.assert_allclose(fv["z_b"], md.z_b, atol=1.0)
    np.testing.assert_allclose(fv["z_s"], md.z_s, atol=1.0)
    np.testing.assert_allclose(fv["G"], md.G, atol=1e-4)
    mine = ref.dirichlet_nodes(fv["nodes"], fv["cells"], fv["outflow"])
    port = ref.dirichlet_nodes(md.nodes, md.cells, md.OutflowBoundary)
    assert mine.sum() > 0 and (mine != port).sum() <= 0.05 * port.sum()
    traffic = dict(members=2, b_scale=0.0)
    b = cell.config.initial(
        fv, s, traffic, np.random.default_rng(1))["b"]
    np.testing.assert_array_equal(b, np.stack([md.b_init] * 2))
    inside = geometry.points_in_polygon(md.nodes, md.outline)
    np.testing.assert_array_equal(
        assets.points_in_polygon(md.nodes, md.outline), inside)


def test_dirichlet_nodes_of_a_square():
    nodes = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5]], float)
    cells = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]])
    west = ref.dirichlet_nodes(nodes, cells, lambda p: p[:, 0] < 1e-9)
    assert west.tolist() == [True, False, False, True, False]
