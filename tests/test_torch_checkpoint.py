"""The port's run layer against shakti_tpu's: window grouping and the
rolling-checkpoint cadence (the cases of tests/test_api.py), checkpoints in
the JAX package's format, resume bit-exact within the port (with and
without the lag carry), the float64 bootstrap's checkpoints (the cases of
tests/test_bootstrap.py) and the Cook_E2 setup.  Resume across the two
packages: tests/test_torch_resume_jax.py."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from shakti_tpu.api import run as jrun
from shakti_tpu.io import checkpoint as jckpt
from shakti_tpu_torch.api import run as trun
from shakti_tpu_torch.io import checkpoint as tckpt
from shakti_tpu_torch.setups import setup_slab as tslab
from tests.torch_parity import rel_err

KEYS = ("N", "b", "qx", "qy")


def _tmd(tmp_path, name, dtype=torch.float64, **solver):
    """The port's slab 8x8, 5 days at 4 steps a day (20 steps), on the CPU."""
    md = tslab.initialize(nx=8, ny=8, days=5.0, nt_per_day=4,
                          results_name=str(tmp_path / name))
    md.device, md.dtype = "cpu", dtype
    if solver:
        md.solver = dataclasses.replace(md.solver, **solver)
    return md


def _half(md):
    md.nt_check = 2 * md.nt_save
    md.timesteps = md.timesteps[: md.timesteps.size // 2 + 1]
    return md


def test_group_windows_and_ck_due_equal_jax():
    cases = [(101, 4, 16, 8, 0), (97, 24, 1200, 25, 0), (50, 4, 8, 64, 9),
             (10, 1, 5, 3, 0), (25, 24, 48, 4, 0), (101, 4, 10, 8, 0),
             (120, 24, 30, 25, 0), (60, 8, 3, 4, 5)]
    for nt, nt_save, nt_check, max_g, start in cases:
        ws = list(trun._save_windows(nt, nt_save, start))
        assert ws == list(jrun._save_windows(nt, nt_save, start))
        grps = list(trun._group_windows(ws, nt_check, max_g))
        assert grps == list(jrun._group_windows(ws, nt_check, max_g))
        assert [w for g in grps for w in g] == ws
        for g in grps:
            assert len(g) <= max_g
            for w in g[:-1]:
                assert not trun._ck_due(w[0], w[0] + w[1] - 1, nt_check)
        for i0 in range(start, nt):
            for last in range(i0, min(nt, i0 + 30)):
                assert (trun._ck_due(i0, last, nt_check)
                        == jrun._ck_due(i0, last, nt_check))


def test_grouped_run_matches_singleton(tmp_path, monkeypatch):
    """Grouping changes when save rows reach the host, nothing else: the
    grouped run equals SHAKTI_RUN_GROUP=1 bit for bit, with fewer pulls."""
    out1 = _tmd(tmp_path, "grp_auto").solve(progress=False)
    monkeypatch.setenv("SHAKTI_RUN_GROUP", "1")
    out2 = _tmd(tmp_path, "grp_one").solve(progress=False)
    assert torch.equal(out1["state"].N, out2["state"].N)
    assert torch.equal(out1["state"].b, out2["state"].b)
    for k in KEYS:
        np.testing.assert_array_equal(out1["history"][k], out2["history"][k])
    assert out1["newton_iters_total"] == out2["newton_iters_total"]
    assert out1["cg_iters_total"] == out2["cg_iters_total"]
    log1 = (tmp_path / "grp_auto" / "log.csv").read_text().splitlines()
    log2 = (tmp_path / "grp_one" / "log.csv").read_text().splitlines()
    assert log1 == log2 and len(log1) == 1 + 5
    # saves after steps 0, 4, 8, 12, 16: one pull for the first window, one
    # for the group of the four 4-step windows (checkpoints every 200 steps)
    assert (out1["host_pulls"], out2["host_pulls"]) == (2, 5)


def test_rolling_checkpoints_fire_on_misaligned_cadence(tmp_path, monkeypatch):
    calls = []
    real = trun.ckpt.save_state

    def spy(rdir, state, next_step, next_row, **kw):
        calls.append((next_step, kw.get("include_lag", True)))
        return real(rdir, state, next_step, next_row, **kw)

    monkeypatch.setattr(trun.ckpt, "save_state", spy)
    md = _tmd(tmp_path, "ckpt_misaligned")
    md.nt_save, md.nt_check = 4, 6                     # nt = 20
    md.solve(progress=False)
    assert [s for s, lag in calls if not lag] == [1, 9, 13]
    assert [s for s, lag in calls if lag] == [20]


@pytest.mark.parametrize("lag", [True, False], ids=["lag", "nolag"])
def test_resume_bit_exact(tmp_path, lag):
    """Half the run, then a resume to the end, equals the uninterrupted run
    bit for bit; the histories grow through the .new path and keep their
    early rows."""
    solver = dict(lag_operator=lag, adaptive_dt_levels=0)
    full = _tmd(tmp_path, "full", **solver).solve(progress=False)
    assert (full["state"].lag_op is not None) == lag
    part = _half(_tmd(tmp_path, "split", **solver)).solve(progress=False)
    md = _tmd(tmp_path, "split", **solver)
    md.nt_check = 2 * md.nt_save
    out = md.solve(resume=True, progress=False)
    assert out["steps"] == 20 - 11
    assert torch.equal(out["state"].N, full["state"].N)
    assert torch.equal(out["state"].b, full["state"].b)
    assert torch.equal(out["state"].q, full["state"].q)
    for k in KEYS:
        np.testing.assert_array_equal(out["history"][k], full["history"][k])
        np.testing.assert_array_equal(np.load(tmp_path / "split" / f"{k}.npy"),
                                      full["history"][k])
        np.testing.assert_array_equal(full["history"][k][:3],
                                      part["history"][k])
    if lag:
        la, lb = full["state"].lag_op, out["state"].lag_op
        assert la[:2] == lb[:2] and torch.equal(la[2], lb[2])
    log = (tmp_path / "split" / "log.csv").read_text().splitlines()[1:]
    assert [int(r.split(",")[0]) for r in log] == [0, 4, 8, 12, 16]
    meta = json.loads((tmp_path / "split" / "run_meta.json").read_text())
    assert meta["resumed_from"] == 11 and meta["steps"] == 9


def test_checkpoint_keys_and_dtypes_equal_jax(tmp_path):
    """save_state writes the JAX package's keys with its dtypes, lag
    included, and each package's load_state reads the other's file."""
    md = _tmd(tmp_path, "keys", dtype=torch.float32)
    md.timesteps = md.timesteps[:6]
    out = md.solve(progress=False)
    z = dict(np.load(tmp_path / "keys" / "checkpoint.npz"))
    assert set(z) == {"N", "b", "q", "melt", "N_prev", "n_nodes", "next_step",
                      "next_row", "mesh_crc", "lag_ok", "lag_age", "lag_vals",
                      "lag_adiag", "lag_Ainv", "lag_floor", "lag_floor_age"}
    # the same state written by shakti_tpu's own save_state
    st = jckpt.load_state(str(tmp_path / "keys"), dtype=np.float32)[0]
    os.makedirs(tmp_path / "jax_keys")
    jckpt.save_state(str(tmp_path / "jax_keys"), st, 6, 2,
                     fingerprint=jckpt.mesh_fingerprint(md.nodes))
    zj = dict(np.load(tmp_path / "jax_keys" / "checkpoint.npz"))
    assert set(zj) == set(z)
    for k in z:
        assert z[k].dtype == zj[k].dtype and z[k].shape == zj[k].shape, k
        np.testing.assert_array_equal(z[k], zj[k], err_msg=k)
    back, nxt, row = tckpt.load_state(str(tmp_path / "jax_keys"),
                                      dtype=torch.float32)
    assert (nxt, row) == (6, 2)
    assert back.lag_op[:2] == out["state"].lag_op[:2]
    assert torch.equal(back.lag_op[2], out["state"].lag_op[2])
    assert tckpt.mesh_fingerprint(md.nodes) == jckpt.mesh_fingerprint(md.nodes)


def test_resume_refuses_another_mesh(tmp_path):
    md = _tmd(tmp_path, "fp")
    md.timesteps = md.timesteps[:3]
    md.solve(progress=False)
    other = tslab.initialize(nx=9, ny=8, days=5.0, nt_per_day=4,
                             results_name=str(tmp_path / "fp"))
    other.device, other.dtype = "cpu", torch.float64
    with pytest.raises(ValueError, match="different mesh"):
        other.solve(resume=True, progress=False)
    # no checkpoint: a resume starts afresh, and refuses an existing dir
    fresh = _tmd(tmp_path, "fresh")
    fresh.timesteps = fresh.timesteps[:3]
    assert fresh.solve(resume=True, progress=False)["steps"] == 3
    os.remove(tmp_path / "fresh" / "checkpoint.npz")
    with pytest.raises(FileExistsError):
        fresh.solve(resume=True, progress=False)


def test_lag_reseeded_under_another_format(tmp_path):
    """A checkpoint's carry written in block-ELL does not fit block-CSR with
    the carry on: it is reseeded, the first resumed step rebuilds, and the
    run ends where the uninterrupted one does to solver tolerance."""
    full = _tmd(tmp_path, "bell_full").solve(progress=False)
    _half(_tmd(tmp_path, "re")).solve(progress=False)
    md = _tmd(tmp_path, "re", lag_operator=True)
    md.operator, md.operator_block = "bcsr", 16
    md.nt_check = 2 * md.nt_save
    out = md.solve(resume=True, progress=False)
    lag = out["state"].lag_op
    mesh = md.freeze()[0]
    assert mesh.bcsr_B == 16
    assert lag[0] and lag[2].shape == mesh.nz_col.shape
    assert rel_err(out["state"].N.numpy(), full["state"].N.numpy()) <= 1e-8


# ---------------------------------------------------------------- bootstrap
def _boot_md(tmp_path, name, dtype, boot):
    md = tslab.initialize(nx=8, ny=8, days=5.0, nt_per_day=4,
                          results_name=str(tmp_path / name))
    md.device, md.dtype, md.bootstrap_steps = "cpu", dtype, boot
    return md


def test_bootstrap_resume_log_covers_each_save_once(tmp_path):
    md = _boot_md(tmp_path, "bres", torch.float32, 3)
    md.solve(progress=False)
    log = (tmp_path / "bres" / "log.csv").read_text().strip().splitlines()
    steps = [int(r.split(",")[0]) for r in log[1:]]
    assert steps == [0, 4, 8, 12, 16]


def test_kill_after_bootstrap_resumes_from_boot_boundary(tmp_path, monkeypatch):
    """The bootstrap replay writes no rolling checkpoint; the first one is
    the boundary's (next_step 5), and a kill right after it resumes to the
    uninterrupted run exactly."""
    full = _boot_md(tmp_path, "full", torch.float32, 3)
    full.nt_check = 4
    full.solve(progress=False)
    calls = []
    real = trun.ckpt.save_state

    def dying(rdir, state, next_step, next_row, **kw):
        calls.append(int(next_step))
        real(rdir, state, next_step, next_row, **kw)
        raise KeyboardInterrupt

    monkeypatch.setattr(trun.ckpt, "save_state", dying)
    kill = _boot_md(tmp_path, "kill", torch.float32, 3)
    kill.nt_check = 4
    with pytest.raises(KeyboardInterrupt):
        kill.solve(progress=False)
    monkeypatch.setattr(trun.ckpt, "save_state", real)
    assert calls == [5]
    _, nxt, row = tckpt.load_state(str(tmp_path / "kill"), dtype=torch.float32)
    assert (nxt, row) == (5, 2)
    res = _boot_md(tmp_path, "kill", torch.float32, 3)
    res.nt_check = 4
    res.solve(resume=True, progress=False)
    for k in KEYS:
        np.testing.assert_array_equal(np.load(tmp_path / "kill" / f"{k}.npy"),
                                      np.load(tmp_path / "full" / f"{k}.npy"))


# ---------------------------------------------------------------- Cook_E2
@pytest.mark.parametrize("env", ["synthetic", "committed_mesh_reference_binit"])
def test_setup_cooke2_equals_jax(monkeypatch, env):
    import setups.setup_cooke2 as jsc
    from shakti_tpu_torch.setups import setup_cooke2 as tsc
    if env != "synthetic":
        monkeypatch.setenv("SHAKTI_MESH_DIR", "assets/cooke2_synth")
        monkeypatch.setenv("SHAKTI_REFERENCE_BINIT", "1")
    jmd, tmd = jsc.initialize(days=3), tsc.initialize(days=3)
    for k in ("nodes", "cells", "inputs", "b_init", "N_init", "lake_bdry",
              "timesteps"):
        np.testing.assert_array_equal(np.asarray(getattr(tmd, k)),
                                      np.asarray(getattr(jmd, k)), err_msg=k)
    # interpolated fields: the original may take its native library's path
    for k in ("z_b", "z_s", "G"):
        ref = np.asarray(getattr(jmd, k))
        np.testing.assert_allclose(getattr(tmd, k), ref, rtol=0,
                                   atol=1e-14 * np.abs(ref).max(), err_msg=k)
    for k in ("N_bdry", "nt_save", "nt_check", "results_name", "bootstrap_steps"):
        assert getattr(tmd, k) == getattr(jmd, k), k
    np.testing.assert_array_equal(tmd.dirichlet_nodes(), jmd.dirichlet_nodes())
    assert tmd.bootstrap_steps == (24 if env != "synthetic" else 0)


def test_setup_cooke2_refuses_unported_datasets(monkeypatch, tmp_path):
    """A dataset file the readers cannot read (an empty bed.nc) raises what
    the JAX setup raises; a variable naming no file takes the synthetic
    fields."""
    import setups.setup_cooke2 as jsc
    from shakti_tpu_torch.setups import setup_cooke2 as tsc
    data = tmp_path / "bed.nc"
    data.write_bytes(b"")
    monkeypatch.setenv("SHAKTI_BEDMACHINE", str(data))
    with pytest.raises(Exception) as ref:
        jsc.initialize(days=1)
    with pytest.raises(type(ref.value)) as got:
        tsc.initialize(days=1)
    assert type(got.value) is type(ref.value)
    monkeypatch.setenv("SHAKTI_BEDMACHINE", str(tmp_path / "missing.nc"))
    assert tsc.initialize(days=1).nodes.shape == (2601, 2)
