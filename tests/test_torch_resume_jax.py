"""Resume across the two packages and the float64 bootstrap against
shakti_tpu: a checkpoint.npz written by either package, resumed by the
other, ends at the uninterrupted JAX run to 1e-10 of scale; the rows the
port's bootstrap covers are JAX's float64 trajectory cast to float32, and
the bootstrap marches in float64 on the run's own device."""

import numpy as np
import pytest
import torch

import setups.setup_slab as jslab
from shakti_tpu.api import run as jrun
from shakti_tpu_torch.api import run as trun
from tests.test_torch_checkpoint import KEYS, _boot_md, _half, _tmd
from tests.torch_parity import rel_err


def _jmd(tmp_path, name):
    """The model of test_torch_checkpoint._tmd in shakti_tpu (float64), in
    block-ELL like the port, so both keep the same node order."""
    md = jslab.initialize(nx=8, ny=8, days=5.0, nt_per_day=4,
                          results_name=str(tmp_path / name))
    md.operator = "bell"
    return md


@pytest.fixture(scope="module")
def jax_full(tmp_path_factory):
    """shakti_tpu's uninterrupted float64 run (the cross-package reference)."""
    out = jrun.solve(_jmd(tmp_path_factory.mktemp("jax"), "full"),
                     progress=False)
    return {"N": np.asarray(out["state"].N), "b": np.asarray(out["state"].b),
            "history": {k: np.asarray(v) for k, v in out["history"].items()}}


@pytest.mark.parametrize("direction", ["jax_then_torch", "torch_then_jax"])
def test_resume_across_packages(tmp_path, jax_full, direction):
    """A checkpoint written by one package, resumed by the other, ends at
    the uninterrupted JAX run to 1e-10 of scale (histories included)."""
    if direction == "jax_then_torch":
        jrun.solve(_half(_jmd(tmp_path, "x")), progress=False)
        md = _tmd(tmp_path, "x")
        md.nt_check = 2 * md.nt_save
        out = md.solve(resume=True, progress=False)
        N, b = out["state"].N.numpy(), out["state"].b.numpy()
        hist = out["history"]
        N, b = md.to_user_order(N), md.to_user_order(b)
    else:
        _half(_tmd(tmp_path, "x")).solve(progress=False)
        md = _jmd(tmp_path, "x")
        md.nt_check = 2 * md.nt_save
        out = jrun.solve(md, resume=True, progress=False)
        N, b = np.asarray(out["state"].N), np.asarray(out["state"].b)
        hist = out["history"]
        unp = md.node_iperm
        N, b = N[unp], b[unp]
    assert out["steps"] == 20 - 11
    unp = _jmd(tmp_path, "unused")
    unp.freeze()
    assert rel_err(N, jax_full["N"][unp.node_iperm]) <= 1e-10
    assert rel_err(b, jax_full["b"][unp.node_iperm]) <= 1e-10
    for k in KEYS:
        assert rel_err(np.asarray(hist[k]), jax_full["history"][k]) <= 1e-10, k


def test_bootstrap_rows_match_pure_f64_run(tmp_path, jax_full, monkeypatch):
    """The rows the bootstrap covers are the float64 trajectory cast to
    float32 (the port's own float64 run and shakti_tpu's); the bootstrap
    marched in float64 on the run's device; the rest is float32."""
    states = []
    real = trun._bootstrap_f64

    def spy(*a):
        out = real(*a)
        states.append(out[0])
        return out

    monkeypatch.setattr(trun, "_bootstrap_f64", spy)
    out32 = _boot_md(tmp_path, "boot", torch.float32, 3).solve(progress=False)
    monkeypatch.setattr(trun, "_bootstrap_f64", real)
    out64 = _boot_md(tmp_path, "ref64", torch.float64, 0).solve(progress=False)
    (s64,) = states
    for k in ("N", "b", "q", "melt", "N_prev"):
        t = getattr(s64, k)
        assert t.dtype == torch.float64 and t.device.type == "cpu", k
    assert out32["state"].N.dtype == torch.float32
    for k in KEYS:
        a = np.asarray(out32["history"][k][:2], np.float64)
        np.testing.assert_allclose(a, out64["history"][k][:2], rtol=2e-7, atol=0)
        ref = jax_full["history"][k][:2]
        np.testing.assert_allclose(a, ref, rtol=2e-7,
                                   atol=1e-12 * np.abs(ref).max())
    last64 = out64["history"]["N"][-1]
    assert (np.linalg.norm(out32["history"]["N"][-1] - last64)
            / np.linalg.norm(last64)) < 1e-4
    assert out32["steps"] == 20 - 4 - 1
