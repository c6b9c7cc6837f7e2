"""The port's float32 path tracks its float64 twin through a transient:
tests/test_precision.py:test_f32_tracks_f64 on the port (the slab 12 x 12,
120 hourly steps, relative L2 of N < 2e-3 and of b < 1e-3).  The same
guard on the 12,270-node Cook_E2 catchment runs on the card
(chip_smoke.py phase 18 (d))."""

import numpy as np
import pytest
import torch

from shakti_tpu_torch.setups import setup_slab
from shakti_tpu_torch.solve.timestep import make_step_fn, run_window
from tests import torch_parity  # noqa: F401  (pins torch's threads)


@pytest.fixture(scope="module")
def finals():
    out = {}
    for dtype in (torch.float64, torch.float32):
        md = setup_slab.initialize(nx=12, ny=12, days=10.0, nt_per_day=6,
                                   moulin_Q=0.5)
        md.device, md.dtype = "cpu", dtype
        mesh, static, state, cfg = md.freeze()
        step = make_step_fn(mesh, static, md.params, cfg)
        s, d = run_window(step, state, torch.full((120,), 3600.0,
                                                  dtype=dtype))
        assert d["converged"].all(), dtype
        out[dtype] = s
    return out


@pytest.mark.parametrize("field,tol", [("N", 2e-3), ("b", 1e-3)])
def test_f32_tracks_f64(finals, field, tol):
    a = getattr(finals[torch.float32], field).double().numpy()
    r = getattr(finals[torch.float64], field).numpy()
    assert np.isfinite(a).all()
    err = np.linalg.norm(a - r) / np.linalg.norm(r)
    assert err < tol, (field, err)
