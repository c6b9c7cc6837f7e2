"""The golden cases of tests/golden_cases.py rebuilt from shakti_tpu_torch's
setup twins (no jax), for the port's tests and chip_smoke.py.

Each case returns (md, n_steps, golden file name); the stored goldens are
in user node order, so compare ``md.to_user_order(state.<field>)``.
"""

import os

import numpy as np

from shakti_tpu_torch.setups import setup_lake as lake
from shakti_tpu_torch.setups import setup_slab as slab

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
# tests/test_goldens.py: |got - ref| / max|ref| <= 1e-7 per field
GOLDEN_ATOL = 1e-7


def slab_case():
    md = slab.initialize(nx=12, ny=12, days=5.0, nt_per_day=4, seed=0)
    md.b_init = 0.001 * (1.0 + 0.5 * np.sin(2 * np.pi * md.x / 10e3)
                         * np.cos(2 * np.pi * md.y / 10e3))
    return md, 20, "slab_12x12_20steps.npz"


def lake_case():
    md = lake.initialize(nx=16, ny=16, days=3.0, nt_per_day=4, seed=0)
    md.b_init = 0.001 * (1.0 + 0.5 * np.sin(2 * np.pi * md.x / 40e3)
                         * np.cos(2 * np.pi * md.y / 40e3))
    return md, 12, "lake_16x16_12steps.npz"


ALL_CASES = (slab_case, lake_case)


def golden_errors(md, state, fname):
    """max |got - ref| / max|ref| per field against the stored golden."""
    z = np.load(os.path.join(GOLDEN_DIR, fname))
    out = {}
    for k in ("N", "b", "q", "melt"):
        ref = z[k]
        scale = np.abs(ref).max() or 1.0
        out[k] = float(np.abs(md.to_user_order(getattr(state, k)) - ref).max()
                       / scale)
    return out
