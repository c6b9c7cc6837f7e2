"""SHMIP F5 from the cold start at 2-hour steps (tests/torch_examples_ref.py's
F5_INIT) on the port, a step at a time, beside the JAX package's run of the
same steps recorded in tests/torch_f5_ref.json (``python
tests/torch_examples_ref.py f5``): NOT a test module;
tests/test_torch_f5_ell.py and test_torch_f5_bell.py hold the two formats.

    python -m tests.torch_f5 [ell|bell|bell_nolag]

prints the port's steps in a format ("bell_nolag": block-ELL with the
operator carry off) beside the JAX package's recorded ones."""

import dataclasses
import json
import sys

import numpy as np
import torch

from tests import torch_examples_ref as R


def reference(operator):
    """The JAX package's steps in ``operator``'s format."""
    with open(R.F5_JSON) as f:
        return json.load(f)[operator]["steps"]


def port_steps(operator, steps=R.F5_STEPS):
    """The port's F5 at F5_INIT in float64 on the CPU in ``operator``'s
    format ("ell", "bell" or "bell_nolag"), ``steps`` single-step windows:
    the same records as R.f5_steps."""
    from shakti_tpu_torch.setups import setup_shmip as shmip
    from shakti_tpu_torch.solve.timestep import (make_forcing, make_step_fn,
                                                 run_window)
    md = shmip.initialize("F5", **R.F5_INIT)
    md.device, md.dtype = "cpu", torch.float64
    md.operator = operator.removesuffix("_nolag")
    if operator.endswith("_nolag"):
        md.solver = dataclasses.replace(md.solver, lag_operator=False)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    forcing = make_forcing(md.timesteps, dtype=md.dtype,
                           device=static.dirichlet.device,
                           degree_day=md.degree_day)
    rows = []
    for k in range(steps):
        state, d = run_window(step, state,
                              {n: v[k:k + 1] for n, v in forcing.items()})
        rows.append({"newton": int(d["newton_iters"][0]),
                     "cg": int(d["cg_iters"][0]),
                     "converged": bool(d["converged"][0]),
                     "N": md.to_user_order(state.N)})
    return rows


def rel_err(a, b):
    """max |a - b| over the largest |b| (N crosses zero)."""
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


if __name__ == "__main__":
    op = sys.argv[1] if len(sys.argv) > 1 else "bell_nolag"
    for k, (p, j) in enumerate(zip(port_steps(op), reference(op))):
        print(f"step {k}: port newton {p['newton']} cg {p['cg']} converged "
              f"{p['converged']} | JAX newton {j['newton']} cg {j['cg']} "
              f"converged {j['converged']} | N {rel_err(p['N'], j['N']):.2e} "
              "of scale")
