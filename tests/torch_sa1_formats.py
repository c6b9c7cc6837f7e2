"""Suite S's A1 march (setup_shmip 60 x 12, float64, solve_steady(tol=1e-3,
max_steps=30000, strict=False) without the polish) in either package and
either operator format, on the CPU: its PTC steps, Newton total and final
drift rate.  The pseudo-time controller's accept/reject decisions follow
the summation order, which the operator format sets; this script shows
the count per format in each package.

    python tests/torch_sa1_formats.py jax ell      # or: jax bell,
    python tests/torch_sa1_formats.py torch bell  #     torch ell
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(pkg, op):
    if pkg == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import setups.setup_shmip as shmip
        md = shmip.initialize("A1", nx=60, ny=12, days=30, nt_per_day=24)
    else:
        import torch
        from shakti_tpu_torch.setups import setup_shmip as shmip
        md = shmip.initialize("A1", nx=60, ny=12, days=30, nt_per_day=24)
        md.device, md.dtype = "cpu", torch.float64
    md.operator = op
    t0 = time.time()
    info = md.solve_steady(tol=1e-3, max_steps=30000, strict=False,
                           polish=False)["info"]
    print(f"{pkg} {op}: PTC steps {info['steps']}, Newton "
          f"{info['newton_total']}, rate {info['rate']:.4e}, "
          f"{time.time() - t0:.1f} s on the CPU", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
