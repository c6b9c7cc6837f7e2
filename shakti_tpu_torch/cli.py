"""Command-line launcher (reference source/main.py equivalent).

    python -m shakti_tpu_torch <setup> [--device cuda|cpu] [--resume] [--quiet]
    python -m shakti_tpu_torch <setup> --steady [--steady-tol TOL] [--polish]
                                       [--cycle-window K] [--device ...]
    torchrun --nproc-per-node P -m shakti_tpu_torch <setup> --dist
                                       [--backend nccl|gloo] [--device ...]

Imports the named setup module, calls its ``initialize()`` to get a
ModelSetup of this package, and runs ``md.solve()`` on the chosen device,
or with ``--steady`` ``md.solve_steady()`` (``--polish``: followed by the
monolithic coupled Newton), which writes steady.npz and steady_info.json to
``<results_name>_steady/`` (the JAX package's files and keys).
A bare name resolves first against this package's own setups
(shakti_tpu_torch/setups/), then ./setups and the current directory; a
path to a .py file is loaded as it is.  ``--device cuda`` (the default)
fails when no GPU is present: there is no silent CPU fallback.

``--dist`` runs node-sharded on the ranks torchrun starts (parallel/dist.py,
utils/multihost.py: NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``;
``--backend gloo`` lets ranks share one card); rank 0 writes the results.
``--multihost`` joins the group and implies ``--dist`` when it has more than
one rank.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

import numpy as np

_OWN_SETUPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "setups")


def load_setup(name: str):
    """Import a setup module by name or path."""
    if name.endswith(".py") and os.path.exists(name):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(name))[0], name)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    if os.path.exists(os.path.join(_OWN_SETUPS, name + ".py")):
        return importlib.import_module(f"shakti_tpu_torch.setups.{name}")
    for d in (os.path.join(os.getcwd(), "setups"), os.getcwd()):
        if os.path.exists(os.path.join(d, name + ".py")) and d not in sys.path:
            sys.path.insert(0, d)
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if getattr(e, "name", None) == name:
            raise SystemExit(
                f"error: setup module '{name}' not found — looked for "
                f"{name}.py in {_OWN_SETUPS}, ./setups and the current "
                "directory, and on PYTHONPATH. Pass a module name or a path "
                "to a .py file.")
        raise


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="shakti_tpu_torch",
        description="SHAKTI subglacial hydrology on PyTorch/CUDA")
    ap.add_argument("setup", help="setup module name or a .py path")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in the results "
                         "directory (one written by either package)")
    ap.add_argument("--steady", action="store_true",
                    help="solve directly for the steady state "
                         "(pseudo-transient continuation) instead of "
                         "marching md.timesteps; writes steady.npz + "
                         "steady_info.json to <results_name>_steady/")
    ap.add_argument("--steady-tol", type=float, default=1e-2, metavar="TOL",
                    help="steady drift tolerance per year (default 1e-2)")
    ap.add_argument("--polish", action="store_true",
                    help="with --steady: after the PTC march, solve the "
                         "coupled (N, b) steady system directly by "
                         "monolithic Newton (certifies channelized regimes "
                         "the staggered march plateaus on)")
    ap.add_argument("--cycle-window", type=int, default=0, metavar="K",
                    help="with --steady: if the drift certificate cannot "
                         "fire, march two windows of K accepted pseudo-steps "
                         "and certify the limit cycle instead; the output "
                         "becomes the cycle-mean state (default 0 = off)")
    ap.add_argument("--dist", action="store_true",
                    help="node-sharded over the ranks of the torch.distributed"
                         " world (launch with torchrun --nproc-per-node P)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun describes "
                         "(MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE/"
                         "LOCAL_RANK); implies --dist with more than one rank")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend (default: nccl on "
                         "CUDA, gloo on the CPU; gloo lets ranks share a "
                         "card)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from shakti_tpu_torch.utils.backend import resolve_device
    from shakti_tpu_torch.utils.multihost import init_multihost, local_device
    primary = True
    if args.dist or args.multihost:
        nproc, _, primary = init_multihost(device=args.device,
                                               backend=args.backend)
        if args.multihost:
            if not args.quiet and primary:
                print(f"multihost: {nproc} processes")
            # multi-process runs exist only on the node-sharded path: a
            # per-process single-device run would race on the results
            args.dist = args.dist or nproc > 1
    device = resolve_device(local_device(args.device))
    setup = load_setup(args.setup)
    md = setup.initialize()
    if md.setup_file is None and getattr(setup, "__file__", None):
        md.setup_file = setup.__file__
    md.device = device
    if args.dist:
        md.distributed = True
    if args.steady:
        return _steady(md, args, primary)
    out = md.solve(resume=args.resume, progress=not args.quiet and primary)
    if primary:
        print(f"\ncompleted {out['steps']} steps in {out['wall_time']:.2f} s "
              f"({1e3 * out['wall_time'] / max(out['steps'], 1):.3f} "
              "ms/step)")
    return 0


def _steady(md, args, primary=True):
    """--steady: solve, print the JAX CLI's summary, write the files."""
    out = md.solve_steady(tol=args.steady_tol, cycle_window=args.cycle_window,
                          polish=args.polish)
    if not primary:
        return 0
    info = out["info"]
    verdict = info["verdict"]
    print(f"\n{verdict} state in {info['steps']} PTC steps "
          f"({info['rejected']} rejected, {info['newton_total']} Newton)"
          f" — drift {info['rate']:.2e}/t_ref, wall {info['wall_s']:.2f} s")
    if verdict == "cycle":
        print(f"limit cycle certified: centroid rate "
              f"{info['cycle_rate']:.2e}/t_ref, relative amplitude "
              f"N {info['cycle_amp_N']:.2e} / b {info['cycle_amp_b']:.2e}"
              f" — fields are the cycle mean")
    if "Q_out" in out:
        print(f"mass budget: boundary discharge {float(out['Q_out']):.6g}"
              f" vs production {float(out['Q_src']):.6g} m^3/s")
    if md.results_name is not None:
        rdir = f"{md.results_name}_steady"
        os.makedirs(rdir, exist_ok=True)
        np.savez(os.path.join(rdir, "steady.npz"), N=out["N"], b=out["b"],
                 qx=out["qx"], qy=out["qy"])
        info_j = dict(info)
        for k in ("Q_out", "Q_src"):
            if k in out:
                info_j[k] = float(out[k])
        with open(os.path.join(rdir, "steady_info.json"), "w") as f:
            json.dump(info_j, f, indent=1)
        if not args.quiet:
            print(f"wrote {rdir}/steady.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
