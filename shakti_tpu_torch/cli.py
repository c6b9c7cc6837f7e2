"""Command-line launcher (reference source/main.py equivalent).

    python -m shakti_tpu_torch <setup> [--device cuda|cpu] [--resume] [--quiet]

Imports the named setup module, calls its ``initialize()`` to get a
ModelSetup of this package, and runs ``md.solve()`` on the chosen device.
A bare name resolves first against this package's own setups
(shakti_tpu_torch/setups/), then ./setups and the current directory; a
path to a .py file is loaded as it is.  ``--device cuda`` (the default)
fails when no GPU is present: there is no silent CPU fallback.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys

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
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from shakti_tpu_torch.utils.backend import resolve_device
    device = resolve_device(args.device)
    setup = load_setup(args.setup)
    md = setup.initialize()
    if md.setup_file is None and getattr(setup, "__file__", None):
        md.setup_file = setup.__file__
    md.device = device
    out = md.solve(resume=args.resume, progress=not args.quiet)
    print(f"\ncompleted {out['steps']} steps in {out['wall_time']:.2f} s "
          f"({1e3 * out['wall_time'] / max(out['steps'], 1):.3f} ms/step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
