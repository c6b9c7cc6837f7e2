"""What a run must refuse: no card, or the JAX side in the process."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

# top-level module names that may not be loaded: JAX and the JAX package
# that the port was made from (compared whole: shakti_tpu_torch passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "shakti_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the names
    in sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & set(FORBIDDEN))


def imported_names(path: Path) -> set:
    """Every module name that the Python file ``path`` imports."""
    tree = ast.parse(Path(path).read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def card_error(chips: int):
    """Why this process cannot run a cell of ``chips`` cards, or None."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark needs a card"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards and "
                f"{torch.cuda.device_count()} are visible")
    return None


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    return r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
