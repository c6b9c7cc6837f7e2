"""The port imports nothing of shakti_tpu and nothing of jax: every module of
shakti_tpu_torch/, chip_smoke.py and the golden cases it loads, and
torch_ab.py, read with ``ast``; and a fresh
interpreter that imports every module of the package and runs a small
model's freeze and one operator matvec ends with neither package loaded and
no native host library mapped."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "shakti_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "tests/torch_golden_cases.py",  # chip_smoke loads it
    "torch_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "shakti_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (f"<relative import, level {node.level}>" if node.level
                   else node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES)
def test_module_imports_no_jax_or_shakti_tpu(path):
    src = (ROOT / path).read_text()
    bad = [m for m in _imports(ast.parse(src, path))
           if _forbidden(m) or m.startswith("<relative")]
    assert not bad, f"{path} imports {bad}"
    assert "libshakti_native" not in src, f"{path} names the native library"


def test_forbidden_names():
    assert _forbidden("shakti_tpu.native") and _forbidden("jax.numpy")
    assert not _forbidden("shakti_tpu_torch.fem") and not _forbidden("jaxtyping")


_PROBE = """
import pkgutil, importlib, sys
import torch
import shakti_tpu_torch
for m in pkgutil.walk_packages(shakti_tpu_torch.__path__, "shakti_tpu_torch."):
    if m.name != "shakti_tpu_torch.__main__":
        importlib.import_module(m.name)
from shakti_tpu_torch.setups import setup_lake
from shakti_tpu_torch.physics.residual import operator_from_values
md = setup_lake.initialize(nx=6, ny=6)
md.dtype = torch.float64
mesh, static, state, cfg = md.freeze("cpu")
vals = torch.zeros(mesh.bell_nbr.shape + (mesh.bell_B, mesh.bell_B),
                   dtype=torch.float64)
y = operator_from_values(vals, mesh, static.dirichlet)(state.N)
assert torch.equal(y, torch.where(static.dirichlet, state.N, 0.0))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                           "shakti_tpu"))
maps = open("/proc/self/maps").read() if sys.platform == "linux" else ""
print("BAD", bad, "NATIVE", "libshakti_native" in maps)
"""


def test_fresh_interpreter_loads_no_jax_nor_shakti_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "BAD [] NATIVE False", r.stdout
