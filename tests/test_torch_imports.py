"""The port imports nothing of shakti_tpu and nothing of jax: every module of
shakti_tpu_torch/, chip_smoke.py and the golden cases it loads,
torch_ab.py, the port's validation drivers (scripts/torch_*.py) and the
example twins (examples/torch_*.py), read with ``ast``; the drivers
import none of the JAX package's scripts (each imports jax), and the SHMIP
twins with the FV oracle load neither; the drivers and
twins import none of the optional libraries at module level (the machine
with the card lacks them: matplotlib and PIL only inside the legs that
guard them), and importing every twin loads none; and a fresh
interpreter that imports every module of the package and runs a small
model's freeze and one operator matvec ends with neither package loaded,
none of the optional libraries that only some functions need (h5py,
netCDF4, PIL, matplotlib, pyproj: the machine with the card has none of
them) and no native host library mapped.  Nor does a rank of the
distributed path (parallel/dist.py, two gloo ranks spawned from
tests/torch_dist_worker.py).  The package's top-level names resolve to the
port's objects, as shakti_tpu's resolve to its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests import torch_parity  # noqa: F401  (pins torch's threads)
from tests.torch_parity import case, spawn_world

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "shakti_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "tests/torch_golden_cases.py",  # chip_smoke loads it
    "torch_ab.py", "tests/torch_dist_worker.py"] + sorted(  # a rank's code
    str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob("torch_*.py"))
DRIVERS = sorted(str(p.relative_to(ROOT)) for d in ("scripts", "examples")
                 for p in (ROOT / d).glob("torch_*.py"))
SOURCES += [p for p in DRIVERS if p.startswith("examples")]
FORBIDDEN = ("jax", "jaxlib", "shakti_tpu")
# what the machine with the card lacks (and optax, the JAX examples' own)
OPTIONAL = ("h5py", "netCDF4", "PIL", "matplotlib", "pyproj", "optax")


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


@pytest.mark.parametrize("path", DRIVERS)
def test_driver_imports_no_optional_library_at_module_level(path):
    tree = ast.parse((ROOT / path).read_text(), path)
    top = ast.Module(body=[n for n in tree.body if isinstance(
        n, (ast.Import, ast.ImportFrom, ast.If, ast.Try))], type_ignores=[])
    bad = [m for m in _imports(top) if m.split(".")[0] in OPTIONAL]
    assert not bad, f"{path} imports {bad} at module level"


_TWINS = """
import importlib.util, pathlib, sys
for p in sorted(pathlib.Path("examples").glob("torch_*.py")):
    spec = importlib.util.spec_from_file_location(p.stem, p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(m for m in sys.modules if m.split(".")[0] in {names}))
"""


def test_importing_the_twins_loads_no_optional_library():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    names = set(OPTIONAL) | set(FORBIDDEN)
    r = subprocess.run([sys.executable, "-c", _TWINS.format(names=names)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout


# the JAX package's drivers (scripts/ other than the twins): each imports
# jax, or may; a twin imports none of them, by name or by path
JAX_SCRIPTS = sorted(p.stem for p in (ROOT / "scripts").glob("*.py")
                     if not p.stem.startswith("torch_"))


@pytest.mark.parametrize("path", [p for p in DRIVERS
                                  if p.startswith("scripts")])
def test_driver_imports_no_jax_script(path):
    src = (ROOT / path).read_text()
    bad = [m for m in _imports(ast.parse(src, path))
           if m.split(".")[0] in JAX_SCRIPTS]
    assert not bad, f"{path} imports {bad}"
    named = [s for s in JAX_SCRIPTS
             if f'"{s}.py"' in src or f"'{s}.py'" in src]
    assert not named, f"{path} names {named}"


_SHMIP = """
import importlib.util, sys
for name in ("torch_shmip_validate", "torch_valley_stationarity"):
    spec = importlib.util.spec_from_file_location(name, f"scripts/{{name}}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
v = sys.modules["torch_shmip_validate"]
v._fv()
assert callable(v.suite_O) and callable(v.suite_OT) and callable(v.suite_OV)
assert callable(v.suite_X) and callable(v.suite_S)
print(sorted(m for m in sys.modules if m.split(".")[0] in {names}))
"""


def test_shmip_twins_load_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _SHMIP.format(
        names=set(FORBIDDEN) | {"shmip_validate", "valley_stationarity"})],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout


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
from shakti_tpu_torch.parallel import ensemble
from shakti_tpu_torch.solve import implicit
from shakti_tpu_torch import post
from shakti_tpu_torch.data import geotiff, lakes, netcdf
from shakti_tpu_torch.mesh import basin, msh_io
from shakti_tpu_torch.setups import setup_cooke2
for fn in (post.load_results, post.render_frames, geotiff.read_geotiff,
           lakes.load_inventory_hdf5, netcdf.read_grid, basin.basin_mesh,
           msh_io.write_msh, setup_cooke2.initialize):
    assert callable(fn)
for name in ("stack_states", "perturbed_ensemble", "make_ensemble_step_fn",
             "make_ensemble_runner"):
    assert callable(getattr(ensemble, name)), name
assert callable(implicit.make_implicit_solver)
md = setup_lake.initialize(nx=6, ny=6)
md.dtype = torch.float64
mesh, static, state, cfg = md.freeze("cpu")
vals = torch.zeros(mesh.bell_nbr.shape + (mesh.bell_B, mesh.bell_B),
                   dtype=torch.float64)
y = operator_from_values(vals, mesh, static.dirichlet)(state.N)
assert torch.equal(y, torch.where(static.dirichlet, state.N, 0.0))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                           "shakti_tpu"))
optional = sorted(m for m in sys.modules if m.split(".")[0] in (
    "h5py", "netCDF4", "PIL", "matplotlib", "pyproj"))
maps = open("/proc/self/maps").read() if sys.platform == "linux" else ""
print("OPTIONAL", optional)
print("BAD", bad, "NATIVE", "libshakti_native" in maps)
"""


def test_fresh_interpreter_loads_no_jax_nor_shakti_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "BAD [] NATIVE False", r.stdout
    assert lines[-2] == "OPTIONAL []", r.stdout


_API = """
import importlib, sys
import {pkg} as pkg
got = {{}}
for name in ("solve", "ModelSetup", "solve_steady", "NewtonConfig",
             "rectangle_mesh", "polygon_mesh", "read_msh", "post"):
    obj = getattr(pkg, name)
    got[name] = (obj.__name__ if hasattr(obj, "__file__")
                 else obj.__module__ + "." + obj.__name__)
print(got)
"""


@pytest.mark.parametrize("pkg", ["shakti_tpu_torch", "shakti_tpu"])
def test_top_level_names(pkg):
    """shakti_tpu's lazy top-level names, in each package, resolve to that
    package's objects.  ``solve`` is asked first: once anything has loaded
    the subpackage of the same name, the attribute is that subpackage, in
    both packages alike."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _API.format(pkg=pkg)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = ast.literal_eval(r.stdout.strip().splitlines()[-1])
    assert got == {
        "solve": f"{pkg}.api.run.solve",
        "ModelSetup": f"{pkg}.api.model.ModelSetup",
        "solve_steady": f"{pkg}.api.steady.solve_steady",
        "NewtonConfig": f"{pkg}.solve.newton.NewtonConfig",
        "rectangle_mesh": f"{pkg}.mesh.generate.rectangle_mesh",
        "polygon_mesh": f"{pkg}.mesh.generate.polygon_mesh",
        "read_msh": f"{pkg}.mesh.msh_io.read_msh",
        "post": f"{pkg}.post"}
    if pkg == "shakti_tpu_torch":
        import shakti_tpu_torch
        from shakti_tpu_torch.api.model import ModelSetup
        assert shakti_tpu_torch.ModelSetup is ModelSetup
        assert shakti_tpu_torch.DEFAULT_PARAMS.g == 9.81
        with pytest.raises(AttributeError, match="no attribute"):
            shakti_tpu_torch.no_such_name


def test_spawned_ranks_load_no_jax_nor_shakti_tpu(tmp_path):
    for r in case(spawn_world("imports", 2, tmp_path), "modules"):
        assert r["bad"].size == 0, list(r["bad"])
