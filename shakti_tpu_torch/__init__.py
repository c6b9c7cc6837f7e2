"""shakti_tpu_torch: the SHAKTI subglacial-hydrology solver on PyTorch/CUDA.

A port of ``shakti_tpu`` (the JAX package beside it, which stays the
reference) to PyTorch on an NVIDIA H100.  The layout mirrors
``shakti_tpu`` module for module, so each function's counterpart is found
under the same path:

  params     physical constants
  mesh/      device Mesh (frozen dataclass of tensors) in one operator
             format, host mesh generation, .msh reading and writing,
             boundary geometry, drainage-basin extraction and meshing
  fem/       gather/scatter/averaging primitives, quadrature, the
             block-ELL, scalar-ELL and block-CSR operator formats
  physics/   constitutive laws + weak-form residual and element Jacobian
  solve/     Newton + CG/BiCGStab + two-level and multilevel
             preconditioners, time stepping, steady state, the implicit
             adjoint
  ops/       hand-written CUDA kernels (csrc/) and their plain twins
  data/      gridded-data interpolation onto the mesh, the netCDF grid
             readers, the lake inventory, GeoTIFF
  parallel/  RCB node ordering, batched ensembles
  api/       ModelSetup, the transient run layer and the steady state
  io/        checkpoints, in shakti_tpu's format
  post       results loading, the validation reductions, frame rendering
  setups/    experiment setups built on this package's ModelSetup

JAX's ``while_loop``/``scan``/``cond`` become Python loops and ``if``s; each
convergence test is a host sync.  The host modules it needs from
``shakti_tpu`` (params, fem/p1, mesh/{generate,msh_io,geometry,basin},
data/{interp,netcdf,lakes,geotiff}, parallel/partition, post) are copies
of their numpy paths: this package imports nothing of ``shakti_tpu``, nor
jax, and loads no native host library.  Optional libraries (h5py,
netCDF4, pyproj, PIL, matplotlib) are imported only by the functions that
need them.
"""

__version__ = "0.1.0"

from shakti_tpu_torch.params import DEFAULT_PARAMS, PhysicalParams  # noqa: F401

_LAZY = {
    "ModelSetup": ("shakti_tpu_torch.api.model", "ModelSetup"),
    "solve": ("shakti_tpu_torch.api.run", "solve"),
    "solve_steady": ("shakti_tpu_torch.api.steady", "solve_steady"),
    "NewtonConfig": ("shakti_tpu_torch.solve.newton", "NewtonConfig"),
    "rectangle_mesh": ("shakti_tpu_torch.mesh.generate", "rectangle_mesh"),
    "polygon_mesh": ("shakti_tpu_torch.mesh.generate", "polygon_mesh"),
    "read_msh": ("shakti_tpu_torch.mesh.msh_io", "read_msh"),
    "post": ("shakti_tpu_torch.post", None),
}


def __getattr__(name):
    """Lazy top-level API, shakti_tpu's names: ModelSetup, solve,
    solve_steady, NewtonConfig, rectangle_mesh, polygon_mesh, read_msh,
    post (module)."""
    import importlib

    if name in _LAZY:
        mod, attr = _LAZY[name]
        m = importlib.import_module(mod)
        return m if attr is None else getattr(m, attr)
    raise AttributeError(f"module 'shakti_tpu_torch' has no attribute {name!r}")
