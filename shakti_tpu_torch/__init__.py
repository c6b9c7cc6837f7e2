"""shakti_tpu_torch: the SHAKTI subglacial-hydrology solver on PyTorch/CUDA.

A port of ``shakti_tpu`` (the JAX package beside it, which stays the
reference) to PyTorch on an NVIDIA H100.  The layout mirrors
``shakti_tpu`` module for module, so each function's counterpart is found
under the same path:

  params     physical constants
  mesh/      device Mesh (frozen dataclass of tensors) in one operator
             format, host mesh generation, .msh reading, boundary geometry
  fem/       gather/scatter/averaging primitives, quadrature, the
             block-ELL, scalar-ELL and block-CSR operator formats
  physics/   constitutive laws + weak-form residual and element Jacobian
  solve/     Newton + CG/BiCGStab + two-level preconditioner + time stepping
  ops/       hand-written CUDA kernels (csrc/) and their plain twins
  data/      gridded-data interpolation onto the mesh
  parallel/  RCB node ordering
  api/       ModelSetup and the transient run layer
  io/        checkpoints, in shakti_tpu's format
  setups/    experiment setups built on this package's ModelSetup

JAX's ``while_loop``/``scan``/``cond`` become Python loops and ``if``s; each
convergence test is a host sync.  The host modules it needs from
``shakti_tpu`` (params, fem/p1, mesh/{generate,msh_io,geometry}, data/interp,
parallel/partition) are copies of their numpy paths: this package imports
nothing of ``shakti_tpu``, nor jax, and loads no native host library.
"""

__version__ = "0.1.0"
