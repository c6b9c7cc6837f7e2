"""Experiment/model-state API: the port of shakti_tpu/api/model.py.

A mutable setup object with the JAX class's attributes: construct with raw
mesh arrays, set fields/toggles/ICs as numpy arrays, then ``solve()``.
:meth:`ModelSetup.freeze` builds the immutable device problem on
``self.device``.  The operator format follows the TPU's rule on every
device: block-ELL up to 200k nodes, block-CSR beyond, both with RCB node
renumbering (outputs are mapped back to the caller's node order through
``node_iperm``); scalar ELL and the matrix-free 'cells' operator are chosen
explicitly (``md.operator``), in the caller's node order, unless the
multilevel preconditioner ('mg') asks for RCB aggregates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shakti_tpu_torch.data.interp import GridInterpolator, subset_grid
from shakti_tpu_torch.mesh import geometry as geo
from shakti_tpu_torch.mesh.mesh import OPERATORS, build_mesh, cell_geometry
from shakti_tpu_torch.parallel.partition import rcb_order
from shakti_tpu_torch.params import DEFAULT_PARAMS, PhysicalParams
from shakti_tpu_torch.solve.mg import attach_hierarchy
from shakti_tpu_torch.solve.newton import NewtonConfig, check_config, zero_lag
from shakti_tpu_torch.solve.timestep import State, make_static_fields
from shakti_tpu_torch.utils.backend import resolve_device

# past this size "auto" switches block-ELL for block-CSR
# (shakti_tpu/api/model.py:221): padding waste and memory
BELL_MAX_NODES = 200_000


def default_dtype():
    """The dtype a ModelSetup takes unless told otherwise: torch.float32
    (the JAX package's answer follows jax_enable_x64; the port has no such
    switch, and a setup asks for float64 by setting ``md.dtype``)."""
    return torch.float32


class ModelSetup:
    """Mutable experiment configuration (reference model_setup.py:18-66).

    ``dtype`` defaults to torch.float32 and ``device`` to 'cuda' (the CLI's
    --device); both may be reassigned before freeze()/solve()."""

    def __init__(self, nodes: np.ndarray, cells: np.ndarray, *,
                 params: PhysicalParams = DEFAULT_PARAMS, dtype=None,
                 device="cuda"):
        self.nodes = np.asarray(nodes, dtype=np.float64)
        self.cells = np.asarray(cells, dtype=np.int32)
        self.x = self.nodes[:, 0]
        self.y = self.nodes[:, 1]
        self.params = params
        self.dtype = dtype or default_dtype()
        self.device = device

        n = self.nodes.shape[0]
        buffer = self.get_buffer()
        self.bounds = [self.x.min() - buffer, self.x.max() + buffer,
                       self.y.min() - buffer, self.y.max() + buffer]

        self.outflow_on = True
        self.storage_on = True
        self.OutflowBoundary = None      # predicate (m,2)->bool

        self.z_b = np.zeros(n)
        self.z_s = np.zeros(n)
        self.G = np.zeros(n)
        self.inputs = np.zeros(n)
        self.b_init = np.zeros(n)
        self.N_init = np.zeros(n)
        self.q_init = np.zeros((n, 2))
        self.melt_init = np.zeros(n)
        self.lake_bdry = np.zeros(n)
        self.N_bdry = 0.0
        self.b_min = 1.0e-5
        # None (unbounded), "thickness" (cap at z_s - z_b) or an (n,) array
        self.b_cap = None
        # float64 cold-start bootstrap steps (api/run._bootstrap_f64; 0 = off)
        self.bootstrap_steps = 0
        self.outline = None

        self.lake_name = None
        self.results_name = None
        self.setup_name = None
        self.setup_file = None

        self.timesteps = None
        self.nt_save = None
        self.nt_check = None
        self.seasonal_inputs = None      # (amplitude, period_s, phase)
        self.degree_day = None           # SHMIP D/F degree-day melt dict

        self.solver = NewtonConfig(adaptive_dt_levels=1)
        # 'auto' (bell up to 200k nodes, bcsr beyond), 'bell', 'bcsr', 'ell'
        # or 'cells'; operator_block: the block formats' edge (None: 128 for
        # bell, 32 for bcsr, 16 beyond 6M nodes)
        self.operator = "auto"
        self.operator_block = None
        self.node_iperm = None
        # run on the ranks of the torch.distributed world, node-sharded
        # (parallel/dist.py; the CLI's --dist)
        self.distributed = False

    # ------------------------------------------------------------------ setup
    def get_buffer(self) -> float:
        """10x the max grid spacing in x/y (reference model_setup.py:93-106)."""
        xs, ys = np.unique(self.x), np.unique(self.y)
        bx = 10 * np.max(np.diff(xs)) if xs.size > 1 else 0.0
        by = 10 * np.max(np.diff(ys)) if ys.size > 1 else 0.0
        return max(bx, by)

    def set_lake_bdry(self, outline: np.ndarray):
        """Point-in-polygon lake indicator."""
        self.outline = np.asarray(outline, dtype=np.float64)
        self.lake_bdry = geo.points_in_polygon(self.nodes, self.outline).astype(np.float64)

    def interp_data(self, var_name: str, x_d, y_d, f) -> GridInterpolator:
        """Interpolate gridded data onto mesh nodes into ``self.<var_name>``;
        returns the interpolator for reuse."""
        xs, ys, fs = subset_grid(np.asarray(x_d), np.asarray(y_d),
                                 np.asarray(f), self.bounds)
        itp = GridInterpolator(xs, ys, fs)
        setattr(self, var_name, itp(self.x, self.y))
        return itp

    def add_moulin(self, xy, Q: float):
        """Point moulin of discharge Q [m^3/s] at the node nearest ``xy``, as
        inputs = Q / (lumped nodal area)."""
        k = int(np.argmin((self.x - xy[0]) ** 2 + (self.y - xy[1]) ** 2))
        sa, _ = cell_geometry(self.nodes, self.cells)
        node_area = np.zeros(self.nodes.shape[0])
        np.add.at(node_area, self.cells.reshape(-1), np.repeat(np.abs(sa), 3))
        self.inputs[k] += Q / (node_area[k] / 3.0)
        return k

    # ----------------------------------------------------------------- freeze
    def dirichlet_nodes(self) -> np.ndarray:
        if not self.outflow_on or self.OutflowBoundary is None:
            return np.zeros(0, dtype=np.int64)
        return geo.locate_boundary_nodes(self.nodes, self.cells, self.OutflowBoundary)

    def to_user_order(self, arr):
        """Map a solver-order nodal array back to this setup's node order."""
        a = arr.detach().cpu().numpy() if torch.is_tensor(arr) else np.asarray(arr)
        return a if self.node_iperm is None else a[self.node_iperm]

    def validate(self, require_timesteps: bool = True):
        """Fail early with actionable messages."""
        if require_timesteps and (self.timesteps is None
                                  or np.size(self.timesteps) < 2):
            raise ValueError(
                "md.timesteps must be an array of at least 2 times "
                "(e.g. np.linspace(0, t_final, n_steps))")
        if self.outflow_on and self.OutflowBoundary is None:
            raise ValueError(
                "outflow_on=True but md.OutflowBoundary is unset; provide a "
                "boundary predicate (coords (m,2) -> bool) or set "
                "md.outflow_on = False for a no-outflow run")
        for name in ("z_b", "z_s", "G", "inputs", "b_init", "N_init"):
            a = getattr(self, name)
            if a is None or np.ndim(a) == 0:
                raise ValueError(
                    f"md.{name} must be a per-node array of length "
                    f"{self.nodes.shape[0]} (got a scalar/None; use "
                    f"np.full(md.x.size, value) for uniform fields)")
            if np.shape(a)[0] != self.nodes.shape[0]:
                raise ValueError(f"md.{name} has {np.shape(a)[0]} entries for "
                                 f"{self.nodes.shape[0]} nodes")

    def freeze(self, device=None, distributed=None):
        """Build the immutable device problem (mesh, static_fields,
        initial_state, newton_config) on ``device`` (default self.device).

        For the block formats, and for any format under precond='mg'
        (contiguous aggregates are then spatially compact), the nodes are
        renumbered by recursive coordinate bisection and ``self.node_iperm``
        is set to the solver-order -> user-order permutation (None
        otherwise).  Under 'mg' the mesh carries its hierarchy (solve/mg.py,
        None at or below mg_coarse_cap nodes) and the operator carry is
        off.  ``distributed`` (default self.distributed): the layout of the
        node-sharded path, whose ranks build their own operators and
        hierarchy (parallel/dist.py): RCB order, no operator structure
        ('cells'), no hierarchy."""
        dev = resolve_device(self.device if device is None else device)
        if distributed is None:
            distributed = self.distributed
        self.validate(require_timesteps=False)
        n = self.nodes.shape[0]
        op = self.operator
        if op == "auto":
            op = "bell" if n <= BELL_MAX_NODES else "bcsr"
        if op not in OPERATORS:
            raise ValueError(f"md.operator must be 'auto' or one of "
                             f"{OPERATORS}, got {op!r}")
        check_config(self.solver)
        reorder = op in ("bell", "bcsr") or self.solver.precond == "mg"
        if distributed:
            op, reorder = "cells", True

        nodes, cells, perm = self.nodes, self.cells, None
        self.node_iperm = None
        if reorder:
            perm = rcb_order(self.nodes)
            iperm = np.argsort(perm)
            nodes = self.nodes[perm]
            cells = iperm[self.cells].astype(np.int32)
            self.node_iperm = iperm

        def p(a):
            return np.asarray(a) if perm is None else np.asarray(a)[perm]

        cfg = self.solver.for_dtype(self.dtype)
        if cfg.coarse_block is None:
            # auto coarse aggregate: cap the dense coarse problem at ~1.5k
            # dofs; on block-ELL start from its 128-wide blocks
            blk = 128 if op == "bell" else 64
            while n // blk > 1536:
                blk *= 2
            cfg = dataclasses.replace(cfg, coarse_block=blk)
        if cfg.lag_operator is None or cfg.precond == "mg" or distributed:
            # auto: carry the operator in the block-ELL regime only; never
            # under mg (the carry holds a two-level coarse inverse) nor on
            # the distributed path (no global operator to carry)
            cfg = dataclasses.replace(
                cfg, lag_operator=op == "bell" and cfg.precond != "mg")
        blk = self.operator_block
        if blk is None:
            blk = (32 if n <= 6_000_000 else 16) if op == "bcsr" else 128
        mesh = build_mesh(nodes, cells, dtype=self.dtype, device=dev,
                          operator=op, bell_block=blk)
        if not distributed:
            mesh = attach_hierarchy(mesh, cfg)
        dnodes = geo.locate_boundary_nodes(nodes, cells, self.OutflowBoundary) \
            if (self.outflow_on and self.OutflowBoundary is not None) \
            else np.zeros(0, dtype=np.int64)
        dmask = geo.dirichlet_mask(n, dnodes)
        storage = self.lake_bdry if self.storage_on else np.zeros(n)
        b_cap = self.b_cap
        if isinstance(b_cap, str):
            if b_cap != "thickness":
                raise ValueError(f"b_cap must be None, 'thickness', or an "
                                 f"array, got {b_cap!r}")
            b_cap = np.maximum(np.asarray(self.z_s) - np.asarray(self.z_b),
                               self.b_min)
        static = make_static_fields(
            mesh, p(self.z_b), p(self.z_s), p(self.G), p(self.inputs),
            p(storage), dmask, self.N_bdry, self.b_min, self.params,
            b_max=None if b_cap is None else p(b_cap))

        def f(a):
            return torch.as_tensor(p(np.asarray(a, np.float64)),
                                   dtype=self.dtype, device=dev)

        state0 = State(N=f(self.N_init), b=f(self.b_init), q=f(self.q_init),
                       melt=f(self.melt_init), N_prev=f(self.N_init))
        if cfg.lag_operator:
            state0 = dataclasses.replace(
                state0, lag_op=zero_lag(mesh, self.dtype, cfg))
        return mesh, static, state0, cfg

    # ------------------------------------------------------------------ solve
    def solve(self, **kw):
        """Run the transient problem and write results (api/run.solve)."""
        from shakti_tpu_torch.api.run import solve as _solve
        return _solve(self, **kw)

    def solve_steady(self, **kw):
        """Solve directly for the steady state (pseudo-transient
        continuation, api/steady.py); ``md.timesteps`` is optional here (it
        only seeds the initial pseudo-dt when present)."""
        from shakti_tpu_torch.api.steady import solve_steady as _steady
        return _steady(self, **kw)
