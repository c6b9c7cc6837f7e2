"""Multilevel (aggregation V-cycle) preconditioner on torch tensors.

Port of shakti_tpu/solve/mg.py (the single-device path).  The two-level
preconditioner carries one dense coarse problem of ~1.5k dofs; past ~1M
dofs its aggregates grow so large that mid-frequency error falls between
the smoother and the coarse space.  Here:

  * the hierarchy is contiguous index-range aggregation of the RCB-ordered
    nodes, a factor ``agg`` per level, down to a dense coarse problem of at
    most ``cap`` dofs (:func:`build_hierarchy`, numpy on the host);
  * every level's Galerkin operator A_l = P^T A_{l-1} P is assembled each
    Newton iteration from the element Jacobian blocks (:func:`assemble_levels`):
    where JAX sums with ``segment_sum``, each level is a deterministic
    gather over a host plan built once per hierarchy and kept on it
    (fem/ops.chunked_plan), so no sum depends on atomics;
  * the apply is a symmetric V(1,1) cycle (damped Jacobi or Chebyshev
    smoothing with the exact fine operator, a dense solve at the bottom),
    optionally a W-cycle and hybrid smoothed-aggregation fine transfers: a
    fixed SPD linear operator, so plain CG stays valid.

Every scalar of the apply (the Gershgorin bounds, the Chebyshev
coefficients) stays a 0-d device tensor: an apply syncs nothing with the
host.

On a rank's share of a node-sharded mesh (``mesh.halo``, parallel/dist.py)
the hierarchy is global and replicated: the rank's level-1 entries (its own
cells', :func:`localize_hierarchy`) are completed by one sum over the
ranks, every coarser level is the same computation on every rank, the fine
restriction is an owned-masked planned sum and one sum over the ranks, and
the prolongation reads the replicated coarse vector through each slot's
global aggregate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shakti_tpu_torch.fem import ops
from shakti_tpu_torch.fem.ops import chunked_plan, chunked_sum
from shakti_tpu_torch.solve.precond import regularized_inverse

# values per chunk of a level's deterministic sum: level 1 gathers 5-100
# element entries per slot, the deeper levels up to agg * K
_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class MGPlan:
    """Multilevel structure (static sparsity; the values are assembled again
    every Newton iteration), tensors on the mesh's device.

    ``cols``/``diag_slot``/``next_map`` hold one entry per intermediate ELL
    level (none: ``map9`` targets the dense coarse directly).  ``sums``
    holds one chunked plan (slots, idx1, idx2, size) per assembly sum: the
    9c element entries into level 1 (or the dense coarse), then each level's
    slots into the next."""

    map9: torch.Tensor        # (9c,) int32 element entry -> level-1 slot
    agg_fine: torch.Tensor    # (n,) int32 fine node -> level-1 aggregate
    cols: tuple               # (m_l, K_l) int64 ELL columns per level
    diag_slot: tuple          # (m_l,) int64 within-row diagonal slots
    next_map: tuple           # (m_l * K_l,) int32 slot -> next-level slot
    sums: tuple               # chunked plans of the assembly sums
    m_c: int = 0
    agg: int = 16
    # a rank's share (localize_hierarchy): the gather plan (slots, idx) of
    # the fine restriction's sum of its slots into level-1 aggregates
    restrict: tuple = ()

    @property
    def sizes(self) -> list:
        """[m_1, ..., m_L, m_c]: the rows of every level below the fine one."""
        return [c.shape[0] for c in self.cols] + [self.m_c]


def _ell_structure(keys: np.ndarray, m: int):
    """Unique (row * m + col) keys -> ELL structure: (uniq_key, cols,
    diag_slot, K, flat_slot of each uniq key), cols padded by the row's own
    id (zero-valued slots)."""
    uniq = np.unique(keys)
    r = (uniq // m).astype(np.int64)
    c = (uniq % m).astype(np.int32)
    deg = np.bincount(r, minlength=m)
    K = max(int(deg.max()) if deg.size else 1, 1)
    row_start = np.concatenate([[0], np.cumsum(deg)])
    slot_k = np.arange(uniq.size) - row_start[r]
    cols = np.broadcast_to(np.arange(m, dtype=np.int32)[:, None], (m, K)).copy()
    cols[r, slot_k] = c
    diag_key = np.arange(m, dtype=np.int64) * (m + 1)
    pos = np.clip(np.searchsorted(uniq, diag_key), 0, uniq.size - 1)
    diag_slot = np.where(uniq[pos] == diag_key, slot_k[pos], 0).astype(np.int32)
    flat_slot = (r * K + slot_k).astype(np.int64)
    return uniq, cols, diag_slot, K, flat_slot


def build_hierarchy(cells: np.ndarray, n_nodes: int, *, agg: int = 16,
                    cap: int = 1536, device="cpu") -> MGPlan | None:
    """The hierarchy of a mesh (``cells`` in solver order) on ``device``:
    the JAX package's arrays (built on the host the same way) and the plans
    of the assembly sums; None at or below ``cap`` nodes (the two-level
    preconditioner serves there)."""
    if n_nodes <= cap:
        return None
    ms = [n_nodes]
    while ms[-1] > cap:
        ms.append(-(-ms[-1] // agg))
    m_c = ms[-1]
    n_lvl = len(ms) - 2            # intermediate ELL levels ms[1:-1]

    a3 = np.asarray(cells, np.int64) // agg                  # (c, 3) level 1
    rows9 = np.broadcast_to(a3[:, :, None], a3.shape + (3,)).reshape(-1)
    cols9 = np.broadcast_to(a3[:, None, :], (a3.shape[0], 3, 3)).reshape(-1)

    cols_t, diag_t, next_t = [], [], []
    if n_lvl == 0:
        map9 = (rows9 * m_c + cols9).astype(np.int32)
    else:
        keys = rows9 * ms[1] + cols9
        uniq, cols_l, diag_l, _, flat_slot = _ell_structure(keys, ms[1])
        map9 = flat_slot[np.searchsorted(uniq, keys)].astype(np.int32)
        cols_t.append(cols_l)
        diag_t.append(diag_l)
        # each level's (m*K,) slots into the next (pads carry zero values,
        # so any real target is fine)
        for lvl in range(1, n_lvl + 1):
            m, K = cols_t[-1].shape
            r_l = np.repeat(np.arange(m, dtype=np.int64), K) // agg
            c_l = cols_t[-1].reshape(-1).astype(np.int64) // agg
            if lvl == n_lvl:                     # next is the dense coarse
                next_t.append((r_l * m_c + c_l).astype(np.int32))
            else:
                keys = r_l * ms[lvl + 1] + c_l
                uniq, cols_l, diag_l, _, flat_slot = _ell_structure(
                    keys, ms[lvl + 1])
                next_t.append(
                    flat_slot[np.searchsorted(uniq, keys)].astype(np.int32))
                cols_t.append(cols_l)
                diag_t.append(diag_l)
    agg_fine = (np.arange(n_nodes, dtype=np.int64) // agg).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)

    sums = tuple(
        tuple(t(a) for a in chunked_plan(keys, np.arange(keys.size),
                                         keys.size, _CHUNK)) + (size,)
        for keys, size in zip([map9] + next_t,
                              [c.size for c in cols_t] + [m_c * m_c]))
    # the level tables index tensors: int64, torch's indexing type (an
    # int32 index costs a conversion kernel at every use)
    return MGPlan(map9=t(map9), agg_fine=t(agg_fine),
                  cols=tuple(t(c).long() for c in cols_t),
                  diag_slot=tuple(t(d).long() for d in diag_t),
                  next_map=tuple(t(nm) for nm in next_t), sums=sums,
                  m_c=int(m_c), agg=int(agg))


def localize_hierarchy(plan: MGPlan, cell_ids: np.ndarray,
                       glob_ids: np.ndarray, device) -> MGPlan:
    """One rank's view of a global hierarchy: the level-1 targets of its
    own cells' 9 element entries (``cell_ids``: the rank's global cell ids
    in local order) and their planned sum, and the global level-1
    aggregate of each local slot (``glob_ids``: the global node of each
    slot; dead slots alias node 0, and the restriction masks them).  The
    coarser levels are the global ones."""
    map9 = plan.map9.cpu().numpy().reshape(-1, 9)[cell_ids].reshape(-1)
    size = int(plan.sums[0][3])
    sum1 = tuple(torch.as_tensor(a, device=device) for a in chunked_plan(
        map9, np.arange(map9.size), map9.size, _CHUNK)) + (size,)

    def t(a):
        return a.to(device) if torch.is_tensor(a) else torch.as_tensor(
            a, device=device)

    agg_fine = (np.asarray(glob_ids, np.int64) // plan.agg).astype(np.int32)
    return MGPlan(map9=t(map9), agg_fine=t(agg_fine),
                  cols=tuple(t(c) for c in plan.cols),
                  diag_slot=tuple(t(d) for d in plan.diag_slot),
                  next_map=tuple(t(m) for m in plan.next_map),
                  sums=(sum1,) + tuple(
                      tuple(t(a) for a in s_[:3]) + (s_[3],)
                      for s_ in plan.sums[1:]),
                  m_c=plan.m_c, agg=plan.agg,
                  restrict=tuple(t(a) for a in ops.gather_plan(agg_fine)))


def attach_hierarchy(mesh, cfg):
    """``mesh`` with the hierarchy of ``cfg`` (mg_agg, mg_coarse_cap) when
    cfg.precond is 'mg' and the mesh is larger than the cap; else ``mesh``
    as it is (api/model.freeze, convert.problem_from_numpy)."""
    if cfg.precond != "mg":
        return mesh
    plan = build_hierarchy(mesh.cells.cpu().numpy(), mesh.n_nodes,
                           agg=cfg.mg_agg, cap=cfg.mg_coarse_cap,
                           device=mesh.nodes.device)
    return mesh if plan is None else dataclasses.replace(mesh, mg=plan)


def assemble_levels(J_c, mesh, dirichlet, plan: MGPlan):
    """Galerkin level operators of A = -J (free rows and columns only) from
    the element Jacobian blocks: one planned sum per level, then the
    regularized dense coarse inverse.  Returns ([(V (m, K), d (m,)) per ELL
    level], A_inv (m_c, m_c))."""
    dtype = J_c.dtype
    tiny = torch.finfo(dtype).tiny
    free = (~dirichlet).to(dtype)
    wc = free[mesh.cells]                                        # (c, 3)
    v = (-J_c * (wc[:, :, None] * wc[:, None, :])).reshape(-1)
    levels = []
    for lvl, (slots, idx1, idx2, size) in enumerate(plan.sums):
        v = chunked_sum(v, slots, idx1, idx2, size)
        if lvl == 0 and mesh.halo is not None:
            # cells are partitioned disjointly: one sum over the ranks
            # completes level 1; everything below is replicated
            v = mesh.halo.allsum(v)
        if lvl < len(plan.cols):
            m, K = plan.cols[lvl].shape
            V = v.reshape(m, K)
            d = v[torch.arange(m, device=v.device) * K + plan.diag_slot[lvl]]
            levels.append((V, d))
    return levels, regularized_inverse(v.reshape(plan.m_c, plan.m_c),
                                       plan.m_c, dtype, tiny)


def _make_cheb(matvec, inv_d, lmax, deg: int, frac: float):
    """Degree-``deg`` Chebyshev smoother for A x = b on [frac*lmax, lmax] of
    the D^{-1}A spectrum (three-term recurrence; each step past the first
    costs one matvec).  A fixed polynomial in D^{-1}A, so the symmetric
    cycle stays SPD.  ``lmax`` is a 0-d tensor; so are the coefficients."""
    theta = 0.5 * (1.0 + frac) * lmax
    delta = 0.5 * (1.0 - frac) * lmax
    sigma = theta / delta
    rhos = [1.0 / sigma]
    for _ in range(deg - 1):
        rhos.append(1.0 / (2.0 * sigma - rhos[-1]))
    # the recurrence's coefficients, once per preconditioner build
    steps = [(rn * ro, 2.0 * rn / delta) for ro, rn in zip(rhos, rhos[1:])]

    def smooth(x, b, from_zero: bool):
        r = b if from_zero else b - matvec(x)
        dv = (inv_d * r) / theta
        x = dv if from_zero else x + dv
        for c1, c2 in steps:
            r = b - matvec(x)
            dv = c1 * dv + c2 * (inv_d * r)
            x = x + dv
        return x

    return smooth


def _restrict(r, m_next, agg, m):
    """(m,) -> (m_next,): the sum over each aggregate of ``agg`` contiguous
    rows (a pad, a reshape and a sum; no gather)."""
    return torch.nn.functional.pad(r, (0, m_next * agg - m)).reshape(
        m_next, agg).sum(dim=1)


def make_multilevel(J_c, mesh, dirichlet, a_diag, matvec, *,
                    omega: float = 0.8, smoother: str = "jacobi",
                    cheb_deg: int = 2, cheb_frac: float = 0.25,
                    cycle: str = "v", smooth_p: float = 0.0):
    """Symmetric V(1,1)-cycle preconditioner apply for A = -J (see the JAX
    package's make_multilevel for the method and its measurements).

    ``matvec`` must be the same regularized, Dirichlet-identity fine
    operator the Krylov solver gets, and ``a_diag`` its diagonal: smoothing
    with the exact operator keeps the cycle SPD.  ``smoother``: 'jacobi'
    (one damped sweep, 2 fine matvecs per apply) or 'cheb' (degree
    ``cheb_deg`` with a Gershgorin bound from the element blocks, 2 *
    cheb_deg fine matvecs).  ``cycle='w'``: a second correction at every
    coarse level (2B - BAB).  ``smooth_p > 0``: hybrid smoothed-aggregation
    fine transfers P_s = (I - w_p D^{-1}A) P_t (+2 fine matvecs)."""
    if smoother not in ("jacobi", "cheb"):
        raise ValueError(f"mg_smoother must be 'jacobi' or 'cheb', got "
                         f"{smoother!r}")
    if cycle not in ("v", "w"):
        raise ValueError(f"mg_cycle must be 'v' or 'w', got {cycle!r}")
    plan: MGPlan = mesh.mg
    halo = mesh.halo
    dtype = a_diag.dtype
    tiny = torch.finfo(dtype).tiny
    levels, A_inv = assemble_levels(J_c, mesh, dirichlet, plan)
    agg = plan.agg
    cheb = smoother == "cheb"
    sp = smooth_p > 0.0

    d0 = torch.where(torch.abs(a_diag) < tiny, 1.0, a_diag)
    inv_d0 = torch.where(dirichlet, 0.0, omega / d0)
    if cheb or sp:
        # Gershgorin: lambda_max(D^-1 A) <= 1 + max_i offabs_i / a_ii, with
        # offabs from the element blocks' |.| (one gather-sum per build)
        free = (~dirichlet).to(dtype)
        wc = free[mesh.cells]
        aJ = torch.abs(J_c) * (wc[:, :, None] * wc[:, None, :])
        offabs_c = aJ.sum(dim=2) - torch.diagonal(aJ, dim1=1, dim2=2)
        offabs = ops.scatter_add_cells(mesh, offabs_c)
        if halo is not None:
            # a second accumulate, as the JAX package's halo branch does
            # (its scatter already accumulated): ghost copies add into the
            # owned rows again, which only raises the upper bound
            offabs = halo.accumulate(offabs)
        ratio = torch.where(dirichlet | (a_diag <= tiny), 1.0,
                            1.0 + offabs / d0)
        lmax0 = torch.max(ratio)
        if halo is not None:
            lmax0 = halo.max(lmax0)
    if cheb:
        smooth0 = _make_cheb(matvec, torch.where(dirichlet, 0.0, 1.0 / d0),
                             lmax0, cheb_deg, cheb_frac)

    sizes = plan.sizes
    n = a_diag.shape[0]

    if halo is None:
        def restrict_fine(r):
            return _restrict(r, sizes[0], agg, n)

        def prolong_fine(xc):
            return torch.repeat_interleave(xc, agg)[:n]
    else:
        own = halo.owned_mask

        def restrict_fine(r):
            return halo.allsum(ops.plan_sum(r * own, *plan.restrict,
                                            sizes[0]))

        def prolong_fine(xc):
            # the replicated xc through each slot's global aggregate: the
            # same value on every copy of a node, no push
            return xc[plan.agg_fine]

    if sp:
        w_p = smooth_p / lmax0
        inv_dp = torch.where(dirichlet, 0.0, 1.0 / d0)

        def restrict_t(r):              # P_s^T r = P_t^T (I - w_p A D^{-1}) r
            rm = r - w_p * matvec(inv_dp * r)
            return restrict_fine(torch.where(dirichlet, 0.0, rm))

        def prolong_t(xc):              # P_s xc, zero on Dirichlet rows
            p = torch.where(dirichlet, 0.0, prolong_fine(xc))
            return p - w_p * (inv_dp * matvec(p))
    else:
        restrict_t = restrict_fine

        def prolong_t(xc):
            return torch.where(dirichlet, 0.0, prolong_fine(xc))

    def level_mv(lvl):
        V, _ = levels[lvl]
        cols = plan.cols[lvl]
        return lambda x: (V * x[cols]).sum(dim=1)

    # per-level smoothers, built once per preconditioner (not per apply)
    smoothers = []
    for lvl, (V, d) in enumerate(levels):
        d_safe = torch.where(torch.abs(d) < tiny, 1.0, d)
        if cheb:
            # exact Gershgorin from the level values (rowabs includes the
            # diagonal; pad slots hold zeros)
            rowabs = torch.abs(V).sum(dim=1)
            lmax_l = torch.max(torch.where(d > tiny, rowabs / d_safe, 1.0))
            smoothers.append(_make_cheb(
                level_mv(lvl), torch.where(torch.abs(d) < tiny, 0.0,
                                           1.0 / d_safe),
                lmax_l, cheb_deg, cheb_frac))
        else:
            smoothers.append(omega / d_safe)
    gamma = 2 if cycle == "w" else 1

    def solve_level(lvl, r):
        """gamma-cycle solve at ELL level ``lvl`` (dense coarse at the end)."""
        if lvl == len(levels):
            return A_inv @ r
        x = level_cycle(lvl, r)
        if gamma == 2:
            # second stationary correction: B_W = 2B - BAB
            x = x + level_cycle(lvl, r - level_mv(lvl)(x))
        return x

    def level_cycle(lvl, r):
        """V-cycle on the intermediate ELL level ``lvl``."""
        m, mv = sizes[lvl], level_mv(lvl)

        def down(rr):
            xc = solve_level(lvl + 1, _restrict(rr, sizes[lvl + 1], agg, m))
            return torch.repeat_interleave(xc, agg)[:m]

        sm = smoothers[lvl]
        if cheb:
            x = sm(None, r, True)
            x = x + down(r - mv(x))
            return sm(x, r, False)
        x = sm * r
        x = x + down(r - mv(x))
        return x + sm * (r - mv(x))

    def apply(r):
        r0 = torch.where(dirichlet, 0.0, r)
        x = smooth0(None, r0, True) if cheb else inv_d0 * r0
        x = x + prolong_t(solve_level(0, restrict_t(r0 - matvec(x))))
        x = (smooth0(x, r0, False) if cheb
             else x + inv_d0 * (r0 - matvec(x)))
        return torch.where(dirichlet, r, x)

    return apply
