"""Node-sharded domain decomposition with explicit halo exchange, on
torch.distributed.

Port of shakti_tpu/parallel/halo.py.  One process per rank (the PyTorch
idiom) where the JAX package runs one program over P devices:

  * nodes are partitioned into P contiguous chunks of the solver ordering
    (RCB-localized, so chunks are spatially compact);
  * a cell lives on the lowest rank owning one of its nodes; the other
    ranks' nodes it references become ghosts there;
  * each rank's local index space is [owned | ghosts | 1 dump slot] with
    L = omax + gmax + 1 slots on every rank (the JAX package's numbering,
    so checkpoints and :func:`globalize_nodal` agree slot for slot);
  * two exchanges, one ``all_to_all_single`` each:
      - ``push``:       owner -> ghost copy,
      - ``accumulate``: ghost -> owner add, then push;
  * reductions mask the ghosts and sum over the ranks.

Autograd.  Both exchanges are linear, and each is recorded as one
``torch.autograd.Function`` (:func:`linear`) whose backward is its
transpose, the exchange in the other direction: ``push``'s transpose adds
each ghost's cotangent into its owned slot and zeroes the ghost slot, and
``accumulate``'s is ``accumulate`` itself.  The backward sums in the same
fixed order as the forward (the host gather plan), so it gives the same
bits on every run.  When grad mode is off or nothing requires grad, the
exchanges run without a Function.  The reductions have no transpose: one
given a tensor that requires grad under grad mode raises, where
``all_gather`` and ``all_reduce`` would silently drop its gradient.

The exchange plan keeps no pads: where the JAX package pads every pair of
devices to the largest (its (P, H) arrays), ``all_to_all_single`` takes each
rank's ``input_split_sizes`` / ``output_split_sizes``, so a rank sends and
receives exactly the entries that cross its boundary.

Determinism.  Every sum here has a fixed order and gives the same bits on
every rank, which keeps the ranks' host decisions (Krylov, Newton and PTC
loop tests) identical without a broadcast:
  - ``accumulate`` adds the ghost contributions into their owned slots over a
    host-built gather plan (fem/ops.gather_plan): the owner's value, then
    the received values in (source rank, position) order; no ``index_add_``;
  - :meth:`Collectives.allsum` gathers every rank's partial value and sums
    them in rank order on every rank (an all-reduce may order the sum per
    rank); MAX and MIN, exact, are all-reduces.

Transport.  Every collective takes the tensors where they lie, CUDA
tensors included: NCCL does, and gloo ran all_reduce, all_gather and
all_to_all_single (even and uneven splits) on CUDA tensors of ranks sharing
one H100 (torch 2.11.0+cu128), so the halo stages nothing through the host.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from shakti_tpu_torch.fem.ops import fixed_sum, gather_plan

# the default time after which a collective that no peer joins aborts the
# run (a rank that died or left a loop early), instead of hanging it
TIMEOUT = datetime.timedelta(seconds=300)


class _Linear(torch.autograd.Function):
    """y = fwd(*xs), a linear map, whose backward is ``bwd(g)``: one
    cotangent per x."""

    @staticmethod
    def forward(ctx, fwd, bwd, *xs):
        ctx.bwd = bwd
        return fwd(*xs)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *ctx.bwd(g))


def linear(fwd, bwd, *xs):
    """``fwd(*xs)`` for a linear ``fwd`` whose transpose is ``bwd`` (g -> a
    tuple of one cotangent per x): recorded for autograd as one Function
    when grad mode is on and an x requires grad, else ``fwd(*xs)`` alone."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _Linear.apply(fwd, bwd, *xs)
    return fwd(*xs)


def _no_transpose(op, x):
    """Raise where the collective ``op`` would drop the gradient of ``x``."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{op} has no transpose, and its input requires grad: the "
            "gradient would be dropped.  Reduce the detached value (a "
            "reduction that steers a host decision), or run it under "
            "torch.no_grad()")


class Collectives:
    """The reductions of one process group (default: the world), with the
    same bits on every rank.  Serves the cell-sharded step (``mesh.paxis``,
    parallel/shard.py) and is the base of :class:`Halo`."""

    def __init__(self, device, group=None):
        self.group = group
        self.device = torch.device(device)
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def gather(self, x):
        """Every rank's ``x`` (equal shapes), in rank order: a list."""
        _no_transpose("all_gather", x)
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(outs, x, group=self.group)
        return outs

    def allsum(self, x):
        """The sum over the ranks of ``x``, in rank order, the same bits on
        every rank."""
        return fixed_sum(torch.stack(self.gather(x)), 0)

    def _reduce(self, x, op):
        _no_transpose("all_reduce", x)
        y = x.clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def max(self, x):
        """The maximum over the ranks (exact: the same on every rank)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def min(self, x):
        return self._reduce(x, dist.ReduceOp.MIN)

    def all(self, flag):
        """A bool tensor true on every rank."""
        return self.min(flag.to(torch.int32)) > 0

    def all_to_all(self, buf, out_counts, in_counts):
        """``all_to_all_single`` along dim 0 with the split sizes given
        (not recorded by autograd: the exchanges below are)."""
        _no_transpose("all_to_all_single", buf)
        buf = buf.contiguous()
        out_shape = (int(sum(out_counts)),) + tuple(buf.shape[1:])
        if self.world == 1:
            # a rank alone has no ghosts: nothing crosses
            return buf.reshape(out_shape)
        out = buf.new_empty(out_shape)
        dist.all_to_all_single(out, buf, list(out_counts), list(in_counts),
                               group=self.group)
        return out


class Halo(Collectives):
    """One rank's halo-exchange plan (from :func:`build_halo`'s stacked host
    plan) and its reductions.  Tensors on ``device``; ``owned_mask`` in
    ``dtype``.

    ``send`` (S,): the owned slots this rank sends, destination by
    destination (``send_counts``); ``recv`` (R,): the ghost slots it fills,
    source by source (``recv_counts``).  ``acc_slots``/``acc_idx``: the
    plan of accumulate's sum over ``cat([x, back, 0])``, row u = the slot
    acc_slots[u] itself, then the received values for it in order."""

    def __init__(self, plan: dict, rank: int, dtype, device, group=None):
        super().__init__(device, group)
        P, L = int(plan["P"]), int(plan["L"])
        if (self.world, self.rank) != (P, rank):
            raise ValueError(f"halo plan of rank {rank} of {P}, in a group "
                             f"of {self.world} (this rank {self.rank})")
        self.P, self.L, self.omax = P, L, int(plan["omax"])
        valid = plan["send_valid"]
        send, self.send_counts = [], []
        recv, self.recv_counts = [], []
        for p in range(P):
            k = int(valid[rank, p].sum())
            send.append(plan["send_idx"][rank, p, :k])
            self.send_counts.append(k)
            k = int(valid[p, rank].sum())
            recv.append(plan["recv_slot"][rank, p, :k])
            self.recv_counts.append(k)
        send = np.concatenate(send).astype(np.int64)
        recv = np.concatenate(recv).astype(np.int64)
        slots, idx = gather_plan(send)                  # pads: S (a zero)
        acc_idx = np.concatenate([slots[:, None], L + idx], axis=1)

        def t(a):
            return torch.as_tensor(a, device=self.device)

        self.send, self.recv = t(send), t(recv)
        self.acc_slots, self.acc_idx = t(slots), t(acc_idx)
        self.owned_mask = torch.as_tensor(plan["owned_mask"][rank],
                                          dtype=dtype, device=self.device)

    @property
    def n_local(self) -> int:
        return self.L

    def _mask(self, x):
        return self.owned_mask.reshape((-1,) + (1,) * (x.dim() - 1))

    # ---------------------------------------------------------- exchanges
    def push(self, x):
        """Owner -> ghost copy (the reference's scatter_forward)."""
        return linear(self._push, lambda g: (self._push_t(g),), x)

    def accumulate(self, x):
        """Ghost contributions -> owner add, then fresh owner values into
        the ghost copies (the assembly's completion).  Its own transpose."""
        return linear(self._accumulate, lambda g: (self._accumulate(g),), x)

    def accumulate_split(self, y_lo, y_hi):
        """accumulate(cat(y_lo, y_hi)) with the ghost return depending on
        ``y_hi`` alone (rows [split, L), split = len(y_lo) <= omax: every
        ghost slot lies there); bitwise equal to :meth:`accumulate`."""
        split = y_lo.shape[0]
        if split > self.omax:
            raise ValueError(f"split {split} past the owned slots "
                             f"({self.omax})")

        def bwd(g):
            g = self._accumulate(g)
            return g[:split], g[split:]

        return linear(self._accumulate_split, bwd, y_lo, y_hi)

    def _push(self, x):
        recv = self.all_to_all(x[self.send], self.recv_counts,
                               self.send_counts)
        y = x.clone()
        y[self.recv] = recv
        return y

    def _push_t(self, g):
        """The transpose of push: each ghost slot's value added into its
        owned slot on its owner (the ghost return), the ghost slots zero;
        the owned slots, the dead slots and the dump pass."""
        back = self.all_to_all(g[self.recv], self.send_counts,
                               self.recv_counts)
        y = g.clone()
        y[self.recv] = 0.0
        return self._sum_back(y, back)

    def _sum_back(self, x, back):
        """x with the received ghost contributions ``back`` added to their
        owned slots in plan order: the slot's own value, then the received
        ones in (source rank, position) order."""
        y = x.clone()
        if self.acc_slots.numel():
            ext = torch.cat([x, back, x.new_zeros((1,) + tuple(x.shape[1:]))])
            y[self.acc_slots] = fixed_sum(ext[self.acc_idx], 1)
        return y

    def _add_back(self, x, back):
        """:meth:`_sum_back`, then the ghosts (and the dump) zeroed."""
        y = self._sum_back(x, back)
        return y * self._mask(y)

    def _accumulate(self, x):
        back = self.all_to_all(x[self.recv], self.send_counts,
                               self.recv_counts)
        return self._push(self._add_back(x, back))

    def _accumulate_split(self, y_lo, y_hi):
        split = y_lo.shape[0]
        back = self.all_to_all(y_hi[self.recv - split], self.send_counts,
                               self.recv_counts)
        return self._push(self._add_back(torch.cat([y_lo, y_hi]), back))

    # ----------------------------------------------------------- reductions
    def dot(self, a, b):
        """Owned-slot dot product summed over the ranks (0-d)."""
        return self.allsum(torch.sum(a * self._mask(a) * b))

    def dots(self, pairs):
        """The owned-slot dot products of several pairs (a, b) in one sum
        over the ranks: (k,), each equal to :meth:`dot` bit for bit."""
        return self.allsum(torch.stack([torch.sum(a * self._mask(a) * b)
                                        for a, b in pairs]))

    def norm(self, a):
        return torch.sqrt(self.dot(a, a))


def build_halo(n_nodes: int, cells: np.ndarray, n_parts: int):
    """Host-side halo plan from contiguous node chunks (the JAX package's
    arrays, stacked over the ranks):

      owners: P, L (owned_max + ghost_max + 1), omax, starts, sizes,
      owner_of (n,), cell_owner (c,), g2l (P, n) global -> local or -1,
      local_cells (P, cmax, 3), cell_ids (P, cmax), cell_valid (P, cmax),
      send_idx / send_valid / recv_slot (P, P, H): the padded exchange plan
      (device q sends send_idx[q, p] to p, which writes recv_slot[p, q]),
      owned_mask (P, L).
    """
    P = n_parts
    chunk = -(-n_nodes // P)
    starts = np.minimum(np.arange(P) * chunk, n_nodes)
    ends = np.minimum(starts + chunk, n_nodes)
    sizes = ends - starts
    owner_of = np.minimum(np.arange(n_nodes) // chunk, P - 1)

    cell_owner = owner_of[cells].min(axis=1)

    ghosts = [[] for _ in range(P)]
    for p in range(P):
        cp = cells[cell_owner == p]
        refs = np.unique(cp)
        ghosts[p] = refs[(refs < starts[p]) | (refs >= ends[p])]
    gmax = max((g.size for g in ghosts), default=0)
    omax = int(sizes.max())
    L = omax + gmax + 1                      # +1 dump slot

    g2l = -np.ones((P, n_nodes), dtype=np.int64)
    for p in range(P):
        g2l[p, starts[p]:ends[p]] = np.arange(sizes[p])
        g2l[p, ghosts[p]] = omax + np.arange(ghosts[p].size)

    cmax = int(np.bincount(cell_owner, minlength=P).max())
    local_cells = np.zeros((P, cmax, 3), dtype=np.int32)
    cell_ids = np.zeros((P, cmax), dtype=np.int64)
    cell_valid = np.zeros((P, cmax), dtype=bool)
    for p in range(P):
        ids = np.where(cell_owner == p)[0]
        local_cells[p, :ids.size] = g2l[p][cells[ids]]
        cell_ids[p, :ids.size] = ids
        cell_valid[p, :ids.size] = True

    need = [[np.empty(0, np.int64)] * P for _ in range(P)]
    for p in range(P):
        gh = ghosts[p]
        src = owner_of[gh]
        for q in range(P):
            need[p][q] = gh[src == q]        # global ids p needs from q
    H = max((need[p][q].size for p in range(P) for q in range(P)), default=0)
    H = max(H, 1)
    send_idx = np.zeros((P, P, H), dtype=np.int32)
    send_valid = np.zeros((P, P, H), dtype=bool)
    recv_slot = np.full((P, P, H), L - 1, dtype=np.int32)   # pad -> dump
    for q in range(P):
        for p in range(P):
            ids = need[p][q]                 # q sends these to p
            k = ids.size
            send_idx[q, p, :k] = (ids - starts[q])
            send_valid[q, p, :k] = True
            recv_slot[p, q, :k] = g2l[p][ids]

    owned_mask = np.zeros((P, L))
    for p in range(P):
        owned_mask[p, :sizes[p]] = 1.0

    return {
        "P": P, "L": L, "omax": omax, "starts": starts, "sizes": sizes,
        "owner_of": owner_of, "cell_owner": cell_owner, "g2l": g2l,
        "local_cells": local_cells, "cell_ids": cell_ids,
        "cell_valid": cell_valid,
        "send_idx": send_idx, "send_valid": send_valid,
        "recv_slot": recv_slot, "owned_mask": owned_mask,
    }


def localize_rank(plan: dict, f: np.ndarray, rank: int):
    """Global nodal array -> one rank's local array (L, ...): row ``rank``
    of :func:`localize_nodal`, without the other ranks' work."""
    out = np.zeros((plan["L"],) + f.shape[1:], dtype=f.dtype)
    s, k = plan["starts"][rank], plan["sizes"][rank]
    out[:k] = f[s:s + k]
    g2l = plan["g2l"][rank]
    gl = np.where(g2l >= plan["omax"])[0]
    out[g2l[gl]] = f[gl]
    return out


def localize_nodal(plan: dict, f: np.ndarray):
    """Global nodal array -> stacked local arrays (P, L, ...), ghosts
    filled, dead slots zero."""
    P, L = plan["P"], plan["L"]
    out = np.zeros((P, L) + f.shape[1:], dtype=f.dtype)
    for p in range(P):
        s, e = plan["starts"][p], plan["starts"][p] + plan["sizes"][p]
        out[p, :plan["sizes"][p]] = f[s:e]
        gl = np.where(plan["g2l"][p] >= plan["omax"])[0]
        out[p, plan["g2l"][p][gl]] = f[gl]
    return out


def globalize_nodal(plan: dict, local: np.ndarray):
    """Stacked local arrays (P, L, ...) -> global (n, ...) from the owned
    slots."""
    n = plan["owner_of"].shape[0]
    out = np.zeros((n,) + local.shape[2:], dtype=local.dtype)
    for p in range(P := plan["P"]):
        s = plan["starts"][p]
        out[s:s + plan["sizes"][p]] = local[p, :plan["sizes"][p]]
    return out
