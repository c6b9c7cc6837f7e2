"""Direct steady-state solver: pseudo-transient continuation (PTC).

Port of shakti_tpu/solve/steady.py (its module docstring
gives the method, its measurements and why each mechanism exists).  The
timestep is reused as the PTC iteration with the semi-implicit gap update;
dt adapts by switched-evolution relaxation (SER) under two stability caps
(melt opening, and the b<->N coupling with an adaptive kappa that two
windowed detectors tighten: period-2 increments and probationary
geometric-mean stalls); a step is rejected when its Newton solve fails,
produces non-finite values or moves b by more than ``max_rel_change``; the
march is certified when the relative drift per ``t_ref`` falls below
``tol`` on an accepted step.

Each ``lax.while_loop`` of the JAX package is a Python loop over a carry
dict with the same keys, whose entries are 0-d or nodal tensors.  Accept,
reject, SER, the caps and the detectors stay tensor arithmetic
(``torch.where``); the loop's one ``done``/``k < k_end`` test per step is
the only host sync the march adds to the step's own.  On a rank's share
of a node-sharded mesh (``mesh=``, parallel/dist.py) every norm, dot, max
and finiteness test runs over the ranks, so all ranks take each decision
alike.
"""

from __future__ import annotations

import dataclasses

import torch

from shakti_tpu_torch.solve.timestep import State, make_step_fn

YEAR = 3.1536e7     # 365-day year [s], the default rate-reference time

STATE_KEYS = ("N", "b", "q", "melt", "N_prev")
# the info keys of steady_solve, in the JAX package's order
INFO_KEYS = ("done", "k", "accepted", "rejected", "rate", "rate_N", "rate_b",
             "rate_b_bdry", "kappa", "dt", "t_pseudo", "newton_total",
             "cg_total")


def _select(accept, new: State, old: State) -> State:
    return dataclasses.replace(old, **{
        k: torch.where(accept, getattr(new, k), getattr(old, k))
        for k in STATE_KEYS})


def _finite(state: State):
    return torch.isfinite(state.N).all() & torch.isfinite(state.b).all()


def _norm(x, m=None):
    return torch.linalg.vector_norm(x if m is None else x * m)


def _reductions(mesh, drift_mask, dtype, dev):
    """(act, exc, mnorm, mdot, pamax, pall) of a march: the certificate mask
    (None: every node), the mask-excluded nodes, the (masked) norm and dot,
    the max over the nodes' contributions and the all-ranks test.  On a
    node-sharded mesh (``mesh.halo``) the masks keep the owned slots only
    and every reduction runs over the ranks, so each rank takes the same
    decisions."""
    halo = None if mesh is None else mesh.halo
    act = None if drift_mask is None else torch.as_tensor(drift_mask).to(
        device=dev, dtype=dtype)
    if halo is None:
        exc = None if act is None else 1.0 - act
        return (act, exc, _norm, lambda a, b: torch.sum(a * b),
                lambda x: x, lambda x: x)
    own = halo.owned_mask
    if act is not None:
        act = act * own
    exc = None if act is None else own - act

    def mnorm(x, m=None):
        return halo.norm(x if m is None else x * m)

    return act, exc, mnorm, halo.dot, halo.max, halo.all


def steady_solve(step_fn, state0, *, params, dt0=3600.0, dt_max=1e9,
                 tol=1e-2, t_ref=YEAR, max_steps=2000, growth_cap=4.0,
                 shrink=0.25, max_rel_change=0.5, stab_safety=2.0,
                 drift_mask=None, kappa0=1.0, kappa_min=1e-3,
                 osc_corr=-0.5, osc_M=20, stall_M=200, imp_eps=0.02,
                 carry_in=None, return_carry=False, mesh=None):
    """March ``step_fn`` (built by :func:`make_steady_step`) to steady state
    with adaptive pseudo-timesteps.  ``state0.lag_op`` must be None.

    ``drift_mask``: (n,) bool, True where a node counts toward the drift
    certificate, the max_rel_change guard and the dt caps (the caller passes
    ~dirichlet); excluded nodes' gap drift is reported as ``rate_b_bdry``.

    Returns ``(state, info)``, info's scalars still tensors: ``converged``,
    ``steps``, ``accepted``, ``rejected``, ``rate``/``rate_N``/``rate_b``,
    ``rate_b_bdry``, ``kappa``, ``dt``, ``t_pseudo``, ``newton_total``,
    ``cg_total``.  ``carry_in`` re-enters the march with the carry of an
    earlier call (raise its ``k_end`` first); ``return_carry=True`` appends
    the carry to the return (api/steady.py's segmented march).  ``mesh``:
    the step's mesh; on a rank's share of a node-sharded mesh every norm,
    max and test of the march runs over the ranks (parallel/dist.py)."""
    if state0.lag_op is not None:
        raise ValueError("steady_solve requires lag_operator=False "
                         "(State.lag_op must be None)")
    dtype, dev = state0.N.dtype, state0.N.device
    tiny = torch.finfo(dtype).tiny

    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    def i32(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev)

    act, exc, mnorm, mdot, pamax, pall = _reductions(mesh, drift_mask,
                                                     dtype, dev)
    own = None if mesh is None or mesh.halo is None else mesh.halo.owned_mask

    def rates(old, new, dt):
        rN = mnorm(new.N - old.N, act) / torch.clamp_min(mnorm(old.N, act), tiny)
        rb = mnorm(new.b - old.b, act) / torch.clamp_min(mnorm(old.b, act), tiny)
        per_ref = t_ref / dt
        rbx = f(0.0)
        if exc is not None:
            rbx = (mnorm(new.b - old.b, exc)
                   / torch.clamp_min(mnorm(old.b, exc), tiny)) * per_ref
        return rN * per_ref, rb * per_ref, rb, rbx

    def dt_cap(state, kappa):
        """(min of both caps, the coupling cap): the melt-opening feedback
        +3 m/(rho_i b) and the staggered b<->N coupling kappa/(A |N|^n),
        over certificate nodes only (and, sharded, each node once, through
        its owner)."""
        lam = 3.0 * torch.clamp_min(state.melt, 0.0) / (
            params.rho_i * torch.clamp_min(state.b, tiny))
        lam2 = params.A * torch.abs(state.N) ** params.n
        m = act if act is not None else own
        if m is not None:
            lam, lam2 = lam * m, lam2 * m
        cap1 = stab_safety / torch.clamp_min(pamax(torch.max(lam)), tiny)
        cap2 = kappa / torch.clamp_min(pamax(torch.max(lam2)), tiny)
        return torch.minimum(cap1, cap2), cap2

    def body(c):
        state, dt, kappa = c["state"], c["dt"], c["kappa"]
        new_state, d = step_fn(state, dt)
        rate_N, rate_b, rel_b, rate_bx = rates(state, new_state, dt)
        accept = (torch.as_tensor(bool(d["converged"]), device=dev)
                  & pall(_finite(new_state)) & (rel_b <= max_rel_change))
        rate = torch.maximum(rate_N, rate_b)
        out_state = _select(accept, new_state, state)
        done = accept & (rate < tol)
        # period-2 signature: correlation of consecutive accepted increments
        dN = new_state.N - state.N
        ndN = mnorm(dN, act)
        corr = mdot(dN if act is None else dN * act, c["dN_prev"]) \
            / torch.clamp_min(ndN * c["ndN_prev"], tiny)
        cap_all, cap2 = dt_cap(out_state, kappa)
        # both detectors run on windows of accepted steps and fire only when
        # dt was roughly flat across the window (hover signature); a
        # detection pins the coupling cap at half the hovering dt
        acc_i = accept.to(torch.int32)
        cneg = c["cneg"] + (accept & (corr < osc_corr)).to(torch.int32)
        cw = c["cw"] + acc_i
        fast_done = cw >= osc_M
        dt_flat_f = dt <= 2.0 * c["dt_fmark"]
        osc = fast_done & (cneg >= osc_M // 2) & (rate >= tol) \
            & dt_flat_f & accept
        ssum = c["ssum"] + torch.where(
            accept, torch.log(torch.clamp_min(rate, tiny)), f(0.0))
        sw = c["sw"] + acc_i
        slow_done = (sw >= stall_M) & accept
        avg = ssum / torch.clamp_min(sw, 1).to(dtype)
        # stall tightens are probationary: reverted, with exponential
        # backoff, unless the next window's mean rate improved
        on_probe = c["pend"] > 0
        helped = avg < c["pre_avg"] - 5.0 * imp_eps
        revert = slow_done & on_probe & ~helped
        stalled = slow_done & ~on_probe & (c["skip"] <= 0) \
            & (avg > c["prev_avg"] - imp_eps) \
            & (rate >= tol) & (dt <= 2.0 * c["dt_smark"])
        tighten = osc | stalled
        lam2max = kappa / cap2          # max active coupling rate
        kappa_pin = torch.clamp_min(0.5 * dt * lam2max, kappa_min)
        kappa_new = torch.where(tighten, torch.minimum(kappa, kappa_pin),
                                torch.where(revert, c["kappa_saved"], kappa))
        cap_new = torch.minimum(cap_all, cap2 * kappa_new / kappa)
        # SER: grow dt as the drift rate falls, shrink when it rises;
        # hard-shrink on rejection; always respect the stability caps
        ser = torch.clamp(c["rate"] / torch.clamp_min(rate, tiny), shrink,
                          growth_cap)
        dt_acc = torch.minimum(torch.clamp_max(dt * ser, dt_max), cap_new)
        dt_new = torch.where(accept, dt_acc,
                             torch.clamp_min(dt * shrink, 1e-6 * dt0))
        win_f = tighten | fast_done
        win_s = tighten | slow_done
        return {
            "k_end": c["k_end"],
            "state": out_state,
            "dt": dt_new,
            "kappa": kappa_new,
            "cw": torch.where(win_f, i32(0), cw),
            "cneg": torch.where(win_f, i32(0), cneg),
            "dt_fmark": torch.where(win_f, dt_new, c["dt_fmark"]),
            "sw": torch.where(win_s, i32(0), sw),
            "ssum": torch.where(win_s, f(0.0), ssum),
            "prev_avg": torch.where(tighten, f(float("inf")),
                                    torch.where(slow_done, avg, c["prev_avg"])),
            "dt_smark": torch.where(win_s, dt_new, c["dt_smark"]),
            "pend": torch.where(stalled, i32(1),
                                torch.where(osc | slow_done, i32(0), c["pend"])),
            "pre_avg": torch.where(stalled, avg, c["pre_avg"]),
            "kappa_saved": torch.where(stalled, kappa, c["kappa_saved"]),
            "skip": torch.where(revert, c["wait"], torch.where(
                slow_done, torch.clamp_min(c["skip"] - 1, 0), c["skip"])),
            "wait": torch.where(revert, torch.clamp_max(c["wait"] * 2 + 1, 32),
                                torch.where((slow_done & on_probe & helped)
                                            | osc, i32(0), c["wait"])),
            "dN_prev": torch.where(accept, dN, c["dN_prev"]),
            "ndN_prev": torch.where(accept, ndN, c["ndN_prev"]),
            "rate": torch.where(accept, rate, c["rate"]),
            "rate_N": torch.where(accept, rate_N, c["rate_N"]),
            "rate_b": torch.where(accept, rate_b, c["rate_b"]),
            "rate_b_bdry": torch.where(accept, rate_bx, c["rate_b_bdry"]),
            "t_pseudo": c["t_pseudo"] + torch.where(accept, dt, f(0.0)),
            "k": c["k"] + 1,
            "accepted": c["accepted"] + acc_i,
            "rejected": c["rejected"] + (~accept).to(torch.int32),
            "newton_total": c["newton_total"] + d["newton_iters"],
            "cg_total": c["cg_total"] + d["cg_iters"],
            "done": done,
        }

    c = (steady_carry_init(state0, dt0=dt0, kappa0=kappa0, max_steps=max_steps)
         if carry_in is None else carry_in)
    while bool(~c["done"] & (c["k"] < c["k_end"])):
        c = body(c)
    info = steady_info_from_carry(c)
    if return_carry:
        return c["state"], info, c
    return c["state"], info


def steady_carry_init(state0, *, dt0, kappa0=1.0, max_steps=2000):
    """The PTC loop's initial carry (shared by :func:`steady_solve` and the
    segmented march of api/steady.py, which saves it key by key)."""
    dtype, dev = state0.N.dtype, state0.N.device

    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    def i32(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev)

    inf = float("inf")
    return {
        "k_end": i32(max_steps),
        "state": state0, "dt": f(dt0), "kappa": f(kappa0),
        "cw": i32(0), "cneg": i32(0), "dt_fmark": f(dt0),
        "sw": i32(0), "ssum": f(0.0), "prev_avg": f(inf),
        "dt_smark": f(dt0),
        "pend": i32(0), "pre_avg": f(inf), "kappa_saved": f(kappa0),
        "skip": i32(0), "wait": i32(0),
        "dN_prev": torch.zeros_like(state0.N), "ndN_prev": f(0.0),
        "rate": f(inf), "rate_N": f(inf), "rate_b": f(inf),
        "rate_b_bdry": f(0.0),
        "t_pseudo": f(0.0), "k": i32(0),
        "accepted": i32(0), "rejected": i32(0),
        "newton_total": i32(0), "cg_total": i32(0),
        "done": torch.as_tensor(False, device=dev),
    }


def steady_info_from_carry(c):
    """The user-facing info dict of :func:`steady_solve`, from a carry."""
    info = {k: c[k] for k in INFO_KEYS}
    info["converged"] = info.pop("done")
    info["steps"] = info.pop("k")
    return info


def cycle_certify(step_fn, state0, *, params, dt, tol=1e-2, t_ref=YEAR,
                  window=400, max_attempts=None, shrink=0.25,
                  max_rel_change=0.5, drift_mask=None, mesh=None):
    """Certify a PTC plateau as a statistically stationary limit cycle: two
    consecutive windows of ``window`` accepted steps at the plateau's
    pseudo-timestep ``dt`` (no SER; a rejection shrinks dt, which regrows
    toward ``dt``), certified when the two window means agree to ``tol``
    per ``t_ref``:

        cycle_rate = max_f ||mean2_f - mean1_f|| / ||mean1_f||
                     * t_ref / T_window   < tol      (f in {N, b})

    Sums are centred on the entry state (f32-safe).  Returns
    ``(mean_state, info)``: the window-2 time mean and ``certified``,
    ``cycle_rate``, ``amp_N``/``amp_b`` (relative RMS amplitude of window
    2), ``t_window``, ``steps``/``accepted``/``rejected``,
    ``newton_total``/``cg_total``, scalars still tensors.  ``mesh`` as in
    :func:`steady_solve`."""
    if max_attempts is None:
        max_attempts = 4 * window
    dtype, dev = state0.N.dtype, state0.N.device
    tiny = torch.finfo(dtype).tiny

    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    def i32(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev)

    act, _, mnorm, _, _, pall = _reductions(mesh, drift_mask, dtype, dev)
    dt = f(dt)
    N0, b0, q0, melt0 = state0.N, state0.b, state0.q, state0.melt
    zeros = torch.zeros_like

    def body(c):
        state = c["state"]
        new_state, d = step_fn(state, c["dt"])
        rel_b = mnorm(new_state.b - state.b, act) \
            / torch.clamp_min(mnorm(state.b, act), tiny)
        accept = (torch.as_tensor(bool(d["converged"]), device=dev)
                  & pall(_finite(new_state)) & (rel_b <= max_rel_change))
        out_state = _select(accept, new_state, state)

        def add(s, v):
            return s + torch.where(accept, v, zeros(v))

        # accumulators centred on the entry state (f32-safe)
        sN = add(c["sN"], out_state.N - N0)
        sb = add(c["sb"], out_state.b - b0)
        sq = add(c["sq"], out_state.q - q0)
        sm = add(c["sm"], out_state.melt - melt0)
        s2N = c["s2N"] + torch.where(accept, mnorm(out_state.N - N0, act) ** 2,
                                     f(0.0))
        s2b = c["s2b"] + torch.where(accept, mnorm(out_state.b - b0, act) ** 2,
                                     f(0.0))
        n = c["n"] + accept.to(torch.int32)
        tw = c["tw"] + torch.where(accept, c["dt"], f(0.0))
        win_done = n >= window
        K = torch.clamp_min(n, 1).to(dtype)
        # on rejection shrink; otherwise regrow toward the plateau dt
        dt_new = torch.where(accept, torch.minimum(c["dt"] * 1.2, dt),
                             c["dt"] * shrink)
        keep1 = win_done & (c["phase"] == 0)

        def sel1(m1, s):
            return torch.where(keep1, s / K, m1)

        def reset(s):
            return torch.where(win_done, zeros(s), s)

        return {
            "state": out_state, "dt": dt_new,
            "phase": c["phase"] + win_done.to(torch.int32),
            "n": torch.where(win_done, i32(0), n),
            "tw": torch.where(win_done, f(0.0), tw),
            "t1": torch.where(keep1, tw, c["t1"]),
            "sN": reset(sN), "sb": reset(sb), "sq": reset(sq), "sm": reset(sm),
            "s2N": torch.where(win_done, f(0.0), s2N),
            "s2b": torch.where(win_done, f(0.0), s2b),
            "m1N": sel1(c["m1N"], sN), "m1b": sel1(c["m1b"], sb),
            "m2N": torch.where(win_done, sN / K, c["m2N"]),
            "m2b": torch.where(win_done, sb / K, c["m2b"]),
            "m2q": torch.where(win_done, sq / K, c["m2q"]),
            "m2m": torch.where(win_done, sm / K, c["m2m"]),
            "v2N": torch.where(win_done, s2N / K, c["v2N"]),
            "v2b": torch.where(win_done, s2b / K, c["v2b"]),
            "t2": torch.where(win_done, tw, c["t2"]),
            "k": c["k"] + 1,
            "accepted": c["accepted"] + accept.to(torch.int32),
            "rejected": c["rejected"] + (~accept).to(torch.int32),
            "newton_total": c["newton_total"] + d["newton_iters"],
            "cg_total": c["cg_total"] + d["cg_iters"],
        }

    c = {
        "state": state0, "dt": dt, "phase": i32(0),
        "n": i32(0), "tw": f(0.0), "t1": f(0.0),
        "sN": zeros(N0), "sb": zeros(b0), "sq": zeros(q0), "sm": zeros(melt0),
        "s2N": f(0.0), "s2b": f(0.0),
        "m1N": zeros(N0), "m1b": zeros(b0),
        "m2N": zeros(N0), "m2b": zeros(b0), "m2q": zeros(q0), "m2m": zeros(melt0),
        "v2N": f(0.0), "v2b": f(0.0), "t2": f(0.0),
        "k": i32(0), "accepted": i32(0), "rejected": i32(0),
        "newton_total": i32(0), "cg_total": i32(0),
    }
    while bool((c["phase"] < 2) & (c["k"] < max_attempts)):
        c = body(c)

    # window means (offsets restored), drift of the orbit centroid
    mean_state = dataclasses.replace(
        state0, N=N0 + c["m2N"], b=b0 + c["m2b"], q=q0 + c["m2q"],
        melt=melt0 + c["m2m"],
        N_prev=None if state0.N_prev is None else N0 + c["m2N"])

    def nrm(x, off):
        return torch.clamp_min(mnorm(x + off, act), tiny)

    t2 = torch.clamp_min(c["t2"], tiny)
    dN = mnorm(c["m2N"] - c["m1N"], act) / nrm(c["m1N"], N0)
    db = mnorm(c["m2b"] - c["m1b"], act) / nrm(c["m1b"], b0)
    cycle_rate = torch.maximum(dN, db) * t_ref / t2
    # relative RMS amplitude of window 2 around its mean:
    # Var = E||x - x0||^2 - ||mean - x0||^2
    ampN = torch.sqrt(torch.clamp_min(
        c["v2N"] - mnorm(c["m2N"], act) ** 2, 0.0)) / nrm(c["m2N"], N0)
    ampb = torch.sqrt(torch.clamp_min(
        c["v2b"] - mnorm(c["m2b"], act) ** 2, 0.0)) / nrm(c["m2b"], b0)
    done = c["phase"] >= 2
    info = {
        "certified": done & (cycle_rate < tol),
        "cycle_rate": cycle_rate, "amp_N": ampN, "amp_b": ampb,
        "t_window": c["t2"], "steps": c["k"],
        "accepted": c["accepted"], "rejected": c["rejected"],
        "newton_total": c["newton_total"], "cg_total": c["cg_total"],
    }
    return mean_state, info


def make_steady_step(mesh, static, params, cfg):
    """The PTC iteration: the timestep with the semi-implicit gap update, no
    dt-halving wrapper, no operator carry and no guess extrapolation (under
    SER's order-of-magnitude dt swings the previous solution is the better
    Newton start).  Returns (step, cfg)."""
    cfg = dataclasses.replace(cfg, adaptive_dt_levels=0, lag_operator=False,
                              extrapolate_guess=False)
    return make_step_fn(mesh, static, params, cfg,
                        b_update="semi_implicit"), cfg
