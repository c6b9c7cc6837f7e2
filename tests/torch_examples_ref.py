"""The JAX package's examples (examples/{calibrate_melt, invert_melt_field,
ensemble_uq, lake_workflow, basin_pipeline}.py) as references for their
port twins (examples/torch_*.py): NOT a test module.

- ``full()``: each JAX example's main() at its defaults, its printed lines
  parsed into numbers (the card's runs of the twins are held to them);
- ``at_cut(name, **cut)``: each example's code path at a cut, the JAX
  functions the example calls in the order it calls them, returning
  full-precision numbers (tests/test_torch_examples.py and chip_smoke.py's
  phase 22 hold the twins to them); ``CUTS``: phase 22's cuts, the JAX
  examples' widths with fewer steps and iterations; ``SHMIP_CUTS``:
  scripts/shmip_validate.py's runners at phase 22's cuts;
  ``shmip_bf_tests()`` (``--bf-tests``), ``so_tests()`` (``--so-tests``)
  and ``examples_tests()`` (``--examples-tests``): the runners, suite S
  and the artesian study, and the examples' code paths at
  tests/test_torch_shmip_bf.py's, test_torch_shmip_so.py's and
  tests/test_torch_examples.py's cuts, run by ``Child`` beside the port's
  runs.

    python tests/torch_examples_ref.py [full] [cut] [x64] [f5] [so-cut]

writes examples/torch_examples_jax_ref.json (full; x64 adds to it
ensemble_uq's run at its defaults in float64, ``ensemble_uq_x64``),
tests/torch_examples_cut_ref.json (cut; so-cut adds to it suite S and the
stationarity leg at chip_smoke.py's cuts, ``so``) and
tests/torch_f5_ref.json (f5: SHMIP F5's first steps from the cold start
in scalar ELL and in block-ELL, with and without the operator carry,
``f5_steps``) from this CPU, in float64 where
the example enables it (calibrate, invert) and float32 elsewhere, as the
examples run.  Each example runs in a fresh interpreter: ensemble_uq and
lake_workflow leave jax_enable_x64 off, the others turn it on.

ensemble_uq, lake_workflow and basin_pipeline run in block-ELL
(``bell_format``), the format "auto" picks on a TPU and on the port (up
to 200k nodes): JAX's "auto" picks scalar ELL on the CPU, without the
operator carry, and its Newton path parts from block-ELL's (the
ensemble's first day by 15 % in mean N), while the two packages'
block-ELL runs agree (tests/test_torch_examples.py).  calibrate_melt and
invert_melt_field turn the carry off, so the format moves them by
roundoff only; they run in JAX's CPU format, scalar ELL, because
invert_melt_field builds its hidden field in the user's node order and
sets it as the solver-order inputs: under block-ELL's renumbering the JAX
example would invert another field than the one it scores against.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
FULL_JSON = os.path.join(ROOT, "examples", "torch_examples_jax_ref.json")
CUT_JSON = os.path.join(ROOT, "tests", "torch_examples_cut_ref.json")
NAMES = ("calibrate_melt", "invert_melt_field", "ensemble_uq",
         "lake_workflow", "basin_pipeline")
BELL = ("ensemble_uq", "lake_workflow", "basin_pipeline")
# chip_smoke.py phase 22's cuts (keywords of each twin's main): the JAX
# examples' widths and member count, their lengths and iterations cut
CUTS = {
    "calibrate_melt": dict(nx=16, ny=16, days=2 / 16, nt_per_day=16,
                           iters=2),
    "invert_melt_field": dict(nx=20, ny=20, days=0.125, nt_per_day=24,
                              iters=3),
    "ensemble_uq": dict(members=8, days=1.0, nx=24, ny=24),
    "lake_workflow": dict(nx=24, ny=24, days=2.0, nt_per_day=4),
    "basin_pipeline": dict(steps=4),
}


def by_path(path, alias):
    """The Python file ``path`` (relative to the repo) as a module named
    ``alias``."""
    spec = importlib.util.spec_from_file_location(alias,
                                                  os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example(name):
    """The JAX example examples/<name>.py as a module (its top level sets
    JAX's platform and, for some, x64)."""
    return by_path(os.path.join("examples", name + ".py"),
                   "jax_example_" + name)


@contextlib.contextmanager
def patched(module, **over):
    """module.initialize with ``over`` replacing its keywords."""
    real = module.initialize

    def init(*a, **kw):
        kw.update(over)
        return real(*a, **kw)
    module.initialize = init
    try:
        yield
    finally:
        module.initialize = real


@contextlib.contextmanager
def bell_format():
    """Every JAX ModelSetup made inside runs in block-ELL."""
    from shakti_tpu.api.model import ModelSetup
    real = ModelSetup.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.operator = "bell"
    ModelSetup.__init__ = init
    try:
        yield
    finally:
        ModelSetup.__init__ = real


# ------------------------------------------------------------- at a cut

def calibrate_at_cut(nx, ny, days, nt_per_day, iters):
    """calibrate_melt.main's secant loop for ``iters`` iterations."""
    import jax
    import jax.numpy as jnp

    from shakti_tpu.solve.timestep import run_window
    mod = example("calibrate_melt")
    with patched(mod.slab, nx=nx, ny=ny, days=days, nt_per_day=nt_per_day):
        md, state, step, dts = mod.build()
    s_true = 1.7

    @jax.jit
    def final_N(scale):
        forcing = {"dt": dts, "inputs_scale": jnp.full_like(dts, scale)}
        out, _ = run_window(step, state, forcing)
        return out.N

    N_obs = final_N(jnp.asarray(s_true, md.dtype))

    @jax.jit
    def loss(s):
        dN = (final_N(s) - N_obs) / 1e5
        return jnp.mean(dN * dN)

    grad = jax.jit(jax.grad(loss))
    s_prev, g_prev = 1.0, float(grad(jnp.asarray(1.0, md.dtype)))
    s, rows = 1.2, []
    for it in range(iters):
        g = float(grad(jnp.asarray(s, md.dtype)))
        rows.append({"iter": it, "s": s, "loss": float(loss(s)), "grad": g})
        if g == g_prev or abs(g) < 1e-14:
            break
        s_next = s - g * (s - s_prev) / (g - g_prev)
        s_prev, g_prev, s = s, g, s_next
    return {"s": s, "rel_err": abs(s - s_true) / s_true, "rows": rows}


def invert_at_cut(nx, ny, days, nt_per_day, iters):
    """invert_melt_field.main's Adam loop for ``iters`` updates: theta in
    user order, the initial and final field errors, the rows it prints."""
    import jax
    import jax.numpy as jnp
    import optax
    mod = example("invert_melt_field")
    with patched(mod.slab, nx=nx, ny=ny, days=days, nt_per_day=nt_per_day):
        md, mesh, static, state, runner, dts = mod.build()
    theta_star = jnp.asarray(mod.true_theta(md), md.dtype)

    def final_N(theta):
        st = dataclasses.replace(static, inputs=mod.R0 * jnp.exp(theta))
        out, _ = runner(mesh, st, state, dts)
        return out.N

    N_obs = jax.jit(final_N)(theta_star)

    @jax.jit
    def loss(theta):
        dN = (final_N(theta) - N_obs) / 1e4
        g = mod.ops.cell_grad(mesh, theta)
        smooth = jnp.mean(mesh.area * jnp.sum(g * g, axis=-1))
        return jnp.mean(dN * dN) + mod.ALPHA * smooth

    opt = optax.adam(learning_rate=0.3)
    theta = jnp.zeros_like(theta_star)
    opt_state = opt.init(theta)

    @jax.jit
    def update(theta, opt_state):
        val, g = jax.value_and_grad(loss)(theta)
        upd, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(theta, upd), opt_state, val

    def err():
        return float(jnp.linalg.norm(theta - theta_star)
                     / jnp.linalg.norm(theta_star))

    err0, rows = err(), []
    for it in range(iters):
        theta, opt_state, val = update(theta, opt_state)
        if it % 40 == 0 or it == iters - 1:
            rows.append({"iter": it, "loss": float(val), "err": err()})
    th = np.asarray(theta)
    return {"err0": err0, "err": err(), "rows": rows,
            "theta": (th if md.node_iperm is None
                      else th[md.node_iperm]).tolist()}


def ensemble_at_cut(members, days, nx, ny):
    """ensemble_uq.main's loop: a row per day and the final members'
    means."""
    from shakti_tpu.parallel.ensemble import (make_ensemble_runner,
                                              perturbed_ensemble)
    from shakti_tpu.solve.timestep import timestep_sizes
    mod = example("ensemble_uq")
    md = mod.slab.initialize(nx=nx, ny=ny, days=days, nt_per_day=8)
    mesh, static, state, cfg = md.freeze()
    ens = perturbed_ensemble(state, members, b_scale=5e-4, seed=0)
    runner = make_ensemble_runner(mesh, static, md.params, cfg)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype)
    win = int(md.nt_save)
    lo = np.asarray(static.dirichlet, bool)
    rows = []
    for j in range(dts.shape[0] // win):
        ens, diag = runner(ens, dts[j * win:(j + 1) * win])
        assert bool(np.asarray(diag["converged"]).all())
        inner = (np.asarray(ens.N) / 1e6)[:, ~lo]
        rows.append({"day": (j + 1) * win / 8,
                     "mean_N_MPa": float(inner.mean()),
                     "spread_MPa": float(inner.mean(axis=1).std()),
                     "max_member_spread_MPa": float(
                         (inner.max(0) - inner.min(0)).max())})
    final = np.asarray(ens.N)[:, ~lo].mean(axis=1) / 1e6
    return {"rows": rows, "final_mean_MPa": float(final.mean()),
            "final_std_MPa": float(final.std()), "dtype": str(md.dtype)}


def ensemble_x64():
    """ensemble_uq's code path at the example's defaults (8 members, 5
    days, 24x24) with jax_enable_x64 on, so in float64: the reference of
    the twin's float64 run."""
    import jax
    jax.config.update("jax_enable_x64", True)
    return ensemble_at_cut(members=8, days=5.0, nx=24, ny=24)


def lake_at_cut(nx, ny, days, nt_per_day):
    """lake_workflow.main's run and post-processing (no frames)."""
    import setups.setup_lake as setup_lake
    from shakti_tpu import post
    from shakti_tpu.api.run import solve
    with tempfile.TemporaryDirectory() as tmp:
        outdir = os.path.join(tmp, "lake")
        md = setup_lake.initialize(nx=nx, ny=ny, days=days,
                                   nt_per_day=nt_per_day,
                                   results_name=outdir)
        md.seasonal_inputs = (0.8, 3.154e7, 0.0)
        with contextlib.redirect_stdout(io.StringIO()):
            out = solve(md)
        res = post.load_results(outdir)
    return lake_numbers(post, md, res, out)


def lake_numbers(post, md, res, out):
    """The numbers lake_workflow.main prints, at full precision."""
    lake_mask = md.lake_bdry > 0.5
    lvl = post.lake_level(res["N"], lake_mask)
    rate = post.filling_rate(res["t"], res["N"], lake_mask)
    gap = post.mean_gap(res["b"])
    qmax = post.max_flux(res["qx"], res["qy"], exclude_mask=lake_mask)
    far = (md.x > 0.8 * md.x.max())
    ratio = post.far_field_ratio(res["N"], far, md.N_bdry)
    return {"steps": int(out["steps"]),
            "level_change_mm": float(lvl[-1] * 1e3),
            "filling_rate_m_per_yr": float(rate * 3.154e7),
            "mean_gap_mm": float(gap[-1] * 1e3),
            "peak_flux_m2s": float(qmax[-1]),
            "far_field_ratio": float(ratio)}


def basin_at_cut(steps):
    """basin_pipeline.main with ``steps`` transient steps: the mesh's
    counts and the run's N range and Newton total."""
    mod = example("basin_pipeline")
    real = mod.np.linspace

    def linspace(a, b, n=50, **kw):
        # the example's md.timesteps: np.linspace(0.0, 10 * 3600.0, 11)
        if (a, b, n) == (0.0, 36000.0, 11):
            return real(0.0, steps * 3600.0, steps + 1)
        return real(a, b, n, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        mod.np.linspace = linspace
        try:
            text = _captured(mod.main, os.path.join(tmp, "basin"))
        finally:
            mod.np.linspace = real
    return parse("basin_pipeline", text)


# chip_smoke.py phase 22's cuts of the SHMIP runners (scripts/
# torch_shmip_validate.py), held to scripts/shmip_validate.py's; a C case
# samples its last two days, so its cut keeps two
SHMIP_CUTS = {"B5": dict(years=30 / 365, nt_per_day=4),
              "C1": dict(days=2, nt_per_day=24),
              "D5": dict(days=10, nt_per_day=4, sample_days=5),
              "F5": dict(days=2, nt_per_day=24, sample_days=1),
              "E1": dict(years=2 / 365, nt_per_day=24)}


def shmip_at_cut():
    """The JAX runners at SHMIP_CUTS (C1 from the cut B5's state; D5 and F5
    with no spin and their length cut through initialize)."""
    j = by_path(os.path.join("scripts", "shmip_validate.py"),
                "jax_shmip_validate")
    c = SHMIP_CUTS
    out = {}
    md, st, qo, qs, conv = j.run_b_case("B5", c["B5"]["years"],
                                        nt_per_day=c["B5"]["nt_per_day"])
    out["B5"] = {"Q_out": qo, "Q_src": qs, "converged": conv,
                 "ymean_N": j.ymean_profile(md, np.asarray(st.N))[1].tolist()}
    _, out["C1"] = j.run_c_case("C1", st, **c["C1"])
    for case in ("D5", "F5"):
        kw = dict(c[case])
        with patched(j.shmip, days=kw.pop("days")):
            md, st, samples, conv, qo, qs = j.run_seasonal_case(
                case, spin_years=0, **kw)
        out[case] = {"samples": samples.tolist(), "converged": conv,
                     "Q_out": qo, "Q_src": qs}
    md, st, rel, conv, qo, qs = j.run_e_case("E1", **c["E1"])
    out["E1"] = {"N_mean_MPa": float(np.asarray(st.N).mean() / 1e6),
                 "steady_rel": rel, "converged": conv, "Q_out": qo,
                 "Q_src": qs}
    return out


# tests/test_torch_shmip_bf.py's cuts of the SHMIP runners: B5 and C4 (from
# it) on 60x12, D5 on 12x4, F5 and E1 on the valley at 300 m; ``init``
# replaces setup_shmip.initialize's keywords (a seasonal case shorter than
# a year)
BF_TEST_CUTS = {
    "B5": dict(years=1 / 365, nx=60, ny=12, nt_per_day=4),
    "C4": dict(days=2, nt_per_day=4),
    "D5": dict(init=dict(days=10), nx=12, ny=4, nt_per_day=1,
               sample_days=5),
    "F5": dict(init=dict(days=2, resolution=300.0), nt_per_day=24,
               sample_days=1),
    "E1": dict(years=1 / 365, nt_per_day=8, resolution=300.0),
}


def shmip_bf_tests():
    """The JAX runners at BF_TEST_CUTS in float64, case by case: (case,
    record) with N in the runner's node order."""
    import jax
    jax.config.update("jax_enable_x64", True)
    j = by_path(os.path.join("scripts", "shmip_validate.py"),
                "jax_shmip_validate")
    c = BF_TEST_CUTS
    md, st, qo, qs, conv = j.run_b_case("B5", **c["B5"])
    N = np.asarray(st.N)
    yield "B5", {"N": N.tolist(), "ymean": j.ymean_profile(md, N)[1].tolist(),
                 "Q_out": float(qo), "Q_src": float(qs), "converged": conv}
    yield "C4", j.run_c_case("C4", st, **c["C4"])[1]
    for case in ("D5", "F5"):
        kw = dict(c[case])
        with patched(j.shmip, **kw.pop("init")):
            md, st, samples, conv, qo, qs = j.run_seasonal_case(
                case, spin_years=0, **kw)
        yield case, {"samples": samples.tolist(), "converged": conv,
                     "Q_out": float(qo), "Q_src": float(qs)}
    md, st, rel, conv, qo, qs = j.run_e_case("E1", **c["E1"])
    yield "E1", {"N": np.asarray(st.N).tolist(), "steady_rel": float(rel),
                 "converged": conv, "Q_out": float(qo), "Q_src": float(qs)}


# tests/test_torch_shmip_so.py's cuts: suite S at SO_S_INIT, its
# solve_steady capped (SO_S_CAP; the polish's segments at SO_POLISH_NEWTON
# iterations), in block-ELL in both packages; the artesian study on D5 at
# SO_X_INIT (the JAX package's CPU format, scalar ELL, whose solver order
# is the user's)
SO_S_INIT = dict(nx=20, ny=4)
SO_S_CAP = dict(max_steps=3, cycle_window=0, polish_max_newton=2)
SO_POLISH_NEWTON = 2
SO_X_INIT = dict(nx=12, ny=4)


def capped_steady(module, init, cap):
    """Wrap ``module.initialize`` (a setup_shmip): ``init`` replaces its
    keywords and each model's solve_steady takes ``cap`` over the
    caller's keywords."""
    real = module.initialize

    def initialize(case, **kw):
        kw.update(init)
        md = real(case, **kw)
        solve = md.solve_steady

        def capped(**skw):
            skw.update(cap)
            return solve(**skw)
        md.solve_steady = capped
        return md
    return initialize


def so_tests():
    """The JAX script's suite S (A2, A6) and suite_artesian at the cuts
    above in float64: (name, record).  The artesian record holds N after
    every window it ran (the spin first), in user order."""
    import functools
    import types

    import jax
    jax.config.update("jax_enable_x64", True)
    import shakti_tpu.solve.monolithic as mono
    j = by_path(os.path.join("scripts", "shmip_validate.py"),
                "jax_shmip_validate")
    j._save_cache = lambda out: None
    real_init, real_polish = j.shmip.initialize, mono.steady_polish
    j.shmip.initialize = capped_steady(j.shmip, SO_S_INIT, SO_S_CAP)
    mono.steady_polish = functools.partial(real_polish,
                                           max_newton=SO_POLISH_NEWTON)
    try:
        for case in ("A2", "A6"):
            out = {}
            with bell_format(), contextlib.redirect_stdout(sys.stderr):
                j.suite_S(out, False, force=True, cases=(case,))
            yield "S_" + case, out["S_" + case]
    finally:
        j.shmip.initialize, mono.steady_polish = real_init, real_polish
    states = []

    def recorded(f):
        run = jax.jit(f)

        def call(s, forcing):
            s, d = run(s, forcing)
            states.append(np.asarray(s.N).tolist())
            return s, d
        return call
    real_jax = j.jax
    j.jax = types.SimpleNamespace(jit=recorded, tree_util=jax.tree_util)
    out = {}
    with patched(j.shmip, **SO_X_INIT), \
            contextlib.redirect_stdout(sys.stderr):
        j.suite_artesian(out, True)
    j.jax = real_jax
    yield "artesian_D5", dict(out["artesian_D5"], N=states)


# chip_smoke.py phase 22's cuts of suite S (A2, A6 at the suite's 60 x 12,
# capped as SO_S_CAP) and of the stationarity leg (from the E1 state of
# SHMIP_CUTS, a few FV steps on the JAX script's 48 x 12 grid)
SO_CUTS = {"S": dict(init=dict(nx=60, ny=12), cap=SO_S_CAP,
                     polish_newton=SO_POLISH_NEWTON),
           "stationarity": dict(nx=48, ny=12, years=2e-4)}


def so_at_cut():
    """The JAX script's suite S for A2 and A6 at SO_CUTS["S"] in block-ELL,
    and valley_stationarity.main from the E1 state of SHMIP_CUTS at
    SO_CUTS["stationarity"]."""
    import functools

    import shakti_tpu.solve.monolithic as mono
    j = by_path(os.path.join("scripts", "shmip_validate.py"),
                "jax_shmip_validate")
    j._save_cache = lambda out: None
    c = SO_CUTS["S"]
    real_init, real_polish = j.shmip.initialize, mono.steady_polish
    j.shmip.initialize = capped_steady(j.shmip, c["init"], c["cap"])
    mono.steady_polish = functools.partial(real_polish,
                                           max_newton=c["polish_newton"])
    out = {}
    try:
        with bell_format(), contextlib.redirect_stdout(sys.stderr):
            j.suite_S(out, False, force=True, cases=("A2", "A6"))
    finally:
        j.shmip.initialize, mono.steady_polish = real_init, real_polish
    res = {k: out[k] for k in ("S_A2", "S_A6")}
    md, st, _, _, _, _ = j.run_e_case("E1", **SHMIP_CUTS["E1"])
    vs = by_path(os.path.join("scripts", "valley_stationarity.py"),
                 "jax_valley_stationarity")
    xy = np.stack([md.x, md.y], axis=1)
    vs.fem_e1_state = lambda: (xy, md.to_user_order(st.N),
                               md.to_user_order(st.b))
    s = SO_CUTS["stationarity"]
    with tempfile.TemporaryDirectory() as tmp:
        vs.OUT = os.path.join(tmp, "out.json")
        with contextlib.redirect_stdout(sys.stderr):
            vs.main(s["nx"], s["ny"], s["years"])
        with open(vs.OUT) as f:
            res["stationarity"] = json.load(f)
    return res


def write_so_cut():
    """so_at_cut() into CUT_JSON as ``so``, its cuts under cuts.so."""
    with open(CUT_JSON) as f:
        rec = json.load(f)
    rec["so"] = _in_child("cut", "so")
    rec["cuts"]["so"] = SO_CUTS
    print("so", json.dumps(rec["so"])[:400], flush=True)
    with open(CUT_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")


# tests/test_torch_f5_{ell,bell}.py's run: SHMIP F5 on the valley at 300 m,
# 12 steps a day from the cold start, a window of one step at a time
F5_INIT = dict(days=2, resolution=300.0, nt_per_day=12)
F5_STEPS = 5
F5_JSON = os.path.join(ROOT, "tests", "torch_f5_ref.json")


def f5_steps(operator, steps=F5_STEPS):
    """F5 at F5_INIT in float64 in ``operator``'s format ("ell", "bell", or
    "bell_nolag": block-ELL with the operator carry off), ``steps``
    single-step windows: per step the Newton and CG counts, ``converged``
    and N in user order."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import setups.setup_shmip as shmip
    from shakti_tpu.solve.timestep import (make_forcing, make_step_fn,
                                           run_window)
    md = shmip.initialize("F5", **F5_INIT)
    md.operator = operator.removesuffix("_nolag")
    if operator.endswith("_nolag"):
        md.solver = dataclasses.replace(md.solver, lag_operator=False)
    mesh, static, state, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    forcing = make_forcing(md.timesteps, dtype=md.dtype,
                           degree_day=md.degree_day)
    runner = jax.jit(lambda s, f: run_window(step, s, f))
    rows = []
    for k in range(steps):
        state, d = runner(state, jax.tree_util.tree_map(
            lambda a: a[k:k + 1], forcing))
        rows.append({"newton": int(np.asarray(d["newton_iters"])[0]),
                     "cg": int(np.asarray(d["cg_iters"])[0]),
                     "converged": bool(np.asarray(d["converged"])[0]),
                     "N": md.to_user_order(state.N).tolist()})
    return {"operator": operator, "dtype": str(md.dtype),
            "n_nodes": int(md.x.size), "steps": rows}


def write_f5():
    """f5_steps in both formats, each in a fresh interpreter, into
    F5_JSON."""
    rec = {"what": "the JAX package's SHMIP F5 at tests/torch_examples_ref"
                   ".py's F5_INIT, single-step windows from the cold start",
           "written_by": "python tests/torch_examples_ref.py f5",
           "init": F5_INIT}
    for op in ("ell", "bell", "bell_nolag"):
        rec[op] = _in_child("f5", op)
        print(op, json.dumps([{k: v for k, v in r.items() if k != "N"}
                              for r in rec[op]["steps"]]), flush=True)
    with open(F5_JSON, "w") as f:
        json.dump(rec, f)
        f.write("\n")


# tests/test_torch_examples.py's cuts
TEST_CUTS = {
    "calibrate_melt": dict(nx=8, ny=8, days=2 / 16, nt_per_day=16,
                           iters=2),
    "invert_melt_field": dict(nx=6, ny=6, days=2 / 24, nt_per_day=24,
                              iters=3),
    "ensemble_uq": dict(members=2, days=1.0, nx=6, ny=6),
    "lake_workflow": dict(nx=8, ny=8, days=1.0, nt_per_day=4),
}


def examples_tests():
    """The JAX examples' code paths at TEST_CUTS in float64 (ensemble_uq
    and lake_workflow in block-ELL), name by name: (name, record)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    for name, cut in TEST_CUTS.items():
        with (bell_format() if name in BELL else contextlib.nullcontext()):
            yield name, AT_CUT[name](**cut)


class Child:
    """``python tests/torch_examples_ref.py FLAG`` (``--bf-tests`` or
    ``--examples-tests``) in a child process, its JSON lines ({name:
    record}) written to ``folder``: a test file's JAX references computed
    beside the port's runs.  ``child(name)`` waits for name's record."""

    def __init__(self, flag, folder):
        self.out = os.path.join(folder, "out")
        self.err = os.path.join(folder, "err")
        with open(self.out, "w") as o, open(self.err, "w") as e:
            self.proc = subprocess.Popen(
                [sys.executable, __file__, flag], cwd=ROOT, stdout=o,
                stderr=e, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        self.got = {}

    def __call__(self, name):
        import time
        while name not in self.got:
            with open(self.out) as f:
                for line in f.read().splitlines():
                    self.got.update(json.loads(line))
            if name not in self.got:
                if self.proc.poll() is not None:
                    with open(self.err) as f:
                        raise RuntimeError(
                            f"{self.proc.args[-1]} exited "
                            f"{self.proc.returncode} before {name}:\n"
                            + f.read()[-4000:])
                time.sleep(0.2)
        return self.got[name]

    def close(self):
        self.proc.kill()
        self.proc.wait()


AT_CUT = {"calibrate_melt": calibrate_at_cut,
          "invert_melt_field": invert_at_cut,
          "ensemble_uq": ensemble_at_cut, "lake_workflow": lake_at_cut,
          "basin_pipeline": basin_at_cut, "shmip": shmip_at_cut,
          "so": so_at_cut}


def at_cut(name, **cut):
    return AT_CUT[name](**(cut or CUTS.get(name, {})))


# ------------------------------------------------------------- full size

def _captured(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


_F = r"([-+]?\d+\.?\d*(?:e[-+]?\d+)?)"


def parse(name, text):
    """The numbers of an example's printed lines."""
    def all_(pat):
        return [tuple(float(v) for v in m) if isinstance(m, tuple)
                else float(m) for m in re.findall(pat, text)]

    if name == "calibrate_melt":
        rows = all_(rf"iter +\d+  s = {_F}  loss = {_F}  grad = {_F}")
        s, err = all_(rf"# recovered s = {_F} \(relative error {_F}\)")[0]
        return {"s": s, "rel_err": err, "rows": [
            {"s": a, "loss": b, "grad": c} for a, b, c in rows]}
    if name == "invert_melt_field":
        rows = all_(rf"iter +(\d+)  loss = {_F}  field rel error = {_F}")
        err, err0 = all_(rf"relative L2 error {_F} \(from {_F}")[0]
        return {"err0": err0, "err": err, "rows": [
            {"iter": int(i), "loss": b, "err": c} for i, b, c in rows]}
    if name == "ensemble_uq":
        rows = all_(rf"day +{_F}  mean N +{_F} MPa  ensemble spread \(std "
                    rf"of member means\) {_F} MPa  max member spread {_F}")
        mean, std = all_(rf"final mean-N across members: {_F} MPa \+/- {_F}")[0]
        return {"final_mean_MPa": mean, "final_std_MPa": std, "rows": [
            {"day": a, "mean_N_MPa": b, "spread_MPa": c,
             "max_member_spread_MPa": d} for a, b, c, d in rows]}
    if name == "lake_workflow":
        steps = all_(r"ran (\d+) steps in")[0]
        lvl, rate = all_(rf"lake level change: {_F} mm \({_F} m/yr\)")[0]
        gap, q = all_(rf"mean gap: {_F} mm; peak off-lake \|q\|: {_F}")[0]
        ratio = all_(rf"far-field N / N_bdry: {_F}")[0]
        frames = all_(r"rendered (\d+) frames")
        return {"steps": int(steps), "level_change_mm": lvl,
                "filling_rate_m_per_yr": rate, "mean_gap_mm": gap,
                "peak_flux_m2s": q, "far_field_ratio": ratio,
                "frames": int(frames[0]) if frames else None}
    if name == "basin_pipeline":
        v, nn, nt = all_(r"catchment outline: (\d+) vertices; mesh: (\d+) "
                         r"nodes / (\d+) triangles")[0]
        steps, lo, hi, newton = all_(
            rf"ran (\d+) steps: N in \[{_F}, {_F}\] Pa, newton_total=(\d+)")[0]
        return {"outline_vertices": int(v), "nodes": int(nn),
                "triangles": int(nt), "steps": int(steps), "N_min": lo,
                "N_max": hi, "newton_total": int(newton)}
    raise KeyError(name)


def full_one(name):
    """examples/<name>.py's main() at its defaults in ``name``'s
    interpreter: its printed numbers, its stdout and its wall time."""
    import time
    mod = example(name)
    with tempfile.TemporaryDirectory() as tmp:
        args = ((os.path.join(tmp, "out"),)
                if name in ("lake_workflow", "basin_pipeline") else ())
        t0 = time.time()
        text = _captured(mod.main, *args)
        wall = time.time() - t0
    return dict(parse(name, text), stdout=text, wall_s_cpu=round(wall, 1))


def _in_child(kind, name):
    """``kind`` ('full' or 'cut') of ``name`` in a fresh interpreter."""
    out = subprocess.run(
        [sys.executable, __file__, "--one", kind, name], cwd=ROOT,
        capture_output=True, text=True, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return json.loads(out.stdout.strip().splitlines()[-1])


def write_x64():
    """ensemble_x64() into examples/torch_examples_jax_ref.json as
    ``ensemble_uq_x64``."""
    with open(FULL_JSON) as f:
        rec = json.load(f)
    rec["ensemble_uq_x64"] = _in_child("x64", "ensemble_uq")
    print("ensemble_uq_x64", json.dumps(rec["ensemble_uq_x64"]), flush=True)
    with open(FULL_JSON, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")


def write(kind):
    if kind == "x64":
        return write_x64()
    if kind == "f5":
        return write_f5()
    if kind == "so-cut":
        return write_so_cut()
    path = FULL_JSON if kind == "full" else CUT_JSON
    rec = {"what": ("the JAX examples' main() at their defaults, printed "
                    "numbers parsed" if kind == "full" else
                    "the JAX examples' code paths at tests/"
                    "torch_examples_ref.py's CUTS, full precision"),
           "written_by": "python tests/torch_examples_ref.py " + kind}
    if kind == "cut":
        rec["cuts"] = dict(CUTS, shmip=SHMIP_CUTS, so=SO_CUTS)
    for name in NAMES + (("shmip", "so") if kind == "cut" else ()):
        rec[name] = _in_child(kind, name)
        print(name, json.dumps({k: v for k, v in rec[name].items()
                                if k not in ("stdout", "theta", "rows")}),
              flush=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] in (["--bf-tests"], ["--examples-tests"],
                        ["--so-tests"]):
        # a JSON line per run as it ends (Child)
        runs = {"--bf-tests": shmip_bf_tests, "--so-tests": so_tests,
                "--examples-tests": examples_tests}[sys.argv[1]]()
        for name, rec in runs:
            print(json.dumps({name: rec}), flush=True)
    elif sys.argv[1:2] == ["--one"]:
        kind, name = sys.argv[2:4]
        with (bell_format() if name in BELL else contextlib.nullcontext()):
            res = (full_one(name) if kind == "full" else ensemble_x64()
                   if kind == "x64" else f5_steps(name) if kind == "f5"
                   else at_cut(name))
        print("\n" + json.dumps(res))
    else:
        for kind in sys.argv[1:] or ("full", "cut"):
            write(kind)
