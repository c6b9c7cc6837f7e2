"""Smoke test of the PyTorch/CUDA port (shakti_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU
    python3 chip_smoke.py --phases kernel,scale   # a subset, for debugging

Phases (any failure raises: exit code != 0 and no result line):
  1. the card: torch.cuda must be available; prints its name and
     nvidia-smi's name/power limit;
  2. build: compiles csrc/bell_spmv.cu, csrc/ell_spmv.cu and
     csrc/element_batched.cu with nvcc for sm_90a, one nvcc per source,
     started together;
  3. bell_spmv vs plain: the block-ELL operator kernel (the structural
     nonzeros of vals, with and without the fused Dirichlet/diagonal-floor
     epilogue) on the bench operator (Cook_E2 mesh, NB 96, KB 11, B 128,
     n 12,270, W 10; seeded element blocks folded as the main path folds
     them, the bench Dirichlet mask, a seeded increment), in float32 and
     float64, plus a small ragged case: bitwise equal to its mirror twin
     over the structural view, within float32 rtol 2e-6 / atol 1e-6 max|y|
     (float64 1e-12) of the dense plain twin, and bitwise repeatable.
     Times at the bench shape: the kernel's device time per launch from
     torch.profiler (median of 50; also with the L2 cache flushed), the
     time per call between CUDA events (host work included: the measure
     of "ms" since the first kernel), the dense plain twin's and one torch
     sparse CSR mv's (the library yardstick) both ways, the host's time per
     matvec fused (one launch) and composed as before the fusion (where,
     the product, where, mul, add), and the bound from the bytes the
     function needs at 3.35 TB/s;
  4. goldens on the card: the slab and lake golden cases in float64
     through the port, against tests/goldens/*.npz at
     tests/test_goldens.py's tolerance (1e-7 of scale), every step
     converged;
  5. main path at full size: the bench model (setups/setup_bench.py, a port
     of bench.py:build_bench_model) through api/run.solve for 2 simulated
     days (48 hourly steps, f32, lag on) into a temporary results dir; every
     step converged, all fields finite, history files present, the
     kernel launched by that run, the carried operator zero outside the
     structural view, and newton_mean / cg_mean within 5 % of the
     earlier dense kernel's;
  6. profile: one more simulated day, timed, then under torch.profiler
     (device busy share, launches and host syncs per step, device time by
     op, the kernel's launches and device time on the path), to show where
     a steady step's time goes;
  7. ell_spmv vs plain: the scalar-ELL/block-CSR operator kernel over the
     structural values (W, n) at the bench mesh in ELL and in BCSR (B 32),
     at phase 8's 1,002,001-node BCSR mesh and a ragged n = 169 case in
     both, float32 and float64, with and without the epilogue: bitwise
     equal to its plain version (its mirror: the same operations in the
     same order) and between two launches, within phase 3's tolerances of
     the dense plain product (fem/ell.to_dense, then the JAX-layout
     matvec); the structural fold scattered by to_dense equals the dense
     fold bit for bit; device time per launch (profiler, median of 50),
     the bytes bound (one value and one 4-byte column per structural
     nonzero, 4 bytes per row, the vectors) and a torch sparse CSR mv of
     the same entries;
  8. large mesh: scripts/scale_bench.py's configuration on the port
     (rectangle_mesh(1000, 1000, 2e6, 2e6, jitter 0.25): 1,002,001 nodes,
     2M triangles, f32, two-level, no lag), "auto" -> block-CSR B 32,
     coarse block 1024, 24 steps through api/run.solve with nt_save 12:
     every step converged, fields finite, ell_spmv launched and no plain
     version called, every fold the structural (W, n) (never the
     nnzb * B * B blocks); ms/step of the second window, counts, peak
     memory and the host time of freeze; then three more steps under
     torch.profiler (device busy share, launches and host syncs per step,
     device time by op);
  9. formats agree: the bench model in float64 for 4 hourly steps under
     bell, ell, bcsr (B 32) and cells: all converge, final N and b in user
     order within 1e-7 of scale of bell's; Newton and CG counts per format;
 10. resume: phase 5's uninterrupted run against 25 steps then --resume
     through cli.main to step 48: N, b, q and the four histories equal;
 11. bootstrap: setup_cooke2 (the committed mesh, SHAKTI_REFERENCE_BINIT=1)
     for 3 days: 24 float64 bootstrap steps marched on the card (every
     bootstrap tensor float64 on cuda), then float32; all 72 converge;
 12. BiCGStab: the bench model in float64 for 4 steps with
     krylov="bicgstab": converges, N within 1e-7 of scale of phase 9's cg;
 13. mg: the multilevel V-cycle (precond="mg", Chebyshev degree 2, agg 4):
     (a) the bench model in float64 for 4 steps in bell, ell and bcsr (B
     32), hierarchy 12,270 -> 3,068 -> dense 767: converged, N and b in user
     order within 1e-7 of scale of phase 9's bell two-level run; (b) phase
     8's 1M-node model under mg (the same freeze, the hierarchy attached as
     freeze attaches it: 1,002,001 -> 250,501 -> 62,626 -> 15,657 -> 3,915
     -> dense 979), 24 steps through api/run.solve: converged, finite,
     ell_spmv launched at least 5 times per CG iteration, no plain version
     called; Newton and CG per step, ms/step of window 2 and peak memory
     beside phase 8's, the host time of the hierarchy, three profiled steps
     and the V-cycle apply's launches, device time and host syncs (0);
 14. steady: setup_slab 16 x 16 in float64 through solve_steady (tol 2e-2,
     tests/test_steady.py's case): verdict steady, rate < tol, boundary
     drift above it; 10 explicit hourly steps from the state move it less
     than the certified rates allow; Q_out against Q_src; a segmented
     march killed after one 64-attempt segment and resumed ends bit-identical
     to the uninterrupted one; the CLI's --steady writes steady.npz and
     steady_info.json;
 15. polish: the monolithic coupled steady Newton (solve/monolithic.py,
     float64, dense LU of the colored Jacobian): (a) steady_polish(tol 1e-6)
     from phase 14's slab PTC state (marched here when phase 14 is not run):
     converged, rate_b < 1e-6, resN_rel < 1e-7, n_fixed > 0, dtau_seed=None
     agreeing to rtol 1e-6, 10 hourly transient steps moving the free gap
     less than 1e-3 of a year's worth; (b) SHMIP A1 at suite-S width
     (setup_shmip 60 x 12, 793 nodes, block-ELL) through
     solve_steady(tol 1e-3, max_steps 300, polish=True): verdict polished,
     rate < 1e-3, Q_out against Q_src within 1e-6, relN over x in [30, 90]
     km against oracle/shmip_oracle.steady_profile within 5e-4; bell_spmv
     launched by that run; PTC steps and polish Newton iterations beside the
     JAX package's on the CPU, the colors, peak memory, and (torch.profiler
     over the same polish, repeated from the march's state: bit-identical)
     launches, device time and host syncs per Newton iteration split into
     Jacobian, LU and Armijo; a polish killed after its first segment and
     resumed from polish.npz ends bit-identical;
 16. adjoint: the differentiable transient (solve/implicit.py) on the bench
     model in float64 with a uniform 1e-8 m/s recharge, lag off,
     differentiable=True and tests/test_adjoint.py's tight tolerances, 6
     hourly steps: the forward bitwise equal to differentiable=False;
     d mean(N)/d inputs_scale and, through make_runner, the gradient with
     respect to the (n,) inputs field along a seeded direction, each within
     rel 1e-5 of a central difference; every backward matvec a bell_spmv
     launch on the transposed operator (none through a plain version), the
     last one held against its plain version; adjoint CG counts, forward
     and backward ms per step, peak memory;
 17. ensemble: the bench model in float32, M = 8 members of
     perturbed_ensemble(b_scale 5e-4, seed 0), 24 hourly steps through
     make_ensemble_runner: converged, finite, every matvec one
     member-batched bell_spmv launch (none through a plain version);
     members 0 and 7 run alone give equal Newton counts and N within 1e-4
     of scale; in float64, M = 3 over 4 steps equals the member runs within
     1e-10; the batched launch (M = 8 f32, M = 3 f64) bitwise equal to M
     single launches and within phase 3's tolerances of the plain version,
     with its device time beside 8 single launches, the plain version, a
     block-diagonal torch sparse CSR mv of the 8 operators and its bytes
     bound; ms per step and per member-step beside the members' own runs;
 18. cooke2: the reference's production experiment from its potential
     field to its validation battery, through the port alone: (a)
     scripts/make_cooke2_mesh.py's pipeline (the seeded 600 x 600
     potential, mesh/basin.basin_outline, the catchment scaled to the
     reference mesh's node count, polygon_mesh, write_msh, read back)
     equal to assets/cooke2_synth (outline, lake and nodes bitwise, cells
     as a set of triangles); (b) an npz lake inventory (save_inventory_npz)
     and setup_cooke2 on that mesh for 10 days in float32 through
     api/run.solve (240 steps, daily saves, log.csv): converged, finite,
     block-ELL, bell_spmv launched and no plain matvec; (c) the battery of
     scripts/cooke2_report.py through post (far-field ratio, lake level
     equal to -(mean N - mean N_0)/(rho_w g) from the N history, filling
     rate, mean gap, off-lake peak flux), finite, printed beside
     COOKE2_RUN.md's 10-year TPU numbers for orientation only; the run's
     last day again from its final state, timed and profiled as in phase
     6 (busy share, launches and syncs per step, device time by op); (d) 96
     hourly steps in float32 and float64 from the setup's state: relative
     L2 of N and b < 2e-3 (tests/test_precision.py's guard); (e) bell_spmv
     on the run's last operator within phase 3's tolerances of its plain
     version, in float32 and float64.
 19. dist: the distributed path (parallel/dist.py, halo.py, shard.py,
     utils/multihost.py; api/run.py and api/steady.py with md.distributed)
     on gloo ranks that this script spawns (chip_smoke.py --dist-rank),
     time-sliced on the one card (the 4-rank bench world beside the
     2-rank steady world, then the 8-rank toy), each rank with a
     wall-clock limit and a clock on its collectives (their count, time
     and share of the rank's wall time): (a) the
     bench model in float64 for 4 steps on 4 ranks, the global two-level in
     per-rank block-ELL and mg in per-rank block-CSR: N and b in user order
     within 1e-7 of scale of phase 9's bell run (phase 13 (a) holds its mg
     runs against the same), Newton counts equal to single-device runs with
     the ranks' settings (no operator carry), CG beside; per rank the
     kernel's launches (none through a plain version), L, omax and peak
     memory; bell_spmv and ell_spmv against their plain versions on rank
     0's last operator (ghost rows, dead slots); (b) the bench model in
     float32 through api/run.solve on 4 ranks for 48 steps: the save rows
     after the first within 1e-4 of scale of a single-device run with the
     ranks' settings (two-level aggregates of 16, no operator carry); the
     first row, after the cold start's dt/10 step, no farther from a
     float64 run with those settings than twice the single-device f32 run
     (every f32 run is ~25 % of scale from it there); the errors against
     phase 5's run printed; only rank 0 holding the rows, and a run of 25
     steps resumed to 48 equal to it; (c) the 8 x 8 toy of
     __graft_entry__.dryrun_multichip on 8 ranks, one step cell-sharded,
     halo, and halo with block-ELL and mg: Newton equal to
     MULTICHIP_r05.json's, CG beside; (d) the 16 x 16 slab in float64
     through solve_steady on 2 ranks: verdict steady in phase 14's PTC
     steps, N within 1e-8 of scale of its; (e) the bench model for 4
     float64 steps on a world of one rank under NCCL on cuda:0 and under
     gloo: bitwise equal.  Every rank's counts and residual norms equal.
 20. dist_adjoint: the distributed adjoint (halo.py's recorded exchanges,
     dist.localize, make_distributed_runner(control="inputs"),
     solve/implicit.py's halo branch) on 2 gloo ranks spawned as in phase
     19: phase 16's model (bench, float64, 1e-8 m/s recharge, lag off,
     tight tolerances) for 3 hourly steps, each rank differentiating its
     owned-row share of mean(N) with respect to inputs_scale and the
     localized inputs field: (a) every rank's forward bitwise equal to
     differentiable=False; (b) the rank-summed d mean(N)/d inputs_scale
     within 1e-6 of the single-device adjoint on the same model and steps
     and 2e-5 of a central difference of the distributed forward; (c) the
     field's derivative along a seeded direction within 1e-4 of its
     central difference; (d) bell_spmv on rank 0's last transposed
     operator within phase 3's tolerances of its plain version; (e) per
     rank the backward's launches (none through a plain version), the
     backward's and forward's wall time, the collectives' share of each
     (phase 19's clock) and peak memory.
 21. validate: the port's validation drivers (scripts/torch_*.py, twins of
     scripts/cooke2_report.py, shmip_validate.py, cooke2_steady.py) on the
     card: (a) torch_cooke2_report.analyze over phase 18's results
     directory equal to phase 18's battery (rounded as the report rounds);
     (b) one year of SHMIP A1 (60 x 12, 4 steps a day, float64) through
     torch_shmip_validate.run_case: every step converged, relN_win against
     the 1D oracle within 1 % of the JAX package's year 1
     (scripts/shmip_results.json), bell_spmv launched, no plain operator
     called; (c) torch_cooke2_steady.compute (the direct float64 steady
     Cook_E2) capped at 3 PTC steps: finite, on bell_spmv likewise.  The
     full runs (the 10-year Cook_E2, suite A, S_A1, the steady Cook_E2) are
     the scripts' own commands, not this script's.
 22. drivers: the JAX package's drivers on the port at cuts, held to the
     JAX package's code paths at the same cuts (tests/torch_examples_ref.py
     on the CPU, committed as tests/torch_examples_cut_ref.json), at the
     JAX examples' widths with fewer steps and iterations: (a) the five
     example twins (examples/torch_*.py): calibrate_melt on the 16x16 slab
     and invert_melt_field on the 20x20 one, their secant iterates and
     Adam updates (float64, 1e-8), the checkpointed calibration step
     against the unwrapped one (equal Newton/CG counts in the
     recomputation, equal gradient, both peak memories), ensemble_uq's 8
     members on the 24x24 slab for a day (float32, member-batched
     launches; mean N within 1e-3), lake_workflow's post numbers through
     api/run at 24x24 (float32, 1e-2: a cold start in float32),
     basin_pipeline's 757-node mesh (equal counts, N finite, Newton total
     within 1); (b) SHMIP's runners (scripts/torch_shmip_validate.py,
     float64): B5 on 60x12 for 30 days, C1 for its two sampled days at
     24 steps a day from it, D5 for 10 days and F5 for 2 hourly days with
     the degree-day forcing and no spin, E1 for two hourly days on the
     1,316-node valley with the certified budget: every step converged,
     within 1e-6 of JAX's, and X (the artesian study) from D5's windows;
     (c) suite S for A2 and A6 at 60x12 in block-ELL, solve_steady capped
     at 3 PTC steps and a polish of 2 Newton iterations (verdict and
     counts as JAX's, the values within 1e-6), the stationarity leg
     (scripts/torch_valley_stationarity.py) from (b)'s E1 state for a few
     FV steps (within 1e-5 of JAX's from its own E1 state) and O_ladder at
     nx = 200 (within 1e-8 of scripts/shmip_results.json).  Every
     bell_spmv launch (single and member-batched) counted, none through a
     plain version; the kernel held to its plain version (f32 rtol 2e-6,
     f64 1e-12) on each run's last operator (S's: its march's), the
     batched launch on the ensemble's.
 23. element: the ensemble's element kernels (csrc/element_batched.cu,
     ops/element_cuda.py) at cooke2-ens128's shapes: setup_cooke2 on the
     Cook_E2 mesh, 128 members stepped twice in float32 (the launches of
     both libraries counted), then at that state in float32 and float64
     the Jacobian and the 3-column residual against the plain twin (1e-5
     / 1e-12 of the largest entry: FMA contraction and the quadrature
     sums' order), each column bitwise a 1-column launch, the node sum
     bitwise the twin's, two launches bitwise equal; in float32 each
     launch's device time beside its bytes bound, the twin's time and the
     forward-AD route's (vmap of physics/residual's functions, the route
     the batched Newton solve took before).
 24. coarse: the ensemble's coarse operators (coarse_batched of
     csrc/element_batched.cu, ops/element_cuda.coarse) at cooke2-ens128's
     shapes: 128 members stepped twice in float32 under the two-level
     preconditioner, one launch per Newton iteration of the ensemble; at
     that state, at the run's aggregate size and at 64 nodes, in float32
     and float64 the coarse operators from the element Jacobian bitwise
     the plain twin's and two launches bitwise equal; in float32 the
     launch's device time beside its bytes bound, the twin's, the batched
     preconditioner build's and that of the vmapped coarse_from_values
     route it replaces (the inverses of both compared); with phase 17 run,
     its members' f32 reading repeated beside them.
The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def host_us(fn, reps=1000, warmup=20) -> float:
    """Host time of one fn() call in microseconds: perf_counter around
    ``reps`` calls issued back to back (the card runs behind them), before
    the final synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def median_ms(fn, reps=50, warmup=5) -> float:
    """Median time of one fn() call between two CUDA events over ``reps``
    calls: the host work inside fn (Python, allocation, the launch) counts
    too."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def queued_ms(fn, reps=50, between=None) -> float:
    """Device time of one fn() call without the profiler: ``reps`` calls
    queued behind a device-side sleep, so that the card runs them back to
    back, timed between two CUDA events (the gaps between kernels count).
    With ``between``: the time of between() + fn() less that of between()
    alone, queued the same way.  The sleep doubles until the host has
    queued every call before the card reaches the first event."""
    def run(body):
        cycles = 50_000_000
        for _ in range(6):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            a.record()
            for _ in range(reps):
                body()
            b.record()
            late = a.query()        # the card reached `a` before all were queued
            torch.cuda.synchronize()
            if not late:
                return a.elapsed_time(b) / reps
            cycles *= 2
        raise RuntimeError("queued_ms: the host could not queue the calls "
                           "ahead of the card")
    if between is None:
        return run(fn)
    return run(lambda: (between(), fn())) - run(between)


def device_ms(fn, match=None, reps=50, warmup=5, between=None) -> float:
    """Device time from torch.profiler (CUPTI).  With ``match``: the median
    over ``reps`` calls of the one kernel per call whose name contains it
    (``between`` runs untimed before each call).  Without: all device time
    of ``reps`` calls over ``reps`` (a call may launch several kernels).
    CUPTI drops records at random, at times a whole session's (seen on an
    H100 with torch 2.11): with ``match`` the records of up to eight
    sessions are pooled until they hold ``reps``; without, the session
    that kept the most records of three (up to eight while none kept any)
    is taken.  If the profiler still kept too few, the time comes from
    :func:`queued_ms` and the log says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if between is not None and match is None:
        raise ValueError("device_ms: `between` needs `match`")
    for _ in range(warmup):
        fn()
    pool, best = [], []
    for attempt in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if match is None:
            if len(evs) > len(best):
                best = [e.time_range.elapsed_us() for e in evs]
            if best and attempt >= 2:
                return sum(best) / reps / 1e3
            continue
        us = [e.time_range.elapsed_us() for e in evs if match in e.name]
        if len(us) != reps:
            log(f"  profiler kept {len(us)} of {reps} {match!r} records")
        pool += us
        if len(pool) >= reps:
            return float(np.median(pool)) / 1e3
    ms = queued_ms(fn, reps, between)
    log(f"  profiler kept {len(pool) or len(best)} records in eight sessions "
        f"of {reps} calls ({match!r}): {ms:.5f} ms from CUDA events around "
        f"{reps} calls queued behind a sleep")
    return ms


def check_close(name, got, ref, rtol, atol_rel):
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    atol = atol_rel * np.abs(ref).max()
    err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)
    log(f"  {name}: max|kernel - plain| = {err:.3e} (max|y| "
        f"{np.abs(ref).max():.3e}, rtol {rtol:g}, atol {atol:.3e})")
    return err


def bitwise_equal(a, b) -> bool:
    itype = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(itype), b.view(itype))


TOLS = ((torch.float32, 2e-6, 1e-6), (torch.float64, 1e-12, 1e-12))
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, NVIDIA data sheet
FLOPS = {torch.float32: 67e12, torch.float64: 34e12}  # outside tensor cores


def operator_inputs(mesh, dirichlet, rng):
    """Seeded operator inputs as the main path makes them: element blocks
    folded by fem/bell.bell_from_elements, x, and a non-negative diagonal
    increment that is zero on Dirichlet rows."""
    dev = mesh.nodes.device
    J = rng.standard_normal((mesh.n_cells, 3, 3))
    x = rng.standard_normal(mesh.n_nodes)
    extra = rng.random(mesh.n_nodes) * ~dirichlet.cpu().numpy()
    return {k: torch.as_tensor(v, device=dev) for k, v in
            (("J", J), ("x", x), ("extra", extra))}


def wrappers(kernel):
    """(operator_fn, dense plain product, mirror) of kernel 'bell_spmv' or
    'ell_spmv' (ops/spmv_cuda.py); ell_spmv's mirror is its plain
    version."""
    from shakti_tpu_torch.ops import spmv_cuda as sp
    if kernel == "bell_spmv":
        return (sp.bell_operator_fn, sp.bell_operator_plain,
                sp.bell_operator_structural)
    return sp.ell_operator_fn, sp.ell_operator_dense, sp.ell_operator_plain


def check_operator(tag, vals, mesh, x, dirichlet, extra, rtol, atol_rel,
                   kernel="bell_spmv"):
    """The kernel against its mirror twin (bitwise), the plain twin
    (tolerance) and itself (bitwise); returns the error against the plain
    twin."""
    operator_fn, plain, mirror = wrappers(kernel)
    op = operator_fn(vals, mesh, dirichlet, extra)
    y = op(x)
    ym = mirror(vals, mesh, x, dirichlet, extra)
    dense = plain(vals, mesh, x, dirichlet, extra)
    torch.cuda.synchronize()
    if not bitwise_equal(y, ym):
        bad = int((y != ym).sum())
        raise RuntimeError(f"{kernel} {tag}: differs from its mirror twin in "
                           f"{bad} rows (max {float((y - ym).abs().max())})")
    err = check_close(tag, y, dense, rtol, atol_rel)
    if not bitwise_equal(op(x), y):
        raise RuntimeError(f"{kernel} {tag}: two launches differ")
    return err


def bound(nnz, n, dtype, epilogue: bool, index_bytes: int, row_bytes: int):
    """(ms, 'bytes' or 'operations'): the least time of one operator matvec
    on this card's published peaks, from what this run's operator needs:
    each structural nonzero's value and ``index_bytes`` of indices,
    ``row_bytes`` per row, x and y once, plus the mask and extra with the
    epilogue; 2 flops a nonzero (3 per row more with the epilogue)."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = nnz * (es + index_bytes) + row_bytes * n + 2 * n * es
    if epilogue:
        nbytes += n + n * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2 * nnz + (3 * n if epilogue else 0)) / FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bell_bound(mesh, dtype, epilogue: bool):
    """bell_spmv: one int32 position per nonzero, one int32 length a row."""
    nnz = int((mesh.bell_nz_pos >= 0).sum())
    return bound(nnz, mesh.n_nodes, dtype, epilogue, 4, 4)


def ell_bound(mesh, dtype, epilogue: bool, index_bytes=4, row_bytes=4):
    """ell_spmv: what any sparse format must read, one int32 column per
    structural nonzero and 4 bytes per row (a length or an offset).  With
    (8, 0): the bound as it was counted for the earlier kernel, a position
    and a column per nonzero."""
    nnz = int((mesh.nz_pos >= 0).sum())
    return bound(nnz, mesh.n_nodes, dtype, epilogue, index_bytes, row_bytes)


def csr_of(vals, pos, col, n):
    """The same structural entries of the same vals as a torch sparse CSR
    matrix (int32 indices, columns ascending in each row): the library
    yardstick, never used by the port.  ``pos``/``col``: a (W, n) view."""
    pos, col = pos.long(), col.long()
    valid = pos >= 0
    rows = torch.arange(n, device=pos.device).expand_as(pos)[valid]
    cols, p = col[valid], pos[valid]
    order = torch.argsort(rows * n + cols)
    rows, cols, p = rows[order], cols[order], p[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=pos.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow.int(), cols.int(), vals.reshape(-1)[p],
                                   (n, n), check_invariants=True)


def library_times(r, tag, vals, pos, col, n, x, ref, dtype, atol_rel,
                  flush=None):
    """One torch sparse CSR mv of the same entries: checked against the
    kernel's product ``ref`` and timed (device and events) into ``r``; with
    ``flush`` (a call that empties the L2) also with a cold L2
    (:func:`queued_ms`)."""
    try:
        A = csr_of(vals, pos, col, n)
        check_close(f"{tag} library CSR vs kernel", torch.mv(A, x), ref,
                    1e-5 if dtype == torch.float32 else 1e-12, atol_rel)
        r["library_device_ms"] = device_ms(lambda: torch.mv(A, x))
        r["library_ms"] = median_ms(lambda: torch.mv(A, x))
        if flush is not None:
            r["library_queued_ms_cold_l2"] = queued_ms(
                lambda: torch.mv(A, x), between=flush)
        del A
    except RuntimeError as e:
        log(f"  library sparse CSR mv refused in {tag}: {e}")
        r["library_device_ms"] = r["library_ms"] = None
        if flush is not None:
            r["library_queued_ms_cold_l2"] = None


def phase_kernel(dev, mesh, dirichlet):
    from shakti_tpu_torch.fem.bell import bell_from_elements
    from shakti_tpu_torch.ops.spmv_cuda import (bell_operator_fn,
                                                bell_operator_plain,
                                                view_columns)
    inp = operator_inputs(mesh, dirichlet, np.random.default_rng(0))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)  # > L2
    out = {}
    for dtype, rtol, atol_rel in TOLS:
        tag = str(dtype).removeprefix("torch.")
        vals = bell_from_elements(inp["J"].to(dtype), mesh)
        x, extra = inp["x"].to(dtype), inp["extra"].to(dtype)
        err = {}
        for epi, (d, e) in (("product", (None, None)),
                            ("epilogue", (dirichlet, extra))):
            err[epi] = check_operator(f"bench shape {tag} {epi}", vals, mesh,
                                      x, d, e, rtol, atol_rel)
        op = bell_operator_fn(vals, mesh, dirichlet, extra)
        prod = bell_operator_fn(vals, mesh)
        r = dict(max_abs_err=err["epilogue"], max_abs_err_product=err["product"])
        r["device_ms"] = device_ms(lambda: op(x), "bell_spmv")
        r["device_ms_product"] = device_ms(lambda: prod(x), "bell_spmv")
        r["device_ms_cold_l2"] = device_ms(lambda: op(x), "bell_spmv",
                                           between=flush.zero_)
        r["ms"] = median_ms(lambda: op(x))
        r["plain_device_ms"] = device_ms(
            lambda: bell_operator_plain(vals, mesh, x, dirichlet, extra))
        r["plain_ms"] = median_ms(
            lambda: bell_operator_plain(vals, mesh, x, dirichlet, extra))
        r["host_us"] = host_us(lambda: op(x))
        # the matvec as it was before the fusion: where, product, where, mul, add
        r["host_us_composed"] = host_us(lambda: torch.where(
            dirichlet, x, prod(torch.where(dirichlet, 0.0, x))) + extra * x)
        r["bound_ms"], r["bound_by"] = bell_bound(mesh, dtype, True)
        r["bound_ms_product"], _ = bell_bound(mesh, dtype, False)
        library_times(r, f"bench shape {tag}", vals, mesh.bell_nz_pos,
                      view_columns(mesh.bell_nz_pos, mesh.bell_nbr, mesh.bell_B),
                      mesh.n_nodes, x, prod(x), dtype, atol_rel)
        log(f"  bench shape {tag}: kernel device {r['device_ms']:.5f} ms/launch"
            f" (product only {r['device_ms_product']:.5f}, L2 flushed "
            f"{r['device_ms_cold_l2']:.5f}; median of 50, profiler), "
            f"{r['ms']:.5f} ms/call between CUDA events (host work "
            f"included); dense plain twin {r['plain_device_ms']:.5f} ms "
            f"device/call ({r['plain_ms']:.5f} events); library CSR mv "
            f"{r['library_device_ms']} ms device/call ({r['library_ms']} "
            f"events); bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"(product {r['bound_ms_product']:.5f})")
        log(f"  bench shape {tag}: host time per matvec {r['host_us']:.2f} us"
            f" fused, {r['host_us_composed']:.2f} us composed (where, "
            f"product, where, mul, add)")
        out[tag] = r
        del vals, op, prod
    del flush
    # a small ragged case: 169 nodes in two 128-blocks (12 x 12 slab mesh)
    from shakti_tpu_torch.setups import setup_slab
    md = setup_slab.initialize(nx=12, ny=12)
    md.dtype = torch.float64
    m, st, _, _ = md.freeze(dev)
    inp = operator_inputs(m, st.dirichlet, np.random.default_rng(1))
    for dtype, rtol, atol_rel in TOLS:
        tag = f"ragged n={m.n_nodes} {str(dtype).removeprefix('torch.')}"
        vals = bell_from_elements(inp["J"].to(dtype), m)
        x, extra = inp["x"].to(dtype), inp["extra"].to(dtype)
        check_operator(f"{tag} product", vals, m, x, None, None, rtol, atol_rel)
        check_operator(f"{tag} epilogue", vals, m, x, st.dirichlet, extra,
                       rtol, atol_rel)
    return out


def phase_goldens(dev):
    from shakti_tpu_torch.solve.timestep import (make_step_fn, run_window,
                                                 timestep_sizes)
    # by path: an installed top-level package named "tests" would shadow the
    # repository's tests/ directory (it has no __init__.py)
    spec = importlib.util.spec_from_file_location(
        "torch_golden_cases", os.path.join(HERE, "tests", "torch_golden_cases.py"))
    gc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gc)
    for case in gc.ALL_CASES:
        md, n, fname = case()
        md.dtype, md.device = torch.float64, dev
        mesh, static, state, cfg = md.freeze()
        step = make_step_fn(mesh, static, md.params, cfg)
        t0 = time.perf_counter()
        state, diags = run_window(step, state, timestep_sizes(
            md.timesteps, md.dtype, dev)[:n])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not diags["converged"].all():
            raise RuntimeError(f"{fname}: steps did not converge: "
                               f"{diags['converged']}")
        errs = gc.golden_errors(md, state, fname)
        log(f"  {fname}: {n} steps in {wall:.2f} s, newton "
            f"{diags['newton_iters'].tolist()}, max err/scale "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if max(errs.values()) > gc.GOLDEN_ATOL:
            raise RuntimeError(f"{fname}: golden drift {errs} > {gc.GOLDEN_ATOL}")


# the bench main path's solver counts with the earlier dense-stream kernel
# (48 f32 steps on an H100); a kernel that sums the same terms in another
# order may move them by roundoff, not by more than a few per cent
DENSE_NEWTON_MEAN, DENSE_CG_MEAN = 1.0625, 14.625


def phase_main(dev, tmp):
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.setups import setup_bench
    rdir = os.path.join(tmp, "bench_run")
    md = setup_bench.initialize(days=2, results_name=rdir)
    md.device = dev
    spmv_cuda.reset_launches()
    out = md.solve(progress=False)
    launches = spmv_cuda.launches["bell_spmv"]
    steps = out["steps"]
    if steps != 48:
        raise RuntimeError(f"expected 48 steps, ran {steps}")
    st = out["state"]
    for k in ("N", "b", "q", "melt"):
        if not torch.isfinite(getattr(st, k)).all():
            raise RuntimeError(f"non-finite {k} after the main path")
    n = md.nodes.shape[0]
    for k in ("N", "b", "qx", "qy"):
        h = np.load(os.path.join(rdir, f"{k}.npy"))
        if h.shape != (2, n) or not np.isfinite(h).all():
            raise RuntimeError(f"history {k}.npy: shape {h.shape}")
    for f in ("t.npy", "nodes_x.npy", "nodes_y.npy", "log.csv",
              "setup_bench.py"):
        if not os.path.exists(os.path.join(rdir, f)):
            raise RuntimeError(f"results file {f} missing")
    if launches <= 0:
        raise RuntimeError("the main path never launched the bell_spmv kernel")
    # the kernel reads vals only at the structural view: the carried operator
    # must be zero everywhere else
    vals = st.lag_op[2].reshape(-1)
    pos = md.freeze()[0].bell_nz_pos
    outside = vals.clone()
    outside[pos[pos >= 0].long()] = 0
    if int(torch.count_nonzero(outside)) or not int(torch.count_nonzero(vals)):
        raise RuntimeError(f"carried operator: {int(torch.count_nonzero(outside))}"
                           " nonzeros outside the structural view")
    res = dict(
        nodes=n, steps=steps, launches=launches,
        ms_per_step=1e3 * out["wall_time"] / steps,
        newton_mean=out["newton_iters_total"] / steps,
        cg_mean=out["cg_iters_total"] / steps,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log("  main path: " + json.dumps(res))
    for k, ref in (("newton_mean", DENSE_NEWTON_MEAN),
                   ("cg_mean", DENSE_CG_MEAN)):
        if abs(res[k] - ref) > 0.05 * ref:
            raise RuntimeError(f"{k} {res[k]} is not within 5 % of the dense "
                               f"kernel's {ref}")
    return res, md, st, rdir


def profile_steps(dev, step, state, forcing, kernel):
    """Where a steady step's time goes: the window ``forcing`` from
    ``state`` once unprofiled (timed), then again under torch.profiler:
    device busy share, launches and host syncs per step, ``kernel``'s
    launches and mean device time, device time by op.  Measurement only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shakti_tpu_torch.solve.timestep import run_window
    steps = int(forcing["dt"].shape[0])
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, d = run_window(step, state, forcing)
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0) / steps
    log(f"  {steps} steady steps: {ms:.3f} ms/step, newton_mean "
        f"{d['newton_iters'].mean():.4f}, cg_mean {d['cg_iters'].mean():.4f}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_window(step, state, forcing)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_ops = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in dev_ops) / 1e6
    count = {e.key: e.count for e in ka}
    res = dict(ms_per_step=ms, profiled_ms_per_step=1e3 * wall / steps,
               busy=dev_s / wall, device_ms_per_step=1e3 * dev_s / steps,
               launches_per_step=count.get("cudaLaunchKernel", 0) / steps,
               syncs_per_step=count.get("aten::_local_scalar_dense", 0) / steps,
               newton=d["newton_iters"].tolist(), cg=d["cg_iters"].tolist())
    log(f"  profiled: {res['profiled_ms_per_step']:.3f} ms/step, device busy "
        f"{100 * res['busy']:.1f} % ({res['device_ms_per_step']:.3f} ms/step),"
        f" {res['launches_per_step']:.1f} launches/step, "
        f"{res['syncs_per_step']:.1f} syncs/step")
    share = {e.key.removeprefix("aten::"): e.self_device_time_total
             for e in ka if e.device_type == DeviceType.CPU
             and e.key.startswith("aten::") and e.self_device_time_total}
    spmv = [e for e in dev_ops if kernel in e.key]
    share[kernel] = sum(e.self_device_time_total for e in spmv)
    n_spmv = sum(e.count for e in spmv)
    log(f"  {kernel} on the path: {n_spmv / steps:.2f} launches/step, "
        f"{share[kernel] / 1e3 / max(n_spmv, 1):.5f} ms/launch (mean)")
    log("  kernels per step by name: " + "; ".join(
        f"{e.key[:48]} {e.count / steps:.2f}"
        for e in sorted(dev_ops, key=lambda e: -e.count)[:12]))
    top = sorted(share.items(), key=lambda kv: -kv[1])[:12]
    log("  device time by op: " + ", ".join(
        f"{k} {100 * v / 1e6 / max(dev_s, 1e-12):.1f} %" for k, v in top))
    return res


def phase_profile(dev, md, state):
    """Phase 6: one more simulated day from the main path's final state."""
    from shakti_tpu_torch.solve.timestep import make_forcing, make_step_fn
    mesh, static, _, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    day = {k: v[24:48] for k, v in make_forcing(
        md.timesteps, dtype=md.dtype, device=dev).items()}
    profile_steps(dev, step, state, day, "bell_spmv")


def element_plan(mesh, dev):
    """The dense fold's plan from the mesh's element -> position maps alone
    (fem/ops.gather_plan over the JAX-layout fields, not the renumbered
    plan fold_structural and to_dense share): (slots, idx, size) for
    fem/ops.plan_sum."""
    from shakti_tpu_torch.fem.bcsr import fold_keys
    from shakti_tpu_torch.fem.ell import dense_shape
    from shakti_tpu_torch.fem.ops import gather_plan
    if mesh.bcsr_brow is not None:
        keys = fold_keys(mesh.bcsr_blk.cpu().numpy(),
                         mesh.bcsr_off.cpu().numpy(), mesh.bcsr_B)
    else:
        keys = mesh.ell_map.cpu().numpy()
    slots, idx = gather_plan(keys)
    return (torch.as_tensor(slots, device=dev), torch.as_tensor(idx, device=dev),
            int(np.prod(dense_shape(mesh))))


def phase_ell_kernel(dev, cases):
    """ell_spmv against its plain version (bitwise) and the dense plain
    product on each (tag, mesh, dirichlet) of ``cases``, f32 and f64, with
    and without the epilogue; timed at each case whose tag does not start
    with 'ragged'.  Returns {tag: {dtype: numbers}}."""
    from shakti_tpu_torch.fem.ell import dense_shape, to_dense
    from shakti_tpu_torch.fem.ops import plan_sum
    from shakti_tpu_torch.ops.spmv_cuda import (ell_operator_fn,
                                                ell_operator_plain)
    from shakti_tpu_torch.physics.residual import fold_operator_values
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)  # > L2
    out = {}
    for i, (tag, mesh, dirichlet) in enumerate(cases):
        W, n = mesh.nz_col.shape
        valid = mesh.nz_pos >= 0
        nnz = int(valid.sum())
        log(f"  {tag}: n={n} W={W} nonzeros={nnz} slots={W * n}")
        # each structural entry's flat slot in svals (-1 on padding): the
        # positions csr_of reads the library's values from
        slot = torch.where(valid, torch.arange(
            W * n, device=dev).reshape(W, n), -1)
        inp = operator_inputs(mesh, dirichlet, np.random.default_rng(10 + i))
        plan = element_plan(mesh, dev)
        out[tag] = {}
        for dtype, rtol, atol_rel in TOLS:
            dt = str(dtype).removeprefix("torch.")
            vals = fold_operator_values(inp["J"].to(dtype), mesh)
            if tuple(vals.shape) != (W, n) or int(torch.count_nonzero(
                    vals[~valid])):
                raise RuntimeError(f"{tag} {dt}: the fold is not the "
                                   f"structural (W, n): {tuple(vals.shape)}")
            dense_fold = plan_sum(-inp["J"].to(dtype), *plan).reshape(
                dense_shape(mesh))
            if not bitwise_equal(to_dense(vals, mesh), dense_fold):
                raise RuntimeError(f"{tag} {dt}: to_dense(structural fold) "
                                   "differs from the dense fold")
            del dense_fold
            x, extra = inp["x"].to(dtype), inp["extra"].to(dtype)
            err = {epi: check_operator(f"{tag} {dt} {epi}", vals, mesh, x, d, e,
                                       rtol, atol_rel, kernel="ell_spmv")
                   for epi, (d, e) in (("product", (None, None)),
                                       ("epilogue", (dirichlet, extra)))}
            r = dict(max_abs_err=err["epilogue"],
                     max_abs_err_product=err["product"], W=W, nnz=nnz,
                     n=mesh.n_nodes)
            if not tag.startswith("ragged"):
                op = ell_operator_fn(vals, mesh, dirichlet, extra)
                prod = ell_operator_fn(vals, mesh)
                r["device_ms"] = device_ms(lambda: op(x), "ell_spmv")
                r["device_ms_product"] = device_ms(lambda: prod(x), "ell_spmv")
                # a cold L2, as on the path (other kernels run between two
                # matvecs): the product alone, as the library call computes
                r["device_ms_cold_l2"] = device_ms(lambda: op(x), "ell_spmv",
                                                   between=flush.zero_)
                r["queued_ms_product_cold_l2"] = queued_ms(
                    lambda: prod(x), between=flush.zero_)
                r["ms"] = median_ms(lambda: op(x))
                r["plain_device_ms"] = device_ms(
                    lambda: ell_operator_plain(vals, mesh, x, dirichlet, extra))
                r["plain_ms"] = median_ms(
                    lambda: ell_operator_plain(vals, mesh, x, dirichlet, extra))
                r["host_us"] = host_us(lambda: op(x))
                r["bound_ms"], r["bound_by"] = ell_bound(mesh, dtype, True)
                r["bound_ms_two_indices"], _ = ell_bound(mesh, dtype, True, 8, 0)
                library_times(r, f"{tag} {dt}", vals, slot, mesh.nz_col,
                              mesh.n_nodes, x, prod(x), dtype, atol_rel,
                              flush=flush.zero_)
                log(f"  {tag} {dt}: L2 flushed before each call: kernel device "
                    f"{r['device_ms_cold_l2']:.5f} ms/launch (profiler); between"
                    f" events less the flush, product "
                    f"{r['queued_ms_product_cold_l2']:.5f} ms against library "
                    f"CSR mv {r['library_queued_ms_cold_l2']} ms")
                log(f"  {tag} {dt}: kernel device {r['device_ms']:.5f} ms/launch"
                    f" (product {r['device_ms_product']:.5f}), {r['ms']:.5f} "
                    f"ms/call events; plain version {r['plain_device_ms']:.5f} "
                    f"ms device ({r['plain_ms']:.5f} events); library CSR mv "
                    f"{r['library_device_ms']} ms device ({r['library_ms']} "
                    f"events); bound {r['bound_ms']:.5f} ms by {r['bound_by']}"
                    f" (counted with two indices per nonzero, as for the "
                    f"earlier kernel: {r['bound_ms_two_indices']:.5f})")
                del op, prod
            out[tag][dt] = r
            del vals
        del plan
    return out


def scale_model(nx=1000):
    """scripts/scale_bench.py's configuration on the port's ModelSetup:
    1,002,001 nodes and 2M triangles at 2 km (nx = 1000); f32, two-level,
    no lag carry, 48 hourly times of which phase 8 runs the first 24, saves
    every 12."""
    from shakti_tpu_torch.api.model import ModelSetup
    from shakti_tpu_torch.mesh.generate import rectangle_mesh
    from shakti_tpu_torch.solve.newton import NewtonConfig
    h = 2000.0
    nodes, cells = rectangle_mesh(nx, nx, nx * h, nx * h, jitter=0.25, seed=0)
    md = ModelSetup(nodes, cells)
    md.solver = NewtonConfig(lag_operator=False, precond="two_level")
    md.z_b = 0.002 * md.x - 100.0
    md.z_s = md.z_b + 1200.0 + 0.001 * (md.x - nx * h / 2)
    md.G = np.full(md.x.size, 0.06)
    md.N_bdry = 3.7e5
    md.OutflowBoundary = lambda p: p[:, 0] < 1e-6
    rng = np.random.default_rng(0)
    md.b_init = np.maximum(0.001 + rng.normal(scale=5e-4, size=md.x.size), 1e-5)
    md.N_init = np.full(md.x.size, md.N_bdry)
    md.storage_on = False
    md.timesteps = np.linspace(0, 48 * 3600.0, 48)[:24]
    md.nt_save = 12
    return md


def phase_scale(dev, md, frozen, label="1M-node run"):
    """Phase 8 (and 13's 1M-node run): the 1M-node model through
    api/run.solve (its freeze is ``frozen``, made once for phases 7, 8 and
    13).  Times each window between synchronizations; returns the numbers,
    the ell_spmv launches and the profile of three steady steps."""
    from shakti_tpu_torch.api import run as trun
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.physics import residual
    mesh, _, _, cfg = frozen
    windows, plain_calls = [], {"ell": 0, "bell": 0}
    fold_shapes = set()
    real_window = trun.run_window
    real_plain = spmv_cuda.ell_operator_plain, spmv_cuda.bell_operator_plain
    real_fold = residual.fold_operator_values

    def spied_fold(J_c, m):
        vals = real_fold(J_c, m)
        fold_shapes.add(tuple(vals.shape))
        return vals

    def timed_window(step_fn, state, forcing):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, d = real_window(step_fn, state, forcing)
        torch.cuda.synchronize(dev)
        windows.append((time.perf_counter() - t0, d))
        return state, d

    def counted(name, fn):
        def wrapped(*a, **k):
            plain_calls[name] += 1
            return fn(*a, **k)
        return wrapped

    trun.run_window = timed_window
    spmv_cuda.ell_operator_plain = counted("ell", real_plain[0])
    spmv_cuda.bell_operator_plain = counted("bell", real_plain[1])
    residual.fold_operator_values = spied_fold
    md.device = dev
    md.freeze = lambda device=None: frozen
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        spmv_cuda.reset_launches()
        out = md.solve(progress=False)
        launches = dict(spmv_cuda.launches)
    finally:
        trun.run_window = real_window
        spmv_cuda.ell_operator_plain, spmv_cuda.bell_operator_plain = real_plain
        residual.fold_operator_values = real_fold
        del md.freeze
    st = out["state"]
    for k in ("N", "b", "q", "melt"):
        if not torch.isfinite(getattr(st, k)).all():
            raise RuntimeError(f"non-finite {k} after the 1M-node run")
    if out["steps"] != 24 or launches["ell_spmv"] <= 0 or any(plain_calls.values()):
        raise RuntimeError(f"1M-node run: {out['steps']} steps, launches "
                           f"{launches}, plain version calls {plain_calls}")
    # the operator is never the nnzb * B * B blocks: every fold of the run
    # gave the structural (W, n)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if fold_shapes != {tuple(mesh.nz_col.shape)}:
        raise RuntimeError(f"1M-node run: folds of shapes {fold_shapes}; the "
                           f"structural one is {tuple(mesh.nz_col.shape)}")
    wall, d = windows[1]
    newton = sum((w[1]["newton_iters"].tolist() for w in windows), [])
    cg = sum((w[1]["cg_iters"].tolist() for w in windows), [])
    res = dict(nodes=mesh.n_nodes, steps=out["steps"], launches=launches["ell_spmv"],
               ms_per_step_window2=1e3 * wall / d["newton_iters"].size,
               window2_steps=int(d["newton_iters"].size),
               newton_mean=out["newton_iters_total"] / out["steps"],
               cg_mean=out["cg_iters_total"] / out["steps"],
               cg_total=out["cg_iters_total"], newton_steps=newton,
               cg_steps=cg, newton_first3=newton[:3], cg_first3=cg[:3],
               ms_per_step_all=1e3 * out["wall_time"] / out["steps"],
               peak_mem_gb=peak_gb)
    log(f"  {label}: " + json.dumps(res))
    # where a steady step goes at this size: the run's last three steps
    # again, from its final state
    from shakti_tpu_torch.solve.timestep import make_forcing, make_step_fn
    step = make_step_fn(mesh, frozen[1], md.params, cfg)
    last = {k: v[-3:] for k, v in make_forcing(
        md.timesteps, dtype=md.dtype, device=dev).items()}
    res["profile"] = profile_steps(dev, step, st, last, "ell_spmv")
    res["state"] = st
    return res


def bench_f64(dev, op="auto", **solver):
    """The bench model in float64 for its first 4 hourly steps."""
    import dataclasses
    from shakti_tpu_torch.setups import setup_bench
    md = setup_bench.initialize(days=2)
    md.device, md.dtype, md.operator = dev, torch.float64, op
    md.timesteps = md.timesteps[:4]
    if op == "bcsr":
        md.operator_block = 32
    if solver:
        md.solver = dataclasses.replace(md.solver, **solver)
    return md


def run_counted(md, **kw):
    """md.solve with every launch count set to 0 just before and read just
    after."""
    from shakti_tpu_torch.ops import spmv_cuda
    spmv_cuda.reset_launches()
    out = md.solve(progress=False, **kw)
    return out, dict(spmv_cuda.launches)


def phase_formats(dev):
    """Phase 9: the four formats agree on the bench model in float64."""
    ref, res = None, {}
    for op, kernel in (("bell", "bell_spmv"), ("ell", "ell_spmv"),
                       ("bcsr", "ell_spmv"), ("cells", None)):
        md = bench_f64(dev, op, lag_operator=None)
        out, launches = run_counted(md)
        if kernel is not None and launches[kernel] <= 0:
            raise RuntimeError(f"{op}: {kernel} never launched ({launches})")
        N = md.to_user_order(out["state"].N)
        b = md.to_user_order(out["state"].b)
        r = dict(newton=out["newton_iters_total"], cg=out["cg_iters_total"],
                 launches=launches)
        if ref is None:
            ref = (N, b)
        else:
            r["err_N"] = float(np.abs(N - ref[0]).max() / np.abs(ref[0]).max())
            r["err_b"] = float(np.abs(b - ref[1]).max() / np.abs(ref[1]).max())
            if max(r["err_N"], r["err_b"]) > 1e-7:
                raise RuntimeError(f"{op} differs from bell: {r}")
        res[op] = r
        log(f"  {op}: " + json.dumps(r))
    return res, dict(N=ref[0], b=ref[1])


WRAPPER = """import numpy as np

from shakti_tpu_torch.setups import setup_bench


def initialize():
    md = setup_bench.initialize(days=2, results_name={rdir!r})
    md.timesteps = md.timesteps[:{steps}]
    return md
"""


def phase_resume(dev, tmp, full_dir):
    """Phase 10: 25 steps, then --resume through cli.main to step 48; every
    output equal to phase 5's uninterrupted run."""
    from shakti_tpu_torch.cli import main as cli_main
    from shakti_tpu_torch.ops import spmv_cuda
    rdir = os.path.join(tmp, "resumed")
    launches = {}
    for steps, extra in ((25, []), (48, ["--resume"])):
        path = os.path.join(tmp, f"wrap_{steps}.py")
        with open(path, "w") as f:
            f.write(WRAPPER.format(rdir=rdir, steps=steps))
        spmv_cuda.reset_launches()
        if cli_main([path, "--device", str(dev), "--quiet", *extra]) != 0:
            raise RuntimeError(f"cli.main {extra} failed")
        launches[steps] = spmv_cuda.launches["bell_spmv"]
    a = np.load(os.path.join(full_dir, "checkpoint.npz"))
    b = np.load(os.path.join(rdir, "checkpoint.npz"))
    same = {k: bool(np.array_equal(a[k], b[k])) for k in ("N", "b", "q", "melt")}
    for k in ("N", "b", "qx", "qy"):
        same[f"{k}.npy"] = bool(np.array_equal(
            np.load(os.path.join(full_dir, f"{k}.npy")),
            np.load(os.path.join(rdir, f"{k}.npy"))))
    meta = json.load(open(os.path.join(rdir, "run_meta.json")))
    log(f"  resume: equal {same}, resumed_from {meta['resumed_from']}, "
        f"bell_spmv launches {launches}")
    if not all(same.values()) or meta["resumed_from"] != 25 or min(
            launches.values()) <= 0:
        raise RuntimeError("resume is not bit-exact")
    return dict(equal=same, launches=launches)


def phase_bootstrap(dev, tmp):
    """Phase 11: setup_cooke2's reference cold start, 24 float64 bootstrap
    steps on the card then float32, 3 days."""
    from shakti_tpu_torch.api import run as trun
    md = cooke2_setup({"SHAKTI_MESH_DIR": COOKE2_DIR,
                       "SHAKTI_REFERENCE_BINIT": "1"},
                      days=3, results_name=os.path.join(tmp, "ck2"))
    md.device = dev
    boot = {}
    real = trun._bootstrap_f64

    def spy(*a):
        state, wins, end = real(*a)
        boot.update(state=state, wins=wins, end=end)
        return state, wins, end

    trun._bootstrap_f64 = spy
    try:
        t0 = time.perf_counter()
        out, launches = run_counted(md)
        wall = time.perf_counter() - t0
    finally:
        trun._bootstrap_f64 = real
    s64 = boot["state"]
    for k in ("N", "b", "q", "melt", "N_prev"):
        t = getattr(s64, k)
        if t.dtype != torch.float64 or t.device.type != "cuda":
            raise RuntimeError(f"bootstrap {k}: {t.dtype} on {t.device}")
    if out["state"].N.dtype != torch.float32:
        raise RuntimeError("the run after the bootstrap is not float32")
    dg = np.concatenate([w[3] for w in boot["wins"]], axis=1)
    steps = boot["end"] + out["steps"]
    res = dict(steps=steps, boot_steps=boot["end"],
               boot_newton=int(dg[1].sum()), boot_cg=int(dg[2].sum()),
               f32_newton=out["newton_iters_total"] - int(dg[1].sum()),
               f32_cg=out["cg_iters_total"] - int(dg[2].sum()),
               wall_s=wall, launches=launches,
               b_negative_share=float((md.b_init < 0).mean()))
    log("  bootstrap: " + json.dumps(res))
    if steps != 72 or launches["bell_spmv"] <= 0:
        raise RuntimeError(f"bootstrap run: {res}")
    return res


def phase_bicgstab(dev, N_cg):
    """Phase 12: BiCGStab on the bench model in float64, against phase 9's
    cg run."""
    md = bench_f64(dev, krylov="bicgstab", lag_operator=None)
    out, launches = run_counted(md)
    N = md.to_user_order(out["state"].N)
    err = float(np.abs(N - N_cg).max() / np.abs(N_cg).max())
    res = dict(newton=out["newton_iters_total"], krylov=out["cg_iters_total"],
               err_N=err, launches=launches)
    log("  bicgstab: " + json.dumps(res))
    if err > 1e-7 or launches["bell_spmv"] <= 0:
        raise RuntimeError(f"bicgstab: {res}")
    return res


def phase_mg_bench(dev, ref):
    """Phase 13 (a): the bench model in float64 for 4 steps under
    precond='mg' in bell, ell and bcsr (B 32), against phase 9's bell
    two-level N and b (``ref``).  Returns the counts and launches."""
    res = {}
    for op, kernel in (("bell", "bell_spmv"), ("ell", "ell_spmv"),
                       ("bcsr", "ell_spmv")):
        md = bench_f64(dev, op, precond="mg")
        mesh = md.freeze()[0]
        if mesh.mg is None or mesh.mg.sizes != [3068, 767]:
            raise RuntimeError(f"mg {op}: hierarchy "
                               f"{None if mesh.mg is None else mesh.mg.sizes}")
        out, launches = run_counted(md)
        r = dict(newton=out["newton_iters_total"], cg=out["cg_iters_total"],
                 launches=launches)
        for k, v in (("N", out["state"].N), ("b", out["state"].b)):
            a, want = md.to_user_order(v), ref[k]
            r[f"err_{k}"] = float(np.abs(a - want).max() / np.abs(want).max())
        log(f"  mg {op}: " + json.dumps(r))
        if max(r["err_N"], r["err_b"]) > 1e-7 or launches[kernel] <= 0:
            raise RuntimeError(f"mg {op} against bell two-level: {r}")
        res[op] = r
    return res


def mg_apply_cost(dev, mesh, static, state, cfg, params, dt):
    """The V-cycle apply built as a Newton iteration builds it at ``state``:
    launches and host syncs per apply (torch.profiler over 20 applies; no
    sync is allowed), ell_spmv launches per apply (4: Chebyshev degree 2),
    device time per apply (:func:`device_ms`), time per apply between CUDA
    events, host time per apply, and the device time of one build (level
    assembly and dense inverse)."""
    from torch.profiler import ProfilerActivity, profile

    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.physics import residual as res
    from shakti_tpu_torch.solve import precond as pc
    from shakti_tpu_torch.solve.newton import diag_floor_extra
    d = static.dirichlet
    pre = res.precompute_step(mesh, state.N, state.b, state.q, state.melt,
                              static, dt, params, cfg.quad_degree)
    J_c = res.element_jacobian(state.N, pre, mesh, params)
    vals = res.fold_operator_values(J_c, mesh)
    a_diag = res.operator_diag_from_values(vals, mesh)
    extra = diag_floor_extra(a_diag, d, mesh, cfg.diag_floor_rel)
    matvec = res.operator_from_values(vals, mesh, d, extra)

    def build():
        return pc.make_preconditioner(
            "mg", mesh, d, a_diag + extra, cfg.coarse_block, J_c=J_c,
            matvec=matvec, mg_omega=cfg.mg_omega, mg_smoother=cfg.mg_smoother,
            mg_cheb_deg=cfg.mg_cheb_deg, mg_cheb_frac=cfg.mg_cheb_frac,
            mg_cycle=cfg.mg_cycle, mg_smooth_p=cfg.mg_smooth_p)

    apply = build()
    r = torch.randn(mesh.n_nodes, dtype=state.N.dtype, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    reps = 20
    for _ in range(3):
        apply(r)
    torch.cuda.synchronize(dev)
    before = spmv_cuda.launches["ell_spmv"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            apply(r)
        torch.cuda.synchronize(dev)
    spmv_per_apply = (spmv_cuda.launches["ell_spmv"] - before) / reps
    count = {e.key: e.count for e in prof.key_averages()}
    out = dict(launches_per_apply=count.get("cudaLaunchKernel", 0) / reps,
               ell_spmv_per_apply=spmv_per_apply,
               syncs_per_apply=count.get("aten::_local_scalar_dense", 0) / reps,
               device_ms_per_apply=device_ms(lambda: apply(r), reps=reps,
                                             warmup=2),
               ms_per_apply=median_ms(lambda: apply(r), reps=20),
               host_us_per_apply=host_us(lambda: apply(r), reps=50, warmup=3),
               build_device_ms=device_ms(build, reps=3, warmup=1))
    if out["syncs_per_apply"] or out["ell_spmv_per_apply"] != 4:
        raise RuntimeError(f"mg apply: {out}")
    return out


# the 1M-node mesh's hierarchy at mg_agg 4, mg_coarse_cap 1536: four ELL
# levels and the dense coarse problem
HIERARCHY_1M = [250501, 62626, 15657, 3915, 979]


def phase_mg_scale(dev, md, frozen, two_level, expect=HIERARCHY_1M):
    """Phase 13 (b): phase 8's 1M-node model under precond='mg' (the same
    freeze with the hierarchy attached as freeze attaches it), 24 steps
    through api/run.solve; counts beside phase 8's two-level run."""
    import dataclasses

    from shakti_tpu_torch.solve.mg import attach_hierarchy
    mesh, static, state0, cfg = frozen
    cfg = dataclasses.replace(cfg, precond="mg")
    t0 = time.perf_counter()
    mesh = attach_hierarchy(mesh, cfg)
    torch.cuda.synchronize(dev)
    hier_s = time.perf_counter() - t0
    sizes = mesh.mg.sizes
    log(f"  hierarchy: {sizes} (agg {mesh.mg.agg}), built with its plans in "
        f"{hier_s:.2f} s host time")
    if sizes != expect:
        raise RuntimeError(f"hierarchy {sizes}, expected {expect}")
    md.solver = dataclasses.replace(md.solver, precond="mg")
    r = phase_scale(dev, md, (mesh, static, state0, cfg), "1M-node run, mg")
    r["hierarchy"], r["hierarchy_s"] = sizes, hier_s
    if r["launches"] < 5 * r["cg_total"]:
        raise RuntimeError(f"mg: {r['launches']} ell_spmv launches for "
                           f"{r['cg_total']} CG iterations")
    dt = torch.as_tensor(md.timesteps[-1] - md.timesteps[-2], dtype=md.dtype,
                         device=dev)
    r["apply"] = mg_apply_cost(dev, mesh, static, r["state"], cfg, md.params, dt)
    # one apply per CG iteration and one more per Krylov solve
    prof = r["profile"]
    applies = (sum(prof["cg"]) + sum(prof["newton"])) / len(prof["cg"])
    r["apply"]["vcycle_share"] = (
        applies * r["apply"]["device_ms_per_apply"] / prof["device_ms_per_step"]
        if prof["device_ms_per_step"] > 0 else None)
    log(f"  mg apply: " + json.dumps(r["apply"]) + f"; {applies:.2f} applies "
        f"per profiled step")
    for k in ("newton_first3", "cg_first3", "newton_mean", "cg_mean",
              "ms_per_step_window2", "peak_mem_gb"):
        log(f"  {k}: mg {r[k]} | two-level {two_level[k]}")
    return r


STEADY_WRAPPER = """import torch

from shakti_tpu_torch.setups import setup_slab


def initialize():
    md = setup_slab.initialize(nx=16, ny=16, results_name={rdir!r})
    md.dtype = torch.float64
    return md
"""


def phase_steady(dev, tmp):
    """Phase 14: setup_slab 16 x 16 in float64 on the card through
    solve_steady (tests/test_steady.py's case), the transient oracle from
    its state, the mass budget, a segmented march killed after one segment
    and resumed, and the CLI's --steady files."""
    import dataclasses

    from shakti_tpu_torch.api.steady import PTC_FILE
    from shakti_tpu_torch.cli import main as cli_main
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.setups import setup_slab
    from shakti_tpu_torch.solve.newton import zero_lag
    from shakti_tpu_torch.solve.timestep import make_step_fn
    tol, year = 2e-2, 3.1536e7

    def slab():
        md = setup_slab.initialize(nx=16, ny=16)
        md.device, md.dtype = dev, torch.float64
        return md

    md = slab()
    spmv_cuda.reset_launches()
    t0 = time.perf_counter()
    out = md.solve_steady(tol=tol, max_steps=1600)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(spmv_cuda.launches)
    info = out["info"]
    res = dict(verdict=info["verdict"], steps=info["steps"],
               accepted=info["accepted"], rejected=info["rejected"],
               newton_total=info["newton_total"], cg_total=info["cg_total"],
               rate=info["rate"], rate_b_bdry=info["rate_b_bdry"],
               wall_s=wall, ms_per_ptc_step=1e3 * wall / info["steps"],
               Q_out=out["Q_out"], Q_src=out["Q_src"],
               budget_gap=abs(out["Q_out"] - out["Q_src"]) / abs(out["Q_src"]),
               launches=launches)
    log("  steady: " + json.dumps(res))
    if not (info["verdict"] == "steady" and info["rate"] < tol
            and info["rate_b_bdry"] > info["rate"]
            and launches["bell_spmv"] > 0):
        raise RuntimeError(f"steady: {res}")
    # the independent oracle: 10 explicit hourly steps move the state less
    # than the certified rates allow (5x headroom, tests/test_steady.py)
    mesh, static, _, cfg = md.freeze()
    step = make_step_fn(mesh, static, md.params, cfg)
    s = out["state"]
    s = dataclasses.replace(s, lag_op=zero_lag(mesh, s.N.dtype, cfg)
                            if cfg.lag_operator else None)
    N0, b0 = s.N, s.b
    for _ in range(10):
        s, d = step(s, torch.as_tensor(3600.0, dtype=torch.float64, device=dev))
        if not d["converged"]:
            raise RuntimeError("steady oracle: a transient step failed")
    frac = 10 * 3600.0 / year
    act, bdry = (~static.dirichlet).double(), static.dirichlet.double()

    def rel(new, old, m):
        return float(torch.linalg.vector_norm((new - old) * m)
                     / torch.linalg.vector_norm(old * m))

    oracle = dict(N=rel(s.N, N0, act) / (5 * tol * frac),
                  b=rel(s.b, b0, act) / (5 * tol * frac),
                  b_bdry=rel(s.b, b0, bdry) / (5 * info["rate_b_bdry"] * frac))
    log("  oracle, movement over 10 hourly steps / its certified limit: "
        + json.dumps(oracle))
    if max(oracle.values()) >= 1.0:
        raise RuntimeError(f"steady oracle: {oracle}")
    # a segmented march killed after its first segment, then resumed
    ck = os.path.join(tmp, "ptc")
    first = slab().solve_steady(tol=tol, max_steps=64, strict=False,
                                checkpoint=ck, segment_steps=64)
    if first["info"]["steps"] != 64 or not os.path.exists(
            os.path.join(ck, PTC_FILE)):
        raise RuntimeError(f"segmented march: {first['info']}")
    resumed = slab().solve_steady(tol=tol, max_steps=1600, checkpoint=ck,
                                  segment_steps=256)
    same = {k: bool(np.array_equal(resumed[k], out[k]))
            for k in ("N", "b", "qx", "qy")}
    same["steps"] = resumed["info"]["steps"] == info["steps"]
    log(f"  killed after 64 attempts and resumed: bit-identical {same}")
    if not all(same.values()):
        raise RuntimeError(f"resumed steady march differs: {same}")
    # the CLI
    rdir = os.path.join(tmp, "slab_cli")
    path = os.path.join(tmp, "slab_steady.py")
    with open(path, "w") as f:
        f.write(STEADY_WRAPPER.format(rdir=rdir))
    if cli_main([path, "--steady", "--device", str(dev), "--quiet"]) != 0:
        raise RuntimeError("cli --steady failed")
    files = sorted(os.listdir(rdir + "_steady"))
    keys = sorted(json.load(open(os.path.join(rdir + "_steady",
                                              "steady_info.json"))))
    log(f"  cli --steady wrote {files}, info keys {keys}")
    if files != ["steady.npz", "steady_info.json"]:
        raise RuntimeError(f"cli --steady files {files}")
    res["resume_equal"] = same
    return res, (md, out["state"])


# the JAX package's counts for phase 15's calls, float64 on the CPU (ELL,
# the JAX package's choice there): tests/test_monolithic.py's slab polish and
# scripts/shmip_validate.py's A1 call capped at 300 PTC steps
JAX_SLAB_POLISH = dict(newton=3, n_fixed=17, refreshes=2)
JAX_A1 = dict(steps=300, newton_total=1110, cg_total=119609, polish_newton=16)
RELN_A1_SHMIP_MD = 3.36e-4          # SHMIP.md, suite S, A1 polished
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
SHMIP_A1_KW = dict(tol=1e-3, max_steps=300, strict=False, polish=True,
                   polish_max_newton=6000, polish_patience=3,
                   polish_max_wall_s=600)


class Killed(Exception):
    """Raised in place of a polish segment, to kill a march between two."""


def range_cost(prof, name):
    """(launches, device ms, host ms, host syncs) inside the record_function
    ranges called ``name``: the runtime launch calls and item reads in
    their subtrees, the device time of the kernels those launched, the
    ranges' host time (profiled)."""
    from torch.autograd import DeviceType
    tops = [e for e in prof.events()
            if e.name == name and e.device_type == DeviceType.CPU]
    launches = syncs = 0
    stack = list(tops)
    while stack:
        e = stack.pop()
        launches += e.name in LAUNCHES
        syncs += e.name == "aten::_local_scalar_dense"
        stack.extend(e.cpu_children)
    return (launches, sum(e.device_time_total for e in tops) / 1e3,
            sum(e.cpu_time_total for e in tops) / 1e3, syncs)


def slab_polish(dev, slab):
    """Phase 15 (a): steady_polish from the slab's PTC state."""
    import dataclasses

    from shakti_tpu_torch.solve import monolithic
    from shakti_tpu_torch.solve.newton import zero_lag
    from shakti_tpu_torch.solve.timestep import make_step_fn
    md, ptc_state = slab
    mesh, static, _, cfg = md.freeze()
    t0 = time.perf_counter()
    state, info = monolithic.steady_polish(mesh, static, md.params, ptc_state,
                                           tol=1e-6)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    s2, _ = monolithic.steady_polish(mesh, static, md.params, ptc_state,
                                     tol=1e-6, dtau_seed=None)
    pure = float(torch.max(torch.abs(s2.N - state.N) / torch.abs(state.N)))
    step = make_step_fn(mesh, static, md.params, cfg)
    s = dataclasses.replace(state, lag_op=zero_lag(mesh, state.N.dtype, cfg)
                            if cfg.lag_operator else None)
    b0 = s.b
    free = ((~static.dirichlet) & (b0 > static.b_min * (1 + 1e-9))).double()
    for _ in range(10):
        s, d = step(s, torch.as_tensor(3600.0, dtype=torch.float64, device=dev))
        if not d["converged"]:
            raise RuntimeError("slab polish oracle: a transient step failed")
    relb = float(torch.linalg.vector_norm((s.b - b0) * free)
                 / torch.linalg.vector_norm(b0 * free))
    limit = 1e-3 * 10 * 3600.0 / 3.1536e7 + 1e-9
    res = dict(newton=info["newton"], n_fixed=int(info["n_fixed"]),
               refreshes=info["refreshes"], converged=bool(info["converged"]),
               rate_b=float(info["rate_b"]), resN_rel=float(info["resN_rel"]),
               wall_s=wall, pure_newton_max_rel_dN=pure, relb_10h=relb,
               relb_limit=limit, jax_cpu=JAX_SLAB_POLISH)
    log("  (a) slab 16 x 16 polish: " + json.dumps(res))
    if not (res["converged"] and res["rate_b"] < 1e-6
            and res["resN_rel"] < 1e-7 and res["n_fixed"] > 0
            and pure <= 1e-6 and relb < limit):
        raise RuntimeError(f"slab polish: {res}")
    return res


def phase_polish(dev, tmp, slab=None):
    """Phase 15: (a) the slab polish, (b) SHMIP A1 through
    solve_steady(polish=True) at suite-S width (bell_spmv checked against
    its plain version on the A1 operator first, and no matvec of the run
    through a plain version), its polish profiled and killed-and-resumed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from shakti_tpu_torch.api import steady as steady_api
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.setups import setup_shmip, setup_slab
    from shakti_tpu_torch.solve import monolithic
    t_phase = time.perf_counter()
    if slab is None:
        md = setup_slab.initialize(nx=16, ny=16)
        md.device, md.dtype = dev, torch.float64
        slab = (md, md.solve_steady(tol=2e-2, max_steps=1600)["state"])
    res = {"slab": slab_polish(dev, slab)}

    # (b) the main path: the march and the polish, the polish's arguments
    # observed on their way (for the profile and the resume below)
    md = setup_shmip.initialize("A1", nx=60, ny=12, days=30, nt_per_day=24)
    md.device, md.dtype = dev, torch.float64
    # bell_spmv against its plain version at the operator this path gives it
    from shakti_tpu_torch.fem.bell import bell_from_elements
    m, st = md.freeze(dev)[:2]
    inp = operator_inputs(m, st.dirichlet, np.random.default_rng(2))
    a1_err = {}
    for dtype, rtol, atol_rel in TOLS:
        dt = str(dtype).removeprefix("torch.")
        vals = bell_from_elements(inp["J"].to(dtype), m)
        x, extra = inp["x"].to(dtype), inp["extra"].to(dtype)
        for epi, (d, e) in (("product", (None, None)),
                            ("epilogue", (st.dirichlet, extra))):
            a1_err[f"{dt} {epi}"] = check_operator(
                f"SHMIP A1 n={m.n_nodes} {dt} {epi}", vals, m, x, d, e, rtol,
                atol_rel)
    log(f"  SHMIP A1 operator (n={m.n_nodes}): bell_spmv against its plain "
        f"version, max abs err {json.dumps(a1_err)}")
    del m, st, inp, vals, x, extra

    seen, plain_calls = {}, {"ell": 0, "bell": 0}
    real = steady_api.steady_polish
    real_plain = spmv_cuda.ell_operator_plain, spmv_cuda.bell_operator_plain

    def observed(*args, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize(dev)
        seen.update(args=args, kw=kw, wall=time.perf_counter() - t0)
        return out

    def counted(name, fn):
        def wrapped(*a, **k):
            plain_calls[name] += 1
            return fn(*a, **k)
        return wrapped

    steady_api.steady_polish = observed
    spmv_cuda.ell_operator_plain = counted("ell", real_plain[0])
    spmv_cuda.bell_operator_plain = counted("bell", real_plain[1])
    torch.cuda.reset_peak_memory_stats(dev)
    spmv_cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        out = md.solve_steady(**SHMIP_A1_KW)
        torch.cuda.synchronize(dev)
    finally:
        steady_api.steady_polish = real
        spmv_cuda.ell_operator_plain, spmv_cuda.bell_operator_plain = real_plain
    wall = time.perf_counter() - t0
    launches = dict(spmv_cuda.launches)
    info = out["info"]
    p = importlib.util.spec_from_file_location(
        "shmip_oracle", os.path.join(HERE, "oracle", "shmip_oracle.py"))
    oracle = importlib.util.module_from_spec(p)
    p.loader.exec_module(oracle)
    prof_a1 = oracle.steady_profile("A1")
    win = (md.x > 30e3) & (md.x < 90e3)

    def rel(field):
        ref = np.interp(md.x, prof_a1["x"], prof_a1[field])[win]
        return float(np.linalg.norm(out[field][win] - ref)
                     / np.linalg.norm(ref))

    mesh, args = seen["args"][0], seen["args"]
    a1 = dict(verdict=info["verdict"], steps=info["steps"],
              newton_total=info["newton_total"], cg_total=info["cg_total"],
              polish_newton=info["polish_newton"], rate=info["rate"],
              polish_resN=info["polish_resN"], wall_s=wall,
              ptc_s=wall - seen["wall"], polish_s=seen["wall"],
              ms_per_ptc_step=1e3 * (wall - seen["wall"]) / info["steps"],
              ms_per_newton=1e3 * seen["wall"] / info["polish_newton"],
              Q_out=out["Q_out"], Q_src=out["Q_src"],
              budget_gap=abs(out["Q_out"] - out["Q_src"]) / abs(out["Q_src"]),
              relN=rel("N"), relN_shmip_md=RELN_A1_SHMIP_MD, relb=rel("b"),
              n=mesh.n_nodes, colors=monolithic._coloring_plan(mesh)[4],
              peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
              launches=launches, plain_calls=plain_calls,
              operator_max_abs_err=a1_err, jax_cpu=JAX_A1)
    log("  (b) SHMIP A1 60 x 12: " + json.dumps(a1))
    if not (info["verdict"] == "polished" and info["rate"] < 1e-3
            and a1["budget_gap"] < 1e-6 and a1["relN"] <= 5e-4
            and launches["bell_spmv"] > 0 and not any(plain_calls.values())):
        raise RuntimeError(f"SHMIP A1 polish: {a1}")

    # the same polish again from the march's state, under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pstate, pinfo = monolithic.steady_polish(*args, **seen["kw"])
        torch.cuda.synchronize(dev)
        pwall = time.perf_counter() - t0
    newton = pinfo["newton"]
    same = dict(N=bitwise_equal(pstate.N, out["state"].N),
                b=bitwise_equal(pstate.b, out["state"].b),
                newton=newton == info["polish_newton"])
    count = {e.key: e.count for e in prof.key_averages()}
    # kernels and copies only: the ranges' device-side annotations span them
    dev_ms = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and not e.name.startswith("polish.")) / 1e3
    per = dict(launches=sum(count.get(k, 0) for k in LAUNCHES) / newton,
               device_ms=dev_ms / newton,
               syncs=count.get("aten::_local_scalar_dense", 0) / newton,
               profiled_ms=1e3 * pwall / newton)
    for part in ("jacobian", "lu", "armijo"):
        n_l, ms, host, n_s = range_cost(prof, "polish." + part)
        per[part] = dict(launches=n_l / newton, device_ms=ms / newton,
                         host_ms=host / newton, syncs=n_s / newton)
    a1["per_newton"] = per
    a1["profiled_equal"] = same
    log("  polish per Newton iteration (profiled, " + f"{newton} iterations"
        "): " + json.dumps(per))
    log(f"  profiled polish bit-identical to the main path's: {same}")
    if not all(same.values()):
        raise RuntimeError(f"repeated polish differs: {same}")

    # killed after its first segment, then resumed from polish.npz
    ck = os.path.join(tmp, "polish.npz")
    step_fn, calls = monolithic.polish, []

    def killed(*a, **k):
        if calls:
            raise Killed
        calls.append(1)
        return step_fn(*a, **k)

    monolithic.polish = killed
    try:
        monolithic.steady_polish(*args, **dict(seen["kw"], checkpoint=ck))
        raise RuntimeError("the polish ended within one segment: nothing to "
                           "resume")
    except Killed:
        pass
    finally:
        monolithic.polish = step_fn
    if not os.path.exists(ck):
        raise RuntimeError("no polish.npz after the first segment")
    rstate, rinfo = monolithic.steady_polish(*args,
                                             **dict(seen["kw"], checkpoint=ck))
    resumed = dict(N=bitwise_equal(rstate.N, out["state"].N),
                   b=bitwise_equal(rstate.b, out["state"].b),
                   newton=rinfo["newton"] == info["polish_newton"],
                   file_removed=not os.path.exists(ck))
    log(f"  polish killed after one segment and resumed: {resumed}")
    if not all(resumed.values()):
        raise RuntimeError(f"resumed polish differs: {resumed}")
    a1["resume_equal"] = resumed
    res["a1"] = a1
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 15: {res['wall_s']:.1f} s")
    return res


def counted_plain():
    """Counts the calls of the plain operators (ops/spmv_cuda.py) while
    active: a CUDA run must make none (scripts/torch_cooke2_report.py's
    CountPlain)."""
    return script("torch_cooke2_report").CountPlain()


def sync_s(dev, t0):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


# the adjoint's settings: tests/test_adjoint.py's tight solves (the gradient
# is exact only where F(N*) = 0 holds to roundoff), no operator carry
ADJOINT_SOLVER = dict(adaptive_dt_levels=0, lag_operator=False, rtol=1e-12,
                      atol=1e-13, lin_rtol=1e-12, differentiable=True)
FD_RTOL = 1e-5


def adjoint_bench(dev):
    """Phase 16's model: the bench model in float64 with the adjoint's
    settings.  It has no meltwater input, so no loss would depend on it: a
    uniform distributed recharge of 1e-8 m/s."""
    import dataclasses

    from shakti_tpu_torch.setups import setup_bench
    md = setup_bench.initialize(days=1)
    md.device, md.dtype = dev, torch.float64
    md.inputs = np.full(md.x.size, 1e-8)
    md.solver = dataclasses.replace(md.solver, **ADJOINT_SOLVER)
    return md


def adjoint_forcing(dts, s):
    """The steps ``dts`` with the meltwater input scaled by the 0-d ``s``."""
    return {"dt": dts, "inputs_scale": s.expand(dts.shape[0])}


def phase_adjoint(dev, md=None, steps=6):
    """Phase 16: the differentiable transient at full width.  The bench
    model in float64, lag off, differentiable=True, ``steps`` hourly steps:
    the forward bitwise equal to differentiable=False; d mean(N)/d
    inputs_scale and, through make_runner, the gradient with respect to the
    (n,) inputs field, each against a central difference (rel FD_RTOL; the
    field along one seeded direction); the adjoint's transposed operator
    through bell_spmv (held against its plain version), no matvec through a
    plain version."""
    import dataclasses

    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.physics import residual
    from shakti_tpu_torch.solve import krylov
    from shakti_tpu_torch.solve import timestep as ts
    t_phase = time.perf_counter()
    if md is None:
        md = adjoint_bench(dev)
    md.solver = dataclasses.replace(md.solver, **ADJOINT_SOLVER)
    mesh, static, state, cfg = md.freeze()
    dts = ts.timestep_sizes(md.timesteps, md.dtype, dev)[1:steps + 1]
    fwd = {}
    for diff in (False, True):
        step = ts.make_step_fn(mesh, static, md.params,
                               dataclasses.replace(cfg, differentiable=diff))
        out, d = ts.run_window(step, state, dts)
        if not d["converged"].all():
            raise RuntimeError(f"adjoint phase forward (differentiable="
                               f"{diff}) did not converge: {d}")
        fwd[diff] = (out, d)
    same = {k: bitwise_equal(getattr(fwd[False][0], k),
                             getattr(fwd[True][0], k))
            for k in ("N", "b", "q", "melt")}
    log(f"  forward with differentiable=True bitwise equal to False: {same};"
        f" newton {fwd[True][1]['newton_iters'].tolist()}, cg "
        f"{fwd[True][1]['cg_iters'].tolist()}")
    if not all(same.values()):
        raise RuntimeError(f"differentiable=True changed the forward: {same}")
    step = ts.make_step_fn(mesh, static, md.params, cfg)

    def loss_scale(s):
        out, _ = ts.run_window(step, state, adjoint_forcing(dts, s))
        return out.N.mean()

    # the backward's matvecs and adjoint solves, observed on their way
    seen, cg = [], []
    real_op, real_cg = residual.operator_from_values, krylov.SOLVERS["cg"]

    def op_spy(vals, mesh_, dirichlet, extra=None):
        seen.append((vals, dirichlet, extra))
        return real_op(vals, mesh_, dirichlet, extra)

    def cg_spy(*a, **k):
        x, info = real_cg(*a, **k)
        cg.append(info["iters"])
        return x, info

    res = {"forward_equal": same, "newton": fwd[True][1]["newton_iters"].tolist(),
           "cg": fwd[True][1]["cg_iters"].tolist()}
    s = torch.tensor(1.0, dtype=md.dtype, device=dev, requires_grad=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    L = loss_scale(s)
    t_fwd = sync_s(dev, t0)
    spmv_cuda.reset_launches()
    residual.operator_from_values, krylov.SOLVERS["cg"] = op_spy, cg_spy
    try:
        with counted_plain() as plain:
            t0 = time.perf_counter()
            L.backward()
            t_bwd = sync_s(dev, t0)
    finally:
        residual.operator_from_values, krylov.SOLVERS["cg"] = real_op, real_cg
    launches = dict(spmv_cuda.launches)
    g = s.grad.item()
    with torch.no_grad():
        h = 1e-5
        fd = (loss_scale(s.detach() + h) - loss_scale(s.detach() - h)).item() / (2 * h)
    if fd == 0.0:
        raise RuntimeError("mean(N) does not move with inputs_scale")
    res["scale"] = dict(grad=g, fd=fd, rel=abs(g - fd) / abs(fd))
    res.update(launches_backward=launches, plain_calls_backward=plain,
               adjoint_cg=list(cg), forward_ms_per_step=1e3 * t_fwd / steps,
               backward_ms_per_step=1e3 * t_bwd / steps,
               peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None))
    log("  d mean(N)/d inputs_scale: " + json.dumps(res["scale"])
        + f"; adjoint CG per step {cg}; forward "
        f"{res['forward_ms_per_step']:.1f} ms/step, backward "
        f"{res['backward_ms_per_step']:.1f} ms/step; backward launches "
        f"{launches}, plain calls {plain}; peak {res['peak_gb']} GB")
    kernel = "bell_spmv" if mesh.bell_nbr is not None else "ell_spmv"
    if (res["scale"]["rel"] > FD_RTOL or len(seen) != steps
            or launches[kernel] <= 0 or any(plain.values())):
        raise RuntimeError(f"adjoint (inputs_scale): {res}")

    # the adjoint's transposed operator against its plain version
    if dev.type == "cuda" and kernel == "bell_spmv":
        vals, dirichlet, extra = seen[-1]
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(
            mesh.n_nodes), dtype=md.dtype, device=dev)
        rtol, atol_rel = next((r, a) for t, r, a in TOLS if t == md.dtype)
        res["operator_max_abs_err"] = check_operator(
            "adjoint A^T (last step)", vals, mesh, x, dirichlet, extra, rtol,
            atol_rel)

    # the (n,) inputs field through make_runner, along a seeded direction
    runner = ts.make_runner(md.params, cfg)
    base = static.inputs
    v = torch.as_tensor(np.random.default_rng(7).normal(size=mesh.n_nodes),
                        dtype=md.dtype, device=dev)
    v = v / torch.linalg.vector_norm(v)

    def loss_inputs(inputs):
        out, _ = runner(mesh, dataclasses.replace(static, inputs=inputs),
                        state, dts)
        return out.N.mean() / 1e5

    x = base.clone().requires_grad_(True)
    spmv_cuda.reset_launches()
    t0 = time.perf_counter()
    loss_inputs(x).backward()
    t_field = sync_s(dev, t0)
    gdir = float(torch.dot(x.grad, v))
    with torch.no_grad():
        h = 1e-6 * float(torch.linalg.vector_norm(base))
        fd = (loss_inputs(base + h * v) - loss_inputs(base - h * v)).item() / (2 * h)
    if fd == 0.0:
        raise RuntimeError("mean(N) does not move with the inputs field")
    res["inputs"] = dict(grad_dir=gdir, fd=fd, rel=abs(gdir - fd) / abs(fd),
                         launches=dict(spmv_cuda.launches),
                         s=t_field)
    log("  d mean(N)/d inputs (make_runner) along a seeded direction: "
        + json.dumps(res["inputs"]))
    if res["inputs"]["rel"] > FD_RTOL:
        raise RuntimeError(f"adjoint (inputs field): {res['inputs']}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 16: {res['wall_s']:.1f} s")
    return res


def bell_batched_bound(mesh, dtype, M):
    """(ms, 'bytes' or 'operations') of one member-batched launch: M times
    each member's values, x, y and extra, plus the view's positions, the
    row lengths and the mask once; M times the flops."""
    es = torch.tensor([], dtype=dtype).element_size()
    n = mesh.n_nodes
    nnz = int((mesh.bell_nz_pos >= 0).sum())
    nbytes = M * (nnz * es + 3 * n * es) + nnz * 4 + 4 * n + n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = M * (2 * nnz + 3 * n) / FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def block_diag_csr(vals, mesh):
    """The M operators as one block-diagonal torch sparse CSR matrix (the
    library yardstick of the batched launch; never used by the port)."""
    from shakti_tpu_torch.ops.spmv_cuda import view_columns
    n = mesh.n_nodes
    col = view_columns(mesh.bell_nz_pos, mesh.bell_nbr, mesh.bell_B)
    parts = [csr_of(vals[m], mesh.bell_nz_pos, col, n)
             for m in range(vals.shape[0])]
    nnz = parts[0].values().numel()
    crow = torch.cat([parts[0].crow_indices()] + [
        p.crow_indices()[1:] + m * nnz for m, p in enumerate(parts) if m])
    cols = torch.cat([p.col_indices() + m * n for m, p in enumerate(parts)])
    return torch.sparse_csr_tensor(crow, cols,
                                   torch.cat([p.values() for p in parts]),
                                   (len(parts) * n,) * 2)


def check_batched(tag, vals, mesh, x, dirichlet, extra, rtol, atol_rel):
    """The batched launch: each member bitwise equal to a single launch on
    its slice, all within tolerance of the plain version (per member), and
    bitwise repeatable; returns the error against the plain version."""
    from shakti_tpu_torch.ops import spmv_cuda as sp
    op = sp.bell_operator_batched_fn(vals, mesh, dirichlet, extra)
    y = op(x)
    singles = torch.stack([sp.bell_operator_fn(
        vals[m], mesh, dirichlet, None if extra is None else extra[m])(x[m])
        for m in range(vals.shape[0])])
    plain = sp.bell_operator_batched_plain(vals, mesh, x, dirichlet, extra)
    torch.cuda.synchronize()
    if not bitwise_equal(y, singles):
        raise RuntimeError(f"batched bell_spmv {tag}: differs from M single "
                           f"launches in {int((y != singles).sum())} entries")
    err = check_close(f"{tag} batched vs plain", y, plain, rtol, atol_rel)
    if not bitwise_equal(op(x), y):
        raise RuntimeError(f"batched bell_spmv {tag}: two launches differ")
    return err


def batched_kernel(dev, mesh, dirichlet, M_by_dtype):
    """The batched launch at the bench shape: checks (f32 at M = 8, f64 at M
    = 3) and, in f32, its times beside 8 single launches, the plain version
    and a block-diagonal CSR mv, and its bytes bound."""
    from shakti_tpu_torch.fem.bell import bell_from_elements
    from shakti_tpu_torch.ops import spmv_cuda as sp
    out = {}
    for dtype, rtol, atol_rel in TOLS:
        M = M_by_dtype[dtype]
        tag = f"M={M} {str(dtype).removeprefix('torch.')}"
        rng = np.random.default_rng(11)
        vals = torch.stack([bell_from_elements(torch.as_tensor(
            rng.standard_normal((mesh.n_cells, 3, 3)), dtype=dtype,
            device=dev), mesh) for _ in range(M)])
        x = torch.as_tensor(rng.standard_normal((M, mesh.n_nodes)),
                            dtype=dtype, device=dev)
        extra = torch.as_tensor(rng.random((M, mesh.n_nodes))
                                * ~dirichlet.cpu().numpy(), dtype=dtype,
                                device=dev)
        r = {"M": M}
        r["max_abs_err_product"] = check_batched(f"{tag} product", vals, mesh,
                                                 x, None, None, rtol, atol_rel)
        r["max_abs_err"] = check_batched(f"{tag} epilogue", vals, mesh, x,
                                         dirichlet, extra, rtol, atol_rel)
        if dtype == torch.float32:
            op = sp.bell_operator_batched_fn(vals, mesh, dirichlet, extra)
            singles = [sp.bell_operator_fn(vals[m], mesh, dirichlet, extra[m])
                       for m in range(M)]
            xs = list(x)

            def eight():
                for m in range(M):
                    singles[m](xs[m])
            r["device_ms"] = device_ms(lambda: op(x), "bell_spmv")
            r["singles_device_ms"] = device_ms(eight)
            r["ms"] = median_ms(lambda: op(x))
            r["singles_ms"] = median_ms(eight)
            r["plain_device_ms"] = device_ms(
                lambda: sp.bell_operator_batched_plain(vals, mesh, x,
                                                       dirichlet, extra))
            r["plain_ms"] = median_ms(
                lambda: sp.bell_operator_batched_plain(vals, mesh, x,
                                                       dirichlet, extra))
            prod = sp.bell_operator_batched_fn(vals, mesh)
            try:
                A = block_diag_csr(vals, mesh)
                xf = x.reshape(-1)
                check_close(f"{tag} library block-diagonal CSR vs kernel",
                            torch.mv(A, xf), prod(x).reshape(-1), 1e-5,
                            atol_rel)
                r["library_device_ms"] = device_ms(lambda: torch.mv(A, xf))
                r["library_ms"] = median_ms(lambda: torch.mv(A, xf))
                del A
            except RuntimeError as e:
                log(f"  library block-diagonal CSR mv refused: {e}")
                r["library_device_ms"] = r["library_ms"] = None
            r["bound_ms"], r["bound_by"] = bell_batched_bound(mesh, dtype, M)
            log(f"  batched launch {tag}: device {r['device_ms']:.5f} ms "
                f"(8 single launches {r['singles_device_ms']:.5f} ms device),"
                f" {r['ms']:.5f} ms/call between CUDA events (8 singles "
                f"{r['singles_ms']:.5f}); plain {r['plain_device_ms']:.5f} ms "
                f"device ({r['plain_ms']:.5f} events); library block-diagonal "
                f"CSR mv {r['library_device_ms']} ms device "
                f"({r['library_ms']} events); bound {r['bound_ms']:.5f} ms by "
                f"{r['bound_by']}")
        out[str(dtype).removeprefix("torch.")] = r
        del vals, x, extra
    return out


# members 0 and 7 alone against their slots of the f32 ensemble: roundoff
# in the batched dots, norms and coarse products (another reduction order
# on the card) moves N by at most a few Newton tolerances (rtol 2e-5)
ENSEMBLE_F32_RTOL = 1e-4


def phase_ensemble(dev, md32=None, md64=None, steps=24, steps64=4, M=8,
                   M64=3):
    """Phase 17: the batched ensemble at full width.  The bench model in
    float32, M = 8 members of perturbed_ensemble(b_scale 5e-4, seed 0),
    ``steps`` hourly steps through make_ensemble_runner: converged, finite,
    the batched bell_spmv launched and no matvec through a plain version;
    members 0 and 7 alone with equal Newton counts and N within
    ENSEMBLE_F32_RTOL of scale; then float64 with M = 3 over ``steps64``
    steps equal to the member runs within 1e-10; the batched launch checked
    and timed at the bench shape."""
    import dataclasses

    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.parallel import ensemble as ens_mod
    from shakti_tpu_torch.setups import setup_bench
    from shakti_tpu_torch.solve import timestep as ts
    t_phase = time.perf_counter()
    res = {}
    if md32 is None:
        md32 = setup_bench.initialize(days=2)
        md32.device = dev
    mesh, static, state, cfg = md32.freeze()
    forcing = {k: v[:steps] for k, v in ts.make_forcing(
        md32.timesteps, dtype=md32.dtype, device=dev).items()}
    ens = ens_mod.perturbed_ensemble(state, M, b_scale=5e-4, seed=0)
    runner = ens_mod.make_ensemble_runner(mesh, static, md32.params, cfg)
    spmv_cuda.reset_launches()
    with counted_plain() as plain:
        t0 = time.perf_counter()
        out, d = runner(ens, forcing)
        wall = sync_s(dev, t0)
    launches = dict(spmv_cuda.launches)
    finite = all(bool(torch.isfinite(getattr(out, k)).all())
                 for k in ("N", "b", "q", "melt"))
    res.update(M=M, steps=steps, launches=launches, plain_calls=plain,
               ms_per_step=1e3 * wall / steps,
               ms_per_member_step=1e3 * wall / steps / M,
               newton_mean=float(d["newton_iters"].mean()),
               cg_mean=float(d["cg_iters"].mean()))
    log(f"  ensemble M={M} f32 {steps} steps: " + json.dumps(res))
    batched_name = ("bell_spmv_batched" if mesh.bell_nbr is not None
                    else "ell_spmv")
    if not (d["converged"].all() and finite and launches[batched_name] > 0
            and not any(plain.values())):
        raise RuntimeError(f"ensemble run: converged {d['converged']}, "
                           f"finite {finite}, {res}")
    step = ts.make_step_fn(mesh, static, md32.params,
                           dataclasses.replace(cfg, lag_operator=False))
    members = {}
    for m in (0, M - 1):
        t0 = time.perf_counter()
        s, dm = ts.run_window(step, ens_mod.member(ens, m), forcing)
        w = sync_s(dev, t0)
        scale = float(s.N.abs().max())
        members[m] = dict(
            ms_per_step=1e3 * w / steps,
            newton_equal=bool(np.array_equal(dm["newton_iters"],
                                             d["newton_iters"][:, m])),
            cg_alone=int(dm["cg_iters"].sum()),
            cg_in_ensemble=int(d["cg_iters"][:, m].sum()),
            err_N=float((s.N - out.N[m]).abs().max()) / scale)
    res["members"] = members
    log("  members alone (f32): " + json.dumps(members))
    if not all(r["newton_equal"] and r["err_N"] <= ENSEMBLE_F32_RTOL
               for r in members.values()):
        raise RuntimeError(f"ensemble members differ from their runs: "
                           f"{members}")
    del out, ens

    # float64, M64 members: equal to the member runs to 1e-10
    if md64 is None:
        md64 = setup_bench.initialize(days=2)
        md64.device, md64.dtype = dev, torch.float64
    mesh64, static64, state64, cfg64 = md64.freeze()
    dts = ts.timestep_sizes(md64.timesteps, md64.dtype, dev)[:steps64]
    ens = ens_mod.perturbed_ensemble(state64, M64, b_scale=5e-4, seed=0)
    out, d = ens_mod.make_ensemble_runner(mesh64, static64, md64.params,
                                          cfg64)(ens, dts)
    step = ts.make_step_fn(mesh64, static64, md64.params,
                           dataclasses.replace(cfg64, lag_operator=False))
    f64 = {}
    for m in range(M64):
        s, dm = ts.run_window(step, ens_mod.member(ens, m), dts)
        f64[m] = dict(newton_equal=bool(np.array_equal(
            dm["newton_iters"], d["newton_iters"][:, m])),
            err_N=float((s.N - out.N[m]).abs().max() / s.N.abs().max()),
            err_b=float((s.b - out.b[m]).abs().max() / s.b.abs().max()))
    res["f64"] = f64
    log(f"  f64 M={M64} {steps64} steps against member runs: "
        + json.dumps(f64))
    if not (d["converged"].all() and all(
            r["newton_equal"] and max(r["err_N"], r["err_b"]) <= 1e-10
            for r in f64.values())):
        raise RuntimeError(f"f64 ensemble differs from member runs: {f64}")
    if dev.type == "cuda" and mesh.bell_nbr is not None:
        res["kernel"] = batched_kernel(dev, mesh, static.dirichlet,
                                       {torch.float32: M,
                                        torch.float64: M64})
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 17: {res['wall_s']:.1f} s")
    return res


# ---- phase 23: the ensemble's element kernels (csrc/element_batched.cu) --
# the kernels against their plain twin, as a share of the largest entry:
# float64 1e-12; float32 1e-5, because nvcc contracts each product and sum
# into an FMA (one rounding where the twin rounds twice) and the quadrature
# sums accumulate those differences over 6 points
ELEMENT_TOLS = {torch.float32: 1e-5, torch.float64: 1e-12}


def element_bounds(mesh, M, nq, dtype, k):
    """The bytes bound (ms at 3.35 TB/s) of each launch of
    csrc/element_batched.cu and of one residual call: per member and cell
    the fields a kernel reads (the Jacobian T_q, q_q, b_q; the residual
    those, mdiff_q and N_n) and what it writes, N or X and the result per
    member and node, the shared fields and the geometry once.  The
    residual call's bound leaves out the corner contributions, which the
    two passes write and read back."""
    es = torch.tensor([], dtype=dtype).element_size()
    c, n, S = mesh.n_cells, mesh.n_nodes, mesh.inc_map.shape[1]
    geometry = c * (3 * 8 + 8 * es)
    corner = M * c * 3 * k * es
    jac = (M * c * (4 * nq + 9) + M * n + c * nq) * es + geometry
    cells = (M * c * 6 * nq + M * n * k + 3 * c * nq + 2 * c) * es + geometry
    nodes = M * n * k * es + n * S * 8 + n
    return {key: 1e3 * v / HBM_BYTES_PER_S for key, v in (
        ("jacobian", jac), ("residual_cells", cells + corner),
        ("node_sum", nodes + corner), ("residual_call", cells + nodes))}


def rel_to_max(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


def ensemble_batch(md, cfg, ens, dt, dtype):
    """The ensemble ``ens`` at one step of ``md`` in ``dtype``: (mesh,
    static, the members' StepPre as the ensemble's vmapped precompute makes
    it, its checked ops/element_cuda batch, N (M, n) contiguous)."""
    from shakti_tpu_torch.ops import element_cuda as ec
    from shakti_tpu_torch.physics import residual as pres
    md.dtype = dtype
    mesh_t, static_t = md.freeze()[:2]
    st = {k: getattr(ens, k).to(dtype) for k in ("N", "b", "q", "melt")}
    dt = dt.to(dtype)
    sq = pres.static_quad_fields(mesh_t, static_t, cfg.quad_degree, dtype)
    pre = pres.StepPre(*torch.func.vmap(
        lambda N_, b_, q_, m_: pres.pre_values(pres.precompute_step(
            mesh_t, N_, b_, q_, m_, static_t, dt, md.params,
            cfg.quad_degree, sq=sq)))(st["N"], st["b"], st["q"], st["melt"]))
    return (mesh_t, static_t, pre, ec.prepare(pre, mesh_t, md.params),
            st["N"].contiguous())


def phase_element(dev, M=128, steps=2):
    """Phase 23: csrc/element_batched.cu at cooke2-ens128's shapes.  The
    Cook_E2 mesh (setup_cooke2 on assets/cooke2_synth: 12,270 nodes, 23,990
    cells), M members of perturbed_ensemble stepped ``steps`` hourly f32
    steps (every launch of both libraries counted); at that state, in
    float32 and float64, the Jacobian and the 3-column residual (seeded
    1 % perturbations of N) against the plain twin within ELEMENT_TOLS of
    the largest entry, each column bitwise a 1-column launch, the node sum
    bitwise the twin's on the kernel's corners, two launches bitwise
    equal; in float32 the device time per launch beside its bytes bound,
    the twin's, and the forward-AD route's (vmap of physics/residual's
    element_jacobian and assemble_residual(_multi), the route the batched
    Newton solve took before, the one PyTorch yardstick)."""
    import dataclasses

    from shakti_tpu_torch.ops import element_cuda as ec
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.parallel import ensemble as ens_mod
    from shakti_tpu_torch.physics import residual as pres
    from shakti_tpu_torch.solve import timestep as ts
    t_phase = time.perf_counter()
    md = cooke2_setup({"SHAKTI_MESH_DIR": COOKE2_DIR}, days=1,
                      results_name=None)
    md.device, md.dtype = dev, torch.float32
    mesh, static, state, cfg = md.freeze()
    cfg = dataclasses.replace(cfg, adaptive_dt_levels=0)
    dts = ts.timestep_sizes(md.timesteps, md.dtype, dev)
    step = ens_mod.make_ensemble_step_fn(mesh, static, md.params, cfg)
    ens = ens_mod.perturbed_ensemble(state, M, b_scale=5e-4, seed=0)
    ec.reset_launches()
    spmv_cuda.reset_launches()
    t0 = time.perf_counter()
    for s in range(steps):
        ens, d = step(ens, dts[s])
    wall = sync_s(dev, t0)
    res = {"M": M, "n": mesh.n_nodes, "c": mesh.n_cells, "steps": steps,
           "wall_s_steps": wall, "launches": dict(ec.launches),
           "spmv_launches": dict(spmv_cuda.launches),
           "newton": d["newton_iters"].tolist()[:4],
           "converged": bool(d["converged"].all())}
    log(f"  {steps} steps of M={M} on Cook_E2 (f32): launches "
        f"{res['launches']}, spmv {res['spmv_launches']}, "
        f"{wall:.2f} s, converged {res['converged']}")
    if not res["converged"] or min(res["launches"].values()) < steps:
        raise RuntimeError(f"phase 23: the ensemble steps: {res}")
    rng = np.random.default_rng(23)
    noise = rng.standard_normal((M, mesh.n_nodes, 2))
    for dtype, tol in ELEMENT_TOLS.items():
        mesh_t, static_t, pre, batch, N = ensemble_batch(md, cfg, ens,
                                                         dts[0], dtype)
        pert = torch.as_tensor(noise, dtype=dtype, device=dev)
        X = torch.stack([N, N * (1 + 1e-2 * pert[..., 0]),
                         N * (1 + 1e-2 * pert[..., 1])], dim=-1).contiguous()
        mask = static_t.dirichlet
        tag = str(dtype).removeprefix("torch.")
        J = ec.jacobian(batch, N)
        J_plain = ec.jacobian_plain(batch, N)
        corner = ec.corner_residual(batch, X)
        F = ec.node_sum(batch, corner, mask)
        corner_plain = ec.corner_residual_plain(batch, X)
        F_plain = ec.node_sum_plain(batch, corner_plain, mask)
        torch.cuda.synchronize()
        scale = J_plain.abs().amax(dim=(2, 3), keepdim=True)
        r = {"jacobian_err": rel_to_max(J, J_plain),
             "jacobian_block_err": float(((J - J_plain).abs()
                                          / scale.clamp_min(1e-300))
                                         .max()),
             "corner_err": rel_to_max(corner, corner_plain),
             "residual_err": rel_to_max(F, F_plain),
             "max_abs_J": float(J_plain.abs().max()),
             "max_abs_F": float(F_plain.abs().max())}
        cols = [bitwise_equal(
            ec.corner_residual(batch, X[..., j:j + 1].contiguous())[..., 0],
            corner[..., j]) and bitwise_equal(
            ec.residual(batch, X[..., j].contiguous(), mask), F[..., j])
            for j in range(3)]
        r["columns_bitwise"] = all(cols)
        r["node_sum_bitwise"] = bitwise_equal(
            F, ec.node_sum_plain(batch, corner, mask))
        r["repeatable"] = (bitwise_equal(ec.jacobian(batch, N), J)
                           and bitwise_equal(ec.residual(batch, X, mask), F))
        log(f"  {tag}: " + json.dumps(r))
        bad = [k for k in ("jacobian_err", "corner_err", "residual_err")
               if not r[k] <= tol]
        bad += [k for k in ("columns_bitwise", "node_sum_bitwise",
                            "repeatable") if not r[k]]
        if bad:
            raise RuntimeError(f"phase 23 {tag}: {bad}: {r}")
        if dtype == torch.float32:
            X1 = X[..., :1].contiguous()
            c1 = ec.corner_residual(batch, X1)
            r["bound_ms"] = element_bounds(mesh_t, M, batch.nq, dtype, 1)
            r["bound_ms_k3"] = element_bounds(mesh_t, M, batch.nq, dtype, 3)
            r["device_ms"] = {
                "jacobian": device_ms(lambda: ec.jacobian(batch, N),
                                      "jacobian_kernel"),
                "residual_cells": device_ms(
                    lambda: ec.corner_residual(batch, X1), "residual_kernel"),
                "residual_cells_k3": device_ms(
                    lambda: ec.corner_residual(batch, X), "residual_kernel"),
                "node_sum": device_ms(lambda: ec.node_sum(batch, c1, mask),
                                      "node_sum_kernel"),
                "node_sum_k3": device_ms(
                    lambda: ec.node_sum(batch, corner, mask),
                    "node_sum_kernel")}
            r["ms"] = {"jacobian": median_ms(lambda: ec.jacobian(batch, N)),
                       "residual": median_ms(
                           lambda: ec.residual(batch, N, mask)),
                       "residual_k3": median_ms(
                           lambda: ec.residual(batch, X, mask))}
            r["plain_device_ms"] = {
                "jacobian": device_ms(lambda: ec.jacobian_plain(batch, N),
                                      reps=10, warmup=2),
                "residual": device_ms(lambda: ec.node_sum_plain(
                    batch, ec.corner_residual_plain(batch, X1), mask),
                    reps=10, warmup=2)}
            vals = pres.pre_values(pre)
            v_jac = torch.func.vmap(lambda N_, *p: pres.element_jacobian(
                N_, pres.StepPre(*p), mesh_t, md.params))
            v_res = torch.func.vmap(lambda N_, *p: pres.assemble_residual(
                N_, pres.StepPre(*p), mesh_t, md.params))
            v_multi = torch.func.vmap(
                lambda N_, *p: pres.assemble_residual_multi(
                    N_, pres.StepPre(*p), mesh_t, md.params))
            r["ad_err"] = {"jacobian": rel_to_max(J, v_jac(N, *vals)),
                           "residual_k3": rel_to_max(
                               F, torch.where(mask[:, None], 0.0,
                                              v_multi(X, *vals)))}
            r["library_ms"] = {
                "jacobian": median_ms(lambda: v_jac(N, *vals), reps=10),
                "residual": median_ms(lambda: v_res(N, *vals), reps=10),
                "residual_k3": median_ms(lambda: v_multi(X, *vals), reps=10)}
            r["library_device_ms"] = {
                "jacobian": device_ms(lambda: v_jac(N, *vals), reps=10,
                                      warmup=2),
                "residual": device_ms(lambda: v_res(N, *vals), reps=10,
                                      warmup=2)}
            dm, b1 = r["device_ms"], r["bound_ms"]
            r["roofline_pct"] = {
                "jacobian": 100 * b1["jacobian"] / dm["jacobian"],
                "residual_cells": 100 * b1["residual_cells"]
                / dm["residual_cells"],
                "node_sum": 100 * b1["node_sum"] / dm["node_sum"],
                "residual_call": 100 * b1["residual_call"]
                / (dm["residual_cells"] + dm["node_sum"])}
            log(f"  {tag} times: " + json.dumps({k: r[k] for k in (
                "device_ms", "bound_ms", "roofline_pct", "ms",
                "plain_device_ms", "library_ms", "library_device_ms",
                "ad_err")}))
        res[tag] = r
        del pre, batch, J, J_plain, corner, corner_plain, F, F_plain, X
        torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 23: {res['wall_s']:.1f} s")
    return res


# ---- phase 24: the ensemble's coarse operators (coarse_batched) ---------

def coarse_bound(mesh, M, dtype, plan):
    """The bytes bound (ms at 3.35 TB/s) of one coarse_batched launch: each
    member's 9c entries of J read once and its (m, m) operator written; the
    plan (positions, offsets, slots, the filled mask), the cells and the
    Dirichlet mask read once."""
    es = torch.tensor([], dtype=dtype).element_size()
    U, mm = plan.slots.shape[0], plan.m * plan.m
    need = (M * (9 * mesh.n_cells + mm) * es + 9 * mesh.n_cells * 4
            + (U + 1) * 4 + U * 8 + mm + 3 * 8 * mesh.n_cells + mesh.n_nodes)
    return 1e3 * need / HBM_BYTES_PER_S


def phase_coarse(dev, M=128, steps=2):
    """Phase 24: csrc/element_batched.cu's coarse_batched at cooke2-ens128's
    shapes.  The Cook_E2 mesh, M members of perturbed_ensemble stepped
    ``steps`` hourly f32 steps under the two-level preconditioner, one
    launch per Newton iteration of the ensemble; at that state, in float32
    and float64, the element Jacobian's coarse operators at the run's
    aggregate size (and at 64 nodes) bitwise the plain twin's, two launches
    bitwise equal; in float32 the launch's device time beside its bytes
    bound, the twin's, the batched preconditioner build's (kernel, inverse)
    and that of the route it replaces, the vmapped coarse_from_values over
    the folded block-ELL values, with both routes' inverses compared."""
    import dataclasses

    from shakti_tpu_torch.ops import element_cuda as ec
    from shakti_tpu_torch.parallel import ensemble as ens_mod
    from shakti_tpu_torch.physics import residual as pres
    from shakti_tpu_torch.solve import precond as pc
    from shakti_tpu_torch.solve import timestep as ts
    t_phase = time.perf_counter()
    md = cooke2_setup({"SHAKTI_MESH_DIR": COOKE2_DIR}, days=1,
                      results_name=None)
    md.device, md.dtype = dev, torch.float32
    md.solver = dataclasses.replace(md.solver, adaptive_dt_levels=0,
                                    precond="two_level")
    mesh, static, state, cfg = md.freeze()
    dts = ts.timestep_sizes(md.timesteps, md.dtype, dev)
    step = ens_mod.make_ensemble_step_fn(mesh, static, md.params, cfg)
    ens = ens_mod.perturbed_ensemble(state, M, b_scale=5e-4, seed=0)
    ec.reset_launches()
    newton = 0
    for s in range(steps):
        ens, d = step(ens, dts[s])
        newton += int(np.max(d["newton_iters"]))
    blocks = (cfg.coarse_block, 64)
    res = {"M": M, "n": mesh.n_nodes, "c": mesh.n_cells, "steps": steps,
           "blocks": blocks, "newton_iterations": newton,
           "launches": ec.launches["coarse_batched"],
           "converged": bool(np.all(d["converged"]))}
    log(f"  {steps} steps of M={M} on Cook_E2 (f32, two-level, block "
        f"{cfg.coarse_block}): {res['launches']} coarse_batched launches for "
        f"{newton} Newton iterations, converged {res['converged']}")
    if not res["converged"] or res["launches"] != newton:
        raise RuntimeError(f"phase 24: the ensemble steps: {res}")
    for dtype in (torch.float32, torch.float64):
        mesh_t, static_t, pre, batch, N = ensemble_batch(md, cfg, ens,
                                                         dts[0], dtype)
        J = ec.jacobian(batch, N)
        fixed = static_t.dirichlet
        tag = str(dtype).removeprefix("torch.")
        r = {}
        for block in blocks:
            plan = ec.coarse_plan(mesh_t, block)
            A = ec.coarse(mesh_t, J, fixed, block)
            torch.cuda.synchronize()
            counts = plan.offsets.diff()
            r[block] = {"m": plan.m, "pairs": plan.slots.shape[0],
                        "longest": plan.maxlen,
                        "mean_pair": float(counts.double().mean()),
                        "bitwise": bitwise_equal(
                            A, ec.coarse_plain(mesh_t, J, fixed, block)),
                        "repeatable": bitwise_equal(
                            A, ec.coarse(mesh_t, J, fixed, block))}
        log(f"  {tag}: " + json.dumps(r))
        bad = [(b, k) for b, v in r.items() for k in ("bitwise", "repeatable")
               if not v[k]]
        if bad:
            raise RuntimeError(f"phase 24 {tag}: {bad}: {r}")
        if dtype == torch.float32:
            a_diag = torch.ones_like(N)
            vals = torch.func.vmap(
                lambda J_: pres.fold_operator_values(J_, mesh_t))(J)
            for block in blocks:
                rb = r[block]
                plan = ec.coarse_plan(mesh_t, block)

                def kernel():
                    return ec.coarse(mesh_t, J, fixed, block)

                def build():
                    return pc.make_preconditioner_batched(
                        "two_level", mesh_t, fixed, a_diag, block, J_c=J)

                def replaced():
                    return torch.func.vmap(lambda v: pc.coarse_from_values(
                        v, mesh_t, fixed, block))(vals)

                rb["bound_ms"] = coarse_bound(mesh_t, M, dtype, plan)
                rb["device_ms"] = device_ms(kernel, "coarse_kernel")
                rb["ms"] = median_ms(kernel)
                rb["roofline_pct"] = 100 * rb["bound_ms"] / rb["device_ms"]
                rb["plain_device_ms"] = device_ms(
                    lambda: ec.coarse_plain(mesh_t, J, fixed, block),
                    reps=10, warmup=2)
                rb["build_ms"] = median_ms(build, reps=20)
                rb["build_device_ms"] = device_ms(build, reps=20)
                rb["library_ms"] = median_ms(replaced, reps=10, warmup=2)
                rb["library_device_ms"] = device_ms(replaced, reps=10,
                                                    warmup=2)
                new_inv = torch.func.vmap(lambda A_: pc.regularized_inverse(
                    A_, plan.m, dtype, torch.finfo(dtype).tiny))(kernel())
                rb["inverse_err"] = rel_to_max(new_inv, replaced())
                log(f"  {tag} block {block} times: " + json.dumps(rb))
            del vals
        res[tag] = r
        del pre, batch, J
        torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 24: {res['wall_s']:.1f} s")
    return res


# ---- phase 18: Cook_E2 from the potential field to the validation battery
# scripts/make_cooke2_mesh.py's target: the reference mesh's node count at
# 2 km (BASELINE.md)
COOKE2_NODES, COOKE2_RES = 12_268, 2000.0
COOKE2_DIR = os.path.join(HERE, "assets", "cooke2_synth")
# COOKE2_RUN.md: the JAX package's 10-year run on a TPU, printed beside
# this 10-day run for orientation only (no gate)
COOKE2_TPU_10Y = dict(far_field_ratio=0.8963, lake_level_final_m=3.348,
                      filling_rate_m_per_yr=0.3936, mean_gap_final_mm=2.356,
                      max_offlake_flux_final_m2s=0.01009)
YEAR_S = 3.154e7


def cooke2_potential(n=600, L=160e3, seed=7):
    """scripts/make_cooke2_mesh.py:synthetic_potential: a two-outlet
    potential with seeded ridge noise (ragged divides) and the lake."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-L, L, n)
    y = np.linspace(-L, L, n)
    X, Y = np.meshgrid(x, y)
    c1 = np.hypot(X + L, Y + 0.3 * L)
    c2 = np.hypot(X - L, Y - 0.4 * L)
    base = 0.004 * np.minimum(c1, 1.08 * c2)
    ridges = np.zeros_like(X)
    for _ in range(12):
        kx, ky = rng.uniform(-4, 4, 2) * np.pi / L
        ridges += rng.uniform(10, 30) * np.cos(kx * X + ky * Y
                                               + rng.uniform(0, 2 * np.pi))
    bowl = 60.0 * np.exp(-((X + 0.15 * L) / 14e3) ** 2
                         - ((Y - 0.05 * L) / 10e3) ** 2)
    phi = 917.0 * 9.81 * (1000.0 + base + ridges - bowl)
    th = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    lake = np.column_stack([-0.15 * L + 9e3 * np.cos(th),
                            0.05 * L + 7e3 * np.sin(th)])
    return x, y, phi, lake


def cooke2_mesh(out_dir):
    """scripts/make_cooke2_mesh.py:main through the port: the potential ->
    basin.basin_outline -> the catchment scaled to the reference mesh's
    area and tuned to its node count -> polygon_mesh(jitter 0.28, seed 3)
    -> write_msh; writes Cook_E2_mesh.msh, outline.npy and lake.npy into
    ``out_dir`` and returns the host seconds of each stage."""
    from shakti_tpu_torch.mesh import basin
    from shakti_tpu_torch.mesh.generate import polygon_mesh
    from shakti_tpu_torch.mesh.msh_io import write_msh
    t0 = time.perf_counter()
    x, y, phi, lake = cooke2_potential()
    t1 = time.perf_counter()
    outline = basin.basin_outline(x, y, phi, lake_outline=lake)
    t2 = time.perf_counter()
    area = 0.5 * abs(np.sum(outline[:, 0] * np.roll(outline[:, 1], -1)
                            - np.roll(outline[:, 0], -1) * outline[:, 1]))
    target_area = 24_101 * (np.sqrt(3) / 4) * COOKE2_RES ** 2
    c = outline.mean(axis=0)
    scale = np.sqrt(target_area / area)
    for _ in range(8):
        out_s = (outline - c) * scale + c
        nodes, cells = polygon_mesh(out_s, COOKE2_RES, jitter=0.28, seed=3)
        err = nodes.shape[0] / COOKE2_NODES
        if abs(err - 1.0) < 0.01:
            break
        scale /= np.sqrt(err)
    t3 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    write_msh(os.path.join(out_dir, "Cook_E2_mesh.msh"), nodes, cells)
    np.save(os.path.join(out_dir, "outline.npy"), out_s)
    np.save(os.path.join(out_dir, "lake.npy"), (lake - c) * scale + c)
    return dict(potential_s=t1 - t0, basin_outline_s=t2 - t1,
                mesh_s=t3 - t2, write_s=time.perf_counter() - t3,
                basin_vertices=int(outline.shape[0]), scale=float(scale))


def bitwise_equal_np(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def same_mesh(got_dir, ref_dir=COOKE2_DIR):
    """outline.npy, lake.npy and the nodes bitwise equal; the cells equal
    as a set of triangles (another qhull may order them otherwise)."""
    from shakti_tpu_torch.mesh.msh_io import read_msh
    same = {f: bitwise_equal_np(np.load(os.path.join(got_dir, f)),
                                np.load(os.path.join(ref_dir, f)))
            for f in ("outline.npy", "lake.npy")}
    gn, gc = read_msh(os.path.join(got_dir, "Cook_E2_mesh.msh"))
    rn, rc = read_msh(os.path.join(ref_dir, "Cook_E2_mesh.msh"))
    same["nodes"] = bitwise_equal_np(gn, rn)

    def triangles(c):
        return np.unique(np.sort(c, axis=1), axis=0)
    same["cells"] = (gc.shape == rc.shape
                     and np.array_equal(triangles(gc), triangles(rc))
                     and triangles(gc).shape[0] == gc.shape[0])
    return same, gn.shape[0], gc.shape[0]


def script(name, folder="scripts"):
    """<folder>/<name>.py of this checkout, loaded by path (once)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, folder, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def cooke2_setup(env, **kw):
    """The port's setup_cooke2.initialize(**kw) with the environment
    variables ``env`` set for the call (and restored after)."""
    from shakti_tpu_torch.setups import setup_cooke2
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return setup_cooke2.initialize(**kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def cooke2_battery(rdir, md):
    """Phase 18 (c): the validation battery of scripts/cooke2_report.py
    through the port's post, on the run's results directory."""
    from shakti_tpu_torch import post
    r = post.load_results(rdir)
    lake = md.lake_bdry.astype(bool)
    far = script("torch_cooke2_report").far_mask(md)
    t, N, b = r["t"], r["N"], r["b"]
    lvl = post.lake_level(N, lake, md.params)
    # the level straight from the N history: -(mean N - mean N_0)/(rho_w g)
    NL = N[:, lake]
    direct = -(NL.mean(axis=1) - NL[0].mean()) / (md.params.rho_w * md.params.g)
    out = dict(
        rows=int(N.shape[0]), far_nodes=int(far.sum()),
        lake_nodes=int(lake.sum()),
        far_field_ratio=post.far_field_ratio(N, far, md.N_bdry),
        far_field_mean_N_MPa=float(N[-1, far].mean()) / 1e6,
        lake_mean_N_final_MPa=float(post.lake_mean(N, lake)[-1]) / 1e6,
        lake_level_final_m=float(lvl[-1]),
        filling_rate_m_per_yr=post.filling_rate(t, N, lake, md.params) * YEAR_S,
        mean_gap_final_mm=float(post.mean_gap(b)[-1]) * 1e3,
        max_offlake_flux_final_m2s=float(post.max_flux(
            r["qx"], r["qy"], exclude_mask=lake)[-1]),
        lake_level_direct_equal=bool(np.array_equal(lvl, direct)))
    return out, r


def cooke2_precision(dev, env, steps=96):
    """Phase 18 (d): ``steps`` hourly steps in float32 and in float64 from
    the setup's initial state on this mesh; relative L2 difference of N and
    b (tests/test_precision.py's guard on the bench catchment)."""
    from shakti_tpu_torch.solve import timestep as ts
    fin = {}
    for dtype in (torch.float32, torch.float64):
        md = cooke2_setup(env, days=10, results_name=None)
        md.device, md.dtype = dev, dtype
        mesh, static, state, cfg = md.freeze()
        step = ts.make_step_fn(mesh, static, md.params, cfg)
        t0 = time.perf_counter()
        s, d = ts.run_window(step, state, torch.full((steps,), 3600.0,
                                                     dtype=dtype, device=dev))
        wall = sync_s(dev, t0)
        if not d["converged"].all():
            raise RuntimeError(f"cooke2 {dtype} {steps} steps: not every step "
                               f"converged ({d['converged']})")
        fin[dtype] = (s, wall, int(d["newton_iters"].sum()),
                      int(d["cg_iters"].sum()))
    s32, s64 = fin[torch.float32][0], fin[torch.float64][0]
    res = {k: float(torch.linalg.vector_norm(getattr(s32, k).double()
                                             - getattr(s64, k))
                    / torch.linalg.vector_norm(getattr(s64, k)))
           for k in ("N", "b")}
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        _, wall, nt, cg = fin[dtype]
        res[name] = dict(ms_per_step=1e3 * wall / steps, newton=nt, cg=cg)
    return res


def phase_cooke2(dev, tmp):
    """Phase 18: the reference's production experiment from its potential
    field to its validation battery, through the port only: (a) the
    catchment mesh regenerated (cooke2_mesh) and equal to
    assets/cooke2_synth; (b) an npz lake inventory, then setup_cooke2 on
    that mesh for 10 days in float32 through api/run.solve (240 steps,
    daily saves, log.csv): every step converged, fields finite, every
    matvec a bell_spmv launch; (c) the battery through post, and the
    run's last day profiled from its final state; (d) float32
    against float64 over 96 hourly steps; (e) bell_spmv against its plain
    version on the run's last operator."""
    from shakti_tpu_torch.data.lakes import save_inventory_npz
    from shakti_tpu_torch.physics import residual
    t_phase = time.perf_counter()
    mesh_dir = os.path.join(tmp, "cooke2_mesh")
    res = {"mesh": cooke2_mesh(mesh_dir)}
    same, n, c = same_mesh(mesh_dir)
    res["mesh"].update(nodes=n, cells=c, equal=same)
    log("  (a) mesh from the potential field: " + json.dumps(res["mesh"]))
    if not all(same.values()):
        raise RuntimeError(f"regenerated Cook_E2 mesh differs from "
                           f"assets/cooke2_synth: {same}")

    inventory = os.path.join(tmp, "lakes.npz")
    save_inventory_npz(inventory, {"Cook_E2": {
        "outline": np.load(os.path.join(mesh_dir, "lake.npy")) / 1e3}})
    env = {"SHAKTI_MESH_DIR": mesh_dir, "SHAKTI_LAKE_INVENTORY": inventory}
    rdir = os.path.join(tmp, "cooke2_run")
    md = cooke2_setup(env, days=10, results_name=rdir)
    md.device = dev
    last = {}
    real_op = residual.operator_from_values

    def op_spy(vals, mesh_, dirichlet, extra=None):
        last.update(vals=vals, mesh=mesh_, dirichlet=dirichlet, extra=extra)
        return real_op(vals, mesh_, dirichlet, extra)

    residual.operator_from_values = op_spy
    try:
        with counted_plain() as plain:
            out, launches = run_counted(md)
    finally:
        residual.operator_from_values = real_op
    st = out["state"]
    finite = all(bool(torch.isfinite(getattr(st, k)).all())
                 for k in ("N", "b", "q", "melt"))
    with open(os.path.join(rdir, "log.csv")) as f:
        log_rows = len(f.read().splitlines()) - 1
    steps = out["steps"]
    run = dict(nodes=md.x.size, steps=steps, dtype=str(st.N.dtype),
               operator="bell" if last["mesh"].bell_nbr is not None else "other",
               ms_per_step=1e3 * out["wall_time"] / steps,
               newton_mean=out["newton_iters_total"] / steps,
               cg_mean=out["cg_iters_total"] / steps,
               launches=launches, plain_calls=plain, log_rows=log_rows,
               finite=finite, smi=nvidia_smi_line() if dev.type == "cuda"
               else None)
    res["run"] = run
    log("  (b) setup_cooke2 10 days f32 through api/run.solve: "
        + json.dumps(run))
    # api/run.solve raises ConvergenceError at a step that did not converge
    if not (steps == 240 and finite and run["operator"] == "bell"
            and log_rows == 10
            and (dev.type != "cuda" or (launches["bell_spmv"] > 0
                                        and not any(plain.values())))):
        raise RuntimeError(f"cooke2 run: {run}")

    battery, hist = cooke2_battery(rdir, md)
    res["battery"] = battery
    log("  (c) battery (10 days, this run): " + json.dumps(battery))
    log("      COOKE2_RUN.md (JAX package, 10 years on a TPU; orientation "
        "only): " + json.dumps(COOKE2_TPU_10Y))
    if not (battery["lake_level_direct_equal"] and all(
            np.isfinite(v) for v in battery.values() if isinstance(v, float))
            and all(np.isfinite(hist[k]).all() for k in hist)):
        raise RuntimeError(f"cooke2 battery: {battery}")

    if dev.type == "cuda":
        # where a step of this run goes: its last day again, from its final
        # state, timed and then under torch.profiler
        from shakti_tpu_torch.solve.timestep import make_forcing, make_step_fn
        mesh, static, _, cfg = md.freeze()
        day = {k: v[-24:] for k, v in make_forcing(
            md.timesteps, dtype=md.dtype, device=dev).items()}
        res["profile"] = profile_steps(
            dev, make_step_fn(mesh, static, md.params, cfg), st, day,
            "bell_spmv")

    prec = cooke2_precision(dev, env)
    res["precision"] = prec
    log("  (d) f32 vs f64, 96 hourly steps: " + json.dumps(prec))
    if not (prec["N"] < 2e-3 and prec["b"] < 2e-3):
        raise RuntimeError(f"cooke2 f32 against f64: {prec}")

    if dev.type == "cuda":
        x = torch.as_tensor(np.random.default_rng(5).standard_normal(
            md.x.size), dtype=torch.float32, device=dev)
        res["operator_max_abs_err"] = check_operator(
            "cooke2 last operator (f32)", last["vals"], last["mesh"], x,
            last["dirichlet"], last["extra"], 2e-6, 1e-6)
        v64 = last["vals"].double()
        e64 = None if last["extra"] is None else last["extra"].double()
        res["operator_max_abs_err_f64"] = check_operator(
            "cooke2 last operator (f64)", v64, last["mesh"], x.double(),
            last["dirichlet"], e64, 1e-12, 1e-12)
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 18: {res['wall_s']:.1f} s")
    return res, (md, rdir, battery)


# ---- phase 21: the validation drivers of the port (scripts/torch_*.py)
VALIDATE_STEADY_STEPS = 3


def jax_a1_year1():
    """relN_win of the JAX package's A1 after year 1 (scripts/shmip_validate.py
    on the CPU, cached in scripts/shmip_results.json)."""
    with open(os.path.join(HERE, "scripts", "shmip_results.json")) as f:
        return json.load(f)["A1"]["yearly"][0]["relN_win"]


def phase_validate(dev, cooke2_run):
    """Phase 21: (a) torch_cooke2_report.analyze over phase 18's results
    directory equal to phase 18's own battery (rounded as the report rounds
    it); (b) one year of SHMIP A1 (60 x 12, 4 steps a day, float64) through
    torch_shmip_validate.run_case: every step converged, relN_win within 1 %
    of the JAX package's year 1, bell_spmv launched and no plain operator
    called; (c) torch_cooke2_steady.compute on the committed catchment in
    float64, capped at VALIDATE_STEADY_STEPS PTC steps: finite, on
    bell_spmv likewise."""
    from shakti_tpu_torch.ops import spmv_cuda
    t_phase = time.perf_counter()
    report = script("torch_cooke2_report")
    shmip_v = script("torch_shmip_validate")
    steady = script("torch_cooke2_steady")
    md, rdir, bat18 = cooke2_run
    _, got = report.analyze(rdir, md)
    digits = {"far_field_mean_N_MPa": 4, "far_field_ratio": 4,
              "lake_mean_N_final_MPa": 4, "lake_level_final_m": 3,
              "filling_rate_m_per_yr": 4, "mean_gap_final_mm": 3,
              "max_offlake_flux_final_m2s": 5}
    want = {k: round(bat18[k], d) for k, d in digits.items()}
    want["n_rows"] = bat18["rows"]
    res = {"report": got}
    log("  (a) torch_cooke2_report.analyze on phase 18's run: "
        + json.dumps(got))
    if got != want:
        raise RuntimeError(f"report battery {got} != phase 18's {want}")

    spmv_cuda.reset_launches()
    t0 = time.perf_counter()
    with counted_plain() as plain:
        _, _, _, yearly, q_out, q_src = shmip_v.run_case(
            "A1", 1, device=str(dev))
    wall = sync_s(dev, t0)
    ref = jax_a1_year1()
    a1 = dict(yearly[0], Q_out=q_out, Q_src=q_src,
              launches=dict(spmv_cuda.launches), plain_calls=dict(plain),
              steps=365 * 4, ms_per_step=1e3 * wall / (365 * 4),
              jax_relN_win=ref)
    res["a1"] = a1
    log("  (b) SHMIP A1, 1 year, 60 x 12, float64: " + json.dumps(a1))
    if not (a1["converged"] and a1["launches"]["bell_spmv"] > 0
            and not any(plain.values())
            and abs(a1["relN_win"] - ref) <= 0.01 * ref):
        raise RuntimeError(f"SHMIP A1 year 1: {a1}")

    smd = report.cooke2_model()
    smd.device, smd.dtype = dev, torch.float64
    spmv_cuda.reset_launches()
    t0 = time.perf_counter()
    with counted_plain() as plain:
        st = steady.compute(smd, 1e-3, VALIDATE_STEADY_STEPS, strict=False)
    wall = sync_s(dev, t0)
    st.update(launches=dict(spmv_cuda.launches), plain_calls=dict(plain),
              wall_s=wall)
    res["steady"] = st
    log("  (c) torch_cooke2_steady.compute, "
        f"{VALIDATE_STEADY_STEPS} PTC steps: " + json.dumps(st))
    if not (st["solver"]["steps"] == VALIDATE_STEADY_STEPS
            and all(np.isfinite(st[k]) for k in (
                "far_field_ratio", "lake_mean_N_MPa", "mean_gap_mm",
                "Q_out_m3s", "Q_src_m3s"))
            and st["launches"]["bell_spmv"] > 0 and not any(plain.values())):
        raise RuntimeError(f"steady compute: {st}")
    res["launches"] = (a1["launches"]["bell_spmv"]
                       + st["launches"]["bell_spmv"])
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 21: {res['wall_s']:.1f} s")
    return res


# ---- phase 22: the JAX package's drivers on the port, at cuts ----
# f32 cold starts part from JAX's CPU runs by roundoff amplified in the
# first steps (at these cuts on an H100: ensemble mean N 8.5e-6, lake
# far-field ratio 1.2e-5; up to 8.7e-4 at 12x12)
DRIVER_RTOL = {"float64": 1e-8, "ensemble": 1e-3, "lake": 1e-2,
               "shmip": 1e-6}


class driver_operators:
    """The last operator that each run of phase 22 built, by run: the
    arguments of physics/residual's operator_from_values (one bell_spmv
    launch a matvec) and batched_operator (the member-batched launch),
    recorded while ``run`` names a run, to hold the kernel against its
    plain version at the shapes the drivers gave it."""

    def __init__(self):
        self.run, self.single, self.batched = None, {}, {}

    def __enter__(self):
        from shakti_tpu_torch.physics import residual
        self.mod = residual
        self.real = real_single, real_batched = (residual.operator_from_values,
                                                 residual.batched_operator)

        def single(vals, mesh, dirichlet, extra=None):
            if self.run is not None:
                self.single[self.run] = (vals, mesh, dirichlet, extra)
            return real_single(vals, mesh, dirichlet, extra)

        def batched(vals, J_c, mesh, dirichlet, extra):
            if self.run is not None and vals is not None:
                self.batched[self.run] = (vals, mesh, dirichlet, extra)
            return real_batched(vals, J_c, mesh, dirichlet, extra)
        residual.operator_from_values = single
        residual.batched_operator = batched
        return self

    def __exit__(self, *exc):
        self.mod.operator_from_values, self.mod.batched_operator = self.real

    def check(self, dev, runs, batched_runs):
        """bell_spmv, single and member-batched, against its plain version
        on the last operator of each of ``runs`` and ``batched_runs``, in
        the run's dtype (TOLS: f32 rtol 2e-6, f64 1e-12); raises where such
        a run built no block-ELL operator."""
        rng = np.random.default_rng(22)
        out = {}
        for kind, recs, names, check in (
                ("single", self.single, runs, check_operator),
                ("batched", self.batched, batched_runs, check_batched)):
            for run in names:
                if run not in recs or recs[run][1].bell_nbr is None:
                    raise RuntimeError(f"phase 22 {run}: no block-ELL "
                                       f"operator ({kind})")
                vals, mesh, dirichlet, extra = recs[run]
                vals = vals.detach()
                extra = None if extra is None else extra.detach()
                _, rtol, atol = next(t for t in TOLS if t[0] == vals.dtype)
                shape = ((mesh.n_nodes,) if kind == "single"
                         else (vals.shape[0], mesh.n_nodes))
                x = torch.as_tensor(rng.standard_normal(shape),
                                    dtype=vals.dtype, device=dev)
                r = {"rows": mesh.n_nodes,
                     "dtype": str(vals.dtype).removeprefix("torch.")}
                if kind == "batched":
                    r["M"] = vals.shape[0]
                r["max_abs_err"] = check(
                    f"drivers {run} last operator ({kind})", vals, mesh, x,
                    dirichlet, extra, rtol, atol)
                out.setdefault(kind, {})[run] = r
        return out


def _near(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(b), 1e-300)


def drivers_examples(dev, tmp, ref, cuts, ops):
    """Phase 22 (a): the example twins at ``cuts`` against ``ref``, each
    run's operators recorded in ``ops`` (:class:`driver_operators`)."""
    res, bad = {}, []
    d = str(dev)
    twins = {n: script("torch_" + n, "examples") for n in cuts
             if n not in ("shmip", "so")}
    ops.run = "calibrate_melt"
    t0 = time.perf_counter()
    cal = twins["calibrate_melt"].main(device=d, **cuts["calibrate_melt"])
    r = ref["calibrate_melt"]
    res["calibrate_melt"] = dict(cal, wall_s=sync_s(dev, t0))
    if not (len(cal["rows"]) == len(r["rows"])
            and all(_near(g[k], j[k], DRIVER_RTOL["float64"])
                    for g, j in zip(cal["rows"], r["rows"])
                    for k in ("s", "loss", "grad"))
            and _near(cal["s"], r["s"], DRIVER_RTOL["float64"])):
        bad.append("calibrate_melt")
    # the checkpointed step against the unwrapped one
    ops.run = None
    ck = script("torch_examples_card").checkpoint_compare(
        twins["calibrate_melt"], d, **{k: cuts["calibrate_melt"][k] for k
                                       in ("nx", "ny", "days",
                                           "nt_per_day")})
    res["checkpoint"] = {
        "peak_MB_checkpointed": ck["checkpointed"]["peak_MB"],
        "peak_MB_unwrapped": ck["unwrapped"]["peak_MB"],
        "grad_equal": ck["grad_equal"],
        "recompute_equal": ck["recompute_equal"],
        "counts": ck["checkpointed"]["counts"]}
    if not (ck["grad_equal"] and ck["recompute_equal"]
            and ck["checkpointed"]["counts"]):
        bad.append("checkpoint")

    ops.run = "invert_melt_field"
    t0 = time.perf_counter()
    inv = twins["invert_melt_field"].main(device=d,
                                          **cuts["invert_melt_field"])
    r = ref["invert_melt_field"]
    th, rth = np.asarray(inv.pop("theta")), np.asarray(r["theta"])
    inv.update(wall_s=sync_s(dev, t0),
               theta_err=float(np.abs(th - rth).max() / np.abs(rth).max()))
    res["invert_melt_field"] = inv
    if not (inv["theta_err"] <= DRIVER_RTOL["float64"]
            and _near(inv["err"], r["err"], DRIVER_RTOL["float64"])):
        bad.append("invert_melt_field")

    ops.run = "ensemble_uq"
    t0 = time.perf_counter()
    ens = twins["ensemble_uq"].main(device=d, **cuts["ensemble_uq"])
    r = ref["ensemble_uq"]
    res["ensemble_uq"] = dict(ens, wall_s=sync_s(dev, t0),
                              jax_final_mean_MPa=r["final_mean_MPa"])
    if not (len(ens["rows"]) == len(r["rows"])
            and all(_near(g["mean_N_MPa"], j["mean_N_MPa"],
                          DRIVER_RTOL["ensemble"])
                    for g, j in zip(ens["rows"], r["rows"]))):
        bad.append("ensemble_uq")

    ops.run = "lake_workflow"
    t0 = time.perf_counter()
    lake = twins["lake_workflow"].main(os.path.join(tmp, "lake"), device=d,
                                       **cuts["lake_workflow"])
    r = ref["lake_workflow"]
    res["lake_workflow"] = dict(lake, wall_s=sync_s(dev, t0), jax=r)
    if not (lake["steps"] == r["steps"]
            and all(_near(lake[k], v, DRIVER_RTOL["lake"])
                    for k, v in r.items() if k != "steps")):
        bad.append("lake_workflow")

    ops.run = "basin_pipeline"
    t0 = time.perf_counter()
    bas = twins["basin_pipeline"].main(os.path.join(tmp, "basin"),
                                       device=d, **cuts["basin_pipeline"])
    r = ref["basin_pipeline"]
    res["basin_pipeline"] = dict(bas, wall_s=sync_s(dev, t0), jax=r)
    if not (all(bas[k] == r[k] for k in ("outline_vertices", "nodes",
                                         "triangles", "steps"))
            and bas["finite"]
            and abs(bas["newton_total"] - r["newton_total"]) <= 1):
        bad.append("basin_pipeline")
    return res, bad


def drivers_shmip(dev, ref, cuts, ops):
    """Phase 22 (b): the SHMIP runners at ``cuts`` against ``ref``, each
    run's operators recorded in ``ops``."""
    v = script("torch_shmip_validate")
    d, tol = str(dev), DRIVER_RTOL["shmip"]
    res, bad = {}, []

    def timed(case, steps, fn):
        ops.run = case
        t0 = time.perf_counter()
        out = fn()
        wall = sync_s(dev, t0)
        res[case] = {"wall_s": wall, "steps": steps,
                     "ms_per_step": 1e3 * wall / steps}
        return out

    c = cuts["B5"]
    md, b5, qo, qs, conv = timed("B5", round(365 * c["years"]) * c[
        "nt_per_day"], lambda: v.run_b_case("B5", c["years"], device=d,
                                            nt_per_day=c["nt_per_day"]))
    prof = v.ymean_profile(md, md.to_user_order(b5.N))[1]
    r = ref["B5"]
    res["B5"].update(Q_out=qo, Q_src=qs, converged=conv,
                     ymean_err=float(np.abs(prof - r["ymean_N"]).max()
                                     / np.abs(r["ymean_N"]).max()))
    if not (conv and _near(qo, r["Q_out"], tol) and _near(qs, r["Q_src"], tol)
            and res["B5"]["ymean_err"] <= tol):
        bad.append("B5")
    c = cuts["C1"]
    _, m = timed("C1", c["days"] * c["nt_per_day"],
                 lambda: v.run_c_case("C1", b5, device=d, **c))
    res["C1"].update(m)
    if not (m["converged"] and all(_near(m[k], ref["C1"][k], tol)
                                   for k in ("N_mean_cycle", "N_amp_MPa"))):
        bad.append("C1")
    artesian = []
    for case in ("D5", "F5"):
        c = cuts[case]
        out = timed(case, c["days"] * c["nt_per_day"],
                    lambda: v.run_seasonal_case(
                        case, spin_years=0, device=d,
                        artesian=artesian if case == "D5" else None, **c))
        samples, conv, qo, qs = out[2:]
        r = ref[case]
        res[case].update(samples=samples.tolist(), converged=conv,
                         Q_out=qo, Q_src=qs)
        if not (conv and len(samples) == len(r["samples"])
                and all(_near(a, b, tol)
                        for a, b in zip(samples, r["samples"]))
                and _near(qo, r["Q_out"], tol) and _near(qs, r["Q_src"], tol)):
            bad.append(case)
    # X (the artesian study) from D5's windows: each row's window mean is
    # the sample, JAX's within tol; the fractions and ratios finite
    x = v.artesian_summary(artesian, res["D5"]["converged"], 0,
                           cuts["D5"]["sample_days"])
    res["X_D5"] = {k: x[k] for k in ("days_any_neg", "days_winmean_neg",
                                     "frac_neg_max", "N_min_MPa",
                                     "min_over_pi", "worst_day")}
    if not (len(artesian) == len(ref["D5"]["samples"])
            and [a["day"] for a in artesian]
            == [cuts["D5"]["sample_days"] * (i + 1)
                for i in range(len(artesian))]
            and all(_near(a["winmean_MPa"] * 1e6, b, tol)
                    for a, b in zip(artesian, ref["D5"]["samples"]))
            and all(np.isfinite([a["frac_neg"], a["N_min_MPa"],
                                 a["min_over_pi"]]).all()
                    for a in artesian)):
        bad.append("X_D5")
    c = cuts["E1"]
    md, st, rel, conv, qo, qs = timed(
        "E1", round(365 * c["years"]) * c["nt_per_day"],
        lambda: v.run_e_case("E1", device=d, **c))
    r = ref["E1"]
    res["E1"].update(N_mean_MPa=float(md.to_user_order(st.N).mean() / 1e6),
                     steady_rel=rel, converged=conv, Q_out=qo, Q_src=qs)
    if not (conv and _near(res["E1"]["N_mean_MPa"], r["N_mean_MPa"], tol)
            and _near(qo, r["Q_out"], tol) and _near(qs, r["Q_src"], tol)):
        bad.append("E1")
    return res, bad, (md, st)


# phase 22 (c): suite S's solve_steady capped (tests/torch_examples_ref.py
# SO_CUTS), the stationarity leg's tolerance against the JAX package's
# from its own E1 state (the two E1 states part by DRIVER_RTOL["shmip"];
# the few FV steps carry that over), and O_ladder's against JAX's cached
# row (scipy alone; the card's host may carry another scipy)
SO_STATIONARITY_RTOL, SO_LADDER_RTOL = 1e-5, 1e-8


def drivers_so(dev, ref, cuts, ops, e1):
    """Phase 22 (c): suite S for A2 and A6 at 60 x 12 capped at 3 PTC steps
    and a polish of 2 Newton iterations, in block-ELL, against JAX's row
    at the same cut (verdict and counts equal, the values within
    DRIVER_RTOL["shmip"]); the stationarity leg (scripts/
    torch_valley_stationarity.py) from the E1 state ``e1`` of (b) for a
    few FV steps against JAX's from its own; O_ladder at nx = 200 against
    JAX's cached row (scripts/shmip_results.json)."""
    import functools

    from shakti_tpu_torch.api import steady
    from shakti_tpu_torch.ops import spmv_cuda
    v = script("torch_shmip_validate")
    d, tol, res, bad = str(dev), DRIVER_RTOL["shmip"], {}, []
    c = cuts["S"]
    real_init, real_polish, real_save = (v.shmip.initialize,
                                         steady.steady_polish, v._save_cache)

    def initialize(case, **kw):
        kw.update(c["init"])
        md = real_init(case, **kw)
        solve = md.solve_steady

        def capped(**skw):
            skw.update(c["cap"])
            return solve(**skw)
        md.solve_steady = capped
        return md
    v.shmip.initialize, v._save_cache = initialize, (lambda out: None)
    steady.steady_polish = functools.partial(
        real_polish, max_newton=c["polish_newton"])
    try:
        for case in ("A2", "A6"):
            ops.run = "S_" + case
            t0 = time.perf_counter()
            out = {}
            before = dict(spmv_cuda.launches)
            v.suite_S(out, False, force=True, cases=(case,), device=d)
            # suite_S counts its case's launches from zero: the phase's
            # launches so far go back on top
            for k, n in before.items():
                spmv_cuda.launches[k] += n
            got, r = out["S_" + case], ref["S_" + case]
            res["S_" + case] = {k: got[k] for k in (
                "verdict", "ptc_steps", "newton", "polish_newton",
                "relN_win", "relb_win", "Q_out", "Q_src")}
            res["S_" + case]["wall_s"] = sync_s(dev, t0)
            if not (all(got[k] == r[k] for k in ("verdict", "ptc_steps",
                                                  "polish_newton"))
                    and abs(got["newton"] - r["newton"]) <= 1
                    and all(_near(got[k], r[k], tol) for k in (
                        "relN_win", "relb_win", "Q_out", "Q_src"))):
                bad.append("S_" + case)
    finally:
        v.shmip.initialize, v._save_cache = real_init, real_save
        steady.steady_polish = real_polish
    ops.run = None
    md, st = e1
    tvs = script("torch_valley_stationarity")
    s = cuts["stationarity"]
    t0 = time.perf_counter()
    got = tvs.stationarity(np.stack([md.x, md.y], axis=1),
                           md.to_user_order(st.N), md.to_user_order(st.b),
                           s["nx"], s["ny"], s["years"], verbose=0)
    r = ref["stationarity"]
    keys = ("fem_b_trough_mm", "fv_b_trough_mm_end", "fem_N_trough_MPa",
            "fv_N_trough_MPa_end", "relN_interior", "relb_interior")
    res["stationarity"] = dict({k: got[k] for k in keys + ("steps",)},
                               wall_s=time.perf_counter() - t0)
    if not (got["steps"] == r["steps"]
            and all(_near(got[k], r[k], SO_STATIONARITY_RTOL)
                    for k in keys)):
        bad.append("stationarity")
    t0 = time.perf_counter()
    rows = v.o_ladder_rows(v._fv(), 200)
    with open(os.path.join(HERE, "scripts", "shmip_results.json")) as f:
        jl = json.load(f)["O_ladder"]["rows"]
    res["O_ladder"] = {"wall_s": time.perf_counter() - t0, "max_rel": max(
        abs(rows[a][k] - jl[a][k]) / abs(jl[a][k])
        for a in jl for k in ("relN_fv_1d", "relb_fv_1d"))}
    if not (res["O_ladder"]["max_rel"] <= SO_LADDER_RTOL
            and all(rows[a]["converged"] == jl[a]["converged"]
                    and rows[a]["newton"] == jl[a]["newton"] for a in jl)):
        bad.append("O_ladder")
    return res, bad


def phase_drivers(dev):
    """Phase 22: the example twins and SHMIP's B-F runners at cuts against
    the JAX package's values at the same cuts; every bell_spmv launch
    counted (single and member-batched), none through a plain version; on
    the card the kernel held against its plain version on each run's last
    operator (the batched launch on the ensemble's)."""
    from shakti_tpu_torch.ops import spmv_cuda
    t_phase = time.perf_counter()
    with open(os.path.join(HERE, "tests", "torch_examples_cut_ref.json")) as f:
        ref = json.load(f)
    spmv_cuda.reset_launches()
    with tempfile.TemporaryDirectory() as tmp, counted_plain() as plain, \
            driver_operators() as ops:
        ex, bad = drivers_examples(dev, tmp, ref, ref["cuts"], ops)
        sh, bad_s, e1 = drivers_shmip(dev, ref["shmip"],
                                      ref["cuts"]["shmip"], ops)
        so, bad_o = drivers_so(dev, ref["so"], ref["cuts"]["so"], ops, e1)
    bad_s += bad_o
    res = {"examples": ex, "shmip": sh, "so": so,
           "launches": dict(spmv_cuda.launches), "plain_calls": dict(plain)}
    for k, v in ex.items():
        log(f"  (a) {k}: " + json.dumps({a: b for a, b in v.items()
                                          if a not in ("rows", "counts")}))
    for k, v in sh.items():
        log(f"  (b) SHMIP {k}: " + json.dumps(v))
    for k, v in so.items():
        log(f"  (c) SHMIP {k}: " + json.dumps(v))
    res["launches_drivers"] = (res["launches"]["bell_spmv"]
                               + res["launches"]["bell_spmv_batched"])
    log(f"  launches {json.dumps(res['launches'])}, plain calls "
        f"{json.dumps(res['plain_calls'])}")
    if bad or bad_s:
        raise RuntimeError(f"phase 22: {bad + bad_s} disagree with JAX's")
    if (res["launches"]["bell_spmv"] <= 0
            or res["launches"]["bell_spmv_batched"] <= 0
            or any(plain.values())):
        raise RuntimeError(f"phase 22 launches: {res['launches']}, plain "
                           f"{res['plain_calls']}")
    if dev.type == "cuda":
        # the ensemble's matvecs are all member-batched launches
        res["kernel_check"] = ops.check(
            dev, [k for k in ex if k not in ("checkpoint", "ensemble_uq")]
            + [k for k in sh if k != "X_D5"] + ["S_A2", "S_A6"],
            ["ensemble_uq"])
        log("  bell_spmv on each run's last operator against the plain "
            "version: " + json.dumps(res["kernel_check"]))
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 22: {res['wall_s']:.1f} s")
    return res


# ---- phase 19: the distributed path on torch.distributed ----
# MULTICHIP_r05.json: __graft_entry__.dryrun_multichip(8) on 8 virtual CPU
# devices of the JAX package (float32): Newton and CG of one hourly step of
# the 8 x 8 toy, cell-sharded, halo, halo with block-ELL and mg
DRYRUN_8 = {"cell": (6, 159), "halo": (6, 148), "halo_bell_mg": (6, 48)}
# per-rank wall-clock limit of a world (the process group's own timeout makes
# a rank that waits on a dead peer fail first)
RANK_TIMEOUT_S = 420
# the halo's transport: gloo (and NCCL) take the CUDA tensors themselves for
# every collective the port uses, so nothing is staged through the host
TRANSPORT = "device"


class collective_clock:
    """The host time this rank spends inside torch.distributed's collectives
    (all_reduce, all_gather, all_to_all_single: the ones the port calls),
    and their count.  The card is synchronized before each, so the rank's
    queued work counts as compute; what remains is the transfer and the wait
    for the other ranks."""

    NAMES = ("all_reduce", "all_gather", "all_to_all_single")

    def __init__(self, dev):
        self.dev, self.s, self.n = dev, 0.0, 0

    def __enter__(self):
        import torch.distributed as dist
        self.real = {k: getattr(dist, k) for k in self.NAMES}

        def timed(fn):
            def call(*a, **k):
                torch.cuda.synchronize(self.dev)
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self.s += time.perf_counter() - t0
                self.n += 1
                return out
            return call
        for k, fn in self.real.items():
            setattr(dist, k, timed(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for k, fn in self.real.items():
            setattr(dist, k, fn)

    def read(self, wall):
        return dict(collectives=self.n, collective_s=self.s, wall_s=wall,
                    collective_share=self.s / wall)


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_world(task, world, tmp):
    """Start ``world`` ranks of chip_smoke.py --dist-rank <task> (gloo,
    file:// init), each writing its results under <tmp>/<task>/."""
    out = os.path.join(tmp, task)
    os.makedirs(out, exist_ok=True)
    init = os.path.join(out, "init")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--dist-rank",
         task, str(r), str(world), init, out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return task, world, out, procs, time.perf_counter()


def _finish_world(handle):
    """Wait for a world; raise (with the rank's output) if any rank failed
    or outlived RANK_TIMEOUT_S.  Returns (per-rank results, wall s)."""
    task, world, out, procs, t0 = handle
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(RANK_TIMEOUT_S - (time.perf_counter() - t0), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"dist {task}: a rank outlived "
                               f"{RANK_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    for r, (p, lg) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"dist {task}: rank {r} exited {p.returncode}"
                               f":\n{lg[-6000:]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, wall


class last_operator:
    """Records the arguments of the last call of ops/spmv_cuda's operator
    builder ``name`` (the per-rank operator of a distributed Newton
    iteration), to hold the kernel against its plain version on it."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from shakti_tpu_torch.ops import spmv_cuda
        self.mod, self.real, self.args = spmv_cuda, getattr(spmv_cuda,
                                                            self.name), None

        def spy(*a, **k):
            self.args = a
            return self.real(*a, **k)
        setattr(spmv_cuda, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def _rank_run(md, dev, rank, out, tag, kernel):
    """One distributed run of ``md`` (4 steps) on this rank: counts,
    launches (none through a plain version), L/omax, peak memory, time;
    rank 0 saves N and b in user order and holds ``kernel`` against its
    plain version on its last operator."""
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.parallel import dist as pdist
    from shakti_tpu_torch.solve.timestep import timestep_sizes
    md.distributed = True
    torch.cuda.reset_peak_memory_stats(dev)
    runner, st0, plan = pdist.make_distributed_runner(md, device=dev)
    dts = timestep_sizes(md.timesteps, dtype=md.dtype, device=dev)
    builder = "bell_operator_fn" if kernel == "bell_spmv" else "ell_operator_fn"
    spmv_cuda.reset_launches()
    with counted_plain() as plain, last_operator(builder) as last, \
            collective_clock(dev) as clock:
        t0 = time.perf_counter()
        s, d = runner(st0, dts)
        wall = sync_s(dev, t0)
    launches = dict(spmv_cuda.launches)
    g = pdist.gather_state(plan, s)
    mesh = plan["mesh"]
    r = dict(newton=d["newton_iters"].tolist(), cg=d["cg_iters"].tolist(),
             rnorm=[float(v) for v in d["rnorm"]],
             converged=bool(d["converged"].all()), L=plan["L"],
             omax=plan["omax"], format=plan["format"],
             precond=plan["cfg"].precond, launches=launches,
             plain_calls=dict(plain), ms_per_step=1e3 * wall / len(dts),
             peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             profile=clock.read(wall))
    if rank == 0:
        np.save(os.path.join(out, f"{tag}_N.npy"), md.to_user_order(g.N))
        np.save(os.path.join(out, f"{tag}_b.npy"), md.to_user_order(g.b))
        vals, lmesh, dirichlet = last.args[:3]
        rng = np.random.default_rng(19)
        x = torch.as_tensor(rng.standard_normal(lmesh.n_nodes), device=dev,
                            dtype=vals.dtype)
        extra = torch.as_tensor(rng.random(lmesh.n_nodes)
                                * ~dirichlet.cpu().numpy(), device=dev,
                                dtype=vals.dtype)
        _, rtol, atol = next(t for t in TOLS if t[0] == vals.dtype)
        r["kernel_check"] = {
            "rows": lmesh.n_nodes, "rows_without_entries": int(
                ((lmesh.bell_nz_pos if kernel == "bell_spmv"
                  else lmesh.nz_pos) >= 0).sum(0).eq(0).sum()),
            **{part: check_operator(
                f"dist rank 0 {tag} {kernel} {part}", vals, lmesh, x,
                dirichlet if part == "epilogue" else None,
                extra if part == "epilogue" else None, rtol, atol, kernel)
               for part in ("product", "epilogue")}}
    return r


def _dist_bench(dev, rank, world, out):
    """(a) the bench model, float64, 4 steps: the global two-level in
    block-ELL, then mg in block-CSR; (b) 48 float32 steps through
    api/run.solve into <out>/run, then 25 steps and --resume to 48."""
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.setups import setup_bench
    # a coarse cap above the mesh: no hierarchy, so the ranks keep the
    # global two-level (with a hierarchy that has levels they take mg)
    res = {"two_level": _rank_run(bench_f64(dev, mg_coarse_cap=1 << 15), dev,
                                  rank, out, "two_level", "bell_spmv"),
           "mg": _rank_run(bench_f64(dev, "bcsr", precond="mg"), dev, rank,
                           out, "mg", "ell_spmv")}

    def bench32(name, steps=None):
        md = setup_bench.initialize(days=2,
                                    results_name=os.path.join(out, name))
        md.device, md.distributed = dev, True
        if steps:
            md.timesteps = md.timesteps[:steps]
        return md

    spmv_cuda.reset_launches()
    with counted_plain() as plain, collective_clock(dev) as clock:
        t0 = time.perf_counter()
        o = bench32("run").solve(progress=False)
        wall = sync_s(dev, t0)
    res["run"] = dict(steps=o["steps"], newton=o["newton_iters_total"],
                      cg=o["cg_iters_total"], launches=dict(spmv_cuda.launches),
                      plain_calls=dict(plain), ms_per_step=1e3 * wall / 48,
                      profile=clock.read(wall),
                      history_none=o["history"] is None,
                      finite=bool(torch.isfinite(o["state"].N).all()))
    bench32("resume", 25).solve(progress=False)
    o = bench32("resume").solve(resume=True, progress=False)
    res["resume"] = dict(steps=o["steps"])
    return res


def _dist_toy(dev, rank, world, out):
    """(c) __graft_entry__.dryrun_multichip's 8 x 8 toy, one hourly step:
    cell-sharded, halo, halo with block-ELL and mg."""
    import dataclasses

    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.parallel import dist as pdist
    from shakti_tpu_torch.parallel.shard import make_parallel_step_fn
    from shakti_tpu_torch.setups import setup_slab
    from shakti_tpu_torch.solve.newton import NewtonConfig

    def build():
        md = setup_slab.initialize(nx=8, ny=8, days=2.0, nt_per_day=4)
        md.solver = NewtonConfig(adaptive_dt_levels=0, lag_operator=False)
        md.device = dev
        return md

    def counts(d, state, launches):
        return dict(newton=int(np.sum(d["newton_iters"])),
                    cg=int(np.sum(d["cg_iters"])),
                    converged=bool(np.all(d["converged"])),
                    finite=bool(torch.isfinite(state.N).all()),
                    launches=launches)

    res = {}
    md = build()
    mesh, static, state, cfg = md.freeze()
    step = make_parallel_step_fn(mesh, static, md.params, cfg)
    s, d = step(state, torch.tensor(3600.0, dtype=md.dtype, device=dev))
    res["cell"] = counts(d, s, {})
    for tag, op, solver in (("halo", "auto", {}),
                            ("halo_bell_mg", "bell",
                             dict(precond="mg", mg_agg=4, mg_coarse_cap=16))):
        md = build()
        md.operator = op
        md.solver = dataclasses.replace(md.solver, **solver)
        md.distributed = True
        runner, st0, plan = pdist.make_distributed_runner(md, device=dev)
        spmv_cuda.reset_launches()
        s, d = runner(st0, torch.full((1,), 3600.0, dtype=md.dtype,
                                      device=dev))
        res[tag] = counts(d, s, dict(spmv_cuda.launches))
        res[tag].update(format=plan["format"], precond=plan["cfg"].precond,
                        L=plan["L"])
    return res


def _dist_steady(dev, rank, world, out):
    """(d) the 16 x 16 slab in float64 through solve_steady on the ranks
    (make_distributed_steady_runner)."""
    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.setups import setup_slab
    md = setup_slab.initialize(nx=16, ny=16)
    md.device, md.dtype, md.distributed = dev, torch.float64, True
    spmv_cuda.reset_launches()
    with collective_clock(dev) as clock:
        t0 = time.perf_counter()
        o = md.solve_steady(tol=2e-2)
        wall = sync_s(dev, t0)
    if rank == 0:
        np.save(os.path.join(out, "N.npy"), o["N"])
        np.save(os.path.join(out, "b.npy"), o["b"])
    info = o["info"]
    return dict(verdict=info["verdict"], steps=info["steps"],
                newton=info["newton_total"], cg=info["cg_total"],
                rate=info["rate"], wall_s=wall, profile=clock.read(wall),
                launches=dict(spmv_cuda.launches))


# ---- phase 20: the distributed adjoint ----
DIST_ADJ_STEPS = 3
DIST_ADJ_GRAD_RTOL = 1e-6     # against phase 16's single-device adjoint
DIST_ADJ_FD_RTOL = 2e-5       # the scalar gradient against its FD
DIST_ADJ_DIR_RTOL = 1e-4      # the field's directional derivative, FD


def _dist_adjoint(dev, rank, world, out):
    """Phase 20 on one rank: phase 16's model for DIST_ADJ_STEPS hourly
    steps through make_distributed_runner(control="inputs"), the rank's
    partial mean(N) differentiated with respect to inputs_scale and the
    localized inputs field at once; the forward against
    differentiable=False, central differences of the distributed forward,
    the backward's launches (none through a plain version), times,
    collectives and peak memory; rank 0 holds bell_spmv against its plain
    version on its last transposed operator."""
    import dataclasses

    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.parallel import dist as pdist
    from shakti_tpu_torch.solve import krylov
    from shakti_tpu_torch.solve.timestep import timestep_sizes

    def build(differentiable, control=None):
        md = adjoint_bench(dev)
        md.solver = dataclasses.replace(md.solver,
                                        differentiable=differentiable)
        md.distributed = True
        return (md, *pdist.make_distributed_runner(md, device=dev,
                                                    control=control))

    md, runner0, st00, _ = build(False)
    n = md.x.size
    dts = timestep_sizes(md.timesteps, md.dtype, dev)[1:DIST_ADJ_STEPS + 1]
    one = torch.tensor(1.0, dtype=md.dtype, device=dev)
    t0 = time.perf_counter()
    plain, _ = runner0(st00, adjoint_forcing(dts, one))
    t_plain = sync_s(dev, t0)
    md, runner, st0, plan = build(True, "inputs")
    halo = plan["mesh"].halo
    own = halo.owned_mask
    base = md.freeze("cpu", distributed=True)[1].inputs.to(dev)
    s = one.clone().requires_grad_(True)
    f = base.clone().requires_grad_(True)
    torch.cuda.reset_peak_memory_stats(dev)
    with collective_clock(dev) as c_fwd:
        t0 = time.perf_counter()
        o, d = runner(pdist.localize(plan, f), st0, adjoint_forcing(dts, s))
        part = (o.N * own).sum() / n
        t_fwd = sync_s(dev, t0)
    same = {k: bitwise_equal(getattr(o, k), getattr(plain, k))
            for k in ("N", "b", "q", "melt")}
    cg, real_cg = [], krylov.SOLVERS["cg"]

    def cg_spy(*a, **k):
        x, info = real_cg(*a, **k)
        cg.append(info["iters"])
        return x, info

    spmv_cuda.reset_launches()
    krylov.SOLVERS["cg"] = cg_spy
    try:
        with counted_plain() as plain_calls, \
                last_operator("bell_operator_fn") as last, \
                collective_clock(dev) as c_bwd:
            t0 = time.perf_counter()
            part.backward()
            t_bwd = sync_s(dev, t0)
    finally:
        krylov.SOLVERS["cg"] = real_cg
    launches = dict(spmv_cuda.launches)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    g_s = halo.allsum(s.grad)
    g_f = halo.allsum(f.grad)
    v = torch.as_tensor(np.random.default_rng(7).normal(size=n),
                        dtype=md.dtype, device=dev)
    v = v / torch.linalg.vector_norm(v)

    def loss(sv, field):
        with torch.no_grad():
            o_, _ = runner(pdist.localize(plan, field), st0,
                           adjoint_forcing(dts, one * sv))
            return halo.allsum((o_.N * own).sum() / n).item()

    h = 1e-5
    fd_s = (loss(1 + h, base) - loss(1 - h, base)) / (2 * h)
    hf = 1e-6 * float(torch.linalg.vector_norm(base))
    fd_f = (loss(1.0, base + hf * v) - loss(1.0, base - hf * v)) / (2 * hf)
    r = dict(forward_equal=same, newton=d["newton_iters"].tolist(),
             cg=d["cg_iters"].tolist(), adjoint_cg=cg, L=plan["L"],
             omax=plan["omax"], format=plan["format"],
             precond=plan["cfg"].precond, loss=part.item(),
             grad_scale=g_s.item(), grad_scale_rank=s.grad.item(),
             fd_scale=fd_s, grad_dir=float(torch.dot(g_f, v)), fd_dir=fd_f,
             launches_backward=launches, plain_calls_backward=dict(plain_calls),
             plain_forward_s=t_plain, forward_s=t_fwd, backward_s=t_bwd,
             profile_forward=c_fwd.read(t_fwd),
             profile_backward=c_bwd.read(t_bwd), peak_gb=peak)
    if rank == 0:
        vals, lmesh, dirichlet = last.args[:3]
        rng = np.random.default_rng(20)
        x = torch.as_tensor(rng.standard_normal(lmesh.n_nodes), device=dev,
                            dtype=vals.dtype)
        extra = torch.as_tensor(rng.random(lmesh.n_nodes)
                                * ~dirichlet.cpu().numpy(), device=dev,
                                dtype=vals.dtype)
        _, rtol, atol = next(t for t in TOLS if t[0] == vals.dtype)
        r["kernel_check"] = {
            "rows": lmesh.n_nodes,
            "product": check_operator(
                "dist adjoint rank 0 A^T product", vals, lmesh, x, None,
                None, rtol, atol, "bell_spmv"),
            "epilogue": check_operator(
                "dist adjoint rank 0 A^T epilogue", vals, lmesh, x,
                dirichlet, extra, rtol, atol, "bell_spmv")}
    return r


DIST_TASKS = {"bench": _dist_bench, "toy": _dist_toy, "steady": _dist_steady,
              "adjoint": _dist_adjoint}


def dist_rank(task, rank, world, init, out):
    """One rank of phase 19 (chip_smoke.py --dist-rank ...): joins the gloo
    world on the card, runs ``task`` and writes <out>/rank<r>.json."""
    import datetime

    import torch.distributed as dist
    torch.set_num_threads(1)
    from shakti_tpu_torch.utils.backend import resolve_device
    dev = resolve_device("cuda:0")
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)      # the context, before the memory stats
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    res = DIST_TASKS[task](dev, rank, world, out)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _world_size_1(dev):
    """(e) the bench model for 4 float64 steps on a world of one rank, under
    NCCL on cuda:0 and under gloo: the same code, bitwise the same result."""
    import datetime

    import torch.distributed as dist

    from shakti_tpu_torch.ops import spmv_cuda
    from shakti_tpu_torch.parallel import dist as pdist
    from shakti_tpu_torch.solve.timestep import timestep_sizes
    res, st = {}, {}
    for backend in ("nccl", "gloo"):
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120), **kw)
        try:
            md = bench_f64(dev)
            md.distributed = True
            runner, st0, plan = pdist.make_distributed_runner(md, device=dev)
            spmv_cuda.reset_launches()
            s, d = runner(st0, timestep_sizes(md.timesteps, dtype=md.dtype,
                                              device=dev))
            st[backend] = pdist.gather_state(plan, s)
            res[backend] = dict(newton=int(d["newton_iters"].sum()),
                                cg=int(d["cg_iters"].sum()),
                                launches=dict(spmv_cuda.launches))
        finally:
            dist.destroy_process_group()
    res["bitwise_equal"] = {k: bitwise_equal(getattr(st["nccl"], k),
                                             getattr(st["gloo"], k))
                            for k in ("N", "b", "q", "melt")}
    return res


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


# (b)'s row 0: the ranks' f32 distance from float64 over the single-device
# f32 run's, at most (read 1.02 / 1.14 / 1.08 / 1.46 for N / b / qx / qy
# on an H100; both runs 0.25 of scale from float64 in N)
ROW0_F64_FACTOR = 2.0


def phase_dist(dev, tmp, ref=None, mg13=None, main_dir=None, slab=None):
    """Phase 19: the distributed path (parallel/dist.py, halo.py, shard.py,
    api/run.py and api/steady.py on torch.distributed), gloo ranks
    time-sliced on the one card: (a) and (b) on 4 ranks, (c) on 8, (d) on
    2, (e) in this process.  ``ref``: phase 9's bell two-level N and b in
    user order (phase 13 (a) holds its mg runs against the same);
    ``mg13``: phase 13 (a)'s block-CSR mg counts, printed beside; ``main_dir``
    phase 5's results; ``slab`` phase 14's (md, state, PTC steps).  Newton
    counts are held against single-device runs with the ranks' settings
    (no operator carry), made here.  After the single-device references
    the bench and steady worlds run side by side (six host-bound ranks on
    the host's cores), then the toy's eight ranks alone."""
    import dataclasses

    from shakti_tpu_torch.api.steady import solve_steady
    from shakti_tpu_torch.setups import setup_bench, setup_slab
    t_phase = time.perf_counter()
    res = {"card": nvidia_smi_line()}
    # the single-device references the ranks are held against
    single = {}
    for tag, md in (("two_level", bench_f64(dev, lag_operator=False)),
                    ("mg", bench_f64(dev, "bcsr", precond="mg"))):
        out, _ = run_counted(md)
        single[tag] = dict(newton=out["newton_iters_total"],
                           cg=out["cg_iters_total"],
                           N=md.to_user_order(out["state"].N),
                           b=md.to_user_order(out["state"].b))
    # (b)'s reference: 48 f32 steps single-device with the ranks' solver
    # settings (the global aggregates of 16 nodes as the two-level's, no
    # operator carry)
    md = setup_bench.initialize(days=2)
    md.device = dev
    md.solver = dataclasses.replace(md.solver, coarse_block=16,
                                    lag_operator=False)
    out = md.solve(progress=False)
    single32 = dict(newton=out["newton_iters_total"], cg=out["cg_iters_total"],
                    **out["history"])
    # the same settings in float64 for 25 steps: both of (b)'s save rows
    md = setup_bench.initialize(days=2)
    md.device, md.dtype = dev, torch.float64
    md.timesteps = md.timesteps[:25]
    md.solver = dataclasses.replace(md.solver, coarse_block=16,
                                    lag_operator=False)
    single64 = md.solve(progress=False)["history"]
    if slab is None:
        md = setup_slab.initialize(nx=16, ny=16)
        md.device, md.dtype = dev, torch.float64
        o = solve_steady(md, tol=2e-2)
        slab_N, slab_steps = o["N"], o["info"]["steps"]
    else:
        slab_N, slab_steps = slab[0].to_user_order(slab[1].N), slab[2]
    # the bench and steady worlds side by side (each rank's times include
    # the other world's share of the card), then the toy alone
    handles = [_spawn_world("bench", 4, tmp), _spawn_world("steady", 2, tmp)]
    bench, res["bench_wall_s"] = _finish_world(handles[0])
    steady, res["steady_wall_s"] = _finish_world(handles[1])
    toy, res["toy_wall_s"] = _finish_world(_spawn_world("toy", 8, tmp))
    log("  worlds' wall s (bench beside steady, then toy): " + json.dumps(
        {k: res[f"{k}_wall_s"] for k in ("bench", "toy", "steady")}))

    # ---- (a) the bench model, f64, 4 ranks ----
    out4 = os.path.join(tmp, "bench")
    for tag in ("two_level", "mg"):
        ranks = [r[tag] for r in bench]
        for r in ranks[1:]:
            for k in ("newton", "cg", "rnorm"):
                if r[k] != ranks[0][k]:
                    raise RuntimeError(f"(a) {tag}: the ranks' {k} differ")
        r0, sg = ranks[0], single[tag]
        kern = "bell_spmv" if tag == "two_level" else "ell_spmv"
        a = dict(newton=sum(r0["newton"]), cg=sum(r0["cg"]),
                 single_newton=sg["newton"], single_cg=sg["cg"],
                 precond=r0["precond"], format=r0["format"],
                 transport=TRANSPORT, ms_per_step=r0["ms_per_step"],
                 per_rank=[dict(rank=i, launches=r["launches"][kern],
                                plain_calls=sum(r["plain_calls"].values()),
                                L=r["L"], omax=r["omax"],
                                peak_gb=r["peak_gb"], profile=r["profile"])
                           for i, r in enumerate(ranks)],
                 kernel_check=r0["kernel_check"])
        if tag == "mg" and mg13 is not None:
            a["phase13_newton"], a["phase13_cg"] = mg13["newton"], mg13["cg"]
        for k in ("N", "b"):
            got = np.load(os.path.join(out4, f"{tag}_{k}.npy"))
            a[f"err_{k}_single"] = _rel(got, sg[k])
            if ref is not None:
                a[f"err_{k}_phase9"] = _rel(got, ref[k])
        log(f"  (a) bench f64 {tag}: " + json.dumps(a))
        errs = [v for k, v in a.items() if k.startswith("err_")]
        if (not r0["converged"] or max(errs) > 1e-7
                or a["newton"] != sg["newton"]
                or min(p["launches"] for p in a["per_rank"]) <= 0
                or max(p["plain_calls"] for p in a["per_rank"]) > 0):
            raise RuntimeError(f"(a) bench {tag} on 4 ranks: {a}")
        res[f"a_{tag}"] = a

    # ---- (b) api/run.solve, f32, 48 steps, and a resume at 25 ----
    b = dict(bench[0]["run"], resume_steps=bench[0]["resume"]["steps"],
             history_none=[r["run"]["history_none"] for r in bench],
             launches_per_rank=[r["run"]["launches"]["bell_spmv"]
                                for r in bench],
             single_newton=single32["newton"], single_cg=single32["cg"],
             profile_per_rank=[r["run"]["profile"] for r in bench])
    for k in ("N", "b", "qx", "qy"):
        got = np.load(os.path.join(out4, "run", f"{k}.npy"))
        rows = range(got.shape[0])
        b[f"err_{k}_single_rows"] = [_rel(got[i], single32[k][i])
                                     for i in rows]
        # every f32 run's distance per row from the float64 run with the
        # ranks' settings: the spread f32 itself leaves
        f32 = {"dist": got, "single": single32[k]}
        if main_dir is not None:
            f32["phase5"] = np.load(os.path.join(main_dir, f"{k}.npy"))
            b[f"err_{k}_phase5_rows"] = [_rel(got[i], f32["phase5"][i])
                                         for i in rows]
            b[f"err_{k}_single_vs_phase5_rows"] = [
                _rel(single32[k][i], f32["phase5"][i]) for i in rows]
        b[f"err_{k}_f64_rows"] = {
            tag: [_rel(h[i], single64[k][i]) for i in rows]
            for tag, h in f32.items()}
        b[f"resume_equal_{k}"] = bool(np.array_equal(got, np.load(
            os.path.join(out4, "resume", f"{k}.npy"))))
    ca = np.load(os.path.join(out4, "run", "checkpoint.npz"))
    cb = np.load(os.path.join(out4, "resume", "checkpoint.npz"))
    b["resume_equal_state"] = all(np.array_equal(ca[k], cb[k])
                                  for k in ("N", "b", "q", "melt"))
    # the rows after the first against the single-device f32 run; row 0
    # (after the cold start's dt/10 step) leaves every f32 run ~25 % of
    # scale (N) from float64, each in its own direction: there the ranks
    # must be no farther from float64 than ROW0_F64_FACTOR times the
    # single-device f32 run is
    errs = [v for k in ("N", "b", "qx", "qy")
            for v in b[f"err_{k}_single_rows"][1:]]
    row0 = {k: b[f"err_{k}_f64_rows"]["dist"][0]
            / b[f"err_{k}_f64_rows"]["single"][0]
            for k in ("N", "b", "qx", "qy")}
    b["row0_f64_ratio"] = row0
    log("  (b) bench f32 through api/run.solve on 4 ranks: " + json.dumps(b))
    if (b["steps"] != 48 or not b["finite"] or b["resume_steps"] != 23
            or b["history_none"] != [False, True, True, True]
            or not all(v for k, v in b.items() if k.startswith("resume_eq"))
            or max(errs) > 1e-4 or max(row0.values()) > ROW0_F64_FACTOR
            or min(b["launches_per_rank"]) <= 0
            or sum(b["plain_calls"].values()) > 0):
        raise RuntimeError(f"(b) api/run.solve on 4 ranks: {b}")
    res["b_run"] = b

    # ---- (c) the 8 x 8 toy on 8 ranks ----
    c = {}
    for tag, (newton, cg) in DRYRUN_8.items():
        rs = [r[tag] for r in toy]
        if any((r["newton"], r["cg"]) != (rs[0]["newton"], rs[0]["cg"])
               for r in rs):
            raise RuntimeError(f"(c) {tag}: the ranks' counts differ")
        c[tag] = dict(rs[0], multichip_r05=dict(newton=newton, cg=cg))
        if (not rs[0]["converged"] or not rs[0]["finite"]
                or rs[0]["newton"] != newton):
            raise RuntimeError(f"(c) {tag}: {c[tag]}")
    if min(r["halo_bell_mg"]["launches"]["bell_spmv"] for r in toy) <= 0:
        raise RuntimeError("(c) halo_bell_mg: a rank never launched bell_spmv")
    log("  (c) 8 x 8 toy on 8 ranks (CG reported, not gated): "
        + json.dumps(c))
    res["c_toy"] = c

    # ---- (d) the 16 x 16 slab steady state on 2 ranks ----
    d = dict(steady[0], single_steps=slab_steps)
    d["err_N"] = _rel(np.load(os.path.join(tmp, "steady", "N.npy")), slab_N)
    log("  (d) slab 16 x 16 steady on 2 ranks: " + json.dumps(d))
    if (steady[1]["steps"] != d["steps"] or d["verdict"] != "steady"
            or d["steps"] != slab_steps or d["err_N"] > 1e-8):
        raise RuntimeError(f"(d) steady on 2 ranks: {d}")
    res["d_steady"] = d

    # ---- (e) world size 1: NCCL against gloo ----
    e = _world_size_1(dev)
    log("  (e) world size 1, NCCL vs gloo: " + json.dumps(e))
    if not all(e["bitwise_equal"].values()):
        raise RuntimeError(f"(e) NCCL and gloo differ at world size 1: {e}")
    res["e_world1"] = e
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 19: {res['wall_s']:.1f} s (P ranks time-sliced on one "
        f"{res['card']})")
    return res


def phase_dist_adjoint(dev, tmp):
    """Phase 20: the distributed adjoint on 2 gloo ranks (_dist_adjoint)
    against phase 16's single-device adjoint on the same model and steps:
    (a) every rank's forward bitwise equal to differentiable=False; (b) the
    rank-summed d mean(N)/d inputs_scale within DIST_ADJ_GRAD_RTOL of the
    single-device gradient and DIST_ADJ_FD_RTOL of a central difference,
    the same on every rank; (c) the inputs field's directional derivative
    within DIST_ADJ_DIR_RTOL of its central difference; (d) bell_spmv on
    rank 0's last transposed operator within phase 3's tolerances; (e)
    per rank the backward's launches (none through a plain version),
    backward and forward wall time, the collectives' share, peak memory."""
    from shakti_tpu_torch.solve import timestep as ts
    t_phase = time.perf_counter()
    md = adjoint_bench(dev)
    mesh, static, state, cfg = md.freeze()
    dts = ts.timestep_sizes(md.timesteps, md.dtype, dev)[1:DIST_ADJ_STEPS + 1]
    s = torch.tensor(1.0, dtype=md.dtype, device=dev, requires_grad=True)
    t0 = time.perf_counter()
    o, _ = ts.run_window(ts.make_step_fn(mesh, static, md.params, cfg), state,
                         adjoint_forcing(dts, s))
    o.N.mean().backward()
    single = dict(grad_scale=s.grad.item(), s=sync_s(dev, t0))
    del mesh, static, state, o
    ranks, wall = _finish_world(_spawn_world("adjoint", 2, tmp))
    r0 = ranks[0]
    g = r0["grad_scale"]
    res = dict(
        card=nvidia_smi_line(), wall_s=wall, single=single,
        forward_equal=[r["forward_equal"] for r in ranks],
        grad_scale=g, fd_scale=r0["fd_scale"],
        rel_single=abs(g - single["grad_scale"]) / abs(single["grad_scale"]),
        rel_fd=abs(g - r0["fd_scale"]) / abs(r0["fd_scale"]),
        grad_dir=r0["grad_dir"], fd_dir=r0["fd_dir"],
        rel_dir=abs(r0["grad_dir"] - r0["fd_dir"]) / abs(r0["fd_dir"]),
        newton=r0["newton"], cg=r0["cg"], adjoint_cg=r0["adjoint_cg"],
        precond=r0["precond"], format=r0["format"],
        kernel_check=r0["kernel_check"],
        per_rank=[dict(rank=i, L=r["L"], omax=r["omax"],
                       grad_scale_rank=r["grad_scale_rank"],
                       launches_backward=r["launches_backward"],
                       plain_calls_backward=sum(
                           r["plain_calls_backward"].values()),
                       plain_forward_s=r["plain_forward_s"],
                       forward_s=r["forward_s"], backward_s=r["backward_s"],
                       backward_over_forward=r["backward_s"] / r["forward_s"],
                       collective_share_forward=r["profile_forward"][
                           "collective_share"],
                       collective_share_backward=r["profile_backward"][
                           "collective_share"],
                       profile_forward=r["profile_forward"],
                       profile_backward=r["profile_backward"],
                       peak_gb=r["peak_gb"])
                  for i, r in enumerate(ranks)])
    log("  (a)-(e) dist adjoint on 2 ranks: " + json.dumps(res))
    bad = []
    if not all(all(fe.values()) for fe in res["forward_equal"]):
        bad.append("(a) differentiable=True changed the forward")
    if any(r[k] != r0[k] for r in ranks[1:]
           for k in ("grad_scale", "grad_dir", "newton", "cg", "adjoint_cg")):
        bad.append("the ranks' gradients or counts differ")
    if res["rel_single"] > DIST_ADJ_GRAD_RTOL or res["rel_fd"] > DIST_ADJ_FD_RTOL:
        bad.append("(b) the scalar gradient")
    if res["rel_dir"] > DIST_ADJ_DIR_RTOL or r0["fd_dir"] == 0.0:
        bad.append("(c) the field's directional derivative")
    if any(p["launches_backward"]["bell_spmv"] <= 0
           or p["plain_calls_backward"] > 0 for p in res["per_rank"]):
        bad.append("(e) a backward matvec not through bell_spmv")
    if bad:
        raise RuntimeError(f"phase 20: {bad}: {res}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 20: {res['phase_s']:.1f} s (2 ranks time-sliced on one "
        f"{res['card']})")
    return res


# the kernels line: "ms", "plain_ms" and "library_ms" are times per call
# between CUDA events (host work included), as "ms" has been since the first
# kernel; the *_device_ms are torch.profiler's device times
LINE_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "plain_device_ms",
             "library_ms", "library_device_ms", "bound_ms", "host_us",
             "host_us_composed")
ELL_LINE_KEYS = tuple(k for k in LINE_KEYS if k != "host_us_composed")
BATCHED_LINE_KEYS = ("M", "max_abs_err", "ms", "device_ms", "singles_ms",
                     "singles_device_ms", "plain_ms", "plain_device_ms",
                     "library_ms", "library_device_ms", "bound_ms")


PHASES = ("kernel", "goldens", "main", "ell", "scale", "formats", "resume",
          "bootstrap", "bicgstab", "mg", "steady", "polish", "dist", "adjoint",
          "ensemble", "cooke2", "dist_adjoint", "validate", "drivers",
          "element", "coarse")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dist-rank"]:
        # a rank of phase 19, started by phase_dist
        task, rank, world, init, out = argv[1:6]
        return dist_rank(task, int(rank), int(world), init, out)
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (resume needs main, bicgstab needs formats, scale "
                    "needs ell, mg needs scale and formats, validate needs "
                    "cooke2); the result lines "
                    "need all of them")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        raise SystemExit(f"unknown phases {set(phases) - set(PHASES)}")
    t_start = time.perf_counter()
    # ---- 1. the card ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs an NVIDIA GPU")
    from shakti_tpu_torch.utils.backend import resolve_device
    dev = resolve_device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")

    # ---- 2. build: one nvcc per source, started together ----
    from shakti_tpu_torch.ops import element_cuda  # noqa: F401 (registers)
    from shakti_tpu_torch.ops import spmv_cuda
    t0 = time.perf_counter()
    infos = spmv_cuda.build_all(*spmv_cuda.LIBRARIES)
    log(f"[build] {time.perf_counter() - t0:.2f} s for {len(infos)} "
        "libraries")
    for name, info in infos.items():
        log(f"  {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"    {line.strip()}")

    def stamp(name):
        log(f"[{name}] (t = {time.perf_counter() - t_start:.1f} s)")

    kres = mres = sres = eres = gres = stres = pres = slab = None
    ares = enres = cres = dres = fres = xres = vres = ref = main_dir = None
    wres = elres = cores = None
    # ---- 3. bell_spmv vs plain at the bench shapes ----
    from shakti_tpu_torch.setups import setup_bench
    if "kernel" in phases:
        stamp("kernel")
        md = setup_bench.initialize(days=2)
        mesh, static = md.freeze(dev)[:2]
        NB, KB = mesh.bell_nbr.shape
        W = mesh.bell_nz_pos.shape[0]
        log(f"  bench operator: n={mesh.n_nodes} NB={NB} KB={KB} "
            f"B={mesh.bell_B}; structural view W={W}, "
            f"{int((mesh.bell_nz_pos >= 0).sum())} nonzeros")
        if (NB, KB, mesh.bell_B, mesh.n_nodes, W) != (96, 11, 128, 12270, 10):
            raise RuntimeError("bench operator shape changed")
        kres = phase_kernel(dev, mesh, static.dirichlet)
        kres["W"] = W
        del mesh, static, md

    # ---- 4. goldens on the card ----
    if "goldens" in phases:
        stamp("goldens: float64 on the card")
        phase_goldens(dev)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 5, 6. main path at full size, then its profile ----
        if "main" in phases:
            stamp("main: bench model, 2 days of hourly steps, float32")
            torch.cuda.reset_peak_memory_stats(dev)
            mres, md, state, main_dir = phase_main(dev, tmp)
            stamp("profile: one more steady day of the main path")
            phase_profile(dev, md, state)
            del md, state

        # ---- 7. ell_spmv vs plain; 8. the 1M-node mesh ----
        if "ell" in phases:
            stamp("ell: ell_spmv at the bench (ELL, BCSR 32), large and "
                  "ragged shapes")
            cases = []
            for op in ("ell", "bcsr"):
                md = setup_bench.initialize(days=2)
                md.operator, md.operator_block = op, 32
                mesh, static = md.freeze(dev)[:2]
                cases.append((f"bench {op}", mesh, static.dirichlet))
            from shakti_tpu_torch.setups import setup_slab
            for op in ("ell", "bcsr"):
                md = setup_slab.initialize(nx=12, ny=12)
                md.operator, md.operator_block = op, 32
                mesh, static = md.freeze(dev)[:2]
                cases.append((f"ragged n={mesh.n_nodes} {op}", mesh,
                              static.dirichlet))
            smd = scale_model()
            t0 = time.perf_counter()
            frozen = smd.freeze(dev)
            torch.cuda.synchronize(dev)
            freeze_s = time.perf_counter() - t0
            log(f"  large mesh: freeze {freeze_s:.2f} s host time, "
                f"{frozen[0].n_nodes} nodes, {frozen[0].n_cells} cells, BCSR "
                f"B {frozen[0].bcsr_B} nnzb {frozen[0].bcsr_brow.shape[0]}, "
                f"coarse block {frozen[3].coarse_block}")
            if (frozen[0].n_nodes, frozen[0].bcsr_B, frozen[3].coarse_block,
                    frozen[3].lag_operator) != (1_002_001, 32, 1024, False):
                raise RuntimeError(
                    f"auto at 1M nodes: B {frozen[0].bcsr_B}, coarse "
                    f"{frozen[3].coarse_block}, lag {frozen[3].lag_operator}")
            cases.append((f"large bcsr n={frozen[0].n_nodes}", frozen[0],
                          frozen[1].dirichlet))
            eres = phase_ell_kernel(dev, cases)
            del cases, mesh, static
            if "scale" in phases:
                stamp("scale: 24 steps on the large mesh through api/run.solve")
                sres = phase_scale(dev, smd, frozen)
                sres["freeze_s"] = freeze_s
                if "mg" in phases:
                    stamp("mg: the large mesh under the multilevel V-cycle")
                    gres = {"1M": phase_mg_scale(dev, smd, frozen, sres)}
            del smd, frozen
            torch.cuda.empty_cache()

        # ---- 9. formats agree; 12. BiCGStab ----
        if "formats" in phases:
            stamp("formats: bench model, float64, 4 steps, four operators")
            fres, ref = phase_formats(dev)
            if "bicgstab" in phases:
                stamp("bicgstab: bench model, float64, 4 steps")
                phase_bicgstab(dev, ref["N"])
            if "mg" in phases and gres is not None:
                stamp("mg: bench model, float64, 4 steps, bell/ell/bcsr")
                gres["bench"] = phase_mg_bench(dev, ref)

        # ---- 10. resume through the CLI ----
        if "resume" in phases and "main" in phases:
            stamp("resume: 25 steps, then --resume to 48")
            phase_resume(dev, tmp, main_dir)

        # ---- 11. the float64 bootstrap on the card ----
        if "bootstrap" in phases:
            stamp("bootstrap: setup_cooke2, reference cold start, 3 days")
            phase_bootstrap(dev, tmp)

        # ---- 14. the steady state ----
        if "steady" in phases:
            stamp("steady: slab 16 x 16, float64, PTC")
            stres, slab = phase_steady(dev, tmp)

        # ---- 15. the monolithic polish ----
        if "polish" in phases:
            stamp("polish: slab polish; SHMIP A1 60 x 12 steady with polish")
            pres = phase_polish(dev, tmp, slab)

        # ---- 19. the distributed path ----
        if "dist" in phases:
            stamp("dist: 4 ranks bench f64/f32, 8 ranks toy, 2 ranks steady,"
                  " world size 1 NCCL vs gloo")
            dres = phase_dist(
                dev, tmp, ref=ref, main_dir=main_dir,
                mg13=None if gres is None or "bench" not in gres
                else gres["bench"]["bcsr"],
                slab=None if slab is None
                else (slab[0], slab[1], stres["steps"]))

    # ---- 16. the differentiable transient; 17. the batched ensemble ----
    if "adjoint" in phases:
        stamp("adjoint: bench model, float64, 6 steps, gradients vs FD")
        ares = phase_adjoint(dev)
    if "ensemble" in phases:
        stamp("ensemble: bench model, float32, M = 8, 24 steps")
        enres = phase_ensemble(dev)
    # ---- 23. the ensemble's element kernels ----
    if "element" in phases:
        stamp("element: Cook_E2, M = 128, the element kernels vs their twin")
        elres = phase_element(dev)
    # ---- 24. the ensemble's coarse operators ----
    if "coarse" in phases:
        stamp("coarse: Cook_E2, M = 128, coarse_batched vs its twin and the "
              "route it replaces")
        cores = phase_coarse(dev)
        if enres is not None:
            cores["ensemble_members_err_N"] = {
                m: r["err_N"] for m, r in enres["members"].items()}
            log("  phase 17, members alone against the f32 ensemble "
                f"(limit {ENSEMBLE_F32_RTOL:g}): "
                + json.dumps(cores["ensemble_members_err_N"]))
    # ---- 18. Cook_E2 from the potential field to the battery ----
    # ---- 21. the validation drivers, on phase 18's run ----
    if "cooke2" in phases:
        stamp("cooke2: basin mesh, 10 days f32, battery, f32 vs f64")
        with tempfile.TemporaryDirectory() as tmp:
            cres, cooke2_run = phase_cooke2(dev, tmp)
            if "validate" in phases:
                stamp("validate: the report on phase 18's run, SHMIP A1 one "
                      "year, the steady Cook_E2 capped")
                vres = phase_validate(dev, cooke2_run)
    # ---- 20. the distributed adjoint ----
    if "dist_adjoint" in phases:
        stamp("dist_adjoint: bench model, float64, 3 steps, 2 ranks, "
              "gradients vs single device and FD")
        with tempfile.TemporaryDirectory() as tmp:
            xres = phase_dist_adjoint(dev, tmp)
    # ---- 22. the JAX package's drivers at cuts ----
    if "drivers" in phases:
        stamp("drivers: the example twins and SHMIP B-F runners at cuts")
        wres = phase_drivers(dev)
    stamp("done")

    if phases != list(PHASES):
        log("partial run: no result lines")
        return 0
    f32 = kres["float32"]
    bat = enres["kernel"]["float32"]
    large = next(v for k, v in eres.items() if k.startswith("large"))
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "bell_spmv", "route": "cuda",
        "source": "shakti_tpu_torch/csrc/bell_spmv.cu",
        "replaces": "shakti_tpu/ops/spmv_pallas.py:46",
        "launches": mres["launches"],
        "launches_mg_bench": gres["bench"]["bell"]["launches"]["bell_spmv"],
        "launches_steady": stres["launches"]["bell_spmv"],
        "launches_shmip_a1": pres["a1"]["launches"]["bell_spmv"],
        "launches_adjoint_backward": ares["launches_backward"]["bell_spmv"],
        "launches_cooke2": cres["run"]["launches"]["bell_spmv"],
        "max_abs_err_cooke2": {"float32": cres["operator_max_abs_err"],
                               "float64": cres["operator_max_abs_err_f64"]},
        "launches_dist": sum(p["launches"] for p in
                             dres["a_two_level"]["per_rank"])
        + sum(dres["b_run"]["launches_per_rank"]),
        "max_abs_err_dist": dres["a_two_level"]["kernel_check"],
        "launches_dist_adjoint_backward": sum(
            p["launches_backward"]["bell_spmv"] for p in xres["per_rank"]),
        "max_abs_err_dist_adjoint": xres["kernel_check"],
        "launches_validate": vres["launches"],
        "launches_drivers": wres["launches_drivers"],
        "max_abs_err_drivers": wres["kernel_check"]["single"],
        "W": kres["W"],
        **{k: f32[k] for k in LINE_KEYS}, "bound_by": f32["bound_by"],
        "float64": {k: kres["float64"][k] for k in LINE_KEYS}}, {
        "name": "bell_spmv_batched", "route": "cuda",
        "source": "shakti_tpu_torch/csrc/bell_spmv.cu",
        "replaces": "shakti_tpu/ops/spmv_pallas.py:46 (under jax.vmap: "
                    "shakti_tpu/parallel/ensemble.py:57)",
        "launches": enres["launches"]["bell_spmv_batched"],
        "launches_drivers": wres["launches"]["bell_spmv_batched"],
        "max_abs_err_drivers": wres["kernel_check"]["batched"],
        **{k: bat[k] for k in BATCHED_LINE_KEYS}, "bound_by": bat["bound_by"],
        "float64": {k: enres["kernel"]["float64"][k]
                    for k in ("M", "max_abs_err", "max_abs_err_product")}}, {
        "name": "ell_spmv", "route": "cuda",
        "source": "shakti_tpu_torch/csrc/ell_spmv.cu",
        "replaces": "none (not a TPU kernel): shakti_tpu/fem/bcsr.py:84 "
                    "bcsr_matvec and shakti_tpu/fem/ell.py:91 ell_matvec "
                    "run in XLA",
        "launches": sres["launches"], "launches_mg_1M": gres["1M"]["launches"],
        "launches_dist": sum(p["launches"] for p in dres["a_mg"]["per_rank"]),
        "max_abs_err_dist": dres["a_mg"]["kernel_check"],
        "launches_mg_bench": {op: gres["bench"][op]["launches"]["ell_spmv"]
                              for op in ("ell", "bcsr")},
        "W": large["float32"]["W"],
        "n": large["float32"]["n"], "nnz": large["float32"]["nnz"],
        **{k: large["float32"][k] for k in ELL_LINE_KEYS},
        "bound_by": large["float32"]["bound_by"],
        "float64": {k: large["float64"][k] for k in ELL_LINE_KEYS},
        "bench": {tag: {dt: {k: r[k] for k in ELL_LINE_KEYS}
                        for dt, r in v.items()}
                  for tag, v in eres.items() if tag.startswith("bench")}}, {
        "name": "element_batched", "route": "cuda",
        "source": "shakti_tpu_torch/csrc/element_batched.cu",
        "replaces": "none (not a TPU kernel): jax.vmap of "
                    "shakti_tpu/physics/residual.py's element_jacobian "
                    "(forward AD) and assemble_residual(_multi) in XLA",
        "launches": elres["launches"], "M": elres["M"],
        **{k: elres["float32"][k] for k in (
            "jacobian_err", "residual_err", "device_ms", "bound_ms",
            "roofline_pct", "ms", "plain_device_ms", "library_ms",
            "library_device_ms")},
        "float64": {k: elres["float64"][k]
                    for k in ("jacobian_err", "residual_err")}}, {
        "name": "coarse_batched", "route": "cuda",
        "source": "shakti_tpu_torch/csrc/element_batched.cu",
        "replaces": "none (not a TPU kernel): jax.vmap of "
                    "shakti_tpu/solve/precond.py's coarse_from_values in XLA",
        "launches": cores["launches"], "M": cores["M"],
        "newton_iterations": cores["newton_iterations"],
        "ensemble_members_err_N": cores["ensemble_members_err_N"],
        **{str(b): cores["float32"][b] for b in cores["blocks"]},
        "float64": {str(b): cores["float64"][b] for b in cores["blocks"]}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
