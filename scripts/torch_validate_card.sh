#!/usr/bin/env bash
# The port's validation runs on one card, started together (each process
# drives the card from the host and leaves it mostly idle): the 10-year
# Cook_E2 production run in float32 and its float64 twin, SHMIP A1, A3, A5
# and S_A1 (a process each), and the direct float64 steady Cook_E2.  When all have ended,
# the float32 run's last day is profiled with the card to itself, and the
# report is written.
#
#     bash scripts/torch_validate_card.sh [OUT_DIR] [MAX_WALL_S] [STEADY_WALL_S]
#
# MAX_WALL_S (default 3000) stops a Cook_E2 run at that point (its record
# then counts the steps to its last checkpoint); STEADY_WALL_S (default
# MAX_WALL_S) stops the steady march likewise, and a later run of this
# script with results/Cook_E2_steady_ck/ptc.npz in place resumes it.  The
# results directories go to results/ (gitignored); the reports, the JSON,
# each run's records and the logs are copied to OUT_DIR (default
# results/validate).  Exits non-zero if any run failed.
set -u
cd "$(dirname "$0")/.."
OUT=${1:-results/validate}
WALL=${2:-3000}
SWALL=${3:-$WALL}
mkdir -p "$OUT"
export SHAKTI_MESH_DIR=assets/cooke2_synth OMP_NUM_THREADS=1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
# build the kernels once, before the runs load them
python -c "from shakti_tpu_torch.ops import spmv_cuda
for k in spmv_cuda.KERNELS: spmv_cuda.build(k)" || exit 1

date +%s > "$OUT/t_start"
pids=()
python scripts/torch_cooke2_report.py --run --max-wall "$WALL" \
    > "$OUT/cooke2_f32.log" 2>&1 & pids+=($!)
python scripts/torch_cooke2_report.py --run --max-wall "$WALL" \
    --setup scripts/torch_setup_cooke2_f64.py > "$OUT/cooke2_f64.log" 2>&1 &
pids+=($!)
# one process per case: a case's row is written when the case ends, so
# each gets the wall limit and 100 s more
for c in A1 A3 A5; do
    timeout $((WALL + 100)) python scripts/torch_shmip_validate.py \
        --suites A --cases "$c" > "$OUT/shmip_$c.log" 2>&1 & pids+=($!)
done
timeout $((WALL + 100)) python scripts/torch_shmip_validate.py --suites S \
    > "$OUT/shmip_S.log" 2>&1 & pids+=($!)
python scripts/torch_cooke2_steady.py --max-wall "$SWALL" \
    --checkpoint results/Cook_E2_steady_ck > "$OUT/steady.log" 2>&1 &
pids+=($!)
rc=0
for p in "${pids[@]}"; do
    wait "$p" || rc=1
done
date +%s > "$OUT/t_runs_done"
python scripts/torch_cooke2_report.py --profile > "$OUT/profile.log" 2>&1 \
    || rc=1
python scripts/torch_cooke2_report.py > "$OUT/report.log" 2>&1 || rc=1
python scripts/torch_cooke2_steady.py --compare > /dev/null || rc=1

cp COOKE2_RUN_TORCH.md SHMIP_TORCH.md scripts/torch_cooke2_results.json \
   scripts/torch_shmip_results.json scripts/torch_cooke2_steady.json "$OUT/"
for d in results/Cook_E2_370kpa results/Cook_E2_370kpa_f64; do
    mkdir -p "$OUT/$(basename "$d")"
    cp "$d"/run_meta*.json "$d"/log.csv "$OUT/$(basename "$d")/"
    cp "$d"/profile.json "$OUT/$(basename "$d")/" 2>/dev/null
done
cp -r results/Cook_E2_steady_ck "$OUT/"
exit $rc
