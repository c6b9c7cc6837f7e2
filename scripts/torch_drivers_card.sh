#!/usr/bin/env bash
# The JAX package's drivers on the port, on one card: SHMIP suites B to F
# (scripts/torch_shmip_validate.py, a process per case) and the five example
# twins (scripts/torch_examples_card.py, a process each), at most JOBS
# processes at once (each drives the card from the host and leaves it
# mostly idle).
#
#     bash scripts/torch_drivers_card.sh [OUT_DIR] [WALL_S] [JOBS] [CK_DIR]
#
# WALL_S (default 3000) is the time this call has: each SHMIP case gets
# what is left of it less 90 s as its --max-wall, stops at its first save
# past that (its state under CK_DIR, default results/shmip_ck) and a later
# run of this script resumes it; a case or example with no time left is not
# started.  Cases already complete in scripts/torch_shmip_results.json are
# skipped.  Suite B's rows hold their y-mean N profiles: relN_vs_A5 is
# derived wherever A5's final state (results/shmip_A5_final.npz, written by
# `torch_shmip_validate.py --suites A --cases A5`) is present.  C1-C4 start
# from B5's final state (results/shmip_B5_final/) and wait for it.
# OUT_DIR (default results/drivers) receives the logs, the cache,
# SHMIP_TORCH.md, the examples' JSON and state.tgz (CK_DIR and B5's final
# state, to carry to the next call: unpack it in the repo's root).  Exits 1 if any run failed, 4 if some case is unfinished, else 0.
set -u
cd "$(dirname "$0")/.."
OUT=${1:-results/drivers}
WALL=${2:-3000}
JOBS=${3:-7}
CK=${4:-results/shmip_ck}
mkdir -p "$OUT" "$CK"
export OMP_NUM_THREADS=1
T_END=$(( $(date +%s) + WALL ))
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
# build the kernels once, before the runs load them
python -c "from shakti_tpu_torch.ops import spmv_cuda
for k in spmv_cuda.KERNELS: spmv_cuda.build(k)" || exit 1

left() { echo $(( T_END - $(date +%s) )); }

# run NAME CMD...: the command with its output in OUT/NAME.log and its exit
# code in OUT/NAME.rc (3: stopped, or not started, for want of time)
run() {
    local name=$1; shift
    if [ "$(left)" -lt 300 ]; then
        echo 3 > "$OUT/$name.rc"; return
    fi
    "$@" > "$OUT/$name.log" 2>&1
    echo $? > "$OUT/$name.rc"
}

shmip() {   # shmip SUITE CASE
    run "shmip_$2" python scripts/torch_shmip_validate.py --suites "$1" \
        --cases "$2" --checkpoint "$CK" --max-wall $(( $(left) - 90 ))
}

c_case() {  # C cases wait for B5's final state
    while [ ! -f results/shmip_B5_final/checkpoint.npz ] \
          && [ "$(left)" -gt 400 ]; do
        sleep 20
    done
    if [ -f results/shmip_B5_final/checkpoint.npz ]; then
        shmip C "$1"
    else
        echo 3 > "$OUT/shmip_$1.rc"
    fi
}

jobs_list() {   # B5 first (C waits for it), the short examples next
    echo "shmip B B5"
    for e in calibrate_melt invert_melt_field ensemble_uq lake_workflow \
             basin_pipeline; do
        [ -f scripts/torch_examples_card.py ] \
            && [ ! -f "$OUT/example_$e.json" ] && echo "example $e"
    done
    for c in E1 E2 E3 E4 E5; do echo "shmip E $c"; done
    for c in B1 B2 B3 B4; do echo "shmip B $c"; done
    for c in D1 D2 D3 D4 D5; do echo "shmip D $c"; done
    for c in C1 C2 C3 C4; do echo "c_case $c"; done
    for c in F1 F2 F3 F4 F5; do echo "shmip F $c"; done
}

example() {
    run "example_$1" python scripts/torch_examples_card.py "$1" \
        --out "$OUT/example_$1.json"
}

date +%s > "$OUT/t_start"
while read -r kind a b; do
    while [ "$(jobs -rp | wc -l)" -ge "$JOBS" ]; do
        wait -n
    done
    case $kind in
        shmip) shmip "$a" "$b" & ;;
        example) example "$a" & ;;
        c_case) c_case "$a" & ;;
    esac
    sleep 2
done < <(jobs_list)
wait
date +%s > "$OUT/t_end"

# the cache's derived values and SHMIP_TORCH.md from every case's row
python scripts/torch_shmip_validate.py --suites "" > "$OUT/render.log" 2>&1
cp SHMIP_TORCH.md scripts/torch_shmip_results.json "$OUT/"
tar czf "$OUT/state.tgz" "$CK" $(ls -d results/shmip_B5_final 2>/dev/null)
for f in "$OUT"/*.rc; do
    echo "$(basename "$f" .rc): $(cat "$f")"
done | tee "$OUT/status.txt"
grep -q ": [^03]" "$OUT/status.txt" && exit 1
grep -q ": 3$" "$OUT/status.txt" && exit 4
exit 0
