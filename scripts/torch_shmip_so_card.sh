#!/usr/bin/env bash
# The rest of the SHMIP driver on the port, on one card: D5 (which gives the
# artesian study X), D3 and D4, B5 again then C4 (C4 starts from B5's final
# state), E1 again (its final state feeds the stationarity leg), then suite
# S for A2-A6 and F1-F5 (scripts/torch_shmip_validate.py, a process per
# case), at most JOBS processes at once (each drives the card from the host
# and leaves it mostly idle); with SMOKE=1, chip_smoke.py's phase 22 first
# beside them.
#
#     bash scripts/torch_shmip_so_card.sh [OUT_DIR] [WALL_S] [JOBS]
#
# WALL_S (default 3000) is the time this call has: each case gets what is
# left of it less 90 s as its --max-wall and stops there; a case with less
# than 300 s left is not started.  Everything a case writes lands in
# OUT_DIR as it is written, so that a call cut short keeps it: results/
# (the checkpoints under results/shmip_ck, B5's and E1's final states) is
# OUT_DIR/results, and the cache and SHMIP_TORCH.md are OUT_DIR's copies.
# A later run resumes every case from there (copy OUT_DIR/results to the
# repo's results/ and OUT_DIR's cache to scripts/ first).  Cases already
# complete in the cache are skipped (B5 and E1 rerun unless their final
# states are present, D5 unless X's row is).  Exits 1 if any run failed,
# 4 if some case is unfinished, else 0.
set -u
cd "$(dirname "$0")/.."
OUT=${1:-results/shmip_so}
WALL=${2:-3000}
JOBS=${3:-8}
CK=results/shmip_ck
mkdir -p "$OUT/results"
OUT=$(cd "$OUT" && pwd)
export OMP_NUM_THREADS=1
T_END=$(( $(date +%s) + WALL ))
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
# results/, the cache and SHMIP_TORCH.md written through to OUT
if [ -d results ] && [ ! -L results ]; then
    cp -r results/. "$OUT/results/" && rm -rf results
fi
ln -sfn "$OUT/results" results
for f in scripts/torch_shmip_results.json SHMIP_TORCH.md; do
    if [ ! -L "$f" ]; then
        cp "$f" "$OUT/$(basename "$f")" && ln -sfn "$OUT/$(basename "$f")" "$f"
    fi
done
mkdir -p "$CK"
# build the kernels once, before the runs load them
python -c "from shakti_tpu_torch.ops import spmv_cuda
for k in spmv_cuda.KERNELS: spmv_cuda.build(k)" || exit 1

left() { echo $(( T_END - $(date +%s) )); }

# shmip SUITE CASE [--force]: the case with its output in
# OUT/shmip_CASE.log and its exit code in OUT/shmip_CASE.rc (3: stopped, or
# not started, for want of time)
shmip() {
    local name=shmip_$2
    if [ "$(left)" -lt 300 ]; then
        echo 3 > "$OUT/$name.rc"; return
    fi
    python scripts/torch_shmip_validate.py --suites "$1" --cases "$2" \
        --checkpoint "$CK" --max-wall $(( $(left) - 90 )) ${3:-} \
        > "$OUT/$name.log" 2>&1
    echo $? > "$OUT/$name.rc"
}

b5_c4() {   # B5 again (its final state), then C4 from it
    if [ ! -f results/shmip_B5_final/checkpoint.npz ]; then
        shmip B B5 --force
    fi
    if [ -f results/shmip_B5_final/checkpoint.npz ]; then
        shmip C C4
    else
        echo 3 > "$OUT/shmip_C4.rc"
    fi
}

e1() {
    if [ ! -f results/shmip_E1_final.npz ]; then
        shmip E E1 --force
    fi
}

smoke() {
    python3 chip_smoke.py --phases drivers > "$OUT/smoke_drivers.log" 2>&1
    echo $? > "$OUT/smoke_drivers.rc"
}

jobs_list() {
    [ "${SMOKE:-0}" = 1 ] && echo "smoke"
    echo "shmip X D5"
    echo "shmip D D3"
    echo "shmip D D4"
    echo "b5_c4"
    echo "e1"
    for c in A2 A3 A6 A4 A5; do echo "shmip S $c"; done
    for c in F1 F2 F3 F4 F5; do echo "shmip F $c"; done
}

date +%s > "$OUT/t_start"
while read -r kind a b; do
    while [ "$(jobs -rp | wc -l)" -ge "$JOBS" ]; do
        wait -n
    done
    case $kind in
        shmip) shmip "$a" "$b" & ;;
        b5_c4) b5_c4 & ;;
        e1) e1 & ;;
        smoke) smoke & ;;
    esac
    sleep 2
done < <(jobs_list)
wait
date +%s > "$OUT/t_end"

# the cache's derived values and SHMIP_TORCH.md from every case's row
python scripts/torch_shmip_validate.py --suites "" > "$OUT/render.log" 2>&1
for f in "$OUT"/*.rc; do
    echo "$(basename "$f" .rc): $(cat "$f")"
done | tee "$OUT/status.txt"
grep -q ": [^03]" "$OUT/status.txt" && exit 1
grep -q ": 3$" "$OUT/status.txt" && exit 4
exit 0
