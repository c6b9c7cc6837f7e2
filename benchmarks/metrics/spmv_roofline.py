"""spmv_roofline: ops/spmv_cuda's operator kernel on the step's path, in %
of the time the card's HBM bandwidth allows for the bytes one application
needs (an ensemble's M members' values and vectors, the structure once;
counted from the mesh's connectivity, harness/work.py), over the mean
device time of the traced slice's records of that kernel: bell_spmv,
its member-batched launch or ell_spmv, whichever one the run launched."""

from benchmarks.harness import work

KERNEL = r"\b(bell_spmv|bell_spmv_batched|ell_spmv)_kernel\b"


def read(run):
    t = run.trace
    if t is None:
        return None
    found = t.kernel_times(KERNEL)
    if len(found) != 1:
        return None
    (count, seconds), = found.values()
    if not count or seconds <= 0:
        return None
    need = work.operator_bytes(run.cells, run.n, run.value_bytes,
                               members=run.members)
    return 100.0 * (need / work.HBM_BYTES_PER_S) / (seconds / count)
