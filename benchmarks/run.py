"""The benchmark of shakti_tpu_torch on one NVIDIA card: one run of one cell.

    python3 benchmarks/run.py --workload cooke2-ens128 --seed 7 --seconds 10 --trace 0

Prints a log on standard error and, as the last line of standard output, one
JSON object: correct, attempted, failed, metrics, device (and with
``--trace 1`` the breakdown), then the numbers ``correct`` compared, each
with its limit.  Exits non-zero without a result when there is no card, or
when JAX or the JAX package was loaded.  See benchmarks/README.md.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every cache at a fixed path inside the checkout (the port builds its
# kernels into build/shakti_tpu_torch/ there by itself)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)
sys.path.insert(0, str(ROOT))

from benchmarks.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
