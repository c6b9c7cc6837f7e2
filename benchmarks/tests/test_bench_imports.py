"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the port."""

from pathlib import Path

import pytest

from benchmarks.harness import guard

BENCH_DIR = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    assert guard.forbidden_loaded(["shakti_tpu_torch", "shakti_tpu_torch.api",
                                   "torch", "numpy"]) == []
    assert guard.forbidden_loaded(["shakti_tpu"]) == ["shakti_tpu"]
    assert guard.forbidden_loaded(["shakti_tpu.solve.newton"]) == ["shakti_tpu"]
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert guard.forbidden_loaded(["jaxtyping", "flaxen"]) == []


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_forbidden_import(path):
    tops = {guard.top_level(n) for n in guard.imported_names(path)}
    assert not tops & set(guard.FORBIDDEN), path
    if "reference" in path.parts:
        assert not tops & {"shakti_tpu_torch", "benchmarks"}, path
