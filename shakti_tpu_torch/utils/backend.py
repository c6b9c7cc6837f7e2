"""Device selection for the port.

Every entry point resolves its device here, so the float32 policy is set in
one place: TF32 matmuls/convolutions keep ~3 decimal digits, which breaks
the f32 Newton solve exactly as the bf16 default did on the TPU
(shakti_tpu/fem/ops.py:28-40).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for ``device`` ('cuda', 'cuda:1', 'cpu' or a
    torch.device).  A CUDA device that is not present raises: there is no
    silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available()"
                " is False (no GPU, or a CPU-only torch build); pass "
                "--device cpu to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
