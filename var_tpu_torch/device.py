"""Device selection for the port's entry points.

Entry points default to ``"cuda"``. A request for CUDA on a machine without
a usable GPU raises instead of quietly running on the CPU; the plain PyTorch
path runs only when the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_exact():
    """Full-precision float32 matmuls and cuDNN convolutions inside the
    block. On the GPU, cuDNN runs float32 convolutions in TF32 by default
    (about three decimal digits), which flips greedy tokens in the
    quantizer's phi conv and the fp32 head; the JAX package runs both at
    HIGHEST precision."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
