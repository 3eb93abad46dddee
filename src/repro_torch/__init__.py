"""PyTorch + CUDA port of the posit PDPU serving stack (`repro`).

`repro_torch` mirrors `src/repro/` path for path and runs on one NVIDIA
Hopper GPU through hand-written CUDA kernels (`csrc/`).  It imports
neither JAX nor the `repro` package.  Entry points take `device="cuda"`
by default; passing `device="cpu"` runs every kernel's plain PyTorch
version instead (how the parity tests run).  There is no silent move to
the CPU: asking for CUDA without a card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_float32_parity():
    """Full-precision f32 matmuls on the card: TF32 rounds P(16,2) weights
    (11 fraction bits) and f32 activations, so parity mode turns it off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
