"""Bit-exact chunked-PDPU GEMM: the CUDA kernel and its plain version.

`pdpu_matmul` (K8, `csrc/pdpu_dot.cu`) replaces
`repro/kernels/pdpu_dot.py:pdpu_matmul`: [M, K] x [K, N_out] posit codes
through chunk-size-N PDPUs, the paper's S1-S6 integer datapath with the
W_m alignment truncation and the accumulator rounded to `cfg.fmt_out`
after every chunk.  Every output code is what a silicon PDPU array with
that chunk size and alignment width produces.  On a CUDA tensor the
wrapper launches the kernel; on a CPU tensor it runs the plain version,
`core/pdpu.pdpu_matmul_exact`.  K must hold whole chunks; M and N_out
need not divide any tile.
"""
from __future__ import annotations

import torch

from repro_torch.core import pdpu
from repro_torch.core.formats import PDPUConfig
from . import _build

# launches of the kernel since the last reset (kernels/ops.reset_launches)
LAUNCHES = {"pdpu_matmul": 0}
_CHUNKS = (1, 2, 4, 8, 16)
_CODE_DTYPES = (torch.int8, torch.int16, torch.int32)


def pdpu_matmul_plain(a_codes, b_codes, cfg: PDPUConfig):
    """The datapath output by output in plain PyTorch (int32 codes)."""
    mask = cfg.fmt_in.mask
    return pdpu.pdpu_matmul_exact(a_codes.to(torch.int64) & mask,
                                  b_codes.to(torch.int64) & mask, cfg)


def pdpu_matmul(a_codes, b_codes, cfg: PDPUConfig):
    """[M, K] fmt_in codes x [K, N_out] fmt_in codes -> [M, N_out] int32
    fmt_out codes.  Codes may sit in any integer container (the int16
    container sign-extends, so only the low n bits are read).  b_codes may
    be a transposed view (the tied embedding as the logits head)."""
    if a_codes.ndim != 2 or b_codes.ndim != 2:
        raise ValueError(f"pdpu_matmul takes 2-D operands, got "
                         f"{tuple(a_codes.shape)} x {tuple(b_codes.shape)}")
    M, K = a_codes.shape
    K2, N_out = b_codes.shape
    if K != K2:
        raise ValueError("contraction mismatch")
    if K % cfg.N:
        raise ValueError(f"K={K} not divisible by PDPU chunk size N={cfg.N}")
    pdpu._validate(cfg)
    if a_codes.device.type == "cpu":
        return pdpu_matmul_plain(a_codes, b_codes, cfg)
    for name, t in (("a", a_codes), ("b", b_codes)):
        if t.dtype not in _CODE_DTYPES:
            raise TypeError(f"pdpu_matmul: {name} must hold integer codes, "
                            f"got {t.dtype}")
    if cfg.N not in _CHUNKS:
        raise ValueError(f"pdpu_matmul: the kernel takes chunk sizes "
                         f"{_CHUNKS}, got N={cfg.N}")
    if cfg.fmt_in.n > 16 or cfg.fmt_out.n > 16:
        raise ValueError("pdpu_matmul: formats of at most 16 bits")
    # the kernel reads int16 containers; the low n bits of a code survive
    # the conversion from any container, and an int16 view stays a view
    a16 = a_codes.to(torch.int16).contiguous()
    b16 = b_codes.to(torch.int16)
    if not (b16.stride(1) == 1 or b16.stride(0) == 1):
        b16 = b16.contiguous()
    dev = a16.device
    if a16.device != b16.device or dev.type != "cuda":
        raise ValueError(f"pdpu_matmul: tensors must share one CUDA device, "
                         f"got {a16.device} and {b16.device}")
    out = torch.empty((M, N_out), dtype=torch.int32, device=dev)
    if M and N_out:
        lib = _build.library("pdpu_dot")
        fi, fo = cfg.fmt_in, cfg.fmt_out
        _build.check(lib.pdpu_matmul_launch(
            a16.data_ptr(), b16.data_ptr(), out.data_ptr(), M, K, N_out,
            a16.stride(0), a16.stride(1), b16.stride(0), b16.stride(1),
            fi.n, fi.es, fo.n, fo.es, cfg.N, cfg.w_m, cfg.guard_bits,
            int(cfg.sticky), _build.stream_of(a16)), "pdpu_matmul")
        LAUNCHES["pdpu_matmul"] += 1
    return out
