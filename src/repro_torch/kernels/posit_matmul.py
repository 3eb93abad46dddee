"""Coded posit GEMM: the CUDA kernel and its plain version.

`posit_matmul` (K6, `csrc/posit_matmul.cu`) replaces
`repro/kernels/posit_matmul.py:posit_matmul`: [M, K] posit codes x [K, N]
posit codes, decoded in the kernel, accumulated in f32, returned as f32
or encoded once into `fmt_out`.  On a CUDA tensor the wrapper launches
the kernel; on a CPU tensor it runs the plain version (decode both
operands, one f32 matmul, optional encode).  M, N and K need not divide
any tile.  The grouped (MoE) form is not ported yet (ROADMAP queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import storage_dtype
from . import _build
from .posit_codec import decode_plain, encode_plain

# launches of the kernel since the last reset (kernels/ops.reset_launches)
LAUNCHES = {"posit_matmul": 0}
_CODE_DTYPES = (torch.int8, torch.int16)


# Tolerance constant of `sum_bound`, in units of u sqrt(K) ||a_i . b_j||_2.
# On an H100 the kernel's sums came within 4.0 units of torch.matmul's at
# the serving shapes, while weights rounded to bf16 landed 816 or more
# units off and one K tile left out 22000 or more (`chip_smoke.py` prints
# all three): 16 leaves a factor 4 on the sound side and 50 on the other.
SUM_TOL = 16.0


def sum_bound(a_codes, b_codes, fmt_a: PositFormat, fmt_b: PositFormat):
    """Tolerance between two f32 sums of the same K products of random
    sign taken in different orders: SUM_TOL * u * sqrt(K) *
    sqrt(sum_k (a_ik b_kj)^2), u = 2^-24.  Each sum's rounding errors walk
    at random, so the gap grows as sqrt(K) u times the products' scale,
    not as the worst case K u.  Returns [M, N] f32."""
    K = a_codes.shape[1]
    a = decode_plain(a_codes, fmt_a).double()
    b = decode_plain(b_codes, fmt_b).double()
    norm = torch.matmul(a * a, b * b).sqrt()
    return (SUM_TOL * 2.0 ** -24 * K ** 0.5 * norm).float()


def posit_matmul_plain(a_codes, b_codes, fmt_a: PositFormat,
                       fmt_b: PositFormat, fmt_out: PositFormat | None = None):
    """decode(A) @ decode(B) in f32, then one encode to fmt_out if set."""
    out = torch.matmul(decode_plain(a_codes, fmt_a), decode_plain(b_codes, fmt_b))
    return out if fmt_out is None else encode_plain(out, fmt_out)


def _check_codes(name: str, t, fmt: PositFormat):
    if t.dtype not in _CODE_DTYPES:
        raise TypeError(f"posit_matmul: {name} must hold int8/int16 codes, "
                        f"got {t.dtype}")
    if fmt.storage_bits != t.element_size() * 8:
        raise TypeError(f"posit_matmul: {fmt} codes live in "
                        f"int{fmt.storage_bits}, {name} is {t.dtype}")


def posit_matmul(a_codes, b_codes, fmt_a: PositFormat, fmt_b: PositFormat,
                 fmt_out: PositFormat | None = None):
    """[M, K] codes x [K, N] codes -> [M, N] f32 (fmt_out None) or fmt_out
    codes in their storage dtype."""
    if a_codes.ndim != 2 or b_codes.ndim != 2:
        raise ValueError(f"posit_matmul takes 2-D operands, got "
                         f"{tuple(a_codes.shape)} x {tuple(b_codes.shape)}")
    M, K = a_codes.shape
    K2, N = b_codes.shape
    if K != K2:
        raise ValueError(f"contraction mismatch {tuple(a_codes.shape)} x "
                         f"{tuple(b_codes.shape)}")
    if a_codes.device.type == "cpu":
        return posit_matmul_plain(a_codes, b_codes, fmt_a, fmt_b, fmt_out)
    _check_codes("a", a_codes, fmt_a)
    _check_codes("b", b_codes, fmt_b)
    _build.require_cuda("posit_matmul", a_codes, b_codes)
    dev = a_codes.device
    if fmt_out is None:
        out = torch.empty((M, N), dtype=torch.float32, device=dev)
    else:
        dt = storage_dtype(fmt_out)
        if dt not in _CODE_DTYPES:
            raise ValueError(f"posit_matmul writes int8/int16 codes, not {dt}")
        out = torch.empty((M, N), dtype=dt, device=dev)
    if M and N:
        lib = _build.library("posit_matmul")
        _build.check(lib.posit_matmul_launch(
            a_codes.data_ptr(), b_codes.data_ptr(),
            out.data_ptr() if fmt_out is None else None,
            None if fmt_out is None else out.data_ptr(), M, N, K,
            a_codes.element_size(), fmt_a.n, fmt_a.es,
            b_codes.element_size(), fmt_b.n, fmt_b.es,
            0 if fmt_out is None else out.element_size(),
            fmt_out.n if fmt_out else 0, fmt_out.es if fmt_out else 0,
            _build.stream_of(a_codes)), "posit_matmul")
        LAUNCHES["posit_matmul"] += 1
    return out
