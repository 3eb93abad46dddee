"""Elementwise posit decode / encode: CUDA kernels and their plain versions.

`decode` and `encode` take any shape.  On a CUDA tensor they launch the
hand-written kernels of `csrc/posit_codec.cu` (K1 and K2, which replace
`repro/kernels/posit_codec.py:decode` / `:encode`); on a CPU tensor they
run the plain PyTorch codec (`decode_plain` / `encode_plain`), which is
bit-for-bit the JAX codec.  The kernels take int8/int16 codes and f32
values (other floats are converted first) and must match the plain
versions bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import PositFormat
from . import _build

# launches of each kernel since the last reset (kernels/ops.reset_launches)
LAUNCHES = {"posit_decode": 0, "posit_encode": 0}
_CODE_DTYPES = (torch.int8, torch.int16)


def decode_plain(codes, fmt: PositFormat):
    """posit codes -> f32 values (plain PyTorch)."""
    return posit.decode(codes, fmt)


def encode_plain(values, fmt: PositFormat):
    """float values -> posit codes in the storage dtype (plain PyTorch)."""
    return posit.pack(values, fmt)


def _check_fmt(fmt: PositFormat, dtype: torch.dtype):
    if fmt.storage_bits != dtype.itemsize * 8:
        raise ValueError(f"{fmt} codes live in int{fmt.storage_bits}, "
                         f"got {dtype}")


def decode(codes, fmt: PositFormat):
    """posit codes (int8/int16, any shape) -> float32 values."""
    if codes.device.type == "cpu":
        return decode_plain(codes, fmt)
    _build.require_cuda("posit_decode", codes)
    if codes.dtype not in _CODE_DTYPES:
        raise TypeError(f"posit_decode takes int8/int16 codes, got {codes.dtype}")
    _check_fmt(fmt, codes.dtype)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    if codes.numel():
        lib = _build.library("posit_codec")
        _build.check(lib.posit_decode_launch(
            codes.data_ptr(), out.data_ptr(), codes.numel(),
            codes.element_size(), fmt.n, fmt.es, _build.stream_of(codes)),
            "posit_decode")
        LAUNCHES["posit_decode"] += 1
    return out


def encode(values, fmt: PositFormat):
    """float values (any shape) -> posit codes in the storage dtype."""
    if values.device.type == "cpu":
        return encode_plain(values, fmt)
    if not values.is_floating_point():
        raise TypeError(f"posit_encode takes float values, got {values.dtype}")
    values = values.to(torch.float32)
    _build.require_cuda("posit_encode", values)
    dtype = posit.storage_dtype(fmt)
    if dtype not in _CODE_DTYPES:
        raise ValueError(f"posit_encode writes int8/int16 codes, not {dtype}")
    out = torch.empty(values.shape, dtype=dtype, device=values.device)
    if values.numel():
        lib = _build.library("posit_codec")
        _build.check(lib.posit_encode_launch(
            values.data_ptr(), out.data_ptr(), values.numel(),
            out.element_size(), fmt.n, fmt.es, _build.stream_of(values)),
            "posit_encode")
        LAUNCHES["posit_encode"] += 1
    return out
