"""Elementwise posit decode / encode: CUDA kernels and their plain versions.

`decode` and `encode` take any shape.  On a CUDA tensor they launch the
hand-written kernels of `csrc/posit_codec.cu` (K1 and K2, which replace
`repro/kernels/posit_codec.py:decode` / `:encode`); on a CPU tensor they
run the plain PyTorch codec (`decode_plain` / `encode_plain`), which is
bit-for-bit the JAX codec.  The kernels take int8/int16 codes and f32
values (other floats are converted first) and must match the plain
versions bit for bit.  Each picks its variant by format and container
(`decode_variant`, `encode_variant`): a compile-time kernel for P(16,2)
and P(13,2) in int16 and P(8,2) in int8 (every format the port's paths
decode and encode), the run-time kernel ("posit") otherwise;
`encode_fast_plain` states the 32-bit encoder's arithmetic in plain
PyTorch.  On a meta tensor the wrappers count the launch they would make
(`kernels/work.py`).
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import PositFormat
from . import _build, work

# launches of each kernel since the last reset (kernels/ops.reset_launches);
# "posit_decode:<variant>" / "posit_encode:<variant>" count K1's / K2's
# launches by `decode_variant` / `encode_variant`
LAUNCHES = {"posit_decode": 0, "posit_decode:p16_2": 0,
            "posit_decode:p13_2": 0, "posit_decode:p8_2": 0,
            "posit_decode:posit": 0, "posit_encode": 0,
            "posit_encode:p16_2": 0, "posit_encode:p13_2": 0,
            "posit_encode:p8_2": 0, "posit_encode:posit": 0}
_CODE_DTYPES = (torch.int8, torch.int16)
# K1's and K2's compile-time variants: (n, es, container) -> (name,
# launcher id)
_FAST_VARIANTS = {(16, 2, torch.int16): ("p16_2", 1),
                  (13, 2, torch.int16): ("p13_2", 2),
                  (8, 2, torch.int8): ("p8_2", 3)}
_M32 = 0xFFFFFFFF


def decode_plain(codes, fmt: PositFormat):
    """posit codes -> f32 values (plain PyTorch)."""
    return posit.decode(codes, fmt)


def encode_plain(values, fmt: PositFormat):
    """float values -> posit codes in the storage dtype (plain PyTorch)."""
    return posit.pack(values, fmt)


def _variant(fmt: PositFormat, dtype: torch.dtype) -> tuple[str, int]:
    return _FAST_VARIANTS.get((fmt.n, fmt.es, dtype), ("posit", 0))


def decode_variant(fmt: PositFormat, dtype: torch.dtype) -> str:
    """K1's kernel for codes of `fmt` in a `dtype` container: the
    compile-time decode (`posit_decode_fast`) for P(16,2) and P(13,2) in
    int16 and P(8,2) in int8, the run-time decode ("posit") otherwise."""
    return _variant(fmt, dtype)[0]


def encode_variant(fmt: PositFormat, dtype: torch.dtype) -> str:
    """K2's kernel for codes of `fmt` in a `dtype` container: the
    compile-time 32-bit encoder for P(16,2) and P(13,2) in int16 and P(8,2)
    in int8, the run-time encoder ("posit") otherwise."""
    return _variant(fmt, dtype)[0]


def round_abs_plain(S, L, fmt: PositFormat):
    """The posit rounding of a magnitude in one 32-bit word
    (`posit_round_abs` of csrc/posit.cuh), on int64 tensors: scale S and a
    significand L left-aligned at bit 31 -> the code of |value| (1 ..
    maxpos).  The pattern is one arithmetic shift of [1, 0, exponent,
    fraction] (k >= 0) or [0, 1, exponent, fraction] (k < 0) by k or
    -k - 1; its top n - 1 bits rounded to nearest even, the guard the next
    bit, the sticky every bit below.  S clamped to +-((n - 1) 2**es - 1)
    saturates every magnitude beyond maxpos / minpos."""
    n, es = fmt.n, fmt.es
    smax = ((n - 1) << es) - 1
    Sc = torch.clamp(S, -smax, smax)
    k = Sc >> es
    m = k ^ (k >> 31)                          # k >= 0: k, else -k - 1
    w = (torch.where(k >= 0, 0x80000000, 0x40000000)
         | (((Sc << (32 - es)) & _M32) >> 2) | (((L << 1) & _M32) >> (es + 2)))
    # the arithmetic shift of the 32-bit word w (sign bit 31)
    pat = ((w - ((w >> 31) << 32)) >> m) & _M32
    base = pat >> (33 - n)
    g = (pat >> (32 - n)) & 1
    st = ((w << (n - m)) & _M32) != 0
    return base + (g & (st.to(torch.int64) | base))


def encode_fast_plain(values, fmt: PositFormat):
    """K2's compile-time 32-bit encoder (`posit_encode_fast` of
    csrc/posit.cuh) in plain PyTorch: float values -> int64 codes (low n
    bits), bit for bit `posit.encode`."""
    bits = values.to(torch.float32).contiguous().view(torch.int32) \
        .to(torch.int64) & _M32
    exp8 = (bits >> 23) & 0xFF
    code = round_abs_plain(exp8 - 127, 0x80000000 | ((bits << 8) & _M32), fmt)
    code = torch.where((bits >> 31) == 1, (-code) & fmt.mask, code)
    code = torch.where(((bits << 1) & _M32) == 0, 0, code)
    return torch.where(exp8 == 0xFF, fmt.nar_code, code)


def rounding_boundaries(fmt: PositFormat):
    """The positive f32 values where the encode's rounding turns from code
    c to c + 1 (1 <= c < maxpos): the pattern c followed by a one, i.e.
    the value of the P(n + 1, es) code 2c + 1 (exact in f32 for n <= 16).
    A boundary rounds to the even code; the f32 values either side of it
    round down and up."""
    n, es = fmt.n + 1, fmt.es
    x = 2 * torch.arange(1, fmt.maxpos_code, dtype=torch.int64) + 1
    body = (x << (32 - n)) & 0x7FFFFFFF       # the regime from bit 30
    r0 = (body >> 30) & 1
    inv = torch.where(r0 == 1, ~body, body) & 0x7FFFFFFF
    m = torch.clamp(31 - posit.bit_length32(inv), max=n - 1)
    k = torch.where(r0 == 1, m - 1, -m)
    rem = (body << (m + 1)) & 0x7FFFFFFF
    fb = n - 3 - es
    mant = ((rem << es) & 0x7FFFFFFF) >> (31 - fb)
    bits = ((k * (1 << es) + (rem >> (31 - es)) + 127) << 23) \
        | (mant << (23 - fb))
    return bits.to(torch.int32).view(torch.float32)


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
        variant, vid = _variant(fmt, codes.dtype)
        keys = ("posit_decode", f"posit_decode:{variant}")
        if work.is_meta(codes):
            work.record(keys, work.decode(codes.numel(),
                                          codes.element_size()))
            return out
        lib = _build.library("posit_codec")
        _build.check(lib.posit_decode_launch(
            codes.data_ptr(), out.data_ptr(), codes.numel(),
            codes.element_size(), fmt.n, fmt.es, vid,
            _build.stream_of(codes)), "posit_decode")
        work.count(LAUNCHES, keys)
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
        variant, vid = _variant(fmt, dtype)
        keys = ("posit_encode", f"posit_encode:{variant}")
        if work.is_meta(values):
            work.record(keys, work.encode(values.numel(), out.element_size()))
            return out
        lib = _build.library("posit_codec")
        _build.check(lib.posit_encode_launch(
            values.data_ptr(), out.data_ptr(), values.numel(),
            out.element_size(), fmt.n, fmt.es, vid,
            _build.stream_of(values)), "posit_encode")
        work.count(LAUNCHES, keys)
    return out
