"""Posit codec in plain PyTorch (int64 datapath with explicit masks).

Bit-for-bit the codec of `repro.core.posit`: the same decode (codes ->
exact f32) and the same pattern round-to-nearest-even encode, written on
int64 tensors.  The JAX module runs its datapath in uint32; PyTorch has
no shifts, comparisons or subtraction on uint32 on the CPU, so every step
here works on int64 and masks to 31 or 32 bits where uint32 would wrap.
f32 values are built from their bit pattern with `.view(torch.float32)`,
never by multiplication.

Supports n <= 16 (the paper's design space): every P(n<=16, es) value has
at most 14 significand bits and |scale| <= 120, so decode into f32 is
exact.  These functions are the plain versions the codec kernels
(`repro_torch.kernels.posit_codec`) are held against, and they run on any
device.  Large inputs are processed in slices of `_SLICE` elements so the
int64 temporaries stay bounded.
"""
from __future__ import annotations

import torch

from .formats import PositFormat

_I64 = torch.int64
_M31 = 0x7FFFFFFF
_SLICE = 1 << 24
_STORAGE = {8: torch.int8, 16: torch.int16, 32: torch.int32}


def _check_fmt(fmt: PositFormat):
    if fmt.n > 16:
        raise ValueError("posit codec supports n <= 16 (exact f32 bridge)")
    if fmt.max_scale > 120:
        raise ValueError("format scale range exceeds the exact float32 bridge")


def storage_dtype(fmt: PositFormat) -> torch.dtype:
    """Narrowest integer container for fmt's codes."""
    return _STORAGE[fmt.storage_bits]


def bit_length32(x):
    """Vectorized bit_length for non-negative values below 2**32 (0 -> 0),
    as the select-chain binary search of the JAX codec."""
    v = x.to(_I64)
    out = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        ge = v >= (1 << s)
        out = out + ge.to(_I64) * s
        v = torch.where(ge, v >> s, v)
    return out + (x != 0).to(_I64)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_unpacked(codes, fmt: PositFormat):
    """codes -> (is_zero, is_nar, sign, scale, frac); frac in
    [2**fb, 2**(fb+1)) for finite non-zero values, fb = fmt.frac_bits.

    Outputs int64 (flags bool).  NaR/zero entries return sign=scale=frac=0.
    """
    _check_fmt(fmt)
    n, es = fmt.n, fmt.es
    x = codes.to(_I64) & fmt.mask
    is_zero = x == 0
    is_nar = x == fmt.nar_code
    sign = (x >> (n - 1)) & 1
    xa = torch.where(sign == 1, (-x) & fmt.mask, x)
    # left-align the n-1 post-sign bits so the first regime bit sits at bit 30
    body = (xa << (32 - n)) & _M31
    r0 = (body >> 30) & 1
    inv = torch.where(r0 == 1, ~body, body) & _M31
    lz = 31 - bit_length32(inv)  # leading run length from bit 30
    m = torch.clamp(lz, max=n - 1)
    k = torch.where(r0 == 1, m - 1, -m)
    rem = (body << (m + 1)) & _M31
    if es > 0:
        e = rem >> (31 - es)
    else:
        e = torch.zeros_like(k)
    fb = fmt.frac_bits
    if fb > 0:
        mant = ((rem << es) & _M31) >> (31 - fb)
    else:
        mant = torch.zeros_like(k)
    frac = (1 << fb) | mant
    scale = k * (1 << es) + e
    valid = ~(is_zero | is_nar)
    zero = torch.zeros_like(k)
    return (is_zero, is_nar, torch.where(valid, sign, zero),
            torch.where(valid, scale, zero), torch.where(valid, frac, zero))


def _to_int32_bits(bits):
    """int64 holding a 32-bit pattern -> int32 with the same bits."""
    return torch.where(bits >= (1 << 31), bits - (1 << 32), bits).to(torch.int32)


def _decode_flat(codes, fmt: PositFormat):
    is_zero, is_nar, sign, scale, frac = decode_unpacked(codes, fmt)
    fb = fmt.frac_bits
    exp_f = torch.where(is_zero | is_nar, torch.zeros_like(scale), scale + 127)
    mant23 = (frac & ((1 << fb) - 1)) << (23 - fb)
    bits = (sign << 31) | (exp_f << 23) | mant23
    val = _to_int32_bits(bits).view(torch.float32)
    val = torch.where(is_zero, torch.zeros_like(val), val)
    return torch.where(is_nar, torch.full_like(val, float("nan")), val)


def _sliced(fn, x, out_dtype):
    """Apply an elementwise fn over x in bounded slices."""
    flat = x.reshape(-1)
    if flat.numel() <= _SLICE:
        return fn(flat).reshape(x.shape)
    out = torch.empty(flat.shape, dtype=out_dtype, device=x.device)
    for lo in range(0, flat.numel(), _SLICE):
        out[lo:lo + _SLICE] = fn(flat[lo:lo + _SLICE])
    return out.reshape(x.shape)


def decode(codes, fmt: PositFormat, dtype=torch.float32):
    """codes -> float values.  Exact for n <= 16 into f32 (NaR -> nan)."""
    _check_fmt(fmt)
    return _sliced(lambda c: _decode_flat(c, fmt), codes,
                   torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def encode_core(sign, scale, frac, F, sticky, fmt: PositFormat):
    """Round/pack unpacked values into posit codes (posit-2022 pattern RNE).

    sign/scale/frac: integer tensors.  frac must be 0 (-> code 0) or
    normalized in [2**F, 2**(F+1)).  F is a python int or a per-element
    integer tensor.  ``sticky`` marks non-zero bits already discarded
    strictly below frac's LSB.  Returns int64 codes (low n bits valid).
    """
    _check_fmt(fmt)
    n, es = fmt.n, fmt.es
    sign, scale, frac = sign.to(_I64), scale.to(_I64), frac.to(_I64)
    is_zero = frac == 0

    # normalize the fraction register to Fp = n - es fraction bits; with
    # the minimum regime length 2 the final rounding cut lands at shift >= 1
    Fp = n - es
    F = torch.as_tensor(F, dtype=_I64, device=frac.device)
    drop = torch.clamp(F - Fp, 0, 31)
    up = torch.clamp(Fp - F, 0, 31)
    sticky = torch.as_tensor(sticky, dtype=torch.bool, device=frac.device) \
        | ((frac & ((torch.ones_like(drop) << drop) - 1)) != 0)
    frac = (frac >> drop) << up

    k = scale >> es  # arithmetic shift = floor division
    e = scale & ((1 << es) - 1) if es > 0 else torch.zeros_like(scale)

    sat_hi = k >= n - 2
    sat_lo = k <= -(n - 1)
    k_c = torch.clamp(k, -(n - 2), n - 3)
    e = torch.where(sat_hi | sat_lo, torch.zeros_like(e), e)

    one = torch.ones_like(k_c)
    rlen = torch.where(k_c >= 0, k_c + 2, 1 - k_c)
    reg = torch.where(k_c >= 0, ((one << (k_c + 1)) - 1) << 1, one)
    body_hi = (reg << es) | e
    body = (body_hi << Fp) | (frac & ((1 << Fp) - 1))
    shift = rlen + es + Fp - (n - 1)  # >= 1 by construction

    g = (body >> (shift - 1)) & 1
    st = sticky | ((body & ((one << (shift - 1)) - 1)) != 0)
    base = body >> shift
    roundup = ((g == 1) & (st | ((base & 1) == 1))).to(_I64)
    code_abs = base + roundup

    code_abs = torch.where(sat_hi, torch.full_like(code_abs, fmt.maxpos_code),
                           code_abs)
    code_abs = torch.where(sat_lo, torch.full_like(code_abs, fmt.minpos_code),
                           code_abs)
    code = torch.where(sign == 1, (-code_abs) & fmt.mask, code_abs)
    return torch.where(is_zero, torch.zeros_like(code), code)


def _encode_flat(values, fmt: PositFormat):
    bits = values.to(torch.float32).contiguous().view(torch.int32).to(_I64)
    sign = (bits >> 31) & 1
    exp8 = (bits >> 23) & 0xFF
    mant = bits & 0x7FFFFF
    is_nar = exp8 == 255  # inf / nan
    is_zero = (exp8 == 0) & (mant == 0)
    subnormal = (exp8 == 0) & (mant != 0)
    scale = torch.where(subnormal, torch.full_like(exp8, -130), exp8 - 127)
    frac = torch.where(is_zero, torch.zeros_like(mant), (1 << 23) | mant)
    code = encode_core(sign, scale, frac, 23, torch.zeros_like(is_zero), fmt)
    return torch.where(is_nar, torch.full_like(code, fmt.nar_code), code)


def encode(values, fmt: PositFormat):
    """float (f32/bf16/f16) -> posit codes (int64; low n bits valid).

    Exact pattern-RNE from the float value (nan/inf -> NaR).  f32
    subnormals sit far below minpos of every supported format and saturate
    to minpos via a forced out-of-range scale."""
    _check_fmt(fmt)
    return _sliced(lambda v: _encode_flat(v, fmt), values, _I64)


# ---------------------------------------------------------------------------
# storage + quantization helpers
# ---------------------------------------------------------------------------

def to_container(code, fmt: PositFormat):
    """int64 codes (low n bits valid) -> the storage container, wrapping
    like a two's-complement cast."""
    w = fmt.storage_bits
    half = 1 << (w - 1)
    return (((code + half) & ((1 << w) - 1)) - half).to(_STORAGE[w])


def pack(values, fmt: PositFormat):
    """float -> posit codes in the narrowest container dtype (int8/int16)."""
    return _sliced(lambda v: to_container(_encode_flat(v, fmt), fmt),
                   values, storage_dtype(fmt))


def unpack(codes, fmt: PositFormat, dtype=torch.float32):
    """posit codes (any int container) -> float values."""
    return decode(codes, fmt, dtype=dtype)


def quantize(x, fmt: PositFormat):
    """Fake-quantization (encode -> decode) in x's dtype."""
    return unpack(encode(x, fmt), fmt, dtype=x.dtype)

