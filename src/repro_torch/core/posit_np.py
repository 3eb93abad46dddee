"""Vectorized posit codec on numpy int64 — the fast host-side reference
(the PyTorch port's copy of `repro.core.posit_np`, kept in step with it:
importing that package would import JAX).

Bridges posit codes <-> float64 exactly (posit fractions are <= 27 bits and
scales are far inside the f64 exponent range for every supported format),
with correct posit-2022 round-to-nearest-even on encode.

Used by: the discrete-DPU / FMA-cascade accuracy baselines (paper Table I),
the PDPU numpy emulation, and as a second cross-check against the exact
Fraction oracle in tests.
"""
from __future__ import annotations

import numpy as np

from .formats import PDPUConfig, PositFormat

_I64 = np.int64


def _check(fmt: PositFormat):
    if fmt.n > 32:
        raise ValueError("numpy codec supports n <= 32")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_unpacked_np(codes, fmt: PositFormat):
    """codes -> (is_zero, is_nar, sign, scale, frac) with frac in
    [2**fb, 2**(fb+1)) for non-zero values, fb = fmt.frac_bits."""
    _check(fmt)
    n, es = fmt.n, fmt.es
    x = np.asarray(codes).astype(_I64) & fmt.mask
    is_zero = x == 0
    is_nar = x == fmt.nar_code
    sign = (x >> (n - 1)) & 1
    xa = np.where(sign == 1, (-x) & fmt.mask, x)
    # left-align the n-1 bits after the sign at bit 62 of an int64
    body = (xa << (63 - (n - 1))) & ((1 << 63) - 1)
    r0 = (body >> 62) & 1
    inv = np.where(r0 == 1, ~body & ((1 << 63) - 1), body)
    # count leading zeros within the 62..0 window of `inv` (bit 63 is 0)
    lz = 62 - _bit_length(inv) + 1
    m = np.minimum(lz, n - 1)
    k = np.where(r0 == 1, m - 1, -m)
    rem = (body << (m + 1)) & ((1 << 63) - 1)
    e = (rem >> (63 - es)) if es > 0 else np.zeros_like(rem)
    fb = fmt.frac_bits
    if fb > 0:
        mant = ((rem << es) & ((1 << 63) - 1)) >> (63 - fb)
    else:
        mant = np.zeros_like(rem)
    frac = (1 << fb) | mant
    scale = k * (1 << es) + e
    valid = ~(is_zero | is_nar)
    frac = np.where(valid, frac, 0)
    scale = np.where(valid, scale, 0)
    sign = np.where(valid, sign, 0)
    return is_zero, is_nar, sign, scale, frac


def _bit_length(x):
    """Vectorized bit_length for non-negative int64 (0 -> 0)."""
    x = np.asarray(x)
    out = np.zeros(x.shape, dtype=_I64)
    v = x.copy()
    for s in (32, 16, 8, 4, 2, 1):
        ge = v >= (np.int64(1) << s)
        out += np.where(ge, s, 0)
        v = np.where(ge, v >> s, v)
    return out + (x > 0)


def decode_np(codes, fmt: PositFormat):
    """codes -> float64 values (NaR -> nan). Exact."""
    is_zero, is_nar, sign, scale, frac = decode_unpacked_np(codes, fmt)
    fb = fmt.frac_bits
    val = np.ldexp(frac.astype(np.float64), (scale - fb).astype(np.int32))
    val = np.where(sign == 1, -val, val)
    val = np.where(is_zero, 0.0, val)
    val = np.where(is_nar, np.nan, val)
    return val


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def encode_core_np(sign, scale, frac, F: int, sticky, fmt: PositFormat):
    """Round/pack unpacked values into posit codes (posit-2022 RNE).

    frac must be 0 (zero result) or normalized in [2**F, 2**(F+1)).
    ``sticky`` is a boolean array: true iff non-zero bits were already
    dropped strictly below frac's LSB.
    """
    _check(fmt)
    n, es = fmt.n, fmt.es
    sign = np.asarray(sign).astype(_I64)
    scale = np.asarray(scale).astype(_I64)
    frac = np.asarray(frac).astype(_I64)
    sticky = np.asarray(sticky).astype(bool)

    is_zero = frac == 0

    # pre-reduce fraction width so the packed body fits in int64 and the
    # rounding cut always lands inside the kept bits (shift >= 1 below).
    Fp = n - es  # >= n - es - 2 + 2
    if F > Fp:
        drop = F - Fp
        sticky = sticky | ((frac & ((np.int64(1) << drop) - 1)) != 0)
        frac = frac >> drop
    elif F < Fp:
        frac = frac << (Fp - F)

    k = scale >> es  # floor division
    e = scale & ((1 << es) - 1)

    # regime saturation (posit clamps, never overflows to NaR)
    sat_hi = k >= n - 2
    sat_lo = k <= -(n - 1)
    k_c = np.clip(k, -(n - 2), n - 3)
    e = np.where(sat_hi | sat_lo, 0, e)

    rlen = np.where(k_c >= 0, k_c + 2, 1 - k_c)  # incl. terminator
    reg = np.where(k_c >= 0, ((np.int64(1) << (k_c + 1)) - 1) << 1, np.int64(1))
    body_hi = (reg << es) | e
    body = (body_hi << Fp) | (frac & ((np.int64(1) << Fp) - 1))
    total_bits = rlen + es + Fp
    shift = total_bits - (n - 1)  # >= 1 by construction of Fp

    g = (body >> (shift - 1)) & 1
    st = sticky | ((body & ((np.int64(1) << (shift - 1)) - 1)) != 0)
    base = body >> shift
    roundup = (g == 1) & (st | ((base & 1) == 1))
    code_abs = base + roundup

    code_abs = np.where(sat_hi, fmt.maxpos_code, code_abs)
    code_abs = np.where(sat_lo, fmt.minpos_code, code_abs)
    code = np.where(sign == 1, (-code_abs) & fmt.mask, code_abs)
    code = np.where(is_zero, 0, code)
    return code.astype(_I64)


def encode_np(values, fmt: PositFormat):
    """float64 -> posit codes with exact RNE (nan/inf -> NaR)."""
    v = np.asarray(values, dtype=np.float64)
    is_nar = ~np.isfinite(v)
    v = np.where(is_nar, 0.0, v)
    sign = (np.signbit(v)).astype(_I64)
    mant, exp = np.frexp(np.abs(v))  # mant in [0.5, 1)
    frac = np.round(mant * (1 << 53)).astype(_I64)  # exact: f64 has 53 bits
    # normalize to [2**52, 2**53): frexp mant >= 0.5 so frac in [2**52, 2**53]
    over = frac == (1 << 53)
    frac = np.where(over, frac >> 1, frac)
    exp = np.where(over, exp + 1, exp)
    scale = exp.astype(_I64) - 1
    code = encode_core_np(sign, scale, frac, 52, np.zeros(v.shape, bool), fmt)
    code = np.where(is_nar, fmt.nar_code, code)
    return code


def quantize_np(values, fmt: PositFormat):
    """Fake-quantize float64 through the posit format (encode -> decode)."""
    return decode_np(encode_np(values, fmt), fmt)


# ---------------------------------------------------------------------------
# PDPU emulation (paper Fig. 4 datapath), vectorized over leading dims.
# ---------------------------------------------------------------------------

_NEG_INF = np.int64(-(1 << 40))


def pdpu_dot_np(va_codes, vb_codes, acc_codes, cfg: PDPUConfig):
    """out = PDPU(acc, Va, Vb) — bit-faithful staged emulation.

    va_codes, vb_codes: int arrays [..., N]; acc_codes: [...].
    Returns posit codes [...] in cfg.fmt_out.

    w_m >= 60 routes to the quire path (float64 exact-accumulate + single
    rounding); narrower w_m runs the S1..S6 integer datapath bit-exactly.
    """
    fi, fo, w_m = cfg.fmt_in, cfg.fmt_out, cfg.w_m
    va_codes = np.asarray(va_codes)
    vb_codes = np.asarray(vb_codes)
    acc_codes = np.asarray(acc_codes)

    # integer path needs 2*W - 1 <= 62 bits (see S6); wider w_m is
    # numerically indistinguishable from quire for any fmt_out <= 16 bits.
    W_chk = w_m + cfg.guard_bits + int(np.ceil(np.log2(cfg.N + 1))) + 2
    if 2 * W_chk - 1 > 62:
        a = decode_np(va_codes, fi)
        b = decode_np(vb_codes, fi)
        c = decode_np(acc_codes, fo)
        total = c + np.sum(a * b, axis=-1)
        return encode_np(total, fo)

    # S1: decode
    za, na, sa, ea, fa = decode_unpacked_np(va_codes, fi)
    zb, nb, sb, eb, fb_ = decode_unpacked_np(vb_codes, fi)
    zc, nc, sc, ec, fc = decode_unpacked_np(acc_codes, fo)
    any_nar = np.any(na | nb, axis=-1) | nc

    fbi, fbo = fi.frac_bits, fo.frac_bits
    # S2: exact mantissa products + product exponents
    prod = fa * fb_  # [..., N], 2*fbi fraction bits, value in [1, 4)
    s_ab = sa ^ sb
    e_ab = np.where(za | zb, _NEG_INF, ea + eb)
    e_c = np.where(zc, _NEG_INF, ec)
    # comparator tree
    e_max = np.maximum(np.max(e_ab, axis=-1), e_c)

    all_zero = e_max == _NEG_INF
    e_max_s = np.where(all_zero, 0, e_max)  # safe for shifts

    # S3: align into the w_m window (LSB weight 2**(e_max + 2 - w_m)) with
    # `G` guard bits kept below it; shifted-out bits optionally OR into a
    # sticky LSB (cfg.sticky) — otherwise plain truncation, as plain
    # arithmetic shifters would do.
    G = cfg.guard_bits
    lsb_w = e_max_s + 2 - w_m

    def _align(frac, e, fb):
        sh = (e - fb) - (lsb_w[..., None] if frac.ndim > lsb_w.ndim else lsb_w) + G
        sh = np.where(e == _NEG_INF, -63, sh)
        sh = np.clip(sh, -63, 62)
        left = np.where(sh >= 0, frac << np.maximum(sh, 0), 0)
        right_sh = np.minimum(-sh, 63)
        right = np.where(sh < 0, frac >> right_sh, 0)
        out = np.where(sh >= 0, left, right)
        if cfg.sticky:
            dropped = np.where(sh < 0,
                               frac & ((np.int64(1) << right_sh) - 1), 0)
            out = out | (dropped != 0).astype(_I64)
        return out

    t = _align(prod, e_ab, 2 * fbi)
    t = np.where(s_ab == 1, -t, t)
    tc = _align(fc, e_c, fbo)
    tc = np.where(sc == 1, -tc, tc)

    # S4: accumulate (int64 add == CSA tree result, bit-exact)
    ssum = np.sum(t, axis=-1) + tc

    f_s = (ssum < 0).astype(_I64)
    sm = np.abs(ssum)
    # S5: normalize
    p = _bit_length(sm) - 1
    p = np.maximum(p, 0)
    f_scale = (e_max_s + 2 - w_m - G) + p

    # S6: encode — value = sm * 2**(f_scale - p); per-element F varies, so
    # renormalize every sm to a common width W then encode once.
    W = w_m + G + int(np.ceil(np.log2(cfg.N + 1))) + 2
    frac_n = sm << (W - p).astype(_I64)  # p <= W-1 by construction
    code = encode_core_np(f_s, f_scale, frac_n, W, np.zeros(sm.shape, bool), fo)
    code = np.where(all_zero | (sm == 0), 0, code)
    code = np.where(any_nar, fo.nar_code, code)
    return code


def pdpu_chunked_dot_np(a_codes, b_codes, cfg: PDPUConfig, acc_codes=None):
    """Long dot product via chunk-size-N PDPU accumulation (paper §III-C).

    a_codes, b_codes: [..., K] with K % N == 0. Sequential chunk
    accumulation through the fmt_out accumulator, exactly as a hardware
    PDPU would process a DNN dot product.
    """
    a_codes = np.asarray(a_codes)
    K = a_codes.shape[-1]
    N = cfg.N
    if K % N != 0:
        raise ValueError(f"dot length {K} not divisible by chunk size {N}")
    if acc_codes is None:
        acc = np.zeros(a_codes.shape[:-1], dtype=_I64)
    else:
        acc = np.asarray(acc_codes).astype(_I64)
    for j in range(K // N):
        sl = slice(j * N, (j + 1) * N)
        acc = pdpu_dot_np(a_codes[..., sl], b_codes[..., sl], acc, cfg)
    return acc
