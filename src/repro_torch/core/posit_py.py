"""Exact posit arithmetic oracle (pure Python, Fraction-based; the
PyTorch port's copy of `repro.core.posit_py`, kept in step with it:
importing that package would import JAX).

Ground truth for every other implementation in the repo.  Values are exact
``fractions.Fraction``; rounding is done by nearest-candidate search over the
full code table, which is trivially correct by construction (posit-2022
round-to-nearest, ties to even code, clamp to maxpos / minpos, never
underflow a non-zero value to zero).

Scope: small word sizes (table is O(2^n)); used by tests and the paper's
accuracy benchmarks, never on the hot path.
"""
from __future__ import annotations

import functools
from fractions import Fraction
from typing import Optional, Sequence

from .formats import PositFormat

NAR = None  # decode result for the Not-a-Real pattern


def decode_exact(code: int, fmt: PositFormat) -> Optional[Fraction]:
    """Decode an n-bit posit code to its exact value (None for NaR)."""
    n, es = fmt.n, fmt.es
    code &= fmt.mask
    if code == 0:
        return Fraction(0)
    if code == fmt.nar_code:
        return NAR
    sign = (code >> (n - 1)) & 1
    body = ((-code) & fmt.mask) if sign else code
    # bits after the sign, MSB first
    bits = [(body >> i) & 1 for i in range(n - 2, -1, -1)]
    r0 = bits[0]
    m = 0
    while m < len(bits) and bits[m] == r0:
        m += 1
    k = (m - 1) if r0 else -m
    rest = bits[m + 1:]  # skip terminator (may be absent if regime fills)
    e_bits = rest[:es]
    e_bits += [0] * (es - len(e_bits))  # truncated exponent bits read as 0
    e = 0
    for b in e_bits:
        e = (e << 1) | b
    f_bits = rest[es:]
    frac = Fraction(1)
    for i, b in enumerate(f_bits):
        if b:
            frac += Fraction(1, 1 << (i + 1))
    scale = k * (1 << es) + e
    value = frac * (Fraction(2) ** scale)
    return -value if sign else value


@functools.lru_cache(maxsize=8)
def _positive_table(fmt: PositFormat):
    """Sorted list of (value, code) for all strictly positive codes."""
    table = []
    for code in range(1, fmt.maxpos_code + 1):
        v = decode_exact(code, fmt)
        table.append((v, code))
    table.sort()
    return table


def encode_exact(value, fmt: PositFormat) -> int:
    """Round an exact real (Fraction/int/float) to a posit code.

    Posit-2022 semantics: round-to-nearest-even **in pattern space** (the
    bit string is extended with the exact remaining bits and RNE'd at n
    bits), which is what hardware and SoftPosit implement.  In the
    regime/exponent-dominated gaps this differs from linear nearest-value
    rounding.  |v| >= maxpos clamps to maxpos; 0 < |v| <= minpos rounds to
    minpos (no underflow to zero, no overflow to NaR).

    Exact pattern midpoints: the pattern halfway between consecutive
    positive codes c and c+1 of P(n,es) is precisely the value of code
    2c+1 in P(n+1,es) — that equivalence gives exact RNE with Fractions.
    """
    if value is NAR:
        return fmt.nar_code
    v = Fraction(value)
    if v == 0:
        return 0
    neg = v < 0
    a = -v if neg else v
    table = _positive_table(fmt)
    lo, hi = 0, len(table) - 1
    if a >= table[hi][0]:
        code = table[hi][1]  # clamp to maxpos
    elif a <= table[lo][0]:
        code = table[lo][1]  # clamp to minpos
    else:
        # binary search: largest code with value <= a (codes are monotonic)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if table[mid][0] <= a:
                lo = mid
            else:
                hi = mid
        vlo, base = table[lo]
        if a == vlo:
            code = base
        else:
            ext = PositFormat(fmt.n + 1, fmt.es)
            vmid = decode_exact(2 * base + 1, ext)
            if a > vmid:
                code = base + 1
            elif a < vmid:
                code = base
            else:  # exact pattern tie: even code (LSB == 0)
                code = base if (base & 1) == 0 else base + 1
    if neg:
        code = (-code) & fmt.mask
    return code


def to_float(code: int, fmt: PositFormat) -> float:
    v = decode_exact(code, fmt)
    return float("nan") if v is NAR else float(v)


def from_float(x: float, fmt: PositFormat) -> int:
    if x != x or x in (float("inf"), float("-inf")):
        return fmt.nar_code
    return encode_exact(Fraction(x), fmt)


# ---------------------------------------------------------------------------
# Exact (quire-style) fused dot product: the ideal PDPU with w_m = infinity.
# ---------------------------------------------------------------------------

def quire_dot_exact(
    va: Sequence[int],
    vb: Sequence[int],
    acc: int,
    fmt_in: PositFormat,
    fmt_out: PositFormat,
) -> int:
    """out = round_{fmt_out}( acc + sum_i va_i * vb_i ), exactly one rounding.

    This is the quire semantics: the entire dot product is exact; the single
    rounding happens at the final encode.  Any NaR input poisons the output.
    """
    total = decode_exact(acc, fmt_out)
    if total is NAR:
        return fmt_out.nar_code
    for ca, cb in zip(va, vb):
        a = decode_exact(ca, fmt_in)
        b = decode_exact(cb, fmt_in)
        if a is NAR or b is NAR:
            return fmt_out.nar_code
        total += a * b
    return encode_exact(total, fmt_out)


# ---------------------------------------------------------------------------
# Bit-faithful staged PDPU model (paper Fig. 4, S1..S6) with finite w_m.
# Independent Python-int re-derivation of the hardware datapath, used to
# cross-validate the vectorized JAX emulation bit for bit.
# ---------------------------------------------------------------------------

def pdpu_dot_model(
    va: Sequence[int],
    vb: Sequence[int],
    acc: int,
    fmt_in: PositFormat,
    fmt_out: PositFormat,
    w_m: int,
    guard_bits: int = 2,
    sticky: bool = True,
) -> int:
    n_terms = len(va)
    assert len(vb) == n_terms

    def _dec(code, fmt):
        """-> (is_zero, is_nar, sign, scale, frac_int, frac_bits)."""
        code &= fmt.mask
        if code == 0:
            return True, False, 0, 0, 0, fmt.frac_bits
        if code == fmt.nar_code:
            return False, True, 0, 0, 0, fmt.frac_bits
        v = decode_exact(code, fmt)
        sign = 1 if v < 0 else 0
        a = -v if sign else v
        # a = frac * 2**scale with frac in [1, 2); extract integer mantissa
        scale = 0
        while a >= 2:
            a /= 2
            scale += 1
        while a < 1:
            a *= 2
            scale -= 1
        fb = fmt.frac_bits
        frac = a * (1 << fb)
        assert frac.denominator == 1, "posit fraction wider than frac_bits?"
        return False, False, sign, scale, int(frac), fb

    NEG_INF = -(1 << 30)

    # S1: decode
    terms = []
    any_nar = False
    for ca, cb in zip(va, vb):
        za, na, sa, ea, fa, fba = _dec(ca, fmt_in)
        zb, nb, sb, eb, fb_, fbb = _dec(cb, fmt_in)
        any_nar |= na or nb
        if za or zb:
            terms.append((0, NEG_INF, 0, fba + fbb))
        else:
            # S2: exact integer mantissa product (2 int bits, fba+fbb frac bits)
            terms.append((sa ^ sb, ea + eb, fa * fb_, fba + fbb))
    zc, nc, sc, ec, fc, fbc = _dec(acc, fmt_out)
    any_nar |= nc
    if any_nar:
        return fmt_out.nar_code
    terms.append((sc, ec if not zc else NEG_INF, fc if not zc else 0, fbc))

    # S2b: comparator tree
    e_max = max(t[1] for t in terms)
    if e_max == NEG_INF:
        return 0  # everything zero

    # S3: align into a w_m-wide window (+ guard_bits kept below, shifted-out
    # bits optionally ORed into a sticky LSB); MSB of the window sits at
    # weight 2**(e_max + 1) (products reach [1,4)).
    G = guard_bits
    ssum = 0
    for sign, e, frac, fb in terms:
        if e == NEG_INF:
            continue
        # frac has fb fraction bits; its value is frac * 2**(e - fb).
        # Window LSB weight: 2**(e_max + 1 - (w_m - 1)) = 2**(e_max + 2 - w_m)
        lsb_w = e_max + 2 - w_m
        shift = (e - fb) - lsb_w + G
        if shift >= 0:
            aligned = frac << shift
        else:
            aligned = frac >> -shift
            if sticky and (frac & ((1 << -shift) - 1)):
                aligned |= 1
        ssum += -aligned if sign else aligned  # S4: two's complement CSA + add

    if ssum == 0:
        return 0
    f_s = 1 if ssum < 0 else 0
    sm = -ssum if f_s else ssum

    # S5: normalize — value = sm * 2**(e_max + 2 - w_m - G)
    p = sm.bit_length() - 1
    f_scale = (e_max + 2 - w_m - G) + p

    # S6: round to fmt_out (RNE on the exact remaining bits) and pack.
    # value = (-1)**f_s * (sm / 2**p) * 2**f_scale, significand in [1, 2).
    mag = Fraction(sm, 1 << p) * (Fraction(2) ** f_scale)
    return encode_exact(-mag if f_s else mag, fmt_out)
