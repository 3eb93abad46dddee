"""Posit format descriptors shared by every codec implementation.

A posit format P(n, es) is fully described by its word size ``n`` and
exponent size ``es`` (posit-2017 generalized; posit-2022 fixes es=2).
All codec layers of the PyTorch port (plain torch, CUDA kernels) consume
this one descriptor.  It is a copy of `repro.core.formats`, kept in step
with it: importing that module would import JAX.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PositFormat:
    """P(n, es) descriptor with derived constants."""

    n: int
    es: int = 2

    def __post_init__(self):
        if not (2 <= self.n <= 32):
            raise ValueError(f"posit word size n={self.n} out of supported range [2, 32]")
        if not (0 <= self.es <= 4):
            raise ValueError(f"posit exponent size es={self.es} out of supported range [0, 4]")

    # ---- derived constants -------------------------------------------------
    @property
    def useed_log2(self) -> int:
        """log2(useed) = 2**es."""
        return 1 << self.es

    @property
    def mask(self) -> int:
        return (1 << self.n) - 1

    @property
    def sign_mask(self) -> int:
        return 1 << (self.n - 1)

    @property
    def nar_code(self) -> int:
        return 1 << (self.n - 1)

    @property
    def maxpos_code(self) -> int:
        return (1 << (self.n - 1)) - 1

    @property
    def minpos_code(self) -> int:
        return 1

    @property
    def max_scale(self) -> int:
        """scale of maxpos = (n-2) * 2**es."""
        return (self.n - 2) << self.es

    @property
    def min_scale(self) -> int:
        return -self.max_scale

    @property
    def frac_bits(self) -> int:
        """Fraction bits available with the shortest (2-bit) regime.

        Every decoded posit's significand fits in 1 + frac_bits bits; fewer
        bits are available for longer regimes but the decoder zero-pads, so
        a fixed-width fraction register of this width is exact.
        """
        return max(self.n - 3 - self.es, 0)

    @property
    def storage_bits(self) -> int:
        """Smallest power-of-two container width."""
        for w in (8, 16, 32):
            if self.n <= w:
                return w
        return 64

    def __str__(self) -> str:  # matches the paper's P(n,es) notation
        return f"P({self.n},{self.es})"


# The formats the paper uses in Table I, importable by name.
P16_2 = PositFormat(16, 2)
P16_1 = PositFormat(16, 1)   # paged-KV storage format (serving runtime)
P13_2 = PositFormat(13, 2)
P10_2 = PositFormat(10, 2)
P8_2 = PositFormat(8, 2)
P8_1 = PositFormat(8, 1)
P8_0 = PositFormat(8, 0)


@dataclasses.dataclass(frozen=True)
class PDPUConfig:
    """Configuration of one PDPU instance — mirrors the paper's generator.

    ``fmt_in``  : posit format of the input vectors Va, Vb.
    ``fmt_out`` : posit format of ``acc`` and ``out`` (mixed precision when
                  different from fmt_in; the paper's P(13/16,2) notation).
    ``N``       : dot-product chunk size (number of parallel products).
    ``w_m``     : alignment width — the bit width the aligned product
                  mantissas are truncated to before the CSA accumulation.
                  Larger w_m -> closer to quire-exact; the paper's fidelity
                  vs hardware-cost knob (Table I uses 10 / 14 / 256).
    ``guard_bits`` / ``sticky`` : alignment shifter keeps `guard_bits`
                  extra low-order bits plus an OR-reduction (sticky) of all
                  shifted-out bits — standard FP-datapath rounding support.
                  The paper does not specify its shifter's rounding plumbing;
                  with guard+sticky on (default) the fused unit beats the
                  per-op-rounded discrete DPU on accuracy, matching the
                  paper's Table I ordering (see benchmarks/bench_table1.py).
                  Set guard_bits=0, sticky=False for plain truncation.
    """

    fmt_in: PositFormat
    fmt_out: PositFormat
    N: int = 4
    w_m: int = 14
    guard_bits: int = 2
    sticky: bool = True

    def __post_init__(self):
        if self.fmt_in.es != self.fmt_out.es:
            # the paper keeps es identical across mixed-precision in/out
            raise ValueError("PDPU mixed precision requires matching es for in/out formats")
        if self.N < 1:
            raise ValueError("dot-product size N must be >= 1")
        if self.w_m < 4:
            raise ValueError("alignment width w_m must be >= 4")

    @property
    def name(self) -> str:
        if self.fmt_in.n == self.fmt_out.n:
            return f"P({self.fmt_in.n}/{self.fmt_out.n},{self.fmt_in.es}) N={self.N} Wm={self.w_m}"
        return f"P({self.fmt_in.n}/{self.fmt_out.n},{self.fmt_in.es}) N={self.N} Wm={self.w_m}"


# Table I configurations of the proposed PDPU.
PDPU_P16_16_N4_W14 = PDPUConfig(P16_2, P16_2, N=4, w_m=14)
PDPU_P13_16_N4_W14 = PDPUConfig(P13_2, P16_2, N=4, w_m=14)
PDPU_P13_16_N8_W14 = PDPUConfig(P13_2, P16_2, N=8, w_m=14)
PDPU_P10_16_N8_W14 = PDPUConfig(P10_2, P16_2, N=8, w_m=14)
PDPU_P13_16_N8_W10 = PDPUConfig(P13_2, P16_2, N=8, w_m=10)
PDPU_QUIRE_P13_16_N4 = PDPUConfig(P13_2, P16_2, N=4, w_m=256)
