"""Discrete dot-product baselines the paper compares against (Fig. 1; the
PyTorch port's copy of `repro.core.discrete`, kept in step with it:
importing that package would import JAX).

All baselines are *semantic emulations* on numpy float64: every value that a
real discrete unit would round into its storage format gets rounded at the
same place in the dataflow.  float64 carries >= 53 significand bits, far
beyond any posit/FP16 target here, so each individual rounding is exact for
accuracy-statistics purposes.

  - discrete DPU  (Fig. 1a): multipliers + adder tree, every intermediate
    packed/rounded to the unit format (PACoGen-style for posit, FPnew-style
    for IEEE floats).
  - FMA cascade   (Fig. 1b): sequential fused multiply-add, one rounding per
    MAC step.
  - fused PDPU    : `posit_np.pdpu_chunked_dot_np` (W_m-aligned, one
    rounding per chunk boundary) — the paper's proposal.
  - quire         : exact accumulate + single rounding (W_m = inf limit).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .formats import PDPUConfig, PositFormat
from . import posit_np as pnp

RoundFn = Callable[[np.ndarray], np.ndarray]


# ---------------------------------------------------------------------------
# rounding functions (storage formats)
# ---------------------------------------------------------------------------

def round_fp64(x):
    return np.asarray(x, dtype=np.float64)


def round_fp32(x):
    return np.asarray(x, dtype=np.float64).astype(np.float32).astype(np.float64)


def round_fp16(x):
    return np.asarray(x, dtype=np.float64).astype(np.float16).astype(np.float64)


def make_round_posit(fmt: PositFormat) -> RoundFn:
    def _r(x):
        return pnp.quantize_np(np.asarray(x, dtype=np.float64), fmt)

    return _r


# ---------------------------------------------------------------------------
# discrete architectures (operate on float64 values along the last axis)
# ---------------------------------------------------------------------------

def dpu_discrete(a, b, N: int, rnd: RoundFn, acc=None):
    """Fig. 1(a): per chunk of N — round each product, reduce through a
    balanced adder tree with a rounding after every add, then fold into the
    running accumulator (also rounded)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    K = a.shape[-1]
    if K % N:
        raise ValueError(f"K={K} not divisible by N={N}")
    acc = np.zeros(a.shape[:-1]) if acc is None else np.asarray(acc, np.float64)
    a = rnd(a)
    b = rnd(b)
    for j in range(K // N):
        sl = slice(j * N, (j + 1) * N)
        terms = [rnd(a[..., i] * b[..., i]) for i in range(sl.start, sl.stop)]
        while len(terms) > 1:  # balanced adder tree, rounding per node
            nxt = []
            for i in range(0, len(terms) - 1, 2):
                nxt.append(rnd(terms[i] + terms[i + 1]))
            if len(terms) % 2:
                nxt.append(terms[-1])
            terms = nxt
        acc = rnd(acc + terms[0])
    return acc


def dpu_fma_cascade(a, b, rnd: RoundFn, acc=None):
    """Fig. 1(b): cascaded FMA units — exact product+add fused, one rounding
    per MAC step."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    acc = np.zeros(a.shape[:-1]) if acc is None else np.asarray(acc, np.float64)
    a = rnd(a)
    b = rnd(b)
    for i in range(a.shape[-1]):
        acc = rnd(acc + a[..., i] * b[..., i])
    return acc


def dpu_pdpu_fused(a, b, cfg: PDPUConfig, acc=None):
    """The paper's PDPU: quantize inputs to fmt_in, run the bit-faithful
    chunked fused datapath, return float64 values of the fmt_out codes."""
    a_codes = pnp.encode_np(np.asarray(a, np.float64), cfg.fmt_in)
    b_codes = pnp.encode_np(np.asarray(b, np.float64), cfg.fmt_in)
    acc_codes = None
    if acc is not None:
        acc_codes = pnp.encode_np(np.asarray(acc, np.float64), cfg.fmt_out)
    out = pnp.pdpu_chunked_dot_np(a_codes, b_codes, cfg, acc_codes)
    return pnp.decode_np(out, cfg.fmt_out)


def dpu_quire(a, b, fmt_in: PositFormat, fmt_out: PositFormat, acc=None):
    """Quire-exact reference: inputs posit-quantized, accumulation exact,
    single output rounding (the W_m -> inf limit of PDPU)."""
    cfg = PDPUConfig(fmt_in, fmt_out, N=4, w_m=4096)
    return dpu_pdpu_fused(a, b, cfg, acc)


# ---------------------------------------------------------------------------
# accuracy metric (paper Table I "Accuracy" column; formula documented in
# DESIGN.md — the paper does not specify its exact definition)
# ---------------------------------------------------------------------------

def accuracy_pct(y, y_ref, clip: float = 1.0) -> float:
    """100 * (1 - mean(min(|y - y_ref| / |y_ref|, clip))).

    Per-element relative error against the FP64 reference, clipped at
    ``clip`` so sign flips / zero crossings count as (at most) total loss of
    that element rather than an unbounded penalty."""
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    denom = np.abs(y_ref)
    err = np.abs(y - y_ref)
    rel = np.where(denom > 0, err / np.maximum(denom, 1e-300), np.where(err > 0, clip, 0.0))
    rel = np.minimum(rel, clip)
    return float(100.0 * (1.0 - rel.mean()))
