"""Posit GEMM execution-plan dispatch — the one place model matmuls land
(PyTorch port of `repro.kernels.dispatch`).

  plan        datapath in the port
  ----------  ------------------------------------------------------------
  fake_quant  STE fake-quantization (`fake_quantize`: the codec kernels,
              K2 encode then K1 decode) + a plain f32-accumulated dot.
              Weights may be float masters (rounded to the format) or
              packed posit codes (decoded, K1).  The speculative draft
              policy (`QuantPolicy.with_draft`) runs this plan.
  fused       float activations x posit-coded weights: packed codes decode
              exactly through the codec kernel and `torch.matmul`
              accumulates in f32 (as `ops.matmul_posit_weights`).  With
              `QuantPolicy.activations` set (activation-coded serving) the
              activations are encoded (K2) and both code operands go
              through the coded GEMM kernel (`ops.fused_matmul`, K6).
              Float masters are encoded first (the reference's STE
              forward).
  bit_exact   not ported yet (ROADMAP queue 2: the PDPU GEMM kernel).

The grouped MoE entry point needs the grouped GEMM kernel, which is not
ported yet: it raises `NotImplementedError`.

A weight wrapped in `Prepared` keeps the operand its plan's dot reads
(the rounded, decoded or encoded weights), so several `qdot` calls over
the same weights (the speculative verify's tokens) decode them once and
give, bitwise, what separate calls give.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.quant import QuantPolicy
from . import ops


def is_packed(w) -> bool:
    """True if `w` holds posit codes in an integer storage container."""
    return not (w.is_floating_point() or w.is_complex())


def _as_matrix(x):
    """[..., K] -> ([M, K], leading shape)."""
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


class _FakeQuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        return ops.decode(ops.encode(x, fmt), fmt).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quantize(x, fmt: PositFormat):
    """decode(encode(x)) in x's dtype with a straight-through gradient:
    the codec kernels K2 then K1 on a CUDA tensor, their plain versions
    (the reference's `posit.quantize`, bitwise) on a CPU tensor."""
    return _FakeQuantizeSTE.apply(x, fmt)


def maybe_quant_weight(policy: QuantPolicy, w):
    return w if policy.weights is None else fake_quantize(w, policy.weights)


def maybe_quant_act(policy: QuantPolicy, x):
    return x if policy.activations is None else \
        fake_quantize(x, policy.activations)


class Prepared:
    """A 2-D weight whose plan operand (`_weight_operand`) is made on the
    first `qdot` that reads it, per policy and activation dtype, and
    reused by every later one."""

    def __init__(self, w):
        self.w = w
        self.shape, self.ndim = w.shape, w.ndim
        self._operands = {}

    def operand(self, policy: QuantPolicy, dtype):
        key = (policy, dtype)
        if key not in self._operands:
            self._operands[key] = _weight_operand(self.w, policy, dtype)
        return self._operands[key]


def _weight_operand(w, policy: QuantPolicy, dtype):
    """What the plan's dot reads of w [K, N], for activations of `dtype`:
    fake_quant the rounded weights in that dtype; fused the decoded f32
    weights (float activations) or the codes (coded activations)."""
    packed = is_packed(w)
    if policy.execution == "fake_quant":
        if packed:
            return ops.decode(w, policy.weights).to(dtype)
        return maybe_quant_weight(policy, w.to(dtype))
    # fused: float masters are encoded first (the reference's STE forward)
    codes = w if packed else ops.encode(w.to(torch.float32), policy.weights)
    if policy.activations is None:
        return ops.decode(codes, policy.weights)
    return codes


def qdot(x, w, policy: QuantPolicy, prec_dtype=torch.float32, out_dtype=None):
    """Policy-dispatched matmul: x [..., K] @ w [K, N] -> [..., N]; w is a
    tensor or a `Prepared` one.

    prec_dtype is the output dtype of the fake_quant dot (f32 accumulates
    wide; the compute dtype rounds the dot's output); the fused plan always
    produces f32 before the final cast.  out_dtype=None returns x.dtype.
    """
    if w.ndim != 2:
        raise ValueError(f"qdot weights must be 2-D [K, N], got {tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    raw = w.w if isinstance(w, Prepared) else w
    if is_packed(raw) and policy.weights is None:
        raise ValueError("packed posit weights need QuantPolicy.weights set")
    plan = policy.execution
    if plan == "bit_exact":
        raise NotImplementedError(
            "the bit_exact plan needs the PDPU GEMM kernel (pdpu_matmul), "
            "not ported yet: ROADMAP queue 2")
    if plan not in ("fake_quant", "fused"):
        raise ValueError(f"unknown execution plan '{plan}'")
    wq = w.operand(policy, x.dtype) if isinstance(w, Prepared) else \
        _weight_operand(w, policy, x.dtype)

    if plan == "fake_quant":
        xq = maybe_quant_act(policy, x)
        if prec_dtype == torch.float32:
            # products of the rounded operands are exact in f32: an f32
            # matmul is the dot with f32 accumulation
            out = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
        else:
            out = torch.matmul(xq, wq).to(prec_dtype)
        return out.to(out_dtype)

    xf, lead = _as_matrix(x)
    if policy.activations is None:
        out = torch.matmul(xf.to(torch.float32), wq)
    else:
        a_codes = ops.encode(xf.to(torch.float32), policy.activations)
        out = ops.fused_matmul(a_codes, wq, policy.activations,
                               policy.weights, fmt_out=None)
    return out.reshape(lead + (w.shape[-1],)).to(out_dtype)


def qdot_grouped(x, w, policy: QuantPolicy, prec_dtype=torch.float32,
                 out_dtype=None):
    """Grouped matmul over stacked expert weights — not ported yet."""
    raise NotImplementedError(
        "qdot_grouped (MoE expert stacks) needs the grouped posit GEMM "
        "kernel, not ported yet: ROADMAP queue 2")
