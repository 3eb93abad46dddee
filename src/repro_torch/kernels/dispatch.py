"""Posit GEMM execution-plan dispatch — the one place model matmuls land
(PyTorch port of `repro.kernels.dispatch`).

  plan        datapath in the port
  ----------  ------------------------------------------------------------
  fake_quant  STE fake-quantization (`fake_quantize`: the codec kernels,
              K2 encode then K1 decode) + a plain f32-accumulated dot.
              Weights may be float masters (rounded to the format) or
              packed posit codes (decoded, K1).  The speculative draft
              policy (`QuantPolicy.with_draft`) runs this plan.
  fused       float activations x posit-coded weights
              (`ops.matmul_posit_weights`): at decode rows (M <= 8) a GEMV
              that decodes each code next to its dot and accumulates in
              f32; above, the codes decode exactly through the codec
              kernel (K1) and `torch.matmul` accumulates in f32.  With
              `QuantPolicy.activations` set (activation-coded serving) the
              activations are encoded (K2) and both code operands go
              through the coded GEMM kernel (`ops.fused_matmul`, K6).
              Float masters go through the STE entry points
              (`ops.fused_matmul_ste` and the grouped pair): the same
              forward on their codes, and the fake_quant plan's
              straight-through gradients (QAT on the serving datapath).
              Packed weights with coded activations are forward-only:
              differentiating them raises (`_PACKED_ACT_MSG`).
  bit_exact   the chunked-PDPU GEMM (`ops.pdpu_matmul`, K8): activations
              encoded to the PDPU's input format (K2), the weight codes
              (packed, or float masters encoded), K padded to whole
              chunks with code 0, the paper's S1..S6 integer datapath
              with the W_m alignment truncation, fmt_out codes decoded
              (K1).  Bit-identical to a silicon PDPU array.  Forward
              only: differentiating through it raises (`_GradBarrier`).

Two entry points share the plan table:

  qdot         : x [..., K] @ w [K, N], every dense projection.
  qdot_grouped : stacked expert weights w [E, K, N] against per-expert
                 activation slabs x [E, C, K] (sort-based dispatch
                 buffers) or [B, E, Cg, K] (GShard grouped dispatch; the
                 batch dim folds onto the per-expert rows for the kernel
                 and folds back after).  The fused plan runs the grouped
                 posit GEMM (`ops.matmul_posit_weights_grouped` /
                 `fused_matmul_grouped`, K9), which reads the expert
                 stacks as codes; bit_exact runs K8 expert by expert.

A weight wrapped in `Prepared` keeps the operand its plan's dot reads
(the rounded or encoded weights; under the fused plan with float
activations the codes, and their decoded f32 copy only once a call
above 8 rows or on the CPU reads it), so several `qdot` calls over the
same weights (the speculative verify's tokens) round, encode or decode
them once and give, bitwise, what separate calls give: at decode rows
each call runs the same float GEMV at the same M.  It serves packed
weights and float weights outside autograd only: a master that requires
grad changes every training step, so `Prepared` refuses it under grad
mode rather than serve stale codes.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import storage_dtype
from repro_torch.core.quant import (EXECUTION_PLANS, QuantPolicy,
                                    TRAINABLE_PLANS)
from . import ops, posit_matmul

_BIT_EXACT_MSG = (
    f"execution plan 'bit_exact' is not differentiable; trainable plans "
    f"are {TRAINABLE_PLANS}.  Switch the QuantPolicy with "
    f".with_execution(...) for QAT — bit_exact is a forward-only "
    f"validation datapath.")

_PACKED_ACT_MSG = (
    "the activation-coded fused plan over packed int weights is not "
    "differentiable: the float->code activation encode drops tangents, so "
    "gradients would silently be zero.  Differentiate under the fused plan "
    "over float masters instead.")


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


class _GradBarrier(torch.autograd.Function):
    """`out` unchanged; differentiating it towards `inputs` raises."""

    @staticmethod
    def forward(ctx, reason, out, *inputs):
        ctx.reason = reason
        return out.clone()

    @staticmethod
    def backward(ctx, g):
        raise ValueError(ctx.reason)


def _grad_barrier(reason: str, out, *inputs):
    """Tie `out`, computed from `inputs` through integer codes (where
    autograd sees no path), back to the float inputs so that a gradient
    raises `reason` instead of coming back silently zero.  Without grad
    mode or a float input that requires grad it is `out` itself."""
    if torch.is_grad_enabled() and any(
            t.is_floating_point() and t.requires_grad for t in inputs):
        return _GradBarrier.apply(reason, out, *inputs)
    return out


class Prepared:
    """A 2-D weight whose plan operand (`_weight_operand`) is made on the
    first `qdot` that reads it, per policy and activation dtype, and
    reused by every later one; under the fused plan with float activations
    the operand is the codes, and `decoded` keeps their f32 decode for the
    calls that read it."""

    def __init__(self, w):
        self.w = w
        self.shape, self.ndim = w.shape, w.ndim
        self._operands = {}

    def operand(self, policy: QuantPolicy, dtype):
        if torch.is_grad_enabled() and self.w.requires_grad:
            raise ValueError(
                "Prepared caches a weight's plan operand and cannot follow a "
                "master that requires grad; pass the tensor itself when "
                "training")
        key = (policy, dtype)
        if key not in self._operands:
            self._operands[key] = _weight_operand(self.w, policy, dtype)
        return self._operands[key]

    def decoded(self, policy: QuantPolicy, dtype):
        """The f32 decode of the fused plan's weight codes, made once."""
        key = (policy, dtype, "decoded")
        if key not in self._operands:
            self._operands[key] = ops.decode(self.operand(policy, dtype),
                                             policy.weights)
        return self._operands[key]


def _weight_operand(w, policy: QuantPolicy, dtype):
    """What the plan's dot reads of w [K, N], for activations of `dtype`:
    fake_quant the rounded weights in that dtype; fused the codes (the
    float weight path decodes them itself, `ops.matmul_posit_weights`);
    bit_exact the codes in the PDPU's input format."""
    packed = is_packed(w)
    if policy.execution == "fake_quant":
        if packed:
            return ops.decode(w, policy.weights).to(dtype)
        return maybe_quant_weight(policy, w.to(dtype))
    if policy.execution == "bit_exact":
        # packed weights are in policy.weights == cfg.fmt_in by
        # construction (pdpu_config derives fmt_in from it); the kernel
        # reads their low n bits
        return w if packed else ops.encode(w.to(torch.float32),
                                           policy.pdpu_config().fmt_in)
    # fused: float masters are encoded first (the reference's STE forward)
    return w if packed else ops.encode(w.to(torch.float32), policy.weights)


def _float_weight_dot(xf, w, codes, policy: QuantPolicy, dtype):
    """xf [M, K] float @ the fused plan's weight codes -> f32
    (`ops.matmul_posit_weights`).  A `Prepared` weight serves its cached
    f32 decode wherever the call would decode the whole operand (above
    GEMV_MAX_M rows, or on the CPU): the same values into the same
    `torch.matmul`."""
    if isinstance(w, Prepared) and (
            xf.device.type == "cpu"
            or xf.shape[0] > posit_matmul.GEMV_MAX_M):
        return torch.matmul(xf.to(torch.float32), w.decoded(policy, dtype))
    return ops.matmul_posit_weights(xf, codes, policy.weights)


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
    packed = is_packed(raw)
    if packed and policy.weights is None:
        raise ValueError("packed posit weights need QuantPolicy.weights set")
    plan = policy.execution
    if plan not in EXECUTION_PLANS:
        raise ValueError(f"unknown execution plan '{plan}'")
    xf, lead = _as_matrix(x)
    if plan == "fused" and not packed and not isinstance(w, Prepared):
        # float masters: the differentiable STE entry points, the same
        # coded forward with straight-through gradients (QAT)
        out = ops.fused_matmul_ste(xf.to(torch.float32),
                                   raw.to(torch.float32), policy.activations,
                                   policy.weights)
        return out.reshape(lead + (w.shape[-1],)).to(out_dtype)
    wq = w.operand(policy, x.dtype) if isinstance(w, Prepared) else \
        _weight_operand(w, policy, x.dtype)

    if plan == "fake_quant":
        return _fake_quant_dot(x, wq, policy, prec_dtype).to(out_dtype)

    if plan == "bit_exact":
        out = _grad_barrier(_BIT_EXACT_MSG, _bit_exact(xf, wq, policy),
                            xf, raw)
    elif policy.activations is None:
        out = _float_weight_dot(xf, w, wq, policy, x.dtype)
    else:
        a_codes = ops.encode(xf.to(torch.float32), policy.activations)
        out = _grad_barrier(_PACKED_ACT_MSG, ops.fused_matmul(
            a_codes, wq, policy.activations, policy.weights, fmt_out=None),
            xf)
    return out.reshape(lead + (w.shape[-1],)).to(out_dtype)


def _fake_quant_dot(x, wq, policy: QuantPolicy, prec_dtype):
    """The fake_quant plan's dot of x (rounded here) with the rounded
    weights wq (batched over leading dims)."""
    xq = maybe_quant_act(policy, x)
    if prec_dtype == torch.float32:
        # products of the rounded operands are exact in f32: an f32
        # matmul is the dot with f32 accumulation
        return torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
    return torch.matmul(xq, wq).to(prec_dtype)


def _bit_exact(xf, w_codes, policy: QuantPolicy):
    """xf [..., M, K] float x w_codes [..., K, N] PDPU input codes through
    the chunked-PDPU GEMM (K8), one launch per leading index; returns the
    decoded fmt_out values, f32."""
    cfg = policy.pdpu_config()
    a_codes = ops.encode(xf.to(torch.float32), cfg.fmt_in)
    pad_k = (-xf.shape[-1]) % cfg.N   # whole chunks; code 0 is exact zero
    if pad_k:
        a_codes = torch.nn.functional.pad(a_codes, (0, pad_k))
        w_codes = torch.nn.functional.pad(w_codes, (0, 0, 0, pad_k))
    if a_codes.ndim == 2:
        out_codes = ops.pdpu_matmul(a_codes, w_codes, cfg)
    else:
        out_codes = torch.stack([ops.pdpu_matmul(a, b, cfg)
                                 for a, b in zip(a_codes, w_codes)])
    # fmt_out codes are non-negative below 2**n: the storage container
    # keeps their bits for the decode kernel
    return ops.decode(out_codes.to(storage_dtype(cfg.fmt_out)), cfg.fmt_out)


def qdot_grouped(x, w, policy: QuantPolicy, prec_dtype=torch.float32,
                 out_dtype=None):
    """Policy-dispatched grouped matmul over stacked expert weights.

    x: [E, C, K] or [B, E, Cg, K] activations; w: [E, K, N] stacked weights
    (float masters or packed posit codes) -> [E, C, N] / [B, E, Cg, N].
    Plan semantics match `qdot` applied per expert; the fused plan runs
    the grouped posit GEMM (K9) over the [E, rows, K] slab, bit_exact the
    chunked-PDPU GEMM (K8) expert by expert."""
    if w.ndim != 3:
        raise ValueError(f"qdot_grouped weights must be 3-D [E, K, N], "
                         f"got {tuple(w.shape)}")
    if x.ndim not in (3, 4):
        raise ValueError(f"qdot_grouped activations must be [E, C, K] or "
                         f"[B, E, Cg, K], got {tuple(x.shape)}")
    E, K, N = w.shape
    if x.shape[-3] != E or x.shape[-1] != K:
        raise ValueError(f"grouped contraction mismatch {tuple(x.shape)} x "
                         f"{tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    packed = is_packed(w)
    if packed and policy.weights is None:
        raise ValueError("packed posit weights need QuantPolicy.weights set")
    plan = policy.execution
    if plan not in EXECUTION_PLANS:
        raise ValueError(f"unknown execution plan '{plan}'")

    if plan == "fake_quant":
        wq = _weight_operand(w, policy, x.dtype)
        return _fake_quant_dot(x, wq, policy, prec_dtype).to(out_dtype)

    # fold a leading batch dim onto the per-expert row dim: the kernel sees
    # one [E, rows, K] slab; rows unfold after
    batched = x.ndim == 4
    if batched:
        B, _, C, _ = x.shape
        xe = x.movedim(0, 1).reshape(E, B * C, K)
    else:
        xe = x
    if plan == "bit_exact":
        out = _grad_barrier(_BIT_EXACT_MSG, _bit_exact(
            xe, _weight_operand(w, policy, x.dtype), policy), xe, w)
    elif not packed:
        # float masters: the grouped STE entry points (QAT datapath)
        out = ops.fused_matmul_grouped_ste(
            xe.to(torch.float32), w.to(torch.float32), policy.activations,
            policy.weights)
    elif policy.activations is None:
        out = ops.matmul_posit_weights_grouped(xe, w, policy.weights)
    else:
        a_codes = ops.encode(xe.to(torch.float32), policy.activations)
        out = _grad_barrier(_PACKED_ACT_MSG, ops.fused_matmul_grouped(
            a_codes, w, policy.activations, policy.weights, fmt_out=None), xe)
    if batched:
        out = out.reshape(E, B, C, N).movedim(1, 0)
    return out.to(out_dtype)
