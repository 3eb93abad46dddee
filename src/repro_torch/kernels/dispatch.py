"""Posit GEMM execution-plan dispatch — the one place model matmuls land
(PyTorch port of `repro.kernels.dispatch`).

  plan        datapath in the port
  ----------  ------------------------------------------------------------
  fake_quant  STE fake-quantization + a plain f32-accumulated dot.  Weights
              may be float masters or packed posit codes (decoded).
  fused       float activations x posit-coded weights: packed codes decode
              exactly through the codec kernel and `torch.matmul`
              accumulates in f32 (`ops.matmul_posit_weights`).  With
              `QuantPolicy.activations` set (activation-coded serving) the
              activations are encoded (K2) and both code operands go
              through the coded GEMM kernel (`ops.fused_matmul`, K6).
              Float masters are encoded first (the reference's STE
              forward).
  bit_exact   not ported yet (ROADMAP queue 2: the PDPU GEMM kernel).

The grouped MoE entry point needs the grouped GEMM kernel, which is not
ported yet: it raises `NotImplementedError`.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QuantPolicy
from . import ops


def is_packed(w) -> bool:
    """True if `w` holds posit codes in an integer storage container."""
    return not (w.is_floating_point() or w.is_complex())


def _as_matrix(x):
    """[..., K] -> ([M, K], leading shape)."""
    return x.reshape(-1, x.shape[-1]), tuple(x.shape[:-1])


def qdot(x, w, policy: QuantPolicy, prec_dtype=torch.float32, out_dtype=None):
    """Policy-dispatched matmul: x [..., K] @ w [K, N] -> [..., N].

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
    packed = is_packed(w)
    if packed and policy.weights is None:
        raise ValueError("packed posit weights need QuantPolicy.weights set")
    plan = policy.execution

    if plan == "fake_quant":
        if packed:
            wq = ops.decode(w, policy.weights).to(x.dtype)
        else:
            wq = policy.maybe_quant_weight(w.to(x.dtype))
        xq = policy.maybe_quant_act(x)
        if prec_dtype == torch.float32:
            # products of the rounded operands are exact in f32: an f32
            # matmul is the dot with f32 accumulation
            out = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
        else:
            out = torch.matmul(xq, wq).to(prec_dtype)
        return out.to(out_dtype)

    if plan == "fused":
        xf, lead = _as_matrix(x)
        if packed:
            codes = w
        else:
            # float masters: the reference's STE forward encodes the masters
            # and runs the packed datapath
            codes = ops.encode(w.to(torch.float32), policy.weights)
        if policy.activations is None:
            out = ops.matmul_posit_weights(xf, codes, policy.weights)
        else:
            a_codes = ops.encode(xf.to(torch.float32), policy.activations)
            out = ops.fused_matmul(a_codes, codes, policy.activations,
                                   policy.weights, fmt_out=None)
        return out.reshape(lead + (w.shape[-1],)).to(out_dtype)

    if plan == "bit_exact":
        raise NotImplementedError(
            "the bit_exact plan needs the PDPU GEMM kernel (pdpu_matmul), "
            "not ported yet: ROADMAP queue 2")
    raise ValueError(f"unknown execution plan '{plan}'")


def qdot_grouped(x, w, policy: QuantPolicy, prec_dtype=torch.float32,
                 out_dtype=None):
    """Grouped matmul over stacked expert weights — not ported yet."""
    raise NotImplementedError(
        "qdot_grouped (MoE expert stacks) needs the grouped posit GEMM "
        "kernel, not ported yet: ROADMAP queue 2")
