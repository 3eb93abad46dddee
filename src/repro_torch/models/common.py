"""Shared transformer building blocks (PyTorch port of `repro.models.common`).

Every matmul routes through `qdot` into the execution-plan dispatch
(`kernels/dispatch.py`).  Each function replays the reference's dtype
casts at the same places, so bf16 compute rounds where the JAX code
rounds: `rms_norm` upcasts to f32, `qdot` returns the input dtype,
`kv_decode` decodes to the compute dtype.  KV storage codecs and the head
codecs go through `kernels.ops` (the codec kernels on CUDA, their plain
versions on the CPU; both bit-for-bit the reference codec).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.quant import QuantPolicy
from repro_torch.core.posit import storage_dtype
from repro_torch.kernels import dispatch, ops
from .config import ModelConfig

_NEG = -2.0e38


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def qdot(x, w, policy: QuantPolicy, prec_dtype=torch.float32):
    """Posit-quantized matmul with wide accumulation; x [..., K] @ w [K, N]
    with w float masters or packed posit codes (see kernels/dispatch.py)."""
    return dispatch.qdot(x, w, policy, prec_dtype=prec_dtype)


def tp_prec(cfg) -> torch.dtype:
    """Output dtype for TP-contracted projections (see qdot)."""
    return cfg.compute_dtype if cfg.tp_bf16_reduce else torch.float32


def rms_norm(x, scale, eps=1e-6, upcast=True):
    """RMSNorm; the variance reduction is always f32.  With upcast=False the
    normalize runs in x.dtype."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    if upcast:
        out = x.to(torch.float32) * inv
        return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)
    out = x * inv.to(x.dtype)
    return out * (1.0 + scale).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embeddings. x: [..., S, H, D]; positions: [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq  # [..., S, half]
    ang = ang[..., :, None, :]  # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool,
                    window: Optional[int], chunk_k: int = 1024,
                    softcap_val: float = 0.0):
    """Streaming-softmax attention over KV chunks (never S x S resident).

    q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D]; GQA via Hq = G * Hkv.
    q_pos: [B, Sq], kv_pos: [B, Skv] absolute positions for masking
    (kv_pos < 0 marks an unwritten entry).
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).to(torch.float32) * scale

    ck = min(chunk_k, Skv)
    n_chunks = -(-Skv // ck)
    pad = n_chunks * ck - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)

    m = torch.full((B, Hkv, G, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=q.device)
    qp = q_pos[:, None, None, :, None]
    for c in range(n_chunks):
        kb = k[:, c * ck:(c + 1) * ck].to(torch.float32)
        vb = v[:, c * ck:(c + 1) * ck].to(torch.float32)
        pb = kv_pos[:, None, None, None, c * ck:(c + 1) * ck]
        s = softcap(torch.einsum("bqhgd,bkhd->bhgqk", qg, kb), softcap_val)
        mask = pb >= 0
        if causal:
            mask = mask & (qp >= pb)
        if window is not None:
            mask = mask & ((qp - pb) < window)
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    out = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache with optional posit storage (QuantPolicy.kv_cache)
# ---------------------------------------------------------------------------

def kv_store_dtype(cfg: ModelConfig):
    fmt = cfg.quant.kv_cache
    if fmt is None:
        return cfg.compute_dtype
    return storage_dtype(fmt)


def kv_encode(cfg: ModelConfig, x):
    fmt = cfg.quant.kv_cache
    if fmt is None:
        return x.to(cfg.compute_dtype)
    return ops.encode(x, fmt)


def kv_decode(cfg: ModelConfig, x):
    fmt = cfg.quant.kv_cache
    if fmt is None:
        return x
    return ops.decode(x, fmt).to(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def embed_tokens(emb, tokens, cfg: ModelConfig):
    return emb[tokens.long()].to(cfg.compute_dtype)


def _head_policy(cfg: ModelConfig) -> QuantPolicy:
    # the head quantizes only the weights: final hidden states reach the
    # vocab projection unquantized regardless of the policy
    policy = cfg.quant
    if policy.activations is not None:
        policy = dataclasses.replace(policy, activations=None)
    return policy


def logits_head(x, emb_or_head, cfg: ModelConfig, transpose: bool):
    w = emb_or_head.T if transpose else emb_or_head
    out = dispatch.qdot(x, w, _head_policy(cfg), prec_dtype=torch.float32,
                        out_dtype=torch.float32)
    return softcap(out, cfg.logit_softcap)


@dataclasses.dataclass
class SampleSpec:
    """Sampling epilogue parameters for the fused decode step: `noise` is
    per-slot standard gumbel [B, V] (None when greedy), `temperature` a
    python float, `greedy`/`top_k` as the engine's sampler."""
    noise: Optional[torch.Tensor]
    temperature: float
    greedy: bool
    top_k: int


def sample_head(x, emb_or_head, cfg: ModelConfig, sample: SampleSpec,
                transpose: bool):
    """Fused replacement for `logits_head` + the serving sampler (K4 on
    CUDA): tokens equal to the two-step path.  x: [B, D] hidden rows.  The
    head weights stay untransposed; the kernel reads the tied [V, D]
    layout directly."""
    policy = cfg.quant
    w = emb_or_head
    fmt_w = policy.weights
    if policy.execution == "fake_quant":
        plan = "fake_quant"
        if not dispatch.is_packed(w):
            # float masters: fake-quantize on float (elementwise, commutes
            # with the transpose); the kernel sees plain float weights
            w = policy.maybe_quant_weight(w.to(x.dtype))
            fmt_w = None
    elif policy.execution == "fused":
        plan = "fused"
        if not dispatch.is_packed(w) and fmt_w is not None:
            # the reference's STE forward: encode the float masters (K2),
            # decode in the head kernel
            w = ops.encode(w.to(torch.float32), fmt_w)
    else:
        raise ValueError(f"no fused decode head for execution plan "
                         f"{policy.execution!r}")
    return ops.decode_sample(
        x, w, sample.noise, sample.temperature, plan=plan, fmt_w=fmt_w,
        transpose=transpose, greedy=sample.greedy, top_k=sample.top_k,
        softcap_val=cfg.logit_softcap)
