"""Mixture-of-Experts LM (PyTorch port of `repro.models.moe`):
qwen3-moe-235b (128 experts, top-8) and deepseek-moe-16b (2 shared + 64
routed, top-6): the whole-sequence forward of training (with the
router's load-balance loss) and serving over the paged or the dense KV
cache.

Expert dispatch is sort-based with a capacity limit (GShard-style
dropping): token -> expert choices are sorted by expert id (a stable
sort), ranked within their expert and scattered into an [E, C, D] buffer
whose extra drop row takes the choices past capacity.  Every expert GEMM
(we_gate / we_up / we_down, both dispatch flavours) goes through
`common.qdot_grouped` -> `kernels/dispatch.qdot_grouped`: the grouped
posit GEMM (K9) over packed expert stacks when serving fused and over the
float masters' codes in training (the grouped STE of `kernels/ops.py`),
the chunked-PDPU GEMM (K8) per expert under bit_exact.  The combine adds
each token's k weighted expert outputs in ascending expert id, the order
the reference's scatter-add takes them, as a fixed sequence of adds: the
same on the CPU and on the card, where an atomic scatter-add would sum in
no fixed order.  Attention, the cache and the serving loops are
`transformer`'s; this module supplies the feed-forward block.  On one
card the reference's sharding constraints have nothing to do.
"""
from __future__ import annotations

import torch

from . import common, transformer
from .config import ModelConfig
from .module import ParamSpec


def param_specs(cfg: ModelConfig):
    specs = transformer.param_specs(cfg)
    L, D, E, Fe = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    layers = specs["layers"]
    # the dense FFN gives way to routed experts (+ optional shared experts)
    for k in ("wi_gate", "wi_up", "wo_mlp"):
        del layers[k]
    layers.update({
        "router": ParamSpec((L, D, E), ("layers", "embed", "experts"), "fan_in"),
        "we_gate": ParamSpec((L, E, D, Fe), ("layers", "experts", "embed", "expert_mlp"), "fan_in"),
        "we_up": ParamSpec((L, E, D, Fe), ("layers", "experts", "embed", "expert_mlp"), "fan_in"),
        "we_down": ParamSpec((L, E, Fe, D), ("layers", "experts", "expert_mlp", "embed"), "fan_in"),
    })
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        layers.update({
            "ws_gate": ParamSpec((L, D, Fs), ("layers", "embed", "mlp"), "fan_in"),
            "ws_up": ParamSpec((L, D, Fs), ("layers", "embed", "mlp"), "fan_in"),
            "ws_down": ParamSpec((L, Fs, D), ("layers", "mlp", "embed"), "fan_in"),
        })
    return specs


def _route(x, router, cfg: ModelConfig):
    """Router softmax and top-k over the last dim of x [..., D]: (probs
    [..., E], normalized weights [..., k], expert ids [..., k]).  Ties
    go to the lower expert id, as jax.lax.top_k breaks them (a stable
    descending sort)."""
    logits = torch.matmul(x.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :cfg.top_k], ids[..., :cfg.top_k]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return probs, vals, ids


def _aux_loss(probs, ids, E: int):
    """Switch-style load-balance loss E * sum_e(f_e * p_e)."""
    me = probs.reshape(-1, E).mean(0)
    flat = ids.reshape(-1)
    ce = torch.bincount(flat, minlength=E).to(torch.float32) / flat.numel()
    return E * torch.sum(me * ce)


def _dispatch(x, ids, E: int, C: int):
    """Sort-based dispatch per routing group.  x [G, T, D], ids [G, T, k]
    -> (buf [G, E, C, D], slot, keep, order) with slot/keep/order
    [G, T*k] over the choices in expert order; slot E*C is the drop row.
    The choices' rows are gathered from a copy of x with each row repeated
    k times, each copy once: the gradient of a token's row is then a sum
    over its k choices in a fixed order, where a gather from x itself
    would add them by atomics on the card, in no fixed order."""
    G, T, D = x.shape
    k = ids.shape[-1]
    flat_e = ids.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(T * k, device=x.device)[None] - \
        torch.gather(starts, 1, sorted_e)
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)
    rows = x[:, :, None].expand(G, T, k, D).reshape(G, T * k, D)
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=x.device)
    buf.scatter_(1, slot[..., None].expand(G, T * k, D),
                 torch.gather(rows, 1, order[..., None].expand(G, T * k, D)))
    return buf[:, :E * C].reshape(G, E, C, D), slot, keep, order


def _combine(out_e, ids, vals, slot, keep, order, dtype):
    """y [G, T, D]: per token, its k expert outputs (a dropped choice
    gives 0) times their router weights, added in ascending expert id
    onto zeros, as the reference's scatter-add visits them."""
    G, EC, D = out_e.shape
    T, k = ids.shape[1], ids.shape[2]
    per_choice = torch.gather(
        out_e, 1, torch.clamp(slot, max=EC - 1)[..., None].expand(G, T * k, D))
    per_choice = torch.where(keep[..., None], per_choice,
                             torch.zeros((), dtype=dtype, device=out_e.device))
    w = torch.gather(vals.reshape(G, T * k), 1, order)[..., None].to(dtype)
    per_choice = per_choice * w
    # where each token's choices sit in the expert-sorted list, in
    # ascending expert id (the expert ids of one token are distinct)
    inv = torch.argsort(order, dim=-1)
    perm = torch.argsort(ids, dim=-1)
    flat = torch.arange(T, device=out_e.device)[None, :, None] * k + perm
    pos = torch.gather(inv, 1, flat.reshape(G, T * k))
    pcs = torch.gather(per_choice, 1, pos[..., None].expand(G, T * k, D))
    pcs = pcs.reshape(G, T, k, D)
    y = torch.zeros((G, T, D), dtype=dtype, device=out_e.device)
    for r in range(k):
        y = y + pcs[:, :, r]
    return y


def _experts(p, buf, cfg: ModelConfig, dtype):
    """The routed experts' SwiGLU over a dispatch buffer [E, C, D] or
    [B, E, Cg, D] through the grouped GEMM dispatch."""
    wq = cfg.quant
    g = common.qdot_grouped(buf, p["we_gate"], wq, out_dtype=torch.float32)
    u = common.qdot_grouped(buf, p["we_up"], wq, out_dtype=torch.float32)
    h = (torch.nn.functional.silu(g) * u).to(dtype)
    return common.qdot_grouped(h, p["we_down"], wq,
                               prec_dtype=common.tp_prec(cfg), out_dtype=dtype)


def _shared(p, x, y, cfg: ModelConfig):
    """y plus the shared experts' SwiGLU of x (deepseek-moe)."""
    if not cfg.n_shared_experts:
        return y
    return y + transformer.swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"],
                                  cfg)


def capacity(cfg: ModelConfig, tokens: int, multiple: int = 8) -> int:
    """Rows an expert takes from a routing group of `tokens` tokens: the
    capacity factor times its even share of the top-k choices, rounded up
    to a multiple of `multiple` (and at least `multiple`)."""
    C = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(multiple, -(-C // multiple) * multiple)


def moe_ffn(p, x, cfg: ModelConfig):
    """Routed expert FFN. x: [B, S, D] -> ([B, S, D], aux_loss scalar).
    The capacity limit C applies over all B * S tokens."""
    if cfg.moe_grouped_dispatch:
        return moe_ffn_grouped(p, x, cfg)
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    xf = x.reshape(1, T, D)
    probs, vals, ids = _route(xf, p["router"], cfg)
    aux = _aux_loss(probs, ids, E)
    C = capacity(cfg, T)
    buf, slot, keep, order = _dispatch(xf, ids, E, C)
    out_e = _experts(p, buf[0], cfg, x.dtype).reshape(1, E * C, D)
    y = _combine(out_e, ids, vals, slot, keep, order, x.dtype)
    return _shared(p, x, y.reshape(B, S, D), cfg), aux


def moe_ffn_grouped(p, x, cfg: ModelConfig):
    """GShard-style grouped dispatch: each sequence is a routing group with
    its own capacity Cg; the [B, E, Cg, D] buffer folds its batch dim onto
    the per-expert rows inside qdot_grouped."""
    B, S, D = x.shape
    E = cfg.n_experts
    Cg = capacity(cfg, S, multiple=4)
    probs, vals, ids = _route(x, p["router"], cfg)
    aux = _aux_loss(probs, ids, E)
    buf, slot, keep, order = _dispatch(x, ids, E, Cg)
    out_e = _experts(p, buf, cfg, x.dtype).reshape(B, E * Cg, D)
    y = _combine(out_e, ids, vals, slot, keep, order, x.dtype)
    return _shared(p, x, y, cfg), aux


def _moe_block(p, x, cfg: ModelConfig):
    """The layer's feed-forward block: ln2, then the routed experts;
    returns (output, the router's load-balance loss)."""
    h = common.rms_norm(x, p["ln2"], upcast=not cfg.tp_bf16_reduce)
    return moe_ffn(p, h, cfg)


def apply(params, batch, cfg: ModelConfig, collect_cache: bool = False,
          with_aux: bool = False):
    """Training / prefill forward with the MoE FFN (transformer.apply):
    f32 logits [B, S, V], then each layer's (k, v) with `collect_cache`,
    then the layers' mean load-balance loss with `with_aux`.  The capacity
    limit applies over all B * S tokens (per sequence under
    `cfg.moe_grouped_dispatch`).  Gradients reach the router through the
    combine's weights and the aux loss's probabilities; the expert counts
    of the aux loss carry none, as in the reference."""
    return transformer.apply(params, batch, cfg, collect_cache=collect_cache,
                             with_aux=with_aux, ffn=_moe_block)


# ---------------------------------------------------------------------------
# serving: the transformer's KV caches (paged or dense) and loops with the
# MoE block.  The capacity limit applies within each prefill chunk (or
# batched chunk group); smoke-scale capacity factors are drop-proof, and
# the engine prefills slot by slot where they are not (see ServingEngine).
# There is no k-token verify: speculative decoding of MoE models is not
# offered.
# ---------------------------------------------------------------------------

cache_specs = transformer.cache_specs
init_cache = transformer.init_cache


def prefill(params, batch, cfg: ModelConfig, max_seq=None):
    """Whole-sequence prefill (`apply`) that also builds the dense KV cache
    (transformer.prefill with the MoE FFN): (logits [B, S, V], {"k", "v":
    [L, B, max(max_seq, S), Hkv*Dh] codes, positions past S zero;
    "length": [B] = S})."""
    return transformer.prefill(params, batch, cfg, max_seq=max_seq,
                               ffn=_moe_block)


def decode_step(params, tokens, cache, cfg: ModelConfig, sample=None,
                active=None):
    """One decode step (paged or dense cache) with the MoE FFN
    (transformer.decode_step)."""
    return transformer.decode_step(params, tokens, cache, cfg, sample=sample,
                                   ffn=_moe_block, active=active)


def prefill_chunk(params, tokens, cache, slot: int, cfg: ModelConfig):
    """Chunked prefill of one slot with the MoE FFN (returns the last
    position's logits [1, 1, V])."""
    return transformer.prefill_chunk(params, tokens, cache, slot, cfg,
                                     ffn=_moe_block)


def prefill_chunk_batched(params, tokens, cache, active, cfg: ModelConfig):
    """Cross-slot batched chunked prefill with the MoE FFN; the capacity
    limit applies over the whole [B, C] batch."""
    return transformer.prefill_chunk_batched(params, tokens, cache, active,
                                             cfg, ffn=_moe_block)
