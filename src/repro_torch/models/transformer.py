"""Dense GQA transformer LM, paged serving path (PyTorch port of
`repro.models.transformer`): command-r-35b and the other dense configs.

Parameters are a dict of tensors with layers stacked on a leading dim
([L, D, N]); the layer loop is a Python loop over that dim.  Serving runs
over the paged KV cache: `decode_step` (one token per slot, the
paged-attention kernel) and `prefill_chunk` / `prefill_chunk_batched`
(the decomposed chunk prefill: flash attention over decoded history plus
the raw chunk, then KV encode and page insert).  Page pools are updated
in place.  The fused prefill kernel of the reference is not ported yet:
a config with `quant.fused_prefill` on raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from . import common, paged
from .config import ModelConfig
from .module import ParamSpec, tree_map
from .paged import PagedLayout

_UNBOUNDED = 2 ** 30


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig):
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    Hq, Hkv, Dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    layers = {
        "ln1": ParamSpec((L, D), ("layers", None), "zeros"),
        "ln2": ParamSpec((L, D), ("layers", None), "zeros"),
        "wq": ParamSpec((L, D, Hq * Dh), ("layers", "embed", "heads"), "fan_in"),
        "wk": ParamSpec((L, D, Hkv * Dh), ("layers", "embed", "heads"), "fan_in"),
        "wv": ParamSpec((L, D, Hkv * Dh), ("layers", "embed", "heads"), "fan_in"),
        "wo": ParamSpec((L, Hq * Dh, D), ("layers", "heads", "embed"), "fan_in"),
        "wi_gate": ParamSpec((L, D, F), ("layers", "embed", "mlp"), "fan_in"),
        "wi_up": ParamSpec((L, D, F), ("layers", "embed", "mlp"), "fan_in"),
        "wo_mlp": ParamSpec((L, F, D), ("layers", "mlp", "embed"), "fan_in"),
    }
    if cfg.qk_norm:
        layers["q_norm"] = ParamSpec((L, Dh), ("layers", None), "zeros")
        layers["k_norm"] = ParamSpec((L, Dh), ("layers", None), "zeros")
    specs = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), "embed"),
        "layers": layers,
        "final_norm": ParamSpec((D,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((D, V), ("embed", "vocab"), "fan_in")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: stub frontends (vlm / encoder) are not ported yet")
    return specs


def layer_flags(cfg: ModelConfig):
    """Per-layer is_global (full attention) flags, as python bools."""
    return [cfg.layer_is_global(i) for i in range(cfg.n_layers)]


def _layer(params, i: int):
    return {k: v[i] for k, v in params["layers"].items()}


def _head(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _check_prefill(cfg: ModelConfig):
    if cfg.quant.fused_prefill:
        raise NotImplementedError(
            "the fused prefill kernel (prefill_attention_paged) is not ported "
            "yet (ROADMAP queue 2); serve with fused_prefill=False, which the "
            "reference pins token-identical")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _mlp_block(p, x, cfg: ModelConfig):
    h = common.rms_norm(x, p["ln2"], upcast=not cfg.tp_bf16_reduce)
    g = common.qdot(h, p["wi_gate"], cfg.quant)
    u = common.qdot(h, p["wi_up"], cfg.quant)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return common.qdot(h, p["wo_mlp"], cfg.quant, prec_dtype=common.tp_prec(cfg))


def _window(cfg: ModelConfig, is_global: bool) -> int:
    if cfg.sliding_window is None or is_global:
        return _UNBOUNDED
    return int(cfg.sliding_window)


def _window_arr(cfg: ModelConfig, is_global: bool, device):
    """Per-layer sliding window as a [1] int32 tensor for the paged kernel."""
    return torch.full((1,), _window(cfg, is_global), dtype=torch.int32,
                      device=device)


def _qkv(p, x, cfg: ModelConfig, pos):
    """Projections + optional qk-norm + rope. x: [B, S, D]; pos: [B, S]."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = common.rms_norm(x, p["ln1"], upcast=not cfg.tp_bf16_reduce)
    q = common.qdot(h, p["wq"], cfg.quant).reshape(B, S, Hq, Dh)
    k = common.qdot(h, p["wk"], cfg.quant).reshape(B, S, Hkv, Dh)
    v = common.qdot(h, p["wv"], cfg.quant).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm and "q_norm" in p:
        q = common.rms_norm(q, p["q_norm"])
        k = common.rms_norm(k, p["k_norm"])
    return (common.rope(q, pos, cfg.rope_theta),
            common.rope(k, pos, cfg.rope_theta), v)


def _paged_attn_token(p, x, cfg: ModelConfig, k_l, v_l, bt, length, is_global):
    """One-token attention sub-block over paged KV (decode hot path).

    x: [B, 1, D]; k_l/v_l: [n_pages, ps, Hkv*Dh] page pools (written in
    place); bt: [B, M]; length: [B] pre-insert valid counts.  Writes the new
    token's KV codes at position `length`, then runs the paged-attention
    kernel.  Returns the post-wo output [B, 1, D]."""
    B = x.shape[0]
    Hq, Dh = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, length[:, None])
    paged.insert_tokens(k_l, bt, length, common.kv_encode(cfg, k.reshape(B, -1)))
    paged.insert_tokens(v_l, bt, length, common.kv_encode(cfg, v.reshape(B, -1)))
    attn = ops.paged_attention(
        q.reshape(B, Hq, Dh), k_l, v_l, bt, length + 1,
        _window_arr(cfg, is_global, x.device), fmt_kv=cfg.quant.kv_cache,
        softcap_val=cfg.logit_softcap)
    return common.qdot(attn.reshape(B, 1, Hq * Dh).to(x.dtype), p["wo"],
                       cfg.quant)


def _history_attn(q, k, v, hist_k, hist_v, starts, pos, cfg: ModelConfig,
                  is_global: bool):
    """Flash attention of chunk queries over [decoded history | raw chunk]
    (the reference's decomposed prefill).  hist_*: [B, S_h, F] codes."""
    B, S_h, _ = hist_k.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    hist_pos = torch.arange(S_h, device=q.device)[None].expand(B, S_h)
    hist_pos = torch.where(hist_pos < starts[:, None], hist_pos,
                           torch.full_like(hist_pos, -1))
    kd = common.kv_decode(cfg, hist_k).reshape(B, S_h, Hkv, Dh).to(k.dtype)
    vd = common.kv_decode(cfg, hist_v).reshape(B, S_h, Hkv, Dh).to(v.dtype)
    window = None if cfg.sliding_window is None else _window(cfg, is_global)
    return common.flash_attention(
        q, torch.cat([kd, k], 1), torch.cat([vd, v], 1), pos,
        torch.cat([hist_pos, pos], 1), causal=True, window=window,
        chunk_k=paged.FLASH_CHUNK, softcap_val=cfg.logit_softcap)


def _chunk_attn_batched(p, x, cfg: ModelConfig, k_l, v_l, starts, bt,
                        is_global: bool):
    """Cross-slot batched prefill-chunk attention (decomposed branch):
    queries of slot b sit at starts[b] + [0, C) and attend that slot's
    history plus themselves; intra-chunk attention uses the raw (pre-encode)
    k/v.  x: [B, C, D]; bt [B, M] with inactive rows zeroed (their writes
    land on the trash page).  Returns the post-wo output [B, C, D]."""
    _check_prefill(cfg)
    B, C, _ = x.shape
    Hq, Dh = cfg.n_heads, cfg.head_dim
    starts = starts.long()
    pos = starts[:, None] + torch.arange(C, device=x.device)[None]
    q, k, v = _qkv(p, x, cfg, pos)
    hist_k, hist_v = paged.gather_slots(k_l, bt), paged.gather_slots(v_l, bt)
    paged.insert_chunk_batched(k_l, bt, starts,
                               common.kv_encode(cfg, k.reshape(B, C, -1)))
    paged.insert_chunk_batched(v_l, bt, starts,
                               common.kv_encode(cfg, v.reshape(B, C, -1)))
    attn = _history_attn(q, k, v, hist_k, hist_v, starts, pos, cfg, is_global)
    return common.qdot(attn.reshape(B, C, Hq * Dh), p["wo"], cfg.quant,
                       prec_dtype=common.tp_prec(cfg))


def _chunk_attn(p, x, cfg: ModelConfig, k_l, v_l, start, bt_row,
                is_global: bool):
    """Prefill-chunk attention for one slot (the per-slot path): x [1, C, D]
    at positions start + [0, C) of the slot whose block-table row is
    bt_row [M]."""
    starts = torch.reshape(start, (1,)).to(torch.int32)
    return _chunk_attn_batched(p, x, cfg, k_l, v_l, starts, bt_row[None],
                               is_global)


# ---------------------------------------------------------------------------
# serving: cache container + prefill + decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                layout: Optional[PagedLayout] = None):
    """Paged KV cache: a page pool [L, n_pages, page_size, Hkv*Dh] at KV
    code width plus per-slot block tables.  The dense layout is not ported."""
    if layout is None:
        raise NotImplementedError(
            "the dense (non-paged) KV cache is not ported yet; serve paged")
    dt = common.kv_store_dtype(cfg)
    shape = (cfg.n_layers, layout.n_pages, layout.page_size,
             cfg.n_kv_heads * cfg.head_dim)
    axes = ("layers", "kv_pages", None, "kv_heads")
    return {
        "k": ParamSpec(shape, axes, "zeros", dt),
        "v": ParamSpec(shape, axes, "zeros", dt),
        "block_table": ParamSpec((batch, layout.pages_per_slot(max_seq)),
                                 ("batch", None), "zeros", torch.int32),
        "length": ParamSpec((batch,), ("batch",), "zeros", torch.int32),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               layout: Optional[PagedLayout] = None, device="cpu"):
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                    cache_specs(cfg, batch, max_seq, layout))


def decode_step(params, tokens, cache, cfg: ModelConfig, sample=None):
    """One autoregressive step over the paged cache. tokens: [B] int32.

    Per layer the token's KV codes are written into the slot's current page
    (in place) and the paged-attention kernel attends.  Returns
    (logits [B, V] f32, cache') — or, with `sample` (common.SampleSpec),
    ([B] int32 tokens, cache') from the fused head + sampler kernel."""
    if "block_table" not in cache:
        raise NotImplementedError("the dense KV cache is not ported yet")
    B = tokens.shape[0]
    x = common.embed_tokens(params["embed"], tokens[:, None], cfg)
    length, bt = cache["length"], cache["block_table"]
    for i, is_global in enumerate(layer_flags(cfg)):
        p = _layer(params, i)
        x = x + _paged_attn_token(p, x, cfg, cache["k"][i], cache["v"][i], bt,
                                  length, is_global)
        x = x + _mlp_block(p, x, cfg)
    x = common.rms_norm(x, params["final_norm"])
    new_cache = {"k": cache["k"], "v": cache["v"], "block_table": bt,
                 "length": length + 1}
    head = _head(params, cfg)
    if sample is not None:
        return common.sample_head(x[:, 0], head, cfg, sample,
                                  transpose=cfg.tie_embeddings), new_cache
    logits = common.logits_head(x, head, cfg, transpose=cfg.tie_embeddings)
    return logits[:, 0].reshape(B, -1), new_cache


def prefill_chunk(params, tokens, cache, slot: int, cfg: ModelConfig):
    """Chunked prefill of prompt chunk `tokens` [1, C] for one slot, at
    positions length[slot] + [0, C).  Returns (last-position logits
    [1, 1, V], cache') with length[slot] advanced by C."""
    C = tokens.shape[1]
    x = common.embed_tokens(params["embed"], tokens, cfg)
    start = cache["length"][slot]
    bt_row = cache["block_table"][slot]
    for i, is_global in enumerate(layer_flags(cfg)):
        p = _layer(params, i)
        x = x + _chunk_attn(p, x, cfg, cache["k"][i], cache["v"][i], start,
                            bt_row, is_global)
        x = x + _mlp_block(p, x, cfg)
    x = common.rms_norm(x[:, -1:], params["final_norm"])
    logits = common.logits_head(x, _head(params, cfg), cfg,
                                transpose=cfg.tie_embeddings)
    length = cache["length"].clone()
    length[slot] = start + C
    return logits, dict(cache, length=length)


def prefill_chunk_batched(params, tokens, cache, active, cfg: ModelConfig):
    """Cross-slot batched chunked prefill: one [B, C] pass advances every
    active slot by a chunk of the same bucket size.  The caller zeroes
    inactive rows' length/block-table metadata, so their writes land on
    the trash page.  Returns (last-position logits [B, V], cache')."""
    C = tokens.shape[1]
    x = common.embed_tokens(params["embed"], tokens, cfg)
    starts, bt = cache["length"], cache["block_table"]
    for i, is_global in enumerate(layer_flags(cfg)):
        p = _layer(params, i)
        x = x + _chunk_attn_batched(p, x, cfg, cache["k"][i], cache["v"][i],
                                    starts, bt, is_global)
        x = x + _mlp_block(p, x, cfg)
    x = common.rms_norm(x[:, -1:], params["final_norm"])
    logits = common.logits_head(x, _head(params, cfg), cfg,
                                transpose=cfg.tie_embeddings)
    length = cache["length"] + torch.where(
        active, C, 0).to(torch.int32)
    return logits[:, 0], dict(cache, length=length)
