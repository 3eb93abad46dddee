"""Dense GQA transformer LM (PyTorch port of `repro.models.transformer`):
command-r-35b, minitron-8b and the other dense configs, the encoder
hubert-xlarge (bidirectional, precomputed audio frames in) and the vlm
paligemma-3b (precomputed patch embeddings ahead of the text).

Parameters are a dict of tensors with layers stacked on a leading dim
([L, D, N]); the layer loop is a Python loop over that dim.  `apply` is
the whole-sequence forward of training (logits [B, S, V], differentiable
under the trainable plans, each layer recomputed in the backward when
`cfg.remat == "layer"`); `prefill` runs it once more collecting each
layer's K/V into a dense cache.  Serving runs over either KV cache:

  * the paged cache (a page pool per layer plus block tables):
    `decode_step` (one token per slot, the paged-attention kernel),
    `decode_verify` (T tokens per slot, the speculative verify: one
    multi-query paged-attention launch per layer) and `prefill_chunk` /
    `prefill_chunk_batched` (one prefill chunk per slot: where
    `paged.fused_prefill_applies`, the fused prefill kernel does attention
    + KV encode + page insert in one launch; otherwise the decomposed path
    encodes and inserts the chunk's KV, then runs flash attention over
    decoded history plus the raw chunk);
  * the dense cache ([L, B, max_seq, Hkv*Dh] rows per slot, `layout=None`):
    `decode_step` writes the token's codes at its position and attends the
    decoded row with `common.decode_attention`, and the prefill chunks run
    flash attention over the decoded row plus the raw chunk, as the
    reference does outside its kernels.

Both caches are updated in place.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.kernels import dispatch, ops
from repro_torch.kernels.prefill_attention import decomposed_prefill
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
        specs["frontend_proj"] = ParamSpec(
            (cfg.frontend_dim, D), (None, "embed"), "fan_in")
    return specs


def layer_flags(cfg: ModelConfig):
    """Per-layer is_global (full attention) flags, as python bools."""
    return [cfg.layer_is_global(i) for i in range(cfg.n_layers)]


def _layer(params, i: int):
    return {k: v[i] for k, v in params["layers"].items()}


def _head(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def swiglu(h, w_gate, w_up, w_down, cfg: ModelConfig):
    """silu(h @ w_gate) * (h @ w_up) @ w_down through the GEMM dispatch
    (the dense MLP, and the MoE's shared experts)."""
    g = common.qdot(h, w_gate, cfg.quant)
    u = common.qdot(h, w_up, cfg.quant)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(h.dtype) * u
    return common.qdot(h, w_down, cfg.quant, prec_dtype=common.tp_prec(cfg))


def _mlp_block(p, x, cfg: ModelConfig):
    h = common.rms_norm(x, p["ln2"], upcast=not cfg.tp_bf16_reduce)
    return swiglu(h, p["wi_gate"], p["wi_up"], p["wo_mlp"], cfg)


def _mlp_ffn(p, x, cfg: ModelConfig):
    """The dense layer's feed-forward block as an `ffn`: (output, aux),
    with no auxiliary loss (None)."""
    return _mlp_block(p, x, cfg), None


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


def _dense_window(cfg: ModelConfig, is_global: bool) -> Optional[int]:
    """The window of the plain attentions (None without sliding windows)."""
    return None if cfg.sliding_window is None else _window(cfg, is_global)


def _attn(p, x, cfg: ModelConfig, pos, is_global: bool):
    """Causal self-attention over the whole sequence x [B, S, D] at
    positions pos [B, S] (the plain streaming-softmax attention); returns
    (the post-wo output, k, v), k / v [B, S, Hkv, Dh] for a cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, pos)
    attn = common.flash_attention(q, k, v, pos, pos, causal=cfg.causal,
                                  window=_dense_window(cfg, is_global),
                                  softcap_val=cfg.logit_softcap)
    out = common.qdot(attn.reshape(B, S, cfg.n_heads * cfg.head_dim),
                      p["wo"], cfg.quant, prec_dtype=common.tp_prec(cfg))
    return out, k, v


def _seq_layer(p, x, cfg: ModelConfig, pos, is_global: bool, ffn=_mlp_ffn):
    """One layer of the whole-sequence forward: (x', the ffn's aux)."""
    x = x + _attn(p, x, cfg, pos, is_global)[0]
    out, aux = ffn(p, x, cfg)
    return x + out, aux


def _embed_inputs(params, batch, cfg: ModelConfig):
    """The model's input rows [B, S, D] in the compute dtype: the token
    embeddings; for the audio stub (an encoder) the frames [B, S, F]
    projected by `frontend_proj` in their place; for the vision stub the
    patches [B, P, F] projected and put ahead of the tokens' embeddings
    (S = P + T).  `frontend_proj` is a plain float product, as the
    reference's `jnp.dot` outside any kernel."""
    if cfg.frontend is None:
        return common.embed_tokens(params["embed"], batch["tokens"], cfg)
    cd = cfg.compute_dtype
    proj = params["frontend_proj"].to(cd)
    if cfg.frontend == "audio_stub":
        return torch.matmul(batch["frames"].to(cd), proj)
    if cfg.frontend == "vision_stub":
        patches = torch.matmul(batch["patches"].to(cd), proj)
        text = common.embed_tokens(params["embed"], batch["tokens"], cfg)
        return torch.cat([patches, text], 1)
    raise ValueError(cfg.frontend)


def apply(params, batch, cfg: ModelConfig, collect_cache: bool = False,
          with_aux: bool = False, ffn=_mlp_ffn):
    """Training / prefill forward. batch: {"tokens": [B, S] int}, or the
    stub frontend's inputs (`_embed_inputs`; positions run 0..S-1 over
    the whole sequence, patches included).  Returns f32 logits [B, S, V]; with `collect_cache` also each layer's (k, v)
    [B, S, Hkv, Dh] in a list, and with `with_aux` last the mean over the
    layers of the ffn's auxiliary loss.  `ffn(p, x, cfg) -> (out, aux)` is
    the layer's feed-forward block: the dense MLP here, the routed experts
    in models/moe.py.  With `cfg.remat == "layer"` (and no cache to
    collect) each layer's activations are dropped after the forward and
    recomputed in the backward (`torch.utils.checkpoint`, aux included;
    the recompute is bitwise the first forward, the kernels and the
    routing being deterministic)."""
    x = _embed_inputs(params, batch, cfg)
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32,
                       device=x.device)[None].expand(B, S)
    names = sorted(params["layers"])
    # one unbind per stacked leaf: its backward stacks the layers' grads
    # (a per-layer index would zero-fill a full-size grad each layer)
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
    kvs, auxes = [], []
    for vals, is_global in zip(per_layer, layer_flags(cfg)):
        p = dict(zip(names, vals))
        if collect_cache:
            out, k, v = _attn(p, x, cfg, pos, is_global)
            x = x + out
            out, aux = ffn(p, x, cfg)
            x = x + out
            kvs.append((k, v))
        elif cfg.remat == "layer" and torch.is_grad_enabled():
            x, aux = torch.utils.checkpoint.checkpoint(
                _seq_layer, p, x, cfg, pos, is_global, ffn,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _seq_layer(p, x, cfg, pos, is_global, ffn)
        auxes.append(aux)
    x = common.rms_norm(x, params["final_norm"])
    logits = common.logits_head(x, _head(params, cfg), cfg,
                                transpose=cfg.tie_embeddings)
    outs = [logits]
    if collect_cache:
        outs.append(kvs)
    if with_aux:
        outs.append(torch.stack(auxes).mean())
    return outs[0] if len(outs) == 1 else tuple(outs)


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


def _paged_attn_tokens(p, xs, cfg: ModelConfig, k_l, v_l, bt, length,
                       is_global):
    """T-token attention sub-block over paged KV (the speculative verify).

    xs: T tensors [B, 1, D], token t of every slot; length: [B]
    pre-insert valid counts.  Each token's projections run at the decode
    step's shapes; the T tokens' KV codes are written at positions
    length + [0, T) (what T decode steps would write), then one
    multi-query paged-attention launch attends all T rows, token t over
    positions <= length + t.  Returns the post-wo outputs, T x [B, 1, D]."""
    B = xs[0].shape[0]
    T = len(xs)
    Hq, Dh = cfg.n_heads, cfg.head_dim
    qkv = [_qkv(p, x, cfg, (length + t)[:, None]) for t, x in enumerate(xs)]
    for j, pool in ((1, k_l), (2, v_l)):
        codes = [common.kv_encode(cfg, t[j].reshape(B, -1)) for t in qkv]
        paged.insert_chunk_batched(pool, bt, length, torch.stack(codes, 1))
    attn = ops.paged_attention(
        torch.cat([q for q, _, _ in qkv], 1), k_l, v_l, bt, length + T,
        _window_arr(cfg, is_global, xs[0].device), fmt_kv=cfg.quant.kv_cache,
        softcap_val=cfg.logit_softcap)
    return [common.qdot(attn[:, t].reshape(B, 1, Hq * Dh).to(x.dtype),
                        p["wo"], cfg.quant) for t, x in enumerate(xs)]


def _chunk_attn_batched(p, x, cfg: ModelConfig, k_l, v_l, starts, bt,
                        is_global: bool, active=None):
    """Cross-slot batched prefill-chunk attention: queries of slot b sit at
    starts[b] + [0, C) and attend that slot's history plus themselves;
    intra-chunk attention uses the raw (pre-encode) k/v.  x: [B, C, D];
    starts [B] int32.  Paged (bt [B, M], inactive rows zeroed: their writes
    land on the trash page): where `paged.fused_prefill_applies`, one
    fused prefill launch (ops.prefill_attention_paged) replaces the three
    stages of `decomposed_prefill`.  Dense (bt None, k_l / v_l [B, S, F]):
    `_dense_chunk_attn`, whose writes skip the rows `active` marks False.
    Returns the post-wo output [B, C, D]."""
    B, C, _ = x.shape
    Hq, Dh = cfg.n_heads, cfg.head_dim
    pos = starts.long()[:, None] + torch.arange(C, device=x.device)[None]
    q, k, v = _qkv(p, x, cfg, pos)
    if bt is None:
        attn = _dense_chunk_attn(q, k, v, cfg, k_l, v_l, starts, pos,
                                 is_global, active)
        return common.qdot(attn.reshape(B, C, Hq * Dh), p["wo"], cfg.quant,
                           prec_dtype=common.tp_prec(cfg))
    window = _window_arr(cfg, is_global, x.device)
    if paged.fused_prefill_applies(cfg.quant, bt.shape[1], k_l.shape[1], C):
        attn, _, _ = ops.prefill_attention_paged(
            q, k, v, k_l, v_l, bt, starts.to(torch.int32), window,
            fmt_kv=cfg.quant.kv_cache, compute_dtype=cfg.compute_dtype,
            softcap_val=cfg.logit_softcap, flash_chunk=paged.FLASH_CHUNK)
    else:
        attn, _, _ = decomposed_prefill(
            q, k, v, k_l, v_l, bt, starts, window,
            encode=functools.partial(common.kv_encode, cfg),
            decode=functools.partial(common.kv_decode, cfg),
            softcap_val=cfg.logit_softcap, flash_chunk=paged.FLASH_CHUNK)
    return common.qdot(attn.reshape(B, C, Hq * Dh), p["wo"], cfg.quant,
                       prec_dtype=common.tp_prec(cfg))


def _dense_chunk_attn(q, k, v, cfg: ModelConfig, k_l, v_l, starts, pos,
                      is_global: bool, active=None):
    """The dense cache's chunk attention: flash attention over the slot's
    decoded cache row (positions below starts[b]; the rest masked as
    unwritten) plus the raw chunk, then the chunk's KV codes are written at
    [b, starts[b] + j] of every active row (the reference writes every row
    and reverts the inactive ones).  q / k / v: [B, C, H, Dh] after rope;
    k_l / v_l: [B, S, F].  Returns the attention output [B, C, Hq, Dh]."""
    B, C, Hkv, Dh = k.shape
    S_h = k_l.shape[1]
    hist_pos = torch.arange(S_h, device=q.device)[None].expand(B, S_h)
    hist_pos = torch.where(hist_pos < starts.long()[:, None], hist_pos,
                           torch.full_like(hist_pos, -1))
    kd = common.kv_decode(cfg, k_l).reshape(B, S_h, Hkv, Dh).to(k.dtype)
    vd = common.kv_decode(cfg, v_l).reshape(B, S_h, Hkv, Dh).to(v.dtype)
    attn = common.flash_attention(
        q, torch.cat([kd, k], 1), torch.cat([vd, v], 1), pos,
        torch.cat([hist_pos, pos], 1), causal=True,
        window=_dense_window(cfg, is_global), chunk_k=paged.FLASH_CHUNK,
        softcap_val=cfg.logit_softcap)
    rows = (torch.arange(B, device=q.device) if active is None
            else torch.nonzero(active)[:, 0])
    for pool, t in ((k_l, k), (v_l, v)):
        codes = common.kv_encode(cfg, t.reshape(B, C, -1))
        pool[rows[:, None], pos[rows]] = codes[rows].to(pool.dtype)
    return attn


def _chunk_attn(p, x, cfg: ModelConfig, k_l, v_l, start, bt_row,
                is_global: bool, slot=None):
    """Prefill-chunk attention for one slot (the per-slot path): x [1, C, D]
    at positions start + [0, C) of the slot whose block-table row is
    bt_row [M] (paged), or of row `slot` of the dense pools (bt_row None)."""
    starts = torch.reshape(start, (1,)).to(torch.int32)
    if bt_row is None:
        return _chunk_attn_batched(p, x, cfg, k_l[slot:slot + 1],
                                   v_l[slot:slot + 1], starts, None,
                                   is_global)
    return _chunk_attn_batched(p, x, cfg, k_l, v_l, starts, bt_row[None],
                               is_global)


# ---------------------------------------------------------------------------
# serving: cache container + prefill + decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                layout: Optional[PagedLayout] = None):
    """Abstract KV cache at KV code width.  layout=None: dense rows
    [L, B, max_seq, Hkv*Dh] per k / v plus `length`; with a PagedLayout: a
    page pool [L, n_pages, page_size, Hkv*Dh] plus per-slot block tables."""
    dt = common.kv_store_dtype(cfg)
    if layout is None:
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads * cfg.head_dim)
        axes = ("layers", "batch", "kv_seq", "kv_heads")
        return {
            "k": ParamSpec(shape, axes, "zeros", dt),
            "v": ParamSpec(shape, axes, "zeros", dt),
            "length": ParamSpec((batch,), ("batch",), "zeros", torch.int32),
        }
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
               layout: Optional[PagedLayout] = None, device="cuda"):
    """The zeroed KV cache (dense with layout=None, else paged) on `device`
    (a card by default; raises without one, as every entry point does)."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_specs(cfg, batch, max_seq, layout))


def _cache_insert(cache_l, new_kv, length, active=None):
    """cache_l: [B, S, F]; new_kv: [B, 1, F]; writes row b at length[b]
    (in place), where `active` ([B] bool) is True or not given."""
    rows = torch.arange(cache_l.shape[0], device=cache_l.device)
    at = length.long()
    vals = new_kv[:, 0].to(cache_l.dtype)
    if active is not None:
        vals = torch.where(active[:, None], vals, cache_l[rows, at])
    cache_l[rows, at] = vals


def _dense_attn_token(p, x, cfg: ModelConfig, k_l, v_l, length, is_global,
                      active=None):
    """One-token attention sub-block over the dense cache: x [B, 1, D];
    k_l / v_l [B, S, F] (written in place); length [B] pre-insert valid
    counts.  Writes the token's KV codes at `length` of the rows `active`
    marks (all without it), decodes the rows and attends them
    (`common.decode_attention`).  Returns the post-wo output [B, 1, D]."""
    B = x.shape[0]
    S_max = k_l.shape[1]
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(p, x, cfg, length[:, None])
    _cache_insert(k_l, common.kv_encode(cfg, k.reshape(B, 1, -1)), length,
                  active)
    _cache_insert(v_l, common.kv_encode(cfg, v.reshape(B, 1, -1)), length,
                  active)
    kc = common.kv_decode(cfg, k_l).reshape(B, S_max, Hkv, Dh)
    vc = common.kv_decode(cfg, v_l).reshape(B, S_max, Hkv, Dh)
    kv_pos = torch.arange(S_max, dtype=torch.int32,
                          device=x.device)[None].expand(B, S_max)
    attn = common.decode_attention(q, kc, vc, length + 1, kv_pos,
                                   window=_dense_window(cfg, is_global),
                                   softcap_val=cfg.logit_softcap)
    return common.qdot(attn.reshape(B, 1, Hq * Dh), p["wo"], cfg.quant)


def decode_step(params, tokens, cache, cfg: ModelConfig, sample=None,
                ffn=_mlp_ffn, active=None):
    """One autoregressive step over the paged or the dense cache. tokens:
    [B] int32.

    Per layer the token's KV codes are written at position length[b] (in
    place: into the slot's current page, or row b of the dense pools) and
    attended (the paged-attention kernel, or `common.decode_attention` over
    the decoded rows); `ffn(p, x, cfg)` is the layer's feed-forward block
    (the dense MLP here, the routed experts in models/moe.py; its aux is
    dropped).  `active`
    ([B] bool, dense cache only) leaves the rows it marks False unwritten:
    an engine's free or mid-prefill slots (on the paged cache such rows
    carry zeroed block tables, so their writes land on the trash page).
    Returns
    (logits [B, V] f32, cache') — or, with `sample` (common.SampleSpec),
    ([B] int32 tokens, cache') from the fused head + sampler kernel."""
    B = tokens.shape[0]
    x = common.embed_tokens(params["embed"], tokens[:, None], cfg)
    length, bt = cache["length"], cache.get("block_table")
    for i, is_global in enumerate(layer_flags(cfg)):
        p = _layer(params, i)
        if bt is None:
            x = x + _dense_attn_token(p, x, cfg, cache["k"][i],
                                      cache["v"][i], length, is_global,
                                      active)
        else:
            x = x + _paged_attn_token(p, x, cfg, cache["k"][i],
                                      cache["v"][i], bt, length, is_global)
        x = x + ffn(p, x, cfg)[0]
    x = common.rms_norm(x, params["final_norm"])
    new_cache = dict(cache, length=length + 1)
    head = _head(params, cfg)
    if sample is not None:
        return common.sample_head(x[:, 0], head, cfg, sample,
                                  transpose=cfg.tie_embeddings), new_cache
    logits = common.logits_head(x, head, cfg, transpose=cfg.tie_embeddings)
    return logits[:, 0].reshape(B, -1), new_cache


def decode_verify(params, tokens, cache, cfg: ModelConfig, sample=None):
    """k-token speculative verify over the paged cache. tokens: [B, T]
    int32, per slot the committed next token and T-1 draft proposals.

    Per layer the T tokens' KV codes are written at positions
    length + [0, T) (in place) and one multi-query paged-attention launch
    attends all T query rows, token t over positions <= length + t; each
    row is bitwise the one-token kernel's at that length.  The dense work
    (norms, projections, MLP) runs token by token at the decode step's
    [B, 1, D] shapes: on the card a GEMM or a row reduction sums in an
    order that depends on its number of rows, and bf16 activations turn
    those last-bit differences into other tokens.  Each layer's weights
    are prepared once (`dispatch.Prepared`: rounded, encoded or decoded
    once, as the plan reads them) for the T tokens' GEMMs; under the
    fused plan with float activations each token's GEMMs read the codes
    through the float GEMV at the decode step's rows.  The result is T
    sequential `decode_step` calls over the same tokens, bitwise.  Returns
    ([B, T] int32 tokens from one fused head + sampler launch over the
    B*T rows, b-major (its rows are independent), with `sample`; else
    [B, T, V] f32 logits) and cache' with length + T.  Callers commit the
    accepted prefix and roll `length` back on the host; positions past the
    commit hold rejected codes at or after the new length, which no read
    sees before the next write."""
    if "block_table" not in cache:
        raise ValueError("decode_verify requires a paged cache")
    B, T = tokens.shape
    xs = [common.embed_tokens(params["embed"], tokens[:, t:t + 1], cfg)
          for t in range(T)]
    length, bt = cache["length"], cache["block_table"]
    for i, is_global in enumerate(layer_flags(cfg)):
        p = {k: dispatch.Prepared(v) if v.ndim == 2 else v
             for k, v in _layer(params, i).items()}
        attn = _paged_attn_tokens(p, xs, cfg, cache["k"][i], cache["v"][i],
                                  bt, length, is_global)
        xs = [x + a for x, a in zip(xs, attn)]
        xs = [x + _mlp_block(p, x, cfg) for x in xs]
    xs = [common.rms_norm(x, params["final_norm"]) for x in xs]
    new_cache = {"k": cache["k"], "v": cache["v"], "block_table": bt,
                 "length": length + T}
    head = _head(params, cfg)
    if sample is not None:
        toks = common.sample_head(torch.cat(xs, 1).reshape(B * T, -1), head,
                                  cfg, sample, transpose=cfg.tie_embeddings)
        return toks.reshape(B, T), new_cache
    head = dispatch.Prepared(head.T if cfg.tie_embeddings else head)
    logits = [common.logits_head(x, head, cfg, transpose=False) for x in xs]
    return torch.cat(logits, 1), new_cache


def prefill_chunk(params, tokens, cache, slot: int, cfg: ModelConfig,
                  ffn=_mlp_ffn):
    """Chunked prefill of prompt chunk `tokens` [1, C] for one slot of the
    paged or the dense cache, at positions length[slot] + [0, C).  Returns
    (last-position logits [1, 1, V], cache') with length[slot] advanced by
    C."""
    C = tokens.shape[1]
    x = common.embed_tokens(params["embed"], tokens, cfg)
    start = cache["length"][slot]
    bt_row = cache["block_table"][slot] if "block_table" in cache else None
    for i, is_global in enumerate(layer_flags(cfg)):
        p = _layer(params, i)
        x = x + _chunk_attn(p, x, cfg, cache["k"][i], cache["v"][i], start,
                            bt_row, is_global, slot=slot)
        x = x + ffn(p, x, cfg)[0]
    x = common.rms_norm(x[:, -1:], params["final_norm"])
    logits = common.logits_head(x, _head(params, cfg), cfg,
                                transpose=cfg.tie_embeddings)
    length = cache["length"].clone()
    length[slot] = start + C
    return logits, dict(cache, length=length)


def prefill_chunk_batched(params, tokens, cache, active, cfg: ModelConfig,
                          ffn=_mlp_ffn):
    """Cross-slot batched chunked prefill: one [B, C] pass advances every
    active slot by a chunk of the same bucket size.  The caller zeroes
    inactive rows' length/block-table metadata, so their paged writes land
    on the trash page; the dense cache's inactive rows are not written.
    Returns (last-position logits [B, V], cache')."""
    C = tokens.shape[1]
    x = common.embed_tokens(params["embed"], tokens, cfg)
    starts, bt = cache["length"], cache.get("block_table")
    for i, is_global in enumerate(layer_flags(cfg)):
        p = _layer(params, i)
        x = x + _chunk_attn_batched(p, x, cfg, cache["k"][i], cache["v"][i],
                                    starts, bt, is_global, active=active)
        x = x + ffn(p, x, cfg)[0]
    x = common.rms_norm(x[:, -1:], params["final_norm"])
    logits = common.logits_head(x, _head(params, cfg), cfg,
                                transpose=cfg.tie_embeddings)
    length = cache["length"] + torch.where(
        active, C, 0).to(torch.int32)
    return logits[:, 0], dict(cache, length=length)


def prefill(params, batch, cfg: ModelConfig, max_seq: Optional[int] = None,
            ffn=_mlp_ffn):
    """Whole-sequence forward (`apply`) that also builds the dense KV cache:
    returns (logits [B, S, V], {"k", "v": [L, B, max(max_seq, S), Hkv*Dh]
    codes, positions past S zero; "length": [B] = S})."""
    logits, kvs = apply(params, batch, cfg, collect_cache=True, ffn=ffn)
    B, S = kvs[0][0].shape[:2]
    rows = max(max_seq or S, S)
    cache = init_cache(cfg, B, rows, device=logits.device)
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :S] = common.kv_encode(cfg, k.reshape(B, S, -1))
        cache["v"][i, :, :S] = common.kv_encode(cfg, v.reshape(B, S, -1))
    cache["length"].fill_(S)
    return logits, cache
