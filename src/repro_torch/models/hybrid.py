"""Jamba-style hybrid — jamba-1.5-large-398b (PyTorch port of
`repro.models.hybrid`): Mamba + attention 1:7 interleave, MoE (16 experts
top-2) every other layer.

Layer pattern per period of `attn_interval` layers (8; the smoke config's
2):
    j == 0     : attention sub-layer (always global)
    j >= 1     : mamba2 sub-layer
    j even     : dense FFN      j odd : MoE FFN

Parameters are stacked per period ("blocks": [nb, ...], the mamba and
FFN sub-trees [nb, n, ...] over the period's sub-layers), as the
reference stacks them; the block loop is a Python loop.  The attention
sub-layers are `transformer`'s: the paged decode through K3
(`_paged_attn_token`), chunk prefill through `_chunk_attn` /
`_chunk_attn_batched` (one fused K5 launch where it applies), the dense
cache through `_dense_attn_token`; the MoE sub-layers are `moe.moe_ffn`
(K9 on packed expert stacks), the dense ones `transformer._mlp_block`.

The cache holds KV (dense rows [nb, B, max_seq, F] or a page pool [nb,
n_pages, page_size, F] behind a block table shared by the blocks) and
per-period conv / SSM states ([nb, attn_interval - 1, B, ...], never
paged).  The serving functions update it in place; `active` ([B] bool)
leaves the state rows (and the dense KV rows) it marks False unwritten.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from . import common, moe, transformer
from . import mamba as mamba_m
from .config import ModelConfig
from .module import ParamSpec, tree_map
from .paged import PagedLayout

_F32 = torch.float32


def _period(cfg: ModelConfig) -> int:
    return cfg.attn_interval


def _n_blocks(cfg: ModelConfig) -> int:
    if cfg.attn_interval < 1 or cfg.n_layers % cfg.attn_interval:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_interval {cfg.attn_interval}")
    return cfg.n_layers // cfg.attn_interval


def _ffn_split(cfg: ModelConfig):
    per = _period(cfg)
    moe_js = [j for j in range(per)
              if j % cfg.moe_interval == cfg.moe_interval - 1]
    dense_js = [j for j in range(per) if j not in moe_js]
    return dense_js, moe_js


def param_specs(cfg: ModelConfig):
    D, V = cfg.d_model, cfg.vocab_size
    nb, per = _n_blocks(cfg), _period(cfg)
    Hq, Hkv, Dh, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    E, Fe = cfg.n_experts, cfg.moe_d_ff
    dense_js, moe_js = _ffn_split(cfg)
    nd, nm = len(dense_js), len(moe_js)

    attn = {
        "ln1": ParamSpec((nb, D), ("stack", None), "zeros"),
        "wq": ParamSpec((nb, D, Hq * Dh), ("stack", "embed", "heads"), "fan_in"),
        "wk": ParamSpec((nb, D, Hkv * Dh), ("stack", "embed", "heads"), "fan_in"),
        "wv": ParamSpec((nb, D, Hkv * Dh), ("stack", "embed", "heads"), "fan_in"),
        "wo": ParamSpec((nb, Hq * Dh, D), ("stack", "heads", "embed"), "fan_in"),
    }
    mamba_specs = {
        k: ParamSpec((nb, per - 1) + s.shape[1:],
                     ("stack", None) + s.logical_axes[1:], s.init, s.dtype)
        for k, s in mamba_m.layer_param_specs(cfg, 1).items()
    }
    ffn = {
        "ln2": ParamSpec((nb, nd, D), ("stack", None, None), "zeros"),
        "wi_gate": ParamSpec((nb, nd, D, F), ("stack", None, "embed", "mlp"), "fan_in"),
        "wi_up": ParamSpec((nb, nd, D, F), ("stack", None, "embed", "mlp"), "fan_in"),
        "wo_mlp": ParamSpec((nb, nd, F, D), ("stack", None, "mlp", "embed"), "fan_in"),
    }
    moe_specs = {
        "ln2": ParamSpec((nb, nm, D), ("stack", None, None), "zeros"),
        "router": ParamSpec((nb, nm, D, E), ("stack", None, "embed", "experts"), "fan_in"),
        "we_gate": ParamSpec((nb, nm, E, D, Fe), ("stack", None, "experts", "embed", "expert_mlp"), "fan_in"),
        "we_up": ParamSpec((nb, nm, E, D, Fe), ("stack", None, "experts", "embed", "expert_mlp"), "fan_in"),
        "we_down": ParamSpec((nb, nm, E, Fe, D), ("stack", None, "experts", "expert_mlp", "embed"), "fan_in"),
    }
    return {
        "embed": ParamSpec((V, D), ("vocab", "embed"), "embed"),
        "blocks": {"attn": attn, "mamba": mamba_specs, "ffn": ffn,
                   "moe": moe_specs},
        "final_norm": ParamSpec((D,), (None,), "zeros"),
    }


def _sub(tree, idx):
    return {k: v[idx] for k, v in tree.items()}


def _block(params, b: int):
    """Block b's sub-trees: attn leaves [...], mamba / ffn / moe [n, ...]."""
    return {name: _sub(sub, b) for name, sub in params["blocks"].items()}


def _ffn_apply(blk, j: int, x, cfg: ModelConfig):
    """Sub-layer j's feed-forward block with its residual: (x', aux), aux
    the router's load-balance loss (0 for a dense FFN)."""
    dense_js, moe_js = _ffn_split(cfg)
    if j in moe_js:
        p = _sub(blk["moe"], moe_js.index(j))
        y, aux = moe.moe_ffn(p, common.rms_norm(x, p["ln2"]), cfg)
        return x + y, aux
    p = _sub(blk["ffn"], dense_js.index(j))
    return (x + transformer._mlp_block(p, x, cfg),
            torch.zeros((), dtype=_F32, device=x.device))


def _mamba_sub(blk, j, x, cfg: ModelConfig, conv_l, ssm_l, active=None,
               single_step=False):
    """Mamba sub-layer j >= 1 over the period's state rows conv_l / ssm_l
    ([per - 1, B, ...], written in place where `active`); returns x'."""
    out, cs, ss = mamba_m.mamba_block(
        _sub(blk["mamba"], j - 1), x, cfg, conv_state=conv_l[j - 1],
        ssm_state=ssm_l[j - 1], single_step=single_step)
    mamba_m.put_rows(conv_l[j - 1], cs, active)
    mamba_m.put_rows(ssm_l[j - 1], ss, active)
    return x + out


def _seq_block(blk, x, cfg: ModelConfig, pos, kvs=None):
    """One block (period) of the whole-sequence forward: (x', the mean of
    its sub-layers' aux losses); the attention's (k, v) appended to `kvs`
    where given."""
    block_aux = []
    for j in range(_period(cfg)):
        if j == 0:
            out, k, v = transformer._attn(blk["attn"], x, cfg, pos, True)
            if kvs is not None:
                kvs.append((k, v))
        else:
            out = mamba_m.mamba_block(_sub(blk["mamba"], j - 1), x, cfg)[0]
        x, aux = _ffn_apply(blk, j, x + out, cfg)
        block_aux.append(aux)
    return x, torch.stack(block_aux).mean()


def apply(params, batch, cfg: ModelConfig, collect_cache: bool = False,
          with_aux: bool = False):
    """Whole-sequence forward: f32 logits [B, S, V]; with `collect_cache`
    also each block's attention (k, v) [B, S, Hkv, Dh] in a list, and with
    `with_aux` last the mean over the blocks of each block's mean
    sub-layer aux loss.  With `cfg.remat == "layer"` (grad on, no cache to
    collect) each block is recomputed in the backward
    (`torch.utils.checkpoint`, its aux loss included; the recompute routes
    the tokens as the first forward did)."""
    x = common.embed_tokens(params["embed"], batch["tokens"], cfg)
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32,
                       device=x.device)[None].expand(B, S)
    kvs, auxes = [], []
    for b in range(_n_blocks(cfg)):
        blk = _block(params, b)
        if collect_cache:
            x, aux = _seq_block(blk, x, cfg, pos, kvs)
        elif cfg.remat == "layer" and torch.is_grad_enabled():
            x, aux = torch.utils.checkpoint.checkpoint(
                _seq_block, blk, x, cfg, pos, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux = _seq_block(blk, x, cfg, pos)
        auxes.append(aux)
    x = common.rms_norm(x, params["final_norm"])
    logits = common.logits_head(x, params["embed"], cfg, transpose=True)
    outs = [logits]
    if collect_cache:
        outs.append(kvs)
    if with_aux:
        outs.append(torch.stack(auxes).mean())
    return outs[0] if len(outs) == 1 else tuple(outs)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                layout: Optional[PagedLayout] = None):
    """Per-block KV (dense rows, or posit-coded pages behind a PagedLayout
    with one block table for all blocks) plus per-period conv / SSM states
    (O(1) in sequence, never paged)."""
    nb, per = _n_blocks(cfg), _period(cfg)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.ssm_d_inner + 2 * N
    dt = common.kv_store_dtype(cfg)
    specs = {
        "ssm": ParamSpec((nb, per - 1, batch, H, P, N),
                         ("stack", None, "batch", "ssm_heads", None, None), "zeros"),
        "conv": ParamSpec((nb, per - 1, batch, cfg.ssm_conv - 1, conv_ch),
                          ("stack", None, "batch", None, "ssm_heads"), "zeros", _F32),
        "length": ParamSpec((batch,), ("batch",), "zeros", torch.int32),
    }
    if layout is None:
        kv_shape = (nb, batch, max_seq, cfg.n_kv_heads * cfg.head_dim)
        kv_axes = ("stack", "batch", "kv_seq", "kv_heads")
    else:
        kv_shape = (nb, layout.n_pages, layout.page_size,
                    cfg.n_kv_heads * cfg.head_dim)
        kv_axes = ("stack", "kv_pages", None, "kv_heads")
        specs["block_table"] = ParamSpec(
            (batch, layout.pages_per_slot(max_seq)), ("batch", None),
            "zeros", torch.int32)
    specs["k"] = ParamSpec(kv_shape, kv_axes, "zeros", dt)
    specs["v"] = ParamSpec(kv_shape, kv_axes, "zeros", dt)
    return specs


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               layout: Optional[PagedLayout] = None, device="cuda"):
    from repro_torch import resolve_device
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_specs(cfg, batch, max_seq, layout))


def prefill(params, batch, cfg: ModelConfig, max_seq=None):
    """Whole-sequence prefill into the dense cache: (logits [B, S, V],
    {"k", "v": [nb, B, max(max_seq, S), F] codes, positions past S zero;
    "conv", "ssm": the final states; "length": [B] = S})."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = common.embed_tokens(params["embed"], tokens, cfg)
    cache = init_cache(cfg, B, max(max_seq or S, S), device=x.device)
    pos = torch.arange(S, dtype=torch.int32,
                       device=x.device)[None].expand(B, S)
    for b in range(_n_blocks(cfg)):
        blk = _block(params, b)
        for j in range(_period(cfg)):
            if j == 0:
                out, k, v = transformer._attn(blk["attn"], x, cfg, pos, True)
                cache["k"][b, :, :S] = common.kv_encode(cfg, k.reshape(B, S, -1))
                cache["v"][b, :, :S] = common.kv_encode(cfg, v.reshape(B, S, -1))
                x = x + out
            else:
                out, cs, ss = mamba_m.mamba_block(_sub(blk["mamba"], j - 1),
                                                  x, cfg)
                cache["conv"][b, j - 1] = cs.to(_F32)
                cache["ssm"][b, j - 1] = ss
                x = x + out
            x = _ffn_apply(blk, j, x, cfg)[0]
    x = common.rms_norm(x, params["final_norm"])
    logits = common.logits_head(x, params["embed"], cfg, transpose=True)
    cache["length"].fill_(S)
    return logits, cache


def prefill_chunk(params, tokens, cache, slot: int, cfg: ModelConfig):
    """Chunked prefill for one slot: the attention sub-layers write and
    read the slot's KV (pages or its dense row; the fused prefill kernel
    where it applies), the mamba sub-layers carry the slot's conv / SSM
    states across chunks.  Returns (the last position's logits [1, 1, V],
    cache')."""
    C = tokens.shape[1]
    x = common.embed_tokens(params["embed"], tokens, cfg)
    start = cache["length"][slot]
    bt_row = cache["block_table"][slot] if "block_table" in cache else None
    for b in range(_n_blocks(cfg)):
        blk = _block(params, b)
        conv_l = cache["conv"][b, :, slot:slot + 1]
        ssm_l = cache["ssm"][b, :, slot:slot + 1]
        for j in range(_period(cfg)):
            if j == 0:
                x = x + transformer._chunk_attn(
                    blk["attn"], x, cfg, cache["k"][b], cache["v"][b], start,
                    bt_row, True, slot=slot)
            else:
                x = _mamba_sub(blk, j, x, cfg, conv_l, ssm_l)
            x = _ffn_apply(blk, j, x, cfg)[0]
    x = common.rms_norm(x[:, -1:], params["final_norm"])
    logits = common.logits_head(x, params["embed"], cfg, transpose=True)
    length = cache["length"].clone()
    length[slot] += C
    return logits, dict(cache, length=length)


def prefill_chunk_batched(params, tokens, cache, active, cfg: ModelConfig):
    """Cross-slot batched chunked prefill: the attention sub-layers run the
    batched chunk attention over every slot's own pages / rows (inactive
    paged rows carry zeroed block tables; inactive dense rows are not
    written), the mamba sub-layers carry all slots' states at once and
    write the active rows.  Returns (last-position logits [B, V],
    cache')."""
    C = tokens.shape[1]
    x = common.embed_tokens(params["embed"], tokens, cfg)
    starts, bt = cache["length"], cache.get("block_table")
    for b in range(_n_blocks(cfg)):
        blk = _block(params, b)
        for j in range(_period(cfg)):
            if j == 0:
                x = x + transformer._chunk_attn_batched(
                    blk["attn"], x, cfg, cache["k"][b], cache["v"][b],
                    starts, bt, True, active=active)
            else:
                x = _mamba_sub(blk, j, x, cfg, cache["conv"][b],
                               cache["ssm"][b], active)
            x = _ffn_apply(blk, j, x, cfg)[0]
    x = common.rms_norm(x[:, -1:], params["final_norm"])
    logits = common.logits_head(x, params["embed"], cfg, transpose=True)
    length = cache["length"] + torch.where(active, C, 0).to(torch.int32)
    return logits[:, 0], dict(cache, length=length)


def decode_step(params, tokens, cache, cfg: ModelConfig, sample=None,
                active=None):
    """One token per slot over the paged cache (K3 on the attention
    sub-layers) or the dense one (`common.decode_attention`).  tokens: [B]
    int32.  Returns (logits [B, V] f32, cache'), or with `sample`
    (common.SampleSpec) ([B] int32 tokens, cache') from the fused head +
    sampler kernel."""
    x = common.embed_tokens(params["embed"], tokens[:, None], cfg)
    length, bt = cache["length"], cache.get("block_table")
    for b in range(_n_blocks(cfg)):
        blk = _block(params, b)
        k_l, v_l = cache["k"][b], cache["v"][b]
        for j in range(_period(cfg)):
            if j == 0 and bt is None:
                x = x + transformer._dense_attn_token(
                    blk["attn"], x, cfg, k_l, v_l, length, True, active)
            elif j == 0:
                x = x + transformer._paged_attn_token(
                    blk["attn"], x, cfg, k_l, v_l, bt, length, True)
            else:
                x = _mamba_sub(blk, j, x, cfg, cache["conv"][b],
                               cache["ssm"][b], active, single_step=True)
            x = _ffn_apply(blk, j, x, cfg)[0]
    x = common.rms_norm(x, params["final_norm"])
    new_cache = dict(cache, length=length + 1)
    if sample is not None:
        return common.sample_head(x[:, 0], params["embed"], cfg, sample,
                                  transpose=True), new_cache
    logits = common.logits_head(x, params["embed"], cfg, transpose=True)
    return logits[:, 0], new_cache
