"""Mamba2 (SSD, state-space duality) — mamba2-1.3b, and the Mamba
sub-layers of jamba-1.5-large (PyTorch port of `repro.models.mamba`).

Prefill runs the chunked SSD form (intra-chunk attention-like products
plus an inter-chunk state carried in chunk order); decode carries an O(1)
recurrent state per layer and slot: the depthwise conv's last K-1 inputs
and the SSM state [H, P, N].  Posit quantization applies to the in / out
projections (`common.qdot`: the float GEMV at decode rows, K1 +
`torch.matmul` above 8 rows on the card); the conv, the SSD scan and the
recurrent state stay f32, as the reference keeps them.  Everything here
is plain PyTorch ops: the reference's SSD and conv reach no Pallas kernel.

The SSD's sums (XLA's `cumsum` and contraction orders, its `exp` and
`softplus`) cannot be reproduced bit for bit: the parity tests hold
`ssd_forward` / `ssd_decode_step` to a tolerance scaled to the largest
|value|.  The conv keeps the reference's tap order, so its tap sum is
the reference's exactly.

Caches carry no KV pages (`layout` is ignored): {"conv": [L, B, K-1,
conv_ch] f32, "ssm": [L, B, H, P, N] f32, "length": [B]}.  The serving
functions update "conv" / "ssm" in place; `active` ([B] bool) leaves the
rows it marks False unwritten (an engine's free or mid-prefill slots).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from . import common
from .config import ModelConfig
from .module import ParamSpec, tree_map

_G = 1  # B/C groups (mamba2 default ngroups=1)
_F32 = torch.float32


def layer_param_specs(cfg: ModelConfig, L: int, prefix_axis="layers"):
    D = cfg.d_model
    Di = cfg.ssm_d_inner
    N = cfg.ssm_state
    H = cfg.ssm_heads
    conv_ch = Di + 2 * _G * N
    proj_out = 2 * Di + 2 * _G * N + H
    return {
        "ln": ParamSpec((L, D), (prefix_axis, None), "zeros"),
        "in_proj": ParamSpec((L, D, proj_out), (prefix_axis, "embed", "ssm_heads"), "fan_in"),
        "conv_w": ParamSpec((L, cfg.ssm_conv, conv_ch), (prefix_axis, None, "ssm_heads"), "fan_in"),
        "conv_b": ParamSpec((L, conv_ch), (prefix_axis, "ssm_heads"), "zeros"),
        "A_log": ParamSpec((L, H), (prefix_axis, None), "arange1"),
        "D_skip": ParamSpec((L, H), (prefix_axis, None), "ones"),
        "dt_bias": ParamSpec((L, H), (prefix_axis, None), "zeros"),
        "norm": ParamSpec((L, Di), (prefix_axis, "ssm_heads"), "zeros"),
        "out_proj": ParamSpec((L, Di, D), (prefix_axis, "ssm_heads", "embed"), "fan_in"),
    }


def param_specs(cfg: ModelConfig):
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    return {
        "embed": ParamSpec((V, D), ("vocab", "embed"), "embed"),
        "layers": layer_param_specs(cfg, L),
        "final_norm": ParamSpec((D,), (None,), "zeros"),
    }


# ---------------------------------------------------------------------------
# core SSD math
# ---------------------------------------------------------------------------


def _silu(x):
    """jax.nn.silu's definition, x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def _softplus(x):
    """jax.nn.softplus's definition, logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(cfg: ModelConfig, zxbcdt):
    Di, N = cfg.ssm_d_inner, cfg.ssm_state
    z = zxbcdt[..., :Di]
    xs = zxbcdt[..., Di:2 * Di]
    B_ = zxbcdt[..., 2 * Di:2 * Di + _G * N]
    C_ = zxbcdt[..., 2 * Di + _G * N:2 * Di + 2 * _G * N]
    dt = zxbcdt[..., 2 * Di + 2 * _G * N:]
    return z, xs, B_, C_, dt


def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv, taps K = w.shape[0]. xBC: [B, S, C].

    state: [B, K-1, C] trailing context (decode, chunked prefill); returns
    (out, new_state).  The taps are summed in the reference's order."""
    K = w.shape[0]
    S = xBC.shape[1]
    if state is None:
        pad = torch.zeros((xBC.shape[0], K - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], 1)  # [B, S+K-1, C]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    out = _silu((out + b).to(_F32)).to(xBC.dtype)
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out, new_state


def ssd_forward(cfg: ModelConfig, xs, B_, C_, dt, A_log, dt_bias,
                init_state=None):
    """Chunked SSD. xs: [B, S, Di]; B_ / C_: [B, S, G*N]; dt: [B, S, H].

    Returns (y [B, S, H, P], final_state [B, H, P, N]), f32 inside.  S must
    be a multiple of min(ssm_chunk, S)."""
    Bb, S, _ = xs.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by ssd chunk {Q}")
    nc = S // Q
    x = xs.reshape(Bb, nc, Q, H, P).to(_F32)
    Bm = B_.reshape(Bb, nc, Q, _G, N).to(_F32)
    Cm = C_.reshape(Bb, nc, Q, _G, N).to(_F32)
    dt = _softplus(dt.to(_F32) + dt_bias).reshape(Bb, nc, Q, H)
    A = -torch.exp(A_log.to(_F32))  # [H], negative
    cums = torch.cumsum(dt * A, dim=2)  # inclusive decay within the chunk
    state = (torch.zeros((Bb, H, P, N), dtype=_F32, device=xs.device)
             if init_state is None else init_state)
    idx = torch.arange(Q, device=xs.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]  # causal
    ys = []
    for c in range(nc):
        xq, Bq, Cq, dtq, cq = x[:, c], Bm[:, c], Cm[:, c], dt[:, c], cums[:, c]
        # intra-chunk (attention-like); the masked (i < j) entries are
        # clamped before exp, as in the reference
        CB = torch.einsum("bqgn,bkgn->bqk", Cq, Bq)  # G = 1
        dlt = torch.clamp(cq[:, :, None, :] - cq[:, None, :, :], max=0.0)
        decay = torch.where(tri, torch.exp(dlt), 0.0)  # [B, Q, K, H]
        att = CB[..., None] * decay * dtq[:, None, :, :]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", att, xq)
        # the carried state's contribution
        y_inter = torch.einsum("bqgn,bhpn->bqhp", Cq, state) * \
            torch.exp(cq)[..., None]
        # the state after this chunk
        decay_last = torch.exp(torch.clamp(cq[:, -1:, :] - cq, max=0.0))
        s_local = torch.einsum("bqh,bqn,bqhp->bhpn", decay_last * dtq,
                               Bq[:, :, 0, :], xq)
        state = state * torch.exp(cq[:, -1, :])[:, :, None, None] + s_local
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(Bb, S, H, P)
    return y, state


def ssd_decode_step(cfg: ModelConfig, x1, B1, C1, dt1, A_log, dt_bias, state):
    """Single-token SSD recurrence. x1: [B, H, P]; B1 / C1: [B, G*N];
    dt1: [B, H]; state: [B, H, P, N] -> (y [B, H, P], state')."""
    N = cfg.ssm_state
    dt = _softplus(dt1.to(_F32) + dt_bias)  # [B, H]
    A = -torch.exp(A_log.to(_F32))
    dA = torch.exp(dt * A)
    Bv = B1.reshape(-1, _G, N)[:, 0].to(_F32)  # [B, N]
    Cv = C1.reshape(-1, _G, N)[:, 0].to(_F32)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bv, x1.to(_F32))
    state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cv)
    return y, state


# ---------------------------------------------------------------------------
# full layer (+ model wrappers)
# ---------------------------------------------------------------------------


def mamba_block(p, x, cfg: ModelConfig, conv_state=None, ssm_state=None,
                single_step=False):
    """x: [B, S, D] (S == 1 with single_step) -> (out, conv_state',
    ssm_state')."""
    B, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Di = cfg.ssm_d_inner
    h = common.rms_norm(x, p["ln"], upcast=not cfg.tp_bf16_reduce)
    zxbcdt = common.qdot(h, p["in_proj"], cfg.quant)
    z, xs, B_, C_, dt = _split_proj(cfg, zxbcdt)
    xBC = torch.cat([xs, B_, C_], -1)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xs, B_, C_ = (xBC[..., :Di], xBC[..., Di:Di + _G * N],
                  xBC[..., Di + _G * N:])
    if single_step:
        y, ssm_state = ssd_decode_step(
            cfg, xs[:, 0].reshape(B, H, P), B_[:, 0], C_[:, 0], dt[:, 0],
            p["A_log"], p["dt_bias"], ssm_state)
        y = y[:, None]  # [B, 1, H, P]
    else:
        y, ssm_state = ssd_forward(cfg, xs, B_, C_, dt, p["A_log"],
                                   p["dt_bias"], ssm_state)
    dskip = xs.reshape(B, S, H, P).to(_F32)
    y = y + dskip * p["D_skip"].to(_F32)[None, None, :, None]
    y = y.reshape(B, S, Di).to(x.dtype)
    y = common.rms_norm(y, p["norm"]) * _silu(z.to(_F32)).to(x.dtype)
    out = common.qdot(y, p["out_proj"], cfg.quant,
                      prec_dtype=common.tp_prec(cfg))
    return out, conv_state, ssm_state


def _layer(params, i: int):
    return {k: v[i] for k, v in params["layers"].items()}


def put_rows(dst, src, active=None):
    """dst[b] = src[b] (in place) where `active` ([B] bool) is True or not
    given; dst / src [B, ...].  A select, not a masked index: a boolean
    index would wait on the card for its count of rows."""
    if active is not None:
        mask = active.reshape((-1,) + (1,) * (dst.dim() - 1))
        src = torch.where(mask, src.to(dst.dtype), dst)
    dst.copy_(src)


def _seq_layer(p, x, cfg: ModelConfig):
    """One layer of the whole-sequence forward, residual included."""
    return x + mamba_block(p, x, cfg)[0]


def apply(params, batch, cfg: ModelConfig):
    """Whole-sequence forward (training) -> f32 logits [B, S, V].  With
    `cfg.remat == "layer"` (and grad on) each layer's activations are
    dropped after the forward and recomputed in the backward
    (`torch.utils.checkpoint`; the recompute is bitwise the first
    forward)."""
    x = common.embed_tokens(params["embed"], batch["tokens"], cfg)
    names = sorted(params["layers"])
    # one unbind per stacked leaf: its backward stacks the layers' grads
    # (a per-layer index would zero-fill a full-size grad each layer)
    for vals in zip(*(params["layers"][n].unbind(0) for n in names)):
        p = dict(zip(names, vals))
        if cfg.remat == "layer" and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _seq_layer, p, x, cfg, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x = _seq_layer(p, x, cfg)
    x = common.rms_norm(x, params["final_norm"])
    return common.logits_head(x, params["embed"], cfg, transpose=True)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int, layout=None):
    """SSM decode state, O(1) in sequence length.  `layout` (a PagedLayout)
    is accepted for API uniformity and ignored: there are no KV pages, so
    paged and dense serving coincide."""
    L = cfg.n_layers
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.ssm_d_inner + 2 * _G * N
    return {
        "ssm": ParamSpec((L, batch, H, P, N), ("layers", "batch", "ssm_heads", None, None), "zeros"),
        "conv": ParamSpec((L, batch, cfg.ssm_conv - 1, conv_ch),
                          ("layers", "batch", None, "ssm_heads"), "zeros", _F32),
        "length": ParamSpec((batch,), ("batch",), "zeros", torch.int32),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, layout=None,
               device="cuda"):
    from repro_torch import resolve_device
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_specs(cfg, batch, max_seq, layout))


def prefill(params, batch, cfg: ModelConfig, max_seq=None):
    """Whole-sequence prefill: (logits [B, S, V], the cache after the
    prompt: each layer's final conv / SSM state, length S)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = common.embed_tokens(params["embed"], tokens, cfg)
    cache = init_cache(cfg, B, max_seq or S, device=x.device)
    for i in range(cfg.n_layers):
        out, cs, ss = mamba_block(_layer(params, i), x, cfg)
        x = x + out
        cache["conv"][i] = cs.to(_F32)
        cache["ssm"][i] = ss
    x = common.rms_norm(x, params["final_norm"])
    logits = common.logits_head(x, params["embed"], cfg, transpose=True)
    cache["length"].fill_(S)
    return logits, cache


def _no_shard(shard):
    if shard is not None:
        raise ValueError("ssm state is replicated; kv_pages sharding does "
                         "not apply to the SSM family")


def prefill_chunk(params, tokens, cache, slot: int, cfg: ModelConfig,
                  shard=None):
    """Chunked prefill for one slot: the SSD forward over chunk `tokens`
    [1, C] seeded with the slot's carried conv / SSM states (state in,
    state out: the recurrence is exact under chunking).  Returns (the last
    position's logits [1, 1, V], cache').  A chunk longer than
    cfg.ssm_chunk must be a multiple of it (the engine's bucket table
    guarantees this)."""
    _no_shard(shard)
    C = tokens.shape[1]
    x = common.embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        conv_l, ssm_l = cache["conv"][i], cache["ssm"][i]
        out, cs, ss = mamba_block(_layer(params, i), x, cfg,
                                  conv_state=conv_l[slot:slot + 1],
                                  ssm_state=ssm_l[slot:slot + 1])
        x = x + out
        conv_l[slot] = cs[0].to(_F32)
        ssm_l[slot] = ss[0]
    x = common.rms_norm(x[:, -1:], params["final_norm"])
    logits = common.logits_head(x, params["embed"], cfg, transpose=True)
    length = cache["length"].clone()
    length[slot] += C
    return logits, dict(cache, length=length)


def prefill_chunk_batched(params, tokens, cache, active, cfg: ModelConfig,
                          shard=None):
    """Cross-slot batched chunked prefill: every active slot advances one
    chunk [B, C] seeded with its own carried states; the rows `active`
    marks False compute on padding and are not written.  Returns
    (last-position logits [B, V], cache')."""
    _no_shard(shard)
    C = tokens.shape[1]
    x = common.embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        conv_l, ssm_l = cache["conv"][i], cache["ssm"][i]
        out, cs, ss = mamba_block(_layer(params, i), x, cfg,
                                  conv_state=conv_l, ssm_state=ssm_l)
        x = x + out
        put_rows(conv_l, cs, active)
        put_rows(ssm_l, ss, active)
    x = common.rms_norm(x[:, -1:], params["final_norm"])
    logits = common.logits_head(x, params["embed"], cfg, transpose=True)
    length = cache["length"] + torch.where(active, C, 0).to(torch.int32)
    return logits[:, 0], dict(cache, length=length)


def decode_step(params, tokens, cache, cfg: ModelConfig, sample=None,
                active=None, shard=None):
    """One token per slot through the recurrence. tokens: [B] int32.
    Returns (logits [B, V] f32, cache'), or with `sample`
    (common.SampleSpec) ([B] int32 tokens, cache') from the fused head +
    sampler kernel."""
    _no_shard(shard)
    x = common.embed_tokens(params["embed"], tokens[:, None], cfg)
    for i in range(cfg.n_layers):
        conv_l, ssm_l = cache["conv"][i], cache["ssm"][i]
        out, cs, ss = mamba_block(_layer(params, i), x, cfg,
                                  conv_state=conv_l, ssm_state=ssm_l,
                                  single_step=True)
        x = x + out
        put_rows(conv_l, cs, active)
        put_rows(ssm_l, ss, active)
    x = common.rms_norm(x, params["final_norm"])
    new_cache = dict(cache, length=cache["length"] + 1)
    if sample is not None:
        return common.sample_head(x[:, 0], params["embed"], cfg, sample,
                                  transpose=True), new_cache
    logits = common.logits_head(x, params["embed"], cfg, transpose=True)
    return logits[:, 0], new_cache
