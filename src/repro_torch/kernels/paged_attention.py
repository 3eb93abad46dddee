"""Paged-attention decode and the fused decode epilogue (head GEMM +
sampler): CUDA kernels and their plain versions.

`paged_attention` (K3, `csrc/paged_attention.cu`) replaces
`repro/kernels/paged_attention.py:paged_attention` for a 3-D query (one
decode token per slot); `decode_sample` (K4, `csrc/decode_sample.cu`)
replaces `repro/kernels/paged_attention.py:decode_sample`.  On a CUDA
tensor each wrapper launches its kernel; on a CPU tensor it runs the
plain PyTorch version beside it, which states the same function densely.
The multi-query (4-D q) form is not ported yet (ROADMAP queue 2).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.formats import PositFormat
from . import _build
from .posit_codec import decode_plain

_NEG = -2.0e38
# launches of each kernel since the last reset (kernels/ops.reset_launches)
LAUNCHES = {"paged_attention": 0, "decode_sample": 0}
_KINDS = {torch.int8: 0, torch.int16: 1, torch.float32: 2, torch.bfloat16: 3}


def _softcap(x, cap: float):
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def _as_f32_values(t, fmt: PositFormat | None):
    return t.to(torch.float32) if fmt is None else decode_plain(t, fmt)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, window,
                          fmt_kv: PositFormat | None = None,
                          softcap_val: float = 0.0, page_ok=None,
                          partials: bool = False):
    """Dense statement of the paged-attention kernel: gather each slot's
    pages by block table, decode, mask (pos < length, the window, page_ok)
    and softmax.  With partials, returns the unnormalized (o, m, l) the
    streaming kernel ends with (m = -2e38, l = 0 for an empty slot)."""
    B, Hq, Dh = q.shape
    _, ps, kvd = k_pages.shape
    Hkv = kvd // Dh
    G = Hq // Hkv
    M = block_tables.shape[1]
    S = M * ps
    bt = block_tables.long()
    kg = _as_f32_values(k_pages[bt], fmt_kv).reshape(B, S, Hkv, Dh)
    vg = _as_f32_values(v_pages[bt], fmt_kv).reshape(B, S, Hkv, Dh)
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Hkv, G, Dh).to(torch.float32) * scale
    s = _softcap(torch.einsum("bhgd,bkhd->bhgk", qg, kg), softcap_val)
    pos = torch.arange(S, device=q.device)[None, :]
    length = lengths.long()[:, None]
    mask = (pos < length) & ((length - 1 - pos) < window.long()[0])
    if page_ok is not None:
        mask &= (page_ok != 0).repeat_interleave(ps, dim=1)
    mask = mask[:, None, None, :]
    m = torch.where(mask, s, torch.full_like(s, _NEG)).amax(-1)
    m = torch.clamp(m, min=_NEG)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, vg)
    if partials:
        return (o.reshape(B, Hq, Dh), m.reshape(B, Hq), l.reshape(B, Hq))
    return (o / torch.clamp(l, min=1e-30)[..., None]).reshape(B, Hq, Dh)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, window,
                    fmt_kv: PositFormat | None = None,
                    softcap_val: float = 0.0, page_ok=None,
                    partials: bool = False):
    """One-token attention over block-table-paged posit KV.

    q            : [B, Hq, Dh] float query (one decode token per slot).
    k/v_pages    : [n_pages, page_size, Hkv*Dh] posit codes (int8/int16,
                   decoded in-kernel via fmt_kv) or float (fmt_kv=None).
    block_tables : [B, max_pages] int32; page j holds the slot's positions
                   [j*page_size, (j+1)*page_size).
    lengths      : [B] int32 valid positions per slot including the current
                   token.
    window       : [1] int32 sliding-window size (>= max_seq = unbounded).
    page_ok      : optional [B, max_pages] int32 mask (nonzero = attend).
    partials     : return the unnormalized (o [B,Hq,Dh], m [B,Hq], l [B,Hq]).

    Returns [B, Hq, Dh] f32 (or the (o, m, l) triple)."""
    if q.ndim != 3:
        raise NotImplementedError(
            "multi-query (4-D q) paged attention is not ported yet "
            "(ROADMAP queue 2, the speculative verify kernel)")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"k/v page pools differ: {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    B, Hq, Dh = q.shape
    n_pages, ps, kvd = k_pages.shape
    Hkv = kvd // Dh
    if Hkv * Dh != kvd or Hq % Hkv:
        raise ValueError(f"page feature dim {kvd} incompatible with "
                         f"q heads {Hq} x head_dim {Dh}")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, window, fmt_kv, softcap_val,
                                     page_ok, partials)
    if k_pages.dtype not in _KINDS:
        raise TypeError(f"paged_attention takes int8/int16/f32/bf16 pages, "
                        f"got {k_pages.dtype}")
    if fmt_kv is not None and k_pages.is_floating_point():
        raise TypeError("fmt_kv given but the pages hold floats")
    q = q.to(torch.float32).contiguous()
    M = block_tables.shape[1]
    for name, t, shape in (("block_tables", block_tables, (B, M)),
                           ("lengths", lengths, (B,)),
                           ("window", window, (1,)),
                           ("page_ok", page_ok, (B, M))):
        if t is not None and (t.dtype != torch.int32 or tuple(t.shape) != shape):
            raise ValueError(f"paged_attention: {name} must be int32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    extra = [page_ok] if page_ok is not None else []
    _build.require_cuda("paged_attention", q, k_pages, v_pages, block_tables,
                        lengths, window, *extra)
    out = torch.empty((B, Hq, Dh), dtype=torch.float32, device=q.device)
    m = l = None
    if partials:
        m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    if B:
        lib = _build.library("paged_attention")
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _build.check(lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), window.data_ptr(),
            ptr(page_ok), out.data_ptr(), ptr(m), ptr(l),
            B, M, ps, Hq, Hkv, Dh, _KINDS[k_pages.dtype],
            fmt_kv.n if fmt_kv else 0, fmt_kv.es if fmt_kv else 0,
            1.0 / math.sqrt(Dh), float(softcap_val), _build.stream_of(q)),
            "paged_attention")
        LAUNCHES["paged_attention"] += 1
    return (out, m, l) if partials else out


# ---------------------------------------------------------------------------
# fused decode epilogue: logits-head posit GEMM + sampling
# ---------------------------------------------------------------------------

def sample_logits(l, noise, temperature, *, greedy: bool, top_k: int):
    """The serving sampler on f32 logits rows [B, V]: greedy argmax, or
    argmax(noise + l / T) after the exact top-k filter
    `l >= sort(l)[..., -top_k]` (categorical(key, l) == argmax of gumbel
    noise + l).  Ties go to the first index, as in jnp.argmax."""
    if greedy:
        return torch.argmax(l, dim=-1).to(torch.int32)
    l = l / max(float(temperature), 1e-6)
    V = l.shape[-1]
    if 0 < top_k < V:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l >= kth, l, torch.full_like(l, -1e30))
    return torch.argmax(noise.to(torch.float32) + l, dim=-1).to(torch.int32)


def head_logits_plain(x, w, *, plan: str, fmt_w: PositFormat | None,
                      transpose: bool, softcap_val: float):
    """The head GEMM of `common.logits_head` for one plan, plain: f32
    logits [B, V] (softcapped)."""
    wq = _as_f32_values(w, fmt_w)
    if transpose:
        wq = wq.T
    if plan == "fused":
        l = x.to(torch.float32) @ wq
    else:
        # fake_quant: the dot runs in x.dtype with f32 accumulation; bf16
        # products are exact in f32, so an f32 dot of the rounded operands
        # is the same function
        l = x.to(torch.float32) @ wq.to(x.dtype).to(torch.float32)
    return _softcap(l, softcap_val)


def decode_sample_plain(x, w, noise=None, temperature=None, *,
                        plan: str = "fused", fmt_w: PositFormat | None = None,
                        transpose: bool = False, greedy: bool = False,
                        top_k: int = 0, softcap_val: float = 0.0):
    """logits head + sampler, plain; [B] int32 tokens."""
    l = head_logits_plain(x, w, plan=plan, fmt_w=fmt_w, transpose=transpose,
                          softcap_val=softcap_val)
    t = 1.0 if temperature is None else temperature
    return sample_logits(l, noise, t, greedy=greedy, top_k=top_k)


def decode_sample(x, w, noise=None, temperature=None, *, plan: str = "fused",
                  fmt_w: PositFormat | None = None, transpose: bool = False,
                  greedy: bool = False, top_k: int = 0,
                  softcap_val: float = 0.0):
    """One-launch-pair decode epilogue: posit logits GEMM + sampling.

    x           : [B, D] final-norm'd hidden rows (one decode token/slot).
    w           : head weights, [D, V] (or [V, D] with transpose=True, the
                  tied-embedding layout); posit codes decoded in-kernel via
                  fmt_w, or float (fmt_w=None).
    noise       : [B, V] f32 standard-gumbel rows (ignored when greedy).
    temperature : python float (ignored when greedy).
    plan        : "fused" (f32 activations x exact decode) or "fake_quant"
                  (weights rounded to x.dtype, f32 accumulation).
    top_k       : 0 (or >= V) disables the filter; any 0 < top_k < V runs
                  the exact threshold sort(l)[..., -top_k].

    Returns [B] int32 tokens."""
    if plan not in ("fused", "fake_quant"):
        raise ValueError(f"no fused decode head for plan {plan!r}")
    if not greedy and noise is None:
        raise ValueError("non-greedy decode_sample requires noise")
    B, D = x.shape
    V = w.shape[0] if transpose else w.shape[1]
    if (w.shape[1] if transpose else w.shape[0]) != D:
        raise ValueError(f"head weights {tuple(w.shape)} do not match x "
                         f"{tuple(x.shape)} (transpose={transpose})")
    if x.device.type == "cpu":
        return decode_sample_plain(x, w, noise, temperature, plan=plan,
                                   fmt_w=fmt_w, transpose=transpose,
                                   greedy=greedy, top_k=top_k,
                                   softcap_val=softcap_val)
    if w.dtype not in _KINDS:
        raise TypeError(f"decode_sample takes int8/int16/f32/bf16 weights, "
                        f"got {w.dtype}")
    rbf16 = plan == "fake_quant" and x.dtype == torch.bfloat16
    if plan == "fake_quant" and x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fake_quant head in {x.dtype} is not ported")
    xf = x.to(torch.float32).contiguous()
    tensors = [xf, w]
    if not greedy:
        noise = noise.to(torch.float32).contiguous()
        if tuple(noise.shape) != (B, V):
            raise ValueError(f"noise must be [B, V] = {(B, V)}, got "
                             f"{tuple(noise.shape)}")
        tensors.append(noise)
    _build.require_cuda("decode_sample", *tensors)
    tok = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B:
        lib = _build.library("decode_sample")
        n_tiles = lib.decode_sample_tiles(V, int(transpose))
        logits = torch.empty((B, V), dtype=torch.float32, device=x.device)
        tile_val = torch.empty((B, n_tiles), dtype=torch.float32,
                               device=x.device)
        tile_idx = torch.empty((B, n_tiles), dtype=torch.int32,
                               device=x.device)
        k = int(top_k) if (not greedy and 0 < top_k < V) else 0
        _build.check(lib.decode_sample_launch(
            xf.data_ptr(), w.data_ptr(),
            None if greedy else noise.data_ptr(), logits.data_ptr(),
            tile_val.data_ptr(), tile_idx.data_ptr(), tok.data_ptr(),
            B, D, V, int(transpose), _KINDS[w.dtype],
            fmt_w.n if fmt_w else 0, fmt_w.es if fmt_w else 0, int(rbf16),
            float(softcap_val), 1.0 if temperature is None else float(temperature),
            int(greedy), k, _build.stream_of(x)),
            "decode_sample")
        LAUNCHES["decode_sample"] += 1
    return tok
