"""Public entry points over the port's kernels (PyTorch port of
`repro.kernels.ops`).

Each entry point takes tensors on one device: on a CUDA device it launches
the hand-written Hopper kernel, on the CPU it runs the kernel's plain
PyTorch version (the analogue of the reference's interpret mode), on the
meta device it takes the CUDA route and counts the launch it would make
(`kernels/work.py`, read by `launch/step_analysis.py`).  A launch knob the
caller does not pass is resolved through the autotune cache
(`kernels/autotune.py`, `_resolve`): only knobs that change no value bit
are tunable, so far K7's `t_block`; every other launch geometry is fixed
per kernel.  `launch_counts` / `reset_launches` read and clear the
per-kernel launch counters.  The wrappers count in Python as they launch,
so a CUDA graph's replay would count nothing: `captured_launches` takes
the launches recorded while a graph captures back out of the counters as
the graph's delta, and `add_launches` adds that delta at each replay
(`runtime/step_graph.py`).

The raw entry points take and return codes and are forward-only; the STE
entry points (`fused_matmul_ste`, `matmul_posit_weights_ste` and the
grouped pair) take f32 masters, run the same kernels forward and carry a
straight-through backward (`torch.autograd.Function`), so QAT trains on
the serving datapath.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.formats import PDPUConfig, PositFormat
from . import autotune
from . import paged_attention as paged_attention_mod
from . import pdpu_dot, posit_codec, posit_matmul
from . import prefill_attention as prefill_attention_mod

_COUNTERS = (posit_codec.LAUNCHES, paged_attention_mod.LAUNCHES,
             prefill_attention_mod.LAUNCHES, posit_matmul.LAUNCHES,
             pdpu_dot.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: n for table in _COUNTERS for name, n in table.items()}


def reset_launches():
    for table in _COUNTERS:
        for name in table:
            table[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Launches counted inside leave the counters as they were and are
    handed back as a delta {key: launches} (filled when the block exits,
    also by an exception): what one replay of a graph captured inside
    launches."""
    before = [dict(table) for table in _COUNTERS]
    delta: dict = {}
    try:
        yield delta
    finally:
        for table, old in zip(_COUNTERS, before):
            for name, n in table.items():
                if n != old.get(name, 0):
                    delta[name] = n - old.get(name, 0)
                    table[name] = old.get(name, 0)


def add_launches(delta: dict):
    """Count a graph replay's launches, a `captured_launches` delta."""
    for name, n in delta.items():
        table = next(t for t in _COUNTERS if name in t)
        table[name] += n


def _resolve(kernel: str, shape, fmts, kw: dict, names) -> dict:
    """Dispatch-time autotune resolution: fill the launch params the
    caller did not pass (None) from the tuned cache (kernels/autotune.py).
    Explicit values always win; a miss leaves them absent, so the
    kernel's defaults apply."""
    missing = [n for n in names if kw.get(n) is None]
    if not missing:
        return kw
    tuned = autotune.lookup(kernel, shape, fmts)
    if tuned:
        for n in missing:
            if tuned.get(n) is not None:
                kw[n] = tuned[n]
    return kw


def _largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (>= 1)."""
    for d in range(min(int(cap), int(n)), 0, -1):
        if n % d == 0:
            return d
    return 1


# Smallest tile a cached launch param may degrade to (see _degrade_tile).
_TILE_FLOOR = 2


def _degrade_tile(n: int, cap: int | None) -> int | None:
    """Resolve a cached tile `cap` against live dim `n`: a divisor of n to
    launch with, or None to use the kernel's untuned default (when the
    largest divisor below cap falls under `_TILE_FLOOR`)."""
    if cap is None:
        return None
    d = _largest_divisor(n, cap)
    if d < min(_TILE_FLOOR, int(n)):
        return None
    return d


def _elementwise(fn, x, fmt):
    """Run an elementwise codec on x; a transposed 2-D view runs on its
    contiguous transpose (the codec commutes with relayout)."""
    if x.ndim == 2 and not x.is_contiguous() and x.T.is_contiguous():
        return fn(x.T, fmt).T
    return fn(x.contiguous(), fmt)


def decode(codes, fmt: PositFormat):
    """posit codes -> f32 (K1 on CUDA)."""
    return _elementwise(posit_codec.decode, codes, fmt)


def encode(values, fmt: PositFormat):
    """float -> posit codes in the storage dtype (K2 on CUDA)."""
    return _elementwise(posit_codec.encode, values, fmt)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, window,
                    fmt_kv: PositFormat | None = None,
                    softcap_val: float = 0.0, page_ok=None,
                    partials: bool = False, t_block: int | None = None):
    """Paged attention: block-table page gather, posit decode next to the
    q.k dot, streaming softmax across pages.  q [B, Hq, Dh] is one decode
    token per slot (K3 on CUDA); q [B, T, Hq, Dh] is T new tokens per slot
    (K7 on CUDA, the speculative verify), tiled by `t_block` (any tiling is
    bitwise identical; T = 1 equals the 3-D path bitwise), resolved
    through the autotune cache when not given: a cached tile that does not
    divide T degrades to the largest divisor below it, or to the kernel's
    default (`_degrade_tile`).  See kernels/paged_attention.py."""
    if q.ndim == 4 and t_block is None:
        kw = _resolve("paged_attention",
                      (q.shape[0], q.shape[1], block_tables.shape[1],
                       k_pages.shape[1], k_pages.shape[2]),
                      (fmt_kv,), {}, ("t_block",))
        t_block = _degrade_tile(q.shape[1], kw.get("t_block"))
    return paged_attention_mod.paged_attention(
        q, k_pages, v_pages, block_tables, lengths, window, fmt_kv=fmt_kv,
        softcap_val=softcap_val, page_ok=page_ok, partials=partials,
        t_block=t_block)


def prefill_attention_paged(q, k, v, k_pages, v_pages, block_tables, starts,
                            window, fmt_kv: PositFormat | None = None,
                            compute_dtype=torch.float32,
                            softcap_val: float = 0.0, flash_chunk: int = 1024,
                            page_ok=None, hist_pool_k=None, hist_pool_v=None,
                            hist_bt=None):
    """Fused prefill (K5 on CUDA): chunk attention + posit KV encode + page
    insert in one launch, the pools written in place; on the CPU the
    decomposed stages op for op.  Sharded pools pass the gathered global
    pool (hist_pool_k/v) and the global block tables as hist_bt beside the
    shard's pools, its localized block tables and their ownership mask as
    page_ok.  See kernels/prefill_attention.py."""
    return prefill_attention_mod.prefill_attention_paged(
        q, k, v, k_pages, v_pages, block_tables, starts, window,
        fmt_kv=fmt_kv, compute_dtype=compute_dtype, softcap_val=softcap_val,
        flash_chunk=flash_chunk, page_ok=page_ok, hist_pool_k=hist_pool_k,
        hist_pool_v=hist_pool_v, hist_bt=hist_bt)


def merge_attn_partials(o, m, l):
    """Log-sum-exp merge of a sharded pool's per-shard paged-attention
    partials (stacked over the shards, or lists), bitwise K3's unsharded
    output for a row whose pages all lie on one shard.  See
    kernels/paged_attention.py."""
    return paged_attention_mod.merge_attn_partials(o, m, l)


def fused_matmul(a_codes, b_codes, fmt_a: PositFormat, fmt_b: PositFormat,
                 fmt_out: PositFormat | None = None):
    """Coded posit GEMM (K6 on CUDA): in-kernel decode of both operands,
    f32 accumulation, one encode when fmt_out is set."""
    return posit_matmul.posit_matmul(a_codes, b_codes, fmt_a, fmt_b, fmt_out)


def fused_matmul_grouped(a_codes, b_codes, fmt_a: PositFormat,
                         fmt_b: PositFormat,
                         fmt_out: PositFormat | None = None):
    """Grouped coded posit GEMM (K9 on CUDA): [E, M, K] x [E, K, N] codes
    -> [E, M, N], per-expert in-kernel decode, f32 accumulation, one
    encode when fmt_out is set."""
    return posit_matmul.posit_matmul_grouped(a_codes, b_codes, fmt_a, fmt_b,
                                             fmt_out)


def matmul_posit_weights_grouped(x, w_codes, fmt_w: PositFormat):
    """Float activations x stacked posit weights, the grouped serving fast
    path (K9 on CUDA): x [E, M, K] float, w_codes [E, K, N]; the expert
    stacks travel as codes and decode in the kernel.  Returns f32."""
    return posit_matmul.posit_matmul_grouped(x.to(torch.float32), w_codes,
                                             None, fmt_w, None)


def pdpu_matmul(a_codes, b_codes, cfg: PDPUConfig):
    """Bit-exact chunked-PDPU GEMM (K8 on CUDA): the paper's W_m datapath,
    int32 cfg.fmt_out codes out.  See kernels/pdpu_dot.py."""
    return pdpu_dot.pdpu_matmul(a_codes, b_codes, cfg)


def decode_sample(x, w, noise=None, temperature=None, *, plan: str = "fused",
                  fmt_w: PositFormat | None = None, transpose: bool = False,
                  greedy: bool = False, top_k: int = 0,
                  softcap_val: float = 0.0):
    """Decode epilogue (K4 on CUDA): logits-head GEMM + sampling, tokens
    equal to `logits_head` followed by the engine sampler."""
    return paged_attention_mod.decode_sample(
        x, w, noise, temperature, plan=plan, fmt_w=fmt_w,
        transpose=transpose, greedy=greedy, top_k=top_k,
        softcap_val=softcap_val)


def matmul_posit_weights(x, w_codes, fmt_w: PositFormat):
    """float activations x posit-stored weights — the serving fast path:
    x [..., K] @ w_codes [K, N] -> f32 [..., N].

    On the card, at most `posit_matmul.GEMV_MAX_M` rows (every decode
    step's projections and the unfused head) run the float GEMV, which
    decodes each weight code next to its dot and reads bf16 or f32
    activations as they lie (`posit_matmul.posit_gemv_f`; w_codes
    contiguous or the transpose of contiguous [N, K] codes).  Above, the
    weights decode exactly (K1) and the dot accumulates in f32 through
    `torch.matmul`, as the reference leaves its dot to XLA.  On the CPU
    always the latter (the GEMV's plain version), bitwise the reference."""
    K = x.shape[-1]
    if x.device.type in ("cuda", "meta") and \
            x.numel() // max(K, 1) <= posit_matmul.GEMV_MAX_M:
        if torch.is_grad_enabled() and x.requires_grad:
            return _FloatGemv.apply(x, w_codes, fmt_w)
        return _float_gemv(x, w_codes, fmt_w)
    return torch.matmul(x.to(torch.float32), decode(w_codes, fmt_w))


def _float_gemv(x, w_codes, fmt_w: PositFormat):
    """x [..., K] (at most GEMV_MAX_M rows) through the float GEMV."""
    out = posit_matmul.posit_gemv_f(x.reshape(-1, x.shape[-1]), w_codes,
                                    fmt_w)
    return out.reshape(tuple(x.shape[:-1]) + (w_codes.shape[-1],))


class _FloatGemv(torch.autograd.Function):
    """The float GEMV with the gradient `torch.matmul` on the decoded
    weights would give x: dx = g @ decode(w_codes)^T."""

    @staticmethod
    def forward(ctx, x, w_codes, fmt_w):
        ctx.save_for_backward(w_codes)
        ctx.fmt_w, ctx.x_dtype = fmt_w, x.dtype
        return _float_gemv(x, w_codes, fmt_w)

    @staticmethod
    def backward(ctx, g):
        (w_codes,) = ctx.saved_tensors
        wq = decode(w_codes, ctx.fmt_w)
        dx = torch.matmul(g.to(torch.float32), wq.transpose(-1, -2))
        return dx.to(ctx.x_dtype), None, None


# ---------------------------------------------------------------------------
# differentiable (STE) entry points over float masters
# ---------------------------------------------------------------------------
#
# The forward runs the serving datapath: the f32 masters are encoded to
# posit codes (K2) and the product runs on the codes, through the coded GEMM
# (K6, K9 grouped) with coded activations or `matmul_posit_weights` with
# float activations (the float GEMV at most 8 rows on the card, else the
# exact decode (K1) and an f32 `torch.matmul`).  The backward is
# straight-through with respect to the float operands, on the decoded
# quantized operands the forward computed on: dx = g @ wq^T and
# dw = aq^T @ g, the same products as the fake_quant plan's backward, so
# the gradients are bitwise that plan's for the same g.  Only codes are
# saved (the weight codes, and the activation codes, or the float
# activations themselves when fmt_a is None), never a decoded f32 copy;
# K1 decodes them again in the backward.  The two backward products are
# plain f32 matmuls, as the reference leaves them to XLA.  All four take
# and return f32; the dispatch layer casts.


class _FusedMatmulSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, fmt_a, fmt_w, grouped):
        w_codes = encode(w, fmt_w)
        if fmt_a is None:
            a_res = x
            out = (matmul_posit_weights_grouped if grouped else
                   matmul_posit_weights)(x, w_codes, fmt_w)
        else:
            a_res = encode(x, fmt_a)
            out = (fused_matmul_grouped if grouped else fused_matmul)(
                a_res, w_codes, fmt_a, fmt_w, fmt_out=None)
        ctx.fmt_a, ctx.fmt_w = fmt_a, fmt_w
        ctx.save_for_backward(a_res, w_codes)
        return out

    @staticmethod
    def backward(ctx, g):
        a_res, w_codes = ctx.saved_tensors
        wq = decode(w_codes, ctx.fmt_w)
        g = g.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, wq.transpose(-1, -2))
        del wq
        if ctx.needs_input_grad[1]:
            aq = a_res if ctx.fmt_a is None else decode(a_res, ctx.fmt_a)
            dw = torch.matmul(aq.to(torch.float32).transpose(-1, -2), g)
        return dx, dw, None, None, None


def fused_matmul_ste(x, w, fmt_a: PositFormat | None, fmt_w: PositFormat):
    """Differentiable fused GEMM over float masters: x [M, K] @ w [K, N],
    both f32.  fmt_a None keeps the activations float (the
    `matmul_posit_weights` path: K2 on w, then the float GEMV or K1 and
    `torch.matmul`); otherwise
    both operands travel as codes through `fused_matmul` (K2 twice, K6).
    Backward: dx = g @ wq^T, dw = xq^T @ g on the decoded quantized
    operands, the fake_quant plan's straight-through gradients."""
    return _FusedMatmulSTE.apply(x, w, fmt_a, fmt_w, False)


def matmul_posit_weights_ste(x, w, fmt_w: PositFormat):
    """Differentiable serving fast path: float activations, posit weights
    encoded from the float masters in the forward, STE weight gradients."""
    return _FusedMatmulSTE.apply(x, w, None, fmt_w, False)


def fused_matmul_grouped_ste(x, w, fmt_a: PositFormat | None,
                             fmt_w: PositFormat):
    """Differentiable grouped fused GEMM over float masters: x [E, C, K] @
    w [E, K, N] -> [E, C, N] through K9, the STE of `fused_matmul_ste`
    per expert (batched backward products)."""
    return _FusedMatmulSTE.apply(x, w, fmt_a, fmt_w, True)


def matmul_posit_weights_grouped_ste(x, w, fmt_w: PositFormat):
    """Differentiable grouped serving fast path (float activations)."""
    return _FusedMatmulSTE.apply(x, w, None, fmt_w, True)


def ste_plain(x, w, fmt_a: PositFormat | None, fmt_w: PositFormat, g):
    """(out, dx, dw) of the STE functions above, on x [..., M, K] and
    w [..., K, N] f32 and the output gradient g, with every kernel
    replaced by its plain version: the codec's plain encode / decode and
    f32 `torch.matmul` on the decoded operands.  On the card the backward
    is bitwise this (K1 is bitwise and the products are the same calls);
    the forward is within `posit_matmul.sum_bound` (K6, K9, the float GEMV
    at most `posit_matmul.GEMV_MAX_M` rows) or bitwise (float activations,
    2-D, above that: K1 and the same `torch.matmul`)."""
    wq = posit_codec.decode_plain(posit_codec.encode_plain(w, fmt_w), fmt_w)
    aq = x if fmt_a is None else posit_codec.decode_plain(
        posit_codec.encode_plain(x, fmt_a), fmt_a)
    return (torch.matmul(aq, wq), torch.matmul(g, wq.transpose(-1, -2)),
            torch.matmul(aq.transpose(-1, -2), g))
