"""Public entry points over the port's kernels (PyTorch port of
`repro.kernels.ops`).

Each entry point takes tensors on one device: on a CUDA device it launches
the hand-written Hopper kernel, on the CPU it runs the kernel's plain
PyTorch version (the analogue of the reference's interpret mode).  Launch
geometry is fixed per kernel; the reference's autotune cache (`_resolve`)
is not ported yet.  `launch_counts` / `reset_launches` read and clear the
per-kernel launch counters.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import PositFormat
from . import paged_attention as paged_attention_mod
from . import posit_codec


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {**posit_codec.LAUNCHES, **paged_attention_mod.LAUNCHES}


def reset_launches():
    for table in (posit_codec.LAUNCHES, paged_attention_mod.LAUNCHES):
        for name in table:
            table[name] = 0


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
                    partials: bool = False):
    """Paged-attention decode (K3 on CUDA): block-table page gather, posit
    decode next to the q.k dot, streaming softmax across pages.  See
    kernels/paged_attention.py."""
    return paged_attention_mod.paged_attention(
        q, k_pages, v_pages, block_tables, lengths, window, fmt_kv=fmt_kv,
        softcap_val=softcap_val, page_ok=page_ok, partials=partials)


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
    """float activations x posit-stored weights — the serving fast path.

    The weights decode exactly (K1 on CUDA) and the dot accumulates in f32
    through `torch.matmul`, as the reference leaves its dot to XLA.
    Returns f32."""
    return torch.matmul(x.to(torch.float32), decode(w_codes, fmt_w))
