"""Fused prefill attention that writes posit KV pages: the CUDA kernel and
its plain version.

`prefill_attention_paged` (K5, `csrc/prefill_attention.cu`) replaces
`repro/kernels/prefill_attention.py:prefill_attention_paged`: one prefill
chunk of every slot as one call -- flash attention over [decoded history
pages | raw chunk | pad], the posit encode of the chunk's K/V and their
in-place page writes.  On a CUDA tensor the wrapper launches the variant
`prefill_variant` picks (tensor cores for head_dim a multiple of 16 up to
256: `tc` / `tc256` for bf16 activations, `tc_f32` for f32 with every
operand split exactly into bf16 terms; SIMT f32 for the rest), and raises
if the launcher refuses it;
on a CPU tensor it runs the plain version, the decomposed stages
(gather -> encode -> insert -> decode -> flash attention) of
`decomposed_prefill`, which the model's decomposed branch also runs, so on
the CPU the fused and decomposed branches of the model are bitwise equal.
On a meta tensor it counts the launch it would make (`kernels/work.py`).

Sharded pools (`hist_pool_k/v` + `hist_bt`, models/paged.py): the caller
passes the gathered global pool and the global block tables, from which
history is read, beside the shard's own pools, the localized block tables
and their ownership mask `page_ok`, through which the chunk's rows are
written.  With the same history bytes the attention output is the
unsharded launch's, bitwise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.formats import PositFormat
from . import _build, work
from .paged_attention import _KINDS
from .posit_codec import decode_plain, encode_plain

# launches of the kernel since the last reset (kernels/ops.reset_launches);
# "prefill_attention:<variant>" counts them by `prefill_variant`
_VARIANTS = {"simt": 0, "tc": 1, "tc256": 2, "tc_f32": 3}
LAUNCHES = {"prefill_attention": 0, "prefill_attention:global_hist": 0} | {
    f"prefill_attention:{v}": 0 for v in _VARIANTS}
_ACT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core variants' key tile and largest head dims
TC_KEYS = 64
TC_MAX_HEAD_DIM = 128
TC256_MAX_HEAD_DIM = 256
# a tc256 split covers at least this many key tiles, and there are at most
# TC256_MAX_SPLITS splits (csrc/prefill_attention.cu:tc256_split_tiles)
TC256_SPLIT_TILES = 4
TC256_MAX_SPLITS = 32
# shared memory a block may take on an H100, and what the launcher returns
# for a head_dim the tc256 kernel does not take
BLOCK_SMEM = 227 * 1024
_REFUSED = -1


def prefill_variant(dtype, head_dim: int) -> str:
    """K5's kernel for q/k/v of `dtype`, by head_dim: a multiple of 16 up
    to TC256_MAX_HEAD_DIM runs on tensor cores with exact bf16 splits of
    its f32 operands -- for bf16 activations "tc" up to TC_MAX_HEAD_DIM
    (command-r, command-r-plus, qwen3, deepseek) and "tc256" (q in shared
    memory, the key span split across blocks) above it (gemma3-4b), for f32
    activations "tc_f32" (every f32 q, k, v and p in three terms, history
    in as many as its page format needs: `prefill_kv_terms`); any other
    head_dim "simt" (f32 FMA)."""
    if head_dim % 16 or not 0 < head_dim <= TC256_MAX_HEAD_DIM:
        return "simt"
    if dtype == torch.float32:
        return "tc_f32"
    if dtype == torch.bfloat16:
        return "tc" if head_dim <= TC_MAX_HEAD_DIM else "tc256"
    return "simt"


def prefill_kv_terms(pages_dtype, fmt_kv: PositFormat | None,
                     hist_bf16: bool) -> int:
    """bf16 terms `tc_f32` takes for a history key or value (the chunk's
    own f32 rows take three): one when history is rounded to bf16 (the
    kv_decode dtype chain) or the pool holds bf16, three for an f32 pool,
    and for posit codes as many bytes as the widest significand has bits
    (n - 2 - es, the hidden bit included: one for P(8,x) and P(10,2), two
    for P(13,x) and P(16,x)); csrc/prefill_attention.cu's
    prefill_hist_terms."""
    if hist_bf16 or pages_dtype == torch.bfloat16:
        return 1
    if fmt_kv is None:
        return 3
    return -(-max(fmt_kv.n - 2 - fmt_kv.es, 1) // 8)


def tc_span_rows(M: int, page_size: int, C: int) -> int:
    """Rows of the tensor-core variants' span buffer: history M * page_size
    plus the chunk, rounded up to whole key tiles."""
    return -(-(M * page_size + C) // TC_KEYS) * TC_KEYS


def tc256_splits(M: int, page_size: int, C: int) -> int:
    """Splits of the tc256 kernel's key span: TC256_SPLIT_TILES key tiles
    each, more when that would pass TC256_MAX_SPLITS.  The shapes alone fix
    them, so a slot's rows never depend on another slot's start or on the
    window."""
    tiles = tc_span_rows(M, page_size, C) // TC_KEYS
    per_split = max(TC256_SPLIT_TILES, -(-tiles // TC256_MAX_SPLITS))
    return -(-tiles // per_split)


def tc256_smem_bytes(head_dim: int) -> int:
    """Shared memory of a tc256 block: 64 q rows, 64 keys and 64 values,
    bf16 rows padded by 8 (two blocks share an SM at head_dim 256)."""
    return 2 * 3 * TC_KEYS * (head_dim + 8)


def tc_f32_splits(M: int, page_size: int, C: int, head_dim: int) -> int:
    """Splits of the tc_f32 kernel's key span: one up to TC_MAX_HEAD_DIM
    (q in registers), tc256's above it (q in shared memory)."""
    return (1 if head_dim <= TC_MAX_HEAD_DIM
            else tc256_splits(M, page_size, C))


def tc_f32_smem_bytes(head_dim: int) -> int:
    """Shared memory of a tc_f32 block: a ring of 64-key bf16 term-plane
    units (rows padded by 8), four up to TC_MAX_HEAD_DIM, three above it
    beside the block's 64 q rows in f32 (padded by 8)."""
    unit = 2 * TC_KEYS * (head_dim + 8)
    if head_dim <= TC_MAX_HEAD_DIM:
        return 4 * unit
    return 3 * unit + 4 * TC_KEYS * (head_dim + 8)


def decomposed_prefill(q, k, v, k_pages, v_pages, block_tables, starts,
                       window, *, encode, decode, softcap_val: float = 0.0,
                       flash_chunk: int = 1024, page_ok=None,
                       hist_pool_k=None, hist_pool_v=None, hist_bt=None,
                       shard=None):
    """The decomposed prefill stages, in place: gather every slot's history
    pages, encode and insert the chunk's K/V (writes to pages with
    page_ok == 0 land on the trash page 0), then flash attention over
    [history decoded -> k dtype | raw chunk].  `encode` maps [B, C, F]
    values to pool entries and `decode` pool entries to the compute dtype:
    the model's decomposed branch passes its KV codec (K1 / K2 on CUDA),
    the plain version below the plain codecs.  History comes from
    hist_pool_k/v by hist_bt when they are given (K5's sharded-pool
    arguments).  Under `shard` (models/paged.py) k_pages / v_pages are the
    lists of sub-pools, block_tables hold global ids, and the gather and
    the inserts run over every shard."""
    from repro_torch.models import common, paged  # models import kernels

    B, C, Hq, Dh = q.shape
    Hkv = k.shape[2]
    bt = block_tables
    if hist_pool_k is not None:
        hist_k = paged.gather_slots(hist_pool_k, hist_bt)
        hist_v = paged.gather_slots(hist_pool_v, hist_bt)
    else:
        hist_k = paged.gather_slots(k_pages, bt, shard=shard)
        hist_v = paged.gather_slots(v_pages, bt, shard=shard)
    bt_w = bt if page_ok is None else torch.where(page_ok != 0, bt,
                                                  torch.zeros_like(bt))
    starts = starts.long()
    paged.insert_chunk_batched(k_pages, bt_w, starts,
                               encode(k.reshape(B, C, -1)), shard=shard)
    paged.insert_chunk_batched(v_pages, bt_w, starts,
                               encode(v.reshape(B, C, -1)), shard=shard)
    S_h = hist_k.shape[1]
    pos = starts[:, None] + torch.arange(C, device=q.device)[None]
    hist_pos = torch.arange(S_h, device=q.device)[None].expand(B, S_h)
    hist_pos = torch.where(hist_pos < starts[:, None], hist_pos,
                           torch.full_like(hist_pos, -1))
    kd = decode(hist_k).reshape(B, S_h, Hkv, Dh).to(k.dtype)
    vd = decode(hist_v).reshape(B, S_h, Hkv, Dh).to(v.dtype)
    attn = common.flash_attention(
        q, torch.cat([kd, k], 1), torch.cat([vd, v], 1), pos,
        torch.cat([hist_pos, pos], 1), causal=True, window=window.long(),
        chunk_k=flash_chunk, softcap_val=softcap_val)
    return attn, k_pages, v_pages


def prefill_attention_paged_plain(q, k, v, k_pages, v_pages, block_tables,
                                  starts, window,
                                  fmt_kv: PositFormat | None = None,
                                  compute_dtype=torch.float32,
                                  softcap_val: float = 0.0,
                                  flash_chunk: int = 1024, page_ok=None,
                                  hist_pool_k=None, hist_pool_v=None,
                                  hist_bt=None):
    """K5's plain version: the decomposed stages with the plain codecs."""

    def encode(x):
        return x.to(compute_dtype) if fmt_kv is None else encode_plain(x, fmt_kv)

    def decode(x):
        if fmt_kv is None:
            return x
        return decode_plain(x, fmt_kv).to(compute_dtype)

    return decomposed_prefill(q, k, v, k_pages, v_pages, block_tables, starts,
                              window, encode=encode, decode=decode,
                              softcap_val=softcap_val, flash_chunk=flash_chunk,
                              page_ok=page_ok, hist_pool_k=hist_pool_k,
                              hist_pool_v=hist_pool_v, hist_bt=hist_bt)


def prefill_attention_paged(q, k, v, k_pages, v_pages, block_tables, starts,
                            window, fmt_kv: PositFormat | None = None,
                            compute_dtype=torch.float32,
                            softcap_val: float = 0.0, flash_chunk: int = 1024,
                            page_ok=None, hist_pool_k=None, hist_pool_v=None,
                            hist_bt=None):
    """Fused prefill: chunk attention + posit KV encode + paged insert.

    q            : [B, C, Hq, Dh] post-rope queries (chunk positions
                   starts[b] + [0, C)), f32 or bf16.
    k, v         : [B, C, Hkv, Dh] raw post-rope chunk keys / values (the
                   kernel encodes them to the pool's code width itself).
    k/v_pages    : [n_pages, page_size, Hkv*Dh] pools, posit codes (int8 /
                   int16 with fmt_kv) or floats in compute_dtype; written
                   in place.
    block_tables : [B, M] int32 page ids; rows of inactive slots zeroed
                   (their writes land on the trash page).
    starts       : [B] int32 chunk start per slot.
    window       : [1] int32 sliding window (>= max_seq = unbounded).
    flash_chunk  : flash_attention's key-chunk length, replayed by the
                   plain version and the SIMT kernel (the tensor-core
                   kernels' running max spans it); spans past it need
                   page_size | flash_chunk.
    page_ok      : optional [B, M] int32 mask; pages with 0 are not
                   written.
    hist_pool_k/v: optional [n_pages_global, page_size, Hkv*Dh] pools
                   history is read from (a sharded pool's gathered global
                   pool), with `hist_bt` [B, M] int32, its global ids;
                   k/v_pages and block_tables are then the shard's own
                   pools and localized ids, written where page_ok allows.

    Returns (attn [B, C, Hq, Dh] in q.dtype, k_pages, v_pages)."""
    B, C, Hq, Dh = q.shape
    n_pages, ps, kvd = k_pages.shape
    Hkv = kvd // Dh
    if Hkv * Dh != kvd or Hq % Hkv:
        raise ValueError(f"page feature dim {kvd} incompatible with "
                         f"q heads {Hq} x head_dim {Dh}")
    if tuple(k.shape) != (B, C, Hkv, Dh) or tuple(v.shape) != (B, C, Hkv, Dh):
        raise ValueError(f"chunk k/v shape {tuple(k.shape)} != "
                         f"{(B, C, Hkv, Dh)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"k/v page pools differ: {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    M = block_tables.shape[1]
    global_hist = hist_pool_k is not None or hist_pool_v is not None
    if global_hist:
        if hist_pool_k is None or hist_pool_v is None or hist_bt is None:
            raise ValueError("hist_pool_k/v require each other and the "
                             "global hist_bt")
        for t in (hist_pool_k, hist_pool_v):
            if tuple(t.shape[1:]) != (ps, kvd):
                raise ValueError(f"hist pool page shape {tuple(t.shape[1:])} "
                                 f"!= {(ps, kvd)}")
    # flash_attention's key-chunk length over [history M*ps | chunk C]; a
    # span holding whole chunks of pure history streams them page by page
    ck = min(int(flash_chunk), M * ps + C)
    if (M * ps) // ck and ck % ps:
        raise ValueError(f"span {M * ps}+{C} needs page_size {ps} to divide "
                         f"flash_chunk {ck} (see fused_prefill_span_ok)")
    if q.device.type == "cpu":
        return prefill_attention_paged_plain(
            q, k, v, k_pages, v_pages, block_tables, starts, window,
            fmt_kv=fmt_kv, compute_dtype=compute_dtype,
            softcap_val=softcap_val, flash_chunk=flash_chunk, page_ok=page_ok,
            hist_pool_k=hist_pool_k, hist_pool_v=hist_pool_v, hist_bt=hist_bt)
    if q.dtype not in _ACT_KINDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"prefill_attention takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k_pages.dtype not in _KINDS:
        raise TypeError(f"prefill_attention takes int8/int16/f32/bf16 pages, "
                        f"got {k_pages.dtype}")
    if fmt_kv is None:
        if k_pages.dtype != compute_dtype:
            raise TypeError(f"float pools hold compute_dtype {compute_dtype}, "
                            f"got {k_pages.dtype}")
    elif k_pages.is_floating_point() or \
            fmt_kv.storage_bits != k_pages.element_size() * 8:
        raise TypeError(f"{fmt_kv} codes live in int{fmt_kv.storage_bits}, "
                        f"got {k_pages.dtype} pages")
    if compute_dtype not in _ACT_KINDS:
        raise TypeError(f"compute_dtype must be f32 or bf16, got {compute_dtype}")
    for name, t, shape in (("block_tables", block_tables, (B, M)),
                           ("starts", starts, (B,)),
                           ("window", window, (1,)),
                           ("page_ok", page_ok, (B, M)),
                           ("hist_bt", hist_bt, (B, M))):
        if t is not None and (t.dtype != torch.int32 or tuple(t.shape) != shape):
            raise ValueError(f"prefill_attention: {name} must be int32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if global_hist and (hist_pool_k.dtype != k_pages.dtype
                        or hist_pool_v.dtype != k_pages.dtype):
        raise TypeError(f"hist pools must hold the pool's {k_pages.dtype}, "
                        f"got {hist_pool_k.dtype} / {hist_pool_v.dtype}")
    extra = [t for t in (page_ok, hist_pool_k, hist_pool_v, hist_bt)
             if t is not None]
    _build.require_cuda("prefill_attention", q, k, v, k_pages, v_pages,
                        block_tables, starts, window, *extra)
    out = torch.empty_like(q)
    # the kv_decode dtype chain: codes -> f32 -> compute dtype -> k dtype
    bf16 = torch.bfloat16
    hist_bf16 = q.dtype == bf16 or (fmt_kv is not None and compute_dtype == bf16)
    if B and C:
        variant = prefill_variant(q.dtype, Dh)
        # the tensor-core variants' decoded [history | chunk] span, K and V
        # (tc_f32: each in three bf16 term planes), and the split variants'
        # partials (o, then m and l) of every output row
        planes = {"tc": (), "tc256": (), "tc_f32": (3,)}.get(variant)
        span = (torch.empty((2, *planes, B, Hkv, tc_span_rows(M, ps, C), Dh),
                            dtype=torch.bfloat16, device=q.device)
                if planes is not None else None)
        splits = (tc256_splits(M, ps, C) if variant == "tc256"
                  else tc_f32_splits(M, ps, C, Dh) if variant == "tc_f32"
                  else 1)
        part_o, part_ml = ((torch.empty((B * C * Hq, splits, Dh),
                                        dtype=torch.float32, device=q.device),
                            torch.empty((B * C * Hq, splits, 2),
                                        dtype=torch.float32, device=q.device))
                           if splits > 1 else (None, None))
        keys = ["prefill_attention", f"prefill_attention:{variant}"] + (
            ["prefill_attention:global_hist"] if global_hist else [])
        if work.is_meta(q):
            # shapes only: every query attends the table's whole span
            # (within the window unknown here) and its own chunk
            hist = M * ps
            work.record(keys, work.prefill(
                B, C, Hq, Hkv, Dh, q.element_size(), k_pages.element_size(),
                B * hist, B * C, B * C * (hist + C), variant,
                chunk_pairs=B * C * C,
                kv_terms=prefill_kv_terms(k_pages.dtype, fmt_kv, hist_bf16)))
            return out, k_pages, v_pages
        lib = _build.library("prefill_attention")
        err = lib.prefill_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), starts.data_ptr(),
            window.data_ptr(), None if page_ok is None else page_ok.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (hist_pool_k, hist_pool_v, hist_bt)),
            out.data_ptr(), None if span is None else span.data_ptr(),
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(), B, C,
            M, ps, Hq, Hkv, Dh, _ACT_KINDS[q.dtype], _KINDS[k_pages.dtype],
            fmt_kv.n if fmt_kv else 0, fmt_kv.es if fmt_kv else 0,
            int(hist_bf16), ck, _VARIANTS[variant], splits,
            1.0 / math.sqrt(Dh), float(softcap_val), _build.stream_of(q))
        if err == _REFUSED:
            raise ValueError(f"prefill_attention: the {variant} kernel does "
                             f"not take head_dim {Dh}")
        _build.check(err, "prefill_attention")
        work.count(LAUNCHES, keys)
    return out, k_pages, v_pages
