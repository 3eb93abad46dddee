"""Paged attention (one or T new tokens per slot) and the fused decode
epilogue (head GEMM + sampler): CUDA kernels and their plain versions.

`paged_attention` launches K3 (`csrc/paged_attention.cu`, replacing
`repro/kernels/paged_attention.py:paged_attention`) for a 3-D query, one
decode token per slot, and K7 (the same source, replacing
`_paged_attention_mq`) for a 4-D query, the T tokens of a speculative
verify; `decode_sample` (K4, `csrc/decode_sample.cu`) replaces
`repro/kernels/paged_attention.py:decode_sample`; `merge_attn_partials`
(the same source as K3) replaces the reference's plain
`repro/kernels/ops.py:merge_attn_partials`, the log-sum-exp merge of a
sharded pool's per-shard K3 / K7 partials.  On a CUDA tensor each
wrapper launches its kernel; on a CPU tensor it runs the plain PyTorch
version beside it, which states the same function densely; on a meta
tensor it counts the launch it would make (`kernels/work.py`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.formats import PositFormat
from . import _build, work
from .posit_codec import decode_plain

_NEG = -2.0e38
# launches of each kernel since the last reset (kernels/ops.reset_launches);
# "<kernel>:merge" counts the launches that also ran the split merge,
# "paged_attention_mq:t<n>" K7's launches by query-token tile t_block,
# "decode_sample:<variant>" K4's launches by `sample_variant`
LAUNCHES = {"paged_attention": 0, "paged_attention:merge": 0,
            "paged_attention_mq": 0, "paged_attention_mq:merge": 0,
            "paged_attention_mq:t1": 0, "paged_attention_mq:t2": 0,
            "paged_attention_mq:t4": 0, "paged_attention_mq:t8": 0,
            "decode_sample": 0, "decode_sample:p16_2": 0,
            "decode_sample:posit": 0, "decode_sample:f32": 0,
            "decode_sample:bf16": 0, "merge_attn_partials": 0}
_KINDS = {torch.int8: 0, torch.int16: 1, torch.float32: 2, torch.bfloat16: 3}
_SAMPLE_VARIANTS = {"posit": 0, "p16_2": 1, "f32": 2, "bf16": 3}
# K3 / K7 split a slot's key span across blocks: a split holds whole pages,
# SPLIT_KEYS // page_size of them (at least one), where a page fits a
# block's shared memory and holds at most MAX_SPLIT_KEYS keys; else a page
# is cut into splits of `split_key_cap(head_dim)` keys.  A lane holds at
# most MAX_HEAD_DIM / 32 dims of a row (csrc/paged_attention.cu)
SPLIT_KEYS = 32
MAX_SPLIT_KEYS = 128
MAX_HEAD_DIM = 256
# the shared memory a block may take on an H100
BLOCK_SMEM = 227 * 1024
# rows a block serves with one warp each (more rows take turns)
BLOCK_ROWS = 16


def split_smem_bytes(keys: int, head_dim: int) -> int:
    """Shared memory of a K3 / K7 block staging `keys` K and V rows in f32
    beside the int8 decode table (`smem_bytes` of csrc/paged_attention.cu)."""
    return 4 * (256 + 2 * keys * head_dim)


def _fits(head_dim: int) -> int:
    """The most keys a split may stage at this head_dim: MAX_SPLIT_KEYS,
    or fewer where their K and V rows would not fit BLOCK_SMEM."""
    return min(MAX_SPLIT_KEYS,
               (BLOCK_SMEM // 4 - 256) // (2 * max(1, head_dim)))


def split_key_cap(head_dim: int) -> int:
    """Keys of a split cut from a page that does not fit one: the largest
    power of two within `_fits(head_dim)` (128 up to head_dim 226, 64 at
    256), so the splits of a page of 2^k tokens tile it exactly."""
    return 1 << (_fits(head_dim).bit_length() - 1)


def attention_splits(M: int, page_size: int,
                     head_dim: int) -> tuple[int, int]:
    """(keys per split KS, splits S) of K3 / K7 over a block table of M
    pages: split s covers the keys [s KS, min(M page_size, (s + 1) KS)) of
    the table's span, in split order, S >= 1.  KS is whole pages, max(1,
    SPLIT_KEYS // page_size) of them, where one page fits a split; else
    `split_key_cap(head_dim)`, so a block's shared memory never grows with
    the page size.  KS depends on the page size and head_dim alone, never
    on T, t_block or a row's length, so every row of any call over the same
    table meets the same splits and the same merge order."""
    if page_size <= _fits(head_dim):
        ks = max(1, SPLIT_KEYS // page_size) * page_size
    else:
        ks = split_key_cap(head_dim)
    return ks, max(1, -(-M * page_size // ks))


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
    """Dense statement of the paged-attention kernels: gather each slot's
    pages by block table, decode, mask and softmax.  q is [B, Hq, Dh] (one
    token per slot, at position lengths - 1) or [B, T, Hq, Dh] (token i at
    lengths - T + i, `ref.paged_attention_mq_ref`); a key at pos counts
    where pos <= q_pos, q_pos - pos < window and page_ok is nonzero.  With
    partials, returns the unnormalized (o, m, l) the streaming kernels end
    with (m = -2e38, l = 0 for a row with nothing to attend)."""
    if q.ndim == 3:
        out = paged_attention_plain(q[:, None], k_pages, v_pages,
                                    block_tables, lengths, window, fmt_kv,
                                    softcap_val, page_ok, partials)
        return tuple(t[:, 0] for t in out) if partials else out[:, 0]
    B, T, Hq, Dh = q.shape
    _, ps, kvd = k_pages.shape
    Hkv = kvd // Dh
    G = Hq // Hkv
    M = block_tables.shape[1]
    S = M * ps
    bt = block_tables.long()
    kg = _as_f32_values(k_pages[bt], fmt_kv).reshape(B, S, Hkv, Dh)
    vg = _as_f32_values(v_pages[bt], fmt_kv).reshape(B, S, Hkv, Dh)
    scale = 1.0 / math.sqrt(Dh)
    # rows r = t * G + g of each KV head's group
    qg = q.reshape(B, T, Hkv, G, Dh).permute(0, 2, 1, 3, 4) \
          .reshape(B, Hkv, T * G, Dh).to(torch.float32) * scale
    s = _softcap(torch.einsum("bhrd,bkhd->bhrk", qg, kg), softcap_val)
    pos = torch.arange(S, device=q.device)[None, None, :]
    q_pos = (lengths.long()[:, None] - T
             + torch.arange(T, device=q.device)[None, :])[..., None]
    mask = (pos <= q_pos) & ((q_pos - pos) < window.long()[0])   # [B, T, S]
    if page_ok is not None:
        mask &= (page_ok != 0).repeat_interleave(ps, dim=1)[:, None, :]
    mask = mask[:, :, None, :].expand(B, T, G, S).reshape(B, 1, T * G, S)
    m = torch.where(mask, s, torch.full_like(s, _NEG)).amax(-1)
    m = torch.clamp(m, min=_NEG)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    o = torch.einsum("bhrk,bkhd->bhrd", p, vg)

    def rows(t, *tail):   # [B, Hkv, T * G, ...] -> [B, T, Hq, ...]
        return t.reshape(B, Hkv, T, G, *tail).transpose(1, 2) \
                .reshape(B, T, Hq, *tail)

    if partials:
        return rows(o, Dh), rows(m), rows(l)
    return rows(o / torch.clamp(l, min=1e-30)[..., None], Dh)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, window,
                    fmt_kv: PositFormat | None = None,
                    softcap_val: float = 0.0, page_ok=None,
                    partials: bool = False, t_block: int | None = None):
    """Attention of new query tokens over block-table-paged posit KV.

    q            : [B, Hq, Dh] float query (one decode token per slot; K3),
                   or [B, T, Hq, Dh] for T new tokens per slot (K7): token
                   i of slot b at position lengths[b] - T + i, causal over
                   the history and the other new tokens.  Row i equals
                   the 3-D call at length lengths - T + i + 1, bitwise.
    k/v_pages    : [n_pages, page_size, Hkv*Dh] posit codes (int8/int16,
                   decoded in-kernel via fmt_kv) or float (fmt_kv=None).
    block_tables : [B, max_pages] int32; page j holds the slot's positions
                   [j*page_size, (j+1)*page_size).
    lengths      : [B] int32 valid positions per slot including the new
                   token(s).
    window       : [1] int32 sliding-window size (>= max_seq = unbounded).
    page_ok      : optional [B, max_pages] int32 mask (nonzero = attend).
    partials     : return the unnormalized (o, m [B,(T,)Hq], l [B,(T,)Hq]).
    t_block      : K7's query-token tile (divides T; default the largest of
                   8, 4, 2, 1 that does and keeps t_block x Hq / Hkv within
                   BLOCK_ROWS); value-neutral, ignored for 3-D q.
                   On the card Dh may not exceed MAX_HEAD_DIM, nor the
                   page size MAX_SPLIT_KEYS, and a split's K and V rows
                   must fit a block's shared memory (the launcher refuses
                   them before launching: ValueError).

    Returns [B, Hq, Dh] (or [B, T, Hq, Dh]) f32, or the (o, m, l) triple."""
    if q.ndim not in (3, 4):
        raise ValueError(f"q must be [B, Hq, Dh] or [B, T, Hq, Dh], got "
                         f"{tuple(q.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"k/v page pools differ: {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    mq = q.ndim == 4
    B, Hq, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    T = q.shape[1] if mq else 1
    n_pages, ps, kvd = k_pages.shape
    Hkv = kvd // Dh
    if Hkv * Dh != kvd or Hq % Hkv:
        raise ValueError(f"page feature dim {kvd} incompatible with "
                         f"q heads {Hq} x head_dim {Dh}")
    if mq:
        # the largest of 8, 4, 2, 1 dividing T that keeps a block to
        # BLOCK_ROWS rows (a warp each); the reference takes the largest
        # dividing T, and every tile gives the same values
        t_block = next((tb for tb in (8, 4, 2) if T % tb == 0
                        and tb * (Hq // Hkv) <= BLOCK_ROWS), 1) \
            if t_block is None else int(t_block)
        if t_block < 1 or T % t_block:
            raise ValueError(f"t_block={t_block} must divide T={T}")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, window, fmt_kv, softcap_val,
                                     page_ok, partials)
    if k_pages.dtype not in _KINDS:
        raise TypeError(f"paged_attention takes int8/int16/f32/bf16 pages, "
                        f"got {k_pages.dtype}")
    if fmt_kv is not None and k_pages.is_floating_point():
        raise TypeError("fmt_kv given but the pages hold floats")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention on the card takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {Dh}")
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
    kernel = "paged_attention_mq" if mq else "paged_attention"
    _build.require_cuda(kernel, q, k_pages, v_pages, block_tables, lengths,
                        window, *extra)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = l = None
    if partials:
        m = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
        l = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    if B and T:
        ks, n_splits = attention_splits(M, ps, Dh)
        part_o = part_ml = None
        if n_splits > 1:
            # each row's per-split (o, m, l), merged in split order
            part_o = torch.empty((B * T * Hq, n_splits, Dh),
                                 dtype=torch.float32, device=q.device)
            part_ml = torch.empty((B * T * Hq, n_splits, 2),
                                  dtype=torch.float32, device=q.device)
        keys = [kernel] + ([f"{kernel}:merge"] if n_splits > 1 else []) \
            + ([f"{kernel}:t{t_block}"] if mq else [])
        if work.is_meta(q):
            # shapes only: every row attends the table's whole span
            work.record(keys, work.paged_attention(
                B, T, Hq, Hkv, Dh, B * M * ps, k_pages.element_size(), M,
                B * T * M * ps, partials, page_ok is not None))
            return (out, m, l) if partials else out
        lib = _build.library("paged_attention")
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        head = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), window.data_ptr(),
                ptr(page_ok), out.data_ptr(), ptr(m), ptr(l), ptr(part_o),
                ptr(part_ml), B, M, ps)
        tail = (Hq, Hkv, Dh, _KINDS[k_pages.dtype],
                fmt_kv.n if fmt_kv else 0, fmt_kv.es if fmt_kv else 0,
                ks, n_splits, 1.0 / math.sqrt(Dh), float(softcap_val),
                _build.stream_of(q))
        if mq:
            err = lib.paged_attention_mq_launch(*head, T, t_block, *tail)
        else:
            err = lib.paged_attention_launch(*head, *tail)
        _build.check(err, kernel)
        work.count(LAUNCHES, keys)
    return (out, m, l) if partials else out


# ---------------------------------------------------------------------------
# the sharded pools' merge of per-shard partials
# ---------------------------------------------------------------------------

def _stacked(parts, home):
    if isinstance(parts, (list, tuple)):
        return torch.stack([t.to(home) for t in parts])
    return parts


def merge_attn_partials_plain(o, m, l):
    """The merge below, plain: shard order, one rounding per product and
    per sum, K3's finalize."""
    mx = m.amax(0)
    lt = torch.zeros_like(l[0])
    ot = torch.zeros_like(o[0])
    for s in range(o.shape[0]):
        w = torch.exp(m[s] - mx)
        lt = lt + l[s] * w
        ot = ot + o[s] * w[..., None]
    return ot / torch.clamp(lt, min=1e-30)[..., None]


def merge_attn_partials(o, m, l):
    """Log-sum-exp merge of the per-shard partials of `paged_attention(...,
    page_ok=<the shard's ownership>, partials=True)`: o [S, B, (T,) Hq,
    Dh], m / l [S, B, (T,) Hq] f32, stacked over the S shards or given as
    lists of S tensors (moved to the first one's device).  Every shard's
    state is rescaled to the rows' global max, summed in shard order and
    normalized as K3 normalizes, o / max(l, 1e-30), dividing: a row whose
    pages all lie on one shard is bitwise K3's unsharded output (the other
    shards hold m = -2e38, l = 0, so their weight is 0).  Returns
    [B, (T,) Hq, Dh] f32."""
    home = (o[0] if isinstance(o, (list, tuple)) else o).device
    o, m, l = (_stacked(t, home) for t in (o, m, l))
    if o.shape[:-1] != m.shape or l.shape != m.shape:
        raise ValueError(f"partials o {tuple(o.shape)}, m {tuple(m.shape)}, "
                         f"l {tuple(l.shape)} do not match")
    if o.device.type == "cpu":
        return merge_attn_partials_plain(o, m, l)
    o, m, l = (t.to(torch.float32).contiguous() for t in (o, m, l))
    _build.require_cuda("merge_attn_partials", o, m, l)
    out = torch.empty(o.shape[1:], dtype=torch.float32, device=o.device)
    S, Dh = o.shape[0], o.shape[-1]
    rows = m[0].numel()
    if rows:
        keys = ("merge_attn_partials",)
        if work.is_meta(o):
            work.record(keys, work.merge(S, rows, Dh))
            return out
        _build.check(_build.library("paged_attention").attn_shard_merge_launch(
            o.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), S, rows,
            Dh, _build.stream_of(o)), "merge_attn_partials")
        work.count(LAUNCHES, keys)
    return out


# ---------------------------------------------------------------------------
# fused decode epilogue: logits-head posit GEMM + sampling
# ---------------------------------------------------------------------------

def scale_logits(l, temperature):
    """l / max(T, 1e-6) in f32, as the reference's `logits /
    jnp.maximum(temperature, 1e-6)`: the divisor is a 0-dim f32 tensor on
    l's device.  (PyTorch divides a CUDA tensor by a Python or CPU scalar
    as a multiply by its reciprocal, which can be one ulp off.)  A 0-dim
    f32 tensor on l's device is taken as the divisor itself (a captured
    step cannot copy a host scalar to the card)."""
    if isinstance(temperature, torch.Tensor):
        return l / temperature
    t = torch.tensor(max(float(temperature), 1e-6), dtype=torch.float32,
                     device=l.device)
    return l / t


def sample_logits(l, noise, temperature, *, greedy: bool, top_k: int):
    """The serving sampler on f32 logits rows [B, V]: greedy argmax, or
    argmax(noise + l / T) after the exact top-k filter
    `l >= sort(l)[..., -top_k]` (categorical(key, l) == argmax of gumbel
    noise + l).  Ties go to the first index, as in jnp.argmax."""
    if greedy:
        return torch.argmax(l, dim=-1).to(torch.int32)
    l = scale_logits(l, temperature)
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


def sample_variant(w_dtype, fmt_w: PositFormat | None) -> str:
    """K4's pass-1 kernel for the head's weights: "p16_2" (int16 P(16,2)
    codes, every serving head: the compile-time decode), "posit" (codes of
    any other format: the run-time decode), "f32" or "bf16" (float
    weights, read as they are)."""
    if w_dtype in (torch.int8, torch.int16):
        if fmt_w is None:
            raise ValueError("decode_sample: coded head weights need fmt_w")
        return ("p16_2" if (fmt_w.n, fmt_w.es) == (16, 2)
                and w_dtype == torch.int16 else "posit")
    if w_dtype in (torch.float32, torch.bfloat16):
        return "f32" if w_dtype == torch.float32 else "bf16"
    raise TypeError(f"decode_sample takes int8/int16/f32/bf16 weights, "
                    f"got {w_dtype}")


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

    On the card the weights decode by `sample_variant`, and one pass over
    them serves up to 16 batch rows; a row's logits (and token) do not
    depend on B or on the other rows.

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
    variant = sample_variant(w.dtype, fmt_w)
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
        keys = ("decode_sample", f"decode_sample:{variant}")
        if work.is_meta(x):
            # the kernel's [B, V] logits scratch, live during the launch
            torch.empty((B, V), dtype=torch.float32, device=x.device)
            work.record(keys, work.decode_sample(
                B, D, V, w.element_size(), 4, greedy))
            return tok
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
            _SAMPLE_VARIANTS[variant], fmt_w.n if fmt_w else 0,
            fmt_w.es if fmt_w else 0, int(rbf16),
            float(softcap_val), 1.0 if temperature is None else float(temperature),
            int(greedy), k, _build.stream_of(x)),
            "decode_sample")
        work.count(LAUNCHES, keys)
    return tok
