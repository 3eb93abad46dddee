"""Paged KV-cache layout + page-pool utilities (PyTorch port of
`repro.models.paged`).

The KV cache is a pool of fixed-size pages `[n_pages, page_size, Hkv*Dh]`
at the QuantPolicy's KV code width, and each batch slot owns an ordered
list of page indices (its block table): page j of a slot holds absolute
positions [j*page_size, (j+1)*page_size).  The invariants of the
reference hold:

  * page 0 is the trash page — never allocated; zeroed block-table rows
    (free / mid-prefill / inactive slots) direct stray writes and gathers
    there,
  * a slot's pages appear in its block-table row in position order,
  * positions >= length are dead: reclaimed pages are reused without
    zeroing, and every read masks `pos < length`.

Unlike the JAX functions, which return new arrays, the insert helpers
here write into the pool **in place** and return it.

Global page-id contract (kv_pages-sharded pools)
------------------------------------------------

A pool sharded along its page dimension (`PagedLayout(n_shards > 1)`) is
a list of `n_shards` sub-pools, shard s holding the contiguous global-id
range [s * pages_per_shard, (s + 1) * pages_per_shard) on its own device
(`PageShard.devices[s]`).  Block tables keep **global** ids:

    shard(g)  = g // pages_per_shard
    local(g)  = g %  pages_per_shard
    global(s, l) = s * pages_per_shard + l

Every shard's local page 0 is its trash page (global ids
s * pages_per_shard); the allocator never hands one out, so capacity is
n_pages - n_shards.  `localize_ids` maps the ids a shard does not own to
its own trash page and returns the ownership mask.  The helpers below
take `shard=PageShard(...)` with such a list of sub-pools: a write lands
in every shard's sub-pool, on the owned page or on that shard's trash
page; a gather indexes the global pool (`global_pool`: the sub-pools in
shard order on the home device, the reference's all_gather; a view when
they share one card; the rows are those of the reference's psum of each
shard's owned rows), which the fused prefill also reads its history
from; a fork copies the page from its owner to the owner of the
destination.  The reference runs these inside a `shard_map`; the port
dispatches each shard's work explicitly, and the model's dense work runs
once on the home device, `PageShard.devices[0]`.  Shards may share one
device (logical page ranges of one card) or sit on several.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import work

# flash_attention's default key-chunk length (models/common.py).
FLASH_CHUNK = 1024


def fused_prefill_span_ok(max_pages: int, page_size: int, chunk: int) -> bool:
    """True when the fused prefill kernel replays `flash_attention`'s chunk
    boundaries for this geometry: a span within one flash chunk, or a page
    size that divides FLASH_CHUNK (history then streams in FLASH_CHUNK
    steps).  Callers read FLASH_CHUNK live (tests shrink it)."""
    if max_pages * page_size + chunk <= FLASH_CHUNK:
        return True
    return FLASH_CHUNK % page_size == 0


def fused_prefill_applies(quant, max_pages: int, page_size: int,
                          chunk: int) -> bool:
    """Whether a prefill chunk of `chunk` tokens over slots of `max_pages`
    pages runs the fused prefill kernel (one program per layer) rather
    than the decomposed stages (three): the policy's `fused_prefill` and a
    span `fused_prefill_span_ok` admits.  The model and the engine's
    program count both ask here."""
    return bool(quant.fused_prefill) and fused_prefill_span_ok(
        max_pages, page_size, chunk)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Geometry of the paged KV pool.

    page_size : tokens per page (the policy's `kv_page_size` by default).
    n_pages   : total pool pages across every shard, including the
                per-shard trash pages (local page 0 of each).
    n_shards  : shards the page dimension is split over (the `kv_pages`
                mesh axis); 1 is the single pool."""

    page_size: int
    n_pages: int
    n_shards: int = 1

    def __post_init__(self):
        if self.page_size <= 0 or self.n_shards < 1:
            raise ValueError(f"bad paged layout {self}")
        if self.n_pages % self.n_shards:
            raise ValueError(
                f"n_pages={self.n_pages} must divide evenly over "
                f"n_shards={self.n_shards} (the kv_pages mesh axis)")
        if self.pages_per_shard < 2:
            raise ValueError(
                f"each shard needs its trash page plus >=1 usable page; "
                f"got {self.pages_per_shard} pages/shard in {self}")

    @property
    def pages_per_shard(self) -> int:
        return self.n_pages // self.n_shards

    @property
    def capacity(self) -> int:
        """Allocatable pages: everything but the per-shard trash pages."""
        return self.n_pages - self.n_shards

    def pages_per_slot(self, max_seq: int) -> int:
        """Block-table row length: pages addressing positions < max_seq."""
        return -(-max_seq // self.page_size)

    # -- host-side global <-> (shard, local) id mapping -------------------

    def _check(self, page: int):
        if not 0 <= page < self.n_pages:
            raise ValueError(
                f"page id {page} out of range [0, {self.n_pages})")

    def shard_of(self, page: int) -> int:
        self._check(page)
        return page // self.pages_per_shard

    def local_id(self, page: int) -> int:
        self._check(page)
        return page % self.pages_per_shard

    def global_id(self, shard: int, local: int) -> int:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range [0, {self.n_shards})")
        if not 0 <= local < self.pages_per_shard:
            raise ValueError(
                f"local id {local} out of range [0, {self.pages_per_shard})")
        return shard * self.pages_per_shard + local

    def is_trash(self, page: int) -> bool:
        """Every shard's local page 0 is reserved (global 0 included)."""
        self._check(page)
        return page % self.pages_per_shard == 0

    @staticmethod
    def for_slots(batch: int, max_seq: int, page_size: int,
                  n_pages: int | None = None,
                  n_shards: int = 1) -> "PagedLayout":
        """Default pool: full capacity for every slot plus the trash page
        per shard (smaller pools oversubscribe).  Sharded pools split the
        budget evenly: each of the n_shards holds
        ceil(batch * pages_per_slot / n_shards) usable pages plus its own
        trash page."""
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        per = -(-max_seq // page_size)
        if n_pages is None:
            n_pages = n_shards * (-(-(batch * per) // n_shards) + 1)
        return PagedLayout(page_size, n_pages, n_shards)


@dataclasses.dataclass(frozen=True)
class PageShard:
    """kv_pages shard context: the pool's page dimension is split into
    `len(devices)` contiguous ranges, sub-pool s on `devices[s]`.  The
    home device `devices[0]` holds everything else (weights, block
    tables, lengths, recurrent states) and runs the model's dense work."""

    devices: tuple

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if len(self.devices) < 2:
            raise ValueError(f"a PageShard splits the pool over >= 2 shards, "
                             f"got {len(self.devices)}")

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def localize_ids(ids, pages_per_shard: int, index: int):
    """Global page ids -> (local ids, ownership mask) for shard `index`.

    Ids the shard does not own localize to its trash page 0, so they can
    index the sub-pool directly; callers mask reads with `owned` (writes
    to local page 0 are harmless by contract)."""
    loc = ids - index * pages_per_shard
    owned = (loc >= 0) & (loc < pages_per_shard)
    return torch.where(owned, loc, torch.zeros_like(loc)), owned


def layer_pools(pool, i: int):
    """Layer (or block) i of a cache's page pool: `pool[i]`, or under a
    shard the list of every sub-pool's layer i."""
    if isinstance(pool, (list, tuple)):
        return [p[i] for p in pool]
    return pool[i]


def pool_page_size(pages) -> int:
    """Tokens a page of a pool (or of a sharded pool's sub-pools)."""
    return (pages[0] if isinstance(pages, (list, tuple)) else pages).shape[1]


def _scatter(pages, page, pos, vals, shard):
    """pages[page, pos] = vals (in place), page holding global ids; under
    `shard` into every sub-pool, non-owned rows onto its trash page."""
    if shard is None:
        pages[page.long(), pos] = vals.to(pages.dtype)
        return pages
    for s, sub in enumerate(pages):
        dev = sub.device
        loc, _ = localize_ids(page.to(dev).long(), sub.shape[0], s)
        sub[loc, pos.to(dev)] = vals.to(dev, sub.dtype)
    return pages


def insert_tokens(pages, block_table, lengths, vals, shard=None):
    """Write one decode token per slot into the pool, in place.

    pages: [P, ps, F] (under `shard` the list of sub-pools); block_table:
    [B, M] global ids; lengths: [B] (write position per slot); vals:
    [B, F].  Rows with zeroed block tables land on the trash page."""
    ps = pool_page_size(pages)
    B = vals.shape[0]
    lengths = lengths.long()
    idx = torch.clamp(lengths // ps, 0, block_table.shape[1] - 1)
    page = block_table[torch.arange(B, device=block_table.device), idx]
    return _scatter(pages, page, lengths % ps, vals, shard)


def insert_chunk(pages, bt_row, start, vals, shard=None):
    """Write a prefill chunk for one slot, in place: vals [C, F] at
    positions start + [0, C) of the slot whose block-table row is bt_row."""
    ps = pool_page_size(pages)
    pos = start + torch.arange(vals.shape[0], device=bt_row.device)
    page = bt_row[torch.clamp(pos // ps, 0, bt_row.shape[0] - 1)]
    return _scatter(pages, page, pos % ps, vals, shard)


def insert_chunk_batched(pages, bt, starts, vals, shard=None):
    """Write one prefill chunk per slot in one scatter, in place: vals
    [B, C, F] at positions starts[b] + [0, C) of slot b.  Inactive rows
    (zeroed block tables) land on the trash page."""
    ps = pool_page_size(pages)
    B, C, _ = vals.shape
    pos = starts.long()[:, None] + torch.arange(C, device=bt.device)[None]
    page = torch.gather(bt.long(), 1,
                        torch.clamp(pos // ps, 0, bt.shape[1] - 1))
    return _scatter(pages, page, pos % ps, vals, shard)


def fork_page(pool, dst: int, src: int, shard=None):
    """Copy-on-write fork, in place: duplicate page `src` into page `dst`
    across the leading (layer) dim.  pool: [L, P, ps, F]; under `shard`
    the list of sub-pools [L, pages_per_shard, ps, F], src and dst global
    ids: the owner of src hands the page to the owner of dst."""
    if shard is None:
        pool[:, dst] = pool[:, src]
        return pool
    pps = pool[0].shape[1]
    s_dst, s_src = divmod(dst, pps), divmod(src, pps)
    target = pool[s_dst[0]]
    target[:, s_dst[1]] = pool[s_src[0]][:, s_src[1]].to(target.device)
    return pool


def global_pool(pages, device):
    """A sharded pool's sub-pools in shard order as one pool on `device`,
    indexed by global id (the reference's all_gather): a view where they
    are consecutive blocks of one tensor there (the shards of one device,
    as `api.init_cache` lays them out), else their concatenation."""
    first, want = pages[0], torch.device(device)
    size = first.numel() * first.element_size()
    if len(pages) > 1 and any(
            p.device.type == "meta" or p.device.type != want.type
            or want.index not in (None, p.device.index) for p in pages):
        # a shard off `device` hands its sub-pool to the gather: the bytes
        # one position sends, whatever the number of shards.  On meta (the
        # dry run) this is what a placement of the shards on separate
        # cards would send; sub-pools on `device` itself move no byte
        work.exchange("paged:history", size)
    storage = first.untyped_storage().data_ptr()
    if first.device.type == want.type and want.index in (
            None, first.device.index) and all(
            p.device == first.device and p.shape == first.shape
            and p.is_contiguous()
            and p.untyped_storage().data_ptr() == storage
            and p.data_ptr() == first.data_ptr() + s * size
            for s, p in enumerate(pages)):
        return first.as_strided((len(pages) * first.shape[0],)
                                + tuple(first.shape[1:]), first.stride())
    return torch.cat([sub.to(device) for sub in pages])


def _gather(pages, bt, shard):
    """pages[bt] for global ids bt [..., M]: [..., M, ps, F]; under `shard`
    from the global pool on bt's device (the rows the reference's psum of
    each shard's owned rows gives)."""
    if shard is not None:
        pages = global_pool(pages, bt.device)
    return pages[bt.long()]


def gather_slot(pages, bt_row, shard=None):
    """One slot's pages densely: [M*ps, F] (garbage past the written
    prefix — callers mask by position)."""
    rows = _gather(pages, bt_row, shard)
    return rows.reshape(-1, rows.shape[-1])


def gather_slots(pages, bt, shard=None):
    """Every slot's pages densely: [B, M*ps, F]."""
    rows = _gather(pages, bt, shard)
    return rows.reshape(bt.shape[0], -1, rows.shape[-1])
