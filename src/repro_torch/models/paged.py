"""Paged KV-cache layout + page-pool utilities (PyTorch port of
`repro.models.paged`, single pool).

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
here write into the pool **in place** and return it.  Sharded pools
(`n_shards > 1`) are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

# flash_attention's default key-chunk length (models/common.py).
FLASH_CHUNK = 1024


def fused_prefill_span_ok(max_pages: int, page_size: int, chunk: int) -> bool:
    """True when the reference's fused prefill kernel is bit-exact for this
    geometry (a page size that divides FLASH_CHUNK, or a span within one
    flash chunk).  Kept for parity; the port's prefill is decomposed."""
    if max_pages * page_size + chunk <= FLASH_CHUNK:
        return True
    return FLASH_CHUNK % page_size == 0


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Geometry of the paged KV pool: `page_size` tokens per page and
    `n_pages` pages including the reserved trash page 0."""

    page_size: int
    n_pages: int
    n_shards: int = 1

    def __post_init__(self):
        if self.page_size <= 0:
            raise ValueError(f"bad paged layout {self}")
        if self.n_shards != 1:
            raise NotImplementedError(
                "kv_pages-sharded page pools are not ported yet "
                "(ROADMAP queue 1, slice H)")
        if self.n_pages < 2:
            raise ValueError(f"the pool needs its trash page plus >=1 usable "
                             f"page; got {self.n_pages} pages in {self}")

    @property
    def capacity(self) -> int:
        """Allocatable pages: everything but the trash page."""
        return self.n_pages - 1

    def pages_per_slot(self, max_seq: int) -> int:
        """Block-table row length: pages addressing positions < max_seq."""
        return -(-max_seq // self.page_size)

    @staticmethod
    def for_slots(batch: int, max_seq: int, page_size: int,
                  n_pages: int | None = None) -> "PagedLayout":
        """Default pool: full capacity for every slot plus the trash page
        (smaller pools oversubscribe)."""
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        per = -(-max_seq // page_size)
        if n_pages is None:
            n_pages = batch * per + 1
        return PagedLayout(page_size, n_pages)


def insert_tokens(pages, block_table, lengths, vals):
    """Write one decode token per slot into the pool, in place.

    pages: [P, ps, F]; block_table: [B, M]; lengths: [B] (write position per
    slot); vals: [B, F].  Rows with zeroed block tables land on the trash
    page."""
    ps = pages.shape[1]
    B = vals.shape[0]
    lengths = lengths.long()
    idx = torch.clamp(lengths // ps, 0, block_table.shape[1] - 1)
    page = block_table[torch.arange(B, device=pages.device), idx].long()
    pages[page, lengths % ps] = vals.to(pages.dtype)
    return pages


def insert_chunk(pages, bt_row, start, vals):
    """Write a prefill chunk for one slot, in place: vals [C, F] at
    positions start + [0, C) of the slot whose block-table row is bt_row."""
    ps = pages.shape[1]
    pos = start + torch.arange(vals.shape[0], device=pages.device)
    page = bt_row[torch.clamp(pos // ps, 0, bt_row.shape[0] - 1)].long()
    pages[page, pos % ps] = vals.to(pages.dtype)
    return pages


def insert_chunk_batched(pages, bt, starts, vals):
    """Write one prefill chunk per slot in one scatter, in place: vals
    [B, C, F] at positions starts[b] + [0, C) of slot b.  Inactive rows
    (zeroed block tables) land on the trash page."""
    ps = pages.shape[1]
    B, C, _ = vals.shape
    pos = starts.long()[:, None] + torch.arange(C, device=pages.device)[None]
    page = torch.gather(bt.long(), 1,
                        torch.clamp(pos // ps, 0, bt.shape[1] - 1))
    pages[page, pos % ps] = vals.to(pages.dtype)
    return pages


def gather_slot(pages, bt_row):
    """One slot's pages densely: [M*ps, F] (garbage past the written
    prefix — callers mask by position)."""
    M = bt_row.shape[0]
    return pages[bt_row.long()].reshape(M * pages.shape[1], pages.shape[2])


def gather_slots(pages, bt):
    """Every slot's pages densely: [B, M*ps, F]."""
    B, M = bt.shape
    return pages[bt.long()].reshape(B, M * pages.shape[1], pages.shape[2])
