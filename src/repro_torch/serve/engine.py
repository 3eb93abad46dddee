"""Posit-KV serving engine (PyTorch port of `repro.serve.engine`).

The engine is a host-side slot scheduler over the model entry points:

  * `prefill_chunk_batched` — prompts decompose exactly into chunks from a
    small bucket table (e.g. 64/16/4/1 tokens), and all slots whose next
    chunk has the same bucket size advance as ONE [batch_slots, chunk]
    pass; rows of other slots are masked (zeroed metadata, writes to the
    trash page).  `batched_prefill=False` runs one slot at a time.  With
    `fused_prefill` (the default) each layer's chunk attention, KV encode
    and page insert are one launch of the fused prefill kernel.
  * `decode_step` — one token for every decoding slot per iteration; with
    `fused_decode` (the default) the head GEMM and the sampler run in the
    fused decode-sample kernel, else the decode pass returns logits and
    the sampler draws.  On a card the single pool's decode step is one
    device program, as the reference's `jax.jit` makes it: the first step
    runs eagerly, the second captures the step as a CUDA graph over
    static buffers (tokens, lengths, block tables, the `active` mask, the
    gumbel noise) and every later step replays it, one replay a fused
    step and two unfused (the decode and the sampler graph)
    (`runtime/step_graph.py`; `disable_graphs()` runs it op by op).
    Prefill, speculative rounds, copy-on-write forks and sharded pools
    dispatch eagerly.

The KV cache is a pool of posit-coded pages `[L, n_pages, page_size,
Hkv*Dh]` updated in place, with a block table per slot; pages come from a
host free list (`PageAllocator`, page 0 reserved as trash) and are
reclaimed at retirement without zeroing (reads mask `pos < length`).

Prefix sharing (the default): a prefix index maps the digest of each
prompt-token prefix that fills a page to the physical page holding its
KV.  A request whose prompt shares such a prefix maps the donor's pages
(refcount + 1) and prefills only the rest; sharing stops at a boundary of
the request's own chunk decomposition, so shared serving is token-
identical to unshared serving.  Shared pages are copy-on-write below
their frozen prefix: a slot about to write there first forks the page
(`paged.fork_page`).  Admission reserves each request's fork page, so a
fork never allocates mid-flight; a retiring request's prefix pages that a
queued request still matches are held by the engine until that request
admits or leaves.

Sampling: greedy argmax, or temperature / top-k sampling from gumbel
noise drawn per (base seed, request seed, draw index) — reproducible and
independent of batch composition.  `noise_fn(seed, draw_index, vocab)`
replaces the default torch.Generator stream (tests replay the reference's
`jax.random` stream through it).

Speculative decoding (`speculate_k=k`): each round a draft policy
(`QuantPolicy.with_draft()`: fake_quant over the same weights, or
`draft_quant` / `draft_params`) proposes k-1 tokens per decoding slot with
plain decode steps, and one batched verify under the serve policy
(`api.decode_verify`: one multi-query paged-attention launch per layer,
the fused head + sampler over the B*k rows) scores all k positions.  Draft
and verify write the same posit-coded pages; the verify re-writes every
position before it attends, each position samples with the noise of the
draw plain decode would make there, and the longest prefix of drafts that
match the verified tokens commits, so the streams are plain decode's.
Rejected positions are rolled back by the host's slot lengths.

Under the bit_exact plan (`validate_bit_exact`) there is no fused head:
decoding is `decode_step`, the logits head through the PDPU GEMM and the
host sampler.  A routed-MoE config whose capacity can drop choices
prefills slot by slot (a batched chunk's padding rows could displace
active tokens), and MoE has no k-token verify, so `speculate_k` raises.

`preempt(slot)` evicts a running request back to the head of the queue
(its prompt pages become holds it maps again on re-admission; its tokens
are replayed identically) and `cancel(rid)` drops a queued request.

`paged=False` serves from the dense cache instead: rows [L, B, max_seq,
Hkv*Dh] per slot at KV code width, zeroed when a slot is admitted, with
no allocator, no prefix sharing, no fused prefill or fused decode (the
dense attention runs outside the kernels, as in the reference) and no
speculation.

Recurrent families (SSM, hybrid) carry per-slot conv / SSM state rows
beside any KV.  A slot's rows are zeroed at admission (prefill seeds
them) and a decode call writes only the decoding slots' rows, so a slot
filling between steps keeps its own.  An SSM cache has no pages: the
engine serves it unpaged whatever `paged` says.  Under prefix sharing a
hybrid registers a snapshot of the slot's states with each page whose
end is a chunk boundary; a request maps a shared prefix only up to such
a page and starts from its snapshot (no partially-filled tail pages).
Recurrent state cannot roll back a rejected draft, so `speculate_k`
raises for these families, and bucket sizes the SSD's chunk length does
not divide are dropped.

Sharded pools (`mesh=...`, a `parallel.sharding.Mesh` whose >1 axis is
the one the rules map kv_pages onto, e.g. `launch.mesh.make_serving_mesh`):
the pool's pages split into contiguous per-shard ranges, one sub-pool per
mesh device and one page budget per shard (`PageAllocator`); block tables
keep global page ids (models/paged.py).  Allocation keeps a slot on one
shard when any budget fits (a prefix donor's shard first) and spills
otherwise; admission checks each request against the per-shard budgets.
Decode runs the paged-attention kernel on every shard and merges the
partials, bitwise the single pool for a slot on one shard; fused prefill
reads history from the gathered global pool.  Everything else (weights,
metadata, conv / SSM states) stays on the home device, the mesh's first,
where the model's dense work runs once.  Dense-cache and SSM-family
engines ignore the mesh; speculation over a sharded pool is refused, as
the reference refuses it.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, set_float32_parity
from repro_torch.kernels.paged_attention import sample_logits
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models import paged as paged_mod
from repro_torch.models.paged import PagedLayout, PageShard, fork_page, \
    fused_prefill_applies, fused_prefill_span_ok
from repro_torch.parallel import sharding
from repro_torch.runtime import step_graph


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    seed: Optional[int] = None   # sampling stream (defaults to rid)
    out_tokens: Optional[list] = None


class PageAllocator:
    """Host-side refcounted free lists over the (possibly sharded) KV pool.

    Block tables address global page ids (models/paged.py).  With
    n_shards=1 this is the single pool: page 0 is the trash page and is
    never handed out.  With n_shards>1 the pool's pages split into
    contiguous per-shard ranges and the allocator keeps one free list, one
    page budget, per shard: every shard's local page 0 (global ids
    divisible by pages_per_shard) is its trash page, so capacity is
    n_pages - n_shards.

    `alloc(n, prefer_shard=...)` grants fresh pages (low local ids first)
    at refcount 1 from one shard when any single shard can serve all n
    (prefer_shard first, a prefix donor's shard; else the shard with the
    most free pages, ties by index), and spills deterministically across
    shards (most free first, ties by index) only when no single budget
    fits.  `share` takes an extra reference, `free` drops one reference
    per page and recycles a page onto its own shard's free list when its
    last reference goes (returning the recycled pages); freeing a page
    that holds no reference raises."""

    def __init__(self, n_pages: int, n_shards: int = 1):
        if n_pages % n_shards:
            raise ValueError(f"n_pages={n_pages} not divisible by "
                             f"n_shards={n_shards}")
        self.n_shards = n_shards
        self.pages_per_shard = n_pages // n_shards
        if self.pages_per_shard < 2:
            raise ValueError(f"need >= 2 pages per shard (trash + 1), got "
                             f"{self.pages_per_shard}")
        self.capacity = n_pages - n_shards
        self.peak_in_use = 0
        self.total_allocs = 0   # fresh grants ever (shares not counted)
        # per-shard free lists of global ids, pop() -> low local ids first
        self._free = [list(range((s + 1) * self.pages_per_shard - 1,
                                 s * self.pages_per_shard, -1))
                      for s in range(n_shards)]
        self._refs: Dict[int, int] = {}

    @property
    def pages_free(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def pages_in_use(self) -> int:
        return self.capacity - self.pages_free

    @property
    def pages_free_by_shard(self) -> List[int]:
        return [len(f) for f in self._free]

    @property
    def pages_in_use_by_shard(self) -> List[int]:
        per = self.pages_per_shard - 1  # usable pages per shard
        return [per - len(f) for f in self._free]

    def shard_of(self, page: int) -> int:
        return page // self.pages_per_shard

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int,
              prefer_shard: Optional[int] = None) -> Optional[List[int]]:
        if n > self.pages_free:
            return None
        if n == 0:
            return []
        if prefer_shard is not None and len(self._free[prefer_shard]) >= n:
            order = [prefer_shard]
        else:
            fits = [s for s in range(self.n_shards)
                    if len(self._free[s]) >= n]
            if fits:
                order = [max(fits, key=lambda s: (len(self._free[s]), -s))]
            else:
                order = sorted(range(self.n_shards),
                               key=lambda s: (-len(self._free[s]), s))
        out: List[int] = []
        for s in order:
            while len(out) < n and self._free[s]:
                out.append(self._free[s].pop())
        for p in out:
            self._refs[p] = 1
        self.total_allocs += len(out)
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return out

    def share(self, pages: List[int]):
        """Take one extra reference per page."""
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise ValueError(f"cannot share free page {p}")
            self._refs[p] += 1

    def free(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; returns the pages recycled."""
        recycled = []
        for p in pages:
            rc = self._refs.get(p, 0)
            if rc < 1:
                raise ValueError(f"double free of page {p}")
            if rc == 1:
                del self._refs[p]
                self._free[self.shard_of(p)].append(p)
                recycled.append(p)
            else:
                self._refs[p] = rc - 1
        return recycled


def _nbytes(leaf) -> int:
    """Bytes of a cache leaf (a tensor, or a sharded pool's sub-pools)."""
    if isinstance(leaf, (list, tuple)):
        return sum(_nbytes(t) for t in leaf)
    return leaf.numel() * leaf.element_size()


def _canonical(dev: torch.device) -> torch.device:
    """`cuda` names the current card: give it its index."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


_FREE, _PREFILL, _DECODE = 0, 1, 2
_META = ("k", "v", "length", "block_table")


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, batch_slots: int,
                 max_seq: int, greedy: bool = True, *,
                 temperature: float = 1.0, top_k: int = 0,
                 base_seed: int = 0, paged: bool = True,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefill_buckets=(64, 16, 4, 1),
                 prefill_chunks_per_step: int = 0,
                 prefix_sharing: Optional[bool] = None,
                 batched_prefill: Optional[bool] = None,
                 fused_prefill: Optional[bool] = None,
                 fused_decode: Optional[bool] = None,
                 speculate_k: int = 0,
                 draft_quant=None,
                 draft_params=None,
                 mesh=None,
                 noise_fn: Optional[Callable] = None,
                 device="cuda"):
        """batch_slots decode slots over a max_seq position budget per slot,
        serving `params` (float or posit-packed, already on `device`).

        page_size defaults to cfg.quant.kv_page_size (with fused prefill
        on, lowered to a divisor of paged.FLASH_CHUNK when needed; an
        explicit size that loses the one-launch prefill raises, see
        _resolve_page_size) and n_pages to full capacity (batch_slots *
        pages_per_slot + the trash page); a smaller n_pages oversubscribes
        and admission waits for reclaimed pages.
        prefill_chunks_per_step=0 completes a prompt's chunks at admission;
        k>0 interleaves at most k chunks per request per step with decode.
        batched_prefill / fused_decode / fused_prefill / prefix_sharing
        override the QuantPolicy knobs.
        noise_fn(seed, draw_index, vocab) -> [vocab] f32 gumbel row, for
        sampled decoding; the default draws from a torch.Generator seeded
        by (base_seed, seed, draw_index).
        speculate_k >= 2 turns speculative decoding on (k tokens per
        round); draft_quant (default cfg.quant.with_draft()) must keep the
        serve policy's kv_cache and kv_page_size; draft_params defaults to
        `params`.  paged=False serves from the dense cache (no pages: the
        page and sharing knobs do not apply, decoding takes decode_step
        and the host sampler).
        mesh: a `parallel.sharding.Mesh`.  When kv_pages maps onto one of
        its axes of size > 1, the page pool splits over that axis: one
        sub-pool and one page budget per shard, n_pages divisible by the
        shard count, sub-pool s on mesh.devices[s]; `device` must be the
        mesh's first device (the home device).  Any other axis of size > 1,
        or kv_pages over two such axes, raises.  Dense-cache and SSM
        engines ignore the mesh.

        Constructing an engine turns TF32 off (`set_float32_parity`): the
        posit-decoded P(16,2) weights have 11 fraction bits, which TF32
        would round."""
        q = cfg.quant
        if fused_prefill is not None:
            q = dataclasses.replace(q, fused_prefill=bool(fused_prefill))
        if fused_decode is not None:
            q = dataclasses.replace(q, fused_decode=bool(fused_decode))
        cfg = dataclasses.replace(cfg, quant=q)
        self.device = resolve_device(device)
        if mesh is not None and not isinstance(mesh, sharding.Mesh):
            raise TypeError(f"mesh must be a repro_torch.parallel.sharding."
                            f"Mesh, got {type(mesh).__name__}")
        shard_devices = (self._shard_devices(mesh)
                         if mesh is not None and paged else None)
        if self.device.type == "cuda":
            set_float32_parity()
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.S = max_seq
        self.greedy = greedy
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.base_seed = int(base_seed)
        self.prefill_chunks_per_step = int(prefill_chunks_per_step)
        # what the family's cache holds when offered pages: KV pages (an
        # SSM cache has none, and is served unpaged whatever `paged` says),
        # and rows with a batch axis beside the KV (recurrent conv / SSM
        # state)
        offered = api.cache_specs(cfg, batch_slots, max_seq,
                                  PagedLayout.for_slots(batch_slots, max_seq,
                                                        max_seq))
        self.paged = bool(paged) and "block_table" in offered
        self._recurrent = any(name not in _META and "batch" in s.logical_axes
                              for name, s in offered.items())
        # SSM recurrent state is O(1) and has no pages: nothing to shard
        self.mesh = mesh if shard_devices and self.paged else None
        self._page_shard = None
        if self.mesh is not None:
            self._page_shard = PageShard(shard_devices)
            if _canonical(self._page_shard.home) != _canonical(self.device):
                raise ValueError(
                    f"the engine's device {self.device} must be the mesh's "
                    f"first device {self._page_shard.home} (the home device "
                    f"of the weights and the dense work)")
        self.n_shards = (self._page_shard.n_shards if self._page_shard
                         else 1)
        if speculate_k:
            if speculate_k < 2:
                raise ValueError("speculate_k must be >= 2 (k=1 is plain "
                                 "decode); pass 0 to disable speculation")
            if not self.paged:
                raise ValueError("speculative decoding requires the paged "
                                 "KV cache (draft and verify must address "
                                 "the same posit-coded pages)")
            if self._recurrent:
                raise ValueError(
                    "speculative decoding is limited to pure-attention "
                    "paged families: recurrent (conv/SSM) state cannot be "
                    "rolled back when a draft token is rejected")
            if self.n_shards > 1:
                raise ValueError("speculative decoding is not implemented "
                                 "for sharded page pools yet")
            if not hasattr(api._mod(cfg), "decode_verify"):
                raise NotImplementedError(
                    f"family {cfg.family!r} has no k-token verify step")
        self.prefill_buckets = self._valid_buckets(prefill_buckets)
        self.layout = None
        if self.paged:
            ps = self._resolve_page_size(page_size, max_seq)
            self.layout = PagedLayout.for_slots(batch_slots, max_seq, ps,
                                                n_pages,
                                                n_shards=self.n_shards)
        self.cache = api.init_cache(cfg, batch_slots, max_seq, self.layout,
                                    device=self.device,
                                    shard=self._page_shard)
        # batch-dim index per cache leaf (page pools have none)
        specs = api.cache_specs(cfg, batch_slots, max_seq, self.layout)
        self._state_bdim = {
            name: (s.logical_axes.index("batch")
                   if "batch" in s.logical_axes else None)
            for name, s in specs.items()}
        self.allocator = (PageAllocator(self.layout.n_pages,
                                        self.layout.n_shards)
                          if self.paged else None)
        self.max_pages_per_slot = (self.cache["block_table"].shape[1]
                                   if self.paged else 0)
        self.prefix_sharing = self.paged and bool(
            q.prefix_sharing if prefix_sharing is None else prefix_sharing)
        if batched_prefill is None:
            # routed-MoE capacity is computed over the whole [B, C] batch:
            # unless the capacity factor is drop-proof (capacity >= tokens
            # even if routing concentrates), padding rows of a batched
            # chunk could displace active tokens and make outputs depend
            # on batch composition, so such configs prefill slot by slot.
            # An explicit batched_prefill=True overrides.
            droppy_moe = (cfg.n_experts > 0 and
                          cfg.capacity_factor * cfg.top_k < cfg.n_experts)
            self.batched_prefill = bool(q.batched_prefill) and not droppy_moe
        else:
            self.batched_prefill = bool(batched_prefill)
        # bit_exact has no fused head: it decodes with decode_step, the
        # logits head and the host-side sampler; so does the dense cache
        self.fused_decode = (self.paged and bool(q.fused_decode)
                             and q.execution != "bit_exact")
        # None: the default per-(seed, draw) generators (`_default_noise`);
        # a bound method here would make the engine a reference cycle,
        # which keeps a dropped engine's graph pool alive until a collection
        self.noise_fn = noise_fn
        # the decode step's static buffers and graphs (`_step_graphs`)
        self._steps = None

        # host-owned scheduler state (device copies are refreshed per call)
        self.lengths = np.zeros(batch_slots, np.int32)
        self.block_tables = np.zeros(
            (batch_slots, max(self.max_pages_per_slot, 1)), np.int32)
        self.slot_phase = np.full(batch_slots, _FREE, np.int8)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pages: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_reserve: List[Optional[int]] = [None] * batch_slots
        self.slot_cursor = np.zeros(batch_slots, np.int64)  # prompt progress
        self.slot_remaining = np.zeros(batch_slots, np.int64)
        self.next_token = np.zeros(batch_slots, np.int32)
        self._slot_seed = [0] * batch_slots
        self._slot_sampled = np.zeros(batch_slots, np.int64)
        self._slot_registered = np.zeros(batch_slots, np.int64)
        self.queue: List[Request] = []
        self.done: List[Request] = []

        # prefix index: digest(prompt token prefix) -> (page, the slot's
        # recurrent states after that prefix or None); _page_keys /
        # _frozen support eviction and copy-on-write decisions; _held are
        # pages a retiring request left behind because a queued request's
        # prefix still matches them (the engine owns their last reference
        # until that request admits or leaves the queue)
        self.prefix_index: Dict[bytes, tuple] = {}
        self._page_keys: Dict[int, set] = {}
        self._frozen: Dict[int, int] = {}
        self._held: set = set()
        self.stats = {"pages_shared": 0, "shared_admissions": 0,
                      "cow_forks": 0, "prefill_batch_sizes": {},
                      "prefill_chunks": 0, "prefill_device_programs": 0,
                      "decode_steps": 0, "decode_device_programs": 0,
                      "preemptions": 0, "spec_rounds": 0,
                      "spec_draft_tokens": 0, "spec_accepted_tokens": 0,
                      "spec_committed_tokens": 0}

        # speculative decoding: the draft policy proposes, the serve policy
        # verifies over the same pages
        self.speculate_k = int(speculate_k)
        self.draft_quant = None
        if self.speculate_k:
            dq = draft_quant if draft_quant is not None else \
                cfg.quant.with_draft()
            if (dq.kv_cache != cfg.quant.kv_cache
                    or dq.kv_page_size != cfg.quant.kv_page_size):
                raise ValueError(
                    "draft policy must keep the serve policy's kv_cache "
                    "format and kv_page_size — draft and target decode "
                    "the same posit-coded pages, which is what makes "
                    "speculative acceptance exact (QuantPolicy.with_draft "
                    "preserves both)")
            self.draft_quant = dq
            self._draft_cfg = dataclasses.replace(cfg, quant=dq)
            self.draft_params = params if draft_params is None else \
                draft_params

    @staticmethod
    def _shard_devices(mesh):
        """The devices of the mesh axis kv_pages shards over (None when it
        shards over none of size > 1); raises for a mesh whose other axes
        of size > 1 the rules do not map kv_pages onto, or that maps it
        onto two such axes."""
        axes = [a for a in sharding.mesh_axes_for("kv_pages", mesh)
                if mesh.shape[a] > 1]
        extra = [a for a in mesh.axis_names
                 if mesh.shape[a] > 1 and a not in axes]
        if extra:
            raise ValueError(
                f"serving mesh has >1-sized axes {extra} that kv_pages "
                f"does not shard over; the engine only shards the page "
                f"pool — use a mesh whose non-trivial axis is the "
                f"kv_pages one (default: 'model')")
        if len(axes) > 1:
            raise ValueError(
                f"kv_pages maps onto multiple >1 mesh axes {axes}; "
                f"shard the page pool over a single axis")
        # every other axis has size 1, so the row-major device list runs
        # along the kv_pages axis
        return tuple(mesh.devices) if axes else None

    def _valid_buckets(self, buckets):
        """Descending chunk sizes; 1 is always included (exact prompt
        decomposition), and for recurrent families (an SSD in their
        layers) sizes the SSD cannot chunk are dropped (a chunk C needs C %
        min(ssm_chunk, C) == 0)."""
        out = {int(b) for b in buckets if b >= 1} | {1}
        if self._recurrent:
            q = self.cfg.ssm_chunk
            out = {b for b in out if b <= q or b % q == 0}
        return tuple(sorted(out, reverse=True))

    def _resolve_page_size(self, requested: Optional[int],
                           max_seq: int) -> int:
        """Page size the paged layout is built with.  With fused prefill on,
        a page size that neither divides paged.FLASH_CHUNK nor keeps every
        prefill span inside one flash chunk would put every chunk on the
        decomposed path: an explicit such size raises, and the policy
        default (page_size=None) is lowered to the largest FLASH_CHUNK
        divisor not above cfg.quant.kv_page_size."""
        q = self.cfg.quant
        ps = int(q.kv_page_size if requested is None else requested)
        if ps < 1:
            raise ValueError(f"page_size must be >= 1, got {ps}")
        if not q.fused_prefill:
            return ps
        chunk = paged_mod.FLASH_CHUNK
        per = -(-max_seq // ps)
        if fused_prefill_span_ok(per, ps, max(self.prefill_buckets)):
            return ps
        if requested is not None:
            raise ValueError(
                f"page_size={ps} cannot tile FLASH_CHUNK={chunk} and the "
                f"slot span ({per} pages x {ps} + a "
                f"{max(self.prefill_buckets)}-token chunk) exceeds one "
                f"flash chunk: every prefill chunk would fall back to the "
                f"3-program decomposed path.  Pass a divisor of {chunk} (or "
                f"page_size=None to auto-pick one), or construct with "
                f"fused_prefill=False to accept the decomposed path")
        return max(d for d in range(1, ps + 1) if chunk % d == 0)

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, cfg: ModelConfig, directory: str,
                        batch_slots: int, max_seq: int,
                        step: Optional[int] = None, device="cuda",
                        **kw) -> "ServingEngine":
        """Restore params (float or posit-packed) written by the
        reference's CheckpointManager and build an engine on `device`.
        Packed checkpoints come back as int8/int16 code tensors."""
        from repro_torch import checkpoint
        from repro_torch.core.formats import PositFormat
        from repro_torch.models import packing

        device = resolve_device(device)
        if step is None:
            step = checkpoint.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
        extra = checkpoint.read_manifest(directory, step).get("extra") or {}
        like = api.param_specs(cfg)
        if extra.get("packed_weights"):
            fmt = PositFormat(extra["weights_n"], extra["weights_es"])
            if cfg.quant.weights != fmt:
                raise ValueError(
                    f"checkpoint packed as {fmt} but cfg.quant.weights is "
                    f"{cfg.quant.weights}; align the serving QuantPolicy "
                    f"with the pack format")
            like = packing.packed_param_specs(cfg, fmt)
        tree = checkpoint.restore(directory, step, like)
        params = packing.params_from_numpy(tree, cfg, device)
        return cls(cfg, params, batch_slots, max_seq, device=device, **kw)

    # ------------------------------------------------------------------
    # storage accounting
    # ------------------------------------------------------------------

    def weight_bytes(self) -> int:
        """Resident weight-storage bytes (codes count at container width)."""
        from repro_torch.models.packing import weight_bytes
        return weight_bytes(self.params)

    def kv_cache_summary(self) -> dict:
        """Decode-state storage split: `kv_bytes` is the K/V payload (pages
        or dense rows, at code width when posit-coded) plus any conv / SSM
        state, `metadata_bytes` the positions + block tables; a paged engine
        adds the bytes of the pages in use and at the peak."""
        kv = meta = 0
        for name, leaf in self.cache.items():
            if name in ("length", "block_table"):
                meta += _nbytes(leaf)
            else:
                kv += _nbytes(leaf)
        out = {"kv_bytes": kv, "metadata_bytes": meta,
               "total_bytes": kv + meta}
        if self.paged:
            page_b = (_nbytes(self.cache["k"]) + _nbytes(self.cache["v"])) \
                // self.layout.n_pages
            out["kv_bytes_in_use"] = self.pages_in_use * page_b
            out["kv_bytes_peak"] = self.allocator.peak_in_use * page_b
            if self.n_shards > 1:
                out["pages_in_use_by_shard"] = \
                    self.allocator.pages_in_use_by_shard
        return out

    def kv_cache_bytes(self) -> int:
        """Total allocated decode-state bytes (payload + metadata)."""
        return self.kv_cache_summary()["total_bytes"]

    @property
    def slot_free(self) -> List[bool]:
        """Per-slot availability (a view over the phase array)."""
        return [bool(p == _FREE) for p in self.slot_phase]

    @property
    def pages_in_use(self) -> int:
        return self.allocator.pages_in_use if self.allocator else 0

    @property
    def pages_free(self) -> int:
        return self.allocator.pages_free if self.allocator else 0

    @property
    def pages_promised(self) -> int:
        """Diagnostic: worst-case pages the queued requests will draw, each
        counted unshared.  Submission is not gated on it: admission accounts
        each admitted request's full private demand (its fork reserve
        included), and oversubscription waits for reclaimed pages."""
        if not self.paged:
            return 0
        return sum(self._pages_needed(r) for r in self.queue)

    @property
    def pages_shared_mapped(self) -> int:
        """Extra block-table references onto live pages beyond the first
        (how many page loads prefix sharing is deduplicating now)."""
        if not self.paged:
            return 0
        return sum(rc - 1 for rc in self.allocator._refs.values())

    def execution_summary(self) -> dict:
        """Which datapath this engine serves on, plus its storage terms."""
        q = self.cfg.quant
        kv = self.kv_cache_summary()
        return {
            "device": str(self.device),
            "execution": q.execution,
            "weights": str(q.weights) if q.weights else None,
            "activations": str(q.activations) if q.activations else None,
            "kv_cache": str(q.kv_cache) if q.kv_cache else None,
            "activation_coded": q.execution == "fused"
                                and q.activations is not None,
            "weight_bytes": self.weight_bytes(),
            "kv_cache_bytes": kv["total_bytes"],
            "kv_bytes": kv["kv_bytes"],
            "metadata_bytes": kv["metadata_bytes"],
            "paged": self.paged,
            "page_size": self.layout.page_size if self.paged else None,
            "kv_shards": self.n_shards,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.pages_free,
            "pages_in_use_by_shard": (self.allocator.pages_in_use_by_shard
                                      if self.paged else None),
            "prefix_sharing": self.prefix_sharing,
            "batched_prefill": self.batched_prefill,
            "fused_prefill": self.paged and bool(q.fused_prefill),
            "fused_decode": self.fused_decode,
            "prefill_chunks": self.stats["prefill_chunks"],
            "prefill_device_programs": self.stats["prefill_device_programs"],
            "decode_steps": self.stats["decode_steps"],
            "decode_device_programs": self.stats["decode_device_programs"],
            **self._graph_summary(),
            "pages_shared_mapped": self.pages_shared_mapped,
            "cow_forks": self.stats["cow_forks"],
            "preemptions": self.stats["preemptions"],
            "speculative": bool(self.speculate_k),
            "speculate_k": self.speculate_k or None,
            "speculation_rounds": self.stats["spec_rounds"],
            "speculation_committed_tokens":
                self.stats["spec_committed_tokens"],
            "speculation_accept_rate": (
                self.stats["spec_accepted_tokens"]
                / self.stats["spec_draft_tokens"]
                if self.stats["spec_draft_tokens"] else None),
        }

    def _graph_summary(self) -> dict:
        """Which steps run as device programs of their own: on a card the
        single pool's decode step replays its graphs (`decode_graphed`;
        `step_graphs`: each graph's captured flag, replays and eager calls
        so far, `decode_graph_replays` their sum); the steps in
        `eager_steps` dispatch op by op."""
        g = self._steps or {}
        graphs = {name: {"captured": sg.captured, "replays": sg.replays,
                         "eager_calls": sg.eager_calls}
                  for name in ("decode", "sample")
                  if (sg := g.get(name)) is not None}
        eager = ["prefill chunk groups"]
        if self.speculate_k:
            eager.append("speculative rounds")
        if self.prefix_sharing:
            eager.append("copy-on-write forks")
        if self._page_shard is not None:
            eager.append("decode steps (sharded pool)")
        return {"decode_graphed": (self.device.type == "cuda"
                                   and self._page_shard is None),
                "step_graphs": graphs,
                "decode_graph_replays": sum(v["replays"]
                                            for v in graphs.values()),
                "eager_steps": eager}

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def submit(self, req: Request):
        n = len(req.prompt)
        if n < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be >= 1")
        # every written position must fit the slot's budget: positions
        # 0 .. n + max_new_tokens - 2 < max_seq
        if n + req.max_new_tokens - 1 > self.S:
            raise ValueError(
                f"request {req.rid}: prompt ({n}) + max_new_tokens "
                f"({req.max_new_tokens}) needs {n + req.max_new_tokens - 1} "
                f"positions but max_seq is {self.S}")
        if self.paged and self._pages_needed(req) > self.allocator.capacity:
            budgets = ("" if self.allocator.n_shards == 1 else
                       f" ({self.allocator.n_shards} per-device budgets of "
                       f"{self.allocator.pages_per_shard - 1} pages)")
            raise ValueError(
                f"request {req.rid} needs {self._pages_needed(req)} pages "
                f"but the pool only has {self.allocator.capacity}{budgets}; "
                f"raise n_pages or shorten prompt/max_new_tokens")
        req.out_tokens = []
        self.queue.append(req)

    def preempt(self, slot: int) -> Optional[Request]:
        """Evict a mid-flight slot and requeue its request at the head of
        the queue; returns the requeued request (None for a free slot).

        The request is requeued before the slot releases, so `_release`
        sees its own registered prompt pages as wanted by the queue and
        turns them into engine holds instead of recycling them: on
        re-admission the prefix lookup maps those pages back and only the
        unshared tail prefills again.  Emitted tokens are discarded and
        replayed: the noise derives from (seed, draw index), so the rerun
        emits the identical stream.  Front ends that streamed tokens out
        already dedup by count."""
        if self.slot_phase[slot] == _FREE:
            return None
        req = self.slot_req[slot]
        req.out_tokens = []
        self.queue.insert(0, req)
        self._release(slot)
        self.stats["preemptions"] += 1
        return req

    def cancel(self, rid: int) -> bool:
        """Drop a queued (not yet admitted) request; holds only its prefix
        kept alive are released at once."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                self.queue.pop(i)
                if self.paged:
                    self._prune_holds()
                return True
        return False

    def _pages_needed(self, req: Request) -> int:
        last_pos = len(req.prompt) + req.max_new_tokens - 2  # final write
        return min(last_pos // self.layout.page_size + 1,
                   self.max_pages_per_slot)

    def _chunk_sizes(self, n: int):
        """Exact greedy decomposition of n into bucket sizes (1 included).
        It has the suffix property -- the tail after any chunk boundary is
        the greedy decomposition of the remainder -- which makes prefix-
        shared prefill token-identical to unshared prefill when sharing
        stops at a boundary."""
        out = []
        for b in self.prefill_buckets:
            while n >= b:
                out.append(b)
                n -= b
        return out

    def _next_chunk(self, slot: int) -> int:
        remaining = len(self.slot_req[slot].prompt) \
            - int(self.slot_cursor[slot])
        return self._chunk_sizes(remaining)[0]

    def _meta(self, mask=None, lengths=None):
        """The cache with host-owned lengths / block tables pushed to the
        device (prefill and speculative rounds; the decode step stages its
        own, `_decode`); `mask` zeroes rows of slots that must not touch
        real state (free / mid-prefill slots in decode, non-group slots in
        prefill).
        `lengths` overrides the host lengths (the speculative draft loop
        advances a transient position without committing it)."""
        lengths = (self.lengths if lengths is None else lengths).copy()
        if mask is not None:
            lengths[~mask] = 0
        cache = {name: leaf for name, leaf in self.cache.items()
                 if name not in ("length", "block_table")}
        cache["length"] = torch.from_numpy(lengths).to(self.device)
        if self.paged:
            bts = self.block_tables.copy()
            if mask is not None:
                bts[~mask] = 0
            cache["block_table"] = torch.from_numpy(bts).to(self.device)
        return cache

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    def _default_noise(self, seed: int, draw: int, vocab: int):
        g = torch.Generator(device=self.device)
        g.manual_seed((((self.base_seed * 1_000_003) + seed) * 1_000_033
                       + draw) & 0x7FFF_FFFF_FFFF_FFFF)
        return api.sample_noise(g, 1, vocab, self.device)[0]

    def _noise_rows(self, draws, out=None):
        """[len(draws), V] gumbel rows for (slot, draw index) pairs, zeros
        for None entries (discarded draws); None when greedy.  With `out`
        (a [len(draws), V] f32 tensor) the rows are written into it.
        Advances no counter."""
        if self.greedy:
            return None
        V = self.cfg.vocab_size
        rows = []
        for d in draws:
            if d is None:
                rows.append(torch.zeros(V, dtype=torch.float32,
                                        device=self.device))
                continue
            row = (self.noise_fn or self._default_noise)(
                self._slot_seed[d[0]], int(d[1]), V)
            if not isinstance(row, torch.Tensor):
                row = torch.from_numpy(np.array(row, np.float32))
            rows.append(row.to(self.device, torch.float32).reshape(V))
        return torch.stack(rows, out=out)

    def _sample_noise(self, slots, live=None, out=None):
        """[len(slots), V] gumbel rows (None when greedy), advancing each
        live slot's draw counter; rows of non-live slots are zeros and
        their draws are discarded.  `out` as `_noise_rows`'."""
        if self.greedy:
            return None
        draws = [(s, self._slot_sampled[s]) if live is None or live[s]
                 else None for s in slots]
        noise = self._noise_rows(draws, out=out)
        for d in draws:
            if d is not None:
                self._slot_sampled[d[0]] += 1
        return noise

    def _sample(self, logits_rows, slots, live=None):
        """Sample one token per row of logits_rows [n, V] for `slots`."""
        noise = self._sample_noise(slots, live=live)
        toks = sample_logits(logits_rows.to(torch.float32), noise,
                             self.temperature, greedy=self.greedy,
                             top_k=self.top_k)
        return toks.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------
    # prefix index: registration, lookup, eviction
    # ------------------------------------------------------------------

    def _prompt_digests(self, req: Request):
        """Per-request digest cache: ([digest per full-page boundary],
        full-prompt digest), each prefix hashed once per request."""
        ps = self.layout.page_size
        cached = getattr(req, "_prefix_digests", None)
        if cached is not None and cached[0] == ps:
            return cached[1], cached[2]
        prompt = np.ascontiguousarray(req.prompt, np.int32)
        h = hashlib.blake2b(digest_size=16)
        full = []
        for i in range(len(prompt) // ps):
            h.update(prompt[i * ps:(i + 1) * ps].tobytes())
            full.append(h.copy().digest())
        whole = hashlib.blake2b(prompt.tobytes(), digest_size=16).digest()
        req._prefix_digests = (ps, full, whole)
        return full, whole

    def _put_index(self, key: bytes, page: int, frozen: int, state=None):
        """Register a page (and the slot's recurrent states after the
        prefix, or None) for the token prefix hashed by `key`; `frozen` is
        the first position holders may still write (everything below is
        trusted by sharers and must copy-on-write)."""
        if key in self.prefix_index:
            return  # first registration wins; duplicates are identical KV
        self.prefix_index[key] = (page, state)
        self._page_keys.setdefault(page, set()).add(key)
        self._frozen[page] = max(self._frozen.get(page, 0), frozen)

    def _evict(self, recycled: List[int]):
        """Drop index entries whose page went back to the free list."""
        for p in recycled:
            for key in self._page_keys.pop(p, ()):
                self.prefix_index.pop(key, None)
            self._frozen.pop(p, None)

    def _snapshot_state(self, slot: int):
        """A copy of the slot's recurrent (conv / SSM) rows on the device,
        or None for pure-attention families."""
        out = {}
        for name, leaf in self.cache.items():
            bdim = self._state_bdim.get(name)
            if name in _META or bdim is None:
                continue
            out[name] = leaf.select(bdim, slot).clone()
        return out or None

    def _restore_state(self, slot: int, state: dict):
        for name, rows in state.items():
            self.cache[name].select(self._state_bdim[name], slot).copy_(rows)

    def _reset_slot_state(self, slot: int):
        """Zero the slot's rows of every leaf with a batch dim but the
        metadata (conv / SSM states and dense KV rows are seeded by
        prefill: no stale value of an earlier request may leak)."""
        for name, leaf in self.cache.items():
            bdim = self._state_bdim.get(name)
            if name in ("length", "block_table") or bdim is None:
                continue
            leaf.select(bdim, slot).zero_()

    def _register_pages(self, slot: int):
        """Publish the slot's freshly prompt-filled pages to the prefix
        index (after every prefill chunk, while cursor <= prompt length, so
        every registered page holds prompt KV only).  A recurrent family's
        states ride along with the page a chunk ends on exactly; pages that
        end inside a chunk become links without states."""
        if not self.prefix_sharing:
            return
        req = self.slot_req[slot]
        ps = self.layout.page_size
        cur = int(self.slot_cursor[slot])
        full = cur // ps
        digests, full_digest = self._prompt_digests(req)
        snap = (self._snapshot_state(slot)
                if self._recurrent and cur % ps == 0 and full else None)
        for i in range(int(self._slot_registered[slot]), full):
            self._put_index(digests[i], int(self.block_tables[slot, i]),
                            (i + 1) * ps,
                            snap if (i + 1) * ps == cur else None)
        self._slot_registered[slot] = full
        if cur == len(req.prompt) and cur % ps and not self._recurrent:
            # the partially-filled tail page: exact-duplicate prompts map
            # it too and copy-on-write their divergence
            self._put_index(full_digest,
                            int(self.block_tables[slot, full]), cur)

    def _tail_shareable(self, n: int) -> bool:
        """May a request of prompt length n map an exact-duplicate donor's
        partially-filled tail page?  Position n-1 must be a boundary of its
        own chunk decomposition (the condition _lookup_prefix enforces),
        and recurrent families need a state snapshot, which partial pages
        never carry."""
        ps = self.layout.page_size
        return (not self._recurrent and n % ps != 0 and (n - 1) in {
            int(t) for t in np.cumsum(self._chunk_sizes(n))})

    def _index_chain(self, req: Request) -> List[tuple]:
        """Index entries (page, state) for the request's full-page
        prefixes, in order up to the first miss; at most (n-1) //
        page_size of them, so at least one prompt token is left to
        prefill."""
        digests, _ = self._prompt_digests(req)
        chain = []
        for key in digests[:(len(req.prompt) - 1) // self.layout.page_size]:
            entry = self.prefix_index.get(key)
            if entry is None:
                break
            chain.append(entry)
        return chain

    def _chain_pages(self, req: Request) -> set:
        """Pages the index currently offers for this request's prefix
        (full-page chain plus the exact-duplicate tail page)."""
        n = len(req.prompt)
        chain = self._index_chain(req)
        out = {page for page, _ in chain}
        if self._tail_shareable(n) and len(chain) == n // self.layout.page_size:
            entry = self.prefix_index.get(self._prompt_digests(req)[1])
            if entry is not None:
                out.add(entry[0])
        return out

    def _wanted_by_queue(self) -> set:
        """Index pages some queued request would map."""
        wanted = set()
        for req in self.queue:
            wanted |= self._chain_pages(req)
        return wanted

    def _prune_holds(self):
        """Free held pages no queued request's prefix matches anymore (once
        the queue drains this releases every hold)."""
        if not self._held:
            return
        wanted = self._wanted_by_queue()
        for p in list(self._held):
            if p not in wanted:
                self._held.discard(p)
                self._evict(self.allocator.free([p]))

    def _drop_all_holds(self):
        """Release every held page (when admission cannot proceed and
        nothing in flight will ever reclaim)."""
        for p in list(self._held):
            self._held.discard(p)
            self._evict(self.allocator.free([p]))

    def _lookup_prefix(self, req: Request):
        """Longest shareable prompt prefix for `req` from the index:
        (shared pages, n_shared_tokens, state, partial).  Sharing stops at
        a boundary of the request's own chunk decomposition, leaves at
        least one prompt token to prefill (the engine samples from its
        logits) and, for recurrent families, needs a state snapshot at the
        boundary."""
        if not self.prefix_sharing:
            return [], 0, None, False
        n = len(req.prompt)
        ps = self.layout.page_size
        bounds = set(int(t) for t in np.cumsum(self._chunk_sizes(n)))
        chain = self._index_chain(req)
        best = ([], 0, None, False)
        for i, (_, state) in enumerate(chain):
            t = (i + 1) * ps
            if t in bounds and (state is not None or not self._recurrent):
                best = ([p for p, _ in chain[:i + 1]], t, state, False)
        if self._tail_shareable(n) and len(chain) == n // ps:
            entry = self.prefix_index.get(self._prompt_digests(req)[1])
            if entry is not None:
                best = ([p for p, _ in chain] + [entry[0]], n - 1, None,
                        True)
        return best

    # ------------------------------------------------------------------
    # copy-on-write
    # ------------------------------------------------------------------

    def _ensure_writable(self, slot: int, lo: int, hi: int):
        """Fork any shared page the slot is about to write (positions
        [lo, hi)) below its frozen prefix.  Writes at or after the frozen
        position (a donor appending past every sharer's trusted range) stay
        in place: sharers never read there."""
        ps = self.layout.page_size
        for idx in range(lo // ps, (hi - 1) // ps + 1):
            if idx >= self.max_pages_per_slot:
                break
            p = int(self.block_tables[slot, idx])
            if p == 0 or self.allocator.refcount(p) <= 1:
                continue
            if max(lo, idx * ps) >= self._frozen.get(p, 1 << 30):
                continue
            self._fork_slot_page(slot, idx, p)

    def _fork_slot_page(self, slot: int, idx: int, src: int):
        dst = self.slot_reserve[slot]
        self.slot_reserve[slot] = None
        if dst is None:
            # a fork stays on one shard when the source's shard has a page
            got = self.allocator.alloc(
                1, prefer_shard=self.allocator.shard_of(src))
            if got is None:
                raise RuntimeError(
                    f"page pool exhausted during copy-on-write fork for "
                    f"slot {slot}: admission must reserve fork pages up "
                    f"front")
            dst = got[0]
            self.slot_pages[slot].append(dst)
        fork_page(self.cache["k"], dst, src, shard=self._page_shard)
        fork_page(self.cache["v"], dst, src, shard=self._page_shard)
        self.block_tables[slot, idx] = dst
        self.slot_pages[slot].remove(src)
        self._evict(self.allocator.free([src]))
        self.stats["cow_forks"] += 1

    # ------------------------------------------------------------------
    # admission / retirement
    # ------------------------------------------------------------------

    def _next_admissible(self) -> Optional[int]:
        """Queue index of the first request to admit.  A request that would
        share a longer prefix with a still-prefilling slot than the index
        offers now is deferred (it admits after the donor registers its
        pages); later distinct requests may jump ahead."""
        for qi, req in enumerate(self.queue):
            if self.prefix_sharing and self._should_defer(req):
                continue
            return qi
        return None

    def _should_defer(self, req: Request) -> bool:
        n = len(req.prompt)
        ps = self.layout.page_size
        max_full = (n - 1) // ps
        if max_full == 0 and (self._recurrent or n % ps == 0):
            return False
        digests, full_digest = self._prompt_digests(req)
        # tokens the index can hand over now
        have = len(self._index_chain(req)) * ps
        tail_ok = self._tail_shareable(n)
        if (tail_ok and have == (n // ps) * ps
                and full_digest in self.prefix_index):
            have = n - 1
        # tokens a still-prefilling donor will register once it finishes
        for s in range(self.B):
            if self.slot_phase[s] != _PREFILL:
                continue
            o_digests, o_full = self._prompt_digests(self.slot_req[s])
            k = 0
            for i in range(min(max_full, len(o_digests))):
                if digests[i] == o_digests[i]:
                    k = (i + 1) * ps
                else:
                    break
            if tail_ok and k == (n // ps) * ps and o_full == full_digest:
                k = n - 1  # exact duplicate: the tail page will share too
            if k > have:
                return True
        return False

    def _admit(self) -> bool:
        """Move queued requests into free slots.  Admission is atomic per
        request and accounts its full private demand up front: shared
        prefix pages are mapped by reference and a copy-on-write fork page
        is reserved, so an admitted request never allocates mid-flight.
        Returns True if any request was admitted."""
        admitted = False
        for slot in range(self.B):
            if self.slot_phase[slot] != _FREE or not self.queue:
                continue
            qi = self._next_admissible()
            if qi is None:
                break
            req = self.queue[qi]
            n_shared, state = 0, None
            if self.paged:
                got = self._admit_pages(slot, req)
                if got is None:
                    return admitted  # wait for reclamation
                n_shared, state = got
            self._reset_slot_state(slot)
            if state is not None:
                self._restore_state(slot, state)
            self.queue.pop(qi)
            if self.paged:
                self._prune_holds()
            self.slot_req[slot] = req
            self.slot_phase[slot] = _PREFILL
            self.slot_cursor[slot] = n_shared
            self.lengths[slot] = n_shared
            self._slot_seed[slot] = req.seed if req.seed is not None else req.rid
            self._slot_sampled[slot] = 0
            admitted = True
        return admitted

    def _admit_pages(self, slot: int, req: Request) -> Optional[tuple]:
        """Map the request's shared prefix pages and allocate the rest of
        its private demand (and its fork reserve) into the slot's block
        table.  Returns (the shared prefix's length in tokens, the
        recurrent states after it or None), or None when the pool cannot
        serve the request yet."""
        shared, n_shared, state, partial = self._lookup_prefix(req)
        pages = self._alloc_private(req, shared, partial)
        if pages is None and self._held \
                and not (self.slot_phase != _FREE).any():
            # nothing in flight will ever reclaim: held prefix pages must
            # yield so the head of the queue can run
            self._drop_all_holds()
            shared, n_shared, state, partial = self._lookup_prefix(req)
            pages = self._alloc_private(req, shared, partial)
        if pages is None:
            return None
        self.allocator.share(shared)
        reserve = pages.pop() if partial else None
        row = shared + pages
        self.slot_pages[slot] = list(row) + (
            [reserve] if reserve is not None else [])
        self.slot_reserve[slot] = reserve
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(row)] = row
        self._slot_registered[slot] = n_shared // self.layout.page_size
        if shared:
            self.stats["pages_shared"] += len(shared)
            self.stats["shared_admissions"] += 1
        return n_shared, state

    def _alloc_private(self, req: Request, shared: List[int], partial: bool):
        """Fresh pages for the request's demand beyond its shared prefix,
        on the prefix donor's shard when it fits (the whole slot then stays
        on one shard)."""
        k_full = len(shared) - (1 if partial else 0)
        prefer = self.allocator.shard_of(shared[0]) if shared else None
        return self.allocator.alloc(self._pages_needed(req) - k_full,
                                    prefer_shard=prefer)

    def _release(self, slot: int):
        if self.paged:
            self._release_pages(slot)
        self.lengths[slot] = 0
        self.slot_phase[slot] = _FREE
        self.slot_req[slot] = None

    def _release_pages(self, slot: int):
        pages = self.slot_pages[slot]
        if self.prefix_sharing and self.queue:
            # keep prefix pages a queued request still matches alive: the
            # slot's reference becomes an engine hold, released by
            # _prune_holds once nothing in the queue wants the page
            wanted = self._wanted_by_queue()
            keep = {p for p in pages
                    if p in wanted and p not in self._held
                    and self.allocator.refcount(p) == 1}
            self._held.update(keep)
            pages = [p for p in pages if p not in keep]
        self._evict(self.allocator.free(pages))
        self.slot_pages[slot] = []
        self.slot_reserve[slot] = None
        self.block_tables[slot] = 0

    def _retire(self, slot: int):
        self.done.append(self.slot_req[slot])
        self._release(slot)

    # ------------------------------------------------------------------
    # prefill progression
    # ------------------------------------------------------------------

    def _finish_prompt(self, slot: int, tok: int):
        """Prompt complete: record the sampled first token, retire at
        prefill (eos / single-token budget) or move to decode."""
        req = self.slot_req[slot]
        req.out_tokens.append(tok)
        if req.max_new_tokens <= 1 or (
                req.eos_id is not None and tok == req.eos_id):
            self._retire(slot)  # finished at prefill: reclaim pages now
        else:
            self.next_token[slot] = tok
            self.slot_remaining[slot] = req.max_new_tokens - 1
            self.slot_phase[slot] = _DECODE

    def _prefill_programs_per_chunk(self, size: int) -> int:
        """Device programs the attention stage of one prefill chunk issues
        per layer: 1 when the fused kernel applies (attention + KV encode +
        page insert in one launch), else 3 (flash attention, KV encode,
        page insert)."""
        fused = self.paged and fused_prefill_applies(
            self.cfg.quant, self.max_pages_per_slot, self.layout.page_size,
            size)
        return 1 if fused else 3

    def _count_chunk(self, n_slots: int, size: int):
        sizes = self.stats["prefill_batch_sizes"]
        sizes[n_slots] = sizes.get(n_slots, 0) + 1
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_device_programs"] += \
            self._prefill_programs_per_chunk(size)

    def _advance_prefill(self, slot: int):
        """Run one prompt chunk for a prefilling slot (per-slot path)."""
        prompt = np.asarray(self.slot_req[slot].prompt, np.int32)
        lo = int(self.slot_cursor[slot])
        size = self._next_chunk(slot)
        if self.paged:
            self._ensure_writable(slot, lo, lo + size)
        tokens = torch.from_numpy(prompt[None, lo:lo + size]).to(self.device)
        logits, _ = api.prefill_chunk(self.params, tokens, self._meta(), slot,
                                      self.cfg, shard=self._page_shard)
        self._count_chunk(1, size)
        self.slot_cursor[slot] += size
        self.lengths[slot] += size
        self._register_pages(slot)
        if int(self.slot_cursor[slot]) >= len(prompt):
            tok = int(self._sample(logits[:, -1], [slot])[0])
            self._finish_prompt(slot, tok)

    def _run_chunk_group(self, slots: List[int], size: int):
        """Advance every slot in `slots` by one chunk of `size` tokens in a
        single [batch_slots, size] pass; other rows are masked."""
        tokens = np.zeros((self.B, size), np.int32)
        for s in slots:
            lo = int(self.slot_cursor[s])
            tokens[s] = np.asarray(self.slot_req[s].prompt,
                                   np.int32)[lo:lo + size]
            if self.paged:
                self._ensure_writable(s, lo, lo + size)
        active = np.zeros(self.B, bool)
        active[slots] = True
        logits, _ = api.prefill_chunk_batched(
            self.params, torch.from_numpy(tokens).to(self.device),
            self._meta(active), torch.from_numpy(active).to(self.device),
            self.cfg, shard=self._page_shard)
        self._count_chunk(len(slots), size)
        for s in slots:
            self.slot_cursor[s] += size
            self.lengths[s] += size
            self._register_pages(s)
        done = [s for s in slots if int(self.slot_cursor[s])
                >= len(self.slot_req[s].prompt)]
        if done:
            # sample over the fixed [B, V] batch; rows of unfinished slots
            # draw nothing and are discarded
            live = np.zeros(self.B, bool)
            live[done] = True
            toks = self._sample(logits, list(range(self.B)), live=live)
            for s in done:
                self._finish_prompt(s, int(toks[s]))

    def _fill_slots(self) -> bool:
        """Admission + prefill progression for one engine step.  The
        per-step chunk budget applies per request; a request retiring at
        prefill frees its slot for the next queued one within the step."""
        budget = self.prefill_chunks_per_step or None
        ran = False
        used: Dict[int, int] = {}  # chunks run per request this step
        while True:
            admitted = self._admit()
            todo = [s for s in range(self.B)
                    if self.slot_phase[s] == _PREFILL
                    and (budget is None
                         or used.get(id(self.slot_req[s]), 0) < budget)]
            if not todo:
                if not admitted:
                    break
                continue
            for s in todo:
                used[id(self.slot_req[s])] = used.get(id(self.slot_req[s]), 0) + 1
            if self.batched_prefill:
                groups: Dict[int, List[int]] = {}
                for s in todo:
                    groups.setdefault(self._next_chunk(s), []).append(s)
                for size in sorted(groups, reverse=True):
                    self._run_chunk_group(groups[size], size)
            else:
                for s in todo:
                    self._advance_prefill(s)
            ran = True
        return ran

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One engine iteration: admit/prefill, then one decode step for
        every decoding slot.  Returns False when the engine is idle."""
        self._fill_slots()
        decode_mask = self.slot_phase == _DECODE
        if not decode_mask.any():
            return bool((self.slot_phase == _PREFILL).any())
        if self.speculate_k:
            T = self._spec_span(decode_mask)
            if T >= 2:
                self._spec_round(decode_mask, T)
                return True
        if self.paged:
            for s in np.nonzero(decode_mask)[0]:
                pos = int(self.lengths[s])
                self._ensure_writable(int(s), pos, pos + 1)
        slots = [s for s in range(self.B) if decode_mask[s]]
        toks = self._decode(decode_mask)[slots]
        self.stats["decode_steps"] += 1
        self.stats["decode_device_programs"] += 1 if self.fused_decode else 2
        for tok, slot in zip(toks, slots):
            req = self.slot_req[slot]
            req.out_tokens.append(int(tok))
            self.next_token[slot] = tok
            self.lengths[slot] += 1
            self.slot_remaining[slot] -= 1
            if self.slot_remaining[slot] <= 0 or (
                    req.eos_id is not None and int(tok) == req.eos_id):
                self._retire(slot)
        return True

    def _step_graphs(self) -> dict:
        """The decode step's static buffers, their pinned host twins, the
        decode graph and (unfused) the sampler graph, made at the first
        decode step.  The buffers hold the step's tokens, lengths, block
        tables (paged), `active` mask (dense cache, recurrent state: the
        rows of free or mid-prefill slots stay unwritten, as the reference
        reverts them) and gumbel noise (sampled); temperature, top_k and
        greedy are the engine's constants, so a capture fixes them.  A
        sharded pool's step runs eagerly over the same buffers (no graph
        backend)."""
        if self._steps is None:
            dev, B = self.device, self.B
            bufs = {"tokens": torch.zeros(B, dtype=torch.int32, device=dev),
                    "length": torch.zeros(B, dtype=torch.int32, device=dev)}
            if self.paged:
                bufs["block_table"] = torch.zeros(
                    self.block_tables.shape, dtype=torch.int32, device=dev)
            if not self.paged or self._recurrent:
                bufs["active"] = torch.zeros(B, dtype=torch.bool, device=dev)
            if not self.greedy:
                bufs["noise"] = torch.zeros((B, self.cfg.vocab_size),
                                            dtype=torch.float32, device=dev)
            pin = dev.type == "cuda"
            backend = (step_graph._backend(dev) if self._page_shard is None
                       else None)
            self._steps = {
                "buffers": bufs,
                "host": {name: torch.empty(b.shape, dtype=b.dtype,
                                           pin_memory=pin)
                         for name, b in bufs.items() if name != "noise"},
                "decode": step_graph.StepGraph("decode", backend),
                "sample": (None if self.fused_decode else
                           step_graph.StepGraph("sample", backend)),
                "temperature": torch.tensor(max(self.temperature, 1e-6),
                                            dtype=torch.float32, device=dev)}
        return self._steps

    def _step_inputs(self):
        """[(name, body, static inputs)] of the decode step's programs: the
        decode body, and unfused the sampler over the decode's logits."""
        g = self._step_graphs()
        bufs = g["buffers"]
        noise = {"noise": bufs["noise"]} if "noise" in bufs else {}
        decode_in = {k: v for k, v in bufs.items() if k != "noise"}
        if self.fused_decode:
            return [("decode", self._decode_body, dict(decode_in, **noise))]
        logits = torch.zeros((self.B, self.cfg.vocab_size),
                             dtype=torch.float32, device=self.device)
        return [("decode", self._decode_body, decode_in),
                ("sample", self._sample_body, dict(logits=logits, **noise))]

    def _decode_body(self, tokens, length, block_table=None, active=None,
                     noise=None):
        """The decode step's device work, read from the static buffers: [B]
        int32 tokens from the fused head + sampler, or the [B, V] f32
        logits; the KV pages or rows and recurrent states written in
        place."""
        cache = {name: leaf for name, leaf in self.cache.items()
                 if name not in ("length", "block_table")}
        cache["length"] = length
        if block_table is not None:
            cache["block_table"] = block_table
        if self.fused_decode:
            return api.decode_and_sample(
                self.params, tokens, cache, self.cfg, noise,
                self.temperature, greedy=self.greedy, top_k=self.top_k,
                active=active, shard=self._page_shard)[0]
        return api.decode_step(self.params, tokens, cache, self.cfg,
                               active=active, shard=self._page_shard)[0]

    def _sample_body(self, logits, noise=None):
        """The sampler over the decode step's [B, V] logits."""
        return sample_logits(logits.to(torch.float32), noise,
                             self._steps["temperature"], greedy=self.greedy,
                             top_k=self.top_k)

    def _decode(self, decode_mask):
        """One decode step: the host's tokens, lengths, block tables and
        mask (rows of slots not decoding zeroed) and the live slots' noise
        staged into the static buffers, the decode program run (on a card
        a graph replay for the single pool: `_step_graphs`), unfused then
        the sampler program, and the [B] int32 tokens read back."""
        g = self._step_graphs()
        bufs = g["buffers"]
        staged = {"tokens": self.next_token,
                  "length": np.where(decode_mask, self.lengths, 0)}
        if self.paged:
            staged["block_table"] = np.where(decode_mask[:, None],
                                             self.block_tables, 0)
        if "active" in bufs:
            staged["active"] = decode_mask
        for name, arr in staged.items():
            host = g["host"][name]
            host.numpy()[...] = arr
            bufs[name].copy_(host, non_blocking=True)
        noise = {}
        if "noise" in bufs:
            noise["noise"] = self._sample_noise(range(self.B), live=decode_mask,
                                                out=bufs["noise"])
        decode_in = {k: v for k, v in bufs.items() if k != "noise"}
        if self.fused_decode:
            toks = g["decode"](self._decode_body, **decode_in, **noise)
        else:
            logits = g["decode"](self._decode_body, **decode_in)
            toks = g["sample"](self._sample_body, logits=logits, **noise)
        return toks.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------

    def _spec_span(self, decode_mask) -> int:
        """Tokens per speculative round this iteration: speculate_k, capped
        by the addressable tail of every live slot (a write past the block-
        table row would clamp onto the slot's last page) and by the longest
        remaining budget.  A span < 2 falls back to plain decode."""
        cap = self.max_pages_per_slot * self.layout.page_size
        slots = np.nonzero(decode_mask)[0]
        head = min(cap - int(self.lengths[s]) for s in slots)
        rem = max(int(self.slot_remaining[s]) for s in slots)
        return min(self.speculate_k, head, rem)

    def _spec_round(self, decode_mask, T: int):
        """One speculative round over every decoding slot: T-1 draft
        proposals (plain decode steps under the draft policy) and ONE
        batched verify under the serve policy.  The verify re-writes all T
        positions with the serve policy's KV codes before attending, and
        its row (s, j) samples with the noise of draw base + j, the draw
        plain decode would make there; only committed draws advance the
        slot's draw counter and lengths roll forward by the committed
        count, so the committed stream is plain decode's."""
        slots = [int(s) for s in np.nonzero(decode_mask)[0]]
        base = {s: int(self._slot_sampled[s]) for s in slots}
        for s in slots:
            pos = int(self.lengths[s])
            self._ensure_writable(s, pos, pos + T)
        inputs = np.zeros((self.B, T), np.int32)
        inputs[:, 0] = self.next_token
        # draft: d_j guesses the target's j-th draw, so it samples with that
        # draw's noise (base + j - 1); the draft's page writes are
        # placeholders the verify overwrites
        cur = torch.from_numpy(self.next_token.copy()).to(self.device)
        cache = self._meta(decode_mask)
        for j in range(1, T):
            logits, _ = api.decode_step(self.draft_params, cur, cache,
                                        self._draft_cfg)
            noise = self._noise_rows([(s, base[s] + j - 1)
                                      if decode_mask[s] else None
                                      for s in range(self.B)])
            cur = sample_logits(logits.to(torch.float32), noise,
                                self.temperature, greedy=self.greedy,
                                top_k=self.top_k)
            inputs[:, j] = cur.cpu().numpy()
            if j < T - 1:
                drafted = self.lengths + np.where(
                    decode_mask, j, 0).astype(np.int32)
                cache = self._meta(decode_mask, lengths=drafted)
        # verify: rows b-major, row (s, j) with draw base[s] + j
        noise = self._noise_rows([(s, base[s] + j) if decode_mask[s] else None
                                  for s in range(self.B) for j in range(T)])
        toks_bt, _ = api.decode_verify(
            self.params, torch.from_numpy(inputs).to(self.device),
            self._meta(decode_mask), self.cfg, noise, self.temperature,
            greedy=self.greedy, top_k=self.top_k)
        toks = toks_bt.cpu().numpy().astype(np.int32)
        self.stats["spec_rounds"] += 1
        self.stats["decode_steps"] += 1
        # per draft token: one draft decode + one sampler dispatch
        self.stats["decode_device_programs"] += 2 * (T - 1) + 1
        for s in slots:
            req = self.slot_req[s]
            # accept the longest prefix whose drafts matched the verified
            # tokens: t_j is trustworthy iff inputs[1..j] == t[0..j-1]
            n_acc = 1
            while n_acc < T and inputs[s, n_acc] == toks[s, n_acc - 1]:
                n_acc += 1
            self.stats["spec_draft_tokens"] += T - 1
            self.stats["spec_accepted_tokens"] += n_acc - 1
            commit = []
            for j in range(min(n_acc, int(self.slot_remaining[s]))):
                t = int(toks[s, j])
                commit.append(t)
                if req.eos_id is not None and t == req.eos_id:
                    break
            c = len(commit)
            req.out_tokens.extend(commit)
            if not self.greedy:
                self._slot_sampled[s] = base[s] + c
            self.lengths[s] += c
            self.next_token[s] = commit[-1]
            self.slot_remaining[s] -= c
            self.stats["spec_committed_tokens"] += c
            if self.slot_remaining[s] <= 0 or (
                    req.eos_id is not None and commit[-1] == req.eos_id):
                self._retire(s)

    def run(self, max_iters: int = 10_000):
        it = 0
        while (self.queue or (self.slot_phase != _FREE).any()) \
                and it < max_iters:
            if not self.step():
                break
            it += 1
        return self.done
