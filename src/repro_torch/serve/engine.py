"""Paged posit-KV serving engine (PyTorch port of `repro.serve.engine`,
single device).

The engine is a host-side slot scheduler over the model entry points:

  * `prefill_chunk_batched` — prompts decompose exactly into chunks from a
    small bucket table (e.g. 64/16/4/1 tokens), and all slots whose next
    chunk has the same bucket size advance as ONE [batch_slots, chunk]
    pass; rows of other slots are masked (zeroed metadata, writes to the
    trash page).  `batched_prefill=False` runs one slot at a time.
  * `decode_step` — one token for every decoding slot per iteration; with
    `fused_decode` (the default) the head GEMM and the sampler run in the
    fused decode-sample kernel, else the decode pass returns logits and
    the host-side sampler draws.

The KV cache is a pool of posit-coded pages `[L, n_pages, page_size,
Hkv*Dh]` updated in place, with a block table per slot; pages come from a
host free list (`PageAllocator`, page 0 reserved as trash) and are
reclaimed at retirement without zeroing (reads mask `pos < length`).

Sampling: greedy argmax, or temperature / top-k sampling from gumbel
noise drawn per (base seed, request seed, draw index) — reproducible and
independent of batch composition.  `noise_fn(seed, draw_index, vocab)`
replaces the default torch.Generator stream (tests replay the reference's
`jax.random` stream through it).

Not ported yet (each raises NotImplementedError naming ROADMAP): prefix
sharing with copy-on-write, the fused prefill kernel, speculative
decoding, sharded pools (`mesh`), the dense cache (`paged=False`),
preemption and cancellation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, set_float32_parity
from repro_torch.kernels.paged_attention import sample_logits
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import PagedLayout


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                               f"serving items)")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    seed: Optional[int] = None   # sampling stream (defaults to rid)
    out_tokens: Optional[list] = None


class PageAllocator:
    """Host-side refcounted free list over the single KV page pool.

    Page 0 is the trash page and is never handed out, so capacity is
    n_pages - 1.  `alloc(n)` grants fresh pages (low ids first) at refcount
    1, `share` takes an extra reference, `free` drops one reference per
    page and recycles a page when its last reference goes (returning the
    recycled pages); freeing a page that holds no reference raises."""

    def __init__(self, n_pages: int, n_shards: int = 1):
        if n_shards != 1:
            raise NotImplementedError(
                "per-device page budgets (sharded pools) are not ported yet "
                "(ROADMAP queue 1, slice H)")
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (trash + 1), got {n_pages}")
        self.n_shards = 1
        self.pages_per_shard = n_pages
        self.capacity = n_pages - 1
        self.peak_in_use = 0
        self.total_allocs = 0   # fresh grants ever (shares not counted)
        self._free = list(range(n_pages - 1, 0, -1))  # pop() -> low ids first
        self._refs: Dict[int, int] = {}

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.capacity - self.pages_free

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > self.pages_free:
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self.total_allocs += n
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
                self._free.append(p)
                recycled.append(p)
            else:
                self._refs[p] = rc - 1
        return recycled


_FREE, _PREFILL, _DECODE = 0, 1, 2


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
                 mesh=None,
                 noise_fn: Optional[Callable] = None,
                 device="cuda"):
        """batch_slots decode slots over a max_seq position budget per slot,
        serving `params` (float or posit-packed, already on `device`).

        page_size defaults to cfg.quant.kv_page_size and n_pages to full
        capacity (batch_slots * pages_per_slot + the trash page); a smaller
        n_pages oversubscribes and admission waits for reclaimed pages.
        prefill_chunks_per_step=0 completes a prompt's chunks at admission;
        k>0 interleaves at most k chunks per request per step with decode.
        batched_prefill / fused_decode / fused_prefill / prefix_sharing
        override the QuantPolicy knobs; the port serves
        prefix_sharing=False, fused_prefill=False (both pinned
        token-identical to their defaults by the reference).
        noise_fn(seed, draw_index, vocab) -> [vocab] f32 gumbel row, for
        sampled decoding; the default draws from a torch.Generator seeded
        by (base_seed, seed, draw_index).

        Constructing an engine turns TF32 off (`set_float32_parity`): the
        posit-decoded P(16,2) weights have 11 fraction bits, which TF32
        would round."""
        q = cfg.quant
        if fused_prefill is not None:
            q = dataclasses.replace(q, fused_prefill=bool(fused_prefill))
        if fused_decode is not None:
            q = dataclasses.replace(q, fused_decode=bool(fused_decode))
        cfg = dataclasses.replace(cfg, quant=q)
        if not paged:
            raise _not_ported("the dense (paged=False) serving cache")
        if mesh is not None:
            raise _not_ported("kv_pages-sharded serving (mesh=...)")
        if speculate_k:
            raise _not_ported("speculative decoding (speculate_k)")
        if q.fused_prefill:
            raise NotImplementedError(
                "the fused prefill kernel is not ported yet (ROADMAP queue 2); "
                "construct with fused_prefill=False")
        if prefix_sharing if prefix_sharing is not None else q.prefix_sharing:
            raise NotImplementedError(
                "prefix sharing with copy-on-write pages is not ported yet "
                "(ROADMAP queue 1, serving items); construct with "
                "prefix_sharing=False")
        if cfg.quant.execution == "bit_exact":
            raise _not_ported("the bit_exact execution plan")
        self.device = resolve_device(device)
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
        self.prefill_buckets = tuple(sorted(
            {int(b) for b in prefill_buckets if b >= 1} | {1}, reverse=True))
        ps = int(q.kv_page_size if page_size is None else page_size)
        if ps < 1:
            raise ValueError(f"page_size must be >= 1, got {ps}")
        self.layout = PagedLayout.for_slots(batch_slots, max_seq, ps, n_pages)
        self.cache = api.init_cache(cfg, batch_slots, max_seq, self.layout,
                                    device=self.device)
        self.paged = True
        self.n_shards = 1
        self.allocator = PageAllocator(self.layout.n_pages)
        self.max_pages_per_slot = self.cache["block_table"].shape[1]
        self.prefix_sharing = False
        self.batched_prefill = bool(q.batched_prefill if batched_prefill is None
                                    else batched_prefill)
        self.fused_decode = bool(q.fused_decode)
        self.noise_fn = noise_fn or self._default_noise

        # host-owned scheduler state (device copies are refreshed per call)
        self.lengths = np.zeros(batch_slots, np.int32)
        self.block_tables = np.zeros((batch_slots, self.max_pages_per_slot),
                                     np.int32)
        self.slot_phase = np.full(batch_slots, _FREE, np.int8)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pages: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_cursor = np.zeros(batch_slots, np.int64)  # prompt progress
        self.slot_remaining = np.zeros(batch_slots, np.int64)
        self.next_token = np.zeros(batch_slots, np.int32)
        self._slot_seed = [0] * batch_slots
        self._slot_sampled = np.zeros(batch_slots, np.int64)
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.stats = {"prefill_batch_sizes": {}, "prefill_chunks": 0,
                      "prefill_device_programs": 0, "decode_steps": 0,
                      "decode_device_programs": 0}

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
        """Decode-state storage split: `kv_bytes` is the K/V page payload,
        `metadata_bytes` the positions + block tables."""
        nbytes = {k: v.numel() * v.element_size() for k, v in self.cache.items()}
        kv = nbytes["k"] + nbytes["v"]
        meta = nbytes["length"] + nbytes["block_table"]
        page_b = kv // self.layout.n_pages
        return {"kv_bytes": kv, "metadata_bytes": meta,
                "total_bytes": kv + meta,
                "kv_bytes_in_use": self.pages_in_use * page_b,
                "kv_bytes_peak": self.allocator.peak_in_use * page_b}

    @property
    def pages_in_use(self) -> int:
        return self.allocator.pages_in_use

    @property
    def pages_free(self) -> int:
        return self.allocator.pages_free

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
            "weight_bytes": self.weight_bytes(),
            "kv_cache_bytes": kv["total_bytes"],
            "kv_bytes": kv["kv_bytes"],
            "metadata_bytes": kv["metadata_bytes"],
            "paged": True,
            "page_size": self.layout.page_size,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.pages_free,
            "prefix_sharing": self.prefix_sharing,
            "batched_prefill": self.batched_prefill,
            "fused_prefill": False,
            "fused_decode": self.fused_decode,
            "prefill_chunks": self.stats["prefill_chunks"],
            "prefill_device_programs": self.stats["prefill_device_programs"],
            "decode_steps": self.stats["decode_steps"],
            "decode_device_programs": self.stats["decode_device_programs"],
        }

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
        if self._pages_needed(req) > self.allocator.capacity:
            raise ValueError(
                f"request {req.rid} needs {self._pages_needed(req)} pages "
                f"but the pool only has {self.allocator.capacity}; raise "
                f"n_pages or shorten prompt/max_new_tokens")
        req.out_tokens = []
        self.queue.append(req)

    def preempt(self, slot: int):
        raise _not_ported("preemption")

    def cancel(self, rid: int):
        raise _not_ported("cancellation")

    def _pages_needed(self, req: Request) -> int:
        last_pos = len(req.prompt) + req.max_new_tokens - 2  # final write
        return min(last_pos // self.layout.page_size + 1,
                   self.max_pages_per_slot)

    def _chunk_sizes(self, n: int):
        """Exact greedy decomposition of n into bucket sizes (1 included)."""
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

    def _meta(self, mask=None):
        """The cache with host-owned lengths / block tables pushed to the
        device; `mask` zeroes rows of slots that must not touch real state
        (free / mid-prefill slots in decode, non-group slots in prefill)."""
        lengths = self.lengths.copy()
        bts = self.block_tables.copy()
        if mask is not None:
            lengths[~mask] = 0
            bts[~mask] = 0
        return {"k": self.cache["k"], "v": self.cache["v"],
                "length": torch.from_numpy(lengths).to(self.device),
                "block_table": torch.from_numpy(bts).to(self.device)}

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    def _default_noise(self, seed: int, draw: int, vocab: int):
        g = torch.Generator(device=self.device)
        g.manual_seed((((self.base_seed * 1_000_003) + seed) * 1_000_033
                       + draw) & 0x7FFF_FFFF_FFFF_FFFF)
        return api.sample_noise(g, 1, vocab, self.device)[0]

    def _sample_noise(self, slots, live=None):
        """[len(slots), V] gumbel rows (None when greedy), advancing each
        live slot's draw counter; rows of non-live slots are zeros and
        their draws are discarded."""
        if self.greedy:
            return None
        V = self.cfg.vocab_size
        rows = []
        for s in slots:
            if live is None or live[s]:
                row = self.noise_fn(self._slot_seed[s],
                                    int(self._slot_sampled[s]), V)
                if not isinstance(row, torch.Tensor):
                    row = torch.from_numpy(np.array(row, np.float32))
                rows.append(row.to(self.device, torch.float32).reshape(V))
                self._slot_sampled[s] += 1
            else:
                rows.append(torch.zeros(V, dtype=torch.float32,
                                        device=self.device))
        return torch.stack(rows)

    def _sample(self, logits_rows, slots, live=None):
        """Sample one token per row of logits_rows [n, V] for `slots`."""
        noise = self._sample_noise(slots, live=live)
        toks = sample_logits(logits_rows.to(torch.float32), noise,
                             self.temperature, greedy=self.greedy,
                             top_k=self.top_k)
        return toks.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------
    # admission / retirement
    # ------------------------------------------------------------------

    def _admit(self) -> bool:
        """Move queued requests into free slots, each with its full page
        demand allocated up front.  Returns True if any was admitted."""
        admitted = False
        for slot in range(self.B):
            if self.slot_phase[slot] != _FREE or not self.queue:
                continue
            req = self.queue[0]
            pages = self.allocator.alloc(self._pages_needed(req))
            if pages is None:
                return admitted  # wait for reclamation
            self.queue.pop(0)
            self.slot_pages[slot] = pages
            self.block_tables[slot] = 0
            self.block_tables[slot, :len(pages)] = pages
            self.slot_req[slot] = req
            self.slot_phase[slot] = _PREFILL
            self.slot_cursor[slot] = 0
            self.lengths[slot] = 0
            self._slot_seed[slot] = req.seed if req.seed is not None else req.rid
            self._slot_sampled[slot] = 0
            admitted = True
        return admitted

    def _release(self, slot: int):
        self.allocator.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.block_tables[slot] = 0
        self.lengths[slot] = 0
        self.slot_phase[slot] = _FREE
        self.slot_req[slot] = None

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

    def _count_chunk(self, n_slots: int):
        sizes = self.stats["prefill_batch_sizes"]
        sizes[n_slots] = sizes.get(n_slots, 0) + 1
        self.stats["prefill_chunks"] += 1
        # decomposed prefill: flash attention, KV encode, page insert
        self.stats["prefill_device_programs"] += 3

    def _advance_prefill(self, slot: int):
        """Run one prompt chunk for a prefilling slot (per-slot path)."""
        prompt = np.asarray(self.slot_req[slot].prompt, np.int32)
        lo = int(self.slot_cursor[slot])
        size = self._next_chunk(slot)
        tokens = torch.from_numpy(prompt[None, lo:lo + size]).to(self.device)
        logits, _ = api.prefill_chunk(self.params, tokens, self._meta(), slot,
                                      self.cfg)
        self._count_chunk(1)
        self.slot_cursor[slot] += size
        self.lengths[slot] += size
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
        active = np.zeros(self.B, bool)
        active[slots] = True
        logits, _ = api.prefill_chunk_batched(
            self.params, torch.from_numpy(tokens).to(self.device),
            self._meta(active), torch.from_numpy(active).to(self.device),
            self.cfg)
        self._count_chunk(len(slots))
        for s in slots:
            self.slot_cursor[s] += size
            self.lengths[s] += size
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
        cache_in = self._meta(decode_mask)
        tokens_in = torch.from_numpy(self.next_token.copy()).to(self.device)
        slots = [s for s in range(self.B) if decode_mask[s]]
        if self.fused_decode:
            noise = self._sample_noise(list(range(self.B)), live=decode_mask)
            toks_all, _ = api.decode_and_sample(
                self.params, tokens_in, cache_in, self.cfg, noise,
                self.temperature, greedy=self.greedy, top_k=self.top_k)
            toks = toks_all.cpu().numpy().astype(np.int32)[slots]
        else:
            logits, _ = api.decode_step(self.params, tokens_in, cache_in,
                                        self.cfg)
            toks = self._sample(logits, list(range(self.B)),
                                live=decode_mask)[slots]
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

    def run(self, max_iters: int = 10_000):
        it = 0
        while (self.queue or (self.slot_phase != _FREE).any()) \
                and it < max_iters:
            if not self.step():
                break
            it += 1
        return self.done
