"""Asyncio continuous-batching front end over ServingEngine (PyTorch port
of `repro.serve.frontend`; host code only, unchanged in behaviour).

The engine itself is a synchronous slot scheduler: `step()` advances
admission, chunked prefill, and one decode iteration.  This module wraps
it in an event loop so callers interact with serving the way clients do —
submit, stream, await — while the engine keeps iteration-level
continuous batching underneath (Orca-style: requests join and leave the
running batch at step granularity, never between prompt boundaries):

  * **streaming**: `submit(..., on_token=cb)` fires the callback per
    generated token as the engine emits it.  Preemption replays a
    request's stream from the start (the engine discards and regenerates
    bit-identically); the front end dedups by emitted count so a client
    never sees a token twice.
  * **SLO classes + deadlines**: each request carries an `SLOClass`
    (priority, preemptible flag) and an optional deadline.  Queued
    requests that blow their deadline are cancelled (`engine.cancel`,
    which prunes any holds their prefix pinned); the queue is kept sorted
    by priority, then submission order.
  * **admission control with preemption**: when a strictly-higher-
    priority request is stuck queued and no slot is free, the lowest-
    priority preemptible running slot is evicted via `engine.preempt` —
    its pages flow through the existing refcount/held-page paths (prompt
    pages become holds the requeued request remaps on re-admission) and
    its request requeues at its original priority, so the preemption
    cannot thrash: the victim sorts behind the request that displaced it.
  * **latency accounting**: time-to-first-token and inter-token-latency
    histograms per request, surfaced through `execution_summary()` next
    to the engine's own datapath counters.

The loop yields control (`await asyncio.sleep(0)`) after every engine
step, so client coroutines interleave submissions with serving on one
thread — no locks, no background threads, deterministic token streams.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .engine import Request, ServingEngine, _FREE


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A service class: higher `priority` admits first; `preemptible`
    slots may be evicted for a strictly-higher-priority queued request;
    `deadline_ms` is a default queueing deadline for the class (None =
    no deadline)."""
    name: str
    priority: int
    deadline_ms: Optional[float] = None
    preemptible: bool = True


INTERACTIVE = SLOClass("interactive", priority=10, preemptible=False)
BATCH = SLOClass("batch", priority=0)
DEFAULT_SLOS = {c.name: c for c in (INTERACTIVE, BATCH)}


class DeadlineExceeded(Exception):
    """Raised by Ticket.wait() for a request cancelled at its deadline."""


@dataclasses.dataclass
class Ticket:
    """Handle for one submitted request."""
    rid: int
    request: Request
    slo: SLOClass
    deadline: Optional[float]          # absolute clock() time, or None
    on_token: Optional[Callable]
    submitted: float
    seq: int
    state: str = "pending"             # pending | done | expired
    streamed: int = 0                  # tokens already delivered
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    done_event: asyncio.Event = dataclasses.field(
        default_factory=asyncio.Event)

    async def wait(self) -> List[int]:
        """Block until the request finishes; returns its tokens (raises
        DeadlineExceeded if it was cancelled at its deadline)."""
        await self.done_event.wait()
        if self.state == "expired":
            raise DeadlineExceeded(
                f"request {self.rid} ({self.slo.name}) expired in queue")
        return list(self.request.out_tokens)


class _Histogram:
    """Fixed-bucket latency histogram (milliseconds)."""

    BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                  1000.0, 2000.0, 5000.0)

    def __init__(self):
        self.samples: List[float] = []

    def add(self, ms: float):
        self.samples.append(float(ms))

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        arr = np.asarray(self.samples, np.float64)
        buckets: Dict[str, int] = {}
        lo = 0.0
        for hi in self.BUCKETS_MS:
            n = int(((arr > lo) & (arr <= hi)).sum()) if lo else \
                int((arr <= hi).sum())
            if n:
                buckets[f"<={hi:g}ms"] = n
            lo = hi
        over = int((arr > self.BUCKETS_MS[-1]).sum())
        if over:
            buckets[f">{self.BUCKETS_MS[-1]:g}ms"] = over
        return {
            "count": int(arr.size),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "max_ms": float(arr.max()),
            "buckets": buckets,
        }


class AsyncServingFrontend:
    """Asyncio front end over a ServingEngine (see module docstring).

    Typical shape::

        frontend = AsyncServingFrontend(engine)
        t = frontend.submit(prompt, slo="interactive", on_token=cb)
        tokens = (await asyncio.gather(frontend.run(), t.wait()))[1]
    """

    def __init__(self, engine: ServingEngine, slo_classes=None,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.slos = dict(DEFAULT_SLOS)
        for c in (slo_classes or ()):
            self.slos[c.name] = c
        self._clock = clock
        self._tickets: Dict[int, Ticket] = {}
        self._rids = itertools.count()
        self._seq = itertools.count()
        self._done_seen = 0
        self.ttft = _Histogram()
        self.itl = _Histogram()
        self.preemptions = 0
        self.expired = 0

    # ------------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None, seed: Optional[int] = None,
               slo: str = "batch", deadline_ms: Optional[float] = None,
               on_token: Optional[Callable] = None,
               rid: Optional[int] = None) -> Ticket:
        """Queue a request under an SLO class; returns its Ticket.

        on_token(rid, index, token) fires as tokens stream out (dedup'd
        across preemption replays).  deadline_ms (default: the class's)
        bounds *queueing*: a request still unadmitted past it is
        cancelled and its ticket expires."""
        cls = self.slos[slo]
        if rid is None:
            rid = next(self._rids)
            while rid in self._tickets:
                rid = next(self._rids)
        elif rid in self._tickets:
            raise ValueError(f"duplicate rid {rid}")
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      seed=seed)
        self.engine.submit(req)  # validates budget/capacity; may raise
        dl = cls.deadline_ms if deadline_ms is None else deadline_ms
        now = self._clock()
        ticket = Ticket(rid=rid, request=req, slo=cls,
                        deadline=None if dl is None else now + dl / 1e3,
                        on_token=on_token, submitted=now,
                        seq=next(self._seq))
        self._tickets[rid] = ticket
        self._sort_queue()
        return ticket

    def _sort_queue(self):
        """Priority-then-submission-order queue discipline.  The sort is
        stable over the engine's own queue (which preemption may have
        reordered), so a preempted request resumes in its original
        position among its equals."""
        self.engine.queue.sort(
            key=lambda r: (-self._tickets[r.rid].slo.priority,
                           self._tickets[r.rid].seq))

    # ------------------------------------------------------------------
    def _expire_queued(self, now: float):
        queued = {r.rid for r in self.engine.queue}
        for t in self._tickets.values():
            if (t.state == "pending" and t.deadline is not None
                    and now > t.deadline and t.rid in queued
                    and self.engine.cancel(t.rid)):
                t.state = "expired"
                self.expired += 1
                t.done_event.set()

    def _maybe_preempt(self):
        """Evict the lowest-priority preemptible running slot when a
        strictly-higher-priority request is stuck queued with no free
        slot.  One eviction per loop iteration: the requeued victim sorts
        behind what displaced it, so priorities settle without thrash."""
        eng = self.engine
        if not eng.queue or (eng.slot_phase == _FREE).any():
            return
        top = max(self._tickets[r.rid].slo.priority for r in eng.queue)
        victims = []
        for slot in range(eng.B):
            req = eng.slot_req[slot]
            if req is None:
                continue
            t = self._tickets.get(req.rid)
            prio = t.slo.priority if t else 0
            if (t is None or t.slo.preemptible) and prio < top:
                victims.append((prio, t.seq if t else 0, slot))
        if not victims:
            return
        # the victim replays from scratch after re-admission; _pump's
        # emitted-count dedup resumes its client stream seamlessly
        eng.preempt(min(victims)[2])
        self.preemptions += 1
        self._sort_queue()

    def _pump(self, now: float):
        """Deliver newly generated tokens (dedup'd across preemption
        replays) and settle finished tickets."""
        for t in self._tickets.values():
            if t.state != "pending":
                continue
            out = t.request.out_tokens or []
            while t.streamed < len(out):
                tok = int(out[t.streamed])
                if t.first_token_at is None:
                    t.first_token_at = now
                    self.ttft.add((now - t.submitted) * 1e3)
                else:
                    self.itl.add((now - t.last_token_at) * 1e3)
                t.last_token_at = now
                t.streamed += 1
                if t.on_token is not None:
                    t.on_token(t.rid, t.streamed - 1, tok)
        for req in self.engine.done[self._done_seen:]:
            t = self._tickets.get(req.rid)
            if t is not None and t.state == "pending":
                t.state = "done"
                t.done_event.set()
        self._done_seen = len(self.engine.done)

    # ------------------------------------------------------------------
    async def run(self, max_iters: int = 100_000):
        """Drive the engine until every submitted ticket settles.  Yields
        to the event loop after each engine step so clients can stream
        callbacks and submit mid-flight; run it concurrently with the
        submitters (asyncio.gather)."""
        it = 0
        while any(t.state == "pending" for t in self._tickets.values()):
            now = self._clock()
            self._expire_queued(now)
            self._maybe_preempt()
            self.engine.step()
            self._pump(self._clock())
            it += 1
            if it >= max_iters:
                raise RuntimeError(
                    f"frontend did not drain within {max_iters} engine "
                    f"steps; pending="
                    f"{[t.rid for t in self._tickets.values() if t.state == 'pending']}")
            await asyncio.sleep(0)

    # ------------------------------------------------------------------
    def execution_summary(self) -> dict:
        """Engine datapath summary + front-end latency/scheduling terms."""
        s = self.engine.execution_summary()
        s["ttft_ms"] = self.ttft.summary()
        s["itl_ms"] = self.itl.summary()
        s["frontend_preemptions"] = self.preemptions
        s["expired_requests"] = self.expired
        s["requests_done"] = sum(
            1 for t in self._tickets.values() if t.state == "done")
        return s
