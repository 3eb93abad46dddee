"""PyTorch port: the asyncio front end (`repro_torch/serve/frontend.py`)
and the engine's `preempt` / `cancel`.

The five laws of `tests/test_frontend.py`, run against the port on the CPU
with an injected clock that ticks one millisecond per reading (so the
latency histograms are deterministic): streamed tokens equal the final
tokens and a plain engine's streams, across a preemption replay; an
interactive arrival evicts one batch slot; the interactive class is never
evicted; a queued request past its deadline expires with a clean pool;
custom SLO classes and duplicate rids.  Then `preempt` and `cancel`
against the reference engine on one script (shared-prefix queue at the
engine defaults): equal queue order after each call, equal holds,
allocator totals and page references, and streams replayed equal.
"""
import asyncio

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core.quant import QuantPolicy as JPolicy
from repro.models import api as japi
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine

from repro_torch import configs as tconfigs
from repro_torch.core import formats as tformats
from repro_torch.core.quant import QuantPolicy as TPolicy
from repro_torch.models import packing as tpacking
from repro_torch.serve import (AsyncServingFrontend, DeadlineExceeded,
                               Request, ServingEngine, SLOClass)

ENGINE = dict(batch_slots=2, max_seq=32, page_size=4, n_pages=24,
              prefill_buckets=(4, 1))


def _model():
    if not hasattr(_model, "cache"):
        jcfg = jconfigs.get_tiny_serving(
            "command_r_35b", JPolicy(weights=jformats.P16_2,
                                     kv_cache=jformats.P8_2))
        tcfg = tconfigs.get_tiny_serving(
            "command_r_35b", TPolicy(weights=tformats.P16_2,
                                     kv_cache=tformats.P8_2))
        jparams = japi.init(jax.random.key(0), jcfg)
        tparams = tpacking.params_from_numpy(
            jax.tree.map(np.asarray, jparams), tcfg, "cpu")
        _model.cache = (jcfg, jparams, tcfg, tparams)
    return _model.cache


def _engine(**kw):
    _, _, tcfg, tparams = _model()
    return ServingEngine(tcfg, tparams, device="cpu", **dict(ENGINE, **kw))


def _clock():
    t = [0.0]

    def clock():
        t[0] += 1e-3
        return t[0]

    return clock


def _prompts(ns, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 60, n).astype(np.int32) for n in ns]


@pytest.mark.parametrize("speculate_k", [0, 3])
def test_streaming_matches_final_tokens_and_plain_engine(speculate_k):
    prompts = _prompts((5, 9, 7))
    ref = _engine()
    for i, p in enumerate(prompts):
        ref.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=4))
    want = {r.rid: list(r.out_tokens) for r in ref.run()}

    frontend = AsyncServingFrontend(_engine(speculate_k=speculate_k),
                                    clock=_clock())
    streams: dict = {}

    def on_token(rid, idx, tok):
        out = streams.setdefault(rid, [])
        assert idx == len(out)
        out.append(tok)

    async def main():
        ts = [frontend.submit(p, max_new_tokens=4, on_token=on_token, rid=i)
              for i, p in enumerate(prompts)]
        done, _ = await asyncio.gather(
            asyncio.gather(*(t.wait() for t in ts)), frontend.run())
        return {t.rid: toks for t, toks in zip(ts, done)}

    got = asyncio.run(main())
    assert got == want == streams
    s = frontend.execution_summary()
    assert s["requests_done"] == 3 and s["expired_requests"] == 0
    assert s["ttft_ms"]["count"] == 3
    assert s["itl_ms"]["count"] == sum(len(t) for t in want.values()) - 3
    assert s["speculative"] == bool(speculate_k)
    assert frontend.engine.pages_in_use == 0


@pytest.mark.parametrize("speculate_k", [0, 3])
def test_interactive_preempts_lowest_priority_batch_slot(speculate_k):
    prompts = _prompts((6, 8, 5, 7), seed=1)
    interactive = _prompts((5,), 2)[0]
    ref = _engine()
    for i, p in enumerate(prompts):
        ref.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=6))
    ref.submit(Request(rid=99, prompt=interactive.copy(), max_new_tokens=6))
    want = {r.rid: list(r.out_tokens) for r in ref.run()}

    eng = _engine(speculate_k=speculate_k)
    frontend = AsyncServingFrontend(eng, clock=_clock())
    streams: dict = {}

    def on_token(rid, idx, tok):
        streams.setdefault(rid, []).append(tok)

    async def main():
        ts = [frontend.submit(p, max_new_tokens=6, slo="batch", rid=i,
                              on_token=on_token)
              for i, p in enumerate(prompts)]
        runner = asyncio.ensure_future(frontend.run())
        while not ((eng.slot_phase != 0).all() and eng.queue):
            if all(t.state != "pending" for t in ts):
                break
            await asyncio.sleep(0)
        ti = frontend.submit(interactive, max_new_tokens=6,
                             slo="interactive", rid=99, on_token=on_token)
        out = {t.rid: await t.wait() for t in ts + [ti]}
        await runner
        return out

    got = asyncio.run(main())
    assert got == want == streams
    assert frontend.preemptions >= 1
    assert eng.stats["preemptions"] == frontend.preemptions
    assert eng.pages_in_use == 0 and not eng._held


def test_interactive_class_is_never_preempted():
    eng = _engine()
    frontend = AsyncServingFrontend(eng, clock=_clock())

    async def main():
        ti = [frontend.submit(p, max_new_tokens=6, slo="interactive",
                              rid=10 + i)
              for i, p in enumerate(_prompts((6, 7), 3))]
        tb = [frontend.submit(p, max_new_tokens=2, slo="batch", rid=i)
              for i, p in enumerate(_prompts((5, 5), 4))]
        await asyncio.gather(frontend.run(), *(t.wait() for t in ti + tb))

    asyncio.run(main())
    assert frontend.preemptions == 0
    assert eng.stats["preemptions"] == 0


def test_deadline_expiry_cancels_and_keeps_pool_clean():
    eng = _engine(batch_slots=1)
    now = [0.0]
    frontend = AsyncServingFrontend(eng, clock=lambda: now[0])
    fired = []

    async def main():
        t0 = frontend.submit(_prompts((6,), 5)[0], max_new_tokens=8, rid=0)
        t1 = frontend.submit(_prompts((14,), 6)[0], max_new_tokens=8, rid=1,
                             deadline_ms=1.0,
                             on_token=lambda *a: fired.append(a))
        now[0] = 1.0  # 1000 ms later: rid 1 is still queued behind rid 0
        runner = asyncio.ensure_future(frontend.run())
        toks = await t0.wait()
        with pytest.raises(DeadlineExceeded):
            await t1.wait()
        await runner
        return toks, t1

    toks, t1 = asyncio.run(main())
    assert len(toks) == 8 and not fired and t1.state == "expired"
    s = frontend.execution_summary()
    assert s["expired_requests"] == 1 and s["requests_done"] == 1
    assert eng.pages_in_use == 0 and not eng._held
    assert not eng.queue


def test_custom_slo_class_and_duplicate_rid_rejected():
    eng = _engine()
    hi = SLOClass("gold", priority=50, deadline_ms=None, preemptible=False)
    frontend = AsyncServingFrontend(eng, slo_classes=[hi], clock=_clock())

    async def main():
        t0 = frontend.submit(_prompts((5,), 7)[0], max_new_tokens=2,
                             slo="gold", rid=7)
        with pytest.raises(ValueError, match="duplicate rid"):
            frontend.submit(_prompts((5,), 7)[0], rid=7)
        await asyncio.gather(frontend.run(), t0.wait())
        return t0

    t0 = asyncio.run(main())
    assert t0.slo.name == "gold" and t0.state == "done"
    s = frontend.execution_summary()
    assert s["ttft_ms"]["count"] == 1 and s["ttft_ms"]["p50_ms"] > 0


# ---------------------------------------------------------------------------
# preempt / cancel against the reference engine
# ---------------------------------------------------------------------------

def _script_queue():
    """Shared 8-token system prompt plus distinct tails, one exact
    duplicate: prefix sharing maps pages, preemption turns them into
    holds."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, 60, 8)
    tails = [rng.integers(0, 60, n) for n in (3, 6, 2, 5)]
    prompts = [np.concatenate([system, t]).astype(np.int32) for t in tails]
    prompts.append(prompts[1].copy())
    return prompts


def _state(eng):
    a = eng.allocator
    return dict(queue=[r.rid for r in eng.queue], held=sorted(eng._held),
                refs=dict(sorted(a._refs.items())), in_use=a.pages_in_use,
                total_allocs=a.total_allocs, peak=a.peak_in_use,
                preemptions=eng.stats["preemptions"],
                phase=[int(p) for p in eng.slot_phase],
                lengths=[int(n) for n in eng.lengths])


def _preempt_busy(eng, last=False):
    """Preempt the first (or last) busy slot: (slot, requeued rid)."""
    busy = [s for s in range(eng.B) if eng.slot_phase[s] != 0]
    slot = busy[-1 if last else 0]
    return slot, eng.preempt(slot).rid


def _script(eng, request_cls):
    """Submit, step, preempt a busy slot (twice: the second call finds it
    free), cancel a queued request and a missing one, preempt again,
    drain; returns each call's result with the state after it, and the
    final streams."""
    for rid, p in enumerate(_script_queue()):
        eng.submit(request_cls(rid=rid, prompt=p.copy(), max_new_tokens=5))
    states = []
    eng.step()
    eng.step()
    states.append(_state(eng))
    slot, rid = _preempt_busy(eng)
    states.append((slot, rid, _state(eng)))
    states.append((eng.preempt(slot), _state(eng)))
    eng.step()
    states.append(_state(eng))
    states.append((eng.cancel(3), _state(eng)))
    states.append((eng.cancel(12345), _state(eng)))
    eng.step()
    states.append((_preempt_busy(eng, last=True), _state(eng)))
    done = eng.run()
    states.append(_state(eng))
    return states, {r.rid: list(map(int, r.out_tokens)) for r in done}


def test_preempt_and_cancel_match_reference():
    jcfg, jparams, tcfg, tparams = _model()
    jstates, jstreams = _script(JEngine(jcfg, jparams, **ENGINE), JRequest)
    tstates, tstreams = _script(ServingEngine(tcfg, tparams, device="cpu",
                                              **ENGINE), Request)
    assert tstates == jstates
    assert tstreams == jstreams
    assert 3 not in tstreams and len(tstreams) == 4
    # the preempted requests replay the streams an undisturbed run emits
    plain = _engine()
    for rid, p in enumerate(_script_queue()):
        if rid != 3:
            plain.submit(Request(rid=rid, prompt=p.copy(), max_new_tokens=5))
    assert {r.rid: list(map(int, r.out_tokens)) for r in plain.run()} == \
        tstreams
    final = tstates[-1]
    assert final["in_use"] == 0 and not final["held"] and not final["refs"]
    assert final["preemptions"] == 2


def test_preempt_free_slot_and_cancel_unknown_are_no_ops():
    eng = _engine()
    assert eng.preempt(0) is None and eng.preempt(1) is None
    assert eng.cancel(7) is False
    assert eng.stats["preemptions"] == 0 and not eng.queue
