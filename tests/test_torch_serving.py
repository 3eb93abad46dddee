"""PyTorch port vs the JAX reference: the serving engine and its page
allocator.

Engine runs on both sides serve the same queue with the same parameters
(the reference's, carried over as numpy) and the same knobs: a mixed queue
with `prefix_sharing=False, fused_prefill=False`, and a shared-prefix
queue at the engine defaults (prefix sharing with copy-on-write pages,
fused prefill), also under `serve_fused_p16_a13`.  Greedy token streams
must be equal; sampled streams must be equal when the port's `noise_fn`
replays `repro.models.api.sample_noise` on the reference's key stream
(fold_in(fold_in(key(base_seed), request seed), draw index)).  Sharing
counters, allocator totals and the page pools (page 0, the trash page,
excluded) must be equal too.  Reference runs are shared through
module-scoped fixtures.
"""
import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core.quant import QuantPolicy as JPolicy
from repro.core.quant import policy_by_name as jpolicy
from repro.models import api as japi
from repro.serve import PageAllocator as JAllocator
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine

from repro_torch import configs as tconfigs
from repro_torch.core import formats as tformats
from repro_torch.core.quant import QuantPolicy as TPolicy
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.models import packing as tpacking
from repro_torch.serve import PageAllocator as TAllocator
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

MAX_SEQ = 48
# (prompt length, max_new_tokens, eos) per request
QUEUE = [(3, 6, None), (17, 5, None), (9, 7, 11), (30, 4, None), (5, 8, None),
         (21, 1, None)]
RUNS = {
    # name: (config, greedy, fused_decode, batched_prefill, chunks_per_step)
    "greedy-fused": ("tiny", True, True, True, 0),
    "greedy-decomposed": ("tiny", True, False, True, 0),
    "sampled-fused": ("tiny", False, True, True, 0),
    "sampled-decomposed-interleaved": ("tiny", False, False, True, 1),
    "greedy-per-slot-prefill": ("tiny", True, True, False, 0),
}


def _cfgs(kind):
    getter = {"tiny": "get_tiny_serving", "smoke": "get_smoke"}[kind]
    jcfg = getattr(jconfigs, getter)("command_r_35b").replace(
        quant=jpolicy("serve_fused_p16"))
    tcfg = getattr(tconfigs, getter)("command_r_35b").replace(
        quant=tpolicy("serve_fused_p16"))
    return jcfg, tcfg


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).astype(np.int32) for n, _, _ in QUEUE]


def _jax_noise(base_seed):
    base = jax.random.key(base_seed)

    def noise_fn(seed, draw, vocab):
        key = jax.random.fold_in(jax.random.fold_in(base, seed), draw)
        return np.asarray(japi.sample_noise(key[None], vocab))[0]

    return noise_fn


def _serve(engine, request_cls, prompts):
    for rid, (p, (_, max_new, eos)) in enumerate(zip(prompts, QUEUE)):
        engine.submit(request_cls(rid=rid, prompt=p, max_new_tokens=max_new,
                                  eos_id=eos, seed=100 + rid))
    done = engine.run()
    return {r.rid: list(map(int, r.out_tokens)) for r in done}


@pytest.fixture(scope="module", params=sorted(RUNS))
def served(request):
    kind, greedy, fused_decode, batched, per_step = RUNS[request.param]
    jcfg, tcfg = _cfgs(kind)
    params = japi.pack_params(japi.init(jax.random.key(2), jcfg), jcfg)
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(batch_slots=3, max_seq=MAX_SEQ, greedy=greedy,
              temperature=0.8, top_k=5, base_seed=9,
              prefill_chunks_per_step=per_step, prefix_sharing=False,
              fused_prefill=False, fused_decode=fused_decode,
              batched_prefill=batched)
    jeng = JEngine(jcfg, params, **kw)
    want = _serve(jeng, JRequest, prompts)
    teng = TEngine(tcfg, tpacking.params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"), device="cpu",
        noise_fn=_jax_noise(9), **kw)
    got = _serve(teng, TRequest, prompts)
    return want, got, jeng, teng


def test_token_streams_equal(served):
    want, got, _, _ = served
    assert got == want


def test_pool_reclaimed_and_counters_match(served):
    _, _, jeng, teng = served
    assert teng.pages_free == teng.allocator.capacity
    assert teng.pages_in_use == 0
    js, ts = jeng.execution_summary(), teng.execution_summary()
    for key in ("decode_steps", "decode_device_programs", "prefill_chunks",
                "prefill_device_programs", "pages_free", "weight_bytes",
                "kv_bytes", "page_size", "fused_decode", "batched_prefill"):
        assert ts[key] == js[key], key
    assert teng.stats["prefill_batch_sizes"] == \
        jeng.stats["prefill_batch_sizes"]
    assert teng.allocator.peak_in_use == jeng.allocator.peak_in_use


def test_default_noise_is_seeded_and_batch_independent():
    """Without noise_fn, a request's sampled stream depends on its seed
    only, not on what else is in the batch."""
    _, tcfg = _cfgs("tiny")
    import torch
    from repro_torch.models import api as tapi
    params = tpacking.pack_params(
        tapi.init(torch.Generator().manual_seed(0), tcfg, device="cpu"), tcfg)
    prompts = _prompts(tcfg.vocab_size)

    def run(rids):
        eng = TEngine(tcfg, params, batch_slots=3, max_seq=MAX_SEQ,
                      greedy=False, temperature=1.0, top_k=0, base_seed=4,
                      prefix_sharing=False, fused_prefill=False, device="cpu")
        for rid in rids:
            eng.submit(TRequest(rid=rid, prompt=prompts[rid],
                                max_new_tokens=6))
        return {r.rid: r.out_tokens for r in eng.run()}

    alone, mixed = run([1]), run([0, 1, 3])
    assert alone[1] == mixed[1]
    assert run([0, 1, 3]) == mixed


@pytest.mark.parametrize("temperature", [0.8, 0.7, 1e-7])
def test_sampler_temperature_division_matches_reference(temperature):
    """The sampler scales logits by a true f32 division by max(T, 1e-6),
    bitwise numpy's and the reference's `logits / jnp.maximum(temperature,
    1e-6)` (src/repro/serve/engine.py), never by a reciprocal multiply."""
    import jax.numpy as jnp
    import torch
    from repro_torch.kernels import paged_attention as tpa
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 5003)) * 30).astype(np.float32)
    got = tpa.scale_logits(torch.from_numpy(logits), temperature).numpy()
    host = logits / np.float32(max(temperature, 1e-6))
    ref = np.asarray(jnp.asarray(logits) / jnp.maximum(temperature, 1e-6))
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), host.view(np.int32))
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_page_allocator_fuzz_matches_reference():
    rng = np.random.default_rng(17)
    for trial in range(4):
        n_pages = int(rng.integers(2, 24))
        ja, ta = JAllocator(n_pages), TAllocator(n_pages)
        live = []
        for _ in range(300):
            op = rng.integers(0, 3)
            if op == 0:
                n = int(rng.integers(0, 6))
                got, want = ta.alloc(n), ja.alloc(n)
                assert got == want
                if got:
                    live.extend(got)
            elif op == 1 and live:
                pages = list(rng.choice(live, int(rng.integers(1, 3))))
                ta.share(pages)
                ja.share(pages)
                live.extend(pages)
            elif op == 2 and live:
                idx = sorted(set(rng.integers(0, len(live),
                                              int(rng.integers(1, 4)))),
                             reverse=True)
                pages = [live.pop(i) for i in idx]
                assert ta.free(pages) == ja.free(pages)
            assert (ta.pages_free, ta.pages_in_use, ta.peak_in_use,
                    ta.total_allocs, ta.capacity) == \
                (ja.pages_free, ja.pages_in_use, ja.peak_in_use,
                 ja.total_allocs, ja.capacity)
            for p in range(n_pages):
                assert ta.refcount(p) == ja.refcount(p)
        with pytest.raises(ValueError, match="double free"):
            ta.free([0])
        with pytest.raises(ValueError, match="cannot share"):
            ta.share([0])


def test_submit_validation_matches_reference():
    _, tcfg = _cfgs("tiny")
    import torch
    from repro_torch.models import api as tapi
    params = tapi.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    eng = TEngine(tcfg, params, batch_slots=2, max_seq=16, page_size=4,
                  n_pages=2, prefix_sharing=False, fused_prefill=False,
                  device="cpu")
    for req in (TRequest(0, np.zeros(0, np.int32)),             # empty
                TRequest(1, np.zeros(4, np.int32), max_new_tokens=0),
                TRequest(2, np.zeros(10, np.int32), max_new_tokens=8),
                TRequest(3, np.zeros(6, np.int32), max_new_tokens=2)):
        with pytest.raises(ValueError):
            eng.submit(req)
    eng.submit(TRequest(4, np.zeros(3, np.int32), max_new_tokens=2))
    assert len(eng.queue) == 1


# ---------------------------------------------------------------------------
# the engine defaults: prefix sharing + fused prefill, on a shared-prefix
# queue (a 32-token system prompt = two 16-token pages, plus exact
# duplicates whose partial tail page is shared and forked on write)
# ---------------------------------------------------------------------------

DEFAULT_RUNS = {
    # name: (policy, greedy, batched_prefill, chunks_per_step)
    "defaults-greedy": ("serve_fused_p16", True, None, 0),
    "defaults-sampled": ("serve_fused_p16", False, None, 0),
    "defaults-per-slot-interleaved": ("serve_fused_p16", True, False, 1),
    "a13-greedy": ("serve_fused_p16_a13", True, None, 0),
}


def _shared_queue(vocab):
    rng = np.random.default_rng(12)
    system = rng.integers(0, vocab, 32).astype(np.int32)
    dup = rng.integers(0, vocab, 21).astype(np.int32)
    tail = lambda n: rng.integers(0, vocab, n).astype(np.int32)  # noqa: E731
    # (prompt, max_new_tokens, eos)
    return [(np.concatenate([system, tail(5)]), 6, None),
            (np.concatenate([system, tail(3)]), 5, None),
            (dup, 6, None),
            (dup.copy(), 5, None),
            (np.concatenate([system, tail(9)]), 4, 7),
            (tail(13), 4, None),
            (np.concatenate([system, tail(1)]), 3, None),
            (dup.copy(), 2, None)]


def _serve_queue(engine, request_cls, queue):
    for rid, (p, max_new, eos) in enumerate(queue):
        engine.submit(request_cls(rid=rid, prompt=p.copy(),
                                  max_new_tokens=max_new, eos_id=eos,
                                  seed=100 + rid))
    done = engine.run()
    return {r.rid: list(map(int, r.out_tokens)) for r in done}


@pytest.fixture(scope="module", params=sorted(DEFAULT_RUNS))
def served_defaults(request):
    policy, greedy, batched, per_step = DEFAULT_RUNS[request.param]
    jcfg = jconfigs.get_tiny_serving("command_r_35b").replace(
        quant=jpolicy(policy))
    tcfg = tconfigs.get_tiny_serving("command_r_35b").replace(
        quant=tpolicy(policy))
    params = japi.pack_params(japi.init(jax.random.key(2), jcfg), jcfg)
    queue = _shared_queue(jcfg.vocab_size)
    kw = dict(batch_slots=3, max_seq=MAX_SEQ, greedy=greedy,
              temperature=0.8, top_k=5, base_seed=9,
              prefill_chunks_per_step=per_step, batched_prefill=batched)
    jeng = JEngine(jcfg, params, **kw)
    want = _serve_queue(jeng, JRequest, queue)
    teng = TEngine(tcfg, tpacking.params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"), device="cpu",
        noise_fn=_jax_noise(9), **kw)
    got = _serve_queue(teng, TRequest, queue)
    return want, got, jeng, teng


def test_defaults_token_streams_equal(served_defaults):
    want, got, jeng, teng = served_defaults
    assert teng.prefix_sharing and teng.cfg.quant.fused_prefill
    assert got == want


def test_defaults_sharing_counters_match(served_defaults):
    _, _, jeng, teng = served_defaults
    for key in ("shared_admissions", "pages_shared", "cow_forks",
                "prefill_chunks", "prefill_device_programs", "decode_steps"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["shared_admissions"] > 0
    assert teng.stats["cow_forks"] > 0
    assert teng.allocator.total_allocs == jeng.allocator.total_allocs
    assert teng.allocator.peak_in_use == jeng.allocator.peak_in_use
    js, ts = jeng.execution_summary(), teng.execution_summary()
    for key in ("pages_shared_mapped", "cow_forks", "fused_prefill",
                "prefix_sharing", "activation_coded", "page_size",
                "prefill_device_programs", "prefill_chunks"):
        assert ts[key] == js[key], key
    assert ts["prefill_device_programs"] == ts["prefill_chunks"]
    assert teng.pages_free == teng.allocator.capacity
    assert not teng._held and not teng.prefix_index


def test_defaults_page_pools_bitwise(served_defaults):
    _, _, jeng, teng = served_defaults
    for name in ("k", "v"):
        np.testing.assert_array_equal(teng.cache[name].numpy()[:, 1:],
                                      np.asarray(jeng.cache[name])[:, 1:])


def _tiny_pair(policy_kw):
    jq = JPolicy(kv_cache=jformats.P16_1, **policy_kw)
    tq = TPolicy(kv_cache=tformats.P16_1, **policy_kw)
    jcfg = jconfigs.get_tiny_serving("command_r_35b", jq)
    tcfg = tconfigs.get_tiny_serving("command_r_35b", tq)
    params = japi.init(jax.random.key(0), jcfg)
    return jcfg, tcfg, params, tpacking.params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def test_resolve_page_size_rules_match_reference(monkeypatch):
    """An explicit page size that loses the one-launch prefill raises; the
    escape hatch keeps it; the policy default auto-picks a FLASH_CHUNK
    divisor; sizes the span gate admits pass unchanged."""
    from repro.models import paged as jpaged
    from repro_torch.models import paged as tpaged
    monkeypatch.setattr(tpaged, "FLASH_CHUNK", 16)
    monkeypatch.setattr(jpaged, "FLASH_CHUNK", 16)
    _, tcfg, _, tparams = _tiny_pair({})
    with pytest.raises(ValueError, match="fused"):
        TEngine(tcfg, tparams, batch_slots=1, max_seq=64, page_size=12,
                device="cpu")
    eng = TEngine(tcfg, tparams, batch_slots=1, max_seq=64, page_size=12,
                  fused_prefill=False, device="cpu")
    assert eng.layout.page_size == 12
    assert eng._prefill_programs_per_chunk(8) == 3
    jcfg, tcfg, jparams, tparams = _tiny_pair(dict(kv_page_size=12))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (21, 6)]
    got_eng = TEngine(tcfg, tparams, batch_slots=2, max_seq=64, device="cpu")
    want_eng = JEngine(jcfg, jparams, batch_slots=2, max_seq=64)
    assert got_eng.layout.page_size == want_eng.layout.page_size == 8
    queue = [(p, 3, None) for p in prompts]
    assert _serve_queue(got_eng, TRequest, queue) == \
        _serve_queue(want_eng, JRequest, queue)
    s = got_eng.execution_summary()
    assert s["prefill_device_programs"] == s["prefill_chunks"] > 0


def test_resolve_page_size_untouched_when_gate_holds():
    _, tcfg, _, tparams = _tiny_pair({})
    eng = TEngine(tcfg, tparams, batch_slots=1, max_seq=32, page_size=48,
                  device="cpu")
    assert eng.layout.page_size == 48
    eng2 = TEngine(tcfg, tparams, batch_slots=1, max_seq=32, device="cpu")
    assert eng2.layout.page_size == tcfg.quant.kv_page_size
    assert eng2._prefill_programs_per_chunk(8) == 1
    dec = TEngine(tcfg, tparams, batch_slots=1, max_seq=32,
                  fused_prefill=False, device="cpu")
    assert dec._prefill_programs_per_chunk(8) == 3
