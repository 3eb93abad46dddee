"""PyTorch port vs the JAX reference: speculative decoding.

The port's `ServingEngine(speculate_k=k)` drafts k-1 tokens per round with
the draft policy (`QuantPolicy.with_draft()`: fake_quant over the same
weights) and verifies them in one `api.decode_verify` (one multi-query
paged-attention launch per layer).  Each case of
`tests/test_speculative.py` (greedy; sampled, with the reference's noise
replayed through `noise_fn`; a narrow P(8,0) draft; eos inside a round; a
budget shorter than the span; interleaved chunked prefill) runs the same
queue through the reference's speculative engine, the port's speculative
engine and the port's plain engine, on the tiny serving config, under the
fake_quant policy of `examples/serve_async.py`; the greedy, sampled and
interleaved cases also under packed `serve_fused_p16`.  The port's
speculative streams must equal the reference's and the port's plain
streams; the speculation counters, decode counters and allocator totals
must equal the reference's, and every page must come back.  Reference
runs are shared through a module-scoped fixture.  (`decode_verify`
against sequential decode steps is in `tests/test_torch_model.py`, the
draft's fake-quant dispatch in `tests/test_torch_kernels.py`.)
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core.quant import QuantPolicy as JPolicy
from repro.core.quant import policy_by_name as jpolicy
from repro.models import api as japi
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine

from repro_torch import configs as tconfigs
from repro_torch.core import formats as tformats
from repro_torch.core.quant import QuantPolicy as TPolicy
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.models import packing as tpacking
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

ENGINE = dict(batch_slots=2, max_seq=32, page_size=4, n_pages=24,
              prefill_buckets=(4, 1))
POLICIES = {
    # the policy of examples/serve_async.py (fake_quant, float masters)
    "fake_quant": (JPolicy(weights=jformats.P16_2, kv_cache=jformats.P8_2),
                   TPolicy(weights=tformats.P16_2, kv_cache=tformats.P8_2),
                   False),
    "serve_fused_p16": (jpolicy("serve_fused_p16"),
                        tpolicy("serve_fused_p16"), True),
}
CASES = {
    # name: (speculate_k, narrow draft, engine kw, queue kw)
    "greedy": (4, False, {}, {}),
    "sampled": (3, False, dict(greedy=False, temperature=0.9, top_k=5),
                dict(seeds=True)),
    "narrow_draft": (4, True, {}, {}),
    "eos_mid_round": (4, False, {}, dict(eos=True)),
    "budget_shorter_than_span": (4, False, {}, dict(max_new=2)),
    "interleaved_prefill": (3, False, dict(prefill_chunks_per_step=1), {}),
}
# every case under the fake_quant policy; the packed fused policy (whose
# verify takes the fused head + sampler) on the greedy, sampled and
# interleaved cases, which keeps the file's reference runs to nine
RUNS = [("fake_quant", c) for c in CASES] + [
    ("serve_fused_p16", c)
    for c in ("greedy", "sampled", "interleaved_prefill")]


def _models(policy):
    jq, tq, packed = POLICIES[policy]
    jcfg = jconfigs.get_tiny_serving("command_r_35b", jq)
    tcfg = tconfigs.get_tiny_serving("command_r_35b", tq)
    params = japi.init(jax.random.key(0), jcfg)
    if packed:
        params = japi.pack_params(params, jcfg)
    tparams = tpacking.params_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, "cpu")
    return jcfg, params, tcfg, tparams


def _jax_noise(base_seed):
    base = jax.random.key(base_seed)

    def noise_fn(seed, draw, vocab):
        key = jax.random.fold_in(jax.random.fold_in(base, seed), draw)
        return np.asarray(japi.sample_noise(key[None], vocab))[0]

    return noise_fn


def _queue(tcfg, tparams, max_new=6, eos=False, seeds=False):
    """The queue of tests/test_speculative.py: (rid, prompt, max_new, eos,
    seed).  With eos, the eos id is the first token plain decode emits
    for the first prompt, so it fires inside the first verify span."""
    if eos:
        prompt = np.arange(6, dtype=np.int32)
        probe = TEngine(tcfg, tparams, device="cpu", **ENGINE)
        probe.submit(TRequest(rid=0, prompt=prompt.copy(), max_new_tokens=1))
        eos_id = probe.run()[0].out_tokens[0]
        return [(0, prompt, 8, eos_id, None),
                (1, prompt[::-1].copy(), 8, None, None)]
    rng = np.random.default_rng(7)
    return [(rid, rng.integers(0, 60, n).astype(np.int32), max_new, None,
             100 + rid if seeds else None)
            for rid, n in enumerate((5, 9, 12))]


def _serve(engine, request_cls, queue):
    for rid, prompt, max_new, eos, seed in queue:
        engine.submit(request_cls(rid=rid, prompt=prompt.copy(),
                                  max_new_tokens=max_new, eos_id=eos,
                                  seed=seed))
    return {r.rid: list(map(int, r.out_tokens)) for r in engine.run()}


@pytest.fixture(scope="module", params=RUNS, ids=["-".join(r) for r in RUNS])
def served(request):
    policy, case = request.param
    k, narrow, kw, qkw = CASES[case]
    jcfg, jparams, tcfg, tparams = _models(policy)
    queue = _queue(tcfg, tparams, **qkw)
    kw = dict(ENGINE, **kw)
    jdraft = jcfg.quant.with_draft(weights=jformats.P8_0) if narrow else None
    tdraft = tcfg.quant.with_draft(weights=tformats.P8_0) if narrow else None
    jeng = JEngine(jcfg, jparams, speculate_k=k, draft_quant=jdraft, **kw)
    want = _serve(jeng, JRequest, queue)
    noise = _jax_noise(0)
    teng = TEngine(tcfg, tparams, speculate_k=k, draft_quant=tdraft,
                   device="cpu", noise_fn=noise, **kw)
    got = _serve(teng, TRequest, queue)
    plain = TEngine(tcfg, tparams, device="cpu", noise_fn=noise, **kw)
    plain_got = _serve(plain, TRequest, queue)
    return dict(case=case, queue=queue, want=want, got=got,
                plain=plain_got, jeng=jeng, teng=teng)


def test_streams_equal_reference_and_plain_decode(served):
    got = served["got"]
    assert got == served["want"]
    assert got == served["plain"]
    if served["case"] == "eos_mid_round":
        eos = served["queue"][0][3]
        assert got[0][-1] == eos and len(got[0]) < 8
    if served["case"] == "budget_shorter_than_span":
        assert all(len(t) == 2 for t in got.values())


def test_speculation_counters_match_reference(served):
    jeng, teng = served["jeng"], served["teng"]
    js, ts = jeng.execution_summary(), teng.execution_summary()
    assert ts["speculative"]
    # a 2-token budget leaves one decode token: the span falls back to
    # plain decode
    assert (ts["speculation_rounds"] > 0) == \
        (served["case"] != "budget_shorter_than_span")
    for key in ("speculate_k", "speculation_rounds",
                "speculation_committed_tokens", "speculation_accept_rate",
                "decode_steps", "decode_device_programs", "prefill_chunks",
                "prefill_device_programs", "preemptions"):
        assert ts[key] == js[key], key
    assert teng.allocator.total_allocs == jeng.allocator.total_allocs
    assert teng.allocator.peak_in_use == jeng.allocator.peak_in_use


def test_pool_clean_after_speculation(served):
    teng = served["teng"]
    assert teng.pages_in_use == 0 and teng.pages_free == \
        teng.allocator.capacity
    assert not teng.prefix_index and not teng._held
    assert not teng.allocator._refs


def test_speculation_ctor_validation():
    tcfg = tconfigs.get_tiny_serving("command_r_35b", POLICIES["fake_quant"][1])
    params = tpacking.params_from_numpy(
        jax.tree.map(np.asarray, japi.init(
            jax.random.key(0), jconfigs.get_tiny_serving(
                "command_r_35b", POLICIES["fake_quant"][0]))), tcfg, "cpu")
    kw = dict(batch_slots=1, max_seq=32, page_size=4, n_pages=12,
              device="cpu")
    with pytest.raises(ValueError, match="speculate_k must be >= 2"):
        TEngine(tcfg, params, speculate_k=1, **kw)
    with pytest.raises(ValueError, match="paged"):
        TEngine(tcfg, params, speculate_k=2, paged=False, batch_slots=1,
                max_seq=32, device="cpu")
    bad = dataclasses.replace(tcfg.quant.with_draft(), kv_cache=tformats.P16_2)
    with pytest.raises(ValueError, match="kv_cache format"):
        TEngine(tcfg, params, speculate_k=2, draft_quant=bad, **kw)
    dq = tcfg.quant.with_draft()
    assert dq.kv_cache == tcfg.quant.kv_cache
    assert dq.kv_page_size == tcfg.quant.kv_page_size
    assert dq.execution == "fake_quant" and dq.weights == tcfg.quant.weights
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TEngine(tcfg, params, speculate_k=2, batch_slots=1, max_seq=32)
