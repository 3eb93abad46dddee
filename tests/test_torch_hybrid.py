"""PyTorch port vs the JAX reference: the hybrid family
(`models/hybrid.py`, jamba-1.5-large: attention + mamba periods with MoE
every other layer) and its serving with recurrent-state snapshots under
prefix sharing.

Module level, at the smoke config (two periods of 2 layers, ssm_chunk 8),
P(16,2)-packed and float: `apply` (with the cache and the MoE aux loss),
the whole-prompt `prefill`, `prefill_chunk_batched` and `prefill_chunk`
over the paged cache (fused prefill) and the dense one,
`decode_step` paged, dense and fused with the sampler, and chunked
prefill's states against the whole prompt's.  Engine level, at
`get_tiny_serving` with pages of 4: greedy streams and sampled ones (the
reference's gumbel noise injected) against the reference engine at the
defaults (prefix sharing, fused prefill, fused decode), paged == dense,
interleaved prefill == prefill at admission, prefix sharing == unshared
serving (shared admissions from state snapshots, fewer fresh pages, a
clean pool), fused prefill == decomposed, the bucket filter and the
speculation refusal.  The port runs on the CPU (every kernel's plain
version), the reference jitted (its Pallas kernels in interpret mode).

Tolerances as tests/test_torch_ssm.py: the SSD's states to SSD_TOL =
1e-5 times the largest |value|, logits rtol = atol = 2e-5; KV codes,
tokens and lengths bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.quant import policy_by_name as jpolicy
from repro.models import api as japi
from repro.models.paged import PagedLayout as JLayout
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine

from repro_torch import configs as tconfigs
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.models import api as tapi
from repro_torch.models import packing as tpacking
from repro_torch.models.paged import PagedLayout as TLayout
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

ARCH = "jamba_1_5_large"
SSD_TOL = 1e-5
RTOL = ATOL = 2e-5
MAX_SEQ = 48
PAGE = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: run this module's torch work on one thread (torch's
    pool stalls when the suite's other workers hold the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scaled_close(got, want, tol=SSD_TOL):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    gap = np.abs(got - want).max()
    assert gap <= tol * np.abs(want).max(), (gap, np.abs(want).max())


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _cfgs(kind="smoke", policy="serve_fused_p16", fused_prefill=True):
    getter = {"tiny": "get_tiny_serving", "smoke": "get_smoke"}[kind]
    jq = dataclasses.replace(jpolicy(policy), fused_prefill=fused_prefill)
    tq = dataclasses.replace(tpolicy(policy), fused_prefill=fused_prefill)
    return (getattr(jconfigs, getter)(ARCH).replace(quant=jq),
            getattr(tconfigs, getter)(ARCH).replace(quant=tq))


@functools.lru_cache(maxsize=None)
def _params(kind="smoke", seed=1, packed=True):
    """(jparams, tparams): the reference's init from `seed` (packed to
    P(16,2) codes when asked) and the same leaves in the port."""
    jcfg, tcfg = _cfgs(kind)

    def init(key):
        p = japi.init(key, jcfg)
        return japi.pack_params(p, jcfg) if packed else p

    jparams = jax.jit(init)(jax.random.key(seed))
    return jparams, tpacking.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return {k: np.array(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# parameters and the whole-sequence forward
# ---------------------------------------------------------------------------


def test_packing_paths_and_param_tree_match_reference():
    from repro.models import packing as jpacking
    jcfg, tcfg = _cfgs()
    assert tpacking.packable_paths(tcfg) == jpacking.packable_paths(jcfg)
    jparams, tparams = _params(packed=False)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda p: japi.pack_params(p, jcfg))(jparams))
    got = tpacking.pack_params(tparams, tcfg)
    for path in tpacking.packable_paths(tcfg):
        w, g = want, got
        for k in path:
            w, g = w[k], g[k]
        assert g.dtype == torch.int16 and g.shape == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w)
    # routers, conv taps and the scan's parameters stay float
    for sub, name in (("moe", "router"), ("mamba", "conv_w"),
                      ("mamba", "A_log")):
        np.testing.assert_array_equal(got["blocks"][sub][name].numpy(),
                                      want["blocks"][sub][name])
    back = tpacking.unpack_params(got, tcfg)
    unpacked = jax.jit(lambda p: jpacking.unpack_params(p, jcfg))(want)
    for sub, name in (("moe", "we_up"), ("mamba", "in_proj")):
        np.testing.assert_array_equal(back["blocks"][sub][name].numpy(),
                                      np.asarray(unpacked["blocks"][sub][name]))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "float"])
def test_apply_and_prefill_match_reference(packed):
    """`apply` with the cache and the aux loss, and the whole-prompt
    `prefill` into the dense cache (codes bitwise, states to SSD_TOL)."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(packed=packed)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jkv, jaux = jax.jit(lambda p, b: japi.apply(
        p, b, jcfg, collect_cache=True, with_aux=True))(
        jparams, {"tokens": jnp.asarray(toks)})
    tl, tkv, taux = tapi.apply(tparams, {"tokens": _t(toks)}, tcfg,
                               collect_cache=True, with_aux=True)
    _close(tl.numpy(), jl)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert len(tkv) == 2
    for b, (k, v) in enumerate(tkv):
        _close(k.numpy(), jkv[0][b])
        _close(v.numpy(), jkv[1][b])
    jl, jc = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, max_seq=MAX_SEQ))(
        jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tapi.prefill(tparams, {"tokens": toks}, tcfg, max_seq=MAX_SEQ,
                          device="cpu")
    _close(tl.numpy(), jl)
    jc, tc = _np(jc), _np(tc)
    assert sorted(tc) == sorted(jc)
    for name in ("k", "v", "length"):
        assert tc[name].dtype == jc[name].dtype
        np.testing.assert_array_equal(tc[name], jc[name])
    for name in ("conv", "ssm"):
        _scaled_close(tc[name], jc[name])


# ---------------------------------------------------------------------------
# chunked prefill and decode over both caches
# ---------------------------------------------------------------------------

PROMPT = 24   # a batched 16-token chunk, then 4 + 4 per slot


def _serving_run(pkg, cfg, params, toks, nxt, paged):
    """One package's run: batched chunk, per-slot chunks, a decode step and
    a fused decode-and-sample (paged) over a cache of 2 slots."""
    j = pkg == "jax"
    B = 2
    out = {}
    if paged:
        layout = (JLayout if j else TLayout).for_slots(B, MAX_SEQ, PAGE)
        bt = np.zeros((B, layout.pages_per_slot(MAX_SEQ)), np.int32)
        bt[0, :7] = [3, 1, 5, 7, 9, 11, 13]
        bt[1, :7] = [2, 4, 6, 8, 10, 12, 14]
    else:
        layout = None
    if j:
        cache = dict(japi.init_cache(cfg, B, MAX_SEQ, layout))
        if paged:
            cache["block_table"] = jnp.asarray(bt)
        batched = jax.jit(lambda p, t, c, a: japi.prefill_chunk_batched(
            p, t, c, a, cfg))
        chunk = jax.jit(lambda p, t, c, s: japi.prefill_chunk(p, t, c, s, cfg))
        dec = jax.jit(lambda p, t, c: japi.decode_step(p, t, c, cfg))
        lg, cache = batched(params, jnp.asarray(toks[:, :16]), cache,
                            jnp.ones((B,), bool))
        out["batched"] = np.asarray(lg)
        out["chunks"] = []
        for lo in (16, 20):
            for s in (0, 1):
                lg, cache = chunk(params, jnp.asarray(toks[s:s + 1, lo:lo + 4]),
                                  cache, jnp.int32(s))
                out["chunks"].append(np.asarray(lg))
        out["prefilled"] = _np(cache)
        lg, new = dec(params, jnp.asarray(nxt), cache)
        out["decode"] = np.asarray(lg)
        out["decoded"] = _np(new)
        if paged:
            tok, _ = jax.jit(lambda p, t, c: japi.decode_and_sample(
                p, t, c, cfg, None, jnp.float32(1.0), greedy=True, top_k=0))(
                params, jnp.asarray(nxt), cache)
            out["tok"] = np.asarray(tok)
        return out
    cache = tapi.init_cache(cfg, B, MAX_SEQ, layout, device="cpu")
    if paged:
        cache["block_table"] = _t(bt)
    lg, cache = tapi.prefill_chunk_batched(params, _t(toks[:, :16]), cache,
                                           torch.ones(B, dtype=torch.bool), cfg)
    out["batched"] = lg.numpy()
    out["chunks"] = []
    for lo in (16, 20):
        for s in (0, 1):
            lg, cache = tapi.prefill_chunk(params, _t(toks[s:s + 1, lo:lo + 4]),
                                           cache, s, cfg)
            out["chunks"].append(lg.numpy())
    out["prefilled"] = _np(cache)
    snap = {k: v.clone() for k, v in cache.items()}
    lg, new = tapi.decode_step(params, _t(nxt), cache, cfg)
    out["decode"] = lg.numpy()
    out["decoded"] = _np(new)
    if paged:
        for k, v in snap.items():   # the decode wrote in place: roll back
            cache[k].copy_(v)
        tok, _ = tapi.decode_and_sample(params, _t(nxt), cache, cfg, None,
                                        1.0, greedy=True, top_k=0)
        out["tok"] = tok.numpy()
    return out


SERVING_RUNS = {
    "paged-fused": dict(paged=True, fused_prefill=True, packed=True),
    "dense-float": dict(paged=False, fused_prefill=True, packed=False),
}


@pytest.fixture(scope="module", params=sorted(SERVING_RUNS))
def serving_runs(request):
    run = SERVING_RUNS[request.param]
    jcfg, tcfg = _cfgs(fused_prefill=run["fused_prefill"])
    jparams, tparams = _params(packed=run["packed"])
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
    return dict(run, name=request.param,
                want=_serving_run("jax", jcfg, jparams, toks, nxt, run["paged"]),
                got=_serving_run("torch", tcfg, tparams, toks, nxt,
                                 run["paged"]))


def _cache_equal(got, want, paged):
    assert sorted(got) == sorted(want)
    for name in ("k", "v"):
        # pages: page 0 is the trash page, written by nothing here
        g, w = (got[name][:, 1:], want[name][:, 1:]) if paged else \
            (got[name], want[name])
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got["length"], want["length"])
    for name in ("conv", "ssm"):
        _scaled_close(got[name], want[name])


def test_prefill_chunks_match_reference(serving_runs):
    got, want = serving_runs["got"], serving_runs["want"]
    _close(got["batched"], want["batched"])
    for g, w in zip(got["chunks"], want["chunks"]):
        _close(g, w)
    _cache_equal(got["prefilled"], want["prefilled"], serving_runs["paged"])


def test_decode_step_matches_reference(serving_runs):
    got, want = serving_runs["got"], serving_runs["want"]
    _close(got["decode"], want["decode"])
    _cache_equal(got["decoded"], want["decoded"], serving_runs["paged"])
    if serving_runs["paged"]:
        np.testing.assert_array_equal(got["tok"], want["tok"])
        np.testing.assert_array_equal(got["tok"], got["decode"].argmax(-1))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_chunked_states_equal_whole_prompt_states(paged):
    """Over float KV (the chunks then attend the values the whole prompt
    attends; coded KV would round the history), 16 + 4 + 4 chunks carry
    the states the whole 24-token prompt leaves, and the last chunk's
    logits are the whole prompt's last position's."""
    _, tcfg = _cfgs()
    tcfg = tcfg.replace(quant=dataclasses.replace(tcfg.quant, kv_cache=None))
    _, tparams = _params()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    nxt = rng.integers(0, tcfg.vocab_size, (2,)).astype(np.int32)
    chunked = _serving_run("torch", tcfg, tparams, toks, nxt, paged)
    logits, whole = tapi.prefill(tparams, {"tokens": toks}, tcfg,
                                 max_seq=MAX_SEQ, device="cpu")
    for name in ("conv", "ssm"):
        _scaled_close(chunked["prefilled"][name], whole[name].numpy())
    np.testing.assert_array_equal(chunked["prefilled"]["length"],
                                  whole["length"].numpy())
    _close(chunked["chunks"][-1][0, 0], logits[1, -1].numpy())


# ---------------------------------------------------------------------------
# the engine at get_tiny_serving
# ---------------------------------------------------------------------------


def _jax_noise(base_seed):
    base = jax.random.key(base_seed)

    def noise_fn(seed, draw, vocab):
        key = jax.random.fold_in(jax.random.fold_in(base, seed), draw)
        return np.asarray(japi.sample_noise(key[None], vocab))[0]

    return noise_fn


@pytest.fixture(scope="module")
def tiny():
    """Prompts sharing an 8-token prefix (two pages), an exact duplicate and
    an unrelated one."""
    jcfg, tcfg = _cfgs("tiny")
    jparams, tparams = _params("tiny", seed=0)
    rng = np.random.default_rng(1)
    base = rng.integers(0, jcfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([base, rng.integers(0, jcfg.vocab_size, t)
                               .astype(np.int32)]) for t in (3, 5, 9)]
    prompts.append(prompts[0].copy())
    prompts.append(rng.integers(0, jcfg.vocab_size, 11).astype(np.int32))
    return jcfg, tcfg, jparams, tparams, prompts


def _serve(engine, req_cls, prompts, max_new=5):
    for rid, p in enumerate(prompts):
        engine.submit(req_cls(rid=rid, prompt=p, max_new_tokens=max_new))
    return {r.rid: list(map(int, r.out_tokens)) for r in engine.run()}


ENGINE_KW = dict(batch_slots=2, max_seq=32, page_size=PAGE,
                 prefill_buckets=(4, 1))


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_engine_streams_match_reference(tiny, greedy):
    """At the defaults (prefix sharing, fused prefill, fused decode):
    equal streams, sharing counters and allocator totals, a clean pool."""
    jcfg, tcfg, jparams, tparams, prompts = tiny
    kw = dict(ENGINE_KW, greedy=greedy, temperature=0.8, top_k=5,
              base_seed=7)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = TEngine(tcfg, tparams, noise_fn=None if greedy else _jax_noise(7),
                   device="cpu", **kw)
    want, got = _serve(jeng, JRequest, prompts), _serve(teng, TRequest, prompts)
    assert got == want
    assert sorted(got) == list(range(len(prompts)))
    summary = teng.execution_summary()
    assert summary["fused_decode"] and summary["fused_prefill"] \
        and summary["prefix_sharing"]
    for k in ("shared_admissions", "pages_shared", "cow_forks",
              "prefill_batch_sizes"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["shared_admissions"] >= 2
    assert teng.allocator.total_allocs == jeng.allocator.total_allocs
    assert teng.kv_cache_summary() == jeng.kv_cache_summary()
    assert teng.pages_in_use == 0


def test_engine_paged_dense_interleaved_and_fused_agree(tiny):
    """The same streams from: the defaults, the dense cache, interleaved
    prefill (the decode steps leave a filling slot's states alone),
    decomposed prefill, and slot-by-slot prefill."""
    _, tcfg, _, tparams, prompts = tiny
    out = {}
    for name, kw in (("defaults", {}), ("dense", dict(paged=False)),
                     ("interleaved", dict(prefill_chunks_per_step=1)),
                     ("decomposed", dict(fused_prefill=False)),
                     ("per-slot", dict(batched_prefill=False))):
        eng = TEngine(tcfg, tparams, device="cpu", **dict(ENGINE_KW, **kw))
        assert eng.paged is (name != "dense")
        out[name] = _serve(eng, TRequest, prompts)
        if eng.paged:
            assert eng.pages_in_use == 0
    assert all(v == out["defaults"] for v in out.values()), out


def test_prefix_sharing_equals_unshared_serving(tiny):
    """Requests sharing the 8-token prefix map the donor's pages and start
    from its state snapshot at the page boundary: the streams of unshared
    serving, from fewer fresh pages; no partially-filled tail page is
    shared (a recurrent state has no snapshot inside a page); the pool,
    the holds and the index drain."""
    _, tcfg, _, tparams, prompts = tiny
    shared_eng = TEngine(tcfg, tparams, device="cpu", **ENGINE_KW)
    unshared_eng = TEngine(tcfg, tparams, device="cpu", prefix_sharing=False,
                           **ENGINE_KW)
    shared = _serve(shared_eng, TRequest, prompts)
    assert shared == _serve(unshared_eng, TRequest, prompts)
    assert shared_eng.stats["shared_admissions"] >= 2
    assert shared_eng.stats["pages_shared"] >= 4
    assert shared_eng.stats["cow_forks"] == 0
    assert shared_eng.allocator.total_allocs < \
        unshared_eng.allocator.total_allocs
    assert shared_eng.pages_in_use == 0 and not shared_eng.prefix_index \
        and not shared_eng._held


def test_engine_buckets_and_speculation_refusal(tiny):
    jcfg, tcfg, jparams, tparams, _ = tiny
    kw = dict(batch_slots=1, max_seq=32, prefill_buckets=(48, 12, 4))
    assert TEngine(tcfg, tparams, device="cpu", **kw).prefill_buckets == \
        JEngine(jcfg, jparams, **kw).prefill_buckets == (48, 4, 1)
    with pytest.raises(ValueError, match="recurrent"):
        TEngine(tcfg, tparams, batch_slots=2, max_seq=32, speculate_k=2,
                device="cpu")
    with pytest.raises(NotImplementedError, match="verify"):
        tapi.decode_verify(tparams, None, None, tcfg, None, 1.0, greedy=True,
                           top_k=0)


# ---------------------------------------------------------------------------
# engine paths no other test compares for this family: preempt / cancel
# mid-run (greedy, sampled, interleaved prefill, the dense cache), a13 on
# the paged and the dense cache, validate_bit_exact, serve_paged_p16 /
# serve_p16_kv8, the float policy
# ---------------------------------------------------------------------------

# name: (policy, engine knobs, preempt / cancel script).  Each run pairs a
# policy with a scheduler path.
RECURRENT_PATHS = {
    "a13_preempt_cancel": ("serve_fused_p16_a13", {}, True),
    "a13_dense_preempt_cancel": ("serve_fused_p16_a13", dict(paged=False),
                                 True),
    # the PDPU GEMM on the CPU is slow: three requests
    "bit_exact": ("validate_bit_exact", {}, False),
    "paged_p16_sampled_preempt_cancel": ("serve_paged_p16", dict(
        greedy=False, temperature=0.8, top_k=5, base_seed=7), True),
    "p16_kv8_interleaved_preempt_cancel": ("serve_p16_kv8", dict(
        prefill_chunks_per_step=1), True),
    "none": ("none", {}, False),
}


@functools.lru_cache(maxsize=None)
def _policy_params(policy):
    """The reference's tiny init (packed to the policy's weight codes when
    it has them) and the same leaves in the port."""
    jcfg, tcfg = _cfgs("tiny", policy)

    def init(key):
        p = japi.init(key, jcfg)
        return japi.pack_params(p, jcfg) if jcfg.quant.weights else p

    jparams = jax.jit(init)(jax.random.key(0))
    return jcfg, tcfg, jparams, tpacking.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _scripted(engine, req_cls, prompts, script, max_new=5):
    """Serve `prompts`; with `script`, after one step preempt slot 0 and
    cancel the request queued last.  Returns (streams, (the preempted rid,
    the cancelled rid, the queue after both))."""
    for rid, p in enumerate(prompts):
        engine.submit(req_cls(rid=rid, prompt=p, max_new_tokens=max_new))
    calls = None
    if script:
        engine.step()
        pre = engine.preempt(0)
        last = engine.queue[-1].rid
        assert engine.cancel(last)
        calls = (pre.rid, last, [r.rid for r in engine.queue])
    return {r.rid: list(map(int, r.out_tokens)) for r in engine.run()}, calls


@pytest.mark.parametrize("name", sorted(RECURRENT_PATHS))
def test_engine_paths_match_reference(tiny, name):
    policy, knobs, script = RECURRENT_PATHS[name]
    jcfg, tcfg, jparams, tparams = _policy_params(policy)
    # whole 4-token chunks only (one prefill program a run): the 8-token
    # prefix plus 4 or 8 tokens, a duplicate, an unrelated prompt
    base = tiny[4][0][:8]
    rng = np.random.default_rng(5)
    prompts = [np.concatenate([base, rng.integers(0, jcfg.vocab_size, n)
                               .astype(np.int32)]) for n in (4, 8)]
    prompts += [prompts[0].copy(),
                rng.integers(0, jcfg.vocab_size, 12).astype(np.int32)]
    if policy == "validate_bit_exact":
        prompts = prompts[:3]
    kw = dict(ENGINE_KW, **knobs)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = TEngine(tcfg, tparams, device="cpu",
                   noise_fn=_jax_noise(kw.get("base_seed", 0)), **kw)
    want = _scripted(jeng, JRequest, prompts, script)
    got = _scripted(teng, TRequest, prompts, script)
    assert got == want
    assert teng.stats == jeng.stats
    assert teng.kv_cache_summary() == jeng.kv_cache_summary()
    if teng.paged:
        assert teng.pages_in_use == 0 and not teng._held
