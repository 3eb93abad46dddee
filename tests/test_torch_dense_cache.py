"""PyTorch port vs the JAX reference: the dense (non-paged) KV cache and the
engine's public surface.

`common.decode_attention` (with and without a window, with a softcap), the
whole-sequence `prefill` that builds a dense cache and the dense
`decode_step` after it, `ServingEngine(paged=False)` (greedy streams equal
to the reference's dense engine and to the port's paged engine, also
interleaved with decode and sampled), the paged engine's streams against
the reference's paged engine on the same configs (the MoE smoke configs
among them), the MoE family's dense decode and whole-sequence prefill,
`kv_cache_bytes` / `slot_free` / `pages_promised` / `execution_summary()`
and `packing.unpack_params`.  The same numpy inputs and the reference's
own parameters go to both packages; the port runs on the CPU, the
reference jitted.  Logits are f32 sums taken in another order by the two
frameworks: rtol = atol = 1e-5, and 2e-5 after the whole-sequence forward
(its tolerance in tests/test_torch_grad.py: every row of every layer's
attention and GEMMs summed in another order).  Codes, lengths, tokens and
counters are held bitwise.
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
from repro.models import common as jcommon
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine

from repro_torch import configs as tconfigs
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import packing as tpacking
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

RTOL = ATOL = 1e-5
SEQ_TOL = 2e-5
MAX_SEQ = 48


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these sizes are too small to share out: with
    the suite's other workers busy, torch's thread pool waits on taken
    cores and a smoke-config engine run slows many times over.  Run this
    module's torch work on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, kind, policy="serve_fused_p16"):
    getter = {"tiny": "get_tiny_serving", "smoke": "get_smoke"}[kind]
    return (getattr(jconfigs, getter)(arch).replace(quant=jpolicy(policy)),
            getattr(tconfigs, getter)(arch).replace(quant=tpolicy(policy)))


@functools.lru_cache(maxsize=None)
def _params(arch, kind, policy="serve_fused_p16", seed=2):
    """(jcfg, tcfg, jparams, tparams): the reference's packed init from
    `seed` and the same leaves in the port, built once per module (the
    pack jitted: eager it takes seconds a config on the CPU)."""
    jcfg, tcfg = _cfgs(arch, kind, policy)
    jparams = jax.jit(lambda p: japi.pack_params(p, jcfg))(
        japi.init(jax.random.key(seed), jcfg))
    return jcfg, tcfg, jparams, tpacking.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (5, 0.0), (3, 30.0),
                                            (1 << 30, 0.0)])
def test_decode_attention_matches_reference(window, softcap):
    rng = np.random.default_rng(7)
    B, S, Hq, Hkv, D = 3, 24, 6, 2, 16
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    cache_len = np.array([1, 13, 24], np.int32)
    kv_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = np.asarray(jax.jit(lambda *a: jcommon.decode_attention(
        *a, window=window, softcap_val=softcap))(q, k, v, cache_len, kv_pos))
    got = tcommon.decode_attention(
        *map(torch.from_numpy, (q, k, v, cache_len, kv_pos)), window=window,
        softcap_val=softcap).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the mask is the reference's: q_pos = cache_len, kv_pos < q_pos and
    # q_pos - kv_pos <= window (row 0 sees only its one key)
    np.testing.assert_allclose(got[0, 0], np.repeat(v[0, 0], 3, 0),
                               rtol=1e-6, atol=1e-6)
    if window is not None and window < S:
        # keys outside the window do not move the output
        k2, v2 = k.copy(), v.copy()
        far = cache_len[2] - window - 1
        k2[2, :far] = 100.0
        v2[2, :far] = -100.0
        moved = tcommon.decode_attention(
            *map(torch.from_numpy, (q, k2, v2, cache_len, kv_pos)),
            window=window, softcap_val=softcap).numpy()
        np.testing.assert_array_equal(moved[2], got[2])


# ---------------------------------------------------------------------------
# whole-sequence prefill into a dense cache, then dense decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prefill_runs():
    jcfg, tcfg, jparams, tparams = _params("gemma3_4b", "smoke", seed=3)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, jcfg.vocab_size, (2, 19)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (3, 2)).astype(np.int32)
    out = {}
    jlog, jc = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, max_seq=MAX_SEQ))(
        jparams, {"tokens": jnp.asarray(toks)})
    out["j_prefill"] = np.asarray(jlog)
    out["j_cache0"] = {k: np.asarray(v) for k, v in jc.items()}
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, t, c, jcfg))
    out["j_decode"] = []
    for t in nxt:
        lg, jc = jdec(jparams, jnp.asarray(t), jc)
        out["j_decode"].append(np.asarray(lg))
    out["j_cache"] = {k: np.asarray(v) for k, v in jc.items()}

    tlog, tc = tapi.prefill(tparams, {"tokens": toks}, tcfg, max_seq=MAX_SEQ,
                            device="cpu")
    out["t_prefill"] = tlog.numpy()
    out["t_cache0"] = {k: v.numpy().copy() for k, v in tc.items()}
    out["t_decode"] = []
    for t in nxt:
        lg, tc = tapi.decode_step(tparams, torch.from_numpy(t), tc, tcfg)
        out["t_decode"].append(lg.numpy())
    out["t_cache"] = {k: v.numpy() for k, v in tc.items()}
    return out


def test_prefill_logits_and_dense_cache(prefill_runs):
    r = prefill_runs
    np.testing.assert_allclose(r["t_prefill"], r["j_prefill"], rtol=SEQ_TOL,
                               atol=SEQ_TOL)
    assert sorted(r["t_cache0"]) == sorted(r["j_cache0"]) == \
        ["k", "length", "v"]
    for name, want in r["j_cache0"].items():
        got = r["t_cache0"][name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)


def test_dense_decode_after_prefill(prefill_runs):
    r = prefill_runs
    for got, want in zip(r["t_decode"], r["j_decode"]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for name, want in r["j_cache"].items():
        np.testing.assert_array_equal(r["t_cache"][name], want)


def test_window_bites_on_dense_decode():
    """gemma3's local layers mask keys more than `sliding_window` (8 in the
    smoke config) behind the query: past the window, the dense decode's
    logits differ from a run of the same weights without windows, and
    before it they are equal."""
    _, tcfg = _cfgs("gemma3_4b", "smoke")
    params = tpacking.pack_params(
        tapi.init(torch.Generator().manual_seed(1), tcfg, device="cpu"), tcfg)
    toks = torch.arange(21, dtype=torch.int32)[None] * 7 % tcfg.vocab_size

    def logits(cfg, n):
        _, cache = tapi.prefill(params, {"tokens": toks[:, :n]}, cfg,
                                max_seq=MAX_SEQ, device="cpu")
        return tapi.decode_step(params, toks[:, n], cache, cfg)[0]

    unwindowed = tcfg.replace(sliding_window=None)
    assert torch.equal(logits(tcfg, 5), logits(unwindowed, 5))
    gap = (logits(tcfg, 20) - logits(unwindowed, 20)).abs().max()
    assert float(gap) > 1e-3


# ---------------------------------------------------------------------------
# the engine over the dense cache
# ---------------------------------------------------------------------------

QUEUE = ((3, 6), (25, 5), (9, 6), (30, 4), (17, 5))


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).astype(np.int32) for n, _ in QUEUE]


def _jax_noise(base_seed):
    base = jax.random.key(base_seed)

    def noise_fn(seed, draw, vocab):
        key = jax.random.fold_in(jax.random.fold_in(base, seed), draw)
        return np.asarray(japi.sample_noise(key[None], vocab))[0]

    return noise_fn


def _submit(engine, req_cls, prompts):
    for rid, (p, (_, new)) in enumerate(zip(prompts, QUEUE)):
        engine.submit(req_cls(rid=rid, prompt=p, max_new_tokens=new))


def _streams(engine):
    return {r.rid: list(map(int, r.out_tokens)) for r in engine.run()}


ENGINE_RUNS = {
    # name: (arch, kind, engine knobs)
    "command_r_35b-tiny": ("command_r_35b", "tiny", {}),
    "command_r_35b-smoke": ("command_r_35b", "smoke", {}),
    "command_r_plus_104b-smoke": ("command_r_plus_104b", "smoke", {}),
    "gemma3_4b-smoke": ("gemma3_4b", "smoke", {}),
    "qwen3_moe_235b-smoke": ("qwen3_moe_235b", "smoke", {}),
    "deepseek_moe_16b-smoke": ("deepseek_moe_16b", "smoke", {}),
    "command_r_35b-sampled": ("command_r_35b", "tiny",
                              dict(greedy=False, temperature=0.8, top_k=5,
                                   base_seed=9)),
}


@pytest.fixture(scope="module", params=sorted(ENGINE_RUNS))
def dense_served(request):
    """Both packages' dense and paged engines over QUEUE (the paged ones at
    the serving defaults: prefix sharing, fused prefill, fused decode)."""
    arch, kind, knobs = ENGINE_RUNS[request.param]
    jcfg, tcfg, jparams, tparams = _params(arch, kind)
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(batch_slots=2, max_seq=MAX_SEQ, **knobs)
    tkw = dict(device="cpu", noise_fn=_jax_noise(knobs.get("base_seed", 0)))
    jeng = JEngine(jcfg, jparams, paged=False, **kw)
    teng = TEngine(tcfg, tparams, paged=False, **kw, **tkw)
    # the surface before and after the first step (mid-flight), then the
    # rest of the run
    surface = []
    for eng, req in ((jeng, JRequest), (teng, TRequest)):
        _submit(eng, req, prompts)
        before = (eng.slot_free, eng.pages_promised, eng.kv_cache_bytes())
        eng.step()
        surface.append((before, eng.slot_free, eng.pages_promised,
                        eng.kv_cache_bytes(), eng.execution_summary()))
    want, got = _streams(jeng), _streams(teng)
    paged = {}
    for name, eng, req in (("want", JEngine(jcfg, jparams, **kw), JRequest),
                           ("got", TEngine(tcfg, tparams, **kw, **tkw),
                            TRequest)):
        _submit(eng, req, prompts)
        paged[name] = _streams(eng)
    return dict(want=want, got=got, paged=paged["got"],
                paged_want=paged["want"], jeng=jeng, teng=teng,
                surface=surface)


def test_dense_engine_streams_match_reference(dense_served):
    assert sorted(dense_served["got"]) == list(range(len(QUEUE)))
    assert all(len(dense_served["got"][i]) == n
               for i, (_, n) in enumerate(QUEUE))
    assert dense_served["got"] == dense_served["want"]


def test_dense_engine_streams_equal_paged_engine(dense_served):
    assert dense_served["got"] == dense_served["paged"]


def test_paged_engine_streams_match_reference(dense_served):
    assert sorted(dense_served["paged"]) == list(range(len(QUEUE)))
    assert dense_served["paged"] == dense_served["paged_want"]


def test_dense_engine_surface_matches_reference(dense_served):
    (jb, jfree, jprom, jbytes, js), (tb, tfree, tprom, tbytes, ts) = \
        dense_served["surface"]
    assert tb == jb
    assert (tfree, tprom, tbytes) == (jfree, jprom, jbytes)
    assert tfree.count(False) > 0
    for key, val in js.items():
        assert ts[key] == val, key
    assert ts["paged"] is False and ts["kv_shards"] == 1
    assert ts["pages_in_use_by_shard"] is None and ts["page_size"] is None
    assert not ts["prefix_sharing"] and not ts["fused_prefill"] \
        and not ts["fused_decode"]


def test_dense_engine_counters_and_bytes_after_run(dense_served):
    jeng, teng = dense_served["jeng"], dense_served["teng"]
    js, ts = jeng.execution_summary(), teng.execution_summary()
    for key, val in js.items():
        assert ts[key] == val, key
    assert teng.stats["prefill_batch_sizes"] == \
        jeng.stats["prefill_batch_sizes"]
    assert teng.kv_cache_summary() == jeng.kv_cache_summary()
    cfg = teng.cfg
    F = cfg.n_kv_heads * cfg.head_dim
    rows = 2 * cfg.n_layers * teng.B * teng.S * F
    assert teng.kv_cache_bytes() == \
        rows * teng.cache["k"].element_size() + 4 * teng.B
    assert teng.slot_free == [True] * teng.B and teng.pages_promised == 0


def test_dense_engine_interleaved_equals_whole_prompt_admission():
    """A prefill chunk per request per step interleaved with decode (the
    decode pass leaves the filling slots' rows unwritten) gives the streams
    of whole-prompt admission and of the paged engine."""
    _, tcfg = _cfgs("gemma3_4b", "smoke")
    params = tpacking.pack_params(
        tapi.init(torch.Generator().manual_seed(3), tcfg, device="cpu"), tcfg)
    prompts = _prompts(tcfg.vocab_size)
    out = []
    for kw in (dict(paged=False, prefill_chunks_per_step=1),
               dict(paged=False), dict(prefill_chunks_per_step=1)):
        eng = TEngine(tcfg, params, batch_slots=2, max_seq=MAX_SEQ,
                      device="cpu", **kw)
        _submit(eng, TRequest, prompts)
        out.append(_streams(eng))
    assert out[0] == out[1] == out[2]
    assert sorted(out[0]) == list(range(len(QUEUE)))


def test_paged_engine_surface_matches_reference():
    """kv_cache_bytes / slot_free / pages_promised (an oversubscribed pool,
    so requests wait in the queue) and execution_summary()'s kv_shards /
    pages_in_use_by_shard, before, during and after a run."""
    jcfg, tcfg, jparams, tparams = _params("command_r_35b", "tiny")
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(batch_slots=2, max_seq=MAX_SEQ, page_size=4, n_pages=14)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = TEngine(tcfg, tparams, device="cpu", **kw)
    for eng, req in ((jeng, JRequest), (teng, TRequest)):
        _submit(eng, req, prompts)
    for _ in range(4):
        assert teng.slot_free == jeng.slot_free
        assert teng.pages_promised == jeng.pages_promised
        assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()
        assert teng.allocator.pages_in_use_by_shard == \
            jeng.allocator.pages_in_use_by_shard
        js, ts = jeng.execution_summary(), teng.execution_summary()
        for key, val in js.items():
            assert ts[key] == val, key
        jeng.step()
        teng.step()
    assert teng.execution_summary()["pages_in_use_by_shard"] == \
        [teng.pages_in_use] and teng.pages_in_use > 0
    assert _streams(teng) == _streams(jeng)


def test_dense_engine_rejects_speculation_and_unported_mesh():
    _, tcfg = _cfgs("command_r_35b", "tiny")
    params = tapi.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        TEngine(tcfg, params, batch_slots=1, max_seq=32, paged=False,
                speculate_k=2, device="cpu")
    # sharded pools are ported (test_torch_sharded.py): the dense cache
    # ignores a mesh, as the reference's engine does, and refuses what is
    # not one
    from repro_torch.launch.mesh import make_serving_mesh
    eng = TEngine(tcfg, params, batch_slots=1, max_seq=32, paged=False,
                  mesh=make_serving_mesh(2, devices=["cpu", "cpu"]),
                  device="cpu")
    assert eng.n_shards == 1 and eng.mesh is None and not eng.paged
    with pytest.raises(TypeError, match="Mesh"):
        TEngine(tcfg, params, batch_slots=1, max_seq=32, paged=False,
                mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# the MoE family on the dense cache
# ---------------------------------------------------------------------------


def test_moe_dense_decode_matches_reference():
    """qwen3-moe's tiny serving config: a batched chunk prefill and two
    decode steps over the dense cache, logits and codes against the
    reference; then the whole-sequence `prefill` of the same tokens (the
    MoE whole-sequence forward) against the reference's, its codes
    bitwise."""
    jcfg, tcfg, jparams, tparams = _params("qwen3_moe_235b", "tiny", seed=6)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (2, 2)).astype(np.int32)
    jc = japi.init_cache(jcfg, 2, MAX_SEQ)
    tc = tapi.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    jl, jc = jax.jit(lambda p, t, c, a: japi.prefill_chunk_batched(
        p, t, c, a, jcfg))(jparams, jnp.asarray(toks), jc,
                           jnp.ones((2,), bool))
    tl, tc = tapi.prefill_chunk_batched(tparams, torch.from_numpy(toks), tc,
                                        torch.ones(2, dtype=torch.bool), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, t, c, jcfg))
    for t in nxt:
        jl, jc = jdec(jparams, jnp.asarray(t), jc)
        tl, tc = tapi.decode_step(tparams, torch.from_numpy(t), tc, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
    for name in ("k", "v", "length"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    jl, jc = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, max_seq=MAX_SEQ))(
        jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tapi.prefill(tparams, {"tokens": toks}, tcfg, max_seq=MAX_SEQ,
                          device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=SEQ_TOL,
                               atol=SEQ_TOL)
    for name in ("k", "v", "length"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


# ---------------------------------------------------------------------------
# unpack_params, cache specs and the device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,policy,dtype", [
    ("command_r_35b", "serve_fused_p16", "float32"),
    ("gemma3_4b", "serve_paged_p16", "bfloat16"),
    ("qwen3_moe_235b", "serve_fused_p16", "float32")])
def test_unpack_params_bitwise(arch, policy, dtype):
    jcfg, tcfg, jparams, tparams = _params(arch, "tiny", policy, seed=5)
    want = jax.jit(lambda p: japi.unpack_params(
        p, jcfg, dtype=getattr(jnp, dtype)))(jparams)
    got = tapi.unpack_params(tparams, tcfg, dtype=getattr(torch, dtype))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        node = got
        for key in path:
            node = node[key.key]
        w = np.asarray(w)
        g = node.float().numpy() if node.dtype == torch.bfloat16 \
            else node.numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w.astype(np.float32)
                                      if w.dtype != np.float32 and
                                      g.dtype == np.float32 else w)
    # packing the unpacked f32 values gives the codes back
    if dtype == "float32":
        again = tpacking.pack_params(got, tcfg)
        for path in tpacking.packable_paths(tcfg):
            a, b = again, tparams
            for key in path:
                a, b = a[key], b[key]
            assert torch.equal(a, b)


def test_dense_cache_specs_match_reference():
    for arch in ("command_r_35b", "gemma3_4b", "qwen3_moe_235b"):
        jcfg, tcfg = _cfgs(arch, "smoke")
        js = japi.cache_specs(jcfg, 3, 40)
        ts = tapi.cache_specs(tcfg, 3, 40)
        assert sorted(ts) == sorted(js)
        for name in js:
            assert ts[name].shape == js[name].shape, (arch, name)
            assert ts[name].logical_axes == js[name].logical_axes
            assert str(ts[name].dtype).replace("torch.", "") == \
                np.dtype(js[name].dtype).name
        cache = tapi.init_cache(tcfg, 3, 40, device="cpu")
        assert all(float(t.abs().sum()) == 0 for t in cache.values())


def test_dense_entry_points_take_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg = _cfgs("command_r_35b", "tiny")
    params = tapi.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tcfg, params, batch_slots=2, max_seq=32, paged=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_cache(tcfg, 2, 32, layout=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.prefill(params, {"tokens": np.zeros((1, 4), np.int32)}, tcfg)
    logits, cache = tapi.prefill(params, {"tokens": np.zeros((1, 4),
                                                             np.int32)},
                                 tcfg, device="cpu")
    assert logits.shape == (1, 4, tcfg.vocab_size)
    assert cache["k"].shape[2] == 4 and int(cache["length"][0]) == 4
    assert dataclasses.is_dataclass(tcfg)


def test_serving_example_runs_on_cpu(monkeypatch, capsys):
    """examples/serve_posit_lm_torch.py at a small size with device="cpu":
    every request served, the activation-coded rerun too, the reference
    example's lines printed (the launch counts in place of the autotune
    report)."""
    import importlib.util
    import os
    monkeypatch.setenv("SERVE_DEMO_REQUESTS", "3")
    monkeypatch.setenv("SERVE_DEMO_TOKENS", "3")
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "serve_posit_lm_torch.py")
    spec = importlib.util.spec_from_file_location("serve_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    done, done_act = mod.main("cpu")
    assert len(done) == 3 and len(done_act) == 3
    assert all(len(r.out_tokens) == 3 for r in done + done_act)
    out = capsys.readouterr().out
    for line in ("weights:", "mid-flight:", "per-device page occupancy",
                 "prefix sharing:", "fused prefill: on", "fused decode: on",
                 "kernel launches this run", "activation-coded plan:"):
        assert line in out, line
