"""PyTorch port vs the JAX reference: the MoE family (`models/moe.py`)
over the paged serving path, its packing, and MoE serving through the
engine.

Both packages get the same numpy inputs and the reference's own
parameters (JAX init -> numpy -> `packing.params_from_numpy`).  The port
runs on the CPU (`device="cpu"`: every kernel's plain version, K9's among
them); the reference runs its Pallas kernels in interpret mode.

Tolerances: logits are f32 sums taken in another order by the two
frameworks (XLA vs PyTorch CPU matmul, softmax and silu), held to
rtol = atol = 2e-5 as the dense model's in `tests/test_torch_model.py`.
Routing is discrete, so a choice could only flip at a near-tie of two
router probabilities; the inputs here are random and none is that close.
KV pages, packed codes and tokens are held bitwise.
"""
import dataclasses

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
from repro_torch.models import moe as tmoe
from repro_torch.models import packing as tpacking
from repro_torch.models.paged import PagedLayout as TLayout
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

RTOL = ATOL = 2e-5
MAX_SEQ = 48


def _cfgs(name, kind="smoke", policy="serve_fused_p16", **kw):
    getter = {"tiny": "get_tiny_serving", "smoke": "get_smoke"}[kind]
    jcfg = getattr(jconfigs, getter)(name)
    tcfg = getattr(tconfigs, getter)(name)
    jq = dataclasses.replace(jpolicy(policy), fused_prefill=False)
    tq = dataclasses.replace(tpolicy(policy), fused_prefill=False)
    return jcfg.replace(quant=jq, **kw), tcfg.replace(quant=tq, **kw)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _init(jcfg, seed, packed=True):
    """The reference's parameters (packed to posit codes when asked)."""
    def init(key):
        p = japi.init(key, jcfg)
        return japi.pack_params(p, jcfg) if packed else p
    return jax.jit(init)(jax.random.key(seed))


def test_configs_match_reference():
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "vocab_size", "rope_theta", "tie_embeddings", "dtype",
              "qk_norm", "n_experts", "n_shared_experts", "top_k", "moe_d_ff",
              "capacity_factor", "family")
    for name in ("qwen3_moe_235b", "deepseek_moe_16b"):
        for getter in ("get", "get_smoke"):
            j = getattr(jconfigs, getter)(name)
            t = getattr(tconfigs, getter)(name)
            for f in fields:
                assert getattr(t, f) == getattr(j, f), (name, getter, f)
    j = jconfigs.get_tiny_serving("qwen3_moe_235b")
    t = tconfigs.get_tiny_serving("qwen3_moe_235b")
    for f in fields:
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("name", ["qwen3_moe_235b", "deepseek_moe_16b"])
@pytest.mark.parametrize("grouped", [False, True], ids=["sorted", "gshard"])
def test_moe_ffn_matches_reference(name, grouped):
    """The routed FFN alone (router, top-k, capacity dispatch, experts,
    combine, shared experts) on float masters under fake_quant, at a
    capacity that drops choices (capacity_factor 0.5), so the drop row
    and the zero contributions are exercised."""
    from repro.models import moe as jmoe
    jcfg, tcfg = _cfgs(name, policy="paper_mixed", moe_grouped_dispatch=grouped,
                       capacity_factor=0.5)
    jparams = japi.init(jax.random.key(1), jcfg)
    p_j = jax.tree.map(lambda a: a[0], jparams["layers"])
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in p_j.items()}
    x = np.random.default_rng(2).normal(0, 1, (3, 6, jcfg.d_model)) \
        .astype(np.float32)
    want, jaux = jax.jit(lambda p, v: jmoe.moe_ffn(p, v, jcfg))(
        p_j, jnp.asarray(x))
    got, taux = tmoe.moe_ffn(p_t, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _run_both(name, packed, grouped, policy="serve_fused_p16"):
    """Prefill two slots by a batched chunk, then a decode step and a
    fused decode-and-sample step, in both packages."""
    jcfg, tcfg = _cfgs(name, policy=policy, moe_grouped_dispatch=grouped)
    jparams = _init(jcfg, 3, packed)
    tparams = tpacking.params_from_numpy(_numpy_tree(jparams), tcfg, "cpu")
    B, C = 2, 5
    ps = jcfg.quant.kv_page_size
    jl = JLayout.for_slots(B, MAX_SEQ, ps)
    tl = TLayout.for_slots(B, MAX_SEQ, ps)
    rng = np.random.default_rng(11)
    bt = np.zeros((B, jl.pages_per_slot(MAX_SEQ)), np.int32)
    bt[0, :2] = [3, 1]
    bt[1, :2] = [2, 4]
    toks = rng.integers(0, jcfg.vocab_size, (B, C)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (B,)).astype(np.int32)
    out = {}

    jc = dict(japi.init_cache(jcfg, B, MAX_SEQ, jl), block_table=jnp.asarray(bt))
    jlog, jc = jax.jit(lambda p, t, c: japi.prefill_chunk_batched(
        p, t, c, jnp.ones((B,), bool), jcfg))(jparams, jnp.asarray(toks), jc)
    out["j_prefill"] = np.asarray(jlog)
    out["j_pages"] = (np.asarray(jc["k"]), np.asarray(jc["v"]))
    jlog2, _ = jax.jit(lambda p, t, c: japi.decode_step(p, t, c, jcfg))(
        jparams, jnp.asarray(nxt), jc)
    out["j_decode"] = np.asarray(jlog2)
    jtok, _ = jax.jit(lambda p, t, c: japi.decode_and_sample(
        p, t, c, jcfg, None, jnp.float32(1.0), greedy=True, top_k=0))(
        jparams, jnp.asarray(nxt), jc)
    out["j_tok"] = np.asarray(jtok)

    tc = tapi.init_cache(tcfg, B, MAX_SEQ, tl, device="cpu")
    tc["block_table"] = torch.from_numpy(bt)
    tlog, tc = tapi.prefill_chunk_batched(
        tparams, torch.from_numpy(toks), tc, torch.ones(B, dtype=torch.bool),
        tcfg)
    out["t_prefill"] = tlog.numpy()
    out["t_pages"] = (tc["k"].numpy().copy(), tc["v"].numpy().copy())
    k0, v0 = tc["k"].clone(), tc["v"].clone()
    tlog2, _ = tapi.decode_step(tparams, torch.from_numpy(nxt), tc, tcfg)
    out["t_decode"] = tlog2.numpy()
    tc["k"].copy_(k0)
    tc["v"].copy_(v0)
    ttok, _ = tapi.decode_and_sample(tparams, torch.from_numpy(nxt), tc,
                                     tcfg, None, 1.0, greedy=True, top_k=0)
    out["t_tok"] = ttok.numpy()
    return out


@pytest.mark.parametrize("name", ["qwen3_moe_235b", "deepseek_moe_16b"])
@pytest.mark.parametrize("grouped", [False, True], ids=["sorted", "gshard"])
def test_prefill_decode_logits_match_reference(name, grouped):
    out = _run_both(name, packed=True, grouped=grouped)
    np.testing.assert_allclose(out["t_prefill"], out["j_prefill"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out["t_decode"], out["j_decode"], rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(out["t_pages"], out["j_pages"]):
        np.testing.assert_array_equal(a[:, 1:], b[:, 1:])   # page 0: trash
    np.testing.assert_array_equal(out["t_tok"], out["j_tok"])
    np.testing.assert_array_equal(out["t_tok"], out["t_decode"].argmax(-1))


def test_float_master_moe_matches_reference():
    """Float masters under the fused plan (the expert stacks are encoded
    on the fly, the reference's STE forward)."""
    out = _run_both("qwen3_moe_235b", packed=False, grouped=False)
    np.testing.assert_allclose(out["t_decode"], out["j_decode"], rtol=RTOL,
                               atol=ATOL)


def test_packing_paths_match_reference():
    from repro.models import packing as jpacking
    for name in ("qwen3_moe_235b", "deepseek_moe_16b"):
        jcfg, tcfg = _cfgs(name)
        assert tpacking.packable_paths(tcfg) == jpacking.packable_paths(jcfg)
        jparams = _init(jcfg, 0, packed=False)
        want = _numpy_tree(jax.jit(lambda p: japi.pack_params(p, jcfg))(jparams))
        got = tpacking.pack_params(
            tpacking.params_from_numpy(_numpy_tree(jparams), tcfg, "cpu"), tcfg)
        for path in tpacking.packable_paths(tcfg):
            w, g = want, got
            for k in path:
                w, g = w[k], g[k]
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
        # routers and norms stay float
        np.testing.assert_array_equal(got["layers"]["router"].numpy(),
                                      want["layers"]["router"])


def test_moe_checkpoint_restores_into_engine(tmp_path):
    from repro.checkpoint import CheckpointManager
    jcfg, tcfg = _cfgs("qwen3_moe_235b", kind="tiny")
    jparams = _init(jcfg, 6)
    CheckpointManager(str(tmp_path)).save(0, jparams,
                                          extra=japi.pack_manifest(jcfg))
    eng = TEngine.from_checkpoint(tcfg, str(tmp_path), batch_slots=2,
                                  max_seq=32, device="cpu")
    want = _numpy_tree(jparams)
    for name in ("we_gate", "we_down", "router", "wq"):
        np.testing.assert_array_equal(eng.params["layers"][name].numpy(),
                                      want["layers"][name])
    np.testing.assert_array_equal(eng.params["head"].numpy(), want["head"])


# ---------------------------------------------------------------------------
# serving: the engine at the policy's defaults on the tiny MoE config
# ---------------------------------------------------------------------------

QUEUE = [(3, 6, None), (17, 5, None), (9, 7, 11), (30, 4, None), (5, 8, None),
         (21, 1, None)]


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


@pytest.fixture(scope="module")
def tiny_moe():
    jcfg = jconfigs.get_tiny_serving("qwen3_moe_235b").replace(
        quant=jpolicy("serve_fused_p16"))
    tcfg = tconfigs.get_tiny_serving("qwen3_moe_235b").replace(
        quant=tpolicy("serve_fused_p16"))
    jparams = _init(jcfg, 2)
    tparams = tpacking.params_from_numpy(_numpy_tree(jparams), tcfg, "cpu")
    rng = np.random.default_rng(5)
    system = rng.integers(0, jcfg.vocab_size, 20)
    prompts = [np.concatenate([system, rng.integers(0, jcfg.vocab_size, n)])
               .astype(np.int32) for n, _, _ in QUEUE]
    return jcfg, tcfg, jparams, tparams, prompts


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_engine_streams_match_reference(tiny_moe, greedy):
    """Greedy and injected-noise sampled streams at the defaults (prefix
    sharing, fused prefill, fused decode): equal streams, sharing counters
    and allocator totals, a clean pool."""
    jcfg, tcfg, jparams, tparams, prompts = tiny_moe
    kw = dict(batch_slots=3, max_seq=64, greedy=greedy, temperature=0.8,
              top_k=5, base_seed=7)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = TEngine(tcfg, tparams, noise_fn=None if greedy else _jax_noise(7),
                   device="cpu", **kw)
    want = _serve(jeng, JRequest, prompts)
    got = _serve(teng, TRequest, prompts)
    assert got == want
    assert teng.batched_prefill == jeng.batched_prefill
    assert teng.execution_summary()["fused_decode"]
    for k in ("shared_admissions", "pages_shared", "cow_forks"):
        assert teng.stats[k] == jeng.stats[k], k
    assert teng.stats["shared_admissions"] > 0
    assert teng.allocator.total_allocs == jeng.allocator.total_allocs
    assert teng.pages_in_use == 0


def test_droppy_moe_prefills_per_slot_and_refuses_speculation(tiny_moe):
    """A capacity factor that can drop (capacity_factor * top_k < E) turns
    batched prefill off, as in the reference; an explicit True overrides.
    MoE has no k-token verify, so speculate_k raises."""
    _, tcfg, _, tparams, _ = tiny_moe
    for cf, want in ((1.0, False), (2.5, True)):
        cfg = tcfg.replace(capacity_factor=cf)
        jcfg = jconfigs.get_tiny_serving("qwen3_moe_235b").replace(
            capacity_factor=cf, quant=jpolicy("serve_fused_p16"))
        assert TEngine(cfg, tparams, batch_slots=2, max_seq=32,
                       device="cpu").batched_prefill is want
        assert JEngine(jcfg, None, batch_slots=2, max_seq=32) \
            .batched_prefill is want
    assert TEngine(tcfg.replace(capacity_factor=1.0), tparams, batch_slots=2,
                   max_seq=32, batched_prefill=True,
                   device="cpu").batched_prefill
    with pytest.raises(NotImplementedError, match="verify"):
        TEngine(tcfg, tparams, batch_slots=2, max_seq=32, speculate_k=3,
                device="cpu")
    with pytest.raises(NotImplementedError, match="verify"):
        tapi.decode_verify(tparams, None, None, tcfg, None, 1.0, greedy=True,
                           top_k=0)
