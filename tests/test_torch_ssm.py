"""PyTorch port vs the JAX reference: the SSM family (`models/mamba.py`,
mamba2-1.3b) and the engine's recurrent-state serving.

Module level, at the smoke config (ssm_chunk 8): the causal conv, the
chunked SSD (`ssd_forward`), its one-token recurrence
(`ssd_decode_step`), `mamba_block` in both branches, and the model's
`apply`, `prefill`, `prefill_chunk`, `prefill_chunk_batched` and
`decode_step`, float and P(16,2)-packed; chunked prefill's states against
the whole prompt's.  Engine level, at `get_tiny_serving`: greedy streams
and sampled ones (the reference's gumbel noise injected) against the
reference engine, paged == dense, interleaved prefill == prefill at
admission, the SSD bucket filter, the speculation refusal and a packed
checkpoint.  The same numpy inputs and the reference's own parameters go
to both packages; the port runs on the CPU, the reference jitted.

Tolerances.  The SSD's sums cannot be replayed bit for bit: XLA's
`cumsum` (neither a sequential nor torch's order), its contraction
orders, `exp` and `softplus` differ from PyTorch's in the last bits.  So
the SSD's outputs and states are held to SSD_TOL = 1e-5 times the
largest |value| of the reference's tensor, as `posit_matmul.sum_bound`
scales its bound to the operands.  Logits: rtol = atol = 2e-5 (the
whole-sequence forward's tolerance elsewhere).  The conv's tap sum is
the reference's order: bitwise with the activation set aside, and within
2 f32 ulps with it (`jax.nn.silu` and `x * torch.sigmoid(x)` differ in
the last bit of the sigmoid).  Tokens, lengths and codes are bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.quant import policy_by_name as jpolicy
from repro.models import api as japi
from repro.models import mamba as jmamba
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine

from repro_torch import configs as tconfigs
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.models import api as tapi
from repro_torch.models import mamba as tmamba
from repro_torch.models import packing as tpacking
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

ARCH = "mamba2_1_3b"
SSD_TOL = 1e-5
RTOL = ATOL = 2e-5
MAX_SEQ = 48


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


def _cfgs(kind="smoke", policy="serve_fused_p16"):
    getter = {"tiny": "get_tiny_serving", "smoke": "get_smoke"}[kind]
    return (getattr(jconfigs, getter)(ARCH).replace(quant=jpolicy(policy)),
            getattr(tconfigs, getter)(ARCH).replace(quant=tpolicy(policy)))


@functools.lru_cache(maxsize=None)
def _params(kind="smoke", policy="serve_fused_p16", seed=1, packed=True):
    """(jcfg, tcfg, jparams, tparams): the reference's init from `seed`
    (packed to P(16,2) codes when asked) and the same leaves in the port."""
    jcfg, tcfg = _cfgs(kind, policy)

    def init(key):
        p = japi.init(key, jcfg)
        return japi.pack_params(p, jcfg) if packed else p

    jparams = jax.jit(init)(jax.random.key(seed))
    return jcfg, tcfg, jparams, tpacking.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the init and the SSD math
# ---------------------------------------------------------------------------


def test_arange1_init_and_param_specs_match_reference():
    """A_log's `arange1` init is log(1..n) over the whole stack (within an
    ulp: XLA's f32 log and PyTorch's round a few values apart), and the
    parameter tree is the reference's, leaf for leaf."""
    jcfg, tcfg = _cfgs()
    tparams = tapi.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jparams = japi.init(jax.random.key(0), jcfg)
    np.testing.assert_array_max_ulp(tparams["layers"]["A_log"].numpy(),
                                    np.asarray(jparams["layers"]["A_log"]),
                                    maxulp=1)
    jflat = {"/".join(str(k.key) for k in path): leaf.shape
             for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    tflat = {"/".join(p): tuple(tpacking._get(tparams, p).shape)
             for p in tpacking._spec_paths(tparams)}
    assert tflat == jflat


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv_matches_reference(with_state, monkeypatch):
    rng = np.random.default_rng(3)
    B, S, C, K = 2, 7, 40, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    state = (rng.standard_normal((B, K - 1, C)).astype(np.float32)
             if with_state else None)

    def both():
        want = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b),
                                   None if state is None else jnp.asarray(state))
        got = tmamba._causal_conv(_t(x), _t(w), _t(b),
                                  None if state is None else _t(state))
        return [np.asarray(v) for v in want], [v.numpy() for v in got]

    want, got = both()
    np.testing.assert_array_equal(got[1], want[1])       # the new state
    np.testing.assert_array_max_ulp(got[0], want[0], maxulp=2)
    # the tap sum (plus bias) alone is the reference's, bit for bit
    monkeypatch.setattr(jax.nn, "silu", lambda v: v)
    monkeypatch.setattr(tmamba, "_silu", lambda v: v)
    want, got = both()
    np.testing.assert_array_equal(got[0], want[0])


def _ssd_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return dict(
        xs=rng.standard_normal((B, S, H * P)).astype(np.float32),
        B_=rng.standard_normal((B, S, N)).astype(np.float32),
        C_=rng.standard_normal((B, S, N)).astype(np.float32),
        dt=rng.standard_normal((B, S, H)).astype(np.float32),
        A_log=np.log(np.arange(1, H + 1, dtype=np.float32)),
        dt_bias=(0.5 * rng.standard_normal(H)).astype(np.float32),
        state=rng.standard_normal((B, H, P, N)).astype(np.float32))


@pytest.mark.parametrize("S,with_state", [(8, False), (24, False), (24, True),
                                          (5, True)])
def test_ssd_forward_matches_reference(S, with_state):
    """One chunk, three chunks (the state carried in chunk order), a
    seeded state, and a chunk shorter than ssm_chunk."""
    jcfg, tcfg = _cfgs()
    a = _ssd_inputs(jcfg, 2, S, seed=S)
    init = a["state"] if with_state else None
    args = [a[k] for k in ("xs", "B_", "C_", "dt", "A_log", "dt_bias")]
    wy, ws = jax.jit(lambda *v: jmamba.ssd_forward(jcfg, *v))(
        *args, None if init is None else jnp.asarray(init))
    gy, gs = tmamba.ssd_forward(tcfg, *map(_t, args),
                                None if init is None else _t(init))
    _scaled_close(gy.numpy(), wy)
    _scaled_close(gs.numpy(), ws)
    if S > jcfg.ssm_chunk:
        # a sequence the chunk length does not divide is refused
        with pytest.raises(ValueError, match="divisible"):
            tmamba.ssd_forward(tcfg, *(_t(v[:, :S - 3]) if v.ndim == 3
                                       else _t(v) for v in args))


def test_ssd_decode_step_matches_reference_and_forward():
    """The recurrence against the reference's, and T recurrence steps
    against the chunk form over the same T tokens."""
    jcfg, tcfg = _cfgs()
    H, P = jcfg.ssm_heads, jcfg.ssm_head_dim
    a = _ssd_inputs(jcfg, 2, 8, seed=9)
    state = a["state"]
    for t in range(3):
        step = (a["xs"][:, t].reshape(2, H, P), a["B_"][:, t], a["C_"][:, t],
                a["dt"][:, t], a["A_log"], a["dt_bias"])
        wy, ws = jax.jit(lambda *v: jmamba.ssd_decode_step(jcfg, *v))(
            *step, state)
        gy, gs = tmamba.ssd_decode_step(tcfg, *map(_t, step), _t(state))
        _scaled_close(gy.numpy(), wy)
        _scaled_close(gs.numpy(), ws)
        state = np.asarray(ws)
    # the chunk form over 8 tokens == 8 recurrence steps (the port alone)
    fy, fs = tmamba.ssd_forward(tcfg, *(_t(a[k]) for k in (
        "xs", "B_", "C_", "dt", "A_log", "dt_bias")), _t(a["state"]))
    s = _t(a["state"])
    for t in range(8):
        y, s = tmamba.ssd_decode_step(
            tcfg, _t(a["xs"][:, t].reshape(2, H, P)), _t(a["B_"][:, t]),
            _t(a["C_"][:, t]), _t(a["dt"][:, t]), _t(a["A_log"]),
            _t(a["dt_bias"]), s)
        _scaled_close(y.numpy(), fy[:, t].numpy())
    _scaled_close(s.numpy(), fs.numpy())


@pytest.mark.parametrize("single_step", [False, True],
                         ids=["chunk", "single_step"])
@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
def test_mamba_block_matches_reference(single_step, packed):
    jcfg, tcfg, jparams, tparams = _params(packed=packed)
    p_j = jax.tree.map(lambda v: v[1], jparams["layers"])
    p_t = {k: v[1] for k, v in tparams["layers"].items()}
    rng = np.random.default_rng(4)
    S = 1 if single_step else 16
    H, P, N = jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state
    conv_ch = jcfg.ssm_d_inner + 2 * N
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    cs = rng.standard_normal((2, jcfg.ssm_conv - 1, conv_ch)).astype(np.float32)
    ss = rng.standard_normal((2, H, P, N)).astype(np.float32)
    want = jax.jit(lambda p, v, c, s: jmamba.mamba_block(
        p, v, jcfg, c, s, single_step=single_step))(p_j, x, cs, ss)
    got = tmamba.mamba_block(p_t, _t(x), tcfg, _t(cs), _t(ss),
                             single_step=single_step)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    # the conv state holds in_proj's outputs: GEMM sums in another order
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=RTOL, atol=ATOL)
    _scaled_close(got[2].numpy(), want[2])


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------

PROMPT = 24     # 3 SSD chunks; chunked as 16 (batched) + 4 + 4 (per slot)


@pytest.fixture(scope="module", params=[True, False], ids=["packed", "float"])
def model_runs(request):
    """Both packages over the same tokens: `apply`, whole-prompt `prefill`,
    a batched 16-token chunk for both slots then 4 + 4 per slot, two
    decode steps (the second with slot 1 inactive), one fused
    decode-and-sample."""
    jcfg, tcfg, jparams, tparams = _params(packed=request.param)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (2, 2)).astype(np.int32)
    out = {}
    out["j_apply"] = np.asarray(jax.jit(lambda p, b: japi.apply(p, b, jcfg))(
        jparams, {"tokens": jnp.asarray(toks)}))
    jl, jc = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, max_seq=MAX_SEQ))(
        jparams, {"tokens": jnp.asarray(toks)})
    out["j_prefill"] = (np.asarray(jl), jax.tree.map(np.asarray, jc))
    jc = japi.init_cache(jcfg, 2, MAX_SEQ)
    jl, jc = jax.jit(lambda p, t, c, a: japi.prefill_chunk_batched(
        p, t, c, a, jcfg))(jparams, jnp.asarray(toks[:, :16]), jc,
                           jnp.ones((2,), bool))
    out["j_batched"] = np.asarray(jl)
    jchunk = jax.jit(lambda p, t, c, s: japi.prefill_chunk(p, t, c, s, jcfg))
    out["j_chunks"] = []
    for lo in (16, 20):
        for s in (0, 1):
            jl, jc = jchunk(jparams, jnp.asarray(toks[s:s + 1, lo:lo + 4]),
                            jc, jnp.int32(s))
            out["j_chunks"].append(np.asarray(jl))
    out["j_chunked_cache"] = jax.tree.map(np.asarray, jc)
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, t, c, jcfg))
    jl, jc = jdec(jparams, jnp.asarray(nxt[:, 0]), jc)
    out["j_decode"] = np.asarray(jl)
    out["j_decode_cache"] = jax.tree.map(np.asarray, jc)
    jt, _ = jax.jit(lambda p, t, c: japi.decode_and_sample(
        p, t, c, jcfg, None, jnp.float32(1.0), greedy=True, top_k=0))(
        jparams, jnp.asarray(nxt[:, 1]), jc)
    out["j_tok"] = np.asarray(jt)

    out["t_apply"] = tapi.apply(tparams, {"tokens": _t(toks)}, tcfg).numpy()
    tl, tc = tapi.prefill(tparams, {"tokens": toks}, tcfg, max_seq=MAX_SEQ,
                          device="cpu")
    out["t_prefill"] = (tl.numpy(), {k: v.numpy() for k, v in tc.items()})
    tc = tapi.init_cache(tcfg, 2, MAX_SEQ, device="cpu")
    tl, tc = tapi.prefill_chunk_batched(tparams, _t(toks[:, :16]), tc,
                                        torch.ones(2, dtype=torch.bool), tcfg)
    out["t_batched"] = tl.numpy()
    out["t_chunks"] = []
    for lo in (16, 20):
        for s in (0, 1):
            tl, tc = tapi.prefill_chunk(tparams, _t(toks[s:s + 1, lo:lo + 4]),
                                        tc, s, tcfg)
            out["t_chunks"].append(tl.numpy())
    out["t_chunked_cache"] = {k: v.numpy().copy() for k, v in tc.items()}
    tl, tc = tapi.decode_step(tparams, _t(nxt[:, 0]), tc, tcfg)
    out["t_decode"] = tl.numpy()
    out["t_decode_cache"] = {k: v.numpy().copy() for k, v in tc.items()}
    tt, _ = tapi.decode_and_sample(tparams, _t(nxt[:, 1]), tc, tcfg, None,
                                   1.0, greedy=True, top_k=0)
    out["t_tok"] = tt.numpy()
    # the active mask: slot 1 inactive leaves its state rows as they were
    before = {k: v.clone() for k, v in tc.items()}
    tl, _ = tapi.decode_step(tparams, _t(nxt[:, 1]), tc, tcfg,
                             active=torch.tensor([True, False]))
    out["t_masked"] = (before, {k: v.clone() for k, v in tc.items()})
    return out


def test_apply_and_prefill_match_reference(model_runs):
    r = model_runs
    np.testing.assert_allclose(r["t_apply"], r["j_apply"], rtol=RTOL,
                               atol=ATOL)
    (tl, tc), (jl, jc) = r["t_prefill"], r["j_prefill"]
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert sorted(tc) == sorted(jc) == ["conv", "length", "ssm"]
    np.testing.assert_array_equal(tc["length"], jc["length"])
    for name in ("conv", "ssm"):
        assert tc[name].dtype == jc[name].dtype
        _scaled_close(tc[name], jc[name])


def test_prefill_chunks_match_reference(model_runs):
    r = model_runs
    np.testing.assert_allclose(r["t_batched"], r["j_batched"], rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(r["t_chunks"], r["j_chunks"]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    tc, jc = r["t_chunked_cache"], r["j_chunked_cache"]
    np.testing.assert_array_equal(tc["length"], jc["length"])
    for name in ("conv", "ssm"):
        _scaled_close(tc[name], jc[name])


def test_chunked_states_equal_whole_prompt_states(model_runs):
    """16 + 4 + 4 chunks carry the states the whole 24-token prompt
    leaves (in the port; the chunk form is exact under chunking)."""
    r = model_runs
    whole, chunked = r["t_prefill"][1], r["t_chunked_cache"]
    np.testing.assert_array_equal(chunked["length"], whole["length"])
    for name in ("conv", "ssm"):
        _scaled_close(chunked[name], whole[name])
    np.testing.assert_allclose(r["t_chunks"][-1][0, 0], r["t_prefill"][0][1, -1],
                               rtol=RTOL, atol=ATOL)


def test_decode_step_matches_reference(model_runs):
    r = model_runs
    np.testing.assert_allclose(r["t_decode"], r["j_decode"], rtol=RTOL,
                               atol=ATOL)
    tc, jc = r["t_decode_cache"], r["j_decode_cache"]
    np.testing.assert_array_equal(tc["length"], jc["length"])
    for name in ("conv", "ssm"):
        _scaled_close(tc[name], jc[name])
    np.testing.assert_array_equal(r["t_tok"], r["j_tok"])
    before, after = r["t_masked"]
    for name in ("conv", "ssm"):
        assert torch.equal(after[name][:, 1], before[name][:, 1])
        assert not torch.equal(after[name][:, 0], before[name][:, 0])


def test_packing_paths_match_reference():
    from repro.models import packing as jpacking
    jcfg, tcfg, jparams, tparams = _params(packed=False)
    assert tpacking.packable_paths(tcfg) == jpacking.packable_paths(jcfg) \
        == (("layers", "in_proj"), ("layers", "out_proj"))
    want = jax.tree.map(np.asarray, jax.jit(
        lambda p: japi.pack_params(p, jcfg))(jparams))
    got = tpacking.pack_params(tparams, tcfg)
    for name in ("in_proj", "out_proj"):
        assert got["layers"][name].dtype == torch.int16
        np.testing.assert_array_equal(got["layers"][name].numpy(),
                                      want["layers"][name])
    back = tpacking.unpack_params(got, tcfg)
    unpacked = jax.jit(lambda p: jpacking.unpack_params(p, jcfg))(want)
    np.testing.assert_array_equal(back["layers"]["in_proj"].numpy(),
                                  np.asarray(unpacked["layers"]["in_proj"]))
    np.testing.assert_array_equal(got["layers"]["conv_w"].numpy(),
                                  want["layers"]["conv_w"])


# ---------------------------------------------------------------------------
# the engine at get_tiny_serving
# ---------------------------------------------------------------------------

QUEUE = ((11, 6), (6, 5), (9, 6), (20, 4), (3, 5))


def _jax_noise(base_seed):
    base = jax.random.key(base_seed)

    def noise_fn(seed, draw, vocab):
        key = jax.random.fold_in(jax.random.fold_in(base, seed), draw)
        return np.asarray(japi.sample_noise(key[None], vocab))[0]

    return noise_fn


def _serve(engine, req_cls, prompts):
    for rid, (p, (_, new)) in enumerate(zip(prompts, QUEUE)):
        engine.submit(req_cls(rid=rid, prompt=p, max_new_tokens=new))
    return {r.rid: list(map(int, r.out_tokens)) for r in engine.run()}


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg, jparams, tparams = _params("tiny", seed=2)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n, _ in QUEUE]
    return jcfg, tcfg, jparams, tparams, prompts


ENGINE_KNOBS = {
    "greedy": dict(),
    "sampled": dict(greedy=False, temperature=0.8, top_k=5, base_seed=9),
    "interleaved": dict(prefill_chunks_per_step=1),
}


@pytest.mark.parametrize("knobs", sorted(ENGINE_KNOBS))
def test_engine_streams_match_reference(tiny, knobs):
    jcfg, tcfg, jparams, tparams, prompts = tiny
    kw = dict(batch_slots=2, max_seq=32, prefill_buckets=(16, 8, 4, 1),
              **ENGINE_KNOBS[knobs])
    jeng = JEngine(jcfg, jparams, **kw)
    teng = TEngine(tcfg, tparams, device="cpu",
                   noise_fn=_jax_noise(kw.get("base_seed", 0)), **kw)
    want, got = _serve(jeng, JRequest, prompts), _serve(teng, TRequest, prompts)
    assert got == want
    assert sorted(got) == list(range(len(QUEUE)))
    assert teng.stats["prefill_batch_sizes"] == \
        jeng.stats["prefill_batch_sizes"]
    assert teng.kv_cache_summary() == jeng.kv_cache_summary()


def test_engine_paged_equals_dense_and_interleaved_equals_admission(tiny):
    """An SSM cache has no pages: paged=True serves unpaged, with the
    streams of paged=False; interleaved prefill (the decode steps leave
    the filling slot's states alone) gives the streams of prefill at
    admission."""
    _, tcfg, _, tparams, prompts = tiny
    out = []
    for kw in (dict(), dict(paged=False), dict(prefill_chunks_per_step=1),
               dict(batched_prefill=False)):
        eng = TEngine(tcfg, tparams, batch_slots=2, max_seq=32,
                      device="cpu", **kw)
        assert eng.paged is False and eng.layout is None
        assert not eng.prefix_sharing and not eng.fused_decode
        out.append(_serve(eng, TRequest, prompts))
    assert out[0] == out[1] == out[2] == out[3]


def test_engine_buckets_and_speculation_refusal(tiny):
    jcfg, tcfg, jparams, tparams, _ = tiny
    kw = dict(batch_slots=1, max_seq=32, prefill_buckets=(48, 12, 4))
    teng = TEngine(tcfg, tparams, device="cpu", **kw)
    # 48 = 6 x 8 kept, 12 dropped (above 8, not a multiple), 4 kept, 1 added
    assert teng.prefill_buckets == JEngine(jcfg, jparams, **kw) \
        .prefill_buckets == (48, 4, 1)
    with pytest.raises(ValueError, match="paged"):
        TEngine(tcfg, tparams, batch_slots=2, max_seq=32, speculate_k=2,
                device="cpu")
    with pytest.raises(NotImplementedError, match="verify"):
        tapi.decode_verify(tparams, None, None, tcfg, None, 1.0, greedy=True,
                           top_k=0)


def test_packed_checkpoint_restores_into_engine(tiny, tmp_path):
    from repro.checkpoint import CheckpointManager
    jcfg, tcfg, jparams, _, prompts = tiny
    CheckpointManager(str(tmp_path)).save(0, jparams,
                                          extra=japi.pack_manifest(jcfg))
    eng = TEngine.from_checkpoint(tcfg, str(tmp_path), batch_slots=2,
                                  max_seq=32, device="cpu")
    want = jax.tree.map(np.asarray, jparams)
    for name in ("in_proj", "out_proj", "A_log", "conv_w"):
        np.testing.assert_array_equal(eng.params["layers"][name].numpy(),
                                      want["layers"][name])
    assert eng.params["layers"]["in_proj"].dtype == torch.int16
    assert sorted(_serve(eng, TRequest, prompts)) == list(range(len(QUEUE)))


# ---------------------------------------------------------------------------
# engine paths no other test compares for this family: preempt / cancel
# mid-run (greedy, sampled, interleaved prefill, the dense cache), a13,
# validate_bit_exact, serve_paged_p16 / serve_p16_kv8, the float policy
# ---------------------------------------------------------------------------

# name: (policy, engine knobs, preempt / cancel script).  Each run pairs
# a policy with a scheduler path; an SSM engine is unpaged whatever
# `paged` says, so the dense cache is `paged=False`'s same path.
RECURRENT_PATHS = {
    "a13_preempt_cancel": ("serve_fused_p16_a13", {}, True),
    # the PDPU GEMM on the CPU is slow: three requests
    "bit_exact": ("validate_bit_exact", {}, False),
    "paged_p16_sampled_preempt_cancel": ("serve_paged_p16", dict(
        greedy=False, temperature=0.8, top_k=5, base_seed=9), True),
    "p16_kv8_interleaved_preempt_cancel": ("serve_p16_kv8", dict(
        prefill_chunks_per_step=1), True),
    "none_dense_preempt_cancel": ("none", dict(paged=False), True),
}


@functools.lru_cache(maxsize=None)
def _policy_params(policy):
    """The reference's tiny init (packed to the policy's weight codes when
    it has them) and the same leaves in the port."""
    jcfg, tcfg = _cfgs("tiny", policy)

    def init(key):
        p = japi.init(key, jcfg)
        return japi.pack_params(p, jcfg) if jcfg.quant.weights else p

    jparams = jax.jit(init)(jax.random.key(2))
    return jcfg, tcfg, jparams, tpacking.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _scripted(engine, req_cls, prompts, script):
    """Serve QUEUE; with `script`, after one step preempt slot 0 and cancel
    the request queued last.  Returns (streams, (the preempted rid, the
    cancelled rid, the queue after both))."""
    for rid, (p, (_, new)) in enumerate(zip(prompts, QUEUE)):
        engine.submit(req_cls(rid=rid, prompt=p, max_new_tokens=new))
    calls = None
    if script:
        engine.step()
        pre = engine.preempt(0)
        last = engine.queue[-1].rid
        assert engine.cancel(last)
        calls = (pre.rid, last, [r.rid for r in engine.queue])
    return {r.rid: list(map(int, r.out_tokens)) for r in engine.run()}, calls


@pytest.mark.parametrize("name", sorted(RECURRENT_PATHS))
def test_engine_paths_match_reference(name):
    policy, knobs, script = RECURRENT_PATHS[name]
    jcfg, tcfg, jparams, tparams = _policy_params(policy)
    # whole 4-token chunks and one bucket: the reference engine compiles
    # one prefill program a run instead of one a bucket
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (12, 8, 8, 20, 4)]
    if policy == "validate_bit_exact":
        prompts = prompts[:3]
    kw = dict(batch_slots=2, max_seq=32, prefill_buckets=(4,), **knobs)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = TEngine(tcfg, tparams, device="cpu",
                   noise_fn=_jax_noise(kw.get("base_seed", 0)), **kw)
    want = _scripted(jeng, JRequest, prompts, script)
    got = _scripted(teng, TRequest, prompts, script)
    assert got == want
    assert teng.stats == jeng.stats
    assert teng.kv_cache_summary() == jeng.kv_cache_summary()
