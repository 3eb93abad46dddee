"""PyTorch port vs the JAX reference: the dense model's serving entry points
(batched chunk prefill, paged decode, fused decode-and-sample), packing,
the checkpoint reader, and the port's import and device rules.

Both packages get the same numpy inputs and the reference's own parameters
(JAX init -> numpy -> `packing.params_from_numpy`).  The port runs on the
CPU here (`device="cpu"`), i.e. through every kernel's plain version; the
reference runs its Pallas kernels in interpret mode.

Tolerances: logits are f32 sums taken in another order by the two
frameworks (XLA vs PyTorch CPU matmul / einsum, transcendental
implementations), so they are held to rtol = atol = 2e-5 (about 1e2 f32
ulps at these magnitudes).  Integer results (KV page codes, tokens) are
held bitwise.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager
from repro.core.quant import policy_by_name as jpolicy
from repro.models import api as japi
from repro.models.paged import PagedLayout as JLayout

from repro_torch import configs as tconfigs
from repro_torch.core.formats import P13_2
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.models import api as tapi
from repro_torch.models import packing as tpacking
from repro_torch.models.paged import PagedLayout as TLayout

RTOL = ATOL = 2e-5
MAX_SEQ = 48


def _cfgs(kind: str, policy: str = "serve_fused_p16"):
    getter = {"tiny": "get_tiny_serving", "smoke": "get_smoke"}[kind]
    jq = jpolicy(policy)
    tq = tpolicy(policy)
    jcfg = getattr(jconfigs, getter)("command_r_35b")
    tcfg = getattr(tconfigs, getter)("command_r_35b")
    jcfg = jcfg.replace(quant=dataclasses.replace(jq, fused_prefill=False))
    tcfg = tcfg.replace(quant=dataclasses.replace(tq, fused_prefill=False))
    return jcfg, tcfg


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _run_both(kind, packed: bool):
    """Prefill two slots by a batched chunk, then two decode steps (one
    returning logits, one sampling greedily in the fused head), in both
    packages; returns every intermediate as numpy."""
    jcfg, tcfg = _cfgs(kind)
    jparams = japi.init(jax.random.key(3), jcfg)
    if packed:
        jparams = japi.pack_params(jparams, jcfg)
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

    jc = japi.init_cache(jcfg, B, MAX_SEQ, jl)
    jc = dict(jc, block_table=jnp.asarray(bt))
    jlog, jc = jax.jit(lambda p, t, c, a: japi.prefill_chunk_batched(
        p, t, c, a, jcfg))(jparams, jnp.asarray(toks), jc,
                           jnp.ones((B,), bool))
    out["j_prefill"] = np.asarray(jlog)
    out["j_pages_prefill"] = (np.asarray(jc["k"]), np.asarray(jc["v"]))
    jlog2, jc2 = jax.jit(lambda p, t, c: japi.decode_step(p, t, c, jcfg))(
        jparams, jnp.asarray(nxt), jc)
    out["j_decode"] = np.asarray(jlog2)
    out["j_pages_decode"] = (np.asarray(jc2["k"]), np.asarray(jc2["v"]))
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
    out["t_pages_prefill"] = (tc["k"].numpy().copy(), tc["v"].numpy().copy())
    k_before, v_before = tc["k"].clone(), tc["v"].clone()
    tlog2, _ = tapi.decode_step(tparams, torch.from_numpy(nxt), tc, tcfg)
    out["t_decode"] = tlog2.numpy()
    out["t_pages_decode"] = (tc["k"].numpy().copy(), tc["v"].numpy().copy())
    # the fused step re-runs the same decode from the post-prefill pages
    tc["k"].copy_(k_before)
    tc["v"].copy_(v_before)
    ttok, _ = tapi.decode_and_sample(tparams, torch.from_numpy(nxt), tc,
                                     tcfg, None, 1.0, greedy=True, top_k=0)
    out["t_tok"] = ttok.numpy()
    return out


@pytest.fixture(scope="module", params=[("tiny", True), ("smoke", True),
                                        ("tiny", False)],
                ids=["tiny-packed", "smoke-packed", "tiny-float-masters"])
def runs(request):
    return _run_both(*request.param)


def test_prefill_chunk_batched_logits(runs):
    np.testing.assert_allclose(runs["t_prefill"], runs["j_prefill"],
                               rtol=RTOL, atol=ATOL)


def test_pages_after_prefill_bitwise(runs):
    for t, j in zip(runs["t_pages_prefill"], runs["j_pages_prefill"]):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_decode_step_logits(runs):
    np.testing.assert_allclose(runs["t_decode"], runs["j_decode"],
                               rtol=RTOL, atol=ATOL)


def test_pages_after_decode_bitwise(runs):
    for t, j in zip(runs["t_pages_decode"], runs["j_pages_decode"]):
        np.testing.assert_array_equal(t, j)


def test_decode_and_sample_greedy_tokens(runs):
    np.testing.assert_array_equal(runs["t_tok"], runs["j_tok"])
    # the fused head's token is the argmax of the decode step's logits
    np.testing.assert_array_equal(runs["t_tok"],
                                  runs["t_decode"].argmax(-1))


# ---------------------------------------------------------------------------
# paged-pool helpers
# ---------------------------------------------------------------------------


def test_paged_helpers_bitwise():
    from repro.models import paged as jpaged
    from repro_torch.models import paged as tpaged

    rng = np.random.default_rng(4)
    P, ps, F, B, M, C = 9, 4, 6, 3, 3, 5
    pool = rng.integers(-100, 100, (P, ps, F)).astype(np.int8)
    bt = np.array([[2, 5, 0], [7, 1, 3], [0, 0, 0]], np.int32)
    lengths = np.array([6, 9, 0], np.int32)
    vals1 = rng.integers(-100, 100, (B, F)).astype(np.int8)
    valsc = rng.integers(-100, 100, (B, C, F)).astype(np.int8)
    starts = np.array([3, 1, 0], np.int32)
    j = jnp.asarray
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    want = np.asarray(jpaged.insert_tokens(j(pool), j(bt), j(lengths),
                                           j(vals1)))
    got = tpaged.insert_tokens(t(pool), t(bt), t(lengths), t(vals1))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])  # page 0: trash
    want = np.asarray(jpaged.insert_chunk(j(pool), j(bt[1]), 2, j(valsc[1])))
    got = tpaged.insert_chunk(t(pool), t(bt[1]), 2, t(valsc[1]))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jpaged.insert_chunk_batched(j(pool), j(bt[:2]),
                                                  j(starts[:2]), j(valsc[:2])))
    got = tpaged.insert_chunk_batched(t(pool), t(bt[:2]), t(starts[:2]),
                                      t(valsc[:2]))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpaged.gather_slots(t(pool), t(bt)).numpy(),
        np.asarray(jpaged.gather_slots(j(pool), j(bt))))
    np.testing.assert_array_equal(
        tpaged.gather_slot(t(pool), t(bt[1])).numpy(),
        np.asarray(jpaged.gather_slot(j(pool), j(bt[1]))))
    for args in ((16, 16, 64), (64, 16, 64), (70, 15, 64), (4, 300, 1)):
        assert tpaged.fused_prefill_span_ok(*args) == \
            jpaged.fused_prefill_span_ok(*args)
    assert tpaged.FLASH_CHUNK == jpaged.FLASH_CHUNK
    jl, tl = JLayout.for_slots(3, 100, 16), TLayout.for_slots(3, 100, 16)
    assert (tl.n_pages, tl.capacity, tl.pages_per_slot(100)) == \
        (jl.n_pages, jl.capacity, jl.pages_per_slot(100))


def test_param_specs_count_and_bytes_match_reference():
    from repro.models import module as jmodule
    from repro_torch.models import module as tmodule

    jcfg, tcfg = _cfgs("smoke")
    jspecs, tspecs = japi.param_specs(jcfg), tapi.param_specs(tcfg)
    assert tmodule.param_count(tspecs) == jmodule.param_count(jspecs)
    assert tmodule.param_bytes(tspecs) == jmodule.param_bytes(jspecs)
    jfull = jconfigs.get("command_r_35b")
    tfull = tconfigs.get("command_r_35b")
    assert tmodule.param_count(tapi.param_specs(tfull)) == \
        jmodule.param_count(japi.param_specs(jfull))


# ---------------------------------------------------------------------------
# packing and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["serve_fused_p16", "serve_paged_p16"])
def test_pack_params_codes_bitwise(policy):
    jcfg, tcfg = _cfgs("smoke", policy)
    jparams = japi.init(jax.random.key(1), jcfg)
    want = _numpy_tree(japi.pack_params(jparams, jcfg))
    got = tpacking.pack_params(
        tpacking.params_from_numpy(_numpy_tree(jparams), tcfg, "cpu"), tcfg)
    for name, leaf in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][name].numpy(), leaf)
    np.testing.assert_array_equal(got["embed"].numpy(), want["embed"])
    assert tpacking.pack_manifest(tcfg) == japi.pack_manifest(jcfg)
    assert tpacking.weight_bytes(got) == japi.weight_bytes(want)


def test_packed_param_specs_match_reference():
    jcfg, tcfg = _cfgs("smoke")
    jspecs = japi.packed_param_specs(jcfg)
    tspecs = tpacking.packed_param_specs(tcfg)
    for name, spec in jspecs["layers"].items():
        got = tspecs["layers"][name]
        assert tuple(got.shape) == tuple(spec.shape)
        assert str(got.dtype).split(".")[-1] == np.dtype(spec.dtype).name


def test_from_checkpoint_restores_equal_tensors(tmp_path):
    from repro_torch.serve import ServingEngine as TEngine

    jcfg, tcfg = _cfgs("tiny")
    packed = japi.pack_params(japi.init(jax.random.key(5), jcfg), jcfg)
    CheckpointManager(str(tmp_path)).save(7, packed,
                                          extra=japi.pack_manifest(jcfg))
    eng = TEngine.from_checkpoint(tcfg, str(tmp_path), batch_slots=2,
                                  max_seq=32, prefix_sharing=False,
                                  device="cpu")
    want = _numpy_tree(packed)
    assert eng.params["embed"].dtype == torch.float32
    for name, leaf in want["layers"].items():
        got = eng.params["layers"][name]
        assert got.numpy().dtype == leaf.dtype
        np.testing.assert_array_equal(got.numpy(), leaf)
    np.testing.assert_array_equal(eng.params["final_norm"].numpy(),
                                  want["final_norm"])
    mismatched = tcfg.replace(quant=dataclasses.replace(
        tcfg.quant, weights=P13_2))
    with pytest.raises(ValueError, match="packed as"):
        TEngine.from_checkpoint(mismatched, str(tmp_path), batch_slots=2,
                                max_seq=32, prefix_sharing=False,
                                device="cpu")


def test_configs_match_reference():
    for getter in ("get", "get_smoke", "get_tiny_serving"):
        j = getattr(jconfigs, getter)("command_r_35b")
        t = getattr(tconfigs, getter)("command_r_35b")
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab_size", "rope_theta", "tie_embeddings",
                  "dtype", "sliding_window", "logit_softcap"):
            assert getattr(t, f) == getattr(j, f), (getter, f)
    assert tconfigs.get("command_r_35b").compute_dtype == torch.bfloat16
    with pytest.raises(KeyError):
        tconfigs.get("gemma3_4b")


# ---------------------------------------------------------------------------
# import isolation and device rules
# ---------------------------------------------------------------------------


def test_import_loads_no_jax_or_repro():
    code = ("import sys, repro_torch, repro_torch.serve, repro_torch.checkpoint, "
            "repro_torch.models.api, repro_torch.kernels.ops; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_card():
    from repro_torch.serve import ServingEngine as TEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg = _cfgs("tiny")
    params = tapi.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tcfg, params, batch_slots=2, max_seq=32, prefix_sharing=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpacking.params_from_numpy({}, tcfg)


def test_unported_engine_options_raise():
    from repro_torch.serve import ServingEngine as TEngine

    _, tcfg = _cfgs("tiny")
    params = tapi.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    base = dict(batch_slots=2, max_seq=32, device="cpu")
    for kw in (dict(), dict(fused_prefill=True, prefix_sharing=False),
               dict(prefix_sharing=False, speculate_k=2),
               dict(prefix_sharing=False, paged=False),
               dict(prefix_sharing=False, mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TEngine(tcfg, params, **base, **kw)
    eng = TEngine(tcfg, params, prefix_sharing=False, **base)
    for call in (lambda: eng.preempt(0), lambda: eng.cancel(0)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
