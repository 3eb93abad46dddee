"""PyTorch port vs the JAX reference: the architecture registry and the two
dense configs added with it, gemma3-4b (5:1 local:global sliding-window
attention, qk-norm) and command-r-plus-104b.

The registry: `CONFIG` / `SMOKE` / `get_tiny_serving` field for field,
`SHAPE_SKIPS`, `shape_skips` and `runnable_shapes` equal the reference's
for every ported name.  The models: the same numpy inputs and the
reference's own parameters (JAX init -> numpy -> `packing.params_from_numpy`)
go through chunked prefill and decode steps on both KV caches, with
prompts that cross gemma3's smoke window (8 tokens) and a chunk boundary
inside it; the port runs on the CPU (every kernel's plain version), the
reference jitted (its Pallas kernels in interpret mode).  Logits are f32
sums taken in another order by the two frameworks: rtol = atol = 1e-5.
KV codes are held bitwise.  The engines' streams on these configs are
held in tests/test_torch_dense_cache.py.
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

from repro_torch import configs as tconfigs
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.models import api as tapi
from repro_torch.models import packing as tpacking
from repro_torch.models.paged import PagedLayout as TLayout

RTOL = ATOL = 1e-5
NEW_ARCHS = ("gemma3_4b", "command_r_plus_104b")


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


def _text(v):
    """A policy field as text: formats print alike in both packages, and a
    dtype prints as its bare name (jnp.float32 / torch.float32)."""
    return getattr(v, "__name__", None) or str(v).replace("torch.", "")


def _fields(cfg):
    """Every field but `quant` by value, `quant` field by field as text."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "quant"}
    out["quant"] = {f.name: _text(getattr(cfg.quant, f.name))
                    for f in dataclasses.fields(cfg.quant)}
    return out


@pytest.mark.parametrize("name", tconfigs.ARCH_NAMES)
@pytest.mark.parametrize("getter", ["get", "get_smoke", "get_tiny_serving"])
def test_config_fields_match_reference(name, getter):
    j = getattr(jconfigs, getter)(name)
    t = getattr(tconfigs, getter)(name)
    assert _fields(t) == _fields(j)
    assert t.compute_dtype == getattr(torch, t.dtype)


@pytest.mark.parametrize("name", tconfigs.ARCH_NAMES)
def test_shape_skips_and_runnable_shapes_match_reference(name):
    import importlib
    jmod = importlib.import_module(f"repro.configs.{name}")
    tmod = importlib.import_module(f"repro_torch.configs.{name}")
    assert getattr(tmod, "SHAPE_SKIPS", {}) == getattr(jmod, "SHAPE_SKIPS", {})
    assert tconfigs.shape_skips(name) == jconfigs.shape_skips(name)
    assert [dataclasses.astuple(s) for s in tconfigs.runnable_shapes(name)] \
        == [dataclasses.astuple(s) for s in jconfigs.runnable_shapes(name)]
    # aliases resolve as in the reference
    alias = name.replace("_", "-")
    assert tconfigs.shape_skips(alias) == jconfigs.shape_skips(alias)


def test_gemma3_window_pattern_and_unported_names():
    cfg = tconfigs.get("gemma3_4b")
    flags = [cfg.layer_is_global(i) for i in range(cfg.n_layers)]
    assert [i for i, g in enumerate(flags) if g] == [5, 11, 17, 23, 29]
    assert cfg.sliding_window == 1024 and cfg.head_dim == 256
    assert tconfigs.runnable_shapes("gemma3_4b")[-1].name == "long_500k"
    assert "long_500k" in tconfigs.shape_skips("command_r_plus_104b")
    # the new configs have no tiny-serving shrink: their tiny config is
    # their smoke config (tests/test_torch_dense_cache.py serves it)
    for name in NEW_ARCHS:
        assert dataclasses.astuple(tconfigs.get_tiny_serving(name)) == \
            dataclasses.astuple(tconfigs.get_smoke(name))
    # the SSM, hybrid and stub-frontend configs are ported and read as the
    # reference's; an unknown name still raises
    for name in ("mamba2_1_3b", "jamba_1_5_large", "hubert_xlarge",
                 "paligemma_3b"):
        assert _fields(tconfigs.get(name)) == _fields(jconfigs.get(name))
    assert sorted(tconfigs.ARCH_NAMES) == sorted(jconfigs.ARCH_NAMES)
    with pytest.raises(KeyError):
        tconfigs.get("nonexistent")


# ---------------------------------------------------------------------------
# the two new configs' models: chunked prefill and decode across the window
# ---------------------------------------------------------------------------

MAX_SEQ = 48
B = 2
# chunk plan: one batched 16-token chunk for both slots, then per slot a
# chunk whose queries straddle position 16 (a boundary inside gemma3's
# 8-token window), then decode steps that carry both slots past 24
PER_SLOT = (4, 8)
DECODE_STEPS = 3


@functools.lru_cache(maxsize=None)
def _smoke_params(arch):
    """(jcfg, tcfg, jparams, tparams) of `arch`'s smoke config, built once
    for both caches (the pack jitted: eager it takes seconds on the CPU)."""
    jcfg = jconfigs.get_smoke(arch).replace(quant=jpolicy("serve_fused_p16"))
    tcfg = tconfigs.get_smoke(arch).replace(quant=tpolicy("serve_fused_p16"))
    jparams = jax.jit(lambda p: japi.pack_params(p, jcfg))(
        japi.init(jax.random.key(4), jcfg))
    return jcfg, tcfg, jparams, tpacking.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _run_model(arch, layout_kind):
    jcfg, tcfg, jparams, tparams = _smoke_params(arch)
    rng = np.random.default_rng(21)
    first = rng.integers(0, jcfg.vocab_size, (B, 16)).astype(np.int32)
    rest = [rng.integers(0, jcfg.vocab_size, (1, n)).astype(np.int32)
            for n in PER_SLOT]
    steps = rng.integers(0, jcfg.vocab_size,
                         (DECODE_STEPS, B)).astype(np.int32)
    if layout_kind == "paged":
        jl = JLayout.for_slots(B, MAX_SEQ, 16)
        tl = TLayout.for_slots(B, MAX_SEQ, 16)
        bt = np.array([[3, 1, 5, 0], [2, 4, 6, 0]], np.int32)
    else:
        jl = tl = bt = None
    out = {"j": [], "t": []}

    jc = japi.init_cache(jcfg, B, MAX_SEQ, jl)
    if bt is not None:
        jc = dict(jc, block_table=jnp.asarray(bt))
    jbatch = jax.jit(lambda p, t, c, a: japi.prefill_chunk_batched(
        p, t, c, a, jcfg))
    jchunk = jax.jit(lambda p, t, c, s: japi.prefill_chunk(p, t, c, s, jcfg))
    jdec = jax.jit(lambda p, t, c: japi.decode_step(p, t, c, jcfg))
    lg, jc = jbatch(jparams, jnp.asarray(first), jc, jnp.ones((B,), bool))
    out["j"].append(np.asarray(lg))
    for s, toks in enumerate(rest):
        lg, jc = jchunk(jparams, jnp.asarray(toks), jc, jnp.int32(s))
        out["j"].append(np.asarray(lg))
    for toks in steps:
        lg, jc = jdec(jparams, jnp.asarray(toks), jc)
        out["j"].append(np.asarray(lg))
    out["j_cache"] = (np.asarray(jc["k"]), np.asarray(jc["v"]),
                      np.asarray(jc["length"]))

    tc = tapi.init_cache(tcfg, B, MAX_SEQ, tl, device="cpu")
    if bt is not None:
        tc["block_table"] = torch.from_numpy(bt)
    lg, tc = tapi.prefill_chunk_batched(tparams, torch.from_numpy(first), tc,
                                        torch.ones(B, dtype=torch.bool), tcfg)
    out["t"].append(lg.numpy())
    for s, toks in enumerate(rest):
        lg, tc = tapi.prefill_chunk(tparams, torch.from_numpy(toks), tc, s,
                                    tcfg)
        out["t"].append(lg.numpy())
    for toks in steps:
        lg, tc = tapi.decode_step(tparams, torch.from_numpy(toks), tc, tcfg)
        out["t"].append(lg.numpy())
    out["t_cache"] = (tc["k"].numpy(), tc["v"].numpy(), tc["length"].numpy())
    return out


@pytest.fixture(scope="module",
                params=[(a, k) for a in NEW_ARCHS for k in ("paged", "dense")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model_runs(request):
    return _run_model(*request.param)


def test_prefill_and_decode_logits_across_window(model_runs):
    assert len(model_runs["t"]) == len(model_runs["j"]) == \
        1 + len(PER_SLOT) + DECODE_STEPS
    for t, j in zip(model_runs["t"], model_runs["j"]):
        assert t.shape == j.shape
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_kv_codes_and_lengths_bitwise(model_runs):
    for t, j in zip(model_runs["t_cache"], model_runs["j_cache"]):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
