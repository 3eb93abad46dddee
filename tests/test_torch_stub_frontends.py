"""PyTorch port vs the JAX reference: the two stub-frontend configs,
paligemma-3b (the vlm: 256 precomputed patch embeddings projected by
`frontend_proj` and put ahead of the text) and hubert-xlarge (the
encoder: precomputed audio frames in the tokens' place, bidirectional
attention), at their smoke configs on the CPU.

Covered: `param_specs` and `input_specs` shapes, `Pipeline.batch_at`
(bitwise), `api.apply` under `none`, `paper_mixed` fake_quant and packed
`serve_fused_p16`, paligemma's image-prefix `prefill` + decode steps over
the dense cache, hubert's bidirectionality, the encoder guards of the
serving entry points, paligemma's text-only engine (the reference's
engine embeds tokens only, so the port's does too) and a `paper_mixed`
fused train step's loss and gradients.  The same numpy inputs and the
reference's own parameters go to both packages; the reference runs
jitted (its Pallas kernels in interpret mode), the port every kernel's
plain version.

Tolerances, as for the dense family (tests/test_torch_grad.py): float
logits are f32 sums taken in another order, rtol = atol = 2e-5; under
paper_mixed an activation the frameworks compute one ulp apart can land
on the adjacent P(13,2) code, so logits are held to 1e-2, the loss to
1e-2 of its size and each gradient leaf to 4e-3 of its largest entry,
and, sharper, the port's fused plan bitwise to its own fake_quant plan.
KV codes, tokens and pipeline batches are bitwise.
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
from repro.data import DataConfig as JDataConfig, Pipeline as JPipeline
from repro.models import api as japi
from repro.models import packing as jpacking
from repro.models.config import ShapeConfig as JShape
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine
from repro.train import step as jstep

from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.data import DataConfig, Pipeline
from repro_torch.models import api as tapi
from repro_torch.models import packing as tpacking
from repro_torch.models.config import ShapeConfig
from repro_torch.models.module import tree_leaves
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine
from repro_torch.train import step as tstep

ARCHS = ("paligemma_3b", "hubert_xlarge")
RTOL = ATOL = 2e-5
QUANT_TOL = 1e-2
GRAD_FRAC = 4e-3
B, SEQ = 2, 12          # paligemma's smoke: 4 patches + 8 text tokens
MAX_SEQ = 24
POLICIES = ("none", "paper_mixed", "serve_fused_p16")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: run this module's torch work on one thread (torch's
    pool stalls when the suite's other workers hold the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, policy="none", execution="fake_quant", kind="smoke"):
    jq, tq = jpolicy(policy), tpolicy(policy)
    if policy == "paper_mixed":
        jq, tq = jq.with_execution(execution), tq.with_execution(execution)
    getter = {"smoke": "get_smoke", "full": "get"}[kind]
    return (getattr(jconfigs, getter)(arch).replace(quant=jq),
            getattr(tconfigs, getter)(arch).replace(quant=tq))


def _shape(cls, seq=SEQ):
    return cls("t", seq_len=seq, global_batch=B, kind="train")


def _batch(arch):
    """A train batch of the port's pipeline (bitwise the reference's)."""
    _, tcfg = _cfgs(arch)
    return Pipeline(tcfg, _shape(ShapeConfig), DataConfig(seed=5)).batch_at(1)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# configs, specs, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, kind):
    """The parameter tree, leaf for leaf: `frontend_proj` [frontend_dim,
    d_model] beside the dense trunk (hubert's untied head too)."""
    jcfg, tcfg = _cfgs(arch, kind=kind)
    jflat = {"/".join(str(k.key) for k in path): tuple(s.shape)
             for path, s in jax.tree_util.tree_leaves_with_path(
                 japi.param_specs(jcfg),
                 is_leaf=lambda s: hasattr(s, "logical_axes"))}
    tflat = {"/".join(p): tuple(tpacking._get(tapi.param_specs(tcfg), p).shape)
             for p in tpacking._spec_paths(tapi.param_specs(tcfg))}
    assert tflat == jflat
    assert tflat["frontend_proj"] == (tcfg.frontend_dim, tcfg.d_model)
    assert ("head" in tflat) == (not tcfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Every runnable shape cell of the full config: the frontend's float
    inputs and the int32 tokens / labels, shapes and dtypes as the
    reference's, as meta tensors."""
    jcfg, tcfg = _cfgs(arch, kind="full")
    for shape in tconfigs.runnable_shapes(arch):
        jshape = JShape(**dataclasses.asdict(shape))
        want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in japi.input_specs(jcfg, jshape).items()}
        spec = tapi.input_specs(tcfg, shape)
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in spec.items()}
        assert got == want, shape.name
        assert all(v.device.type == "meta" for v in spec.values())


@pytest.mark.parametrize("host", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_batches_bitwise_reference(arch, host):
    """`batch_at` of both frontends, on each of two hosts: frames and
    per-frame labels (audio); patches, the text tokens and labels
    left-padded with frontend_tokens zeros (vision), bitwise."""
    jcfg, tcfg = _cfgs(arch)
    kw = dict(seed=3, host_index=host, host_count=2)
    want = JPipeline(jcfg, _shape(JShape, 16), JDataConfig(**kw)).batch_at(7)
    got = Pipeline(tcfg, _shape(ShapeConfig, 16), DataConfig(**kw)).batch_at(7)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
    if tcfg.frontend == "vision_stub":
        assert got["patches"].shape == (1, tcfg.frontend_tokens,
                                         tcfg.frontend_dim)
        assert not got["labels"][:, :tcfg.frontend_tokens].any()
    else:
        assert got["frames"].shape == (1, 16, tcfg.frontend_dim)
        assert "tokens" not in got


# ---------------------------------------------------------------------------
# the whole-sequence forward under three plans
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _apply_reference(arch):
    """The reference's init (float, and packed to P(16,2)) and its logits
    under the three plans, one jit for the three."""
    cfgs = {p: _cfgs(arch, p)[0] for p in POLICIES}
    params = japi.init(jax.random.key(1), cfgs["none"])

    def run(p, b):
        packed = japi.pack_params(p, cfgs["serve_fused_p16"])
        return packed, {pol: japi.apply(packed if pol == "serve_fused_p16"
                                        else p, b, cfgs[pol])
                        for pol in POLICIES}

    packed, logits = jax.jit(run)(params, _j(_batch(arch)))
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, packed),
            {k: np.asarray(v) for k, v in logits.items()})


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_match_reference(arch, policy):
    params, packed, want = _apply_reference(arch)
    _, tcfg = _cfgs(arch, policy)
    tparams = tpacking.params_from_numpy(
        packed if policy == "serve_fused_p16" else params, tcfg, "cpu")
    if policy == "serve_fused_p16":
        assert tparams["layers"]["wq"].dtype == torch.int16
        assert tparams["frontend_proj"].dtype == torch.float32
    with torch.no_grad():
        got = tapi.apply(tparams, _t(_batch(arch)), tcfg)
    assert got.shape == (B, SEQ, tcfg.vocab_size) and got.dtype == torch.float32
    tol = QUANT_TOL if policy == "paper_mixed" else RTOL
    np.testing.assert_allclose(got.numpy(), want[policy], rtol=tol, atol=tol)


def test_packing_paths_match_reference():
    """The trunk's attention / MLP weights pack (hubert's untied head
    too); `frontend_proj` and the embedding stay float."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch, "serve_fused_p16")
        assert tpacking.packable_paths(tcfg) == jpacking.packable_paths(jcfg)
        assert ("frontend_proj",) not in tpacking.packable_paths(tcfg)
        assert (("head",) in tpacking.packable_paths(tcfg)) == \
            (not tcfg.tie_embeddings)


def test_hubert_attends_both_ways():
    """The encoder's attention is bidirectional: changing the last frame
    moves the first frame's logits (a causal model's would not move), as
    in the reference."""
    params, _, _ = _apply_reference("hubert_xlarge")
    jcfg, tcfg = _cfgs("hubert_xlarge")
    tparams = tpacking.params_from_numpy(params, tcfg, "cpu")
    batch = _batch("hubert_xlarge")
    moved = dict(batch, frames=batch["frames"].copy())
    moved["frames"][:, -1] += 1.0
    with torch.no_grad():
        a = tapi.apply(tparams, _t(batch), tcfg)
        b = tapi.apply(tparams, _t(moved), tcfg)
        causal = tcfg.replace(causal=True)
        c = tapi.apply(tparams, _t(batch), causal)
        d = tapi.apply(tparams, _t(moved), causal)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3
    assert torch.equal(c[:, 0], d[:, 0])
    want = jax.jit(lambda p, x: japi.apply(p, x, jcfg))(
        jax.tree.map(jnp.asarray, params), _j(moved))
    np.testing.assert_allclose(b.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# paligemma's image-prefix serving over the dense cache; the encoder guards
# ---------------------------------------------------------------------------


def test_paligemma_image_prefix_prefill_and_decode_match_reference():
    """`api.prefill` of patches + text into the dense cache (its length
    frontend_tokens + T), then two decode steps continuing at that
    position: logits within RTOL, the cache's KV codes and lengths bitwise
    after each call."""
    _, packed, _ = _apply_reference("paligemma_3b")
    jcfg, tcfg = _cfgs("paligemma_3b", "serve_fused_p16")
    tparams = tpacking.params_from_numpy(packed, tcfg, "cpu")
    batch = {k: v for k, v in _batch("paligemma_3b").items()
             if k != "labels"}
    S = tcfg.frontend_tokens + batch["tokens"].shape[1]
    jparams = jax.tree.map(jnp.asarray, packed)
    jlog, jcache = jax.jit(lambda p, b: japi.prefill(p, b, jcfg,
                                                     max_seq=MAX_SEQ))(
        jparams, _j(batch))
    with torch.no_grad():
        tlog, tcache = tapi.prefill(tparams, batch, tcfg, max_seq=MAX_SEQ,
                                    device="cpu")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=RTOL,
                               atol=ATOL)
    assert tlog.shape == (B, S, tcfg.vocab_size)
    jstep_fn = jax.jit(lambda p, t, c: japi.decode_step(p, t, c, jcfg))
    toks = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)
    for _ in range(2):
        for name in ("k", "v", "length"):
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))
        jl, jcache = jstep_fn(jparams, jnp.asarray(toks), jcache)
        with torch.no_grad():
            tl, tcache = tapi.decode_step(tparams, torch.from_numpy(toks),
                                          tcache, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tcache["length"].tolist() == [S + 2] * B
    for name in ("k", "v"):
        np.testing.assert_array_equal(tcache[name].numpy(),
                                      np.asarray(jcache[name]))


GUARDS = {
    "prefill": lambda api, cfg: api.prefill(None, {}, cfg),
    "decode_step": lambda api, cfg: api.decode_step(None, None, None, cfg),
    "decode_and_sample": lambda api, cfg: api.decode_and_sample(
        None, None, None, cfg, None, 1.0, greedy=True, top_k=0),
    "decode_verify": lambda api, cfg: api.decode_verify(
        None, None, None, cfg, None, 1.0, greedy=True, top_k=0),
    "prefill_chunk": lambda api, cfg: api.prefill_chunk(None, None, None, 0,
                                                        cfg),
    "prefill_chunk_batched": lambda api, cfg: api.prefill_chunk_batched(
        None, None, None, None, cfg),
}


@pytest.mark.parametrize("entry", sorted(GUARDS))
def test_encoder_serving_entry_points_raise_as_reference(entry):
    jcfg, tcfg = _cfgs("hubert_xlarge")
    with pytest.raises(ValueError) as want:
        GUARDS[entry](japi, jcfg)
    with pytest.raises(ValueError) as got:
        GUARDS[entry](tapi, tcfg)
    assert str(got.value) == str(want.value)
    assert "encoder-only" in str(got.value)


QUEUE = ((3, 6), (21, 5), (9, 6), (14, 4))


def test_paligemma_text_only_engine_streams_match_reference():
    """The engine serves a vlm text-only, as the reference's does (its
    prefill chunks embed tokens): greedy streams at the serving defaults
    over the tiny serving config (the smoke config) equal the
    reference engine's."""
    _, packed, _ = _apply_reference("paligemma_3b")
    jcfg, tcfg = _cfgs("paligemma_3b", "serve_fused_p16")
    assert dataclasses.astuple(tconfigs.get_tiny_serving("paligemma_3b")) \
        == dataclasses.astuple(tconfigs.get_smoke("paligemma_3b"))
    tparams = tpacking.params_from_numpy(packed, tcfg, "cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n, _ in QUEUE]
    kw = dict(batch_slots=2, max_seq=32)
    streams = []
    for eng, req in ((JEngine(jcfg, jax.tree.map(jnp.asarray, packed), **kw),
                      JRequest),
                     (TEngine(tcfg, tparams, device="cpu", **kw), TRequest)):
        for rid, (p, (_, new)) in enumerate(zip(prompts, QUEUE)):
            eng.submit(req(rid=rid, prompt=p, max_new_tokens=new))
        streams.append({r.rid: list(map(int, r.out_tokens))
                        for r in eng.run()})
    assert streams[1] == streams[0]
    assert [len(streams[1][i]) for i in range(len(QUEUE))] == \
        [n for _, n in QUEUE]


# ---------------------------------------------------------------------------
# a paper_mixed fused train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _train_reference(arch):
    """The reference's loss and {path: grad} under paper_mixed fused."""
    jcfg, _ = _cfgs(arch, "paper_mixed", "fused")
    params, _, _ = _apply_reference(arch)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(p, b, jcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, params), _j(_batch(arch)))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return float(loss), {"/".join(str(k.key) for k in path): np.asarray(g)
                         for path, g in flat}


def _port_loss_and_grads(tcfg, params, batch):
    tparams = tpacking.params_from_numpy(params, tcfg, "cpu")
    for p in tree_leaves(tparams):
        p.requires_grad_(True)
    loss, _ = tstep.loss_fn(tparams, _t(batch), tcfg)
    loss.backward()
    # a leaf the loss does not reach (the encoder's token embedding) has no
    # grad: zeros, as the reference's and the train step's
    return loss.detach(), {k: torch.zeros_like(v) if v.grad is None
                           else v.grad for k, v in _flatten(tparams).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_train_step_loss_and_grads_match_reference(arch):
    """`train.step.loss_fn` under paper_mixed fused (the STE over float
    masters), remat per layer: the loss and every leaf's gradient,
    `frontend_proj`'s included, against `jax.value_and_grad` of the
    reference's; and bitwise the port's own fake_quant plan."""
    jloss, jgrads = _train_reference(arch)
    params, _, _ = _apply_reference(arch)
    batch = _batch(arch)
    _, tcfg = _cfgs(arch, "paper_mixed", "fused")
    assert tcfg.remat == "layer"
    loss, grads = _port_loss_and_grads(tcfg, params, batch)
    assert abs(float(loss) - jloss) <= QUANT_TOL * abs(jloss)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = jgrads[k]
        gap = float(np.abs(g.numpy() - want).max())
        assert gap <= GRAD_FRAC * float(np.abs(want).max()), (k, gap)
    assert float(grads["frontend_proj"].abs().max()) > 0
    _, qcfg = _cfgs(arch, "paper_mixed", "fake_quant")
    q_loss, q_grads = _port_loss_and_grads(qcfg, params, batch)
    assert torch.equal(_bits(loss), _bits(q_loss))
    for k, g in grads.items():
        assert torch.equal(_bits(g), _bits(q_grads[k])), k


def test_train_step_takes_frontend_batches():
    """`make_train_step` over a Pipeline batch of each frontend, in two
    microbatches: each key keeps its dtype and trailing shape, and one
    AdamW step moves `frontend_proj`."""
    from repro_torch.optim import optimizers as topt
    for arch in ARCHS:
        _, tcfg = _cfgs(arch, "paper_mixed", "fused")
        tcfg = tcfg.replace(n_layers=1)
        opt = topt.adamw(topt.constant_schedule(1e-3))
        state = tstep.init_state(torch.Generator().manual_seed(0), tcfg, opt,
                                 "cpu")
        before = state.params["frontend_proj"].clone()
        batch = _t(Pipeline(tcfg, _shape(ShapeConfig)).batch_at(0))
        state, metrics = tstep.make_train_step(tcfg, opt, accum=2)(state,
                                                                    batch)
        assert np.isfinite(float(metrics["loss"]))
        assert not torch.equal(state.params["frontend_proj"], before)
