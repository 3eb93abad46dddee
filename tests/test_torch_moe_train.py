"""PyTorch port vs the JAX reference: the MoE family's whole-sequence
forward and its QAT training (`moe.apply` with the router's load-balance
loss, `moe.prefill`, `train.step.loss_fn`, `Trainer`), on the smoke
configs of qwen3-moe-235b and deepseek-moe-16b (its shared experts) on the
CPU.

The same numpy-seeded tokens go to both packages, and the reference's own
parameters reach the port through `packing.params_from_numpy`.  The
reference runs jitted, its Pallas kernels in interpret mode as its own
tests run them; the port runs every kernel's plain version.

Tolerances, as for the dense family in tests/test_torch_grad.py: without
quantization the two frameworks' f32 sums differ in order only, so logits
are held to rtol = atol = 2e-5, the aux loss and the loss to rtol 1e-6 and
each gradient leaf to 1e-5 of its largest entry.  Under paper_mixed an
activation the frameworks compute one ulp apart can sit on a P(13,2)
rounding boundary and take the adjacent code: logits are held to 1e-2,
the loss to 1e-2 of its size and each gradient leaf to 4e-3 of its
largest entry; sharper, the port's fused plan is held bitwise to its
fake_quant plan under the sorted dispatch (the grouped dispatch folds its
batch into the expert rows, so its dw sums in another order).  The
routing itself (the router is an f32 dot) is the same in both packages on
these inputs.  Remat on and off are bitwise equal.  The dense cache's KV
codes after `prefill` are bitwise the reference's.  Trainer losses are
held to 1e-3 of the loss over 3 steps, as in tests/test_torch_train.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JManager
from repro.core.quant import policy_by_name as jpolicy
from repro.data import DataConfig as JDataConfig, Pipeline as JPipeline
from repro.models import api as japi
from repro.models.config import ShapeConfig as JShape
from repro.optim import optimizers as jopt
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTConfig

from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.data import DataConfig, Pipeline
from repro_torch.models import api as tapi
from repro_torch.models import packing as tpacking
from repro_torch.models.config import ShapeConfig
from repro_torch.models.module import tree_leaves
from repro_torch.optim import optimizers as topt
from repro_torch.train import Trainer, TrainerConfig, step as tstep

ARCHS = ("qwen3_moe_235b", "deepseek_moe_16b")
SEQ_TOL = 2e-5
MAX_SEQ = 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's small torch ops on one thread (torch's pool waits
    on cores the suite's other workers hold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, policy, execution="fake_quant", **kw):
    jq, tq = jpolicy(policy), tpolicy(policy)
    if tq.enabled:
        jq, tq = jq.with_execution(execution), tq.with_execution(execution)
    return (jconfigs.get_smoke(arch).replace(quant=jq, **kw),
            tconfigs.get_smoke(arch).replace(quant=tq, **kw))


def _batch(vocab):
    rng = np.random.default_rng(12)
    return {k: rng.integers(0, vocab, (2, 16)).astype(np.int32)
            for k in ("tokens", "labels")}


@functools.lru_cache(maxsize=None)
def _reference(arch, policy, execution, grouped, with_logits=False):
    """The reference's (logits or None, aux, loss, ce, {path: grad},
    params), one jit per case (the logits' extra forward only where
    asked: it adds to the compile)."""
    jcfg, _ = _cfgs(arch, policy, execution, moe_grouped_dispatch=grouped)
    params = japi.init(jax.random.key(1), jcfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}

    def both(p):
        (loss, metrics), g = jax.value_and_grad(
            lambda q: jstep.loss_fn(q, jb, jcfg), has_aux=True)(p)
        logits = japi.apply(p, jb, jcfg) if with_logits else None
        return logits, metrics["aux"], loss, metrics["ce"], g

    logits, aux, loss, ce, grads = jax.jit(both)(params)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    grads = {"/".join(str(k.key) for k in path): np.asarray(g)
             for path, g in flat}
    return (None if logits is None else np.asarray(logits), float(aux),
            float(loss), float(ce), grads, jax.tree.map(np.asarray, params))


def _port(tcfg, jparams):
    """The port's (logits, aux, loss, metrics, {path: grad}) on the
    reference's parameters."""
    params = tpacking.params_from_numpy(jparams, tcfg, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(tcfg.vocab_size).items()}
    loss, metrics = tstep.loss_fn(params, tb, tcfg)
    loss.backward()
    with torch.no_grad():
        logits, aux = tapi.apply(params, tb, tcfg, with_aux=True)
    grads = {k: v.grad for k, v in _flatten(params).items()}
    return logits, aux, loss.detach(), metrics, grads


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_aux_and_grads_match_reference(arch):
    """Float weights (no quantization): `api.apply(..., with_aux=True)`,
    the loss with its aux term, and every leaf's gradient."""
    jl, jaux, jloss, jce, jgrads, jparams = _reference(
        arch, "none", "fake_quant", False, with_logits=True)
    _, tcfg = _cfgs(arch, "none")
    logits, aux, loss, metrics, grads = _port(tcfg, jparams)
    assert logits.shape == jl.shape and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jl, rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-6)
    np.testing.assert_allclose(float(metrics["aux"].detach()), jaux,
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics["ce"]), jce, rtol=1e-6)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    assert float(aux) > 0
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = jgrads[k]
        gap = float(np.abs(g.numpy() - want).max())
        assert gap <= 1e-5 * float(np.abs(want).max()), (k, gap)


@pytest.mark.parametrize("grouped", [False, True], ids=["sorted", "grouped"])
@pytest.mark.parametrize("execution", ["fake_quant", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, execution, grouped):
    """paper_mixed under both trainable plans and both dispatch flavours:
    aux, loss and every gradient leaf against `jax.value_and_grad` of the
    reference's `loss_fn` under the same plan (logits under the sorted
    dispatch).  The router, whose only gradient paths are the combine's
    weights and the aux loss's probabilities, gets its gradient too."""
    jl, jaux, jloss, _, jgrads, jparams = _reference(
        arch, "paper_mixed", execution, grouped, with_logits=not grouped)
    _, tcfg = _cfgs(arch, "paper_mixed", execution,
                    moe_grouped_dispatch=grouped)
    logits, aux, loss, _, grads = _port(tcfg, jparams)
    if jl is not None:
        np.testing.assert_allclose(logits.numpy(), jl, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-2)
    assert abs(float(loss) - jloss) <= 1e-2 * abs(jloss)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = jgrads[k]
        gap = float(np.abs(g.numpy() - want).max())
        assert gap <= 4e-3 * float(np.abs(want).max()), (k, gap)
    assert float(grads["layers/router"].abs().max()) > 0
    if execution == "fused" and not grouped:
        # sharper: the port's fused plan is its fake_quant plan, bitwise
        _, qcfg = _cfgs(arch, "paper_mixed", "fake_quant")
        q_logits, q_aux, q_loss, _, q_grads = _port(qcfg, jparams)
        assert torch.equal(_bits(logits), _bits(q_logits))
        assert torch.equal(_bits(loss), _bits(q_loss))
        for k, g in grads.items():
            assert torch.equal(_bits(g), _bits(q_grads[k])), k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_bitwise_equal_no_remat(arch):
    """Recomputing each MoE layer in the backward (remat "layer") routes
    the tokens as the first forward did: loss, aux and every gradient are
    bitwise those of keeping the activations (remat "none")."""
    out = []
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(499).items()}
    for remat in ("layer", "none"):
        _, tcfg = _cfgs(arch, "paper_mixed", "fused", remat=remat)
        params = tapi.init(torch.Generator().manual_seed(3), tcfg, "cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, metrics = tstep.loss_fn(params, batch, tcfg)
        loss.backward()
        out.append([loss, metrics["aux"]]
                   + [p.grad for p in tree_leaves(params)])
    for a, b in zip(*out):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """`api.prefill` of the MoE family over the reference's packed
    serve_fused_p16 weights: logits, and the dense cache's KV codes
    (padded to max_seq) and lengths bitwise."""
    jcfg, tcfg = _cfgs(arch, "serve_fused_p16")
    jparams = jax.jit(lambda p: japi.pack_params(p, jcfg))(
        japi.init(jax.random.key(2), jcfg))
    tparams = tpacking.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         tcfg, "cpu")
    toks = _batch(jcfg.vocab_size)["tokens"][:, :13]
    jlog, jc = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, max_seq=MAX_SEQ))(
        jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlog, tc = tapi.prefill(tparams, {"tokens": toks}, tcfg,
                                max_seq=MAX_SEQ, device="cpu")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=SEQ_TOL,
                               atol=SEQ_TOL)
    assert sorted(tc) == sorted(jc) == ["k", "length", "v"]
    for name, want in jc.items():
        got = tc[name].numpy()
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
    assert tc["k"].shape[2] == MAX_SEQ and not tc["k"][:, :, 13:].any()


def test_trainer_losses_match_reference(tmp_path):
    """qwen3-moe's smoke config: both trainers restore the reference's
    initial state and take 3 steps of paper_mixed fused (AdamW, accum 2);
    each step's loss (the cross-entropy plus 0.01 x aux) agrees within
    rtol 1e-3."""
    jcfg, tcfg = _cfgs("qwen3_moe_235b", "paper_mixed", "fused")
    tshape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    jshape = JShape("t", seq_len=16, global_batch=4, kind="train")
    kw = dict(total_steps=3, log_every=100, ckpt_every=100, accum=2,
              async_ckpt=False)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    jo = jopt.adamw(jopt.cosine_schedule(3e-3, warmup=1, total=3))
    init = jstep.init_state(jax.random.key(4), jcfg, jo)
    for d in (tdir, jdir):
        JManager(d).save(0, init, blocking=True)
    tr = Trainer(tcfg, tshape,
                 topt.adamw(topt.cosine_schedule(3e-3, warmup=1, total=3)),
                 Pipeline(tcfg, tshape, DataConfig(seed=2)),
                 TrainerConfig(ckpt_dir=tdir, **kw), device="cpu")
    jtr = JTrainer(jcfg, jshape, jo,
                   JPipeline(jcfg, jshape, JDataConfig(seed=2)),
                   JTConfig(ckpt_dir=jdir, **kw))
    tr.run(torch.Generator())
    jtr.run(jax.random.key(0))
    got = [h["loss"] for h in tr.history]
    want = [h["loss"] for h in jtr.history]
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]

