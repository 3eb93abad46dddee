"""PyTorch port vs the JAX reference: QAT training of the SSM and hybrid
families (`mamba.apply` / `hybrid.apply` with remat per layer or block,
`train.step.loss_fn` with the hybrid's MoE aux loss, one AdamW step, the
Trainer's checkpoints of their parameter trees) on the smoke configs of
mamba2-1.3b and jamba-1.5-large (ssm_chunk 8) on the CPU.

The reference's own parameters reach the port through
`packing.params_from_numpy`, the same numpy tokens go to both; the
reference runs jitted (its paper_mixed fused plan, one jit an arch; its
own tests/test_grad_parity.py holds its fake_quant plan to it), the port
every kernel's plain version.

Tolerances.  The SSD's sums (XLA's `cumsum`, contraction orders, `exp`,
`softplus`) cannot be replayed bit for bit, in the backward as in the
forward (tests/test_torch_ssm.py holds the forward to 1e-5 of the largest
|value|); under paper_mixed an activation the frameworks compute one ulp
apart can then land on the adjacent P(13,2) code, as in the dense and MoE
families (tests/test_torch_grad.py, tests/test_torch_moe_train.py).  So
the loss is held to 1e-2 of its size and each gradient leaf to 4e-3 of
its largest entry (GRAD_FRAC; the gaps measured here are printed by the
assertions' messages).  Sharper, and bitwise: the port's fused plan is
its own fake_quant plan, and remat on and off give the same loss and
gradients.  The AdamW step: its first update is lr * u(g) plus the
decay, u(g) = g s / (|g s| + eps) with s the global-norm clip factor (m
and v are g and g^2 once bias-corrected), which is about sign(g) except
where |g s| is near eps.  So each parameter after the step is held to the
reference's within lr * |u(port's g) - u(reference's g)| + 1e-3 lr: the
optimizer adds nothing to the gradients' gap beyond rounding.
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
from repro.optim import optimizers as jopt
from repro.train import step as jstep

from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.models import api as tapi
from repro_torch.models import packing as tpacking
from repro_torch.models.module import tree_leaves
from repro_torch.optim import optimizers as topt
from repro_torch.train import step as tstep

ARCHS = ("mamba2_1_3b", "jamba_1_5_large")
LOSS_TOL = 1e-2
GRAD_FRAC = 4e-3
LR = 1e-3
EPS, CLIP = 1e-8, 1.0    # AdamW's defaults in both packages
B, SEQ = 2, 16          # two SSD chunks of ssm_chunk 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: run this module's torch work on one thread (torch's
    pool stalls when the suite's other workers hold the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, execution="fused", **kw):
    jq = jpolicy("paper_mixed").with_execution(execution)
    tq = tpolicy("paper_mixed").with_execution(execution)
    return (jconfigs.get_smoke(arch).replace(quant=jq, **kw),
            tconfigs.get_smoke(arch).replace(quant=tq, **kw))


def _batch(vocab):
    rng = np.random.default_rng(17)
    return {k: rng.integers(0, vocab, (B, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's (loss, {path: grad}, params as numpy, {path: the
    parameter after one AdamW step}) under paper_mixed fused, one jit of
    its value_and_grad."""
    jcfg, _ = _cfgs(arch)
    params = japi.init(jax.random.key(6), jcfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jb, jcfg), has_aux=True))(params)
    opt = jopt.adamw(jopt.constant_schedule(LR))
    updates, _ = opt.update(grads, opt.init(params), params)
    stepped = jax.tree.map(jnp.add, params, updates)
    return (float(loss), _paths(grads), jax.tree.map(np.asarray, params),
            _paths(stepped))


def _port(tcfg, jparams):
    """The port's (loss, aux, {path: grad}) on the reference's
    parameters."""
    params = tpacking.params_from_numpy(jparams, tcfg, "cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    loss, metrics = tstep.loss_fn(params, tb, tcfg)
    loss.backward()
    grads = {k: v.grad for k, v in _flatten(params).items()}
    return loss.detach(), metrics["aux"], grads


@pytest.mark.parametrize("execution", ["fake_quant", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, execution):
    """The port's paper_mixed under both trainable plans, remat per layer
    (block): the loss (the hybrid's with 0.01 x its MoE aux loss) and every
    leaf's gradient, the SSM's `A_log`, `dt_bias`, `D_skip`, `conv_w`,
    `conv_b`, `norm` and the STE's `in_proj` / `out_proj` included, against
    `jax.value_and_grad` of the reference's `loss_fn` under fused; under
    fused also bitwise the port's fake_quant plan."""
    jloss, jgrads, jparams, _ = _reference(arch)
    _, tcfg = _cfgs(arch, execution)
    assert tcfg.remat == "layer"
    loss, aux, grads = _port(tcfg, jparams)
    assert abs(float(loss) - jloss) <= LOSS_TOL * abs(jloss), \
        (float(loss), jloss)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = jgrads[k]
        gap = float(np.abs(g.numpy() - want).max())
        scale = float(np.abs(want).max())
        assert gap <= GRAD_FRAC * scale, (k, gap, scale)
        assert float(g.abs().max()) > 0, k
    if arch == "jamba_1_5_large":
        assert float(aux.detach()) > 0
        assert float(grads["blocks/moe/router"].abs().max()) > 0
    if execution == "fused":
        _, qcfg = _cfgs(arch, "fake_quant")
        q_loss, _, q_grads = _port(qcfg, jparams)
        assert torch.equal(_bits(loss), _bits(q_loss))
        for k, g in grads.items():
            assert torch.equal(_bits(g), _bits(q_grads[k])), k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_bitwise_equal_no_remat(arch):
    """Recomputing each mamba layer (each hybrid block, its MoE aux loss
    included) in the backward gives, bitwise, the loss, aux and gradients
    of keeping the activations."""
    out = []
    for remat in ("layer", "none"):
        _, tcfg = _cfgs(arch, remat=remat)
        params = tapi.init(torch.Generator().manual_seed(3), tcfg, "cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(tcfg.vocab_size).items()}
        loss, metrics = tstep.loss_fn(params, batch, tcfg)
        loss.backward()
        out.append([loss, torch.as_tensor(metrics["aux"], dtype=torch.float32)]
                   + [p.grad for p in tree_leaves(params)])
    for a, b in zip(*out):
        assert torch.equal(_bits(a), _bits(b))


def _first_adamw_update(grads):
    """{path: g s / (|g s| + eps)} in f64, s the global-norm clip factor:
    AdamW's first step before the learning rate and the decay (m and v
    are g and g^2 once bias-corrected)."""
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in grads.values()))
    s = min(1.0, CLIP / norm)
    return {k: g * s / (np.abs(g.astype(np.float64) * s) + EPS)
            for k, g in grads.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches_reference(arch):
    """One `make_train_step` under paper_mixed fused with AdamW (global
    norm clip 1.0, decay 0.1) from the reference's parameters: each
    parameter against the reference's value_and_grad + AdamW update (the
    limits in the module docstring)."""
    _, jgrads, jparams, want = _reference(arch)
    _, tcfg = _cfgs(arch)
    _, _, tgrads = _port(tcfg, jparams)
    opt = topt.adamw(topt.constant_schedule(LR))
    params = tpacking.params_from_numpy(jparams, tcfg, "cpu")
    state = tstep.TrainState(params, opt.init(params),
                             torch.zeros((), dtype=torch.int32))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab_size).items()}
    state, metrics = tstep.make_train_step(tcfg, opt)(state, batch)
    assert int(state.step) == 1 and np.isfinite(float(metrics["loss"]))
    got = {k: v.detach().numpy() for k, v in _flatten(state.params).items()}
    assert set(got) == set(want)
    tgrads = {k: g.numpy() for k, g in tgrads.items()}
    u_port, u_ref = _first_adamw_update(tgrads), _first_adamw_update(jgrads)
    for k, v in got.items():
        gap = np.abs(v.astype(np.float64) - want[k])
        limit = LR * np.abs(u_port[k] - u_ref[k]) + 1e-3 * LR
        assert (gap <= limit).all(), (k, float((gap - limit).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_restart_reproduces_next_step(arch, tmp_path):
    """`Trainer` over the recurrent families' trees (mamba2's `layers`
    with the SSM leaves, jamba's `blocks`): 1 step, a checkpoint, a fresh
    trainer restoring it for step 2, bitwise 2 uninterrupted steps
    (loss, parameters and AdamW moments)."""
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import Trainer, TrainerConfig
    _, tcfg = _cfgs(arch)
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=B, kind="train")

    def trainer(name, steps):
        return Trainer(tcfg, shape, topt.adamw(topt.constant_schedule(LR)),
                       Pipeline(tcfg, shape, DataConfig(seed=4)),
                       TrainerConfig(total_steps=steps, log_every=100,
                                     ckpt_every=1, async_ckpt=False,
                                     ckpt_dir=str(tmp_path / name)),
                       device="cpu")

    whole = trainer("whole", 2)
    whole.run(torch.Generator().manual_seed(1))
    trainer("split", 1).run(torch.Generator().manual_seed(1))
    second = trainer("split", 2)
    second.run(torch.Generator().manual_seed(99))   # restores: seed unused
    assert [h["step"] for h in second.history] == [1]
    assert second.history[0]["loss"] == whole.history[1]["loss"]
    like = tstep.init_state(torch.Generator(), tcfg, second.opt, "cpu")
    a, b = whole.ckpt.restore(2, like), second.ckpt.restore(2, like)
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt_state.mu)
                    + tree_leaves(a.opt_state.nu),
                    tree_leaves(b.params) + tree_leaves(b.opt_state.mu)
                    + tree_leaves(b.opt_state.nu)):
        assert torch.equal(_bits(x), _bits(y))
    assert "A_log" in (a.params["layers"] if arch == "mamba2_1_3b"
                       else a.params["blocks"]["mamba"])
