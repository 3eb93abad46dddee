"""PyTorch port vs the JAX reference: the training loop's modules —
optimizers and schedules, the data pipeline, the fault-tolerance control
plane, checkpoints (the writer against the reference's reader and the
reverse) and the trainer, at smoke size on the CPU.

Tolerances: the optimizers' updates are f32 elementwise arithmetic in the
same order as the reference's, except for the global-norm and
adafactor's mean reductions (summed in another order) and the
transcendentals of the schedule and corrections (pow, cos, rsqrt, two
libraries): updates and moments are held to rtol 2e-6, atol 1e-9 (a few
f32 ulps), integer state bitwise.  Batches, fault-tolerance verdicts and
checkpoint round trips are bitwise.  Trainer losses under paper_mixed
fused follow different f32 sum orders through a P(13,2) rounding of every
activation (see tests/test_torch_grad.py) and are held to 1e-3 of the
loss over 3 steps.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JManager
from repro.core.quant import policy_by_name as jpolicy
from repro.data import DataConfig as JDataConfig, Pipeline as JPipeline
from repro.models.config import ShapeConfig as JShape
from repro.optim import optimizers as jopt
from repro.runtime import fault_tolerance as jft
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTConfig

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager, tree_paths
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.data import DataConfig, Pipeline
from repro_torch.models import api as tapi
from repro_torch.models.config import ShapeConfig
from repro_torch.models.module import tree_leaves
from repro_torch.optim import optimizers as topt
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.train import Trainer, TrainerConfig, step as tstep


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 0.5, (6, 5)).astype(np.float32),
            "layers": {"k": rng.normal(0, 0.5, (2, 4, 3)).astype(np.float32),
                       "b": rng.normal(0, 0.5, (7,)).astype(np.float32)}}


def _grads(step, seed=1):
    rng = np.random.default_rng([seed, step])
    return {"w": rng.normal(0, 2, (6, 5)).astype(np.float32),
            "layers": {"k": rng.normal(0, 2, (2, 4, 3)).astype(np.float32),
                       "b": rng.normal(0, 2, (7,)).astype(np.float32)}}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _close(a, b, rtol=2e-6, atol=1e-9):
    fa, fb = tree_leaves(_np(a)), tree_leaves(_np(b))
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


_OPTS = {
    "adamw": lambda m: m.adamw(m.cosine_schedule(1e-2, warmup=1, total=5)),
    "adamw_noclip": lambda m: m.adamw(m.constant_schedule(3e-3),
                                      max_grad_norm=None),
    "adafactor": lambda m: m.adafactor(m.cosine_schedule(1e-2, 2, 6),
                                       weight_decay=0.01),
    "sgdm": lambda m: m.sgdm(m.constant_schedule(1e-2)),
}


@pytest.mark.parametrize("name", sorted(_OPTS))
def test_optimizer_updates_match_reference(name):
    """Three updates of each optimizer on the same parameters and
    gradients: updates, parameters and state against the reference."""
    jo, to = _OPTS[name](jopt), _OPTS[name](topt)
    jp = jax.tree.map(jnp.asarray, _params())
    tp = {"w": torch.from_numpy(_params()["w"]),
          "layers": {k: torch.from_numpy(v)
                     for k, v in _params()["layers"].items()}}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = _grads(step)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update({"w": torch.from_numpy(g["w"]), "layers": {
            k: torch.from_numpy(v) for k, v in g["layers"].items()}}, ts, tp)
        _close(tu, ju)
        jp = jax.tree.map(jnp.add, jp, ju)
        tp = {"w": tp["w"] + tu["w"],
              "layers": {k: tp["layers"][k] + tu["layers"][k]
                         for k in tp["layers"]}}
        _close(tp, jp)
        assert int(ts.step) == int(js.step) == step + 1
        for field in ts._fields[1:]:
            _close(getattr(ts, field), getattr(js, field))


def test_schedules_and_global_norm_match_reference():
    for step in range(8):
        for make in (lambda m: m.cosine_schedule(3e-3, 2, 6),
                     lambda m: m.constant_schedule(1e-3)):
            np.testing.assert_allclose(
                float(make(topt)(torch.tensor(step, dtype=torch.int32))),
                float(make(jopt)(jnp.int32(step))), rtol=1e-6)
    g = _grads(0)
    tg = {"w": torch.from_numpy(g["w"]), "layers": {
        k: torch.from_numpy(v) for k, v in g["layers"].items()}}
    np.testing.assert_allclose(float(topt.global_norm(tg)),
                               float(jopt.global_norm(g)), rtol=1e-6)
    clipped, _ = topt.clip_by_global_norm(tg, 1.0)
    jclipped, _ = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    _close(clipped, jclipped)
    with pytest.raises(KeyError):
        topt.by_name("lion", topt.constant_schedule(1.0))


# ---------------------------------------------------------------------------
# data pipeline and fault tolerance
# ---------------------------------------------------------------------------


def test_pipeline_batches_bitwise_reference():
    for arch in ("minitron_8b", "command_r_35b"):
        shape = ShapeConfig("ex", seq_len=32, global_batch=8, kind="train")
        jshape = JShape("ex", seq_len=32, global_batch=8, kind="train")
        for hosts, index in ((1, 0), (2, 1)):
            tp = Pipeline(tconfigs.get_smoke(arch), shape,
                          DataConfig(seed=5, host_index=index,
                                     host_count=hosts))
            jp = JPipeline(jconfigs.get_smoke(arch), jshape,
                           JDataConfig(seed=5, host_index=index,
                                       host_count=hosts))
            for step in (0, 1, 17):
                a, b = tp.batch_at(step), jp.batch_at(step)
                assert set(a) == set(b) == {"tokens", "labels"}
                for k in a:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k],
                                                                       b[k])
            it = tp.iterator(3)
            try:
                for step in (3, 4, 5):
                    assert np.array_equal(next(it)["tokens"],
                                          jp.batch_at(step)["tokens"])
            finally:
                it.close()


def test_fault_tolerance_verdicts_match_reference():
    losses = [1.0, float("nan"), 2.0, float("inf"), float("nan"),
              float("nan"), 0.5, float("nan")]
    tg, jg = tft.NaNGuard(), jft.NaNGuard()
    assert [tg.observe(x) for x in losses] == [jg.observe(x) for x in losses]
    rng = np.random.default_rng(9)
    times = list(rng.normal(1.0, 0.01, 40)) + [1.5, 1.0, 3.0] + list(
        rng.normal(1.0, 0.05, 20))
    ts, js = tft.StragglerDetector(), jft.StragglerDetector()
    got = [ts.observe(t) for t in times]
    assert got == [js.observe(t) for t in times] and any(got)
    assert ts.stats() == js.stats()
    hb = tft.HeartbeatMonitor(["a", "b"])
    hb.beat("a", now=100.0)
    hb.beat("b", now=130.0)
    assert hb.dead_hosts(now=131.0) == ["a"]
    for args in ((8, 4, 100), (64, 4, 7, 16, 2)):
        assert tft.plan_rescale(*args) == tft.RescalePlan(
            **dataclasses.asdict(jft.plan_rescale(*args)))
    with pytest.raises(RuntimeError):
        tft.plan_rescale(1, 4, 0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _train_state(seed=0):
    opt = topt.adamw(topt.constant_schedule(1e-3))
    p = _params(seed)
    params = {"w": torch.from_numpy(p["w"]), "layers": {
        k: torch.from_numpy(v) for k, v in p["layers"].items()}}
    state = tstep.TrainState(params, opt.init(params),
                             torch.tensor(7, dtype=torch.int32))
    for t in tree_leaves(state.opt_state.mu):
        t.add_(0.25)
    return state


def _jax_state(seed=0):
    opt = jopt.adamw(jopt.constant_schedule(1e-3))
    params = jax.tree.map(jnp.asarray, _params(seed))
    s = opt.init(params)
    s = s._replace(mu=jax.tree.map(lambda t: t + 0.25, s.mu))
    return jstep.TrainState(params, s, jnp.int32(7))


def test_checkpoint_port_written_restores_through_reference(tmp_path):
    state = _train_state()
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    mgr.save_async(7, state, extra={"note": "port"})
    mgr.wait()
    jmgr = JManager(str(tmp_path))
    assert jmgr.all_steps() == [7]
    assert jmgr.read_manifest(7)["extra"] == {"note": "port"}
    like = _jax_state()
    back = jmgr.restore(7, like)
    assert tree_paths(state) == sorted(
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(like)[0])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(like)):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(np.asarray(back.params["w"]), _params()["w"])
    assert np.array_equal(np.asarray(back.opt_state.mu["w"]),
                          np.full((6, 5), 0.25, np.float32))
    assert int(back.step) == 7 and int(back.opt_state.step) == 0


def test_checkpoint_reference_written_restores_through_port(tmp_path):
    jstate = _jax_state(3)
    JManager(str(tmp_path)).save(5, jstate, blocking=True)
    like = _train_state()
    back = CheckpointManager(str(tmp_path)).restore(5, like)
    assert isinstance(back, tstep.TrainState)
    assert isinstance(back.opt_state, topt.AdamState)
    for a, b in zip(tree_leaves(_np(back.params)),
                    tree_leaves(_params(3))):
        assert np.array_equal(a, b)
    assert torch.equal(back.opt_state.mu["w"],
                       torch.full((6, 5), 0.25))
    assert back.step.dtype == torch.int32 and int(back.step) == 7
    # meta leaves (an abstract state) need a device and land there
    meta = tstep.TrainState(
        {"w": torch.empty(6, 5, device="meta"), "layers": {
            "k": torch.empty(2, 4, 3, device="meta"),
            "b": torch.empty(7, device="meta")}},
        like.opt_state, like.step)
    with pytest.raises(ValueError, match="device"):
        CheckpointManager(str(tmp_path)).restore(5, meta)
    got = CheckpointManager(str(tmp_path)).restore(5, meta, device="cpu")
    assert torch.equal(got.params["w"], back.params["w"])


def test_checkpoint_atomic_keep_last_and_async_snapshot(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    state = _train_state()
    # an unfinished write (no manifest, tmp name) is invisible to readers
    os.makedirs(tmp_path / "step_000000009.tmp-1-2")
    os.makedirs(tmp_path / "step_000000010")
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    for step in (1, 2, 3):
        mgr.save_async(step, state)
        # the host copy is taken before save_async returns: an in-place
        # update racing the background write does not reach the file
        state.params["w"].add_(1.0)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == [
        "step_000000002", "step_000000003", "step_000000009.tmp-1-2",
        "step_000000010"]
    back = mgr.restore(3, _train_state())
    one = np.float32(1.0)
    assert np.array_equal(back.params["w"].numpy(), _params()["w"] + one + one)
    mgr.save(3, _train_state(1))   # an existing step: idempotent
    assert torch.equal(mgr.restore(3, _train_state()).params["w"],
                       back.params["w"])


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


def _shape():
    return (ShapeConfig("t", seq_len=16, global_batch=4, kind="train"),
            JShape("t", seq_len=16, global_batch=4, kind="train"))


def _trainers(ckpt_dir, jdir, steps=3):
    tq = tpolicy("paper_mixed").with_execution("fused")
    jq = jpolicy("paper_mixed").with_execution("fused")
    tcfg = tconfigs.get_smoke("minitron_8b").replace(quant=tq)
    jcfg = jconfigs.get_smoke("minitron_8b").replace(quant=jq)
    tshape, jshape = _shape()
    kw = dict(total_steps=steps, log_every=100, ckpt_every=100, accum=2,
              async_ckpt=False)
    tr = Trainer(tcfg, tshape,
                 topt.adamw(topt.cosine_schedule(3e-3, warmup=1, total=3)),
                 Pipeline(tcfg, tshape, DataConfig(seed=2)),
                 TrainerConfig(ckpt_dir=ckpt_dir, **kw), device="cpu")
    jtr = JTrainer(jcfg, jshape,
                   jopt.adamw(jopt.cosine_schedule(3e-3, warmup=1, total=3)),
                   JPipeline(jcfg, jshape, JDataConfig(seed=2)),
                   JTConfig(ckpt_dir=jdir, **kw))
    return tr, jtr, jcfg


def test_trainer_losses_match_reference(tmp_path):
    """Both trainers start from the reference's initial state (written by
    the reference's checkpoint writer, restored by each trainer) and take
    3 steps of paper_mixed fused with accum 2."""
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    _, _, jcfg = _trainers(None, None)
    opt = jopt.adamw(jopt.cosine_schedule(3e-3, warmup=1, total=3))
    init = jstep.init_state(jax.random.key(4), jcfg, opt)
    for d in (tdir, jdir):
        JManager(d).save(0, init, blocking=True)
    tr, jtr, _ = _trainers(tdir, jdir)
    tr.run(torch.Generator())
    jtr.run(jax.random.key(0))
    got = [h["loss"] for h in tr.history]
    want = [h["loss"] for h in jtr.history]
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    # each trainer wrote its final state; the port's restores through the
    # reference's reader and stays near the reference's
    final = JManager(tdir).restore(3, jax.eval_shape(lambda: init))
    ref = JManager(jdir).restore(3, jax.eval_shape(lambda: init))
    assert int(final.step) == int(ref.step) == 3
    for a, b in zip(jax.tree.leaves(final.params), jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-4)


def test_trainer_restart_reproduces_next_batch_and_state(tmp_path):
    """2 steps, a checkpoint, a fresh trainer restoring it for step 3:
    equal, bitwise, to 3 uninterrupted steps (the data pipeline is keyed
    by the step, the step deterministic)."""
    whole, _, _ = _trainers(str(tmp_path / "whole"), None)
    whole.run(torch.Generator().manual_seed(1))
    first, _, _ = _trainers(str(tmp_path / "split"), None, steps=2)
    first.run(torch.Generator().manual_seed(1))
    second, _, _ = _trainers(str(tmp_path / "split"), None)
    second.run(torch.Generator().manual_seed(99))   # restores: seed unused
    assert [h["step"] for h in second.history] == [2]
    assert second.history[0]["loss"] == whole.history[2]["loss"]
    like = tstep.init_state(torch.Generator(), first.cfg, first.opt, "cpu")
    a = whole.ckpt.restore(3, like)
    b = second.ckpt.restore(3, like)
    for x, y in zip(tree_leaves(_np(a.params)), tree_leaves(_np(b.params))):
        assert np.array_equal(x, y)
    for x, y in zip(tree_leaves(_np(a.opt_state.nu)),
                    tree_leaves(_np(b.opt_state.nu))):
        assert np.array_equal(x, y)


def test_trainer_rolls_back_on_repeated_nan(tmp_path, monkeypatch):
    """Three non-finite losses in a row restore the last checkpoint."""
    tr, _, _ = _trainers(str(tmp_path), None, steps=5)
    real = tr.train_step
    calls = {"n": 0}

    def flaky(state, batch):
        state, metrics = real(state, batch)
        calls["n"] += 1
        if 2 <= calls["n"] <= 4:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return state, metrics

    tr.ckpt.save(0, tstep.init_state(torch.Generator().manual_seed(1),
                                     tr.cfg, tr.opt, "cpu"))
    monkeypatch.setattr(tr, "train_step", flaky)
    state = tr.run(torch.Generator())
    # steps 0..3 ran, the third NaN in a row (step 3) rolled back to the
    # step-0 checkpoint, and the last iteration trained from there
    assert calls["n"] == 5 and int(state.step) == 1
    assert tr.nan_guard.consecutive == 0
    assert np.isfinite(tr.history[-1]["loss"])


def test_train_step_rejects_bit_exact_and_moe():
    """bit_exact is rejected up front; the MoE family trains (one step of
    qwen3-moe's smoke config, its metrics carrying the aux loss)."""
    cfg = tconfigs.get_smoke("minitron_8b").replace(
        quant=tpolicy("validate_bit_exact"))
    opt = topt.adamw(topt.constant_schedule(1e-3))
    with pytest.raises(ValueError, match="not differentiable"):
        tstep.make_train_step(cfg, opt)
    moe = tconfigs.get_smoke("qwen3_moe_235b").replace(
        quant=tpolicy("paper_mixed").with_execution("fused"))
    state = tstep.init_state(torch.Generator().manual_seed(5), moe, opt,
                             "cpu")
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(
        rng.integers(0, moe.vocab_size, (4, 8)).astype(np.int32))
        for k in ("tokens", "labels")}
    state, metrics = tstep.make_train_step(moe, opt, accum=2)(state, batch)
    assert int(state.step) == 1
    assert all(np.isfinite(float(metrics[k])) for k in ("loss", "ce", "aux"))
    assert float(metrics["aux"]) > 0
    np.testing.assert_allclose(
        float(metrics["loss"]),
        float(metrics["ce"]) + 0.01 * float(metrics["aux"]), rtol=1e-6)


def test_input_specs_and_abstract_state_are_meta():
    cfg = tconfigs.get_smoke("minitron_8b")
    shape, _ = _shape()
    spec = tapi.input_specs(cfg, shape)
    assert {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in spec.items()} == {
        "tokens": ((4, 16), torch.int32, "meta"),
        "labels": ((4, 16), torch.int32, "meta")}
    decode = dataclasses.replace(shape, kind="decode")
    assert tuple(tapi.input_specs(cfg, decode)["tokens"].shape) == (4,)
    abstract = tapi.abstract_state(cfg)
    leaves = tree_leaves(abstract)
    assert all(t.device.type == "meta" for t in leaves)
    real = tapi.init(torch.Generator(), cfg, "cpu")
    assert [t.shape for t in leaves] == [t.shape for t in tree_leaves(real)]
    assert "head" in abstract   # minitron's head is untied


def test_training_modules_import_no_jax_or_repro():
    import subprocess
    import sys
    code = ("import sys, repro_torch.train, repro_torch.optim, "
            "repro_torch.data, repro_torch.runtime, repro_torch.checkpoint; "
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


def test_training_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tconfigs.get_smoke("minitron_8b")
    shape, _ = _shape()
    opt = topt.sgdm(topt.constant_schedule(1e-3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, shape, opt, Pipeline(cfg, shape))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.init_state(torch.Generator(), cfg, opt)
