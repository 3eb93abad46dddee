"""The PyTorch port's example twins (`examples/*_torch.py`) on the CPU,
each against the reference example where the two compute the same thing.

- `quickstart_torch.py`: its PDPU table is the reference example's, line
  for line (the host references are bitwise), and so is the coded GEMM's
  largest error on the diagonal; its P(16,2) output codes are held to
  one code step of the reference kernel's (both sum exact f32 products
  and round once, but in another order: a sum one ulp either side of a
  rounding boundary takes the adjacent code, one of the 64 here).
- `wm_sensitivity_study_torch.py`: its whole output is the reference's.
- `ptq_study_torch.py`: on the reference's own parameters the held-out
  CE of every format's row matches the reference's computation (weights
  rounded bitwise alike; the f32 forward sums in another order: rtol =
  atol = 2e-5), and a short run of its CLI prints the reference's rows.
- `serve_async_torch.py`: on the reference's parameters its streams (which
  it asserts equal across plain, async and speculative serving) are the
  reference's plain engine's.
- `train_posit_lm_torch.py` trains the MoE smoke configs (`--arch`): a
  few paper_mixed fused steps lower the loss; and the encoder's
  (hubert-xlarge) from the reference example's initial parameters: its
  losses are the reference example's within rtol 1e-3.
"""
import contextlib
import io
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import posit as jposit
from repro.core.quant import QuantPolicy as JPolicy
from repro.core.formats import P8_2 as JP8_2, P10_2 as JP10_2, \
    P13_2 as JP13_2, P16_2 as JP16_2
from repro.data import DataConfig as JDataConfig, Pipeline as JPipeline
from repro.models import api as japi
from repro.models.config import ShapeConfig as JShape
from repro.serve import Request as JRequest, ServingEngine as JEngine
from repro.train import step as jstep

from repro_torch.core import posit_np as pnp
from repro_torch.core.formats import P16_2
from repro_torch.models import packing as tpacking

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")
sys.path.insert(0, EXAMPLES)

import ptq_study_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_async_torch  # noqa: E402
import train_posit_lm_torch  # noqa: E402
import wm_sensitivity_study_torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def _reference_example(name):
    """(module globals, printed lines) of running a reference example."""
    return _printed(runpy.run_path, os.path.join(EXAMPLES, name))


def test_quickstart_twin_matches_reference():
    y_kernel, lines = _printed(quickstart_torch.main, "cpu")
    ref, ref_lines = _reference_example("quickstart.py")
    assert lines[:-1] == ref_lines[:-1] and len(lines) == len(ref_lines)
    assert lines[-1].split(":")[-1] == ref_lines[-1].split(":")[-1]
    got = pnp.encode_np(y_kernel, P16_2)
    want = pnp.encode_np(ref["y_kernel"], P16_2)
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.95


def test_wm_sensitivity_twin_matches_reference():
    _, lines = _printed(wm_sensitivity_study_torch.main)
    _, ref_lines = _reference_example("wm_sensitivity_study.py")
    assert lines == ref_lines
    assert len(lines) == 15


def test_ptq_rows_match_reference_on_its_params():
    jcfg = jconfigs.get_smoke("minitron_8b")
    jshape = JShape("ptq", seq_len=128, global_batch=8, kind="train")
    jparams = japi.init(jax.random.key(0), jcfg)
    pipe = JPipeline(jcfg, jshape, JDataConfig(seed=777))
    jbatches = [jax.tree.map(jnp.asarray, pipe.batch_at(0))]
    eval_step = jax.jit(lambda p, b: jstep.loss_fn(p, b, jcfg)[0])

    def ce_with(quantize):
        q = jax.tree.map(lambda p: quantize(p) if p.ndim >= 2 else p, jparams)
        return float(np.mean([float(eval_step(q, b)) for b in jbatches]))

    want = [ce_with(lambda p: p),
            ce_with(lambda p: p.astype(jnp.bfloat16).astype(jnp.float32)),
            ce_with(lambda p: p.astype(jnp.float16).astype(jnp.float32))] + [
        ce_with(lambda p, f=f: jposit.quantize(p, f))
        for f in (JP16_2, JP13_2, JP10_2, JP8_2)]
    cfg = ptq_study_torch.configs.get_smoke("minitron_8b")
    params = tpacking.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        cfg, "cpu")
    rows = ptq_study_torch.ptq_rows(params, cfg,
                                    ptq_study_torch.eval_batches(cfg, "cpu", 1))
    assert [r[0] for r in rows] == ["float32 (reference)", "bfloat16",
                                    "float16", "P(16,2)", "P(13,2)",
                                    "P(10,2)", "P(8,2)"]
    assert [r[2] for r in rows] == [32, 16, 16, 16, 13, 10, 8]
    np.testing.assert_allclose([r[1] for r in rows], want, rtol=2e-5,
                               atol=2e-5)


def test_ptq_cli_runs_on_cpu():
    rows, lines = _printed(ptq_study_torch.main,
                           ["--steps", "3", "--device", "cpu"])
    assert all(np.isfinite(ce) for _, ce, _ in rows)
    table = lines[lines.index(next(x for x in lines if x.startswith(
        "format"))) + 1:][:7]
    for (name, _, bits), line in zip(rows, table):
        assert line.startswith(f"{name:22}") and line.endswith(
            f"{bits:5d} {bits/8*1000:20.0f}")


def test_serve_async_twin_streams_match_reference():
    jcfg = jconfigs.get_tiny_serving(
        "command_r_35b", JPolicy(weights=JP16_2, kv_cache=JP8_2))
    jparams = japi.init(jax.random.key(0), jcfg)
    tparams = tpacking.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         serve_async_torch.config(), "cpu")
    (streams, summary), lines = _printed(serve_async_torch.run, 2, 4, "cpu",
                                         params=tparams)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, 6 + 3 * i).astype(np.int32)
               for i in range(2)]
    interactive = rng.integers(0, jcfg.vocab_size, 5).astype(np.int32)
    eng = JEngine(jcfg, jparams, batch_slots=2, max_seq=64)
    for i, p in enumerate(prompts):
        eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=4))
    eng.submit(JRequest(rid=100, prompt=interactive, max_new_tokens=4))
    want = {r.rid: list(map(int, r.out_tokens)) for r in eng.run()}
    assert {k: list(map(int, v)) for k, v in streams.items()} == want
    assert summary["speculation_rounds"] > 0
    assert lines[0].startswith("[serve_async] drained 3 requests (12 tokens)")


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "deepseek_moe_16b"])
def test_train_example_trains_moe(arch):
    losses = train_posit_lm_torch.run("paper_mixed", 4, arch, "fused",
                                      device="cpu")
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_example_trains_hubert_like_reference(monkeypatch):
    """The encoder (audio frames in, a label a frame): 2 paper_mixed fused
    steps of the example's `run` from the reference example's initial
    parameters (`api.init` from key 0, handed to the port's Trainer) give
    the reference example's losses within rtol 1e-3, as the Trainer tests
    hold them (tests/test_torch_train.py)."""
    from repro.core.quant import policy_by_name as jpolicy
    from repro_torch.train import Trainer as TTrainer, step as tstep
    ref, _ = _reference_example("train_posit_lm.py")
    want, _ = _printed(ref["run"], "paper_mixed", 2, "hubert_xlarge",
                       "fused")
    jcfg = jconfigs.get_smoke("hubert_xlarge").replace(
        quant=jpolicy("paper_mixed").with_execution("fused"))
    init = jax.tree.map(np.asarray, japi.init(jax.random.key(0), jcfg))

    def from_reference(self, generator):
        params = tpacking.params_from_numpy(init, self.cfg, self.device)
        return tstep.TrainState(params, self.opt.init(params),
                                torch.zeros((), dtype=torch.int32))

    monkeypatch.setattr(TTrainer, "init_or_restore", from_reference)
    got = train_posit_lm_torch.run("paper_mixed", 2, "hubert_xlarge",
                                   "fused", device="cpu")
    assert len(got) == len(want) == 2 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3)
