"""The port's launchers, `repro_torch.launch.serve` and `.train`, run in
process on the CPU (`--device cpu`): their summary lines (the reference
launchers' lines, plus the mesh's placement when sharded), their greedy
streams against the engine API's on the same weights and queue, and the
two refusals the reference makes (`--temperature` / `--top-k` without
`--sample`; speculation over a sharded pool), with the reference's text.
"""
import contextlib
import inspect
import io
import re
import sys

import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
import repro.serve.engine as jengine

from repro_torch import configs
from repro_torch.core.quant import policy_by_name
from repro_torch.launch import serve, train
from repro_torch.models import api
from repro_torch.serve import Request, ServingEngine

BASE = ["--arch", "command_r_35b", "--smoke", "--quant", "serve_fused_p16",
        "--requests", "3", "--slots", "2", "--max-seq", "48",
        "--prompt-len", "12", "--new-tokens", "5", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return ret, out.getvalue()


def _engine_streams(**kw):
    """The launcher's queue through the engine API: the same weights (a
    generator seeded 0) and prompts (numpy seeded 0)."""
    cfg = configs.get_smoke("command_r_35b").replace(
        quant=policy_by_name("serve_fused_p16"))
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = ServingEngine(cfg, params, batch_slots=2, max_seq=48, device="cpu",
                        **kw)
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 12).astype(np.int32), max_new_tokens=5))
    return {r.rid: list(map(int, r.out_tokens)) for r in eng.run()}


@pytest.fixture(scope="module")
def plain_streams():
    return _engine_streams()


SUMMARY = re.compile(r"^\[serve\] 3 requests, 15 tokens in [0-9.]+s "
                     r"\([0-9.]+ tok/s\) kv dtype=posit cache=(.*)$", re.M)


@pytest.mark.parametrize("flags", ["", "--mesh-model 2", "--dense",
                                   "--speculate 4"])
def test_serve_launcher_lines_and_streams(flags, plain_streams):
    done, out = _run(serve.main, BASE + flags.split())
    m = SUMMARY.search(out)
    assert m, out
    streams = {r.rid: list(map(int, r.out_tokens)) for r in done}
    # every variant serves the plain engine's greedy streams
    assert streams == plain_streams
    if flags == "--dense":
        assert m.group(1) == "dense"
    else:
        assert re.fullmatch(r"paged\(ps=16, peak=\d+/\d+ pages\)",
                            m.group(1)), m.group(1)
    if flags == "--mesh-model 2":
        assert "[serve] mesh: model[0]=cpu model[1]=cpu" in out
        occ = re.search(r"^\[serve\] per-device page occupancy: "
                        r"d0=(\d+)/(\d+) d1=(\d+)/(\d+)$", out, re.M)
        assert occ and occ.group(1) == occ.group(3) == "0", out
        assert occ.group(2) == occ.group(4)
    else:
        assert "per-device" not in out and "mesh:" not in out
    spec = re.search(r"^\[serve\] speculation: k=4 rounds=(\d+) "
                     r"accept_rate=([0-9.]+) committed=(\d+)$", out, re.M)
    assert bool(spec) == (flags == "--speculate 4"), out


def test_serve_launcher_refusals_match_reference(monkeypatch):
    """--temperature / --top-k without --sample exit with the reference
    launcher's message; speculation over a sharded pool raises the
    reference engine's error."""
    for extra in (["--temperature", "0.5"], ["--top-k", "3"]):
        with pytest.raises(SystemExit) as got:
            serve.main(BASE + extra)
        monkeypatch.setattr(sys, "argv", ["serve"] + BASE[:-2] + extra)
        with pytest.raises(SystemExit) as want:
            jserve.main()
        assert str(got.value) == str(want.value) and "--sample" in str(
            got.value)
    with pytest.raises(ValueError) as err:
        serve.main(BASE + ["--mesh-model", "2", "--speculate", "4"])
    # the reference's message, its adjacent string literals joined
    src = re.sub(r'"\s*\n\s*"', "", inspect.getsource(jengine))
    assert f'"{err.value}"' in src
    assert "sharded page pools" in str(err.value)


def test_train_launcher_smoke_steps(tmp_path):
    """A few smoke steps: the summary line, a finite loss, and the
    checkpoint the launcher's --ckpt-dir asks for."""
    trainer, out = _run(train.main, [
        "--arch", "command_r_35b", "--smoke", "--steps", "4", "--seq", "32",
        "--batch", "2", "--quant", "paper_mixed", "--device", "cpu",
        "--ckpt-dir", str(tmp_path)])
    m = re.search(r"^\[train\] done at step 4; final loss ([0-9.]+); "
                  r"throughput \d+ tok/s$", out, re.M)
    assert m, out
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert float(m.group(1)) == pytest.approx(losses[-1], abs=5e-5)
    assert trainer.ckpt.latest_step() == 4
