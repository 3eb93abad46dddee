"""The compiled decode step (`runtime/step_graph.py`, the engine's decode
graphs) on the CPU.

(a) Each family's decode programs, built by an engine on the meta device
over its static buffers, run under the dry run's dispatch mode
(`step_graph.check_capturable`) without a host read of a device value or
a copy between host and device, the two things a CUDA graph capture
cannot hold; a planted `.item()`, `torch.nonzero` or host-to-device copy
must fail the check.

(b) The engine's graph route on the CPU: `_CpuGraphs` stands in for the
card's (its capture runs the body once, as a card's capture and first
replay together run the step once; each later replay runs the body again
with its launches taken out of the counters and writes its outputs into
the captured ones, so a step reads only the static buffers it was
captured with).  Engines on that route and inside `disable_graphs()`
serve a queue whose slots retire and admit mid-run (prefill interleaved,
so mid-prefill rows are masked) with bitwise equal streams and equal
launch counts (the kernel entry points of `kernels/ops.py` counted on the
CPU as the card counts launches); the greedy and the injected-noise
sampled streams also equal the reference engine's.

(c) The launch accounting of a StepGraph: a capture adds nothing, each
replay adds the capture's delta, a failed capture leaves the counters as
they were.

Torch runs on one thread here (the suite's other workers hold the cores).
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.quant import policy_by_name as jpolicy
from repro.models import api as japi
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine

from repro_torch import configs as tconfigs
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.kernels import ops, posit_codec
from repro_torch.launch.step_analysis import HostRead
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import packing as tpacking
from repro_torch.models.module import abstract_params
from repro_torch.runtime import step_graph
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

MAX_SEQ = 48
# (prompt length, max_new_tokens): 6 requests over 3 slots
QUEUE = [(3, 6), (17, 5), (9, 7), (30, 4), (5, 8), (21, 3)]
KNOBS = dict(batch_slots=3, max_seq=MAX_SEQ, temperature=0.8, top_k=5,
             base_seed=9, prefill_chunks_per_step=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a) the decode programs on meta
# ---------------------------------------------------------------------------

META_CASES = {
    # name: (arch, policy, engine knobs)
    "command-r fused greedy": ("command_r_35b", "serve_fused_p16", {}),
    "command-r fused sampled": ("command_r_35b", "serve_fused_p16",
                                dict(greedy=False)),
    "command-r a13": ("command_r_35b", "serve_fused_p16_a13", {}),
    "command-r dense cache": ("command_r_35b", "serve_fused_p16",
                              dict(paged=False, greedy=False)),
    "command-r bit_exact": ("command_r_35b", "validate_bit_exact", {}),
    "qwen3-moe": ("qwen3_moe_235b", "serve_fused_p16", {}),
    "gemma3": ("gemma3_4b", "serve_fused_p16", dict(greedy=False)),
    "mamba2": ("mamba2_1_3b", "serve_fused_p16", dict(greedy=False)),
    "jamba": ("jamba_1_5_large", "serve_fused_p16", {}),
}


def _meta_engine(arch, policy, knobs):
    cfg = tconfigs.get_smoke(arch).replace(quant=tpolicy(policy))
    params = abstract_params(tpacking.packed_param_specs(cfg))
    kw = dict(dict(greedy=True, temperature=0.8, top_k=5), **knobs)
    return TEngine(cfg, params, 3, MAX_SEQ, device="meta", **kw)


@pytest.mark.parametrize("case", sorted(META_CASES))
def test_decode_programs_capturable_on_meta(case):
    eng = _meta_engine(*META_CASES[case])
    programs = eng._step_inputs()
    assert [name for name, _, _ in programs] == (
        ["decode"] if eng.fused_decode else ["decode", "sample"])
    for name, body, inputs in programs:
        assert all(t.device.type == "meta" for t in inputs.values())
        rec = step_graph.check_capturable(body, **inputs)
        assert rec["device_ops"] > 0, name
    launches = step_graph.check_capturable(programs[0][1],
                                           **programs[0][2])["launches"]
    # the fused head runs in the decode program; unfused, the logits head
    assert bool(launches.get("decode_sample")) == eng.fused_decode


def _item(body):
    def planted(**kw):
        out = body(**kw)
        next(iter(kw.values())).max().item()
        return out
    return planted


def _nonzero(body):
    def planted(**kw):
        torch.nonzero(next(iter(kw.values())))
        return body(**kw)
    return planted


def _upload(body):
    def planted(**kw):
        out = body(**kw)
        return out + torch.ones(1).to(out.device).to(out.dtype)[0]
    return planted


@pytest.mark.parametrize("plant", [_item, _nonzero, _upload])
@pytest.mark.parametrize("case", ["command-r fused sampled", "mamba2"])
def test_planted_host_work_fails_the_check(case, plant):
    eng = _meta_engine(*META_CASES[case])
    for _, body, inputs in eng._step_inputs():
        with pytest.raises(HostRead):
            step_graph.check_capturable(plant(body), **inputs)


def test_host_read_inside_the_model_fails_the_check(monkeypatch):
    """A host read deep in a layer (here the norm) is found as well."""
    eng = _meta_engine(*META_CASES["qwen3-moe"])
    rms_norm = tcommon.rms_norm

    def planted(x, *a, **kw):
        float(x.abs().max())
        return rms_norm(x, *a, **kw)

    monkeypatch.setattr(tcommon, "rms_norm", planted)
    _, body, inputs = eng._step_inputs()[0]
    with pytest.raises(HostRead, match="_local_scalar_dense"):
        step_graph.check_capturable(body, **inputs)


# ---------------------------------------------------------------------------
# (b) the engine's graph route against eager, and against the reference
# ---------------------------------------------------------------------------

class _CpuGraphs:
    """The graph route on the CPU (see the module docstring)."""

    def warmup(self, fn):
        return fn()

    def capture(self, fn):
        out = fn()
        return {"fn": fn, "out": out, "replays": 0}, out

    def replay(self, graph):
        graph["replays"] += 1
        if graph["replays"] == 1:
            return          # the capture ran this step
        with ops.captured_launches():
            out = graph["fn"]()
        graph["out"].copy_(out)


# the kernel entry points the models call, counted on the CPU under
# "cpu:<name>" as a card counts its launches
_COUNTED = ("decode", "encode", "paged_attention", "prefill_attention_paged",
            "decode_sample", "matmul_posit_weights", "fused_matmul",
            "fused_matmul_grouped", "matmul_posit_weights_grouped",
            "pdpu_matmul")


@pytest.fixture
def counted(monkeypatch):
    table = posit_codec.LAUNCHES

    def wrap(name, fn):
        def counting(*args, **kw):
            table[f"cpu:{name}"] = table.get(f"cpu:{name}", 0) + 1
            return fn(*args, **kw)
        return counting

    for name in _COUNTED:
        monkeypatch.setattr(ops, name, wrap(name, getattr(ops, name)))
    yield
    for key in [k for k in table if k.startswith("cpu:")]:
        del table[key]


def _serve(engine, request_cls, prompts):
    for rid, (p, (_, new)) in enumerate(zip(prompts, QUEUE)):
        engine.submit(request_cls(rid=rid, prompt=p, max_new_tokens=new,
                                  seed=100 + rid))
    return {r.rid: list(map(int, r.out_tokens)) for r in engine.run()}


def _port_run(cfg, params, route, knobs, noise_fn=None, monkeypatch=None):
    """Streams, launch counts (from 0) and the engine of one port run:
    route "graphs" takes `_CpuGraphs`, "eager" runs inside
    disable_graphs()."""
    with monkeypatch.context() as m:
        if route == "graphs":
            m.setattr(step_graph, "_backend", lambda dev: _CpuGraphs())
        eng = TEngine(cfg, params, device="cpu", noise_fn=noise_fn,
                      **dict(KNOBS, **knobs))
        prompts = _prompts(cfg.vocab_size)
        ops.reset_launches()
        if route == "graphs":
            streams = _serve(eng, TRequest, prompts)
        else:
            with step_graph.disable_graphs():
                streams = _serve(eng, TRequest, prompts)
        return streams, {k: v for k, v in ops.launch_counts().items()
                         if v}, eng


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).astype(np.int32) for n, _ in QUEUE]


ROUTE_CASES = {
    # name: (arch, policy, knobs)
    "command-r fused greedy": ("command_r_35b", "serve_fused_p16",
                               dict(greedy=True)),
    "command-r unfused sampled": ("command_r_35b", "serve_fused_p16",
                                  dict(greedy=False, fused_decode=False)),
    "command-r dense cache sampled": ("command_r_35b", "serve_fused_p16",
                                      dict(greedy=False, paged=False)),
    "command-r bit_exact": ("command_r_35b", "validate_bit_exact",
                            dict(greedy=True)),
    "mamba2 sampled": ("mamba2_1_3b", "serve_fused_p16",
                       dict(greedy=False)),
    "jamba greedy": ("jamba_1_5_large", "serve_fused_p16",
                     dict(greedy=True)),
}


def _tiny_params(cfg):
    return tpacking.pack_params(tapi.init(torch.Generator().manual_seed(3),
                                          cfg, device="cpu"), cfg)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_graph_route_equals_eager(case, counted, monkeypatch):
    arch, policy, knobs = ROUTE_CASES[case]
    cfg = tconfigs.get_tiny_serving(arch).replace(quant=tpolicy(policy))
    params = _tiny_params(cfg)
    g_streams, g_counts, g_eng = _port_run(cfg, params, "graphs", knobs,
                                           monkeypatch=monkeypatch)
    e_streams, e_counts, e_eng = _port_run(cfg, params, "eager", knobs,
                                           monkeypatch=monkeypatch)
    assert g_streams == e_streams
    assert g_counts == e_counts and any(k.startswith("cpu:")
                                        for k in g_counts)
    steps = g_eng.stats["decode_steps"]
    assert steps == e_eng.stats["decode_steps"] > 2
    per_step = 1 if g_eng.fused_decode else 2
    for eng in (g_eng, e_eng):
        assert eng.stats["decode_device_programs"] == per_step * steps
    # the first decode step warms up, every later one replays
    g, e = g_eng.execution_summary(), e_eng.execution_summary()
    assert g["decode_graph_replays"] == per_step * (steps - 1)
    assert all(v["captured"] and v["eager_calls"] == 1
               for v in g["step_graphs"].values())
    assert e["decode_graph_replays"] == 0 and all(
        not v["captured"] and v["eager_calls"] == steps
        for v in e["step_graphs"].values())
    assert not g["decode_graphed"]      # no card: the plain route
    assert "prefill chunk groups" in g["eager_steps"]


def _jax_noise(base_seed):
    base = jax.random.key(base_seed)

    def noise_fn(seed, draw, vocab):
        key = jax.random.fold_in(jax.random.fold_in(base, seed), draw)
        return np.asarray(japi.sample_noise(key[None], vocab))[0]

    return noise_fn


@pytest.mark.parametrize("greedy,fused", [(True, True), (False, False)])
def test_graph_route_equals_the_reference(greedy, fused, monkeypatch):
    jcfg = jconfigs.get_tiny_serving("command_r_35b").replace(
        quant=jpolicy("serve_fused_p16"))
    tcfg = tconfigs.get_tiny_serving("command_r_35b").replace(
        quant=tpolicy("serve_fused_p16"))
    params = japi.pack_params(japi.init(jax.random.key(2), jcfg), jcfg)
    knobs = dict(greedy=greedy, fused_decode=fused)
    want = _serve(JEngine(jcfg, params, **dict(KNOBS, **knobs)), JRequest,
                  _prompts(jcfg.vocab_size))
    tparams = tpacking.params_from_numpy(jax.tree.map(np.asarray, params),
                                         tcfg, "cpu")
    got, _, eng = _port_run(tcfg, tparams, "graphs", knobs,
                            noise_fn=None if greedy else _jax_noise(9),
                            monkeypatch=monkeypatch)
    assert got == want
    assert eng.execution_summary()["decode_graph_replays"] > 0


# ---------------------------------------------------------------------------
# (c) the launch accounting
# ---------------------------------------------------------------------------

class _StubGraphs:
    """Captures run nothing of the body's launches twice: the capture's
    own run is counted by the StepGraph's delta, a replay runs nothing."""

    def warmup(self, fn):
        return fn()

    def capture(self, fn):
        return "graph", fn()

    def replay(self, graph):
        pass


def _body(x):
    """Counts two launches, as a wrapper of K1's p16_2 variant does."""
    posit_codec.LAUNCHES["posit_decode"] += 1
    posit_codec.LAUNCHES["posit_decode:p16_2"] += 1
    return x + 1


def test_capture_adds_nothing_and_each_replay_its_delta():
    ops.reset_launches()
    sg = step_graph.StepGraph("stub", _StubGraphs())
    x = torch.zeros(2)
    sg(_body, x=x)                    # the warm-up: one eager step
    assert ops.launch_counts()["posit_decode:p16_2"] == 1
    assert not sg.captured and sg.eager_calls == 1
    sg(_body, x=x)                    # capture (counts nothing) + replay
    assert sg.captured and sg.replays == 1
    assert sg.delta == {"posit_decode": 1, "posit_decode:p16_2": 1}
    assert ops.launch_counts()["posit_decode"] == 2
    for n in range(3, 6):
        sg(_body, x=x)
        assert ops.launch_counts()["posit_decode:p16_2"] == n
    assert sg.replays == 4
    with step_graph.disable_graphs():
        sg(_body, x=x)                # eager: counted by the body itself
    assert sg.eager_calls == 2 and sg.replays == 4
    assert ops.launch_counts()["posit_decode"] == 6
    with pytest.raises(ValueError, match="buffers it was captured with"):
        sg(_body, x=torch.zeros(2))
    ops.reset_launches()


def test_failed_capture_raises_and_counts_nothing():
    ops.reset_launches()
    sg = step_graph.StepGraph("stub", _StubGraphs())
    x = torch.zeros(2)

    def failing(x):
        _body(x)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    sg(_body, x=x)
    with pytest.raises(RuntimeError, match="capturing"):
        sg(failing, x=x)
    assert not sg.captured and sg.replays == 0
    assert ops.launch_counts()["posit_decode"] == 1
    ops.reset_launches()


def test_captured_launches_hands_back_new_keys():
    ops.reset_launches()
    table = posit_codec.LAUNCHES
    with ops.captured_launches() as delta:
        table["posit_decode"] += 2
        table["posit_decode:test_variant"] = 1
    try:
        assert delta == {"posit_decode": 2, "posit_decode:test_variant": 1}
        assert table["posit_decode"] == 0
        assert table["posit_decode:test_variant"] == 0
        ops.add_launches(delta)
        ops.add_launches(delta)
        assert table["posit_decode"] == 4
        assert table["posit_decode:test_variant"] == 2
    finally:
        del table["posit_decode:test_variant"]
        ops.reset_launches()


def test_cpu_engine_never_captures():
    """On the CPU the engine's StepGraphs run eagerly (the plain route)."""
    cfg = tconfigs.get_tiny_serving("command_r_35b").replace(
        quant=tpolicy("serve_fused_p16"))
    eng = TEngine(cfg, _tiny_params(cfg), device="cpu",
                  **dict(KNOBS, greedy=True))
    _serve(eng, TRequest, _prompts(cfg.vocab_size))
    s = eng.execution_summary()
    assert s["step_graphs"]["decode"] == {
        "captured": False, "replays": 0,
        "eager_calls": eng.stats["decode_steps"]}
    assert not s["decode_graphed"] and s["decode_graph_replays"] == 0
