"""chip_smoke.py's phase-4 check (`_small_reference`) on the CPU, and how
the script derives its training shapes and attributes launches.

The check compares the card's KV codes and logits with the plain CPU
path's.  Here the "card" side runs on the CPU too, so the two sides agree
exactly; a planted +1 on a KV code far from any rounding boundary of the
card side's pages, written in the prefill or in the decode step, one code
or many, must fail the check (`_kv_flips` accepts a differing code only
at a rounding boundary, and at most `_KV_FLIP_LIMIT` of them).
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402

ARCH, POLICY = "gemma3_4b", "serve_fused_p16"
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke-size ops on one thread: with the suite's other workers busy,
    torch's thread pool waits on taken cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_small_reference_agrees_on_the_cpu():
    assert chip_smoke._small_reference(CPU, POLICY, ARCH) == (0.0, 0.0, 0)


@pytest.mark.parametrize("fn_name,page,row,n_codes", [
    ("prefill_chunk_batched", 1, 5, 1),
    ("decode_step", 2, 4, 1),
    ("decode_step", 2, 4, 10)])
def test_small_reference_rejects_planted_codes(monkeypatch, fn_name, page,
                                               row, n_codes):
    """The second call of `fn_name` is the card side's: its output pages
    get `n_codes` V codes of layer 3 at (page, row) (slot 0's position 5
    in the prefill, 20 in the step) moved up by one, where the code lies
    between 3 and 100 (far from zero and from NaR)."""
    orig = getattr(api, fn_name)
    calls = []

    def planted(*args, **kw):
        out = orig(*args, **kw)
        calls.append(None)
        if len(calls) == 2:
            v = out[1]["v"][3, page, row]
            idx = torch.nonzero((v > 3) & (v < 100))[:n_codes, 0]
            assert len(idx) == n_codes
            v[idx] += 1
        return out

    monkeypatch.setattr(api, fn_name, planted)
    with pytest.raises(SystemExit, match="adjacent one, across a rounding"):
        chip_smoke._small_reference(CPU, POLICY, ARCH)


@pytest.mark.parametrize("arch,dense,experts,capacity", [
    ("minitron_8b", (("wq", 4096, 4096), ("wk", 4096, 1024),
                     ("wv", 4096, 1024), ("wo", 4096, 4096),
                     ("gate", 4096, 16384), ("up", 4096, 16384),
                     ("down", 16384, 4096)), None, None),
    ("qwen3_moe_235b", (("wq", 4096, 8192), ("wk", 4096, 512),
                        ("wv", 4096, 512), ("wo", 8192, 4096)),
     ((4096, 1536), (4096, 1536), (1536, 4096)), 40),
    ("deepseek_moe_16b", (("wq", 2048, 2048), ("wk", 2048, 2048),
                          ("wv", 2048, 2048), ("wo", 2048, 2048),
                          ("gate", 2048, 2816), ("up", 2048, 2816),
                          ("down", 2816, 2048)),
     ((2048, 1408), (2048, 1408), (1408, 2048)), 64)])
def test_training_shapes_follow_the_config(arch, dense, experts, capacity):
    """The K6 / STE shapes the script checks are the full-width config's
    coded GEMMs (deepseek's shared experts 2 x 1408 wide), and K9's are its
    expert GEMMs at the capacity rows of a 512-token microbatch."""
    cfg = configs.get(arch)
    assert chip_smoke._dense_kn(cfg) == dense
    if experts is not None:
        assert chip_smoke._expert_kn(cfg) == experts
        tokens = chip_smoke._train_shape().tokens // chip_smoke.TRAIN_ACCUM
        assert moe.capacity(cfg, tokens) == capacity


def test_attribute_launches_counts_each_launch_once():
    """A record with "paths" counts those runs; one without counts the
    runs no other record of its kernel names; a variant counter reports
    itself as the only variant."""
    runs = {
        "MoE greedy": {"posit_matmul_grouped": 12,
                       "posit_matmul_grouped:p16_2": 12,
                       "posit_matmul_grouped:posit": 0,
                       "posit_matmul_grouped:tc_p13_2": 0, "posit_decode": 7},
        "train qwen3": {"posit_matmul_grouped": 48,
                        "posit_matmul_grouped:p16_2": 0,
                        "posit_matmul_grouped:posit": 0,
                        "posit_matmul_grouped:tc_p13_2": 48,
                        "posit_decode": 5},
        "train deepseek": {"posit_matmul_grouped": 192,
                           "posit_matmul_grouped:p16_2": 0,
                           "posit_matmul_grouped:posit": 0,
                           "posit_matmul_grouped:tc_p13_2": 192,
                           "posit_decode": 3}}
    recs = [dict(name="posit_matmul_grouped"),
            dict(name="K9 qwen3", counter="posit_matmul_grouped:tc_p13_2",
                 paths=("train qwen3",)),
            dict(name="K9 deepseek",
                 counter="posit_matmul_grouped:tc_p13_2",
                 paths=("train deepseek",)),
            dict(name="posit_decode")]
    chip_smoke._attribute_launches(recs, runs)
    serving, qwen3, deepseek, decode = recs
    assert serving["launches_by_path"] == {"MoE greedy": 12}
    assert serving["launches_by_variant"] == {"p16_2": 12, "posit": 0,
                                              "tc_p13_2": 0}
    assert (qwen3["launches"], qwen3["launches_by_variant"]) == (
        48, {"tc_p13_2": 48})
    assert (deepseek["launches"], deepseek["launches_by_variant"]) == (
        192, {"tc_p13_2": 192})
    assert sum(r["launches"] for r in recs[:3]) == sum(
        c["posit_matmul_grouped"] for c in runs.values())
    assert decode["launches"] == 15 and decode["launches_by_variant"] == {}
    assert all(r["route"] == "cuda" for r in recs)


def test_planted_faults_fail_the_sum_bound():
    """The two planted faults exceed `sum_bound` over 2-D and grouped
    operands whose P(13,2) weights all lie below 2^-4, so that they are
    exact in bf16 (as minitron's down projection's at K 16384 are), and a
    bound no gap can pass trips the check."""
    from repro_torch.core.formats import P13_2
    from repro_torch.kernels import posit_codec
    from repro_torch.kernels import posit_matmul as pm
    g = torch.Generator().manual_seed(5)
    for lead, scale in (((), 16), ((3,), 16), ((), 128)):
        a = posit_codec.encode(torch.randn(*lead, 8, 256, generator=g), P13_2)
        w = (torch.randn(*lead, 256, 16, generator=g) / scale).clamp(
            -0.0624, 0.0624)
        b = posit_codec.encode(w, P13_2)
        want = (pm.posit_matmul_grouped_plain(a, b, P13_2, P13_2) if lead
                else pm.posit_matmul_plain(a, b, P13_2, P13_2))
        bound = pm.sum_bound(a, b, P13_2, P13_2)
        A, B = posit_codec.decode(a, P13_2), posit_codec.decode(b, P13_2)
        assert torch.equal(B.to(torch.bfloat16).float(), B)
        chip_smoke._planted_faults("test", A, B, want, bound)
        with pytest.raises(SystemExit):
            chip_smoke._planted_faults("test", A, B, want,
                                       torch.full_like(bound, float("inf")))



@pytest.mark.parametrize("layout", ["kn", "t"])
def test_planted_faults_fail_the_float_gemv_bound(layout):
    """The float GEMV's gate, `sum_bound(x, w, None, fmt)`: its plain
    version passes, and both planted faults (the P(16,2) weights rounded
    to bf16, the first K split left out) exceed it over [K, N] codes and
    over the transpose of [N, K] codes; a bound no gap can pass trips the
    check."""
    from repro_torch.core.formats import P16_2
    from repro_torch.kernels import posit_codec
    from repro_torch.kernels import posit_matmul as pm
    g = torch.Generator().manual_seed(6)
    M, K, N = 4, 4096, 96
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    w = posit_codec.encode(torch.randn(N, K, generator=g) / K ** 0.5, P16_2)
    w = w.T if layout == "t" else w.T.contiguous()
    xf, W = x.float(), posit_codec.decode(w, P16_2)
    want = pm.posit_gemv_f(x, w, P16_2)
    bound = pm.sum_bound(x, w, None, P16_2)
    assert bool(((want - torch.matmul(xf, W)).abs() <= bound).all())
    ks = (pm.split_k_t(N, K) if layout == "t"
          else pm.gemv_f_split_k(N, K))[0]
    assert ks < K
    chip_smoke._gemv_f_faults("test", xf, W, want, bound, ks)
    with pytest.raises(SystemExit):
        chip_smoke._gemv_f_faults("test", xf, W, want,
                                  torch.full_like(bound, float("inf")), ks)


@pytest.mark.parametrize("layout", ["kn", "t"])
def test_float_gemv_rows_check_rejects_an_m_dependence(layout):
    """Phase 3's row check (`_gemv_f_rows_check`): a GEMV computed row by
    row passes at M 1-8, over [K, N] codes and the transpose of [N, K]
    codes; one whose row 0 moves by one ulp at a single M (a sum order
    that depends on M) fails it."""
    from repro_torch.core.formats import P16_2
    from repro_torch.kernels import posit_codec
    from repro_torch.kernels import posit_matmul as pm
    g = torch.Generator().manual_seed(30)
    K, N = 256, 40
    x = torch.randn(8, K, generator=g).to(torch.bfloat16)
    w = posit_codec.encode(torch.randn(N, K, generator=g) / K ** 0.5, P16_2)
    w = w.T if layout == "t" else w.T.contiguous()

    def by_rows(xm, wm, fmt):
        return torch.cat([pm.posit_gemv_f(xm[i:i + 1], wm, fmt)
                          for i in range(xm.shape[0])])

    def m_dependent(xm, wm, fmt):
        out = by_rows(xm, wm, fmt)
        if xm.shape[0] == 3:
            out[0] = torch.nextafter(out[0], torch.full_like(out[0], 1e30))
        return out

    chip_smoke._gemv_f_rows_check(by_rows, x, w, P16_2, "test")
    with pytest.raises(SystemExit, match=r"differ at M \[3\]"):
        chip_smoke._gemv_f_rows_check(m_dependent, x, w, P16_2, "test")


@pytest.mark.parametrize("names,ok", [
    (["void (anonymous namespace)::posit_gemv_f_kernel<4, ActBf16, short, "
      "DecodeP16_2Table>(...)"], True),
    (["void (anonymous namespace)::posit_gemv_f_kernel<4, ActBf16, short, "
      "DecodeP16_2Table>(...)",
      "(anonymous namespace)::posit_gemv_f_reduce_kernel(...)"], False),
    (["void at::native::vectorized_elementwise_kernel<4, FillFunctor>",
      "void (anonymous namespace)::posit_gemv_f_kernel<...>"], False),
    ([], False)])
def test_float_gemv_one_launch_check(names, ok):
    """Phase 3's one-launch check (`_check_one_launch`) passes one
    posit_gemv_f kernel a call and fails a second launch (a separate
    reduce, a fill ahead of the GEMV) or none."""
    if ok:
        chip_smoke._check_one_launch(names, "posit_gemv_f", "test")
    else:
        with pytest.raises(SystemExit, match="one launch a call"):
            chip_smoke._check_one_launch(names, "posit_gemv_f", "test")


def _smoke_engine_calls(arch):
    """13b's smoke engine of `arch` on the CPU with every kernel wrapper's
    calls captured (`_capture_calls("cpu")`): (label, calls)."""
    import numpy as np
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import packing
    from repro_torch.serve import Request, ServingEngine
    cfg = configs.get_smoke(arch).replace(
        quant=policy_by_name("serve_fused_p16"))
    params = packing.pack_params(api.init(torch.Generator().manual_seed(5),
                                          cfg, device="cpu"), cfg)
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab_size, 32)
    eng = ServingEngine(cfg, params, batch_slots=4, max_seq=128, greedy=True,
                        device="cpu")
    for rid, n in enumerate(rng.integers(4, 41, 6)):
        prompt = np.concatenate([system, rng.integers(0, cfg.vocab_size,
                                                      int(n))])
        eng.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                           max_new_tokens=8))
    with chip_smoke._capture_calls("cpu") as calls:
        eng.run()
    return f"{arch} smoke", calls


def _untimed(monkeypatch):
    """chip_smoke's timers as plain calls (no card to time on)."""
    monkeypatch.setattr(chip_smoke, "_device_ms",
                        lambda fn, launches, replays=3: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "_time_once_ms",
                        lambda fn: (fn(), 0.0)[1])


@pytest.mark.parametrize("arch,kernels", [
    ("jamba_1_5_large", {"posit_decode", "posit_encode", "paged_attention",
                         "decode_sample", "prefill_attention",
                         "posit_matmul_grouped"}),
    ("mamba2_1_3b", {"posit_decode", "posit_encode"})])
def test_smoke_replays_hold_each_captured_call(monkeypatch, arch, kernels):
    """13b's capture and replay on the CPU, where each wrapper runs its
    plain version (the float GEMV is reached only on the card): the run's
    calls are captured once a signature, each kernel the run reaches is
    replayed within its limit with every planted fault rejected, and each
    record counts the smoke run's launches alone."""
    _untimed(monkeypatch)
    label, calls = _smoke_engine_calls(arch)
    names = [name for name, _ in calls]
    counts = {k: 1 for k, spec in chip_smoke._REPLAYS.items()
              if spec[0] in names}
    assert set(counts) == kernels
    sigs = [(n, tuple((k, tuple(v.shape), v.dtype) if torch.is_tensor(v)
                      else (k, repr(v)) for k, v in a.items()))
            for n, a in calls]
    assert len(set(sigs)) == len(sigs)
    recs = chip_smoke._replay_smoke_calls(label, calls, counts)
    assert {r["counter"] for r in recs} == kernels
    assert all(r["paths"] == (label,) and r["max_abs_err"] == 0.0
               for r in recs)
    with pytest.raises(SystemExit):
        chip_smoke._replay_smoke_calls(label, calls,
                                       dict(counts, posit_gemv_f=1))


@pytest.mark.parametrize("module,fn,wrong", [
    ("paged_attention", "paged_attention", lambda out: out * (1 + 1e-3)),
    ("prefill_attention", "prefill_attention_paged",
     lambda out: (out[0] * (1 + 1e-3),) + tuple(out[1:])),
    ("posit_matmul", "posit_matmul_grouped", lambda out: out * (1 + 1e-4)),
    ("paged_attention", "decode_sample", lambda out: (out + 1) % 257),
    ("posit_codec", "encode", lambda out: out ^ 1)])
def test_smoke_replays_reject_a_wrong_kernel(monkeypatch, module, fn, wrong):
    """A kernel whose output is off by a relative 1e-3 (attention), 1e-4
    (K9), one token (K4) or one code (K2) fails its replay."""
    import importlib
    _untimed(monkeypatch)
    label, calls = _smoke_engine_calls("jamba_1_5_large")
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    right = getattr(mod, fn)
    monkeypatch.setattr(mod, fn, lambda *a, **kw: wrong(right(*a, **kw)))
    counts = {k: 1 for k, spec in chip_smoke._REPLAYS.items()
              if spec[0] == fn}
    with pytest.raises(SystemExit):
        chip_smoke._replay_smoke_calls(label, calls, counts)


def test_ssd_layer_gaps_on_the_cpu(monkeypatch):
    """13a's SSD witness at mamba2's smoke config (2 layers, ssm_chunk 8)
    on a 64-token prompt: on the CPU the row groups' projections are
    bitwise all rows' (MKL's sums do not depend on M here), so every layer
    is bitwise, the SSD chunked is bitwise whole with both layers' A_log,
    and its recurrence is within MAMBA_RECURRENCE_TOL."""
    import numpy as np
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import packing
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    cfg = configs.get_smoke("mamba2_1_3b").replace(
        quant=policy_by_name("serve_fused_p16"))
    params = packing.pack_params(api.init(torch.Generator().manual_seed(5),
                                          cfg, device="cpu"), cfg)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, 64).astype(np.int32)
    found = chip_smoke._ssd_layer_gaps(cfg, params, prompt, CPU)
    for layers, readings in found.values():
        assert layers == [0.0] * cfg.n_layers
        assert readings.pop("in_proj rows") == (True, 0.0)
        assert len(readings) == 2
        assert all(bitwise and gap <= chip_smoke.MAMBA_RECURRENCE_TOL
                   for bitwise, gap in readings.values())


def _leaf_case(seed, n=2, L=3001):
    """n pods' gradients (magnitudes 1e-9 to 10, some exact zeros) and
    residuals of one leaf, reduced by `compress.compressed_psum_leaf`."""
    import numpy as np
    from repro_torch.optim import compress
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1, (n, L)) * 10.0 ** rng.uniform(-9, 1, (n, L))
    g[:, ::13] = 0.0
    gs = [torch.from_numpy(x.astype(np.float32)) for x in g]
    errs = [torch.from_numpy(rng.normal(0, 1e-3, L).astype(np.float32))
            for _ in range(n)]
    red, new = compress.compressed_psum_leaf(gs, errs)
    return gs, errs, red, new


@pytest.mark.parametrize("n", [2, 4])
def test_compress_checks_hold_the_reduction(n):
    """Phase 16b's checks of a leaf's reduction on the CPU: the reduced
    gradient within P(8,2)'s rounding bound of the f32 mean and error
    feedback conserving the sum, both at most 1, on every element and on a
    leading cut of the elements."""
    from repro_torch.core.formats import P8_2
    gs, errs, red, new = _leaf_case(n, n)
    for limit in (None, 1000):
        a, b = chip_smoke._compress_checks(gs, errs, red, new, P8_2, limit)
        assert a <= 1.0 and b <= 1.0, (a, b)


@pytest.mark.parametrize("fault", ["stage1_residual_dropped",
                                   "stage2_residual_dropped",
                                   "pod_left_out", "one_code_off"])
def test_compress_checks_reject_planted_faults(fault):
    """A reduction with a residual left out (either stage's), one pod's
    gradient left out of the sum, or every reduced value one P(8,2) code
    off must fail one of the two checks."""
    from repro_torch.core.formats import P8_2
    from repro_torch.kernels import posit_codec as pc
    from repro_torch.optim import compress
    gs, errs, red, new = _leaf_case(7)
    n, L = len(gs), gs[0].numel()
    gf = [g + e for g, e in zip(gs, errs)]
    dec = [pc.decode_plain(pc.encode_plain(x, P8_2), P8_2) for x in gf]
    if fault == "stage1_residual_dropped":
        new = [e - (x - d) for e, x, d in zip(new, gf, dec)]
    elif fault == "stage2_residual_dropped":
        s = dec[0] + dec[1]
        seg = s - pc.decode_plain(pc.encode_plain(s, P8_2), P8_2)
        Ls = -(-L // n)
        new = [e.clone() for e in new]
        for i in range(n):
            new[i][i * Ls:(i + 1) * Ls] -= seg[i * Ls:(i + 1) * Ls]
    elif fault == "pod_left_out":
        red, _ = compress.compressed_psum_leaf(
            [gs[0], torch.zeros_like(gs[1])], errs)
    else:
        codes = pc.encode_plain(red[0] * n, P8_2).to(torch.int32)
        nxt = torch.where(codes >= 0, codes + 1, codes - 1)
        red = [pc.decode_plain(nxt.to(torch.int8), P8_2) / n] * n
    a, b = chip_smoke._compress_checks(gs, errs, red, new, P8_2)
    assert a > 1.0 or b > 1.0, (fault, a, b)


def _dryrun_case():
    """Phase 17's gates at smoke size on the CPU: qwen3-moe's smoke
    config, packed, a decode step over the dense cache at 2 rows,
    reckoned on meta (`record`), and the same state allocated on the CPU
    (`held` its bytes) with the launches the card would count (`counts`,
    here the reckoned ones, every key of `ops.launch_counts()`)."""
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import packing
    from repro_torch.models.config import ShapeConfig
    cfg = configs.get_smoke("qwen3_moe_235b").replace(
        quant=policy_by_name("serve_fused_p16"))
    shape = ShapeConfig("s", 32, 2, "decode")
    cell = dryrun.build_cell(cfg, shape, make_host_mesh(), packed=True)
    record = dryrun.analyze(cell)
    params = packing.pack_params(
        api.init(torch.Generator().manual_seed(0), cfg, device=CPU), cfg)
    state = (params, torch.zeros(2, dtype=torch.int32),
             api.init_cache(cfg, 2, 32, device=CPU))
    counts = {k: 0 for k in ops.launch_counts()}
    counts.update(record["work"]["launches"])
    return cell, record, chip_smoke._device_bytes(state, CPU), counts


def test_dryrun_gates_hold_on_an_exact_reckoning():
    _, record, held, counts = _dryrun_case()
    assert record["work"]["launches"]["posit_matmul_grouped:p16_2"] > 0
    assert chip_smoke._dryrun_mismatches(record, held, counts) == []


@pytest.mark.parametrize("fault", ["launch_off_by_one", "leaf_dtype"])
def test_dryrun_gates_reject_planted_faults(fault):
    """A card that launched one more K9 `p16_2` than reckoned, or a
    reckoning that takes one state leaf (the packed wq codes) in the wrong
    dtype, must fail phase 17's exact gates."""
    from repro_torch.launch import dryrun
    cell, record, held, counts = _dryrun_case()
    if fault == "launch_off_by_one":
        counts["posit_matmul_grouped:p16_2"] += 1
        want = "posit_matmul_grouped:p16_2"
    else:
        wq = cell.state["params"]["layers"]["wq"]
        cell.state["params"]["layers"]["wq"] = torch.empty(
            wq.shape, dtype=torch.float32, device="meta")
        record = dict(record, memory=dryrun.memory(cell))
        want = "state bytes"
    bad = chip_smoke._dryrun_mismatches(record, held, counts)
    assert len(bad) == 1 and want in bad[0], bad


def _graph_runs():
    """Phase 18's records of a graphed and an eager run that agree: 5
    decode steps, the first the warm-up, one program a step."""
    graphed = dict(streams={0: [5, 9, 9, 2, 7], 1: [3, 3, 8, 1, 4]},
                   launches={"posit_gemv_f": 140, "posit_gemv_f:p16_2": 140,
                             "decode_sample": 5, "decode_sample:p16_2": 5},
                   steps=5, programs=5, replays=4, captured=True)
    eager = dict(graphed, streams={r: list(t) for r, t in
                                   graphed["streams"].items()},
                 launches=dict(graphed["launches"]), replays=0,
                 captured=False)
    return graphed, eager


def test_graph_gates_hold_on_equal_runs():
    assert chip_smoke._graph_mismatches("18 t", *_graph_runs(), 1) == []


@pytest.mark.parametrize("fault", ["token", "launches", "variant",
                                   "replays", "programs", "steps"])
def test_graph_gates_reject_planted_faults(fault):
    """A differing token, a launch count off by one (a kernel's total or a
    variant's alone), a replay missing, the programs a step wrong, or a
    step more must each fail phase 18's gates."""
    graphed, eager = _graph_runs()
    if fault == "token":
        graphed["streams"][1][3] += 1
    elif fault == "launches":
        eager["launches"]["posit_gemv_f"] += 1
    elif fault == "variant":
        graphed["launches"]["posit_gemv_f:p16_2_t"] = 1
    elif fault == "replays":
        graphed["replays"] -= 1
    elif fault == "programs":
        graphed["programs"] = 10
    else:
        eager["steps"] += 1
        eager["programs"] += 1
    bad = chip_smoke._graph_mismatches("18 t", graphed, eager, 1)
    assert len(bad) == 1, bad


# ---------------------------------------------------------------------------
# K5's tc_f32 exactness probe and K8's replay (phases 3 and 7)
# ---------------------------------------------------------------------------


def _lo_dropped(x):
    """x (f32) as its first two bf16 terms: the lo term left out."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _split_attention(a, drop=None):
    """The probe's attention from the f32 operands (sums in float64, p in
    f32 as the kernel forms it), with the lo bf16 term of `drop` left out:
    "q" (q * scale), "k_chunk", "k_history", "v" (chunk and history) or
    "p"; a tc_f32 kernel that lost that term."""
    import math
    q, k, v = a["q"], a["k"], a["v"]
    B, C, Hq, Dh = q.shape
    kp, vp, bt = a["k_pages"], a["v_pages"], a["block_tables"].long()
    qs = q * (1.0 / math.sqrt(Dh))
    if drop == "q":
        qs = _lo_dropped(qs)
    out = torch.zeros(B, C, Hq, Dh)
    for b in range(B):
        start = int(a["starts"][b])
        hk = kp[bt[b]].reshape(-1, Dh)[:start]
        hv = vp[bt[b]].reshape(-1, Dh)[:start]
        ck, cv = k[b, :, 0], v[b, :, 0]
        if drop == "k_history":
            hk = _lo_dropped(hk)
        if drop == "k_chunk":
            ck = _lo_dropped(ck)
        if drop == "v":
            hv, cv = _lo_dropped(hv), _lo_dropped(cv)
        keys, vals = torch.cat([hk, ck]), torch.cat([hv, cv])
        for j in range(C):
            n = start + j + 1
            s = qs[b, j, 0].double() @ keys[:n].double().T
            pr = torch.exp(s - s.max()).float()
            if drop == "p":
                pr = _lo_dropped(pr)
            out[b, j, 0] = ((pr.double() @ vals[:n].double())
                            / pr.double().sum()).float()
    return out, kp, vp


def test_k5_probe_holds_an_exact_kernel():
    """Every operand of the probe splits into three nonzero bf16 terms
    somewhere; an attention that keeps every term is within K5's f32 limit
    of the plain version at every row: exactly at the probes whose sums are
    exact, within exp's rounding at p's probe (the last of each four)."""
    gaps = chip_smoke._k5_probe(CPU, run=lambda **a: _split_attention(a))
    for side in gaps.values():
        assert max(side[:3]) == 0.0 and side[3] < 1e-5


@pytest.mark.parametrize("drop,where", [
    ("q", "both"), ("k_chunk", "chunk"), ("k_history", "history"),
    ("v", "both"), ("p", "both")])
def test_k5_probe_rejects_a_dropped_term(drop, where):
    """A tc_f32 split with one term dropped (the lo term of q * scale, of
    the chunk's keys, of the history's keys, of the values, of p) fails
    the probe at K5's contract limit (2e-5): each probe row's output hangs
    on that term."""
    with pytest.raises(SystemExit, match="exactness probe"):
        chip_smoke._k5_probe(CPU, run=lambda **a: _split_attention(a, drop))
    a = chip_smoke._k5_probe_inputs(CPU)
    from repro_torch.kernels import prefill_attention as tpf
    want = tpf.prefill_attention_paged_plain(
        **dict(a, k_pages=a["k_pages"].clone(),
               v_pages=a["v_pages"].clone()))[0]
    gaps = chip_smoke._k5_probe_gaps(_split_attention(a, drop)[0], want)
    for side in ("chunk", "history"):
        assert (max(gaps[side]) > 4e-5) == (where in (side, "both"))


@pytest.fixture(scope="module")
def w10_calls():
    """K8's captured calls of a CPU bit_exact engine run of command-r's
    smoke config at PDPU_P13_16_N8_W10 (read only by the tests)."""
    import dataclasses
    import numpy as np
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import packing
    from repro_torch.serve import Request, ServingEngine
    quant = dataclasses.replace(policy_by_name("validate_bit_exact"),
                                pdpu_n=8, pdpu_w_m=10)
    cfg = configs.get_smoke("command_r_35b").replace(quant=quant)
    params = packing.pack_params(api.init(torch.Generator().manual_seed(3),
                                          cfg, device="cpu"), cfg)
    rng = np.random.default_rng(3)
    eng = ServingEngine(cfg, params, batch_slots=2, max_seq=32, greedy=True,
                        device="cpu")
    for rid, n in enumerate((5, 9)):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=2))
    with chip_smoke._capture_calls("cpu", names=("pdpu_matmul",)) as calls:
        eng.run()
    return calls


def test_k8_replay_holds_the_w10_run(monkeypatch, w10_calls):
    """Phase 7's W_m 10 run's K8 calls, replayed on the CPU (the wrapper's
    plain version on both sides): bitwise on the checked columns, the
    planted W_m + 1 rejected; one record for K8 counting the run alone."""
    _untimed(monkeypatch)
    monkeypatch.setattr(chip_smoke, "k8_sass_ops", lambda variant: dict(
        step_ops=100.0, decode_ops=20.0))
    calls = w10_calls
    assert calls and all(a["cfg"].w_m == 10 and a["cfg"].N == 8
                         for _, a in calls)
    recs = chip_smoke._replay_smoke_calls(chip_smoke.BIT_EXACT_W10, calls,
                                          {"pdpu_matmul": 1},
                                          only=("pdpu_matmul",))
    assert [r["counter"] for r in recs] == ["pdpu_matmul"]
    assert recs[0]["paths"] == (chip_smoke.BIT_EXACT_W10,)


def test_k8_replay_rejects_a_variant_with_w_m_off_by_one(monkeypatch,
                                                        w10_calls):
    """A K8 variant that runs W_m + 1 (or W_m - 1) fails the replay."""
    import dataclasses
    from repro_torch.kernels import pdpu_dot
    _untimed(monkeypatch)
    monkeypatch.setattr(chip_smoke, "k8_sass_ops", lambda variant: dict(
        step_ops=100.0, decode_ops=20.0))
    calls = w10_calls
    right = pdpu_dot.pdpu_matmul
    for delta in (1, -1):
        monkeypatch.setattr(pdpu_dot, "pdpu_matmul", lambda a, b, cfg: right(
            a, b, dataclasses.replace(cfg, w_m=cfg.w_m + delta)))
        with pytest.raises(SystemExit, match="bitwise"):
            chip_smoke._replay_smoke_calls("w10", calls, {"pdpu_matmul": 1},
                                           only=("pdpu_matmul",))
