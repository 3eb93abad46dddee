"""Device times of K5 with f32 activations and of K8 at the paper's Table I
configurations, and a bit_exact serving run at PDPU_P13_16_N8_W10, with
the repro_torch under ROOT/src:

    python scripts/time_k5_k8.py ROOT LABEL [--serve]

ROOT is a checkout of this repository (or a copy of one of its commits,
e.g. from `git archive`): run it once per tree, in turns (parent, change,
change, parent), one after another on the same card, to compare two
versions of the kernels.  The data are drawn on the card from fixed
seeds, so every tree sees the same inputs.  Times are CUDA-graph replays
timed by CUDA events (ms per call), each beside the variant the tree's
wrapper launched; K8's outputs are digested (equal across trees exactly
when the codes are).  K5: 4 slots, a 64-token chunk, P(8,2) pages, at the
serving shape (64 / 8 heads of 128, 16 pages a slot), the long span (128
pages) and gemma3-4b's chunk (8 / 4 heads of 256, 128 pages) with its
window and globally.  K8: M 4 and M 64, K 8192, N 1024, and P(10/16,2) N 8
with 3 guard bits (the run-time kernel in every tree).  --serve adds
command-r-35b at 2 of 40 layers under validate_bit_exact at pdpu_n 8,
pdpu_w_m 10 serving phase 7's 4 requests x 8 tokens (the tree's
chip_smoke._run_engine: tokens/s, prefill share).  Prints one line
"AB {json}"."""
import dataclasses
import hashlib
import importlib.util
import json
import math
import sys

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, f"{root}/src")
import torch  # noqa: E402
from repro_torch import set_float32_parity  # noqa: E402
from repro_torch.core import formats, posit  # noqa: E402
from repro_torch.kernels import ops, pdpu_dot  # noqa: E402
from repro_torch.kernels import prefill_attention as pf  # noqa: E402


def device_ms(fn, launches=3, replays=3):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * launches)


def launched(before):
    """The variant keys whose counts rose since `before`."""
    now = ops.launch_counts()
    return sorted(k.split(":", 1)[1] for k, n in now.items()
                  if ":" in k and n > before.get(k, 0))


set_float32_parity()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(32)
res = {"label": label}

# K5 at f32 activations: (name, M pages, starts, Hq, Hkv, Dh, window)
for name, M, starts, Hq, Hkv, Dh, window in (
        ("serving", 16, [64, 64, 130, 190], 64, 8, 128, 1 << 30),
        ("long_span", 128, [1024, 1024, 1500, 1984], 64, 8, 128, 1 << 30),
        ("gemma3_window", 128, [1024, 1100, 1500, 1960], 8, 4, 256, 1024),
        ("gemma3_global", 128, [1024, 1100, 1500, 1960], 8, 4, 256,
         1 << 30)):
    B, C, ps = 4, 64, 16
    P = B * M + 1
    kp, vp = (posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g,
                                     device=dev), formats.P8_2)
              for _ in range(2))
    bt = torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, M)
    q = torch.randn(B, C, Hq, Dh, generator=g, device=dev)
    k = torch.randn(B, C, Hkv, Dh, generator=g, device=dev)
    v = torch.randn(B, C, Hkv, Dh, generator=g, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    win = torch.tensor([window], dtype=torch.int32, device=dev)
    kw = dict(fmt_kv=formats.P8_2, compute_dtype=torch.float32)
    before = dict(ops.launch_counts())
    out = pf.prefill_attention_paged(q, k, v, kp, vp, bt, st, win, **kw)[0]
    res[f"k5_{name}_variant"] = launched(before)
    res[f"k5_{name}"] = device_ms(lambda: pf.prefill_attention_paged(
        q, k, v, kp, vp, bt, st, win, **kw), launches=5)
    del kp, vp, q, k, v, out
torch.cuda.empty_cache()

# K8 at the Table I configurations (the quire excepted: pdpu._validate
# refuses it) and one off the table
cfgs = {n: getattr(formats, n) for n in dir(formats)
        if n.startswith("PDPU_") and "QUIRE" not in n}
cfgs["P10_16_N8_W14_G3"] = dataclasses.replace(formats.PDPU_P10_16_N8_W14,
                                               guard_bits=3)
K, N = 8192, 1024
for name, cfg in sorted(cfgs.items()):
    a64 = posit.pack(torch.randn(64, K, generator=g, device=dev), cfg.fmt_in)
    b = posit.pack(torch.randn(K, N, generator=g, device=dev) / math.sqrt(K),
                   cfg.fmt_in)
    a4 = a64[:4].contiguous()
    before = dict(ops.launch_counts())
    out = pdpu_dot.pdpu_matmul(a64, b, cfg)
    res[f"k8_{name}_variant"] = launched(before)
    res[f"k8_{name}_digest"] = hashlib.sha256(
        out.cpu().numpy().tobytes()).hexdigest()[:16]
    res[f"k8_{name}_m4"] = device_ms(lambda: pdpu_dot.pdpu_matmul(a4, b, cfg))
    res[f"k8_{name}_m64"] = device_ms(
        lambda: pdpu_dot.pdpu_matmul(a64, b, cfg), launches=2)
    del a64, a4, b, out
torch.cuda.empty_cache()

if "--serve" in sys.argv:
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  f"{root}/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    quant = dataclasses.replace(policy_by_name("validate_bit_exact"),
                                pdpu_n=8, pdpu_w_m=10)
    cfg = configs.get("command_r_35b").replace(n_layers=2, quant=quant)
    params = api.init(torch.Generator(device=dev).manual_seed(10), cfg,
                      device=dev)
    params["embed"].mul_(1.0 / math.sqrt(cfg.d_model))
    params = packing.pack_params(params, cfg)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 24, 32, 20)]
    before = dict(ops.launch_counts())
    streams = smoke._run_engine(cfg, params, prompts, f"{label} w10",
                                new_tokens=8, greedy=True, max_seq=64,
                                page_size=16, base_seed=1)[0]
    res["w10_k8_variants"] = launched(before)
    res["w10_streams_digest"] = hashlib.sha256(json.dumps(
        streams, sort_keys=True).encode()).hexdigest()[:16]

res["device"] = torch.cuda.get_device_name(0)
print("AB " + json.dumps(res))
