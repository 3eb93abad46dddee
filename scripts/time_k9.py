"""K9 (the grouped posit GEMM) of the repro_torch under ROOT/src on the
card, at the MoE training shapes and at qwen3's serving shapes:

    python scripts/time_k9.py ROOT LABEL [--train]

ROOT is a checkout of this repository (or a `git archive` of one of its
commits): run it once per tree, in turns (parent, change, change, parent),
one process after another on the same card, to compare two versions.  The
data are drawn on the card from fixed seeds, so every tree sees the same
inputs.  Prints one line "AB {json}" with, by key:
  train_qwen3 / train_deepseek: K9 over one layer's three expert GEMMs at
    the MoE training shape (qwen3-moe-235b: E 128, 40 capacity rows,
    [4096, 1536] x 2 and [1536, 4096]; deepseek-moe-16b: E 64, 64 rows,
    [2048, 1408] x 2 and [1408, 2048]), P(13,2) activations and weights:
    the variants launched, ms a call (CUDA-graph replay timed by CUDA
    events), ms a call by CUDA kernel (torch.profiler), the largest error
    in units of u sqrt(K) ||a_i . b_j|| against the plain version (limit
    posit_matmul.SUM_TOL), torch.bmm on the decoded f32 stacks (ms, the
    same replay), and the bounds: bytes (codes read once, f32 out) over
    3.35 TB/s, the exact form's operations (4 bf16 products a
    multiply-add) over 989 TFLOP/s, f32 FMA over 67 TFLOP/s;
  serve_full / serve_routed: K9 over one qwen3 layer's 3 expert GEMMs at
    the serving capacity (E 128, 8 rows, f32 activations x P(16,2)), every
    row occupied and a decode step's routing (4 tokens top-8): the
    variants, ms and a digest of the outputs, equal across two trees
    exactly when the kernels' values are.
With --train, also one MoE training run of each model at full width, as
chip_smoke.py's phase 11 drives it (qwen3 1 of 94 layers with adafactor,
deepseek 4 of 28 with AdamW; 4 steps of 8 x 128 tokens, then one step
under torch.profiler), under "step_<model>": the lines it printed about
step time and device time by kernel group."""
import contextlib
import hashlib
import io
import json
import math
import re
import sys

root, label = sys.argv[1], sys.argv[2]
train = "--train" in sys.argv[3:]
sys.path.insert(0, f"{root}/src")
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from repro_torch import set_float32_parity  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.kernels import ops, posit_codec, work  # noqa: E402
from repro_torch.kernels import posit_matmul as pm  # noqa: E402
from repro_torch.launch.mesh import HW  # noqa: E402


def device_ms(fn, launches=1, replays=5):
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


def kernel_ms(fn, calls=3):
    """Device ms a call of each CUDA kernel fn launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            found = re.search(r"\w+_kernel", evt.key)
            name = found.group(0) if found else evt.key[:40]
            out[name] = out.get(name, 0.0) + \
                evt.self_device_time_total / 1e3 / calls
    return out


def variants(fn):
    ops.reset_launches()
    fn()
    return {key.split(":")[1]: n for key, n in ops.launch_counts().items()
            if key.startswith("posit_matmul_grouped:") and n}


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def training_shape(E, M, KN, seed):
    """One layer's 3 expert GEMMs at a training shape, as the grouped STE's
    forward runs them (P(13,2) codes of both operands)."""
    f = formats.P13_2
    g = torch.Generator(device=dev).manual_seed(seed)
    acts = {K: posit_codec.encode(torch.randn(E, M, K, generator=g,
                                              device=dev), f)
            for K in sorted({K for K, _ in KN})}
    layer = [(acts[K], posit_codec.encode(torch.randn(
        E, K, N, generator=g, device=dev) / math.sqrt(K), f)) for K, N in KN]
    run = lambda: [pm.posit_matmul_grouped(a, b, f, f)  # noqa: E731
                   for a, b in layer]
    rec = dict(variants=variants(run), ms=device_ms(run),
               ms_by_kernel=kernel_ms(run))
    units = 0.0
    for a, b in layer:
        gap = (pm.posit_matmul_grouped(a, b, f, f)
               - pm.posit_matmul_grouped_plain(a, b, f, f)).abs()
        unit = pm.sum_bound(a, b, f, f) / pm.SUM_TOL
        units = max(units, float((gap / unit.clamp(min=1e-30)).max()))
        del gap, unit
    rec["err_units"] = units
    decoded = [(posit_codec.decode(a, f), posit_codec.decode(b, f))
               for a, b in layer]
    rec["bmm_ms"] = device_ms(lambda: [torch.bmm(a, b) for a, b in decoded])
    del decoded, layer, acts
    torch.cuda.empty_cache()
    w = work.total(work.grouped(E, M, K, N, 2, 2, 4, "tc_p13_2")
                   for K, N in KN)
    rec["bound_bytes_ms"] = w.bytes / HW["hbm_bw"] * 1e3
    rec["bound_exact_ms"] = w.ops / HW["peak_flops_bf16"] * 1e3
    rec["bound_f32_ms"] = w.flops / HW["peak_flops_f32"] * 1e3
    return rec


def serving():
    """qwen3's serving K9 (chip_smoke.py's phase-3 inputs): every row of
    the 8 occupied, and a decode step's routing."""
    fb = formats.P16_2
    E, M, T, k = 128, 8, 4, 8
    KN = ((4096, 1536), (4096, 1536), (1536, 4096))
    g = torch.Generator(device=dev).manual_seed(9)
    weights = {kn: posit_codec.encode(torch.randn(
        E, *kn, generator=g, device=dev) / math.sqrt(kn[0]), fb)
        for kn in sorted(set(KN))}
    full = {K: torch.randn(E, M, K, generator=g, device=dev)
            for K in (4096, 1536)}
    choice = torch.stack([torch.randperm(E, generator=g, device=dev)[:k]
                          for _ in range(T)]).tolist()
    routed = {}
    for K, x in full.items():
        buf = torch.zeros_like(x)
        fill = [0] * E
        for t in range(T):
            for e in choice[t]:
                buf[e, fill[e]] = x[t, 0]
                fill[e] += 1
        routed[K] = buf
    out = {}
    for name, acts in (("serve_full", full), ("serve_routed", routed)):
        run = lambda: [pm.posit_matmul_grouped(  # noqa: E731
            acts[K], weights[(K, N)], None, fb) for K, N in KN]
        out[name] = dict(variants=variants(run), ms=device_ms(run, 3, 3),
                         digest=digest(run()))
    return out


set_float32_parity()
dev = torch.device("cuda")
res = {"label": label, "device": torch.cuda.get_device_name(0)}
res["train_qwen3"] = training_shape(
    128, 40, ((4096, 1536), (4096, 1536), (1536, 4096)), 31)
res["train_deepseek"] = training_shape(
    64, 64, ((2048, 1408), (2048, 1408), (1408, 2048)), 32)
res.update(serving())
torch.cuda.empty_cache()
if train:
    sys.path.insert(0, root)
    import chip_smoke  # noqa: E402
    for arch, layers, optimizer in chip_smoke.MOE_TRAIN:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            chip_smoke._moe_train_full_width(dev, arch, layers, optimizer)
        res[f"step_{arch}"] = [
            line for line in text.getvalue().splitlines()
            if "median step" in line or line.startswith("profile")]
print("AB " + json.dumps(res))
