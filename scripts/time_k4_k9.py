"""Device times of K9 (one qwen3 layer's 3 expert GEMMs, at full occupancy
and at a decode step's routing) and K4 (B 4 / 16 over command-r's [V, D]
and qwen3's [D, V] heads) with the repro_torch under ROOT/src:

    python scripts/time_k4_k9.py ROOT LABEL

ROOT is a checkout of this repository (or a copy of one of its commits,
e.g. from `git archive`): run it once per tree, in turns (parent, change,
change, parent) in one session on one card, to compare two versions of the
kernels.  The data are drawn on the card from fixed seeds, so every tree
sees the same inputs.  Times are CUDA-graph replays timed by CUDA events
(ms per call).  Prints one line "AB {json}"."""
import json
import math
import sys

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, f"{root}/src")
import torch  # noqa: E402
from repro_torch import set_float32_parity  # noqa: E402
from repro_torch.core import formats, posit  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import posit_codec  # noqa: E402
from repro_torch.kernels import posit_matmul as pm  # noqa: E402


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


set_float32_parity()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(9)
fb = formats.P16_2
E, M, T, k = 128, 8, 4, 8
KN = ((4096, 1536), (4096, 1536), (1536, 4096))
weights = {kn: posit_codec.encode(torch.randn(E, *kn, generator=g, device=dev)
                                  / math.sqrt(kn[0]), fb)
           for kn in sorted(set(KN))}
full = {K: torch.randn(E, M, K, generator=g, device=dev) for K in (4096, 1536)}
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
res = {"label": label}
for name, acts in (("k9_full", full), ("k9_routed", routed)):
    res[name] = device_ms(lambda: [pm.posit_matmul_grouped(
        acts[K], weights[(K, N)], None, fb) for K, N in KN])
res["k9_routed_experts"] = sum(1 for f in fill if f)
del weights, full, routed
torch.cuda.empty_cache()
for tag, D, V, transpose in (("vd", 8192, 256000, True),
                             ("dv", 4096, 151936, False)):
    w = posit.pack(torch.randn((V, D) if transpose else (D, V), generator=g,
                               device=dev) / math.sqrt(D), fb)
    x = torch.randn(16, D, generator=g, device=dev)
    noise = -torch.log(-torch.log(torch.rand(16, V, generator=g, device=dev)
                                  .clamp(1e-9, 1 - 1e-7)))
    for B in (4, 16):
        xb, nb = x[:B].contiguous(), noise[:B].contiguous()
        res[f"k4_{tag}_b{B}"] = device_ms(lambda: pa.decode_sample(
            xb, w, nb, 0.8, plan="fused", fmt_w=fb, transpose=transpose,
            greedy=False, top_k=40))
    del w
    torch.cuda.empty_cache()
print("AB " + json.dumps(res))
