"""Device times of K8 (command-r's bit_exact step shapes at M 4, the tied
head with B transposed, and a prefill M), K2 (the tied head's re-encode,
[256000, 8192] f32 into P(16,2) and P(13,2)) and K5 with f32 activations
(the tree's f32 variant: the SIMT kernel before tc_f32) with the
repro_torch under ROOT/src:

    python scripts/time_k2_k8.py ROOT LABEL

ROOT is a checkout of this repository (or a copy of one of its commits,
e.g. from `git archive`): run it once per tree, in turns (parent, change,
change, parent), one after another on the same card, to compare two
versions of the kernels.  The data are drawn on the card from fixed
seeds, so every tree sees the same inputs.  Times are CUDA-graph replays
timed by CUDA events (ms per call).  Prints one line "AB {json}"."""
import json
import math
import sys

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, f"{root}/src")
import torch  # noqa: E402
from repro_torch import set_float32_parity  # noqa: E402
from repro_torch.core import formats, posit  # noqa: E402
from repro_torch.core.quant import policy_by_name  # noqa: E402
from repro_torch.kernels import pdpu_dot, posit_codec  # noqa: E402
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


set_float32_parity()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(18)
cfg = policy_by_name("validate_bit_exact").pdpu_config()
res = {"label": label}


def codes(shape, scale=1.0):
    return posit.pack(torch.randn(*shape, generator=g, device=dev) * scale,
                      cfg.fmt_in)


# K8: (name, M, K, N_out); the head's B is the [256000, 8192] codes
# transposed
a = {K: codes((4, K)) for K in (8192, 22528)}
for name, M, K, N in (("wq_wo", 4, 8192, 8192), ("wk_wv", 4, 8192, 1024),
                      ("gate_up", 4, 8192, 22528), ("down", 4, 22528, 8192),
                      ("prefill_m64", 64, 8192, 1024)):
    x = a[K] if M == 4 else codes((M, K))
    w = codes((K, N), 1 / math.sqrt(K))
    res[f"k8_{name}"] = device_ms(lambda: pdpu_dot.pdpu_matmul(x, w, cfg))
    del x, w
head = codes((256000, 8192), 1 / math.sqrt(8192))
res["k8_head"] = device_ms(lambda: pdpu_dot.pdpu_matmul(a[8192], head.T, cfg),
                           launches=1, replays=2)
del head
torch.cuda.empty_cache()
# K2 at the tied head's shape
emb = torch.randn(256000, 8192, generator=g, device=dev)
for fmt in (formats.P16_2, formats.P13_2):
    res[f"k2_{fmt.n}_{fmt.es}"] = device_ms(
        lambda: posit_codec.encode(emb, fmt), launches=2)
del emb
torch.cuda.empty_cache()
# K5 in f32: chip_smoke.py's f32 serving case (4 slots, a 64-token chunk, 64 / 8
# heads of 128, 16 pages of 16 a slot over P(8,2), slots 0 and 1 sharing
# their history, slot 3's pages not written)
B, C, Hq, Hkv, Dh, ps, Mp = 4, 64, 64, 8, 128, 16, 16
P = B * Mp + 1
kp, vp = (posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g, device=dev),
                     formats.P8_2) for _ in range(2))
bt = torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, Mp)
bt[1, :4] = bt[0, :4]
q = torch.randn(B, C, Hq, Dh, generator=g, device=dev)
k = torch.randn(B, C, Hkv, Dh, generator=g, device=dev)
v = torch.randn(B, C, Hkv, Dh, generator=g, device=dev)
st = torch.tensor([64, 64, 130, 190], dtype=torch.int32, device=dev)
win = torch.tensor([1 << 30], dtype=torch.int32, device=dev)
ok = torch.ones(B, Mp, dtype=torch.int32, device=dev)
ok[3] = 0
res["k5_simt_f32"] = device_ms(lambda: pf.prefill_attention_paged(
    q, k, v, kp, vp, bt, st, win, fmt_kv=formats.P8_2,
    compute_dtype=torch.float32, flash_chunk=1024, page_ok=ok), launches=10)
print("AB " + json.dumps(res))
