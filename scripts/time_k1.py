"""K1 (the posit decode) and the float weight path of the repro_torch
under ROOT/src on the card:

    python scripts/time_k1.py ROOT LABEL [--steps]

ROOT is a checkout of this repository (or a `git archive` of one of its
commits): run it once per tree, in turns (parent, change, change, parent),
one process after another on the same card, to compare two versions.  The
data are drawn on the card from fixed seeds, so every tree sees the same
inputs.  Prints one line "AB {json}" with, by key:
  k1/<shape>: `posit_codec.decode` at the weight shapes that keep K1
    (command-r-35b's [8192, 22528] and command-r-plus-104b's
    [12288, 33792] P(16,2), minitron-8b's training head [4096, 256000]
    and qwen3-moe-235b's [4096, 151936] P(13,2), a dense KV cache layer's
    [4, 256, 1024] P(8,2) int8 rows): ms a call (CUDA-graph replay timed
    by CUDA events), the bytes bound (codes read once, f32 written once,
    over 3.35 TB/s) and its share, the variant counted, bitwise equal to
    the plain decode;
  path/<projection> and path/layer: command-r-35b's 7 projections at M 4
    (bf16 activations, P(16,2) weights) through `ops.matmul_posit_weights`
    (the tree's float weight path: K1 + torch.matmul in a tree without the
    float GEMV), K1 + torch.matmul, and torch.matmul on pre-decoded f32
    weights; ms each (graph replay), the bytes bound of the GEMV form (2
    bytes a code, the activations and the f32 output once);
  path/head: the same at the tied head, the transpose of [256000, 8192]
    codes, at M 4;
  each path record also holds a digest of `ops.matmul_posit_weights`'s
    output (equal across two trees exactly when the values are).
With --steps, also ROOT's chip_smoke.py phase-6 profile of command-r-35b
(4 of 40 layers, full width) decode steps at the defaults and over the
dense cache, under "steps": the lines it printed (device time by kernel
group, busy share)."""
import contextlib
import hashlib
import io
import json
import math
import sys

root, label = sys.argv[1], sys.argv[2]
steps = "--steps" in sys.argv[3:]
sys.path.insert(0, f"{root}/src")
sys.path.insert(0, root)
import torch  # noqa: E402
from repro_torch import set_float32_parity  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.kernels import ops, posit_codec, work  # noqa: E402
from repro_torch.kernels import posit_matmul as pm  # noqa: E402
from repro_torch.launch.mesh import HW  # noqa: E402

LAYER_KN = {"wq": (8192, 8192), "wk": (8192, 1024), "wv": (8192, 1024),
            "wo": (8192, 8192), "gate": (8192, 22528), "up": (8192, 22528),
            "down": (22528, 8192)}


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
    ms = start.elapsed_time(stop) / (replays * launches)
    del graph
    return ms


def digest(t):
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()[:16]


def variants(before, after, kernel):
    return {k.split(":", 1)[1]: after[k] - before.get(k, 0)
            for k in after if k.startswith(kernel + ":")
            and after[k] != before.get(k, 0)}


def k1_records(dev):
    out = {}
    cases = (("P16_2", (8192, 22528)), ("P16_2", (12288, 33792)),
             ("P13_2", (4096, 256000)), ("P13_2", (4096, 151936)),
             ("P8_2", (4, 256, 1024)))
    g = torch.Generator(device=dev).manual_seed(1)
    for name, shape in cases:
        fmt = getattr(formats, name)
        codes = posit_codec.encode(
            torch.randn(*shape, generator=g, device=dev) * 0.05, fmt)
        before = dict(ops.launch_counts())
        got = posit_codec.decode(codes, fmt)
        var = variants(before, ops.launch_counts(), "posit_decode")
        exact = bool(torch.equal(got.view(torch.int32), posit_codec.decode_plain(
            codes, fmt).view(torch.int32)))
        del got
        ms = device_ms(lambda: posit_codec.decode(codes, fmt))
        bound = work.decode(codes.numel(),
                            codes.element_size()).bound_s(HW)[0] * 1e3
        out[f"k1/{name}{list(shape)}"] = dict(
            ms=ms, bound_ms=bound, share=bound / ms, variants=var,
            bitwise=exact)
        del codes
        torch.cuda.empty_cache()
    return out


def path_records(dev):
    out = {}
    fmt = formats.P16_2
    g = torch.Generator(device=dev).manual_seed(2)
    weights = {n: posit_codec.encode(
        torch.randn(K, N, generator=g, device=dev) / math.sqrt(K), fmt)
        for n, (K, N) in LAYER_KN.items()}
    head = posit_codec.encode(torch.randn(256000, 8192, generator=g,
                                          device=dev) / math.sqrt(8192), fmt)
    weights["head"] = head.T
    M = 4
    xs = {K: torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
          for K in {8192, 22528}}
    totals = dict(ms=0.0, k1_matmul_ms=0.0, matmul_ms=0.0, bound_ms=0.0)
    for n, w in weights.items():
        K, N = w.shape
        x = xs[K]
        before = dict(ops.launch_counts())
        got = ops.matmul_posit_weights(x, w, fmt)
        var = {k: v for k, v in ops.launch_counts().items()
               if v != before.get(k, 0) and ":" in k}
        rec = dict(digest=digest(got), launched=var)
        del got
        rec["ms"] = device_ms(lambda: ops.matmul_posit_weights(x, w, fmt))
        rec["k1_matmul_ms"] = device_ms(lambda: torch.matmul(
            x.to(torch.float32), posit_codec.decode(w.T.contiguous(), fmt).T
            if n == "head" else posit_codec.decode(w, fmt)))
        wf = posit_codec.decode(w.T, fmt).T if n == "head" else \
            posit_codec.decode(w, fmt)
        xf = x.to(torch.float32)
        rec["matmul_ms"] = device_ms(lambda: torch.matmul(xf, wf))
        del wf
        rec["bound_ms"] = work.gemv_f(M, K, N, 2, 2).bound_s(HW)[0] * 1e3
        out[f"path/{n}"] = rec
        if n != "head":
            for k in totals:
                totals[k] += rec[k]
        torch.cuda.empty_cache()
    out["path/layer"] = totals
    return out


def step_lines(dev):
    import chip_smoke
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing
    import numpy as np
    cfg = configs.get("command_r_35b").replace(
        n_layers=4, quant=policy_by_name("serve_fused_p16"))
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    params["embed"].mul_(1.0 / math.sqrt(cfg.d_model))
    params = packing.pack_params(params, cfg)
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size,
                                                    int(n))]).astype(np.int32)
               for n in rng.integers(8, 57, 8)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        chip_smoke._profile(cfg, params, prompts, "defaults")
        chip_smoke._profile(cfg, params, prompts, "dense cache", steps=2,
                            paged=False)
    return buf.getvalue().splitlines()


def main():
    dev = torch.device("cuda")
    set_float32_parity()
    rec = {"label": label, "device": torch.cuda.get_device_name(0),
           "has_gemv_f": hasattr(pm, "posit_gemv_f")}
    rec.update(k1_records(dev))
    rec.update(path_records(dev))
    if steps:
        rec["steps"] = step_lines(dev)
    print("AB " + json.dumps(rec))


if __name__ == "__main__":
    main()
