"""K5 (the fused prefill attention) of the repro_torch under ROOT/src on
the card: its device time at gemma3-4b's chunk shape, digests of its
outputs at chip_smoke.py's phase-3 shapes, and a torch.profiler breakdown
of one gemma3-4b prefill chunk group at full width:

    python scripts/time_k5.py ROOT LABEL

ROOT is a checkout of this repository (or a `git archive` of one of its
commits): run it once per tree, in turns (parent, change, change, parent),
one after another on the same card, to compare two versions.  The data
are drawn on the card from fixed seeds, so every tree sees the same
inputs.  Prints one line "AB {json}" with, by key:
  k5_gemma3_<window>: K5 at 4 slots, a 64-token chunk at starts 1024, 1100,
    1500 and 1960 over 128 pages of 16 a slot (P(8,2)), 8 / 4 heads of
    256, bf16, window 1024 or 2^30: the variant launched, ms a call
    (CUDA-graph replay timed by CUDA events), ms a call by kernel
    (torch.profiler) and max |err| against the plain version;
  k5_<case>: chip_smoke.py's phase-3 K5 cases (the same inputs): the
    variant, max |err| and a digest of the output and pages, equal across
    two trees exactly when the kernels' values are;
  chunk_group: prefill chunk groups of gemma3-4b (12 of 34 layers,
    serve_fused_p16, 4 slots x 64 tokens): the host-clock wall of the one
    at position 1536 (ending in a synchronize) and the device time by
    kernel group of the one at 1600 (torch.profiler)."""
import hashlib
import json
import math
import re
import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, f"{root}/src")
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from repro_torch import configs, set_float32_parity  # noqa: E402
from repro_torch.core import formats, posit  # noqa: E402
from repro_torch.core.quant import policy_by_name  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import prefill_attention as pf  # noqa: E402
from repro_torch.models import api, packing  # noqa: E402
from repro_torch.models.paged import PagedLayout  # noqa: E402


def device_ms(fn, launches=10, replays=3):
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


def k5_case(act, M, starts, Hkv=8, paged_fmt="P8_2", Hq=64, Dh=128,
            window=1 << 30, timed=False):
    """chip_smoke.py's _k5_case inputs: one call of K5 against its plain
    version; the variant, max |err|, a digest and (timed) ms a call."""
    fmt = getattr(formats, paged_fmt) if paged_fmt else None
    B, C, ps = 4, 64, 16
    P = B * M + 1
    g = torch.Generator(device=dev).manual_seed(5 + M)
    kp, vp = (torch.randn(P, ps, Hkv * Dh, generator=g, device=dev)
              for _ in range(2))
    kp, vp = ((posit.pack(x, fmt) for x in (kp, vp)) if fmt
              else (x.to(act) for x in (kp, vp)))
    bt = torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, M)
    shared = starts[0] // ps
    bt[1, :shared] = bt[0, :shared]
    q = torch.randn(B, C, Hq, Dh, generator=g, device=dev).to(act)
    k = torch.randn(B, C, Hkv, Dh, generator=g, device=dev).to(act)
    v = torch.randn(B, C, Hkv, Dh, generator=g, device=dev).to(act)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    win = torch.tensor([window], dtype=torch.int32, device=dev)
    ok = torch.ones(B, M, dtype=torch.int32, device=dev)
    ok[3] = 0
    kw = dict(fmt_kv=fmt, compute_dtype=act, flash_chunk=1024, page_ok=ok)
    kp0, vp0 = kp.clone(), vp.clone()
    ops.reset_launches()
    got, _, _ = pf.prefill_attention_paged(q, k, v, kp, vp, bt, st, win, **kw)
    variant = [key.split(":")[1] for key, n in ops.launch_counts().items()
               if key.startswith("prefill_attention:") and n]
    want, _, _ = pf.prefill_attention_paged_plain(q, k, v, kp0, vp0, bt, st,
                                                  win, **kw)
    digest = hashlib.sha256()
    for t in (got, kp, vp):
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    rec = dict(variant=variant,
               max_abs_err=float((got.float() - want.float()).abs().max()),
               digest=digest.hexdigest()[:16])
    if timed:
        run = lambda: pf.prefill_attention_paged(  # noqa: E731
            q, k, v, kp, vp, bt, st, win, **kw)
        rec["ms"] = device_ms(run)
        rec["ms_by_kernel"] = kernel_ms(run)
    return rec


def kernel_ms(fn, calls=5):
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


# kernel-name fragments -> the layer that launched the kernel
GROUPS = (("prefill_attention", "K5 prefill_attention"),
          ("posit_decode", "K1 posit_decode"),
          ("posit_encode", "K2 posit_encode"),
          ("gemm", "torch.matmul"), ("gemv", "torch.matmul"))


def chunk_group():
    """gemma3-4b at full width, 12 layers: 24 chunk groups of 64 tokens
    into 4 slots, the 25th timed by the host clock, the 26th profiled."""
    cfg = configs.get("gemma3_4b").replace(
        n_layers=12, quant=policy_by_name("serve_fused_p16"))
    params = api.init(torch.Generator(device=dev).manual_seed(20), cfg,
                      device=dev)
    params["embed"].mul_(1.0 / math.sqrt(cfg.d_model))
    params = packing.pack_params(params, cfg)
    max_seq, B, C = 2048, 4, 64
    cache = api.init_cache(cfg, B, max_seq, PagedLayout.for_slots(B, max_seq,
                                                                  16),
                           device=dev)
    cache["block_table"] = torch.arange(
        1, B * max_seq // 16 + 1, dtype=torch.int32,
        device=dev).reshape(B, max_seq // 16)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, 26 * C), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3),
                         dtype=torch.int32)

    def group(i):
        nonlocal cache
        _, cache = api.prefill_chunk_batched(
            params, toks[:, i * C:(i + 1) * C].contiguous(), cache, active,
            cfg)

    for i in range(24):
        group(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    group(24)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        group(25)
        torch.cuda.synchronize()
    by = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or not evt.self_device_time_total:
            continue
        name = next((n for frag, n in GROUPS if frag in evt.key),
                    "other torch ops")
        by[name] = by.get(name, 0.0) + evt.self_device_time_total / 1e3
    return dict(wall_ms=wall, device_ms=sum(by.values()),
                device_ms_by_group=by)


set_float32_parity()
dev = torch.device("cuda")
res = {"label": label, "device": torch.cuda.get_device_name(0)}
bf16 = torch.bfloat16
gemma = dict(M=128, starts=[1024, 1100, 1500, 1960], Hkv=4, Hq=8, Dh=256)
res["k5_gemma3_window_1024"] = k5_case(bf16, window=1024, timed=True,
                                       **gemma)
res["k5_gemma3_global"] = k5_case(bf16, timed=True, **gemma)
serving = dict(M=16, starts=[64, 64, 130, 190])
res["k5_serving_bf16"] = k5_case(bf16, **serving)
res["k5_serving_f32"] = k5_case(torch.float32, **serving)
res["k5_long_span"] = k5_case(bf16, 128, [1024, 1024, 1500, 1984])
res["k5_g16_p8"] = k5_case(bf16, Hkv=4, **serving)
res["k5_g16_bf16_pages"] = k5_case(bf16, Hkv=4, paged_fmt=None, **serving)
torch.cuda.empty_cache()
res["chunk_group"] = chunk_group()
print("AB " + json.dumps(res))
