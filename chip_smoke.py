#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: build the kernels, hold each
against its plain version at the serving shapes, then serve command-r-35b
at full width (depth cut to 4 layers) through the engine.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):
  1. device: name, count, `nvidia-smi` name and power limit;
  2. build: nvcc for sm_90a of every source in src/repro_torch/csrc/, with
     the -Xptxas -v register / shared-memory report;
  3. kernels: K1-K4 against their plain versions at the main path's shapes
     (K1/K2 bitwise, K3 within 2e-5, K4 equal tokens, or a score within
     1e-5 of the largest |logit| where the plain top two are that close),
     with the device time per launch (CUDA-graph replay timed by CUDA
     events; the per-call time with host overhead is printed beside it),
     the plain version's time, the bound from bytes and FLOPs at the H100
     SXM data-sheet rates, and one PyTorch call as a yardstick where one
     exists;
  4. correctness on a small input: the tiny config's logits on the card
     against the port's plain CPU path;
  5. serving: 8 requests greedy, then 8 sampled (T 0.8, top-k 40), on the
     full-width config; every kernel's launch count must be > 0 and every
     page must come back;
  6. profile: torch.profiler over a few decode steps with four slots busy,
     device time per step by kernel and the device's busy share.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
HERE = os.path.dirname(os.path.abspath(__file__))


def _bound(bytes_moved: float, flops: float):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, launches: int, replays: int = 3) -> float:
    """Device time per call: `launches` calls captured in one CUDA graph,
    replayed and timed with CUDA events (no host overhead in the figure)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as graph capture requires
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


def _time_once_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _check(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _k1_decode(dev):
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import posit_codec
    fmt = formats.P16_2
    every = posit.to_container(torch.arange(1 << 16, dtype=torch.int64), fmt)
    every = every.to(dev)
    _check(_bits_equal(posit_codec.decode(every, fmt),
                       posit_codec.decode_plain(every, fmt)),
           "K1 posit_decode on all 2^16 P(16,2) codes")
    g = torch.Generator(device=dev).manual_seed(1)
    w = (torch.randn(8192, 22528, generator=g, device=dev) *
         (1.0 / math.sqrt(8192)))
    codes = posit_codec.encode(w, fmt)
    del w
    got = posit_codec.decode(codes, fmt)
    want = posit_codec.decode_plain(codes, fmt)
    _check(_bits_equal(got, want), "K1 posit_decode at [8192, 22528]")
    call_ms = _time_ms(lambda: posit_codec.decode(codes, fmt), reps=20)
    ms = _device_ms(lambda: posit_codec.decode(codes, fmt), launches=10)
    plain_ms = _time_once_ms(lambda: posit_codec.decode_plain(codes, fmt))
    bound, by = _bound(codes.numel() * (2 + 4), 0)
    del got, want, codes
    return dict(name="posit_decode", source="src/repro_torch/csrc/posit_codec.cu",
                replaces="src/repro/kernels/posit_codec.py:55",
                max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape="[8192, 22528] int16 -> f32")


def _k2_encode(dev):
    import torch
    from repro_torch.core import formats
    from repro_torch.kernels import posit_codec
    fmt = formats.P16_2
    g = torch.Generator(device=dev).manual_seed(2)
    emb = torch.randn(256000, 8192, generator=g, device=dev)
    flat = emb.view(-1)
    special = torch.tensor(
        [0.0, -0.0, 1e-45, -3e-39, 1.17e-38, float("inf"), float("-inf"),
         float("nan"), 1e20, -1e20, 3.4e38, 2.0 ** 60, -2.0 ** -70],
        dtype=torch.float32, device=dev)
    flat[:special.numel()] = special
    # bf16-rounded values and a spread of raw bit patterns
    flat[1000:1000 + (1 << 20)] = flat[1000:1000 + (1 << 20)].to(
        torch.bfloat16).float()
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 22,), generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)
    flat[-(1 << 22):] = bits.view(torch.float32)
    got = posit_codec.encode(emb, fmt)
    want = posit_codec.encode_plain(emb, fmt)
    _check(_bits_equal(got, want), "K2 posit_encode at [256000, 8192]")
    call_ms = _time_ms(lambda: posit_codec.encode(emb, fmt), reps=5)
    ms = _device_ms(lambda: posit_codec.encode(emb, fmt), launches=2)
    plain_ms = _time_once_ms(lambda: posit_codec.encode_plain(emb, fmt))
    bound, by = _bound(emb.numel() * (4 + 2), 0)
    del got, want, emb, flat
    return dict(name="posit_encode", source="src/repro_torch/csrc/posit_codec.cu",
                replaces="src/repro/kernels/posit_codec.py:78",
                max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape="[256000, 8192] f32 -> int16")


def _k3_attention(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.core import formats, posit
    from repro_torch.kernels import paged_attention as pa
    fmt = formats.P8_2
    B, Hq, Hkv, Dh, ps, M = 4, 64, 8, 128, 16, 16
    P = B * M + 1
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, Hq, Dh, generator=g, device=dev)
    kp = posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g, device=dev), fmt)
    vp = posit.pack(torch.randn(P, ps, Hkv * Dh, generator=g, device=dev), fmt)
    bt = (torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, M))
    lengths = torch.tensor([256, 137, 0, 64], dtype=torch.int32, device=dev)
    full = torch.tensor([1 << 30], dtype=torch.int32, device=dev)
    ok = torch.ones(B, M, dtype=torch.int32, device=dev)
    ok[1, 3] = 0
    err = 0.0
    cases = [dict(window=full, softcap_val=0.0, page_ok=None, partials=False),
             dict(window=torch.tensor([100], dtype=torch.int32, device=dev),
                  softcap_val=30.0, page_ok=None, partials=False),
             dict(window=full, softcap_val=0.0, page_ok=ok, partials=True)]
    for kw in cases:
        got = pa.paged_attention(q, kp, vp, bt, lengths, fmt_kv=fmt, **kw)
        want = pa.paged_attention_plain(q, kp, vp, bt, lengths, fmt_kv=fmt,
                                        **kw)
        if not kw["partials"]:
            got, want = (got,), (want,)
        for a, b in zip(got, want):
            _check(bool(torch.isfinite(a).all()), "K3 finite outputs")
            _check(bool(torch.allclose(a, b, rtol=2e-5, atol=2e-5)),
                   f"K3 paged_attention within 2e-5 ({kw['softcap_val']=})")
            err = max(err, float((a - b).abs().max()))
        _check(bool((got[0][2] == 0).all()), "K3 zero-length slot")
    args = (q, kp, vp, bt, lengths, full)
    call_ms = _time_ms(lambda: pa.paged_attention(*args, fmt_kv=fmt),
                       reps=200)
    ms = _device_ms(lambda: pa.paged_attention(*args, fmt_kv=fmt),
                    launches=50)
    plain_ms = _time_ms(lambda: pa.paged_attention_plain(*args, fmt_kv=fmt),
                        reps=5)
    # yardstick: SDPA over the same K/V already gathered and decoded
    kd = posit.decode(kp[bt.long()], fmt).reshape(B, M * ps, Hkv, Dh)
    vd = posit.decode(vp[bt.long()], fmt).reshape(B, M * ps, Hkv, Dh)
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    q4 = q[:, :, None, :]
    library_ms = _device_ms(
        lambda: F.scaled_dot_product_attention(q4, kd, vd), launches=50)
    n_tok = int(lengths.sum())
    pages = sum(-(-int(n) // ps) for n in lengths.tolist())
    bytes_moved = (q.numel() * 4 + 2 * pages * ps * Hkv * Dh * 1
                   + bt.numel() * 4 + lengths.numel() * 4 + q.numel() * 4)
    flops = 4.0 * Hq * Dh * n_tok
    bound, by = _bound(bytes_moved, flops)
    return dict(name="paged_attention",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:266",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                shape="B=4 Hq=64 Hkv=8 Dh=128 ps=16 L<=256 int8 pages")


def _k4_decode_sample(dev):
    import torch
    from repro_torch.core import formats, posit
    from repro_torch.kernels import paged_attention as pa
    fmt = formats.P16_2
    B, D, V = 4, 8192, 256000
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
    w = posit.pack(torch.randn(V, D, generator=g, device=dev), fmt)
    u = torch.rand(B, V, generator=g, device=dev).clamp(1e-9, 1 - 1e-7)
    noise = -torch.log(-torch.log(u))
    kw = dict(plan="fused", fmt_w=fmt, transpose=True)
    logits = pa.head_logits_plain(x, w, softcap_val=0.0, **kw)
    err = 0.0
    # the kernel sums the D = 8192 products in another order than the
    # plain matmul: a token may differ only where the plain top-two scores
    # lie within 1e-5 of the largest |logit|
    tol = 1e-5 * float(logits.abs().max())
    for greedy, top_k, temp in ((True, 0, 1.0), (False, 40, 0.8),
                                (False, 0, 0.8)):
        tok = pa.decode_sample(x, w, None if greedy else noise, temp,
                               greedy=greedy, top_k=top_k, **kw)
        want = pa.sample_logits(logits, noise, temp, greedy=greedy,
                                top_k=top_k)
        l = logits if greedy else logits / temp
        if top_k:
            kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
            l = torch.where(l >= kth, l, torch.full_like(l, -1e30))
        score = l if greedy else noise + l
        rows = torch.arange(B, device=dev)
        gap = (score[rows, want.long()] - score[rows, tok.long()]).abs()
        _check(bool(((tok == want) | (gap <= tol)).all()),
               f"K4 decode_sample tokens (greedy={greedy}, top_k={top_k})")
        err = max(err, float(gap.max()))
    run = lambda: pa.decode_sample(x, w, noise, 0.8, greedy=False,  # noqa: E731
                                   top_k=40, **kw)
    call_ms = _time_ms(run, reps=10)
    ms = _device_ms(run, launches=3)
    plain_ms = _time_once_ms(lambda: pa.decode_sample_plain(
        x, w, noise, 0.8, greedy=False, top_k=40, **kw))
    bytes_moved = w.numel() * 2 + x.numel() * 4 + noise.numel() * 4 + B * 4
    bound, by = _bound(bytes_moved, 2.0 * B * V * D)
    del w, logits
    return dict(name="decode_sample",
                source="src/repro_torch/csrc/decode_sample.cu",
                replaces="src/repro/kernels/paged_attention.py:467",
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape="B=4 D=8192 V=256000 int16 [V, D], T=0.8 top-k 40")


# ---------------------------------------------------------------------------
# phase 4: small-input agreement with the plain CPU path
# ---------------------------------------------------------------------------

def _small_reference(dev):
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing
    from repro_torch.models.paged import PagedLayout
    cfg = configs.get_smoke("command_r_35b")
    cfg = cfg.replace(quant=dataclasses.replace(
        policy_by_name("serve_fused_p16"), fused_prefill=False))
    cpu = torch.device("cpu")
    params = packing.pack_params(
        api.init(torch.Generator().manual_seed(7), cfg, device=cpu), cfg)
    out = {}
    for d in (cpu, dev):
        p = {k: ({kk: vv.to(d) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(d))
             for k, v in params.items()}
        layout = PagedLayout.for_slots(2, 64, 16)
        cache = api.init_cache(cfg, 2, 64, layout, device=d)
        cache["block_table"] = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]],
                                            dtype=torch.int32, device=d)
        toks = torch.arange(40, dtype=torch.int32, device=d).reshape(2, 20) % 503
        lp, cache = api.prefill_chunk_batched(
            p, toks, cache, torch.ones(2, dtype=torch.bool, device=d), cfg)
        ld, _ = api.decode_step(p, toks[:, -1], cache, cfg)
        out[d.type] = (lp.cpu(), ld.cpu())
    err = 0.0
    for a, b in zip(out["cuda"], out["cpu"]):
        _check(bool(torch.isfinite(a).all()), "small-input logits finite")
        _check(bool(torch.allclose(a, b, rtol=1e-4, atol=1e-4)),
               "small-input logits on the card vs the plain CPU path")
        err = max(err, float((a - b).abs().max()))
    return err


# ---------------------------------------------------------------------------
# phase 5: serving the main path
# ---------------------------------------------------------------------------

def _serve(dev):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import ops
    from repro_torch.models import api, packing
    from repro_torch.serve import Request, ServingEngine

    full = configs.get("command_r_35b")
    cfg = full.replace(n_layers=4, quant=dataclasses.replace(
        policy_by_name("serve_fused_p16"), fused_prefill=False,
        prefix_sharing=False))
    print(f"config: d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, dtype {cfg.dtype}")
    print('reduced: ' + json.dumps({"n_layers": f"{full.n_layers} -> "
                                                f"{cfg.n_layers}"}))
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    params = packing.pack_params(params, cfg)
    torch.cuda.synchronize()
    print(f"init + pack on the card: {time.perf_counter() - t0:.3f} s, "
          f"weights {packing.weight_bytes(params)} B")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(24, 121, 8)]
    summaries = {}
    ops.reset_launches()
    for mode, kw in (("greedy", dict(greedy=True)),
                     ("sampled", dict(greedy=False, temperature=0.8,
                                      top_k=40))):
        engine = ServingEngine(cfg, params, batch_slots=4, max_seq=256,
                               page_size=16, fused_prefill=False,
                               prefix_sharing=False, base_seed=1, **kw)
        for rid, p in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=p, max_new_tokens=16))
        torch.cuda.reset_peak_memory_stats()
        before = dict(ops.launch_counts())
        decode_ms = []
        per_step = {k: 0 for k in before}
        t0 = time.perf_counter()
        while engine.queue or (engine.slot_phase != 0).any():
            chunks = engine.stats["prefill_chunks"]
            step_before = dict(ops.launch_counts())
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            if not engine.step():
                break
            torch.cuda.synchronize()
            if engine.stats["prefill_chunks"] == chunks:
                decode_ms.append((time.perf_counter() - s0) * 1e3)
                for k, v in ops.launch_counts().items():
                    per_step[k] += v - step_before[k]
        wall = time.perf_counter() - t0
        done = engine.done
        n_tok = sum(len(r.out_tokens) for r in done)
        _check(len(done) == 8 and all(len(r.out_tokens) == 16 for r in done),
               f"{mode}: every request served 16 tokens")
        _check(all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens),
               f"{mode}: tokens in the vocabulary")
        _check(engine.pages_free == engine.allocator.capacity,
               f"{mode}: every page reclaimed")
        counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
        summary = engine.execution_summary()
        print(f"{mode}: tokens {n_tok}, wall {wall:.3f} s, "
              f"{n_tok / wall:.2f} tok/s, mean decode step "
              f"{float(np.mean(decode_ms)):.3f} ms over {len(decode_ms)} "
              f"steps, peak memory {torch.cuda.max_memory_allocated()} B")
        print(f"{mode}: launches {json.dumps(counts)}")
        print(f"{mode}: launches per pure decode step " + json.dumps(
            {k: v / max(len(decode_ms), 1) for k, v in per_step.items()}))
        print(f"{mode}: pages_free {engine.pages_free} == capacity "
              f"{engine.allocator.capacity}")
        print(f"{mode}: execution_summary {json.dumps(summary)}")
        print(f"{mode}: first tokens {done[0].out_tokens[:8]}")
        summaries[mode] = counts
        del engine
    launches = ops.launch_counts()
    for name, n in launches.items():
        _check(n > 0, f"kernel {name} launched on the main path")
    return launches, cfg, params, prompts


# ---------------------------------------------------------------------------
# phase 6: where a decode step's device time goes
# ---------------------------------------------------------------------------

# kernel-name fragments -> the layer that launched the kernel
_KERNEL_GROUPS = (("posit_decode", "K1 posit_decode"),
                  ("posit_encode", "K2 posit_encode"),
                  ("paged_attention", "K3 paged_attention"),
                  ("ds_", "K4 decode_sample"),
                  ("gemm", "torch.matmul"), ("gemv", "torch.matmul"))


def _profile(cfg, params, prompts, steps: int = 4):
    """torch.profiler over `steps` greedy decode steps with 4 slots busy:
    device time per step by layer, and the device's busy share of the
    window (host clock, ending in a synchronize)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request, ServingEngine
    engine = ServingEngine(cfg, params, batch_slots=4, max_seq=256,
                           page_size=16, fused_prefill=False,
                           prefix_sharing=False, greedy=True)
    for rid, p in enumerate(prompts[:4]):
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=steps + 3))
    engine.step()   # prefill of all four, then their first decode step
    engine.step()
    _check(bool((engine.slot_phase == 2).all()), "profile: four slots decode")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or not evt.self_device_time_total:
            continue
        group = next((g for frag, g in _KERNEL_GROUPS if frag in evt.key),
                     "other torch ops")
        groups[group] = groups.get(group, 0.0) + evt.self_device_time_total
    busy = sum(groups.values())
    print(f"profile: {steps} decode steps, 4 slots, wall {wall_us / steps / 1e3:.3f}"
          f" ms/step, device busy {busy / steps / 1e3:.3f} ms/step "
          f"({100 * busy / wall_us:.1f}% of the window)"
          if busy else "profile: the profiler recorded no device time "
          "(not measured)")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile: {group}: {us / steps / 1e3:.3f} ms/step "
              f"({100 * us / busy:.1f}% of device time)")


def main() -> int:
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "csrc")):
        print("chip_smoke: src/repro_torch is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import set_float32_parity
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    _check(bool(smi), "nvidia-smi reports the card's name and power limit")
    print(f"device: {name}, count {count}")
    print(smi[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    set_float32_parity()
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {len(paths)} libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for src_name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"ptxas[{src_name}]: {line.strip()}")

    kernels = []
    for fn in (_k1_decode, _k2_encode, _k3_attention, _k4_decode_sample):
        rec = fn(dev)
        torch.cuda.empty_cache()
        print(f"kernel {rec['name']} ({rec['shape']}): ms {rec['ms']:.4f} "
              f"(device, graph replay), call_ms {rec['call_ms']:.4f} (per "
              f"call with host overhead), plain_ms {rec['plain_ms']:.3f}, bound_ms "
              f"{rec['bound_ms']:.4f} ({rec['bound_by']}), library_ms "
              f"{'none' if rec['library_ms'] is None else round(rec['library_ms'], 4)}"
              f", max_abs_err {rec['max_abs_err']:.3g}")
        kernels.append(rec)
    print(f"small input: max |logit diff| card vs plain CPU "
          f"{_small_reference(dev):.3g}")
    ops.reset_launches()
    launches, cfg, params, prompts = _serve(dev)
    _profile(cfg, params, prompts)
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
        rec["route"] = "cuda"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
