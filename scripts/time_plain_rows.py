"""Time each kernel's plain PyTorch version on the card at the shapes of
PERF.md section 6's rows that `chip_smoke.py` does not time it at: K1's
run-time decode (P(16,1)), the float GEMV and K6 per projection (M 4,
M 256, the training M 512), K2 into P(13,2), K3 at G 16, K4 over 16 rows
and over an untied [D, V] head, K5 in f32, K9 at a decode
step's routing, and K8's run-time variant; with `--k8` also K8's plain
PDPU at each bit_exact step shape and at a prefill M (10–30 s each).
Inputs are built as `chip_smoke.py` builds them, with `core.posit.pack`
(no kernel is built or launched).  Each plain version is timed once on
the host clock ending in a synchronize, after one untimed call, as
`chip_smoke.py` times its plain versions (`_time_once_ms`).  Prints the card's name and power limit first, then one
`plain <row>: <ms>` line a row.

    python scripts/time_plain_rows.py [--k8]
"""
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import set_float32_parity  # noqa: E402
from repro_torch.core import formats, posit  # noqa: E402
from repro_torch.core.quant import policy_by_name  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import pdpu_dot, posit_codec  # noqa: E402
from repro_torch.kernels import posit_matmul as pm  # noqa: E402
from repro_torch.kernels import prefill_attention as pf  # noqa: E402

DEV = torch.device("cuda")
G = torch.Generator(device=DEV).manual_seed(25)


def randn(*shape, scale=1.0):
    return torch.randn(*shape, generator=G, device=DEV) * scale


def report(row, fn):
    ms = cs._time_once_ms(fn)
    print(f"plain {row}: {ms:.3f} ms", flush=True)
    torch.cuda.empty_cache()


def codec_rows():
    codes = posit.pack(randn(8192, 22528, scale=1 / math.sqrt(8192)),
                       formats.P16_1)
    report("K1 posit P(16,1) [8192, 22528]",
           lambda: posit_codec.decode_plain(codes, formats.P16_1))
    del codes
    emb = randn(256000, 8192)
    report("K2 P(13,2) [256000, 8192]",
           lambda: posit_codec.encode_plain(emb, formats.P13_2))


def projection_rows():
    fmt = formats.P16_2
    for K, N in sorted(set(cs._LAYER_KN)):
        w = posit.pack(randn(K, N, scale=1 / math.sqrt(K)), fmt)
        x = randn(4, K).to(torch.bfloat16)
        report(f"float GEMV M 4 K {K} N {N}",
               lambda: pm.posit_gemv_f_plain(x, w, fmt))
        for M in (4, 256):
            a = posit.pack(randn(M, K), formats.P13_2)
            report(f"K6 M {M} K {K} N {N}", lambda: pm.posit_matmul_plain(
                a, w, formats.P13_2, fmt))
    for K, N in ((4096, 4096), (4096, 1024), (4096, 16384), (16384, 4096)):
        a = posit.pack(randn(512, K), formats.P13_2)
        b = posit.pack(randn(K, N, scale=1 / math.sqrt(K)), formats.P13_2)
        report(f"K6 training M 512 K {K} N {N}",
               lambda: pm.posit_matmul_plain(a, b, formats.P13_2,
                                             formats.P13_2))


def attention_rows():
    B, Hq, Hkv, Dh, ps, M = 4, 64, 4, 128, 16, 16
    P = B * M + 1
    full = torch.tensor([1 << 30], dtype=torch.int32, device=DEV)
    bt = torch.arange(1, P, device=DEV, dtype=torch.int32).reshape(B, M)
    lengths = torch.tensor([256, 137, 4, 64], dtype=torch.int32, device=DEV)
    q = randn(B, Hq, Dh)
    for fmt in (formats.P8_2, None):
        kv = randn(2, P, ps, Hkv * Dh)
        kv = posit.pack(kv, fmt) if fmt else kv.to(torch.bfloat16)
        report(f"K3 G 16 {'P(8,2)' if fmt else 'bf16'} pages",
               lambda: pa.paged_attention_plain(q, kv[0], kv[1], bt, lengths,
                                                full, fmt_kv=fmt))
    # K5's plain version: the serving geometry with f32 activations
    Hkv, C, starts = 8, 64, [64, 64, 130, 190]
    kp, vp = (posit.pack(randn(P, ps, Hkv * Dh), formats.P8_2)
              for _ in range(2))
    bt[1, :starts[0] // ps] = bt[0, :starts[0] // ps]
    q, k, v = (randn(B, C, h, Dh) for h in (Hq, Hkv, Hkv))
    st = torch.tensor(starts, dtype=torch.int32, device=DEV)
    ok = torch.ones(B, M, dtype=torch.int32, device=DEV)
    ok[3] = 0
    report("K5 f32, serving shape (B 4, C 64, 64 / 8 heads, M 16)",
           lambda: pf.prefill_attention_paged_plain(
               q, k, v, kp, vp, bt, st, full, fmt_kv=formats.P8_2,
               compute_dtype=torch.float32, flash_chunk=1024, page_ok=ok))


def head_rows():
    fmt = formats.P16_2
    for B, D, V, transpose in ((16, 8192, 256000, True),
                               (4, 4096, 151936, False),
                               (16, 4096, 151936, False)):
        shape = (V, D) if transpose else (D, V)
        w = posit.pack(randn(*shape, scale=1 / 64), fmt)
        x = randn(B, D).to(torch.bfloat16)
        noise = -torch.log(-torch.log(torch.rand(
            B, V, generator=G, device=DEV).clamp(1e-20, 1 - 1e-7)))
        report(f"K4 B {B} {'[V, D]' if transpose else '[D, V]'} D {D} V {V}",
               lambda: pa.decode_sample_plain(
                   x, w, noise, 0.8, greedy=False, top_k=40, plan="fused",
                   fmt_w=fmt, transpose=transpose))
        del w


def grouped_rows():
    """K9 at a decode step's routing (`chip_smoke._k9_routed`'s buffer):
    4 tokens top-8 of 128 experts, capacity 8."""
    fb, E, M, T, k = formats.P16_2, 128, 8, 4, 8
    choice = torch.stack([torch.randperm(E, generator=G, device=DEV)[:k]
                          for _ in range(T)])
    layer = []
    for K, N in cs._EXPERT_KN:
        x = randn(T, K)
        buf = torch.zeros(E, M, K, device=DEV)
        fill = [0] * E
        for t in range(T):
            for e in choice[t].tolist():
                buf[e, fill[e]] = x[t]
                fill[e] += 1
        layer.append((buf, posit.pack(randn(E, K, N, scale=1 / math.sqrt(K)),
                                      fb)))
    report("K9 a decode step's routing (3 expert GEMMs)",
           lambda: [pm.posit_matmul_grouped_plain(a, b, None, fb)
                    for a, b in layer])


def pdpu_rows(all_shapes: bool):
    c10 = formats.PDPU_P10_16_N8_W14
    a = posit.pack(randn(4, 8192), c10.fmt_in)
    b = posit.pack(randn(8192, 1024, scale=1 / math.sqrt(8192)), c10.fmt_in)
    report("K8 run-time variant P(10/16,2) N 8, M 4, K 8192, N 1024",
           lambda: pdpu_dot.pdpu_matmul_plain(a, b, c10))
    if not all_shapes:
        return
    cfg = policy_by_name("validate_bit_exact").pdpu_config()
    for name, K, N, _ in cs.K8_STEP_SHAPES:
        a = posit.pack(randn(4, K), cfg.fmt_in)
        b = posit.pack(randn(K, N, scale=1 / math.sqrt(K)), cfg.fmt_in)
        if name == "head":   # the tied head's layout: B given transposed
            b = b.T.contiguous().T
        report(f"K8 {name} M 4 K {K} N {N}",
               lambda: pdpu_dot.pdpu_matmul_plain(a, b, cfg))
    a = posit.pack(randn(64, 8192), cfg.fmt_in)
    b = posit.pack(randn(8192, 1024, scale=1 / math.sqrt(8192)), cfg.fmt_in)
    report("K8 prefill M 64 K 8192 N 1024",
           lambda: pdpu_dot.pdpu_matmul_plain(a, b, cfg))


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    set_float32_parity()
    t0 = time.perf_counter()
    for rows in (codec_rows, projection_rows, attention_rows, head_rows,
                 grouped_rows):
        rows()
    pdpu_rows("--k8" in sys.argv)
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
