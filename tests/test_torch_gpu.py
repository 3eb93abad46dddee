"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: every test takes the `cuda` fixture, which skips when no
CUDA device is present (decided inside the fixture, never at import).
Run on a machine with an H100 with `pytest -m gpu tests/test_torch_gpu.py`.

Tolerances: the codec kernels are bit-exact (compared as bit patterns);
attention sums in another order than the plain version (f32), held to
rtol = atol = 2e-5 (f32 outputs) or one bf16 ulp (bf16 outputs); the
fused prefill kernel's page writes are bitwise (page 0, the trash page,
excluded); the decode-sample kernel's tokens equal the plain tokens
except where the plain top-two sampling scores lie within 1e-4 of each
other, where the kernel's choice must score within 1e-4 of the best; the
coded GEMM is within 16 u sqrt(K) sqrt(sum_k (a_ik b_kj)^2) of its plain
version (exact products of random sign, another summation order;
`posit_matmul.sum_bound`), a limit that weights rounded to bf16 or one K
tile left out must fail, and so is the grouped posit GEMM (K9, also with
float activations, whose products round once in the FMA as in any f32
GEMM); the chunked-PDPU GEMM (K8, both variants) and the whole bit_exact
dispatch are integer datapaths, held bitwise; so are K2's compile-time
encode variants.
"""
import pytest
import torch

from repro_torch.core import formats
from repro_torch.core import posit
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import posit_codec
from repro_torch.kernels import posit_matmul as pm
from repro_torch.kernels import prefill_attention as pf

pytestmark = pytest.mark.gpu

SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits_equal(a, b):
    a = a.detach().cpu().contiguous()
    b = b.detach().cpu().contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("fmt", [formats.P16_2, formats.P16_1, formats.P8_2,
                                 formats.P8_0, formats.PositFormat(13, 2)])
def test_decode_all_codes_bitwise(cuda, fmt):
    codes = torch.arange(1 << fmt.n, dtype=torch.int64)
    codes = posit.to_container(codes, fmt).to(cuda)
    want = posit_codec.decode_plain(codes, fmt)
    assert _bits_equal(posit_codec.decode(codes, fmt), want)
    # an unaligned view takes the scalar path
    assert _bits_equal(posit_codec.decode(codes[1:], fmt), want[1:])


@pytest.mark.parametrize("fmt", [formats.P16_2, formats.P16_1, formats.P8_2])
def test_encode_sweep_bitwise(cuda, fmt):
    g = torch.Generator().manual_seed(fmt.n * 10 + fmt.es)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, ((1 << 20) + 13,),
                         generator=g, dtype=torch.int64).to(torch.int32)
    special = torch.tensor([0.0, -0.0, 1e-45, -1e-40, float("inf"),
                            float("-inf"), float("nan"), 1e20, -3e38,
                            2.0 ** -130, 1.0, -1.0], dtype=torch.float32)
    v = torch.cat([bits.view(torch.float32), special,
                   torch.randn(4096, generator=g).to(torch.bfloat16).float()])
    v = v.to(cuda)
    want = posit_codec.encode_plain(v, fmt)
    assert _bits_equal(posit_codec.encode(v, fmt), want)
    assert _bits_equal(posit_codec.encode(v[3:], fmt), want[3:])


@pytest.mark.parametrize("fmt", [formats.P16_2, formats.P13_2, formats.P8_2])
def test_encode_fast_variants_bitwise(cuda, fmt):
    """K2's compile-time variants: every rounding boundary between adjacent
    codes and its f32 neighbours (both signs), every bf16 pattern and a
    spread of f32 bit patterns, bitwise the plain codec; the launch counted
    on its variant; an unaligned view (the scalar path) the same bits."""
    g = torch.Generator().manual_seed(fmt.n)
    b = posit_codec.rounding_boundaries(fmt)
    edges = torch.cat([b, torch.nextafter(b, torch.zeros_like(b)),
                       torch.nextafter(b, torch.full_like(b, float("inf")))])
    bf16 = (torch.arange(1 << 16, dtype=torch.int64) << 16).to(torch.int32)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, ((1 << 20) + 7,),
                         generator=g, dtype=torch.int64).to(torch.int32)
    v = torch.cat([edges, -edges, bf16.view(torch.float32),
                   bits.view(torch.float32)]).to(cuda)
    want = posit_codec.encode_plain(v, fmt)
    variant = posit_codec.encode_variant(fmt, want.dtype)
    assert variant != "posit"
    ops.reset_launches()
    assert _bits_equal(posit_codec.encode(v, fmt), want)
    assert ops.launch_counts()[f"posit_encode:{variant}"] == 1
    assert _bits_equal(posit_codec.encode(v[5:], fmt), want[5:])
    assert ops.launch_counts()["posit_encode"] == 2


def test_launch_counters_count_launches(cuda):
    ops.reset_launches()
    x = torch.randn(64, 64, device=cuda)
    ops.decode(ops.encode(x, formats.P16_2), formats.P16_2)
    counts = ops.launch_counts()
    assert counts["posit_encode"] == 1 and counts["posit_decode"] == 1
    ops.reset_launches()
    assert not any(ops.launch_counts().values())


def _attn_inputs(cuda, kv_dtype, fmt, seed, B=4, Hq=16, Hkv=2, Dh=128, ps=16,
                 M=6, P=40):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, Dh, generator=g)
    kv = torch.randn(2, P, ps, Hkv * Dh, generator=g)
    if fmt is not None:
        kv = posit.pack(kv, fmt)
    else:
        kv = kv.to(kv_dtype)
    bt = (torch.randperm(P - 1, generator=g)[:B * M].reshape(B, M) + 1)
    return (q.to(cuda), kv[0].to(cuda), kv[1].to(cuda),
            bt.to(torch.int32).to(cuda))


ATTN = {
    "p8_2": (torch.int8, formats.P8_2, [96, 17, 1, 50], 1 << 30, 0.0, False),
    "p16_1": (torch.int16, formats.P16_1, [80, 96, 33, 16], 1 << 30, 0.0,
              False),
    "f32": (torch.float32, None, [40, 7, 96, 64], 1 << 30, 0.0, False),
    "bf16": (torch.bfloat16, None, [12, 96, 3, 45], 1 << 30, 0.0, False),
    "window_softcap": (torch.int8, formats.P8_2, [96, 70, 9, 33], 20, 30.0,
                       False),
    "page_ok_partials": (torch.int8, formats.P8_2, [96, 0, 50, 17], 1 << 30,
                         0.0, True),
    "zero_length": (torch.int16, formats.P16_1, [0, 5, 0, 96], 1 << 30, 0.0,
                    False),
}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_paged_attention_matches_plain(cuda, case):
    kv_dtype, fmt, lengths, window, cap, partials = ATTN[case]
    q, kp, vp, bt = _attn_inputs(cuda, kv_dtype, fmt, sorted(ATTN).index(case))
    B, M = bt.shape
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    win = torch.tensor([window], dtype=torch.int32, device=cuda)
    ok = None
    if partials:
        g = torch.Generator().manual_seed(1)
        ok = (torch.rand(B, M, generator=g) > 0.3).to(torch.int32).to(cuda)
    got = pa.paged_attention(q, kp, vp, bt, ln, win, fmt_kv=fmt,
                             softcap_val=cap, page_ok=ok, partials=partials)
    want = pa.paged_attention_plain(q, kp, vp, bt, ln, win, fmt_kv=fmt,
                                    softcap_val=cap, page_ok=ok,
                                    partials=partials)
    if not partials:
        got, want = (got,), (want,)
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        torch.testing.assert_close(g_, w_, rtol=2e-5, atol=2e-5)
    for b, n in enumerate(lengths):
        if n == 0:
            assert (got[0][b] == 0).all()


def _check_tokens(tok, plain_tok, scores):
    """Equal tokens, or (near a tie) a choice within SCORE_TOL of the best."""
    tok, plain_tok = tok.long(), plain_tok.long()
    rows = torch.arange(tok.shape[0], device=tok.device)
    chosen = scores[rows, tok]
    best = scores[rows, plain_tok]
    ok = (tok == plain_tok) | (chosen >= best - SCORE_TOL)
    assert bool(ok.all()), (tok, plain_tok, chosen, best)


def _scores(l, noise, temperature, greedy, top_k):
    if greedy:
        return l
    l = l / torch.tensor(max(temperature, 1e-6), dtype=torch.float32,
                         device=l.device)
    if 0 < top_k < l.shape[-1]:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l >= kth, l, torch.full_like(l, -1e30))
    return noise + l


@pytest.mark.parametrize("w_kind", ["int16", "int8", "f32", "bf16"])
@pytest.mark.parametrize("transpose", [True, False])
def test_decode_sample_matches_plain(cuda, w_kind, transpose):
    g = torch.Generator().manual_seed(3)
    B, D, V = 6, 520, 3001
    x = torch.randn(B, D, generator=g).to(cuda)
    w = torch.randn((V, D) if transpose else (D, V), generator=g) * 0.05
    fmt = {"int16": formats.P16_2, "int8": formats.P8_2}.get(w_kind)
    w = posit.pack(w, fmt) if fmt else w.to(
        torch.float32 if w_kind == "f32" else torch.bfloat16)
    w = w.to(cuda)
    noise = -torch.log(-torch.log(torch.rand(B, V, generator=g)
                                  .clamp(1e-9, 1 - 1e-7))).to(cuda)
    l = pa.head_logits_plain(x, w, plan="fused", fmt_w=fmt,
                             transpose=transpose, softcap_val=30.0)
    for greedy, top_k, temp in ((True, 0, 1.0), (False, 0, 0.8),
                                (False, 40, 0.8), (False, 1, 1.0)):
        kw = dict(plan="fused", fmt_w=fmt, transpose=transpose,
                  greedy=greedy, top_k=top_k, softcap_val=30.0)
        tok = pa.decode_sample(x, w, None if greedy else noise, temp, **kw)
        plain = pa.sample_logits(l, noise, temp, greedy=greedy, top_k=top_k)
        _check_tokens(tok, plain, _scores(l, noise, temp, greedy, top_k))


@pytest.mark.parametrize("temperature", [0.8, 0.7, 1e-7])
def test_scale_logits_bitwise_host_division(cuda, temperature):
    """The sampler's l / max(T, 1e-6) on the card is bitwise the f32
    division numpy does on the host (the reference's `logits /
    jnp.maximum(temperature, 1e-6)`), not a multiply by the reciprocal."""
    import numpy as np
    g = torch.Generator().manual_seed(11)
    l = torch.randn(4, 50000, generator=g) * 30
    want = l.numpy() / np.float32(max(temperature, 1e-6))
    got = pa.scale_logits(l.to(cuda), temperature).cpu().numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_decode_sample_fake_quant_bf16_rounding(cuda):
    g = torch.Generator().manual_seed(4)
    B, D, V = 4, 256, 1000
    x = torch.randn(B, D, generator=g).to(torch.bfloat16).to(cuda)
    w = posit.pack(torch.randn(V, D, generator=g) * 0.05, formats.P16_2).to(cuda)
    tok = pa.decode_sample(x, w, None, None, plan="fake_quant",
                           fmt_w=formats.P16_2, transpose=True, greedy=True)
    l = pa.head_logits_plain(x, w, plan="fake_quant", fmt_w=formats.P16_2,
                             transpose=True, softcap_val=0.0)
    _check_tokens(tok, torch.argmax(l, -1), l)


def test_wrappers_reject_bad_inputs(cuda):
    codes = torch.zeros(4, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        posit_codec.decode(codes, formats.P16_2)
    with pytest.raises(ValueError):
        posit_codec.decode(codes.to(torch.int8), formats.P16_2)
    with pytest.raises(ValueError):
        posit_codec.decode(torch.zeros(4, 4, dtype=torch.int16,
                                       device=cuda).T[:, :2], formats.P16_2)


# (kv fmt, act dtype, B, C, Hq, Hkv, Dh, ps, M, starts, window, softcap,
#  flash_chunk)
PREFILL = {
    "serving_p8_bf16": ("P8_2", torch.bfloat16, 4, 64, 16, 2, 128, 16, 16,
                        [0, 64, 130, 17], 1 << 30, 0.0, 1024),
    "streaming_p8_bf16": ("P8_2", torch.bfloat16, 3, 32, 8, 1, 128, 16, 12,
                          [70, 130, 5], 1 << 30, 0.0, 64),
    "p16_1_f32_window_softcap": ("P16_1", torch.float32, 2, 24, 8, 2, 64, 8,
                                 10, [9, 40], 20, 30.0, 1024),
    "f32_pool_streaming": (None, torch.float32, 2, 7, 4, 2, 32, 4, 20,
                           [33, 2], 1 << 30, 0.0, 16),
    "single_token": ("P16_1", torch.float32, 3, 1, 8, 2, 64, 16, 6,
                     [0, 31, 80], 1 << 30, 0.0, 1024),
    # the tensor-core variant's branches: rows that fill no whole 64-row
    # tile, window + softcap, int16 pools at G = 16, several flash chunks
    # streaming past a long history, head_dim 64, one-token chunks; and a
    # bf16 head_dim that is not a multiple of 16 (the SIMT variant)
    "tc_ragged_rows_window_softcap": ("P8_2", torch.bfloat16, 3, 7, 8, 2,
                                      64, 16, 8, [9, 40, 0], 20, 30.0, 1024),
    "tc_p16_1_g16": ("P16_1", torch.bfloat16, 2, 24, 32, 2, 128, 16, 12,
                     [33, 100], 1 << 30, 0.0, 1024),
    "tc_long_span_flash_chunks": ("P8_2", torch.bfloat16, 2, 64, 16, 2, 128,
                                  16, 80, [1030, 1200], 1 << 30, 0.0, 512),
    "tc_head_dim_64_streaming": ("P8_2", torch.bfloat16, 3, 16, 8, 1, 64, 8,
                                 12, [50, 0, 75], 1 << 30, 0.0, 32),
    "tc_single_token": ("P16_1", torch.bfloat16, 3, 1, 8, 2, 64, 16, 6,
                        [0, 31, 80], 1 << 30, 0.0, 1024),
    "simt_bf16_head_dim_40": ("P8_2", torch.bfloat16, 2, 8, 4, 2, 40, 16, 4,
                              [3, 20], 1 << 30, 0.0, 1024),
    # the tc256 variant at gemma3's heads (8 / 4 of 256): its chunk shape
    # with the local layers' window and the global layers' 2^30 (9 key
    # splits), softcap, ragged rows (C 7, G 2), a one-token chunk, start 0
    # (one split), a span past flash_chunk 512
    "tc256_gemma3_window": ("P8_2", torch.bfloat16, 4, 64, 8, 4, 256, 16,
                            128, [1024, 1100, 1500, 1960], 1024, 0.0, 1024),
    "tc256_gemma3_global": ("P8_2", torch.bfloat16, 4, 64, 8, 4, 256, 16,
                            128, [1024, 1100, 1500, 1960], 1 << 30, 0.0,
                            1024),
    "tc256_softcap": ("P8_2", torch.bfloat16, 2, 32, 8, 4, 256, 16, 24,
                      [100, 300], 1 << 30, 50.0, 1024),
    "tc256_ragged_rows": ("P8_2", torch.bfloat16, 3, 7, 4, 2, 256, 16, 40,
                          [9, 400, 0], 20, 0.0, 1024),
    "tc256_single_token": ("P16_1", torch.bfloat16, 3, 1, 8, 4, 256, 16, 6,
                           [0, 31, 80], 1 << 30, 0.0, 1024),
    "tc256_start_0": ("P8_2", torch.bfloat16, 2, 64, 8, 4, 256, 16, 4,
                      [0, 0], 1 << 30, 0.0, 1024),
    "tc256_past_flash_chunk": ("P8_2", torch.bfloat16, 2, 64, 8, 4, 256, 16,
                               80, [1030, 1200], 1 << 30, 0.0, 512),
}


@pytest.mark.parametrize("case", sorted(PREFILL))
def test_prefill_attention_matches_plain(cuda, case):
    fmt_name, act, B, C, Hq, Hkv, Dh, ps, M, starts, window, cap, chunk = \
        PREFILL[case]
    fmt = getattr(formats, fmt_name) if fmt_name else None
    g = torch.Generator().manual_seed(sorted(PREFILL).index(case))
    P = B * M + 1
    kv = torch.randn(2, P, ps, Hkv * Dh, generator=g)
    kv = posit.pack(kv, fmt) if fmt else kv
    bt = torch.zeros(B, M, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=g) + 1
    for b in range(B):
        n = -(-(starts[b] + C) // ps)
        bt[b, :n] = perm[b * M:b * M + n].to(torch.int32)
    # slots 0 and 1 share their first history page (forked before any
    # write in the engine; read-only here since both starts pass it)
    if B > 1 and starts[0] >= ps and starts[1] >= ps:
        bt[1, 0] = bt[0, 0]
    q = torch.randn(B, C, Hq, Dh, generator=g).to(act)
    k = torch.randn(B, C, Hkv, Dh, generator=g).to(act)
    v = torch.randn(B, C, Hkv, Dh, generator=g).to(act)
    ok = torch.ones(B, M, dtype=torch.int32)
    ok[-1] = 0  # the last slot's pages are not writable
    args = [t.to(cuda) for t in (q, k, v)]
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    win = torch.tensor([window], dtype=torch.int32, device=cuda)
    kw = dict(fmt_kv=fmt, compute_dtype=act, softcap_val=cap,
              flash_chunk=chunk, page_ok=ok.to(cuda))
    kp, vp = kv[0].to(cuda), kv[1].to(cuda)
    kp2, vp2 = kp.clone(), vp.clone()
    ops.reset_launches()
    got, _, _ = pf.prefill_attention_paged(*args, kp, vp, bt.to(cuda), st,
                                           win, **kw)
    variant = pf.prefill_variant(act, Dh)
    assert ops.launch_counts()[f"prefill_attention:{variant}"] == 1
    assert variant == ("tc256" if case.startswith("tc256_") else
                       "tc" if case.startswith(("serving", "streaming",
                                                "tc_")) else "simt")
    want, _, _ = pf.prefill_attention_paged_plain(*args, kp2, vp2,
                                                  bt.to(cuda), st, win, **kw)
    assert got.dtype == act and torch.isfinite(got.float()).all()
    if act == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-6)
    assert _bits_equal(kp[1:], kp2[1:]) and _bits_equal(vp[1:], vp2[1:])
    last = bt[-1][bt[-1] > 0].long().to(cuda)
    assert _bits_equal(kp[last], kv[0].to(cuda)[last])


@pytest.mark.parametrize("shape", [(4, 8192, 1024), (3, 517, 130),
                                   (256, 1024, 320), (70, 333, 65),
                                   (1, 8190, 1000), (4, 8190, 1000),
                                   (8, 8190, 1000), (9, 8190, 1000)])
@pytest.mark.parametrize("fmts", [("P13_2", "P16_2", None),
                                  ("P13_2", "P16_2", "P16_2"),
                                  ("P8_2", "P16_1", "P8_2")])
def test_posit_matmul_matches_plain(cuda, shape, fmts):
    M, K, N = shape
    fa, fb = getattr(formats, fmts[0]), getattr(formats, fmts[1])
    fo = getattr(formats, fmts[2]) if fmts[2] else None
    g = torch.Generator().manual_seed(M + K + N)
    a = posit.pack(torch.randn(M, K, generator=g), fa).to(cuda)
    b = posit.pack(torch.randn(K, N, generator=g) * 0.05, fb).to(cuda)
    bound = pm.sum_bound(a, b, fa, fb)
    plain = pm.posit_matmul_plain(a, b, fa, fb)
    got = pm.posit_matmul(a, b, fa, fb)
    assert got.dtype == torch.float32
    assert bool(((got - plain).abs() <= bound).all())
    if fo is not None:
        codes = pm.posit_matmul(a, b, fa, fb, fo)
        assert codes.dtype == posit.storage_dtype(fo)
        # the codes are the rounding of the kernel's own f32 sums
        assert _bits_equal(codes, posit_codec.encode_plain(got, fo))


@pytest.mark.parametrize("K,N,M", [(8192, 1024, 4), (22528, 512, 4),
                                   (8190, 1000, 1), (8190, 1000, 8)])
def test_posit_matmul_bound_rejects_planted_faults(cuda, K, N, M):
    """At the decode shapes the kernel (split-K over 32-row steps) passes
    `sum_bound` and two faults fail it: weights rounded to bf16, and one
    32-wide K tile (one row step of a split) left out."""
    fa, fb = formats.P13_2, formats.P16_2
    g = torch.Generator().manual_seed(K + N)
    a = posit.pack(torch.randn(M, K, generator=g), fa).to(cuda)
    b = posit.pack(torch.randn(K, N, generator=g) * K ** -0.5, fb).to(cuda)
    bound = pm.sum_bound(a, b, fa, fb)
    plain = pm.posit_matmul_plain(a, b, fa, fb)
    assert bool(((pm.posit_matmul(a, b, fa, fb) - plain).abs() <= bound).all())
    A, B = posit_codec.decode_plain(a, fa), posit_codec.decode_plain(b, fb)
    for bad in (torch.matmul(A, B.to(torch.bfloat16).float()),
                plain - torch.matmul(A[:, :32], B[:32])):
        assert bool(((bad - plain).abs() > bound).any())


@pytest.mark.parametrize("M,K,N,fmt_out", [(4, 8192, 1024, None),
                                           (8, 8190, 1000, "P16_2"),
                                           (256, 1024, 320, None)])
def test_posit_matmul_bitwise_deterministic(cuda, M, K, N, fmt_out):
    """Two calls on the same inputs are bitwise equal: the split-K
    partials are summed in split order, never by float atomics."""
    fa, fb = formats.P13_2, formats.P16_2
    fo = getattr(formats, fmt_out) if fmt_out else None
    g = torch.Generator().manual_seed(M * K)
    a = posit.pack(torch.randn(M, K, generator=g), fa).to(cuda)
    b = posit.pack(torch.randn(K, N, generator=g) * K ** -0.5, fb).to(cuda)
    first = pm.posit_matmul(a, b, fa, fb, fo)
    for _ in range(3):
        assert _bits_equal(pm.posit_matmul(a, b, fa, fb, fo), first)


@pytest.mark.parametrize("fmt_b,M", [("P16_2", 1), ("P16_2", 4),
                                     ("P16_1", 1), ("P16_2", 9)])
def test_posit_matmul_decodes_every_weight_code(cuda, fmt_b, M):
    """Every 16-bit weight code times 1.0 through each kernel variant (the
    GEMV's compile-time P(16,2) and run-time decodes, the tensor-core GEMM
    at M 9, whose hi + lo split must sum back to the code's value) gives
    the plain decode bitwise (NaR as nan)."""
    fa, fb = formats.P13_2, getattr(formats, fmt_b)
    a = posit.pack(torch.ones(M, 1), fa).to(cuda)
    codes = posit.to_container(torch.arange(1 << 16, dtype=torch.int64), fb)
    b = codes.reshape(1, -1).to(cuda)
    ops.reset_launches()
    got = pm.posit_matmul(a, b, fa, fb)
    variant = pm.matmul_variant(M, fa, fb, b.dtype)
    assert ops.launch_counts()[f"posit_matmul:{variant}"] == 1
    want = posit_codec.decode_plain(b, fb).expand(M, -1)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert _bits_equal(got[~nan], want[~nan])


# (activation format, weight format, output format): the four int8 / int16
# container pairs
TC_PAIRS = {
    "a16_w16": ("P13_2", "P16_2", "P16_2"),
    "a8_w16": ("P8_2", "P16_1", "P8_2"),
    "a16_w8": ("P13_2", "P8_2", "P13_2"),
    "a8_w8": ("P8_2", "P8_0", "P8_2"),
}


@pytest.mark.parametrize("pair", sorted(TC_PAIRS))
@pytest.mark.parametrize("M", [9, 33, 255, 257])
def test_posit_matmul_tc_ragged(cuda, M, pair):
    """K6's tensor-core variant at ragged M, N 1000 and K 2050 (no multiple
    of its 128 x 128 tiles or 32-row K steps): within `sum_bound`, fmt_out
    codes the rounding of its own f32 sums, bitwise equal on a second
    call."""
    fa, fb, fo = (getattr(formats, f) for f in TC_PAIRS[pair])
    K, N = 2050, 1000
    g = torch.Generator(device=cuda).manual_seed(M * 7 + len(pair))
    a = posit.pack(torch.randn(M, K, generator=g, device=cuda), fa)
    b = posit.pack(torch.randn(K, N, generator=g, device=cuda) * K ** -0.5,
                   fb)
    ops.reset_launches()
    got = pm.posit_matmul(a, b, fa, fb)
    variant = pm.matmul_variant(M, fa, fb, b.dtype)
    assert variant.startswith("tc")
    assert ops.launch_counts()[f"posit_matmul:{variant}"] == 1
    plain = pm.posit_matmul_plain(a, b, fa, fb)
    assert bool(((got - plain).abs() <= pm.sum_bound(a, b, fa, fb)).all())
    assert _bits_equal(pm.posit_matmul(a, b, fa, fb), got)
    codes = pm.posit_matmul(a, b, fa, fb, fo)
    assert codes.dtype == posit.storage_dtype(fo)
    assert _bits_equal(codes, posit_codec.encode_plain(got, fo))
    assert _bits_equal(pm.posit_matmul(a, b, fa, fb, fo), codes)


# command-r-35b's projections, (K, N)
LAYER_KN = {"wq": (8192, 8192), "wk": (8192, 1024), "wv": (8192, 1024),
            "wo": (8192, 8192), "gate": (8192, 22528), "up": (8192, 22528),
            "down": (22528, 8192)}


@pytest.mark.parametrize("proj", list(LAYER_KN))
def test_posit_matmul_tc_bound_rejects_planted_faults(cuda, proj):
    """At the a13 prefill shape (M 256) every command-r projection passes
    `sum_bound` on the tensor-core variant, and two faults fail it:
    weights rounded to bf16, one 32-wide K tile left out."""
    fa, fb = formats.P13_2, formats.P16_2
    K, N = LAYER_KN[proj]
    g = torch.Generator(device=cuda).manual_seed(K + N + len(proj))
    a = posit.pack(torch.randn(256, K, generator=g, device=cuda), fa)
    b = posit.pack(torch.randn(K, N, generator=g, device=cuda) * K ** -0.5,
                   fb)
    ops.reset_launches()
    got = pm.posit_matmul(a, b, fa, fb)
    assert ops.launch_counts()["posit_matmul:tc_p16_2"] == 1
    bound = pm.sum_bound(a, b, fa, fb)
    plain = pm.posit_matmul_plain(a, b, fa, fb)
    assert bool(((got - plain).abs() <= bound).all())
    A, B = posit_codec.decode_plain(a, fa), posit_codec.decode_plain(b, fb)
    for bad in (torch.matmul(A, B.to(torch.bfloat16).float()),
                plain - torch.matmul(A[:, :32], B[:32])):
        assert bool(((bad - plain).abs() > bound).any())


def test_posit_matmul_tiled_for_unsplittable_formats(cuda):
    """A format pair whose bf16 split products could leave f32's normal
    range (P(16,3) reaches 2^112) keeps the f32 SIMT tiles at M > 8."""
    fa, fb = formats.PositFormat(16, 3), formats.P16_2
    g = torch.Generator(device=cuda).manual_seed(12)
    a = posit.pack(torch.randn(40, 300, generator=g, device=cuda), fa)
    b = posit.pack(torch.randn(300, 96, generator=g, device=cuda) * 0.05, fb)
    ops.reset_launches()
    got = pm.posit_matmul(a, b, fa, fb)
    assert ops.launch_counts()["posit_matmul:tiled"] == 1
    plain = pm.posit_matmul_plain(a, b, fa, fb)
    assert bool(((got - plain).abs() <= pm.sum_bound(a, b, fa, fb)).all())


# ---------------------------------------------------------------------------
# K7: multi-query paged attention (the speculative verify)
# ---------------------------------------------------------------------------

# (kv dtype, fmt, lengths counting the T new tokens, T, window, softcap,
#  partials with page_ok)
MQ = {
    "p8_2": (torch.int8, formats.P8_2, [96, 17, 4, 50], 4, 1 << 30, 0.0,
             False),
    "p16_1_t3": (torch.int16, formats.P16_1, [80, 96, 33, 16], 3, 1 << 30,
                 0.0, False),
    "f32": (torch.float32, None, [40, 7, 96, 64], 4, 1 << 30, 0.0, False),
    "bf16": (torch.bfloat16, None, [12, 96, 3, 45], 2, 1 << 30, 0.0, False),
    "window_softcap": (torch.int8, formats.P8_2, [96, 70, 9, 33], 4, 20,
                       30.0, False),
    "page_ok_partials": (torch.int8, formats.P8_2, [96, 2, 50, 17], 4,
                         1 << 30, 0.0, True),
    "zero_length": (torch.int16, formats.P16_1, [0, 5, 0, 96], 4, 1 << 30,
                    0.0, False),
}


def _mq_case(cuda, case):
    kv_dtype, fmt, lengths, T, window, cap, partials = MQ[case]
    seed = sorted(MQ).index(case)
    q3, kp, vp, bt = _attn_inputs(cuda, kv_dtype, fmt, seed)
    B, M = bt.shape
    g = torch.Generator().manual_seed(100 + seed)
    q = torch.randn(B, T, q3.shape[1], q3.shape[2], generator=g).to(cuda)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    win = torch.tensor([window], dtype=torch.int32, device=cuda)
    ok = None
    if partials:
        ok = (torch.rand(B, M, generator=g) > 0.3).to(torch.int32).to(cuda)
    kw = dict(fmt_kv=fmt, softcap_val=cap, page_ok=ok, partials=partials)
    return q, kp, vp, bt, ln, win, kw


@pytest.mark.parametrize("case", sorted(MQ))
def test_paged_attention_mq_matches_plain(cuda, case):
    q, kp, vp, bt, ln, win, kw = _mq_case(cuda, case)
    ops.reset_launches()
    got = pa.paged_attention(q, kp, vp, bt, ln, win, **kw)
    assert ops.launch_counts()["paged_attention_mq"] == 1
    assert ops.launch_counts()["paged_attention"] == 0
    want = pa.paged_attention_plain(q, kp, vp, bt, ln, win, **kw)
    if not kw["partials"]:
        got, want = (got,), (want,)
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        torch.testing.assert_close(g_, w_, rtol=2e-5, atol=2e-5)
    for b, n in enumerate(ln.tolist()):
        if n == 0:
            assert (got[0][b] == 0).all()


@pytest.mark.parametrize("case", sorted(MQ))
def test_paged_attention_mq_rows_bitwise_k3(cuda, case):
    """Row i of K7 is bitwise K3 for one query at length L - T + i + 1 over
    the same pages; T = 1 is K3 itself."""
    q, kp, vp, bt, ln, win, kw = _mq_case(cuda, case)
    T = q.shape[1]
    got = pa.paged_attention(q, kp, vp, bt, ln, win, **kw)
    one = pa.paged_attention(q[:, :1], kp, vp, bt, ln - T + 1, win, **kw)
    if not kw["partials"]:
        got, one = (got,), (one,)
    for i in range(T):
        k3 = pa.paged_attention(q[:, i].contiguous(), kp, vp, bt,
                                ln - T + i + 1, win, **kw)
        if not kw["partials"]:
            k3 = (k3,)
        for a, b in zip(got, k3):
            assert _bits_equal(a[:, i], b), (case, i)
        if i == 0:
            for a, b in zip(one, k3):
                assert _bits_equal(a[:, 0], b)


@pytest.mark.parametrize("case", ["p8_2", "window_softcap",
                                  "page_ok_partials"])
def test_paged_attention_mq_t_block_neutral(cuda, case):
    q, kp, vp, bt, ln, win, kw = _mq_case(cuda, case)
    outs = [pa.paged_attention(q, kp, vp, bt, ln, win, t_block=tb, **kw)
            for tb in (1, 2, 4)]
    for o in outs[1:]:
        if kw["partials"]:
            assert all(_bits_equal(a, b) for a, b in zip(outs[0], o))
        else:
            assert _bits_equal(outs[0], o)


def test_paged_attention_rows_past_block_threads(cuda):
    """A block serves more query rows than it has threads (K3: 160 rows
    on 128 threads; K7 at t_block 2: 320 on 256): its warps take the rows
    in turn, so both match the plain version and each K7 row is bitwise
    K3 at its length."""
    q, kp, vp, bt = _attn_inputs(cuda, torch.int8, formats.P8_2, 7, Hq=160,
                                 Hkv=1, Dh=16)
    ln = torch.tensor([40, 17, 96, 1], dtype=torch.int32, device=cuda)
    win = torch.tensor([1 << 30], dtype=torch.int32, device=cuda)
    kw = dict(fmt_kv=formats.P8_2)
    got3 = pa.paged_attention(q, kp, vp, bt, ln, win, **kw)
    torch.testing.assert_close(
        got3, pa.paged_attention_plain(q, kp, vp, bt, ln, win, **kw),
        rtol=2e-5, atol=2e-5)
    q4 = torch.stack([q, q.flip(1)], 1)
    want = pa.paged_attention_plain(q4, kp, vp, bt, ln, win, **kw)
    for tb in (2, None):
        got = pa.paged_attention(q4, kp, vp, bt, ln, win, t_block=tb, **kw)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for i in range(2):
        assert _bits_equal(
            got[:, i], pa.paged_attention(q4[:, i].contiguous(), kp, vp, bt,
                                          ln - 1 + i, win, **kw))


@pytest.mark.parametrize("greedy", [True, False])
def test_decode_sample_rows_invariant_in_batch(cuda, greedy):
    """The verify runs K4 over B*T rows where plain decode runs B: each
    row's token must not depend on the other rows."""
    g = torch.Generator().manual_seed(9)
    D, V = 1024, 20001
    x = torch.randn(16, D, generator=g).to(cuda)
    w = posit.pack(torch.randn(V, D, generator=g) * 0.05,
                   formats.P16_2).to(cuda)
    noise = -torch.log(-torch.log(torch.rand(16, V, generator=g)
                                  .clamp(1e-9, 1 - 1e-7))).to(cuda)
    kw = dict(plan="fused", fmt_w=formats.P16_2, transpose=True,
              greedy=greedy, top_k=0 if greedy else 40)
    all16 = pa.decode_sample(x, w, noise, 0.8, **kw)
    first4 = pa.decode_sample(x[:4].contiguous(), w, noise[:4].contiguous(),
                              0.8, **kw)
    assert torch.equal(all16[:4], first4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_quantize_kernels_equal_plain_codec(cuda, dtype):
    """The draft's fake-quant on the card: K2 encode then K1 decode, the
    same values as the plain codec, bitwise."""
    from repro_torch.kernels import dispatch
    g = torch.Generator().manual_seed(10)
    x = (torch.randn(300, 257, generator=g) * 3).to(dtype).to(cuda)
    for fmt in (formats.P16_2, formats.P8_2):
        ops.reset_launches()
        got = dispatch.fake_quantize(x, fmt)
        counts = ops.launch_counts()
        assert counts["posit_encode"] == 1 and counts["posit_decode"] == 1
        assert got.dtype == dtype
        assert _bits_equal(got.float(), posit.quantize(x, fmt).float())
        # a transposed view (the tied head's layout) too
        assert _bits_equal(dispatch.fake_quantize(x.T, fmt).float(),
                           posit.quantize(x.T.contiguous(), fmt).float())


def test_speculative_engine_greedy_streams_equal_plain(cuda):
    """A tiny speculative engine on the card (K3 in the draft, K7 and K4
    in the verify) gives the plain engine's greedy streams."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing
    from repro_torch.serve import Request, ServingEngine
    cfg = configs.get_smoke("command_r_35b").replace(
        quant=policy_by_name("serve_fused_p16"))
    params = packing.pack_params(
        api.init(torch.Generator(device=cuda).manual_seed(0), cfg), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 33, 12, 8)]

    def serve(**kw):
        eng = ServingEngine(cfg, params, batch_slots=3, max_seq=64,
                            page_size=16, **kw)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=9))
        return {r.rid: r.out_tokens for r in eng.run()}, eng

    want, _ = serve()
    ops.reset_launches()
    got, eng = serve(speculate_k=4)
    counts = ops.launch_counts()
    assert got == want
    assert eng.execution_summary()["speculation_rounds"] > 0
    for name in ("paged_attention", "paged_attention_mq", "decode_sample"):
        assert counts[name] > 0, name
    assert eng.pages_in_use == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_verify_bitwise_sequential_decode_steps(cuda, dtype):
    """On the card the verify's logits are bitwise T sequential decode
    steps' over the same tokens and pages (bf16 activations too, where a
    GEMM or row reduction over another number of rows would move them)."""
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing, transformer
    from repro_torch.models.paged import PagedLayout
    cfg = configs.get_smoke("command_r_35b").replace(
        quant=policy_by_name("serve_fused_p16"), dtype=dtype)
    params = packing.pack_params(
        api.init(torch.Generator(device=cuda).manual_seed(1), cfg), cfg)
    B, T, S = 4, 4, 64
    g = torch.Generator().manual_seed(2)
    cache = api.init_cache(cfg, B, S, PagedLayout.for_slots(B, S, 16))
    cache["block_table"] = torch.arange(1, 1 + B * 4, dtype=torch.int32,
                                        device=cuda).reshape(B, 4)
    prompt = torch.randint(0, cfg.vocab_size, (B, 21), generator=g,
                           dtype=torch.int32).to(cuda)
    _, cache = api.prefill_chunk_batched(
        params, prompt, cache, torch.ones(B, dtype=torch.bool, device=cuda),
        cfg)
    window = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                           dtype=torch.int32).to(cuda)
    seq = dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
    ops.reset_launches()
    verify, _ = transformer.decode_verify(params, window, cache, cfg)
    counts = ops.launch_counts()
    assert counts["paged_attention_mq"] == cfg.n_layers
    for t in range(T):
        ops.reset_launches()
        logits, seq = api.decode_step(params, window[:, t].contiguous(), seq,
                                      cfg)
        # the verify decodes each weight once, as one decode step does
        if t == 0:
            assert counts["posit_decode"] == \
                ops.launch_counts()["posit_decode"]
        assert _bits_equal(verify[:, t], logits), t
    assert _bits_equal(cache["k"], seq["k"])


# ---------------------------------------------------------------------------
# G = 16 query heads per KV head (qwen3-moe-235b's 64 / 4) and float pages
# ---------------------------------------------------------------------------

G16 = {
    "p8_2": (torch.int8, formats.P8_2),
    "bf16": (torch.bfloat16, None),
    "f32": (torch.float32, None),
}


@pytest.mark.parametrize("case", sorted(G16))
def test_paged_attention_group_of_16(cuda, case):
    """K3 (one query per slot) and K7 (T = 4 queries per slot) at 64 query
    heads over 4 KV heads, coded and float pages, against the plain
    version; each K7 row bitwise K3 at the row's length."""
    kv_dtype, fmt = G16[case]
    q3, kp, vp, bt = _attn_inputs(cuda, kv_dtype, fmt, 50 + len(case),
                                  Hq=64, Hkv=4)
    B = bt.shape[0]
    lengths = [96, 17, 4, 50]
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    win = torch.tensor([1 << 30], dtype=torch.int32, device=cuda)
    got = pa.paged_attention(q3, kp, vp, bt, ln, win, fmt_kv=fmt)
    want = pa.paged_attention_plain(q3, kp, vp, bt, ln, win, fmt_kv=fmt)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    T = 4
    g = torch.Generator().manual_seed(7)
    q = torch.randn(B, T, 64, 128, generator=g).to(cuda)
    got = pa.paged_attention(q, kp, vp, bt, ln, win, fmt_kv=fmt)
    want = pa.paged_attention_plain(q, kp, vp, bt, ln, win, fmt_kv=fmt)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for t in range(T):
        row = pa.paged_attention(q[:, t].contiguous(), kp, vp, bt,
                                 ln - (T - 1 - t), win, fmt_kv=fmt)
        assert _bits_equal(got[:, t], row)


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("G", [8, 16])
def test_paged_attention_split_boundaries(cuda, G, kind):
    """K3 at lengths that end on a split boundary and span several splits
    (1, one split's 32 tokens, 33, 256, 1100), with window + softcap and
    page_ok + partials, within 2e-5 of the plain version; K7 (T = 4) on
    the same pages within 2e-5 and each row bitwise K3 at its length."""
    fmt = formats.P8_2 if kind == "int8" else None
    dt = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
    lengths = [1, pa.SPLIT_KEYS, pa.SPLIT_KEYS + 1, 256, 1100]
    B, M = len(lengths), 70
    q3, kp, vp, bt = _attn_inputs(cuda, dt[kind], fmt, 80 + G, B=B,
                                  Hq=2 * G, Hkv=2, M=M, P=B * M + 1)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    g = torch.Generator().manual_seed(G)
    ok = (torch.rand(B, M, generator=g) > 0.2).to(torch.int32).to(cuda)
    q4 = torch.randn(B, 4, 2 * G, 128, generator=g).to(cuda)
    cases = [dict(window=1 << 30), dict(window=100, softcap_val=30.0),
             dict(window=1 << 30, page_ok=ok, partials=True)]
    for case in cases:
        kw = dict(case, fmt_kv=fmt)
        win = torch.tensor([kw.pop("window")], dtype=torch.int32,
                           device=cuda)
        tup = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
        for q in (q3, q4):
            ops.reset_launches()
            got = tup(pa.paged_attention(q, kp, vp, bt, ln, win, **kw))
            key = "paged_attention_mq" if q.ndim == 4 else "paged_attention"
            assert ops.launch_counts()[f"{key}:merge"] == 1
            want = tup(pa.paged_attention_plain(q, kp, vp, bt, ln, win, **kw))
            for a, b in zip(got, want):
                assert torch.isfinite(a).all()
                torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        for i in range(4):
            k3 = tup(pa.paged_attention(q4[:, i].contiguous(), kp, vp, bt,
                                        ln - 3 + i, win, **kw))
            for a, b in zip(got, k3):
                assert _bits_equal(a[:, i], b), (case, i)


@pytest.mark.parametrize("fmt_name", ["P8_2", None])
def test_prefill_attention_group_of_16(cuda, fmt_name):
    """K5 at qwen3's geometry (64 / 4 heads of 128, a 64-token chunk, bf16
    activations), int8 P(8,2) pages and bf16 float pages: output within
    one bf16 ulp, page writes bitwise."""
    fmt = getattr(formats, fmt_name) if fmt_name else None
    act = torch.bfloat16
    B, C, Hq, Hkv, Dh, ps, M = 4, 64, 64, 4, 128, 16, 16
    starts = [0, 64, 130, 17]
    g = torch.Generator().manual_seed(61)
    P = B * M + 1
    kv = torch.randn(2, P, ps, Hkv * Dh, generator=g)
    kv = posit.pack(kv, fmt) if fmt else kv.to(act)
    bt = torch.zeros(B, M, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=g) + 1
    for b in range(B):
        n = -(-(starts[b] + C) // ps)
        bt[b, :n] = perm[b * M:b * M + n].to(torch.int32)
    q, k, v = (torch.randn(B, C, h, Dh, generator=g).to(act).to(cuda)
               for h in (Hq, Hkv, Hkv))
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    win = torch.tensor([1 << 30], dtype=torch.int32, device=cuda)
    kp, vp = kv[0].to(cuda), kv[1].to(cuda)
    kp2, vp2 = kp.clone(), vp.clone()
    kw = dict(fmt_kv=fmt, compute_dtype=act, flash_chunk=1024)
    got, _, _ = pf.prefill_attention_paged(q, k, v, kp, vp, bt.to(cuda), st,
                                           win, **kw)
    want, _, _ = pf.prefill_attention_paged_plain(q, k, v, kp2, vp2,
                                                  bt.to(cuda), st, win, **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-6)
    assert _bits_equal(kp[1:], kp2[1:]) and _bits_equal(vp[1:], vp2[1:])


@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_prefill_attention_tc_over_float_pools(cuda, pool):
    """The tensor-core K5 variant over float pools (no KV format; the
    compute dtype is the pool's): bf16 activations, the history rounded
    to bf16 by the kv_decode dtype chain; output within one bf16 ulp,
    page writes bitwise, page_ok == 0 pages untouched."""
    act, dt = torch.bfloat16, getattr(torch, pool)
    B, C, Hq, Hkv, Dh, ps, M = 3, 40, 16, 2, 128, 16, 10
    starts = [16, 100, 0]
    g = torch.Generator().manual_seed(71)
    P = B * M + 1
    kv = torch.randn(2, P, ps, Hkv * Dh, generator=g).to(dt)
    bt = torch.arange(1, P, dtype=torch.int32).reshape(B, M)
    bt[1, 0] = bt[0, 0]   # a shared history page, read by both slots
    ok = torch.ones(B, M, dtype=torch.int32)
    ok[2] = 0
    q, k, v = (torch.randn(B, C, h, Dh, generator=g).to(act).to(cuda)
               for h in (Hq, Hkv, Hkv))
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    win = torch.tensor([1 << 30], dtype=torch.int32, device=cuda)
    kp, vp = kv[0].to(cuda), kv[1].to(cuda)
    kp2, vp2 = kp.clone(), vp.clone()
    kw = dict(fmt_kv=None, compute_dtype=dt, flash_chunk=1024,
              page_ok=ok.to(cuda))
    ops.reset_launches()
    got, _, _ = pf.prefill_attention_paged(q, k, v, kp, vp, bt.to(cuda), st,
                                           win, **kw)
    assert ops.launch_counts()["prefill_attention:tc"] == 1
    want, _, _ = pf.prefill_attention_paged_plain(q, k, v, kp2, vp2,
                                                  bt.to(cuda), st, win, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-6)
    assert _bits_equal(kp[1:], kp2[1:]) and _bits_equal(vp[1:], vp2[1:])
    last = bt[2].long().to(cuda)
    assert _bits_equal(kp[last], kv[0].to(cuda)[last])


# ---------------------------------------------------------------------------
# K8: the chunked-PDPU GEMM, bitwise its plain version
# ---------------------------------------------------------------------------

def _codes(g, fmt, shape):
    """Random codes over the whole range with zero, NaR, +-maxpos and
    +-minpos planted, in the int16 container (sign-extending)."""
    c = torch.randint(0, 1 << fmt.n, shape, generator=g, dtype=torch.int64)
    flat = c.view(-1)
    special = torch.tensor([0, fmt.nar_code, fmt.maxpos_code,
                            (-fmt.maxpos_code) & fmt.mask, fmt.minpos_code,
                            (-fmt.minpos_code) & fmt.mask])
    idx = torch.randperm(flat.numel(), generator=g)[:3 * special.numel()]
    flat[idx] = special.repeat(3)[:idx.numel()]
    return posit.to_container(c, fmt)


PDPU_CASES = {
    # name: (config, guard_bits, sticky, M, K, N_out)
    "p13_n4_decode": (formats.PDPU_P13_16_N4_W14, 2, True, 4, 512, 96),
    "p13_n4_ragged": (formats.PDPU_P13_16_N4_W14, 2, True, 5, 68, 33),
    "p16_n4_truncate": (formats.PDPU_P16_16_N4_W14, 0, False, 9, 64, 40),
    "p10_n8": (formats.PDPU_P10_16_N8_W14, 3, True, 3, 128, 70),
    "p13_n8_w10": (formats.PDPU_P13_16_N8_W10, 1, False, 4, 96, 64),
}


@pytest.mark.parametrize("case", sorted(PDPU_CASES))
def test_pdpu_matmul_bitwise_plain(cuda, case):
    import dataclasses
    from repro_torch.kernels import pdpu_dot
    cfg, gb, st, M, K, N = PDPU_CASES[case]
    cfg = dataclasses.replace(cfg, guard_bits=gb, sticky=st)
    g = torch.Generator().manual_seed(sorted(PDPU_CASES).index(case))
    a = _codes(g, cfg.fmt_in, (M, K)).to(cuda)
    b = _codes(g, cfg.fmt_in, (K, N)).to(cuda)
    ops.reset_launches()
    got = pdpu_dot.pdpu_matmul(a, b, cfg)
    assert ops.launch_counts()["pdpu_matmul"] == 1
    assert ops.launch_counts()[
        f"pdpu_matmul:{pdpu_dot.pdpu_variant(cfg)}"] == 1
    want = pdpu_dot.pdpu_matmul_plain(a, b, cfg)
    assert got.dtype == torch.int32 and _bits_equal(got, want)
    # B given transposed (the tied head's layout): the same bits
    bt = b.T.contiguous().T
    assert _bits_equal(pdpu_dot.pdpu_matmul(a, bt, cfg), want)
    # the CPU's plain version agrees with the card's
    assert _bits_equal(pdpu_dot.pdpu_matmul(a.cpu(), b.cpu(), cfg), want)


FIXED_CASES = {
    # name: (M, K, N_out, values (True) or random codes)
    "decode_k8192": (4, 8192, 40, True),
    "ragged_random_codes": (5, 68, 33, False),
    "prefill_m40": (40, 256, 70, True),
    "one_row_m1": (1, 1028, 75, False),
}


@pytest.mark.parametrize("case", sorted(FIXED_CASES))
def test_pdpu_matmul_fixed_variant_bitwise(cuda, case):
    """K8's compile-time variant (the bit_exact policy's PDPU): bitwise its
    plain version at K 8192 and a narrow N, at ragged M, K and N, at a
    prefill M, with B given transposed, and with NaR in one A row and one B
    column only (NaR reaches exactly their outputs)."""
    from repro_torch.kernels import pdpu_dot
    cfg = pdpu_dot.FIXED
    M, K, N, values = FIXED_CASES[case]
    g = torch.Generator().manual_seed(sorted(FIXED_CASES).index(case))
    if values:
        a = posit.pack(torch.randn(M, K, generator=g), cfg.fmt_in)
        b = posit.pack(torch.randn(K, N, generator=g) / K ** 0.5, cfg.fmt_in)
    else:
        a = _codes(g, cfg.fmt_in, (M, K))
        b = _codes(g, cfg.fmt_in, (K, N))
        a[a == cfg.fmt_in.nar_code] = 0
        b[b == cfg.fmt_in.nar_code] = 0
        a[M // 2, K // 3] = cfg.fmt_in.nar_code
        b[K // 2, N - 1] = cfg.fmt_in.nar_code
    a, b = a.to(cuda), b.to(cuda)
    want = pdpu_dot.pdpu_matmul_plain(a, b, cfg)
    ops.reset_launches()
    got = pdpu_dot.pdpu_matmul(a, b, cfg)
    assert ops.launch_counts()["pdpu_matmul:p13_16_n4"] == 1
    assert got.dtype == torch.int32 and _bits_equal(got, want)
    assert _bits_equal(pdpu_dot.pdpu_matmul(a, b.T.contiguous().T, cfg), want)
    if not values:
        nar = cfg.fmt_out.nar_code
        assert bool((want[M // 2] == nar).all()) and \
            bool((want[:, N - 1] == nar).all())
        assert int((want == nar).sum()) == M + N - 1


def test_qdot_bit_exact_on_card_equals_cpu(cuda):
    """The whole bit_exact dispatch (K2 encode, K8, K1 decode of the
    fmt_out codes) on the card, bitwise the CPU's plain path, for float
    masters, packed weights and a ragged K; grouped per expert too."""
    from repro_torch.core.quant import policy_by_name
    from repro_torch.kernels import dispatch
    tp = policy_by_name("validate_bit_exact")
    g = torch.Generator().manual_seed(5)
    for K in (256, 258):
        x = torch.randn(4, K, generator=g)
        w = torch.randn(K, 72, generator=g) / K ** 0.5
        for wt in (w, posit.pack(w, formats.P13_2)):
            want = dispatch.qdot(x, wt, tp)
            got = dispatch.qdot(x.to(cuda), wt.to(cuda), tp)
            assert _bits_equal(got, want)
    xg = torch.randn(3, 8, 64, generator=g)
    wg = posit.pack(torch.randn(3, 64, 48, generator=g) / 8, formats.P13_2)
    assert _bits_equal(dispatch.qdot_grouped(xg.to(cuda), wg.to(cuda), tp),
                       dispatch.qdot_grouped(xg, wg, tp))


# ---------------------------------------------------------------------------
# K9: the grouped posit GEMM within sum_bound
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8, 4096, 1536), (4, 8, 1536, 4096),
                                   (3, 5, 517, 130), (2, 20, 333, 66)])
@pytest.mark.parametrize("fmts", [(None, "P16_2", None),
                                  ("P13_2", "P16_2", None),
                                  ("P13_2", "P16_2", "P16_2"),
                                  ("P8_2", "P16_1", "P8_2")])
def test_posit_matmul_grouped_matches_plain(cuda, shape, fmts):
    E, M, K, N = shape
    fa = getattr(formats, fmts[0]) if fmts[0] else None
    fb = getattr(formats, fmts[1])
    fo = getattr(formats, fmts[2]) if fmts[2] else None
    g = torch.Generator().manual_seed(E + M + K + N)
    x = torch.randn(E, M, K, generator=g)
    a = (x if fa is None else posit.pack(x, fa)).to(cuda)
    b = posit.pack(torch.randn(E, K, N, generator=g) * K ** -0.5, fb).to(cuda)
    bound = pm.sum_bound(a, b, fa, fb)
    plain = pm.posit_matmul_grouped_plain(a, b, fa, fb)
    ops.reset_launches()
    got = pm.posit_matmul_grouped(a, b, fa, fb)
    assert ops.launch_counts()["posit_matmul_grouped"] == 1
    assert got.dtype == torch.float32
    assert bool(((got - plain).abs() <= bound).all())
    if fo is not None:
        codes = pm.posit_matmul_grouped(a, b, fa, fb, fo)
        assert codes.dtype == posit.storage_dtype(fo)
        assert _bits_equal(codes, posit_codec.encode_plain(got, fo))


@pytest.mark.parametrize("fmt_a", [None, "P13_2"])
def test_posit_matmul_grouped_bound_rejects_planted_faults(cuda, fmt_a):
    """At qwen3's expert shape (K 4096, N 1536, 8 rows) the kernel passes
    `sum_bound` and two faults fail it: weights rounded to bf16, and one
    64-wide K tile left out."""
    fa = getattr(formats, fmt_a) if fmt_a else None
    fb = formats.P16_2
    E, M, K, N = 4, 8, 4096, 1536
    g = torch.Generator().manual_seed(9)
    x = torch.randn(E, M, K, generator=g)
    a = (x if fa is None else posit.pack(x, fa)).to(cuda)
    b = posit.pack(torch.randn(E, K, N, generator=g) * K ** -0.5, fb).to(cuda)
    bound = pm.sum_bound(a, b, fa, fb)
    plain = pm.posit_matmul_grouped_plain(a, b, fa, fb)
    assert bool(((pm.posit_matmul_grouped(a, b, fa, fb) - plain).abs()
                 <= bound).all())
    A = a.float() if fa is None else posit_codec.decode_plain(a, fa)
    B = posit_codec.decode_plain(b, fb)
    for bad in (torch.matmul(A, B.to(torch.bfloat16).float()),
                plain - torch.matmul(A[..., :64], B[:, :64])):
        assert bool(((bad - plain).abs() > bound).any())


def _routed(g, E, M, K, occupancy, fa):
    """An [E, M, K] dispatch buffer on g's device: expert e holds
    occupancy[e] leading rows of activations, zeros after (f32, or fa
    codes)."""
    x = torch.randn(E, M, K, generator=g, device=g.device)
    for e, n in enumerate(occupancy):
        x[e, int(n):] = 0.0
    return x if fa is None else posit.pack(x, fa)


@pytest.mark.parametrize("shape", [(128, 8, 4096, 1536), (16, 8, 1536, 4096),
                                   (5, 20, 333, 66)])
@pytest.mark.parametrize("fmts", [(None, "P16_2", None),
                                  ("P13_2", "P16_2", None),
                                  ("P13_2", "P16_2", "P16_2"),
                                  ("P8_2", "P16_1", "P8_2")])
def test_posit_matmul_grouped_routed_occupancy(cuda, shape, fmts):
    """K9 over a routed buffer (0-3 occupied rows an expert, the rest
    zeros; at E 128 about 32 experts routed, as in a decode step): within
    `sum_bound` of its plain version, every empty row (and so every empty
    expert) exactly zero, on the variant `grouped_variant` picks."""
    E, M, K, N = shape
    fa = getattr(formats, fmts[0]) if fmts[0] else None
    fb = getattr(formats, fmts[1])
    fo = getattr(formats, fmts[2]) if fmts[2] else None
    g = torch.Generator().manual_seed(E + K + N)
    occ = torch.randint(0, 4, (E,), generator=g)
    occ[torch.randperm(E, generator=g)[:E - max(E // 4, 2)]] = 0
    # the stacks are drawn and packed on the card (qwen3's are 805 M codes)
    gd = torch.Generator(device=cuda).manual_seed(E + K + N)
    a = _routed(gd, E, M, K, occ, fa)
    b = posit.pack(torch.randn(E, K, N, generator=gd, device=cuda)
                   * K ** -0.5, fb)
    assert torch.equal(pm.occupied_rows_plain(a, fa).cpu(), occ.to(torch.int32))
    variant = pm.grouped_variant(fb, b.dtype)
    ops.reset_launches()
    got = pm.posit_matmul_grouped(a, b, fa, fb)
    assert ops.launch_counts()[f"posit_matmul_grouped:{variant}"] == 1
    plain = pm.posit_matmul_grouped_plain(a, b, fa, fb)
    assert bool(((got - plain).abs() <= pm.sum_bound(a, b, fa, fb)).all())
    for e, n in enumerate(occ.tolist()):
        assert _bits_equal(got[e, n:], torch.zeros_like(got[e, n:]))
    if fo is not None:
        codes = pm.posit_matmul_grouped(a, b, fa, fb, fo)
        assert _bits_equal(codes, posit_codec.encode_plain(got, fo))


@pytest.mark.parametrize("fmt_a", [None, "P13_2"])
def test_posit_matmul_grouped_expert_independent_of_routing(cuda, fmt_a):
    """An expert's K9 output does not depend on the other experts' rows:
    bitwise equal under two routings that differ elsewhere and to the same
    expert alone in an E = 1 call; two calls are bitwise equal; an expert
    with no rows gives zeros."""
    fa = getattr(formats, fmt_a) if fmt_a else None
    fb = formats.P16_2
    E, M, K, N = 32, 8, 4096, 1536
    g = torch.Generator().manual_seed(31)
    occ1 = torch.randint(0, 4, (E,), generator=g)
    occ2 = torch.where(torch.arange(E) % 2 == 0, occ1,
                       torch.randint(0, 9, (E,), generator=g))
    occ1[3] = 0
    occ2[3] = 0
    gd = torch.Generator(device=cuda).manual_seed(31)
    full = _routed(gd, E, M, K, [M] * E, fa)
    keep = [e for e in range(E) if e % 2 == 0]
    a1, a2 = full.clone(), full.clone()
    for a, occ in ((a1, occ1), (a2, occ2)):
        for e, n in enumerate(occ.tolist()):
            a[e, n:] = 0
    b = posit.pack(torch.randn(E, K, N, generator=gd, device=cuda)
                   * K ** -0.5, fb)
    o1 = pm.posit_matmul_grouped(a1, b, fa, fb)
    o2 = pm.posit_matmul_grouped(a2, b, fa, fb)
    assert _bits_equal(pm.posit_matmul_grouped(a1, b, fa, fb), o1)
    assert _bits_equal(o1[keep], o2[keep])
    assert _bits_equal(o1[3], torch.zeros_like(o1[3]))
    for e in (0, 2, 5):
        alone = pm.posit_matmul_grouped(a1[e:e + 1].contiguous(),
                                        b[e:e + 1].contiguous(), fa, fb)
        assert _bits_equal(alone[0], o1[e])


@pytest.mark.parametrize("B", [1, 4, 5, 16, 17])
@pytest.mark.parametrize("fmt_name", ["P16_2", "P16_1"])
@pytest.mark.parametrize("transpose", [True, False])
def test_decode_sample_batch_rows(cuda, transpose, fmt_name, B):
    """K4 at 1 to 17 batch rows (one pass of 4 or 16 rows, or two of 16),
    both layouts, the P(16,2) and the run-time decode: tokens equal to the
    plain head plus sampler (near ties excepted, as `_check_tokens`), on
    the variant `sample_variant` picks, and the first rows' tokens bitwise
    those of a batch of 4."""
    fmt = getattr(formats, fmt_name)
    g = torch.Generator(device=cuda).manual_seed(17)
    D, V = 1024, 20000
    x = torch.randn(17, D, generator=g, device=cuda)
    w = posit.pack(torch.randn((V, D) if transpose else (D, V), generator=g,
                               device=cuda) * 0.05, fmt)
    noise = -torch.log(-torch.log(torch.rand(17, V, generator=g, device=cuda)
                                  .clamp(1e-9, 1 - 1e-7)))
    variant = pa.sample_variant(w.dtype, fmt)
    assert variant == ("p16_2" if fmt_name == "P16_2" else "posit")
    l = pa.head_logits_plain(x[:B], w, plan="fused", fmt_w=fmt,
                             transpose=transpose, softcap_val=0.0)
    n = min(B, 4)
    for greedy, top_k in ((True, 0), (False, 40), (False, 0)):
        kw = dict(plan="fused", fmt_w=fmt, transpose=transpose,
                  greedy=greedy, top_k=top_k)
        ops.reset_launches()
        tok = pa.decode_sample(x[:B].contiguous(), w,
                               noise[:B].contiguous(), 0.8, **kw)
        assert ops.launch_counts()[f"decode_sample:{variant}"] == 1
        plain = pa.sample_logits(l, noise[:B], 0.8, greedy=greedy,
                                 top_k=top_k)
        _check_tokens(tok, plain, _scores(l, noise[:B], 0.8, greedy, top_k))
        four = pa.decode_sample(x[:4].contiguous(), w, noise[:4].contiguous(),
                                0.8, **kw)
        assert torch.equal(tok[:n], four[:n])


# ---------------------------------------------------------------------------
# QAT training: the STE autograd functions, K6 at P(13,2) x P(13,2), remat
# ---------------------------------------------------------------------------

# minitron-8b's projections, (K, N)
MINITRON_KN = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
               "wo": (4096, 4096), "gate": (4096, 16384),
               "up": (4096, 16384), "down": (16384, 4096)}


@pytest.mark.parametrize("M,K,N", [(512, K, N) for K, N in
                                   sorted(set(MINITRON_KN.values()))]
                         + [(9, 2050, 1000), (511, 2050, 1000),
                            (512, 2050, 1000), (515, 2050, 1000)])
def test_posit_matmul_tc_p13_both_operands(cuda, M, K, N):
    """The training path's K6: P(13,2) activations x P(13,2) weights, both
    int16, on the `tc` variant (run-time decode, split-bf16 wgmma) at M 512
    over minitron's projections and at ragged M: within `sum_bound`,
    bitwise equal on a second call."""
    fa = fb = formats.P13_2
    assert pm.split_exact(fa, fb)
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = posit.pack(torch.randn(M, K, generator=g, device=cuda), fa)
    b = posit.pack(torch.randn(K, N, generator=g, device=cuda) * K ** -0.5,
                   fb)
    assert pm.matmul_variant(M, fa, fb, b.dtype) == ("gemv" if M <= 8
                                                     else "tc")
    ops.reset_launches()
    got = pm.posit_matmul(a, b, fa, fb)
    assert ops.launch_counts()["posit_matmul:tc"] == 1
    plain = pm.posit_matmul_plain(a, b, fa, fb)
    assert bool(((got - plain).abs() <= pm.sum_bound(a, b, fa, fb)).all())
    assert _bits_equal(pm.posit_matmul(a, b, fa, fb), got)


STE_CASES = {
    "fused_matmul_ste": (ops.fused_matmul_ste, formats.P13_2, (512, 2048),
                         (2048, 1536)),
    "matmul_posit_weights_ste": (ops.fused_matmul_ste, None, (512, 2048),
                                 (2048, 1536)),
    "fused_matmul_grouped_ste": (ops.fused_matmul_grouped_ste,
                                 formats.P13_2, (4, 64, 1024), (4, 1024, 768)),
    "matmul_posit_weights_grouped_ste": (ops.fused_matmul_grouped_ste, None,
                                         (4, 64, 1024), (4, 1024, 768)),
}


@pytest.mark.parametrize("case", sorted(STE_CASES))
def test_ste_functions_match_plain(cuda, case):
    """The four STE functions on the card against `ops.ste_plain`: the
    forward within `sum_bound` (bitwise for the 2-D float-activation path,
    K1 + the same matmul), dx and dw bitwise for a given g; the kernels
    launched (K2, then K6 / K9 / K1)."""
    fn, fmt_a, xs, ws = STE_CASES[case]
    fmt_w = formats.P13_2
    g = torch.Generator(device=cuda).manual_seed(len(case))
    x = torch.randn(*xs, generator=g, device=cuda)
    w = torch.randn(*ws, generator=g, device=cuda) * ws[-2] ** -0.5
    gr = torch.randn(*xs[:-1], ws[-1], generator=g, device=cuda)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    ops.reset_launches()
    out = fn(xr, wr, fmt_a, fmt_w)
    dx, dw = torch.autograd.grad(out, (xr, wr), gr)
    counts = ops.launch_counts()
    assert counts["posit_encode:p13_2"] == (1 if fmt_a is None else 2)
    gemm = ("posit_matmul_grouped" if len(xs) == 3 else
            "posit_matmul" if fmt_a is not None else "posit_decode")
    assert counts[gemm] >= 1
    want, want_dx, want_dw = ops.ste_plain(x, w, fmt_a, fmt_w, gr)
    if len(xs) == 2 and fmt_a is None:
        assert _bits_equal(out, want)
    else:
        a = x if fmt_a is None else posit_codec.encode_plain(x, fmt_a)
        bound = pm.sum_bound(a, posit_codec.encode_plain(w, fmt_w), fmt_a,
                             fmt_w)
        assert bool(((out - want).abs() <= bound).all())
    assert _bits_equal(dx, want_dx) and _bits_equal(dw, want_dw)


@pytest.mark.parametrize("grouped", [False, True])
def test_ste_grads_bitwise_fake_quant_on_card(cuda, grouped):
    """On the card, too, the fused plan's gradients are the fake_quant
    plan's, bitwise (paper_mixed, f32)."""
    from repro_torch.core.quant import QuantPolicy
    from repro_torch.kernels import dispatch
    fn = dispatch.qdot_grouped if grouped else dispatch.qdot
    xs, ws = ((4, 64, 1024), (4, 1024, 768)) if grouped else \
        ((4, 128, 2048), (2048, 1536))
    g = torch.Generator(device=cuda).manual_seed(31 + grouped)
    x = torch.randn(*xs, generator=g, device=cuda)
    w = torch.randn(*ws, generator=g, device=cuda) * ws[-2] ** -0.5
    gr = torch.randn(*xs[:-1], ws[-1], generator=g, device=cuda)
    policy = QuantPolicy(weights=formats.P13_2, activations=formats.P13_2)
    grads = []
    for pol in (policy, policy.with_execution("fused")):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(xr, wr, pol), (xr, wr), gr))
    for a, b in zip(*grads):
        assert _bits_equal(a, b)


def test_remat_recompute_bitwise_first_forward(cuda):
    """A layer recomputed in the backward (cfg.remat "layer") is bitwise
    its first forward on the card: the gradients with remat equal those
    without, bitwise, and a layer run twice gives the same bits."""
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, transformer
    from repro_torch.models.module import tree_leaves
    from repro_torch.train import step
    base = configs.get_smoke("minitron_8b").replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
        quant=policy_by_name("paper_mixed").with_execution("fused"))
    tok = torch.randint(0, base.vocab_size, (2, 4, 64),
                        generator=torch.Generator().manual_seed(5))
    batch = {"tokens": tok[0].to(cuda), "labels": tok[1].to(cuda)}
    out = []
    for remat in ("layer", "none"):
        cfg = base.replace(remat=remat)
        params = api.init(torch.Generator(device=cuda).manual_seed(2), cfg,
                          cuda)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, _ = step.loss_fn(params, batch, cfg)
        loss.backward()
        out.append([loss] + [p.grad for p in tree_leaves(params)])
    for a, b in zip(*out):
        assert _bits_equal(a, b)
    p = {k: v[0].detach() for k, v in params["layers"].items()}
    x = torch.randn(4, 64, 256, device=cuda)
    pos = torch.arange(64, dtype=torch.int32, device=cuda)[None].expand(4, 64)
    with torch.no_grad():
        first = transformer._seq_layer(p, x, base, pos, True)[0]
        assert _bits_equal(transformer._seq_layer(p, x, base, pos, True)[0],
                           first)


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "deepseek_moe_16b"])
def test_moe_remat_recompute_bitwise_first_forward(cuda, arch):
    """The MoE layer recomputed in the backward routes as its first forward
    did on the card (stable sort, K9 without atomics): loss, aux and every
    gradient with remat equal those without, bitwise; every K9 launch takes
    the run-time decode (both operands P(13,2) codes)."""
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api
    from repro_torch.models.module import tree_leaves
    from repro_torch.train import step
    base = configs.get_smoke(arch).replace(
        d_model=256, n_heads=4, n_kv_heads=2 if arch.startswith("qwen") else 4,
        head_dim=64, moe_d_ff=384, n_experts=16, capacity_factor=1.25,
        quant=policy_by_name("paper_mixed").with_execution("fused"))
    tok = torch.randint(0, base.vocab_size, (2, 4, 64),
                        generator=torch.Generator().manual_seed(7))
    batch = {"tokens": tok[0].to(cuda), "labels": tok[1].to(cuda)}
    out = []
    for remat in ("layer", "none"):
        cfg = base.replace(remat=remat)
        params = api.init(torch.Generator(device=cuda).manual_seed(2), cfg,
                          cuda)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        ops.reset_launches()
        loss, metrics = step.loss_fn(params, batch, cfg)
        loss.backward()
        counts = ops.launch_counts()
        assert counts["posit_matmul_grouped"] == \
            counts["posit_matmul_grouped:posit"] == \
            3 * cfg.n_layers * (2 if remat == "layer" else 1)
        out.append([loss, metrics["aux"]]
                   + [p.grad for p in tree_leaves(params)])
    assert torch.isfinite(out[0][0])
    for a, b in zip(*out):
        assert _bits_equal(a, b)


# ---------------------------------------------------------------------------
# gemma3-4b and command-r-plus-104b shapes: head_dim 256, G = 2 with a
# 1024-token window, G = 12; K4 at V 2^18; the dense cache on the card
# ---------------------------------------------------------------------------

# lengths around gemma3's window (1024) and a split boundary (1056 = 33
# splits of 32 keys), and one whose window starts past many whole splits
GEMMA_LENGTHS = [1024, 1025, 1057, 1300]


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("window", [1024, 1 << 30])
def test_paged_attention_head_dim_256_window(cuda, window, kind):
    """K3 at gemma3's heads (8 / 4 of 256, pages of 16) over spans that pass
    the 1024-token window: with the window, whole splits before it are
    empty partials (max -inf, sum 0) the merge must weigh zero; within
    2e-5 of the plain version, finite, merged; K7 (T = 4) rows bitwise K3."""
    fmt = formats.P8_2 if kind == "int8" else None
    dt = torch.int8 if kind == "int8" else torch.bfloat16
    B, M = len(GEMMA_LENGTHS), 90
    q3, kp, vp, bt = _attn_inputs(cuda, dt, fmt, 256 + window % 7, B=B, Hq=8,
                                  Hkv=4, Dh=256, M=M, P=B * M + 1)
    ln = torch.tensor(GEMMA_LENGTHS, dtype=torch.int32, device=cuda)
    win = torch.tensor([window], dtype=torch.int32, device=cuda)
    q4 = torch.randn(B, 4, 8, 256, generator=torch.Generator().manual_seed(3)
                     ).to(cuda)
    for q in (q3, q4):
        ops.reset_launches()
        got = pa.paged_attention(q, kp, vp, bt, ln, win, fmt_kv=fmt)
        key = "paged_attention_mq" if q.ndim == 4 else "paged_attention"
        assert ops.launch_counts()[f"{key}:merge"] == 1
        want = pa.paged_attention_plain(q, kp, vp, bt, ln, win, fmt_kv=fmt)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for i in range(4):
        row = pa.paged_attention(q4[:, i].contiguous(), kp, vp, bt,
                                 ln - 3 + i, win, fmt_kv=fmt)
        assert _bits_equal(got[:, i], row)


def test_paged_attention_head_dim_256_page_sizes(cuda):
    """At head_dim 256 a split of 64-token pages fits the shared memory
    (within 2e-5 of the plain version); 128-token pages do not, and the
    launcher refuses them before launching."""
    for ps, M in ((64, 24), (128, 12)):
        q, kp, vp, bt = _attn_inputs(cuda, torch.int8, formats.P8_2, ps,
                                     Hq=8, Hkv=4, Dh=256, ps=ps, M=M,
                                     P=4 * M + 1)
        ln = torch.tensor([ps * M, 1, ps + 1, 1000], dtype=torch.int32,
                          device=cuda)
        win = torch.tensor([1024], dtype=torch.int32, device=cuda)
        if ps == 128:
            before = pa.LAUNCHES["paged_attention"]
            with pytest.raises(ValueError, match="shared memory"):
                pa.paged_attention(q, kp, vp, bt, ln, win,
                                   fmt_kv=formats.P8_2)
            assert pa.LAUNCHES["paged_attention"] == before
            continue
        got = pa.paged_attention(q, kp, vp, bt, ln, win, fmt_kv=formats.P8_2)
        want = pa.paged_attention_plain(q, kp, vp, bt, ln, win,
                                        fmt_kv=formats.P8_2)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_group_of_12(cuda):
    """K3 and K7 at command-r-plus's 96 query heads over 8 KV heads (G = 12,
    a group that does not divide a warp's 16 rows), against the plain
    version; each K7 row bitwise K3."""
    q3, kp, vp, bt = _attn_inputs(cuda, torch.int8, formats.P8_2, 12, B=4,
                                  Hq=96, Hkv=8, M=20, P=81)
    ln = torch.tensor([300, 33, 1, 64], dtype=torch.int32, device=cuda)
    for window in (100, 1 << 30):
        win = torch.tensor([window], dtype=torch.int32, device=cuda)
        got = pa.paged_attention(q3, kp, vp, bt, ln, win, fmt_kv=formats.P8_2)
        want = pa.paged_attention_plain(q3, kp, vp, bt, ln, win,
                                        fmt_kv=formats.P8_2)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        q4 = torch.randn(4, 4, 96, 128,
                         generator=torch.Generator().manual_seed(12)).to(cuda)
        got = pa.paged_attention(q4, kp, vp, bt, ln, win, fmt_kv=formats.P8_2)
        want = pa.paged_attention_plain(q4, kp, vp, bt, ln, win,
                                        fmt_kv=formats.P8_2)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        for t in range(4):
            row = pa.paged_attention(q4[:, t].contiguous(), kp, vp, bt,
                                     ln - 3 + t, win, fmt_kv=formats.P8_2)
            assert _bits_equal(got[:, t], row)


def _prefill_inputs(cuda, act, B, C, Hq, Hkv, Dh, ps, M, starts, window,
                    seed):
    """Random q / k / v, P(8,2) pools and block tables for K5 on the card."""
    fmt = formats.P8_2
    g = torch.Generator().manual_seed(seed)
    P = B * M + 1
    kv = posit.pack(torch.randn(2, P, ps, Hkv * Dh, generator=g), fmt)
    bt = torch.zeros(B, M, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=g) + 1
    for b in range(B):
        n = -(-(starts[b] + C) // ps)
        bt[b, :n] = perm[b * M:b * M + n].to(torch.int32)
    q, k, v = (torch.randn(B, C, h, Dh, generator=g).to(act).to(cuda)
               for h in (Hq, Hkv, Hkv))
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    win = torch.tensor([window], dtype=torch.int32, device=cuda)
    return (q, k, v, kv[0].to(cuda), kv[1].to(cuda), bt.to(cuda), st, win,
            dict(fmt_kv=fmt, compute_dtype=act, flash_chunk=1024))


def _prefill_case(cuda, act, B, C, Hq, Hkv, Dh, ps, M, starts, window, seed):
    """K5 against its plain version: output within one bf16 ulp (bf16) or
    2e-5 (f32), page writes bitwise; returns the variant it launched."""
    q, k, v, kp, vp, bt, st, win, kw = _prefill_inputs(
        cuda, act, B, C, Hq, Hkv, Dh, ps, M, starts, window, seed)
    kp2, vp2 = kp.clone(), vp.clone()
    ops.reset_launches()
    got, _, _ = pf.prefill_attention_paged(q, k, v, kp, vp, bt, st, win, **kw)
    variant = pf.prefill_variant(act, Dh)
    assert ops.launch_counts()[f"prefill_attention:{variant}"] == 1
    want, _, _ = pf.prefill_attention_paged_plain(q, k, v, kp2, vp2, bt, st,
                                                  win, **kw)
    assert torch.isfinite(got.float()).all()
    if act == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -7, atol=1e-6)
    assert _bits_equal(kp[1:], kp2[1:]) and _bits_equal(vp[1:], vp2[1:])
    return variant


@pytest.mark.parametrize("act,variant", [(torch.float32, "simt"),
                                         (torch.bfloat16, "tc256")])
@pytest.mark.parametrize("window", [1024, 1 << 30])
def test_prefill_attention_simt_head_dim_256_window(cuda, window, act,
                                                    variant):
    """K5 at gemma3's heads (8 / 4 of 256): f32 activations keep the SIMT
    kernel there, bf16 take tc256; a 64-token chunk at starts past 1024,
    so the window cuts into the first flash chunk of history."""
    assert _prefill_case(cuda, act, 4, 64, 8, 4, 256, 16, 128,
                         [1024, 1100, 1500, 1960], window, 7) == variant


@pytest.mark.parametrize("head_dim", list(range(144, 257, 16)))
def test_prefill_attention_tc256_head_dims(cuda, head_dim):
    """Every head dim tc256 takes (multiples of 16 in (128, 256]; only 256
    has a power-of-two scale, so the others split q * scale in three
    terms): two slots over 7 key tiles (2 splits), the window biting."""
    assert _prefill_case(cuda, torch.bfloat16, 2, 24, 4, 2, head_dim, 16,
                         24, [100, 350], 200, 3) == "tc256"


def test_prefill_attention_tc256_rows_independent_of_other_slots(cuda):
    """tc256's splits are fixed by the shapes, so a slot's rows are bitwise
    the same whatever another slot's start."""
    outs = []
    for start1 in (1100, 1300):
        q, k, v, kp, vp, bt, st, win, kw = _prefill_inputs(
            cuda, torch.bfloat16, 4, 64, 8, 4, 256, 16, 128,
            [1024, start1, 1500, 1960], 1024, 9)
        outs.append(pf.prefill_attention_paged(q, k, v, kp, vp, bt, st, win,
                                               **kw)[0])
    for b in (0, 2, 3):
        assert _bits_equal(outs[0][b], outs[1][b])
    assert not _bits_equal(outs[0][1], outs[1][1])


def test_prefill_attention_tc256_refused_raises(cuda, monkeypatch):
    """A head dim the tc256 kernel does not take is refused by its launcher
    before anything runs: the wrapper raises, launches nothing else and
    writes no page."""
    q, k, v, kp, vp, bt, st, win, kw = _prefill_inputs(
        cuda, torch.bfloat16, 2, 8, 4, 2, 272, 16, 4, [3, 20], 1 << 30, 5)
    kp0 = kp.clone()
    monkeypatch.setattr(pf, "prefill_variant", lambda dtype, dh: "tc256")
    ops.reset_launches()
    with pytest.raises(ValueError, match="head_dim 272"):
        pf.prefill_attention_paged(q, k, v, kp, vp, bt, st, win, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["prefill_attention"] == 0
    assert _bits_equal(kp, kp0)


def test_prefill_attention_tc_group_of_12(cuda):
    """K5's tensor-core variant at command-r-plus's 96 / 8 heads of 128
    (G = 12 does not divide its 64-row tiles)."""
    assert _prefill_case(cuda, torch.bfloat16, 4, 64, 96, 8, 128, 16, 16,
                         [0, 64, 130, 17], 1 << 30, 12) == "tc"


@pytest.mark.parametrize("D,V", [(2560, 262144), (12288, 32000)])
def test_decode_sample_gemma3_vocab_and_wide_rows(cuda, D, V):
    """K4 over a tied [V, D] P(16,2) head at gemma3's vocab (2^18) and at
    command-r-plus's d_model (12288): tokens equal to the plain head +
    sampler (near ties excepted), greedy and sampled, on p16_2."""
    fmt = formats.P16_2
    g = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn(4, D, generator=g, device=cuda).to(torch.bfloat16)
    w = posit.pack(torch.randn(V, D, generator=g, device=cuda) * 0.05, fmt)
    noise = -torch.log(-torch.log(torch.rand(4, V, generator=g, device=cuda)
                                  .clamp(1e-9, 1 - 1e-7)))
    l = pa.head_logits_plain(x, w, plan="fused", fmt_w=fmt, transpose=True,
                             softcap_val=0.0)
    for greedy, top_k in ((True, 0), (False, 40), (False, 0)):
        ops.reset_launches()
        tok = pa.decode_sample(x, w, noise, 0.8, plan="fused", fmt_w=fmt,
                               transpose=True, greedy=greedy, top_k=top_k)
        assert ops.launch_counts()["decode_sample:p16_2"] == 1
        plain = pa.sample_logits(l, noise, 0.8, greedy=greedy, top_k=top_k)
        _check_tokens(tok, plain, _scores(l, noise, 0.8, greedy, top_k))


@pytest.mark.parametrize("arch", ["command_r_35b", "gemma3_4b",
                                  "command_r_plus_104b"])
def test_dense_engine_equals_paged_engine_on_card(cuda, arch):
    """The smoke configs (f32) served on the card by the dense engine (plain
    attention) and the paged engine (K3, K5, K4): equal greedy streams,
    every page back; `unpack_params` on the card (K1) bitwise the CPU's."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.quant import policy_by_name
    from repro_torch.models import api, packing
    from repro_torch.serve import Request, ServingEngine
    cfg = configs.get_smoke(arch).replace(
        quant=policy_by_name("serve_fused_p16"))
    params = packing.pack_params(
        api.init(torch.Generator(device=cuda).manual_seed(0), cfg), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 27, 40, 12, 9)]

    def serve(**kw):
        eng = ServingEngine(cfg, params, batch_slots=3, max_seq=64, **kw)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=9))
        return {r.rid: r.out_tokens for r in eng.run()}, eng

    ops.reset_launches()
    paged, eng = serve(page_size=16)
    counts = ops.launch_counts()
    for name in ("paged_attention", "prefill_attention", "decode_sample"):
        assert counts[name] > 0, name
    assert eng.pages_in_use == 0
    ops.reset_launches()
    dense, deng = serve(paged=False)
    counts = ops.launch_counts()
    assert counts["paged_attention"] == counts["prefill_attention"] == 0
    assert counts["decode_sample"] == 0
    assert dense == paged
    assert deng.kv_cache_bytes() == sum(
        t.numel() * t.element_size() for t in deng.cache.values())
    cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
               else v.cpu()) for k, v in params.items()}
    on_card = packing.unpack_params(params, cfg)
    on_cpu = packing.unpack_params(cpu, cfg)
    for name in ("wq", "wo_mlp"):
        assert _bits_equal(on_card["layers"][name], on_cpu["layers"][name])
