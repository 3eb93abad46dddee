"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: every test takes the `cuda` fixture, which skips when no
CUDA device is present (decided inside the fixture, never at import).
Run on a machine with an H100 with `pytest -m gpu tests/test_torch_gpu.py`.

Tolerances: the codec kernels are bit-exact (compared as bit patterns);
attention sums in another order than the plain version (f32), held to
rtol = atol = 2e-5; the decode-sample kernel's tokens equal the plain
tokens except where the plain top-two sampling scores lie within 1e-4 of
each other, where the kernel's choice must score within 1e-4 of the best.
"""
import pytest
import torch

from repro_torch.core import formats
from repro_torch.core import posit
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import posit_codec

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
    l = l / max(temperature, 1e-6)
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
