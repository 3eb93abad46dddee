"""PyTorch port vs the JAX reference: the coded posit GEMM (K6) and the
activation-coded fused dispatch.

The reference runs `posit_matmul` in interpret mode (and its host
reference `ref.posit_matmul_ref`); the port runs the kernel's plain
version on the same codes.  Tolerance: products of decoded posits of up
to 12 significand bits each are exact in f32, so the results differ only
by the order of the K-long f32 sums of products of random sign:
|port - reference| <= 16 u sqrt(K) sqrt(sum_k (a_ik b_kj)^2), u = 2^-24
(`posit_matmul.sum_bound`).  A control holds that limit against the K6
kernel's own summation order (which it must pass) and against two planted
faults, weights rounded to bf16 and one K tile left out (which it must
fail).  Coded outputs must
round the port's sum: their value lies between the roundings of
reference - bound and reference + bound.  Where the f32 sums agree
bitwise, the codes must too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import posit as jposit
from repro.core.quant import QuantPolicy as JPolicy
from repro.core.quant import policy_by_name as jpolicy
from repro.kernels import dispatch as jdispatch
from repro.kernels import posit_matmul as jpm
from repro.kernels import ref as jref

from repro_torch.core import formats as tformats
from repro_torch.core import posit as tposit
from repro_torch.core.quant import QuantPolicy as TPolicy
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import posit_matmul as tpm
from repro_torch.kernels.posit_matmul import sum_bound


def _fmt(name):
    return getattr(jformats, name), getattr(tformats, name)


# (fmt_a, fmt_b, fmt_out, M, K, N)
CASES = {
    "a13_w16_f32": ("P13_2", "P16_2", None, 4, 96, 40),
    "a13_w16_ragged": ("P13_2", "P16_2", None, 37, 777, 29),
    "a13_w16_out16": ("P13_2", "P16_2", "P16_2", 5, 300, 130),
    "a8_w16_out8": ("P8_2", "P16_2", "P8_2", 9, 130, 17),
    "a16_w8_f32": ("P16_1", "P8_0", None, 3, 1030, 65),
    "a10_w10_out13": ("P10_2", "P10_2", "P13_2", 64, 200, 64),
}


def _codes(rng, shape, jf, scale):
    return np.array(jposit.pack(
        jnp.asarray(rng.normal(0, scale, shape).astype(np.float32)), jf))


def _assert_codes_round(got, want_f32, bound, fmt):
    """got codes round a sum within `bound` of want_f32 (monotone RNE)."""
    val = tposit.decode(got, fmt)
    lo = tposit.decode(tposit.pack(want_f32 - bound, fmt), fmt)
    hi = tposit.decode(tposit.pack(want_f32 + bound, fmt), fmt)
    assert bool(((val >= lo) & (val <= hi)).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_matmul_matches_reference(name):
    fa, fb, fo, M, K, N = CASES[name]
    (jfa, tfa), (jfb, tfb) = _fmt(fa), _fmt(fb)
    jfo, tfo = _fmt(fo) if fo else (None, None)
    rng = np.random.default_rng(sorted(CASES).index(name))
    a = _codes(rng, (M, K), jfa, 1.0)
    b = _codes(rng, (K, N), jfb, 0.2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    bound = sum_bound(ta, tb, tfa, tfb)
    want_ref = np.array(jref.posit_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                                jfa, jfb, None))
    want_kernel = np.array(jpm.posit_matmul(
        jnp.asarray(a), jnp.asarray(b), jfa, jfb, None, interpret=True))
    got = tops.fused_matmul(ta, tb, tfa, tfb, None)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    for want in (want_ref, want_kernel):
        assert bool(((got - torch.from_numpy(want)).abs() <= bound).all())
    if jfo is None:
        return
    got_codes = tops.fused_matmul(ta, tb, tfa, tfb, tfo)
    assert got_codes.dtype == tposit.storage_dtype(tfo)
    want_codes = np.asarray(jpm.posit_matmul(
        jnp.asarray(a), jnp.asarray(b), jfa, jfb, jfo, interpret=True))
    same = got.numpy() == want_kernel
    np.testing.assert_array_equal(got_codes.numpy()[same], want_codes[same])
    _assert_codes_round(got_codes, torch.from_numpy(want_kernel), bound, tfo)


def test_fused_matmul_zero_codes_are_exact_zero():
    a = torch.zeros(3, 70, dtype=torch.int16)
    b = torch.from_numpy(_codes(np.random.default_rng(1), (70, 5),
                                jformats.P16_2, 1.0))
    out = tops.fused_matmul(a, b, tformats.P13_2, tformats.P16_2)
    assert torch.equal(out, torch.zeros(3, 5))


@pytest.mark.parametrize("packed", [True, False])
def test_qdot_activation_coded_matches_reference(packed):
    """dispatch.qdot under serve_fused_p16_a13: encode the activations to
    P(13,2), then the coded GEMM, as the reference's dispatch does."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 3, 40)).astype(np.float32)
    w = rng.normal(0, 0.2, (40, 24)).astype(np.float32)
    jp, tp = jpolicy("serve_fused_p16_a13"), tpolicy("serve_fused_p16_a13")
    jw = jnp.asarray(w)
    if packed:
        jw = jposit.pack(jw, jformats.P16_2)
    want = np.array(jdispatch.qdot(jnp.asarray(x), jw, jp))
    tw = torch.from_numpy(np.array(jw))
    tx = torch.from_numpy(x)
    got = tdispatch.qdot(tx, tw, tp)
    assert got.shape == (2, 3, 24) and got.dtype == torch.float32
    a_codes = tops.encode(tx.reshape(6, 40), tformats.P13_2)
    w_codes = tw if packed else tops.encode(tw, tformats.P16_2)
    bound = sum_bound(a_codes, w_codes, tformats.P13_2, tformats.P16_2)
    diff = (got.reshape(6, 24) - torch.from_numpy(want).reshape(6, 24)).abs()
    assert bool((diff <= bound).all())


def test_qdot_activation_coded_bf16_activations():
    """bf16 activations (the full-width compute dtype) take the same
    encode -> coded GEMM path and come back in bf16."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (5, 32)).astype(np.float32)
    w = rng.normal(0, 0.2, (32, 16)).astype(np.float32)
    jw = jposit.pack(jnp.asarray(w), jformats.P16_2)
    jp = JPolicy(weights=jformats.P16_2, activations=jformats.P13_2,
                 execution="fused")
    tp = TPolicy(weights=tformats.P16_2, activations=tformats.P13_2,
                 execution="fused")
    want = np.asarray(jdispatch.qdot(jnp.asarray(x, jnp.bfloat16), jw, jp)
                      .astype(jnp.float32))
    got = tdispatch.qdot(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(np.array(jw)), tp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["kernel_order", "tc_order",
                                  "bf16_weights", "dropped_k_tile"])
def test_sum_bound_separates_sound_orders_from_faults(case):
    """The K6 kernel's orders (at decode shapes the split-K GEMV: in each
    K split, warp w sums rows w, w + 8, ... one by one with exact products
    in an f32 accumulator, the split adds its 8 warps in order, the splits
    are added in split order; above, the tensor-core GEMM's TC_BK-row steps)
    must stay within `sum_bound` of torch.matmul, and two faults a kernel
    could make must not."""
    M, K, N = 4, 2048, 64
    rng = np.random.default_rng(5)
    fa, fb = tformats.P13_2, tformats.P16_2
    a = torch.from_numpy(_codes(rng, (M, K), jformats.P13_2, 1.0))
    b = torch.from_numpy(_codes(rng, (K, N), jformats.P16_2, K ** -0.5))
    bound = sum_bound(a, b, fa, fb)
    A, B = tposit.decode(a, fa), tposit.decode(b, fb)
    plain = tops.fused_matmul(a, b, fa, fb)
    if case == "kernel_order":
        ks, _ = tpm.split_k(N, K)
        acc = None
        for k0, k1 in _split_ranges(K, ks):
            warps = []
            for w in range(8):
                part = np.zeros((M, N), np.float32)
                for k in range(k0 + w, k1, 8):
                    part += np.outer(A[:, k].numpy(), B[k].numpy())
                warps.append(part)
            split = warps[0]
            for part in warps[1:]:
                split = split + part
            acc = split if acc is None else acc + split
        assert bool(((torch.from_numpy(acc) - plain).abs() <= bound).all())
        return
    if case == "tc_order":
        # the tensor-core GEMM at M > 8 (a13 geometry): per split, each
        # TC_BK-row K step summed from zero (exact products; its sum rounded
        # once here) and added into the running f32 sum, splits in order
        ks, _ = tpm.tc_split_k(256, N, K)
        acc = None
        for k0, k1 in _split_ranges(K, ks):
            run = torch.zeros(M, N, dtype=torch.float32)
            for s0 in range(k0, k1, tpm.TC_BK):
                s1 = min(s0 + tpm.TC_BK, k1)
                run = run + torch.matmul(A[:, s0:s1].double(),
                                         B[s0:s1].double()).float()
            acc = run if acc is None else acc + run
        assert bool(((acc - plain).abs() <= bound).all())
        return
    if case == "bf16_weights":
        bad = torch.matmul(A, B.to(torch.bfloat16).float())
    else:
        bad = plain - torch.matmul(A[:, :32], B[:32])
    assert bool(((bad - plain).abs() > bound).any())


def _split_ranges(K, ks):
    """The K rows of each split of `split_k`, in the order the kernel sums
    them: split s takes rows [s * ks, min(K, (s + 1) * ks))."""
    return [(k0, min(K, k0 + ks)) for k0 in range(0, K, ks)] or [(0, 0)]


# (N, K): command-r-35b's projections, ragged and tiny shapes
SPLIT_SHAPES = [(8192, 8192), (1024, 8192), (22528, 8192), (8192, 22528),
                (1000, 8190), (130, 517), (65, 333), (40, 96), (7, 1),
                (300, 0)]


def _check_float_gemv_split(N, K, ks, splits):
    """The float GEMV's [K, N] split (`gemv_f_split_k`): splits cover
    [0, K) once, in order, none empty (K = 0: one empty split), KS a
    multiple of GEMV_F_ROWS of at most GEMV_F_MAX_K; the blocks
    (GEMV_F_TILE-wide tiles times splits) reach at least half of their
    aim, about GEMV_F_BLOCK_CODES codes a block and at most GEMV_BLOCKS,
    wherever K has the rows and the cap allows."""
    ranges = _split_ranges(K, ks)
    assert len(ranges) == splits >= 1
    assert ks % tpm.GEMV_F_ROWS == 0 and ks <= tpm.GEMV_F_MAX_K
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == ks
    assert all(k1 > k0 for k0, k1 in ranges) or K == 0
    tiles = -(-N // tpm.GEMV_F_TILE)
    aim = min(tpm.GEMV_BLOCKS, max(1, -(-K * N // tpm.GEMV_F_BLOCK_CODES)))
    steps = max(1, -(-K // tpm.GEMV_F_ROWS))
    if ks < tpm.GEMV_F_MAX_K:
        assert splits >= min(-(-aim // max(tiles, 1)), steps) // 2
        assert tiles * splits <= 2 * aim + tiles


@pytest.mark.parametrize("N,K", SPLIT_SHAPES)
def test_gemv_splits_cover_k_once_in_order(N, K):
    """K6's split-K GEMV (`split_k`): its splits cover [0, K) exactly once,
    in increasing order, none empty (K = 0: one empty split); each split's
    rows are a multiple of the row step (the last one excepted) within the
    shared-memory cap; and wherever K has enough row steps the grid holds
    at least 3 blocks per SM of an H100 (the aim is GEMV_BLOCKS, 4 per SM;
    whole row steps per split can cost up to one).  The float GEMV over
    [K, N] codes (`gemv_f_split_k`): `_check_float_gemv_split`."""
    ks, splits = tpm.split_k(N, K)
    ranges = _split_ranges(K, ks)
    assert len(ranges) == splits >= 1
    assert ks % tpm.GEMV_ROWS == 0 and ks <= tpm.GEMV_MAX_ROWS
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == ks
    assert all(k1 > k0 for k0, k1 in ranges) or K == 0
    tiles = -(-N // tpm.GEMV_BN)
    steps = -(-K // tpm.GEMV_ROWS)
    assert tiles * splits >= min(3 * 132, tiles * max(steps, 1))
    _check_float_gemv_split(N, K, *tpm.gemv_f_split_k(N, K))


@pytest.mark.parametrize("M,fmt_a,fmt_b,dtype,want", [
    (1, "P13_2", "P16_2", torch.int16, "gemv_p16_2"),
    (4, "P13_2", "P16_2", torch.int16, "gemv_p16_2"),
    (8, "P13_2", "P16_2", torch.int16, "gemv_p16_2"),
    (9, "P13_2", "P16_2", torch.int16, "tc_p16_2"),
    (256, "P13_2", "P16_2", torch.int16, "tc_p16_2"),
    (4, "P13_2", "P16_1", torch.int16, "gemv"),
    (3, "P8_2", "P8_0", torch.int8, "gemv"),
    (64, "P10_2", "P10_2", torch.int16, "tc"),
    (256, "P8_2", "P16_1", torch.int16, "tc"),
    (40, "P16_3", "P16_2", torch.int16, "tiled"),
    (4, "P16_3", "P16_2", torch.int16, "gemv_p16_2"),
])
def test_matmul_variant_by_shape_and_format(M, fmt_a, fmt_b, dtype, want):
    """K6's wrapper picks its kernel by M and the formats alone: the
    split-K GEMV at decode shapes (the compile-time P(16,2) decode for the
    a13 weights), above GEMV_MAX_M rows the split-bf16 tensor-core GEMM
    where `split_exact` holds, else the f32 SIMT tiles."""
    fa, fb = (_fmt_by_name(f)[1] for f in (fmt_a, fmt_b))
    assert tpm.matmul_variant(M, fa, fb, dtype) == want


def _weight_view(fmt_name, dtype, layout, K=40, N=24):
    """Codes of fmt in `dtype` as [K, N]: contiguous ("kn"), the transpose
    of contiguous [N, K] codes ("t"), or a strided view of neither kind."""
    w = torch.zeros(N, K, dtype=dtype)
    return {"kn": w.T.contiguous(), "t": w.T,
            "strided": torch.zeros(K, 2 * N, dtype=dtype)[:, ::2]}[layout]


@pytest.mark.parametrize("M", [1, 8, 9])
@pytest.mark.parametrize("fmt_w,dtype,layout,want", [
    ("P16_2", torch.int16, "kn", "p16_2"),
    ("P16_2", torch.int16, "t", "p16_2_t"),
    ("P16_2", torch.int16, "strided", "p16_2"),
    ("P13_2", torch.int16, "kn", "posit"),
    ("P8_2", torch.int8, "kn", "posit"),
    ("P8_2", torch.int8, "t", "posit_t"),
    ("P16_1", torch.int16, "t", "posit_t"),
])
def test_gemv_f_variant_by_rows_format_and_layout(M, fmt_w, dtype, layout,
                                                  want):
    """The float weight path picks its kernel from M, the weight format and
    the layout alone: the float GEMV at most GEMV_MAX_M rows (the
    compile-time P(16,2) decode for int16 P(16,2) codes, "_t" over the
    transpose of contiguous [N, K] codes), K1 + torch.matmul ("decode")
    above."""
    fmt = _fmt_by_name(fmt_w)[1]
    w = _weight_view(fmt_w, dtype, layout)
    assert tpm.gemv_f_variant(M, fmt, w) == (want if M <= tpm.GEMV_MAX_M
                                              else "decode")


# (N, K): the tied heads (command-r-35b, gemma3-4b, command-r-plus-104b),
# few row tiles, ragged and tiny shapes
SPLIT_T_SHAPES = [(256000, 8192), (262144, 2560), (256000, 12288),
                  (1024, 8192), (1000, 8190), (130, 517), (7, 1), (300, 0)]


@pytest.mark.parametrize("N,K", SPLIT_T_SHAPES)
def test_gemv_f_t_splits_cover_k_once_in_order(N, K):
    """The transposed float GEMV's splits (`split_k_t`): GEMV_T_SPLIT codes
    of each output row (8 warps x 256), covering [0, K) once, in order,
    none empty (K = 0: one empty split); at a tied head's N the row tiles
    alone give every SM of an H100 many blocks."""
    ks, splits = tpm.split_k_t(N, K)
    ranges = _split_ranges(K, ks)
    assert ks == tpm.GEMV_T_SPLIT and len(ranges) == splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == ks
    assert all(k1 > k0 for k0, k1 in ranges) or K == 0
    if N >= 50000:
        assert -(-N // tpm.GEMV_F_TILE) * splits >= 4 * 132


@pytest.mark.parametrize("N,K,ks,splits", [
    (1024, 8192, 512, 16), (8192, 8192, 1792, 5), (22528, 8192, 2048, 4),
    (8192, 22528, 2048, 11), (256, 2048, 512, 4), (8512, 2048, 512, 4)])
def test_gemv_f_split_k_at_serving_shapes(N, K, ks, splits):
    """The float GEMV's [K, N] geometry at command-r-35b's, paligemma-3b's
    and mamba2-1.3b's projections: no 128-way splits at N 1024."""
    assert tpm.gemv_f_split_k(N, K) == (ks, splits)


# every format of the port, and two whose split products overflow f32
SPLIT_FORMATS = {"P8_0": True, "P8_1": True, "P8_2": True, "P10_2": True,
                 "P13_2": True, "P16_1": True, "P16_2": True,
                 "P16_0": True, "P16_3": False, "P9_4": False}


def _fmt_by_name(name):
    n, es = (int(x) for x in name[1:].split("_"))
    return jformats.PositFormat(n, es), tformats.PositFormat(n, es)


@pytest.mark.parametrize("name", sorted(SPLIT_FORMATS))
def test_split_bf16_exact_on_every_code(name):
    """K6's tensor-core variant multiplies hi = bf16(x), lo = bf16(x - hi):
    on every code of the format, decoded by the reference, hi + lo == x
    exactly with lo == x - hi (no rounding in either term), zero gives two
    zeros and NaR two nans; `split_exact` accepts the format against
    P(16,2) and itself exactly where every term product is a normal f32."""
    jf, tf = _fmt_by_name(name)
    codes = np.arange(1 << jf.n, dtype=np.int64)
    x = torch.from_numpy(np.array(
        jposit.decode(jnp.asarray(codes, jnp.int32), jf), np.float32))
    hi, lo = tpm.split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    h, l = hi.double(), lo.double()
    nar = torch.isnan(x)
    assert int(nar.sum()) == 1 and bool(torch.isnan(h[nar]).all()) \
        and bool(torch.isnan(l[nar]).all())
    assert h[0] == 0 and l[0] == 0
    assert torch.equal((h + l)[~nar], x.double()[~nar])
    assert torch.equal(l[~nar], (x.double() - h)[~nar])
    assert tpm.split_exact(tf, tformats.P16_2) is SPLIT_FORMATS[name]
    assert tpm.split_exact(tf, tf) is SPLIT_FORMATS[name]


# (M, N, K, splits): a13 prefill projections of command-r-35b (N 1024
# needs 8 splits to near one block per SM), ragged and tiny shapes (None:
# not pinned)
TC_SHAPES = [(256, 8192, 8192, 1), (256, 1024, 8192, 8),
             (256, 22528, 8192, 1), (256, 8192, 22528, 1),
             (9, 1000, 8190, 16), (257, 65, 333, None),
             (33, 130, 517, None), (100, 7, 1, 1), (64, 300, 0, 1)]


@pytest.mark.parametrize("M,N,K,want", TC_SHAPES)
def test_tc_splits_cover_k_once_in_order(M, N, K, want):
    """The tensor-core GEMM's splits cover [0, K) once, in increasing
    order, none empty (K = 0: one split of zeros), each a multiple of its
    TC_BK-row K step, and tiles x splits stay within TC_BLOCKS (one block per
    SM of an H100) unless the tiles alone exceed it."""
    ks, splits = tpm.tc_split_k(M, N, K)
    assert ks % tpm.TC_BK == 0 and ks >= tpm.TC_BK and splits >= 1
    ranges = _split_ranges(K, ks)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == ks
    assert all(k1 > k0 for k0, k1 in ranges) or K == 0
    tiles = -(-M // tpm.TC_BM) * -(-N // tpm.TC_BN)
    assert tiles * splits <= max(tpm.TC_BLOCKS, tiles)
    if want is not None:
        assert splits == want


# ---------------------------------------------------------------------------
# K9: the grouped GEMV's variant, split geometry and occupied rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt_b,dtype,want", [
    ("P16_2", torch.int16, "p16_2"),
    ("P16_1", torch.int16, "posit"),
    ("P13_2", torch.int16, "posit"),
    ("P8_2", torch.int8, "posit"),
    ("P8_0", torch.int8, "posit"),
])
def test_grouped_variant_by_weight_format(fmt_b, dtype, want):
    """K9's wrapper picks the compile-time P(16,2) decode for int16
    P(16,2) expert stacks (every serving MoE layer) and the run-time
    decode for any other weight format, at the serving capacity of 8 rows
    with float activations."""
    assert tpm.grouped_variant(8, None, _fmt_by_name(fmt_b)[1], dtype) == want


# (M, fmt_a, fmt_b, weight dtype, variant)
GROUPED_VARIANTS = [
    (8, "P13_2", "P13_2", torch.int16, "posit"),     # serving rows: GEMV
    (8, "P13_2", "P16_2", torch.int16, "p16_2"),
    (1, None, "P16_2", torch.int16, "p16_2"),
    (9, "P13_2", "P13_2", torch.int16, "tc_p13_2"),  # training: tensor cores
    (40, "P13_2", "P13_2", torch.int16, "tc_p13_2"),
    (64, "P13_2", "P13_2", torch.int16, "tc_p13_2"),
    (80, "P13_2", "P13_2", torch.int16, "tc_p13_2"),
    (40, "P13_2", "P16_2", torch.int16, "tc"),
    (64, "P8_2", "P16_1", torch.int16, "tc"),
    (40, None, "P13_2", torch.int16, "posit"),       # float activations
    (64, None, "P16_2", torch.int16, "p16_2"),
    (40, "P16_3", "P16_2", torch.int16, "p16_2"),    # split not exact
    (40, "P16_3", "P13_2", torch.int16, "posit"),
    (40, "P13_2", "P8_2", torch.int8, "posit"),      # int8 weight codes
]


@pytest.mark.parametrize("M,fmt_a,fmt_b,dtype,want", GROUPED_VARIANTS)
def test_grouped_variant_by_rows_and_formats(M, fmt_a, fmt_b, dtype, want):
    """K9's kernel by shape and format, as `matmul_variant` picks K6's:
    above 8 rows, coded activations, int16 weights and an exact bf16 split
    of both formats take the tensor-core GEMM ("tc_p13_2" with the P(13,2)
    decode table, "tc" otherwise); every other call keeps the GEMV, at 8
    rows exactly as before."""
    fa = _fmt_by_name(fmt_a)[1] if fmt_a else None
    fb = _fmt_by_name(fmt_b)[1]
    assert tpm.grouped_variant(M, fa, fb, dtype) == want
    if want.startswith("tc"):
        assert tpm.split_exact(fa, fb)


# (M, N, K): the MoE training shapes (qwen3-moe: 40 capacity rows of a
# 512-token microbatch; deepseek-moe: 64), 80 rows (two M tiles), ragged
# and tiny shapes
GROUPED_TC_SHAPES = [(40, 1536, 4096), (40, 4096, 1536), (64, 1408, 2048),
                     (64, 2048, 1408), (80, 384, 1024), (9, 130, 517),
                     (20, 66, 333), (64, 300, 0), (9, 1, 1), (200, 7, 4097)]


@pytest.mark.parametrize("M,N,K", GROUPED_TC_SHAPES)
def test_grouped_tc_splits_cover_k_once_in_order(M, N, K):
    """The tensor-core K9's K splits cover [0, K) once, in increasing
    order, none empty (K = 0: one empty split), each a multiple of its
    64-row K step; the geometry is a function of (M, N, K) alone (the
    wrapper passes no E, so an expert's sums are those of an E = 1 call);
    the splits are the shortest multiple of 64 rows that gives at most
    ceil(8 / tiles) splits (an expert's tiles x splits near 8 blocks), and
    the training shapes take one split (the output written directly)."""
    ks, splits = tpm.grouped_tc_split_k(M, N, K)
    assert (ks, splits) == tpm.grouped_tc_split_k(M, N, K)
    assert ks % tpm.GROUPED_TC_BK == 0 and ks >= tpm.GROUPED_TC_BK
    ranges = _split_ranges(K, ks)
    assert len(ranges) == splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == ks
    assert all(k1 > k0 for k0, k1 in ranges) or K == 0
    tiles = -(-M // tpm.GROUPED_TC_BM) * -(-N // tpm.GROUPED_TC_BN)
    want = max(1, -(-tpm.GROUPED_TC_EXPERT_BLOCKS // tiles))
    assert splits <= want
    shorter = ks - tpm.GROUPED_TC_BK
    assert shorter == 0 or -(-K // shorter) > want
    if (M, N, K) in GROUPED_TC_SHAPES[:4]:
        assert splits == 1


def test_p13_2_decode_table_matches_reference():
    """K9's "tc_p13_2" decode table against the JAX reference's decode on
    all 8192 P(13,2) codes: the low half is bf16(value), the high half the
    remainder, hi + lo == value bitwise (NaR: nan in both halves)."""
    jf = jformats.P13_2
    want = np.array(jposit.decode(jnp.asarray(np.arange(1 << 13), jnp.int32),
                                  jf), np.float32)
    table = tpm.p13_2_table()
    assert table.dtype == torch.int32 and table.shape == (1 << 13,)
    halves = table.view(torch.int16).reshape(-1, 2)
    hi, lo = (halves[:, i].contiguous().view(torch.bfloat16).float()
              for i in (0, 1))
    nar = np.isnan(want)
    assert nar.sum() == 1 and nar[1 << 12]
    assert torch.isnan(hi[1 << 12]) and torch.isnan(lo[1 << 12])
    fin = torch.from_numpy(~nar)
    value = torch.from_numpy(want)
    assert torch.equal((hi + lo)[fin].view(torch.int32),
                       value[fin].view(torch.int32))
    assert torch.equal(hi[fin], value[fin].to(torch.bfloat16).float())
    assert (lo[fin] != 0).any()     # the split needs its second term


# (M, N, K): qwen3-moe's expert GEMMs at capacity 8 (gate / up, down),
# deepseek-moe's, ragged and tiny shapes
GROUPED_SHAPES = [(8, 1536, 4096), (8, 4096, 1536), (8, 1408, 2048),
                  (8, 2048, 1408), (20, 66, 333), (5, 130, 517),
                  (64, 1536, 4096), (1, 7, 1), (8, 300, 0)]


@pytest.mark.parametrize("M,N,K", GROUPED_SHAPES)
def test_grouped_splits_cover_k_once_in_order(M, N, K):
    """K9's K splits cover [0, K) once, in increasing order, none empty
    (K = 0: one empty split), each a multiple of the row step within the
    shared-memory cap; the geometry is a function of (M, N, K) alone, and
    where K has enough row steps an occupied expert gets at least 16
    blocks, so the 32 experts of a decode step give the 132 SMs 3 or more
    blocks each."""
    ks, splits = tpm.grouped_split_k(M, N, K)
    assert (ks, splits) == tpm.grouped_split_k(M, N, K)
    assert ks % tpm.GEMV_ROWS == 0 and ks <= tpm.GEMV_MAX_ROWS
    ranges = _split_ranges(K, ks)
    assert len(ranges) == splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == ks
    assert all(k1 > k0 for k0, k1 in ranges) or K == 0
    tiles = -(-M // tpm.GROUPED_BM) * -(-N // tpm.GEMV_BN)
    steps = -(-K // tpm.GEMV_ROWS)
    assert tiles * splits >= min(16, tiles * max(steps, 1))
    if (M, N, K) in ((8, 1536, 4096), (8, 4096, 1536)):
        assert 32 * tiles * splits >= 3 * 132


def _routed_buffer(rng, E, M, K, occupancy, fmt=None):
    """An [E, M, K] dispatch buffer whose expert e holds occupancy[e]
    leading rows of activations and zeros after (as `moe._dispatch` fills
    its capacity), f32 or (fmt) codes as numpy."""
    x = rng.normal(0, 1, (E, M, K)).astype(np.float32)
    for e, n in enumerate(occupancy):
        x[e, n:] = 0.0
    return x if fmt is None else np.array(jposit.pack(jnp.asarray(x), fmt))


@pytest.mark.parametrize("fmt_a", [None, "P13_2", "P8_2"])
def test_occupied_rows_plain_matches_numpy(fmt_a):
    """The plain statement of K9's pre-pass: one past the last row holding
    a non-zero activation, whatever lies before it (a zero row inside the
    occupied span counts as occupied; -0.0 counts as zero, nan as not)."""
    rng = np.random.default_rng(17)
    E, M, K = 9, 8, 33
    occ = rng.integers(0, M + 1, E)
    occ[0], occ[1] = 0, M
    a = _routed_buffer(rng, E, M, K, occ, _fmt(fmt_a)[0] if fmt_a else None)
    if fmt_a is None:
        a[2, :] = 0.0
        a[2, 1, 3] = -0.0
        a[2, 2, 5] = np.nan           # row 2 holds a nan: occupied to 3
        a[3, 1] = 0.0                 # a zero row inside the span
    want = np.array([max([m + 1 for m in range(M) if np.any(a[e, m] != 0)],
                         default=0) for e in range(E)], np.int32)
    got = tpm.occupied_rows_plain(torch.from_numpy(a),
                                  _fmt(fmt_a)[1] if fmt_a else None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if fmt_a is None:
        assert want[2] == 3


@pytest.mark.parametrize("fmt_out", [None, "P16_2"])
@pytest.mark.parametrize("fmt_a", [None, "P13_2"])
def test_grouped_plain_with_empty_experts_matches_reference(fmt_a, fmt_out):
    """K9's plain version over a routed buffer (experts with 0..3 occupied
    rows of 8, the rest zeros, two experts empty) against the reference's
    grouped kernel in interpret mode: the same values, every empty row
    exactly zero on both sides (what the card kernel writes for the rows
    it skips)."""
    rng = np.random.default_rng(23)
    E, M, K, N = 6, 8, 67, 19
    occ = np.array([0, 1, 3, 0, 2, 3])
    jfa, tfa = _fmt(fmt_a) if fmt_a else (None, None)
    jfo, tfo = _fmt(fmt_out) if fmt_out else (None, None)
    a = _routed_buffer(rng, E, M, K, occ, jfa)
    b = _codes(rng, (E, K, N), jformats.P16_2, 1 / np.sqrt(K))
    want = np.asarray(jpm.posit_matmul_grouped(
        jnp.asarray(a), jnp.asarray(b), jfa, jformats.P16_2, jfo,
        interpret=True))
    got = tpm.posit_matmul_grouped(torch.from_numpy(a), torch.from_numpy(b),
                                   tfa, tformats.P16_2, tfo).numpy()
    assert got.dtype == want.dtype
    rows = tpm.occupied_rows_plain(torch.from_numpy(a), tfa).numpy()
    np.testing.assert_array_equal(rows, occ)
    for e, n in enumerate(occ):
        assert not got[e, n:].any() and not want[e, n:].any()
    if fmt_out is None:
        bound = sum_bound(torch.from_numpy(a), torch.from_numpy(b), tfa,
                          tformats.P16_2).numpy()
        assert np.all(np.abs(got - want) <= bound)
    else:
        diff = got.astype(np.int64) - want.astype(np.int64)
        assert np.abs(diff).max() <= 1
