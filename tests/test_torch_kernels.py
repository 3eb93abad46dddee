"""PyTorch port vs the JAX reference: the kernel entry points of
`kernels/ops.py` and the execution-plan dispatch.

The port runs each kernel's plain version (CPU tensors); the reference
runs its Pallas kernels in interpret mode.  Same numpy inputs, seeded.

Tolerances: attention outputs and GEMM results are f32 sums in another
order (XLA einsum/dot vs PyTorch), held to rtol = atol = 1e-5.  The
partials' running max m is an exact max of identical scores up to that
order, held to the same tolerance.  Sampled tokens are held equal; the
noise is the same numpy array on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import posit as jposit
from repro.core.quant import QuantPolicy as JPolicy
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops

from repro_torch.core import formats as tformats
from repro_torch.core.quant import QuantPolicy as TPolicy
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops

RTOL = ATOL = 1e-5
_FMT = {None: (None, None), "P8_2": (jformats.P8_2, tformats.P8_2),
        "P16_1": (jformats.P16_1, tformats.P16_1),
        "P16_2": (jformats.P16_2, tformats.P16_2)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pages(rng, fmt, P, ps, F):
    kv = rng.normal(0, 1, (2, P, ps, F)).astype(np.float32)
    jf, _ = _FMT[fmt]
    if jf is None:
        return kv[0], kv[1]
    return (np.asarray(jposit.pack(jnp.asarray(kv[0]), jf)),
            np.asarray(jposit.pack(jnp.asarray(kv[1]), jf)))


CASES = {
    # name: (fmt, lengths, window, softcap, page_ok, partials)
    "p8_2": ("P8_2", [5, 12, 1, 9], 1 << 30, 0.0, False, False),
    "p16_1": ("P16_1", [16, 3, 11, 7], 1 << 30, 0.0, False, False),
    "float_pages": (None, [4, 12, 9, 1], 1 << 30, 0.0, False, False),
    "window_softcap": ("P8_2", [13, 7, 12, 5], 3, 4.0, False, False),
    "page_ok_partials": ("P8_2", [12, 9, 5, 11], 1 << 30, 0.0, True, True),
    "zero_length_slot": ("P8_2", [0, 6, 12, 3], 1 << 30, 0.0, False, False),
    "zero_length_partials": ("P16_1", [0, 6, 12, 3], 5, 2.0, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_attention_matches_reference(case):
    fmt, lengths, window, cap, use_ok, partials = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    B, Hq, Hkv, Dh, ps, M, P = 4, 4, 2, 8, 4, 3, 14
    q = rng.normal(0, 1, (B, Hq, Dh)).astype(np.float32)
    kp, vp = _pages(rng, fmt, P, ps, Hkv * Dh)
    bt = (rng.permutation(P - 1)[:B * M].reshape(B, M) + 1).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    win = np.array([window], np.int32)
    ok = (rng.random((B, M)) > 0.3).astype(np.int32) if use_ok else None
    jf, tf = _FMT[fmt]
    want = jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln), jnp.asarray(win), fmt_kv=jf, softcap_val=cap,
        page_ok=None if ok is None else jnp.asarray(ok), partials=partials)
    got = tops.paged_attention(
        _t(q), _t(kp), _t(vp), _t(bt), _t(ln), _t(win), fmt_kv=tf,
        softcap_val=cap, page_ok=None if ok is None else _t(ok),
        partials=partials)
    if not partials:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    if 0 in lengths:
        b = lengths.index(0)
        np.testing.assert_array_equal(got[0].numpy()[b], 0.0)


def test_paged_attention_4d_query_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.paged_attention(torch.zeros(1, 2, 2, 8), torch.zeros(3, 4, 8),
                             torch.zeros(3, 4, 8),
                             torch.ones(1, 1, dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("fmt", ["P16_2", "P8_2"])
def test_matmul_posit_weights_matches_reference(fmt):
    rng = np.random.default_rng(7)
    jf, tf = _FMT[fmt]
    x = rng.normal(0, 1, (6, 96)).astype(np.float32)
    w = np.asarray(jposit.pack(jnp.asarray(
        rng.normal(0, 0.1, (96, 40)).astype(np.float32)), jf))
    want = np.asarray(jops.matmul_posit_weights(jnp.asarray(x),
                                                jnp.asarray(w), jf))
    got = tops.matmul_posit_weights(_t(x), _t(w), tf).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _head_inputs(rng, plan, transpose, packed, dtype):
    B, D, V = 3, 48, 97
    x = rng.normal(0, 1, (B, D)).astype(np.float32)
    w = rng.normal(0, 0.3, (V, D) if transpose else (D, V)).astype(np.float32)
    noise = rng.gumbel(size=(B, V)).astype(np.float32)
    if packed:
        w = np.asarray(jposit.pack(jnp.asarray(w), jformats.P16_2))
    return x, w, noise


HEAD_CASES = [(plan, transpose, packed, greedy, top_k)
              for plan in ("fused", "fake_quant")
              for transpose in (True, False)
              for packed in (True, False)
              for greedy, top_k in ((True, 0), (False, 0), (False, 7))
              if plan == "fake_quant" or packed]


@pytest.mark.parametrize("plan,transpose,packed,greedy,top_k", HEAD_CASES)
def test_decode_sample_tokens_equal(plan, transpose, packed, greedy, top_k):
    rng = np.random.default_rng(HEAD_CASES.index(
        (plan, transpose, packed, greedy, top_k)))
    x, w, noise = _head_inputs(rng, plan, transpose, packed, np.float32)
    jf = jformats.P16_2 if packed else None
    tf = tformats.P16_2 if packed else None
    kw = dict(plan=plan, transpose=transpose, greedy=greedy, top_k=top_k,
              softcap_val=5.0)
    want = np.asarray(jops.decode_sample(
        jnp.asarray(x), jnp.asarray(w), None if greedy else jnp.asarray(noise),
        jnp.float32(0.8), fmt_w=jf, **kw))
    got = tops.decode_sample(_t(x), _t(w), None if greedy else _t(noise), 0.8,
                             fmt_w=tf, **kw).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_decode_sample_topk_ties_keep_multiset_threshold():
    """Repeated logits: the threshold is sort(l)[..., -k] (multiset), so
    every tied copy of the k-th value stays in the filter."""
    l = np.array([[3.0, 1.0, 3.0, 2.0, 3.0, 0.5]], np.float32)
    x = np.ones((1, 6), np.float32)  # x @ w = w[0] = l
    w = np.zeros((6, 6), np.float32)
    w[0] = l[0]
    noise = np.array([[0.0, 0.0, 0.1, 0.0, 0.2, 9.0]], np.float32)
    for k in (1, 2, 3, 4):
        want = np.asarray(jops.decode_sample(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(noise),
            jnp.float32(1.0), plan="fake_quant", top_k=k))
        got = tops.decode_sample(_t(x), _t(w), _t(noise), 1.0,
                                 plan="fake_quant", top_k=k).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plan", ["fake_quant", "fused"])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdot_matches_reference(plan, packed, dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 3, 40)).astype(np.float32)
    w = rng.normal(0, 0.2, (40, 24)).astype(np.float32)
    jp = JPolicy(weights=jformats.P16_2, execution=plan)
    tp = TPolicy(weights=tformats.P16_2, execution=plan)
    jw = jnp.asarray(w)
    if packed:
        jw = jposit.pack(jw, jformats.P16_2)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    want = np.asarray(jdispatch.qdot(jx, jw, jp).astype(jnp.float32))
    got = tdispatch.qdot(tx, _t(np.asarray(jw)), tp)
    assert got.dtype == tx.dtype
    tol = RTOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=tol, atol=tol)


def test_dispatch_unported_paths_raise():
    x, w = torch.zeros(2, 8), torch.zeros(8, 4, dtype=torch.int16)
    coded = TPolicy(weights=tformats.P16_2, activations=tformats.P13_2,
                    execution="fused")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdispatch.qdot(x, w, coded)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdispatch.qdot(x, w, TPolicy(weights=tformats.P13_2,
                                     execution="bit_exact"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdispatch.qdot_grouped(x[None], w[None], coded)
    assert tdispatch.is_packed(w) and not tdispatch.is_packed(x)


def test_degrade_tile_matches_reference():
    for n in (1, 2, 7, 12, 97, 256000):
        for cap in (None, 1, 2, 3, 8, 64, 1000):
            assert tops._degrade_tile(n, cap) == jops._degrade_tile(n, cap)
            if cap is not None:
                assert tops._largest_divisor(n, cap) == \
                    jops._largest_divisor(n, cap)
