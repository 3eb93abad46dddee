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
from repro_torch.core import posit as tposit
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
    # The 4-D (multi-query) form is ported now (tests/test_torch_paged_mq.py
    # holds it against the reference); what stays unsupported raises: a
    # t_block that does not divide T, and a q of another rank.
    args = (torch.zeros(3, 4, 8), torch.zeros(3, 4, 8),
            torch.ones(1, 1, dtype=torch.int32),
            torch.full((1,), 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    out = tops.paged_attention(torch.zeros(1, 2, 2, 8), *args)
    assert out.shape == (1, 2, 2, 8) and bool((out == 0).all())
    with pytest.raises(ValueError, match="must divide T"):
        tops.paged_attention(torch.zeros(1, 3, 2, 8), *args, t_block=2)
    with pytest.raises(ValueError, match="q must be"):
        tops.paged_attention(torch.zeros(2, 8), *args)


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


# (M, layout): decode rows (the float GEMV's on the card) and prefill rows
# (K1 + torch.matmul), over [K, N] codes and over the transpose of [N, K]
# codes (the tied head)
FLOAT_PATH = [(4, "kn"), (16, "kn"), (4, "t"), (16, "t")]


@pytest.fixture(scope="module")
def float_path_inputs():
    """x [16, 64] f32 and P(16,2) codes of a [64, 503] weight stored both
    ways (numpy), shared by the float weight path's tests, which run their
    torch work on one thread (at these sizes torch's pool only waits on
    the cores the suite's other workers hold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (16, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, (503, 64)).astype(np.float32)
    codes = np.asarray(jposit.pack(jnp.asarray(w), jformats.P16_2))
    yield x, {"kn": np.ascontiguousarray(codes.T), "t": codes}
    torch.set_num_threads(threads)


def _float_path_operands(float_path_inputs, M, layout):
    """(jax x, jax weight [K, N], torch x, torch weight [K, N]): the "t"
    weights are the transpose of contiguous [N, K] codes on both sides."""
    x, codes = float_path_inputs
    c = codes[layout]
    jw = jnp.asarray(c).T if layout == "t" else jnp.asarray(c)
    tw = torch.from_numpy(c).T if layout == "t" else torch.from_numpy(c)
    return jnp.asarray(x[:M]), jw, torch.from_numpy(x[:M]), tw


@pytest.mark.parametrize("M,layout", FLOAT_PATH)
def test_float_weight_path_bitwise_reference(float_path_inputs, M, layout):
    """`ops.matmul_posit_weights` and `qdot` under the fused plan with
    float activations (packed weights) on the CPU: bitwise the reference's
    `ops.matmul_posit_weights` / `dispatch.qdot` at decode and prefill
    rows and over the transposed head (the plain version of the float
    GEMV is the decode and the same f32 matmul)."""
    jx, jw, tx, tw = _float_path_operands(float_path_inputs, M, layout)
    want = np.asarray(jops.matmul_posit_weights(jx, jw, jformats.P16_2))
    got = tops.matmul_posit_weights(tx, tw, tformats.P16_2).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    jp = JPolicy(weights=jformats.P16_2, execution="fused")
    tp = TPolicy(weights=tformats.P16_2, execution="fused")
    want = np.asarray(jdispatch.qdot(jx, jw, jp))
    got = tdispatch.qdot(tx, tw, tp).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not any(tops.launch_counts().values())


@pytest.mark.parametrize("M,layout", FLOAT_PATH)
def test_prepared_float_weights_equal_separate_calls(float_path_inputs, M,
                                                     layout, monkeypatch):
    """Under the fused plan with float activations a `Prepared` weight's
    operand is the codes themselves, and each qdot over it gives, bitwise,
    what a separate call gives; on the CPU (as on the card above 8 rows)
    its f32 decode is made once, by the first call that reads it."""
    _, _, tx, tw = _float_path_operands(float_path_inputs, M, layout)
    tp = TPolicy(weights=tformats.P16_2, execution="fused")
    xs = [tx.to(torch.bfloat16), tx, tx.to(torch.bfloat16)]
    want = [tdispatch.qdot(x, tw, tp) for x in xs]
    decodes = []
    real = tops.decode
    monkeypatch.setattr(tops, "decode",
                        lambda *a, **k: decodes.append(1) or real(*a, **k))
    prep = tdispatch.Prepared(tw)
    assert prep.operand(tp, torch.bfloat16) is tw
    for x, h in zip(xs, want):
        assert torch.equal(tdispatch.qdot(x, prep, tp), h)
    # one decode per activation dtype (the operand key), none per call
    assert len(decodes) == 2


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


@pytest.mark.parametrize("dtype,fmt,want", [
    (torch.int16, "P16_2", "p16_2"),
    (torch.int16, "P16_1", "posit"),
    (torch.int8, "P8_2", "posit"),
    (torch.float32, None, "f32"),
    (torch.bfloat16, None, "bf16"),
])
def test_sample_variant_by_head_weights(dtype, fmt, want):
    """K4's wrapper picks its pass-1 kernel by the head's weights alone:
    the compile-time P(16,2) decode for int16 P(16,2) codes (every serving
    head), the run-time decode for other codes, float weights as read;
    codes without a format and other dtypes raise."""
    from repro_torch.kernels import paged_attention as tpa
    tf = getattr(tformats, fmt) if fmt else None
    assert tpa.sample_variant(dtype, tf) == want
    if fmt:
        with pytest.raises(ValueError):
            tpa.sample_variant(dtype, None)
    with pytest.raises(TypeError):
        tpa.sample_variant(torch.int32, tf)


@pytest.mark.parametrize("transpose", [True, False])
def test_decode_sample_17_rows_equal_reference(transpose):
    """17 batch rows (two passes of 16 rows on the card) through the port
    and the reference: equal tokens, greedy and with top-k."""
    rng = np.random.default_rng(71)
    B, D, V = 17, 48, 97
    x = rng.normal(0, 1, (B, D)).astype(np.float32)
    w = np.asarray(jposit.pack(jnp.asarray(rng.normal(
        0, 0.3, (V, D) if transpose else (D, V)).astype(np.float32)),
        jformats.P16_2))
    noise = rng.gumbel(size=(B, V)).astype(np.float32)
    for greedy, top_k in ((True, 0), (False, 7)):
        kw = dict(plan="fused", transpose=transpose, greedy=greedy,
                  top_k=top_k, softcap_val=5.0)
        want = np.asarray(jops.decode_sample(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(noise),
            jnp.float32(0.8), fmt_w=jformats.P16_2, **kw))
        got = tops.decode_sample(_t(x), _t(w), _t(noise), 0.8,
                                 fmt_w=tformats.P16_2, **kw).numpy()
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
    """bit_exact qdot and qdot_grouped are ported (tests/test_torch_pdpu.py
    holds them against the reference): on the CPU both run their plain
    versions; an unknown plan and malformed grouped operands raise."""
    x, w = torch.zeros(2, 8), torch.zeros(8, 4, dtype=torch.int16)
    coded = TPolicy(weights=tformats.P16_2, activations=tformats.P13_2,
                    execution="fused")
    out = tdispatch.qdot(x, w.to(torch.int16), TPolicy(weights=tformats.P13_2,
                                                       execution="bit_exact"))
    assert out.shape == (2, 4) and not out.any()
    assert tdispatch.qdot_grouped(x[None], w[None], coded).shape == (1, 2, 4)
    with pytest.raises(ValueError, match="unknown execution plan"):
        tdispatch.qdot(x, w, TPolicy(weights=tformats.P16_2,
                                     execution="no_such_plan"))
    with pytest.raises(ValueError, match="3-D"):
        tdispatch.qdot_grouped(x[None], w, coded)
    assert tdispatch.is_packed(w) and not tdispatch.is_packed(x)


def test_degrade_tile_matches_reference():
    for n in (1, 2, 7, 12, 97, 256000):
        for cap in (None, 1, 2, 3, 8, 64, 1000):
            assert tops._degrade_tile(n, cap) == jops._degrade_tile(n, cap)
            if cap is not None:
                assert tops._largest_divisor(n, cap) == \
                    jops._largest_divisor(n, cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["P16_2", "P8_2", "P13_2"])
def test_draft_fake_quant_equals_reference_quantize(fmt, dtype):
    """The fake_quant plan's weight/activation rounding: on the CPU the
    plain codec (no kernel launch), bitwise the reference's
    posit.quantize, with an identity straight-through gradient."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (64, 48)).astype(np.float32)
    x[0, :4] = [0.0, 1e-30, 3e30, -7.5]
    jf = getattr(jformats, fmt)
    tf = getattr(tformats, fmt)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jposit.quantize(jnp.asarray(x).astype(jd), jf)
                      .astype(jnp.float32))
    tops.reset_launches()
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    got = tdispatch.maybe_quant_weight(TPolicy(weights=tf), xt)
    assert got.dtype == td
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
    assert torch.equal(got.detach(), tposit.quantize(xt.detach(), tf))
    assert torch.equal(tdispatch.fake_quantize(xt.detach(), tf),
                       got.detach())
    assert not any(tops.launch_counts().values())
    got.float().sum().backward()
    assert torch.equal(xt.grad, torch.ones_like(xt))


@pytest.mark.parametrize("policy", [
    dict(execution="fake_quant", packed=False),
    dict(execution="fake_quant", packed=True),
    dict(execution="fused", packed=False),
    dict(execution="fused", packed=True),
    dict(execution="fused", packed=True, activations=tformats.P13_2)])
def test_prepared_weight_qdot_bitwise_and_decoded_once(policy, monkeypatch):
    """A `Prepared` weight read by several qdot calls (the speculative
    verify's tokens) gives each call's raw result bitwise, and its plan
    operand is made once."""
    policy = dict(policy)
    packed = policy.pop("packed")
    tp = TPolicy(weights=tformats.P16_2, **policy)
    rng = np.random.default_rng(5)
    w = _t(rng.normal(0, 0.2, (40, 24)).astype(np.float32))
    if packed:
        w = tops.encode(w, tformats.P16_2)
    xs = [_t(rng.normal(0, 1, (3, 1, 40)).astype(np.float32))
          .to(torch.bfloat16) for _ in range(4)]
    want = [tdispatch.qdot(x, w, tp) for x in xs]
    calls = {"encode": 0, "decode": 0}
    for name in calls:
        def counted(*a, _f=getattr(tops, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tops, name, counted)
    prep = tdispatch.Prepared(w)
    got = [tdispatch.qdot(x, prep, tp) for x in xs]
    for g, h in zip(got, want):
        assert torch.equal(g, h)
    # the weight operand's codec calls happen once (the a13 plan also
    # encodes each call's activations)
    per_call = 1 if tp.activations is not None else 0
    once = {"fake_quant": (1 - packed, 1), "fused": (1 - packed, 0)}
    enc, dec = once[tp.execution]
    if tp.execution == "fused" and tp.activations is None:
        dec = 1
    assert calls == {"encode": enc + per_call * len(xs), "decode": dec}
