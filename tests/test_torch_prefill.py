"""PyTorch port vs the JAX reference: the fused prefill attention that
writes posit KV pages (K5), `paged.fork_page`, and the model's fused
prefill branch.

The reference runs its Pallas kernel in interpret mode; the port runs the
kernel's plain version (the decomposed stages op for op) on the same
numpy inputs.  Geometries follow `tests/test_prefill_fused.py:_CASES`
plus the full-width dtype chain (bf16 activations, P(8,2) pages) and the
streaming branch (a span past the flash chunk, flash_chunk 16).

Tolerances: page contents are held bitwise (page 0, the trash page that
unowned writes land on, excluded).  Attention is f32 sums taken in
another order by XLA and PyTorch, with other exp / tanh implementations:
f32 outputs within rtol 5e-5 and an absolute 5e-5 of the case's largest
|output| (random posit codes decode to values up to 2^28, so the sums
cancel); bf16 outputs within one bf16 ulp (rtol 2^-7).  Several cases are
bitwise; none is required to be.  The port's own fused and decomposed
model branches are held bitwise.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.formats import P8_2 as JP8_2, P16_1 as JP16_1
from repro.core.quant import policy_by_name as jpolicy
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import paged as jpaged

from repro_torch import configs as tconfigs
from repro_torch.core.formats import P8_2 as TP8_2, P16_1 as TP16_1
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import packing as tpacking
from repro_torch.models import paged as tpaged

FMTS = {"p16_1": (JP16_1, TP16_1), "p8_2": (JP8_2, TP8_2), None: (None, None)}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# name: (fmt, compute dtype, activation dtype, C, window, softcap, starts,
#        flash_chunk, per_slot)
CASES = {
    "coded_start0": ("p16_1", "f32", "f32", 8, None, 0.0, [0], 1024, False),
    "coded_mixed_midpage_starts":
        ("p16_1", "f32", "f32", 8, None, 0.0, [0, 5, 13], 1024, False),
    "window_plus_softcap": ("p16_1", "f32", "f32", 8, 7, 30.0, [4, 9], 1024,
                            False),
    "f32_pool": (None, "f32", "f32", 8, None, 0.0, [3, 0], 1024, False),
    "bf16_compute": ("p16_1", "bf16", "f32", 8, None, 0.0, [2, 7], 1024,
                     False),
    "bf16_activations_p8": ("p8_2", "bf16", "bf16", 8, None, 0.0, [2, 7],
                            1024, False),
    "p8_kv": ("p8_2", "f32", "f32", 8, None, 0.0, [1, 6], 1024, False),
    "single_token_chunk": ("p16_1", "f32", "f32", 1, None, 0.0, [7, 0], 1024,
                           False),
    "per_slot_eq_batched": ("p16_1", "f32", "f32", 8, None, 0.0, [0, 5], 1024,
                            True),
    "streaming_p16": ("p16_1", "f32", "f32", 8, None, 0.0, [9, 17], 16,
                      False),
    "streaming_bf16_window_softcap":
        ("p8_2", "bf16", "bf16", 8, 5, 10.0, [12, 3], 16, False),
}
HQ, HKV, DH, PS, M = 4, 2, 8, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these sizes are too small to share out: with
    the suite's other workers busy, torch's thread pool waits on taken
    cores.  Run this module's torch work on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pool(rng, fmt, shape):
    """A recycled pool: valid posit codes (NaR excluded) or floats."""
    if fmt is None:
        return rng.normal(0, 1, shape).astype(np.float32)
    jf = FMTS[fmt][0]
    raw = rng.integers(0, 1 << jf.n, shape)
    raw = np.where(raw == jf.nar_code, 0, raw)
    w = jf.storage_bits
    half = 1 << (w - 1)
    return (((raw + half) & ((1 << w) - 1)) - half).astype(
        np.int8 if w == 8 else np.int16)


def _inputs(seed, fmt, C, starts):
    rng = np.random.default_rng(seed)
    B = len(starts)
    F = HKV * DH
    n_pages = 1 + B * M
    pk = _pool(rng, fmt, (n_pages, PS, F))
    pv = _pool(rng, fmt, (n_pages, PS, F))
    bt = np.zeros((B, M), np.int32)
    for b in range(B):
        alloc = -(-(starts[b] + C) // PS)
        bt[b, :alloc] = 1 + b * M + np.arange(alloc)
    q = rng.normal(0, 1, (B, C, HQ, DH)).astype(np.float32)
    k = rng.normal(0, 1, (B, C, HKV, DH)).astype(np.float32)
    v = rng.normal(0, 1, (B, C, HKV, DH)).astype(np.float32)
    return pk, pv, bt, q, k, v


def _pools(pk, pv, fmt, compute):
    jd, td = DT[compute]
    if fmt is None:
        return ((jnp.asarray(pk, jd), jnp.asarray(pv, jd)),
                (torch.from_numpy(pk).to(td), torch.from_numpy(pv).to(td)))
    return ((jnp.asarray(pk), jnp.asarray(pv)),
            (torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if jnp.issubdtype(
        x.dtype, jnp.floating) else np.asarray(x)


def _assert_attn_close(got, want, act):
    got, want = _f32(got), _f32(want)
    assert np.isfinite(got).all()
    if act == "bf16":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-5,
                                   atol=5e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_attention_matches_reference(name):
    fmt, compute, act, C, win, cap, starts, chunk, per_slot = CASES[name]
    pk, pv, bt, q, k, v = _inputs(sorted(CASES).index(name), fmt, C, starts)
    (jpk, jpv), (tpk, tpv) = _pools(pk, pv, fmt, compute)
    jf, tf = FMTS[fmt]
    jcd, tcd = DT[compute]
    jad, tad = DT[act]
    w = np.full((1,), 2 ** 30 if win is None else win, np.int32)
    st = np.asarray(starts, np.int32)
    want_attn, want_k, want_v = jops.prefill_attention_paged(
        jnp.asarray(q, jad), jnp.asarray(k, jad), jnp.asarray(v, jad), jpk,
        jpv, jnp.asarray(bt), jnp.asarray(st), jnp.asarray(w), fmt_kv=jf,
        compute_dtype=jcd, softcap_val=cap, flash_chunk=chunk)
    tq, tk, tv = (torch.from_numpy(a).to(tad) for a in (q, k, v))
    kw = dict(fmt_kv=tf, compute_dtype=tcd, softcap_val=cap, flash_chunk=chunk)
    tw = torch.from_numpy(w)
    if per_slot:
        got_attn = torch.zeros_like(tq)
        for b in range(len(starts)):
            a1, _, _ = tops.prefill_attention_paged(
                tq[b:b + 1], tk[b:b + 1], tv[b:b + 1], tpk, tpv,
                torch.from_numpy(bt[b:b + 1]), torch.from_numpy(st[b:b + 1]),
                tw, **kw)
            got_attn[b] = a1[0]
        got_k, got_v = tpk, tpv
    else:
        got_attn, got_k, got_v = tops.prefill_attention_paged(
            tq, tk, tv, tpk, tpv, torch.from_numpy(bt), torch.from_numpy(st),
            tw, **kw)
    assert got_attn.dtype == tq.dtype and got_k is tpk  # pools in place
    _assert_attn_close(got_attn, want_attn, act)
    np.testing.assert_array_equal(_f32(got_k)[1:], _f32(want_k)[1:])
    np.testing.assert_array_equal(_f32(got_v)[1:], _f32(want_v)[1:])


def test_prefill_page_ok_masks_writes():
    """Pages with page_ok == 0 keep their contents; the other slot's pages
    are written exactly as the reference writes them."""
    starts = [4, 9]
    pk, pv, bt, q, k, v = _inputs(31, "p16_1", 8, starts)
    (jpk, jpv), (tpk, tpv) = _pools(pk, pv, "p16_1", "f32")
    ok = np.zeros_like(bt)
    ok[0] = 1
    w = np.full((1,), 2 ** 30, np.int32)
    st = np.asarray(starts, np.int32)
    want_attn, want_k, want_v = jops.prefill_attention_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpk, jpv,
        jnp.asarray(bt), jnp.asarray(st), jnp.asarray(w), fmt_kv=JP16_1,
        page_ok=jnp.asarray(ok))
    got_attn, got_k, got_v = tops.prefill_attention_paged(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tpk,
        tpv, torch.from_numpy(bt), torch.from_numpy(st), torch.from_numpy(w),
        fmt_kv=TP16_1, page_ok=torch.from_numpy(ok))
    _assert_attn_close(got_attn, want_attn, "f32")
    np.testing.assert_array_equal(got_k.numpy()[1:], np.asarray(want_k)[1:])
    np.testing.assert_array_equal(got_v.numpy()[1:], np.asarray(want_v)[1:])
    other = bt[1][bt[1] > 0]
    np.testing.assert_array_equal(got_k.numpy()[other], pk[other])
    np.testing.assert_array_equal(got_v.numpy()[other], pv[other])
    assert not np.array_equal(got_k.numpy()[bt[0][bt[0] > 0]],
                              pk[bt[0][bt[0] > 0]])


def test_prefill_rejects_page_size_that_cannot_stream():
    """A span past the flash chunk needs page_size | flash_chunk, as in the
    reference."""
    pk, pv, bt, q, k, v = _inputs(5, "p16_1", 8, [0, 5])
    t = torch.from_numpy
    with pytest.raises(ValueError, match="divide"):
        tops.prefill_attention_paged(
            t(q), t(k), t(v), t(pk), t(pv), t(bt),
            torch.tensor([0, 5], dtype=torch.int32),
            torch.tensor([2 ** 30], dtype=torch.int32), fmt_kv=TP16_1,
            flash_chunk=18)


def test_fork_page_matches_reference():
    rng = np.random.default_rng(8)
    pool = rng.integers(-128, 128, (3, 7, 4, 6)).astype(np.int8)
    want = np.asarray(jpaged.fork_page(jnp.asarray(pool), 5, 2))
    got = torch.from_numpy(pool.copy())
    assert tpaged.fork_page(got, 5, 2) is got
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the model's fused branch: bitwise equal to the decomposed branch on the
# CPU, and equal to the reference's fused branch
# ---------------------------------------------------------------------------

def _model_cfgs(policy, fused, kv):
    jq = dataclasses.replace(jpolicy(policy), fused_prefill=fused)
    tq = dataclasses.replace(tpolicy(policy), fused_prefill=fused)
    if kv is not None:
        jq = dataclasses.replace(jq, kv_cache=FMTS[kv][0])
        tq = dataclasses.replace(tq, kv_cache=FMTS[kv][1])
    return (jconfigs.get_tiny_serving("command_r_35b").replace(quant=jq),
            tconfigs.get_tiny_serving("command_r_35b").replace(quant=tq))


def _prefill_twice(cfg, params, max_seq, toks, toks2, bt):
    """Two chunks into a fresh paged cache (the second sees history);
    returns (logits of both, k pool, v pool)."""
    B = toks.shape[0]
    layout = tpaged.PagedLayout.for_slots(B, max_seq, cfg.quant.kv_page_size)
    cache = tapi.init_cache(cfg, B, max_seq, layout, device="cpu")
    cache["block_table"] = torch.from_numpy(bt)
    active = torch.ones(B, dtype=torch.bool)
    l1, cache = tapi.prefill_chunk_batched(params, torch.from_numpy(toks),
                                           cache, active, cfg)
    l2, cache = tapi.prefill_chunk_batched(params, torch.from_numpy(toks2),
                                           cache, active, cfg)
    return l1, l2, cache["k"], cache["v"]


@pytest.mark.parametrize("flash_chunk", [1024, 16])
@pytest.mark.parametrize("kv", ["p8_2", "p16_1"])
def test_model_fused_branch_bitwise_equals_decomposed(flash_chunk, kv,
                                                      monkeypatch):
    monkeypatch.setattr(tpaged, "FLASH_CHUNK", flash_chunk)
    rng = np.random.default_rng(3)
    _, t_fused = _model_cfgs("serve_fused_p16", True, kv)
    _, t_dec = _model_cfgs("serve_fused_p16", False, kv)
    params = tpacking.pack_params(tapi.init(
        torch.Generator().manual_seed(1), t_fused, device="cpu"), t_fused)
    max_seq = 40
    bt = np.array([[3, 1, 0], [2, 6, 5]], np.int32)  # 16-token pages
    toks = rng.integers(0, t_fused.vocab_size, (2, 9)).astype(np.int32)
    toks2 = rng.integers(0, t_fused.vocab_size, (2, 4)).astype(np.int32)
    got = _prefill_twice(t_fused, params, max_seq, toks, toks2, bt)
    want = _prefill_twice(t_dec, params, max_seq, toks, toks2, bt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_model_fused_prefill_matches_reference_fused(monkeypatch):
    """Port and reference with fused prefill on, FLASH_CHUNK 16 on both
    sides so the second chunk streams history: logits within 2e-5, pages
    bitwise."""
    monkeypatch.setattr(tpaged, "FLASH_CHUNK", 16)
    monkeypatch.setattr(jpaged, "FLASH_CHUNK", 16)
    import jax
    jcfg, tcfg = _model_cfgs("serve_fused_p16", True, None)
    jparams = japi.pack_params(japi.init(jax.random.key(4), jcfg), jcfg)
    tparams = tpacking.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         tcfg, "cpu")
    rng = np.random.default_rng(6)
    max_seq = 40
    bt = np.array([[3, 1, 0], [2, 6, 5]], np.int32)  # 16-token pages
    toks = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    toks2 = rng.integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
    got = _prefill_twice(tcfg, tparams, max_seq, toks, toks2, bt)

    B = 2
    layout = jpaged.PagedLayout.for_slots(B, max_seq, jcfg.quant.kv_page_size)
    jc = dict(japi.init_cache(jcfg, B, max_seq, layout),
              block_table=jnp.asarray(bt))
    active = jnp.ones((B,), bool)
    step = jax.jit(lambda p, t, c: japi.prefill_chunk_batched(p, t, c, active,
                                                              jcfg))
    l1, jc = step(jparams, jnp.asarray(toks), jc)
    l2, jc = step(jparams, jnp.asarray(toks2), jc)
    for g, w in zip(got[:2], (l1, l2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jc["k"]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(jc["v"]))


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 16, "tc"), (torch.bfloat16, 72, "simt"),
    (torch.bfloat16, 256, "tc256"), (torch.bfloat16, 144, "tc256"),
    (torch.bfloat16, 136, "simt"), (torch.bfloat16, 272, "simt"),
    (torch.float32, 256, "tc_f32"), (torch.float32, 128, "tc_f32"),
    (torch.float32, 32, "tc_f32"), (torch.float32, 16, "tc_f32"),
    (torch.float32, 72, "simt"), (torch.float32, 40, "simt"),
    (torch.float32, 80, "tc_f32"), (torch.float32, 272, "simt"),
])
def test_prefill_variant_by_dtype_and_head_dim(dtype, head_dim, want):
    """K5's wrapper picks its kernel by the activations' dtype and the head
    dim alone: tensor cores for head_dim a multiple of 16 up to 256 (bf16:
    `tc` up to 128, `tc256` above; f32: `tc_f32`), the SIMT kernel for
    other head dims."""
    from repro_torch.kernels import prefill_attention as tpf
    assert tpf.prefill_variant(dtype, head_dim) == want


@pytest.mark.parametrize("name,want", [
    ("command_r_35b", "tc"), ("qwen3_moe_235b", "tc"),
    ("deepseek_moe_16b", "tc"), ("command_r_plus_104b", "tc"),
    ("gemma3_4b", "tc256"),
])
def test_serving_configs_take_tensor_core_prefill(name, want):
    """Every serving config of the port at full width (bf16 activations)
    prefills on a tensor-core K5 variant: `tc` at head_dim 128, `tc256` at
    gemma3's 256; the f32 smoke configs (head_dim 16) and each config run
    with f32 activations take `tc_f32`."""
    from repro_torch.kernels import prefill_attention as tpf
    cfg, smoke = tconfigs.get(name), tconfigs.get_smoke(name)
    assert tpf.prefill_variant(cfg.compute_dtype, cfg.head_dim) == want
    assert tpf.prefill_variant(smoke.compute_dtype, smoke.head_dim) == \
        "tc_f32"
    assert tpf.prefill_variant(torch.float32, cfg.head_dim) == "tc_f32"


def test_tc_span_rows_cover_history_and_chunk():
    from repro_torch.kernels import prefill_attention as tpf
    assert tpf.tc_span_rows(16, 16, 64) == 320
    assert tpf.tc_span_rows(128, 16, 64) == 2112
    assert tpf.tc_span_rows(10, 8, 7) == 128
    assert tpf.tc_span_rows(0, 16, 1) == tpf.TC_KEYS


def test_tc256_geometry_from_shapes():
    """The tc256 kernel's splits come from (M, page size, C) alone: 4 key
    tiles of 64 a split, at most 32 splits; gemma3's chunk group (4 slots,
    C 64, 8 / 4 heads, max_seq 2048) fills 132 SMs; and a block's shared
    memory fits 227 KB at every head dim the variant takes."""
    from repro_torch.kernels import prefill_attention as tpf
    assert tpf.tc256_splits(128, 16, 64) == 9       # 33 tiles
    assert tpf.tc256_splits(16, 16, 64) == 2        # 5 tiles
    assert tpf.tc256_splits(0, 16, 1) == 1
    assert tpf.tc256_splits(8, 16, 64) == 1         # 3 tiles
    assert tpf.tc256_splits(8192, 16, 64) == 32     # 2049 tiles, 65 a split
    for M, ps, C in ((1, 16, 1), (96, 16, 64), (4096, 16, 7), (3, 128, 33)):
        S = tpf.tc256_splits(M, ps, C)
        tiles = tpf.tc_span_rows(M, ps, C) // tpf.TC_KEYS
        per_split = -(-tiles // S)
        assert 1 <= S <= tpf.TC256_MAX_SPLITS
        assert per_split >= tpf.TC256_SPLIT_TILES or S == 1
        assert (S - 1) * per_split < tiles <= S * per_split
    B, C, Hq, Hkv, M = 4, 64, 8, 4, 128
    row_tiles = -(-(Hq // Hkv) * C // 64)
    assert tpf.tc256_splits(M, 16, C) * row_tiles * Hkv * B >= 132
    dims = [d for d in range(16, 513, 8)
            if tpf.prefill_variant(torch.bfloat16, d) == "tc256"]
    assert dims == list(range(144, 257, 16))
    assert all(tpf.tc256_smem_bytes(d) <= tpf.BLOCK_SMEM for d in dims)
    assert tpf.tc256_smem_bytes(256) == 101376
    assert 2 * (tpf.tc256_smem_bytes(256) + 1024) <= 228 * 1024


def _bf16_round(x):
    return x.to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize("what", ["q_scaled", "p", "f32"])
def test_three_term_bf16_split_is_exact(what):
    """The tensor-core K5 variants' argument: an f32 x (q * scale from bf16
    q, p = exp(s - m) in (0, 1], or any f32 value: tc_f32's q, k and v)
    splits into hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
    with x = hi + mid + lo exactly, and each term times a bf16 value is
    exact in f32, so three bf16 MMAs sum the same exact products as the f32
    plain version.  Below 2^-110, where lo (or a product) would be an f32
    subnormal, the split and the products lose at most 2^-126."""
    g = torch.Generator().manual_seed(11)
    if what == "q_scaled":
        x = _bf16_round(torch.randn(1 << 16, generator=g) * 3) \
            * (1.0 / math.sqrt(128))
    elif what == "p":
        x = torch.exp(-torch.rand(1 << 16, generator=g) * 100)
    else:
        x = torch.randn(1 << 16, generator=g) * 2.0 ** torch.randint(
            -60, 60, (1 << 16,), generator=g)
    hi = _bf16_round(x)
    mid = _bf16_round(x - hi)
    lo = _bf16_round(x - hi - mid)
    gap = (hi.double() + mid.double() + lo.double() - x.double()).abs()
    assert bool((gap[x.abs() >= 2.0 ** -110] == 0).all())
    assert bool((gap <= 2.0 ** -126).all())
    k = _bf16_round(torch.randn(1 << 16, generator=g))
    normal = x.abs() >= 2.0 ** -110
    for t in (hi, mid, lo):
        prod_gap = ((t * k).double() - t.double() * k.double()).abs()
        assert bool((prod_gap[normal] == 0).all())
        assert bool((prod_gap <= 2.0 ** -126).all())


# ---------------------------------------------------------------------------
# tc_f32: the f32 variant's term counts, geometry, launch keys and work
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pages,fmt,hist_bf16,want", [
    (torch.int8, "P8_2", False, 1), (torch.int8, "P8_0", False, 1),
    (torch.int16, "P10_2", False, 1), (torch.int16, "P13_2", False, 2),
    (torch.int16, "P16_1", False, 2), (torch.int16, "P16_2", False, 2),
    (torch.int16, "P16_2", True, 1), (torch.float32, None, False, 3),
    (torch.bfloat16, None, False, 1)])
def test_prefill_kv_terms_by_page_format(pages, fmt, hist_bf16, want):
    """tc_f32 runs a history tile against as many bf16 terms of its keys
    and values as the page format needs: the decoded value of every code
    of the format is exactly the sum of that many terms, and not of fewer
    (the widest significand needs them all)."""
    from repro_torch.core import formats as tformats
    from repro_torch.core import posit as tposit
    from repro_torch.kernels import prefill_attention as tpf
    f = getattr(tformats, fmt) if fmt else None
    assert tpf.prefill_kv_terms(pages, f, hist_bf16) == want
    if f is None or hist_bf16:
        return
    codes = torch.arange(1 << f.n, dtype=torch.int64)
    x = tposit.decode(codes, f)
    x = x[torch.isfinite(x)]
    rest, terms = x.clone(), []
    for _ in range(want):
        terms.append(_bf16_round(rest))
        rest = rest - terms[-1]
    assert bool((rest == 0).all())
    assert want == 1 or bool((x - _bf16_round(x) - _bf16_round(
        x - _bf16_round(x)) * (want > 2) != 0).any())


def test_tc_f32_geometry_from_shapes():
    """tc_f32 keeps tc's one pass over the span up to head_dim 128 and
    takes tc256's key splits above it; its blocks fit 227 KB (two an SM at
    head_dim 128)."""
    from repro_torch.kernels import prefill_attention as tpf
    assert tpf.tc_f32_splits(128, 16, 64, 128) == 1
    assert tpf.tc_f32_splits(128, 16, 64, 256) == tpf.tc256_splits(
        128, 16, 64) == 9
    dims = [d for d in range(8, 513, 8)
            if tpf.prefill_variant(torch.float32, d) == "tc_f32"]
    assert dims == list(range(16, 257, 16))
    assert all(tpf.tc_f32_smem_bytes(d) <= tpf.BLOCK_SMEM for d in dims)
    assert tpf.tc_f32_smem_bytes(128) == 69632
    assert 2 * (tpf.tc_f32_smem_bytes(128) + 1024) <= 228 * 1024
    assert tpf.tc_f32_smem_bytes(256) == 168960


def _meta_prefill(act, Dh, pages, fmt, compute, M=8, C=64, B=2, Hq=8,
                  Hkv=2, ps=16):
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.kernels import prefill_attention as tpf
    meta = torch.device("meta")
    q = torch.empty(B, C, Hq, Dh, dtype=act, device=meta)
    k = torch.empty(B, C, Hkv, Dh, dtype=act, device=meta)
    kp = torch.empty(B * M + 1, ps, Hkv * Dh, dtype=pages, device=meta)
    bt = torch.empty(B, M, dtype=torch.int32, device=meta)
    st = torch.empty(B, dtype=torch.int32, device=meta)
    win = torch.empty(1, dtype=torch.int32, device=meta)
    return analyze_step(lambda *a: tpf.prefill_attention_paged(
        *a, fmt_kv=fmt, compute_dtype=compute), q, k, k.clone(), kp,
        kp.clone(), bt, st, win)


@pytest.mark.parametrize("act,Dh,pages,fmt,want", [
    (torch.float32, 128, torch.int8, "P8_2", "tc_f32"),
    (torch.float32, 256, torch.int16, "P16_2", "tc_f32"),
    (torch.float32, 64, torch.float32, None, "tc_f32"),
    (torch.float32, 72, torch.int8, "P8_2", "simt"),
    (torch.bfloat16, 128, torch.int8, "P8_2", "tc")])
def test_meta_route_counts_the_variant_and_its_work(act, Dh, pages, fmt,
                                                    want):
    """On meta tensors the wrapper records the launch it would make under
    its variant's key and the exact form's operations: tc_f32 3 x 3 bf16
    products a multiply-add of a chunk key and 3 x `prefill_kv_terms` of a
    history key, q.k and p.v alike; SIMT f32 FMA."""
    from repro_torch.core import formats as tformats
    from repro_torch.kernels import prefill_attention as tpf
    from repro_torch.kernels import work
    f = getattr(tformats, fmt) if fmt else None
    compute = act if fmt is None else torch.float32
    rec = _meta_prefill(act, Dh, pages, f, compute)
    assert rec["launches"] == {"prefill_attention": 1,
                               f"prefill_attention:{want}": 1}
    B, C, Hq, M, ps = 2, 64, 8, 8, 16
    pairs, chunk = B * C * (M * ps + C), B * C * C
    terms = tpf.prefill_kv_terms(pages, f, act == torch.bfloat16)
    if want == "tc_f32":
        ops = 2.0 * Hq * Dh * 2 * 3 * (3 * chunk + terms * (pairs - chunk))
        assert rec["ops_by_rate"] == {"bf16": ops}
        # a history key of one term costs what tc's q.k + p.v cost (3 + 3)
        assert work.prefill(B, C, Hq, 2, Dh, 4, 1, 0, 0, pairs, "tc_f32",
                            chunk_pairs=0, kv_terms=1).ops == work.prefill(
            B, C, Hq, 2, Dh, 2, 1, 0, 0, pairs, "tc").ops
    elif want == "simt":
        assert rec["ops_by_rate"] == {"f32": 4.0 * pairs * Hq * Dh}


class _FailingLib:
    def __init__(self, err):
        self.err = err

    def __getattr__(self, name):
        return lambda *a: self.err


@pytest.mark.parametrize("act,Dh", [(torch.float32, 128),
                                    (torch.float32, 256),
                                    (torch.float32, 72),
                                    (torch.bfloat16, 128)])
@pytest.mark.parametrize("failure", ["build", "launch", "refused"])
def test_wrapper_raises_on_a_failed_build_or_launch(monkeypatch, act, Dh,
                                                    failure):
    """No fallback: where the build fails, the launcher returns a CUDA
    error or refuses the head dim, the wrapper raises and counts no launch
    (driven on meta tensors with the meta route switched off, a stand-in
    library in place of the built one)."""
    from repro_torch.kernels import _build, ops, work
    from repro_torch.kernels import prefill_attention as tpf

    def no_build(name):
        raise RuntimeError("nvcc failed for prefill_attention")

    monkeypatch.setattr(work, "is_meta", lambda t: False)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "library", no_build if failure == "build"
                        else lambda name: _FailingLib(
                            700 if failure == "launch" else -1))
    ops.reset_launches()
    want = {"build": (RuntimeError, "nvcc failed"),
            "launch": (RuntimeError, "CUDA error 700"),
            "refused": (ValueError, f"head_dim {Dh}")}[failure]
    with pytest.raises(want[0], match=want[1]):
        _meta_prefill(act, Dh, torch.int8, TP8_2, torch.float32)
    assert ops.launch_counts()["prefill_attention"] == 0
