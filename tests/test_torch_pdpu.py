"""PyTorch port vs the JAX reference: the bit-exact PDPU datapath
(`core/pdpu.py`), the chunked-PDPU GEMM's plain version (K8), the grouped
posit GEMM's plain version (K9), the bit_exact and grouped dispatch, and
bit_exact serving through the engine.

Same numpy inputs on both sides, seeded.  The port runs on the CPU (each
kernel's plain version); the reference runs its Pallas kernels in
interpret mode.

Tolerances: every PDPU result is an integer code and is held bitwise, and
so is everything the bit_exact plan computes (codes decoded exactly), the
bit_exact token streams included.  The grouped fused and fake_quant plans
are f32 GEMMs: at the expert shapes used here (E 8, K 64, N 48, rows 8,
the qwen3 smoke config's) XLA's and PyTorch's CPU GEMMs sum in the same
order and the results are held bitwise; K9's plain version against the
reference kernel at ragged shapes (where the two GEMMs sum in other
orders) is held to rtol = atol = 1e-5, its fmt_out codes to one code step
(a sum one ulp either side of a rounding boundary).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core import pdpu as jpdpu
from repro.core import posit as jposit
from repro.core.quant import policy_by_name as jpolicy
from repro.kernels import dispatch as jdispatch
from repro.kernels import pdpu_dot as jpdpu_dot
from repro.kernels import posit_matmul as jpm
from repro.models import api as japi
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine

from repro_torch import configs as tconfigs
from repro_torch.core import formats as tformats
from repro_torch.core import pdpu as tpdpu
from repro_torch.core.quant import policy_by_name as tpolicy
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pdpu_dot as tpdpu_dot
from repro_torch.kernels import posit_matmul as tpm
from repro_torch.models import packing as tpacking
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

CONFIGS = sorted(n for n in dir(jformats) if n.startswith("PDPU_"))
VARIANTS = {"guard2-sticky": (2, True), "truncate": (0, False),
            "guard3-sticky": (3, True), "guard1": (1, False)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg_pair(name, variant):
    g, st = VARIANTS[variant]
    return (dataclasses.replace(getattr(jformats, name), guard_bits=g, sticky=st),
            dataclasses.replace(getattr(tformats, name), guard_bits=g, sticky=st))


def _valid(cfg) -> bool:
    try:
        jpdpu._validate(cfg)
    except ValueError:
        return False
    return True


def _codes(rng, fmt, shape):
    """Random codes over the whole range, with zero, NaR, +-maxpos and
    +-minpos planted."""
    c = rng.integers(0, 1 << fmt.n, shape)
    flat = c.reshape(-1)
    special = [0, fmt.nar_code, fmt.maxpos_code, (-fmt.maxpos_code) & fmt.mask,
               fmt.minpos_code, (-fmt.minpos_code) & fmt.mask]
    idx = rng.choice(flat.size, size=min(flat.size, 3 * len(special)),
                     replace=False)
    flat[idx] = np.resize(special, idx.size)
    return c


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", CONFIGS)
def test_pdpu_dot_matches_reference(name, variant):
    """One PDPU step (round(acc + Va . Vb)) on random operand and
    accumulator codes, bitwise, on every Table I configuration of
    formats.py with guard / sticky variants; `_validate` raises for the
    same configurations in both packages."""
    jcfg, tcfg = _cfg_pair(name, variant)
    if not _valid(jcfg):
        with pytest.raises(ValueError):
            tpdpu._validate(tcfg)
        return
    tpdpu._validate(tcfg)
    rng = np.random.default_rng(10 * CONFIGS.index(name)
                                + sorted(VARIANTS).index(variant))
    R, N = 600, jcfg.N
    va = _codes(rng, jcfg.fmt_in, (R, N))
    vb = _codes(rng, jcfg.fmt_in, (R, N))
    acc = _codes(rng, jcfg.fmt_out, (R,))
    # rows of zero products over a live accumulator, and the reverse
    va[:20] = 0
    acc[20:40] = 0
    want = np.asarray(jpdpu.pdpu_dot(jnp.asarray(va, jnp.int32),
                                     jnp.asarray(vb, jnp.int32),
                                     jnp.asarray(acc, jnp.int32), jcfg))
    got = tpdpu.pdpu_dot(_t(va), _t(vb), _t(acc), tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", CONFIGS)
def test_pdpu_matmul_exact_matches_reference(name):
    """The chunked accumulation over K (the fmt_out accumulator rounded
    after every chunk), bitwise."""
    jcfg, tcfg = _cfg_pair(name, "guard2-sticky")
    if not _valid(jcfg):
        return
    rng = np.random.default_rng(3)
    M, K, N = 3, 4 * jcfg.N, 5
    a = _codes(rng, jcfg.fmt_in, (M, K))
    b = _codes(rng, jcfg.fmt_in, (K, N))
    want = np.asarray(jpdpu.pdpu_matmul_exact(jnp.asarray(a, jnp.int32),
                                              jnp.asarray(b, jnp.int32), jcfg))
    np.testing.assert_array_equal(
        tpdpu.pdpu_matmul_exact(_t(a), _t(b), tcfg).numpy(), want)
    with pytest.raises(ValueError, match="divisible"):
        tpdpu.pdpu_chunked_dot(_t(a[:, :-1]), _t(b.T[:, :-1]), tcfg)


@pytest.mark.parametrize("M,N_out", [(5, 7), (1, 3), (9, 130)])
def test_pdpu_matmul_plain_matches_reference_kernel(M, N_out):
    """K8's plain version (the wrapper on CPU tensors) against the
    reference's Pallas kernel in interpret mode, bitwise, with ragged M and
    N_out, codes in sign-extending int16 containers, a transposed B; K not
    a whole number of chunks raises."""
    jcfg = jformats.PDPU_P13_16_N4_W14
    tcfg = tformats.PDPU_P13_16_N4_W14
    rng = np.random.default_rng(M * 100 + N_out)
    K = 24
    fi = jcfg.fmt_in
    a = _codes(rng, fi, (M, K))
    b = _codes(rng, fi, (K, N_out))
    to16 = lambda c: ((c + (1 << 15)) % (1 << 16) - (1 << 15)).astype(np.int16)  # noqa: E731
    want = np.asarray(jpdpu_dot.pdpu_matmul(jnp.asarray(to16(a)),
                                            jnp.asarray(to16(b)), jcfg,
                                            interpret=True))
    got = tops.pdpu_matmul(_t(to16(a)), _t(to16(b)), tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got_t = tops.pdpu_matmul(_t(to16(a)), _t(to16(b).T.copy()).T, tcfg)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert tpdpu_dot.LAUNCHES["pdpu_matmul"] == 0   # no kernel on the CPU
    with pytest.raises(ValueError, match="divisible"):
        tops.pdpu_matmul(_t(a[:, :K - 1]), _t(b[:K - 1]), tcfg)


# ---------------------------------------------------------------------------
# K8's compile-time variant: the choice, and its rearranged chain stated in
# plain PyTorch (pdpu_matmul_fields, round_fields)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,gb,st,variant", [
    ("PDPU_P13_16_N4_W14", 2, True, "p13_16_n4"),
    ("PDPU_P13_16_N4_W14", 3, True, "posit"),
    ("PDPU_P13_16_N4_W14", 2, False, "posit"),
    ("PDPU_P13_16_N8_W14", 2, True, "p13_16_n8"),
    ("PDPU_P16_16_N4_W14", 2, True, "p16_16_n4"),
    ("PDPU_P10_16_N8_W14", 2, True, "p10_16_n8"),
    ("PDPU_P13_16_N8_W10", 2, True, "p13_16_n8_w10"),
    ("PDPU_P13_16_N8_W10", 0, False, "posit")])
def test_pdpu_variant_by_config(name, gb, st, variant):
    """The Table I configurations the reference names take their
    compile-time variants (formats, N, W_m, guard bits and sticky all
    equal), every other configuration the run-time kernel; the bit_exact
    policy's PDPU is p13_16_n4, and with pdpu_n 8 / pdpu_w_m 10
    p13_16_n8_w10."""
    cfg = dataclasses.replace(getattr(tformats, name), guard_bits=gb,
                              sticky=st)
    assert tpdpu_dot.pdpu_variant(cfg) == variant
    policy = tpolicy("validate_bit_exact")
    assert tpdpu_dot.pdpu_variant(policy.pdpu_config()) == "p13_16_n4"
    assert tpdpu_dot.pdpu_variant(dataclasses.replace(
        policy, pdpu_n=8, pdpu_w_m=10).pdpu_config()) == "p13_16_n8_w10"


def test_named_configs_each_have_a_variant():
    """Every PDPU_* configuration of formats.py that pdpu._validate takes
    has its own compile-time variant (one each, with a launch counter);
    the W_m 256 quire is refused before any launch, by the reference's
    rule, in both packages."""
    names = [n for n in CONFIGS if _valid(getattr(jformats, n))]
    assert sorted(names) == sorted(n for n in CONFIGS if "QUIRE" not in n)
    variants = [tpdpu_dot.pdpu_variant(getattr(tformats, n)) for n in names]
    assert "posit" not in variants and len(set(variants)) == len(names)
    assert set(variants) | {"posit"} == set(tpdpu_dot._VARIANTS)
    assert all(f"pdpu_matmul:{v}" in tpdpu_dot.LAUNCHES for v in variants)
    quire = tformats.PDPU_QUIRE_P13_16_N4
    a = torch.zeros(2, 8, dtype=torch.int16)
    with pytest.raises(ValueError, match="int32"):
        tops.pdpu_matmul(a, a.T.contiguous(), quire)
    with pytest.raises(ValueError, match="int32"):
        jpdpu._validate(jformats.PDPU_QUIRE_P13_16_N4)


def _meta_pdpu(cfg, M=4, K=64, N=96):
    from repro_torch.launch.step_analysis import analyze_step
    a = torch.empty(M, K, dtype=torch.int16, device="meta")
    b = torch.empty(K, N, dtype=torch.int16, device="meta")
    return analyze_step(lambda x, y: tpdpu_dot.pdpu_matmul(x, y, cfg), a, b)


@pytest.mark.parametrize("cfg", [
    tformats.PDPU_P13_16_N4_W14, tformats.PDPU_P16_16_N4_W14,
    tformats.PDPU_P13_16_N8_W14, tformats.PDPU_P10_16_N8_W14,
    tformats.PDPU_P13_16_N8_W10,
    tformats.PDPUConfig(tformats.P13_2, tformats.P16_2, N=2, w_m=14,
                        guard_bits=0, sticky=False),
    tformats.PDPUConfig(tformats.P13_2, tformats.P16_2, N=16, w_m=14)],
    ids=lambda c: f"{c.fmt_in.n}_{c.N}_{c.w_m}_{c.guard_bits}")
def test_meta_route_counts_each_variant_and_its_work(cfg):
    """On meta tensors K8's wrapper records one launch under its variant's
    key, and the fields chain's integer operations: M N K / N chunk steps
    of `pdpu_step_ops(N, sticky)` and every operand code decoded once."""
    from repro_torch.kernels import work
    M, K, N = 4, 64, 96
    rec = _meta_pdpu(cfg, M, K, N)
    variant = tpdpu_dot.pdpu_variant(cfg)
    assert rec["launches"] == {"pdpu_matmul": 1,
                               f"pdpu_matmul:{variant}": 1}
    step = work.pdpu_step_ops(cfg.N, cfg.sticky)
    assert step == 5 * cfg.N + (7 if cfg.sticky else 4) * (cfg.N + 1) + 35
    assert rec["ops_by_rate"] == {
        "int32": M * N * (K // cfg.N) * step
        + (M * K + K * N) * work.PDPU_DECODE_OPS}
    assert work.pdpu_floor_s(8192, cfg.N, 1e-7) == 8192 // cfg.N * 1e-7


class _FailingLib:
    def __init__(self, err):
        self.err = err

    def __getattr__(self, name):
        return lambda *a: self.err


@pytest.mark.parametrize("failure", ["build", "launch"])
@pytest.mark.parametrize("named", [True, False])
def test_wrapper_raises_on_a_failed_build_or_launch(monkeypatch, failure,
                                                    named):
    """No fallback to the plain version: a failed build or a launcher's
    CUDA error raises from K8's wrapper and counts no launch (meta tensors
    with the meta route switched off, a stand-in library)."""
    from repro_torch.kernels import _build, work

    def no_build(name):
        raise RuntimeError("nvcc failed for pdpu_dot")

    monkeypatch.setattr(work, "is_meta", lambda t: False)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "library", no_build if failure == "build"
                        else lambda name: _FailingLib(1))
    cfg = tformats.PDPU_P13_16_N8_W10 if named else dataclasses.replace(
        tformats.PDPU_P13_16_N8_W10, guard_bits=1)
    tops.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed" if failure ==
                       "build" else "CUDA error 1"):
        _meta_pdpu(cfg)
    assert tops.launch_counts()["pdpu_matmul"] == 0


def _long_operands(rng, fmt, M, K, N):
    """A [M, K] and B [K, N] over K >= 1024: rows / columns of values near
    1 (the accumulator grows through regimes and rounds at every step), of
    +-maxpos and large values (it saturates at maxpos), and of random codes
    with zero, NaR, +-maxpos and +-minpos planted (row 2 and column 2, so
    NaR reaches only their outputs)."""
    def enc(x):
        return np.asarray(jposit.encode(jnp.asarray(x.astype(np.float32)),
                                        fmt)).astype(np.int64)
    a = enc(rng.normal(0, 1, (M, K)))
    b = enc(rng.normal(0, 1, (K, N)) / 4)
    a[1] = enc(np.sign(rng.normal(0, 1, K)) * 2.0 ** 60)      # +-maxpos
    b[:, 1] = enc(rng.normal(0, 1, K) * 2.0 ** 30)
    a[2] = _codes(rng, fmt, (K,))
    b[:, 2] = _codes(rng, fmt, (K,))
    a[0, ::7] = 0
    return a, b


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", CONFIGS)
def test_pdpu_matmul_fields_matches_exact(name, variant):
    """The rearranged chain (accumulator as fields, right shifts only, S6
    in the log domain, NaR as flags) bitwise `pdpu_matmul_exact`, on every
    valid Table I configuration with guard / sticky variants, at K 1024."""
    jcfg, tcfg = _cfg_pair(name, variant)
    if not _valid(jcfg):
        return
    rng = np.random.default_rng(CONFIGS.index(name) * 10
                                + sorted(VARIANTS).index(variant))
    a, b = _long_operands(rng, jcfg.fmt_in, 4, 1024, 3)
    got = tpdpu_dot.pdpu_matmul_fields(_t(a), _t(b), tcfg)
    assert got.dtype == torch.int32
    want = tpdpu.pdpu_matmul_exact(_t(a), _t(b), tcfg)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (got[2] == tcfg.fmt_out.nar_code).all()
    assert (got[:, 2] == tcfg.fmt_out.nar_code).all()
    assert int(got[1, 1]) in (tcfg.fmt_out.maxpos_code,
                              (-tcfg.fmt_out.maxpos_code) & tcfg.fmt_out.mask)


@pytest.mark.parametrize("name,variant", [
    ("PDPU_P13_16_N4_W14", "guard2-sticky"), ("PDPU_P10_16_N8_W14", "truncate")])
def test_pdpu_matmul_fields_matches_reference_kernel(name, variant):
    """The rearranged chain against the reference's Pallas kernel in
    interpret mode at K 1024, bitwise (the compile-time variant's
    configuration, and one whose products shift left)."""
    jcfg, tcfg = _cfg_pair(name, variant)
    rng = np.random.default_rng(11)
    a, b = _long_operands(rng, jcfg.fmt_in, 4, 1024, 3)
    want = np.asarray(jpdpu_dot.pdpu_matmul(
        jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32), jcfg,
        interpret=True))
    np.testing.assert_array_equal(
        tpdpu_dot.pdpu_matmul_fields(_t(a), _t(b), tcfg).numpy(), want)


@pytest.mark.parametrize("variant", ["guard2-sticky", "truncate"])
def test_round_fields_match_encode_then_decode(variant):
    """S6 of the rearranged chain gives the fields of
    decode(encode_core(...)): on every positive fmt_out code's exact value,
    on every rounding boundary between adjacent codes (ties to even) and
    one unit either side of it, and beyond maxpos / minpos."""
    from repro_torch.core import posit as tposit
    from repro_torch.kernels import posit_codec as tcodec
    _, cfg = _cfg_pair("PDPU_P13_16_N4_W14", variant)
    fo = cfg.fmt_out
    ca = cfg.w_m - 2 - fo.frac_bits + cfg.guard_bits
    base = 2 - cfg.w_m - cfg.guard_bits        # f_scale = e_max + base + p
    # exact values: (scale, significand with frac_bits fraction bits)
    _, _, _, scale, frac = tposit.decode_unpacked(
        torch.arange(1, fo.maxpos_code + 1), fo)
    mags = [frac << (18 - fo.frac_bits)]
    scales = [scale]
    # boundaries: P(n + 1, es) codes 2c + 1, 13-bit significands
    bits = tcodec.rounding_boundaries(fo).view(torch.int32).to(torch.int64)
    bsig = ((1 << 23) | (bits & 0x7FFFFF)) >> 11
    for delta in (-1, 0, 1):
        mags.append((bsig << 6) + delta)
        scales.append((bits >> 23) - 127)
    # beyond the range: saturation to maxpos / minpos
    far = torch.tensor([60, 61, 100, -57, -60, -100])
    mags.append(torch.full_like(far, (1 << 18) + 12345))
    scales.append(far)
    mag, S = torch.cat(mags), torch.cat(scales)
    e_max = S - base - 18          # mag's leading one at bit 18 (or 17)
    sig, ec = tpdpu_dot.round_fields(mag, e_max, cfg)
    p = tposit.bit_length32(mag) - 1
    code = tposit.encode_core(torch.zeros_like(mag), e_max + base + p, mag,
                              p, torch.zeros_like(mag, dtype=torch.bool), fo)
    _, _, _, want_scale, want_frac = tposit.decode_unpacked(code, fo)
    np.testing.assert_array_equal(ec.numpy(), want_scale.numpy())
    np.testing.assert_array_equal(sig.numpy(), (want_frac << ca).numpy())
    # zero magnitude: the zero accumulator
    sig0, ec0 = tpdpu_dot.round_fields(torch.tensor([0]), torch.tensor([3]),
                                       cfg)
    assert int(sig0) == 0 and int(ec0) == tpdpu_dot._SENT


# ---------------------------------------------------------------------------
# dispatch: qdot under bit_exact, qdot_grouped under all three plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [16, 18], ids=["whole-chunks", "ragged-K"])
@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
@pytest.mark.parametrize("lead", [(3,), (2, 3)], ids=["2d", "3d"])
def test_qdot_bit_exact_matches_reference(K, packed, lead):
    rng = np.random.default_rng(K + 2 * packed)
    x = rng.normal(0, 1, lead + (K,)).astype(np.float32)
    w = (rng.normal(0, 1, (K, 5)) / np.sqrt(K)).astype(np.float32)
    jp, tp = jpolicy("validate_bit_exact"), tpolicy("validate_bit_exact")
    jw = jposit.pack(jnp.asarray(w), jformats.P13_2) if packed else jnp.asarray(w)
    want = np.asarray(jdispatch.qdot(jnp.asarray(x), jw, jp))
    got = tdispatch.qdot(_t(x), _t(np.asarray(jw)), tp)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # a Prepared weight keeps the codes and gives the same bits
    prep = tdispatch.Prepared(_t(np.asarray(jw)))
    np.testing.assert_array_equal(
        tdispatch.qdot(_t(x), prep, tp).numpy().view(np.int32),
        want.view(np.int32))


GROUPED_POLICIES = ("paper_mixed", "serve_fused_p16", "serve_fused_p16_a13",
                    "validate_bit_exact")


@pytest.mark.parametrize("shape", [(8, 8, 64), (2, 8, 4, 64), (8, 8, 66)],
                         ids=["3d", "4d", "ragged-K"])
@pytest.mark.parametrize("packed", [False, True], ids=["float", "packed"])
@pytest.mark.parametrize("policy", GROUPED_POLICIES)
def test_qdot_grouped_matches_reference(policy, packed, shape):
    """fake_quant (paper_mixed), fused with float and with coded
    activations, and bit_exact, over float masters and packed expert
    stacks, 3-D and 4-D activations and a K that is not a whole number of
    PDPU chunks: bitwise."""
    rng = np.random.default_rng(len(shape) + 3 * packed + shape[-1])
    K = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = (rng.normal(0, 1, (8, K, 48)) / np.sqrt(K)).astype(np.float32)
    jp, tp = jpolicy(policy), tpolicy(policy)
    jw = jposit.pack(jnp.asarray(w), jp.weights) if packed else jnp.asarray(w)
    want = np.asarray(jax.jit(lambda a, b: jdispatch.qdot_grouped(a, b, jp))(
        jnp.asarray(x), jw))
    got = tdispatch.qdot_grouped(_t(x), _t(np.asarray(jw)), tp)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_bit_exact_backward_raises():
    """Gradients through the bit_exact plan raise the reference's message
    instead of coming back zero, for qdot and qdot_grouped, towards the
    activations and towards float-master weights; without grad the plan
    is a plain forward."""
    tp = tpolicy("validate_bit_exact")
    x = torch.randn(3, 8, requires_grad=True)
    w = torch.randn(8, 4, requires_grad=True)
    with pytest.raises(ValueError, match="not differentiable"):
        tdispatch.qdot(x, w, tp).sum().backward()
    with pytest.raises(ValueError, match="not differentiable"):
        tdispatch.qdot(x, w.detach().to(torch.int16), tp).sum().backward()
    xg = torch.randn(2, 3, 8, requires_grad=True)
    wg = torch.randn(2, 8, 4)
    with pytest.raises(ValueError, match="not differentiable"):
        tdispatch.qdot_grouped(xg, wg, tp).sum().backward()
    with torch.no_grad():
        out = tdispatch.qdot(x, w, tp)
    assert not out.requires_grad


# ---------------------------------------------------------------------------
# K9's plain version against the reference kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt_out", [None, "P16_2"])
@pytest.mark.parametrize("fmt_a", [None, "P13_2"])
def test_posit_matmul_grouped_plain_matches_reference(fmt_a, fmt_out):
    rng = np.random.default_rng(7)
    E, M, K, N = 3, 5, 37, 11
    jfa = getattr(jformats, fmt_a) if fmt_a else None
    tfa = getattr(tformats, fmt_a) if fmt_a else None
    jfo = getattr(jformats, fmt_out) if fmt_out else None
    tfo = getattr(tformats, fmt_out) if fmt_out else None
    x = rng.normal(0, 1, (E, M, K)).astype(np.float32)
    a = x if fmt_a is None else np.asarray(jposit.pack(jnp.asarray(x), jfa))
    b = np.asarray(jposit.pack(jnp.asarray(
        rng.normal(0, 1, (E, K, N)).astype(np.float32) / np.sqrt(K)),
        jformats.P16_2))
    want = np.asarray(jpm.posit_matmul_grouped(
        jnp.asarray(a), jnp.asarray(b), jfa, jformats.P16_2, jfo,
        interpret=True))
    got = tpm.posit_matmul_grouped(_t(a), _t(b), tfa, tformats.P16_2, tfo)
    assert got.numpy().dtype == want.dtype
    if fmt_out is None:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        diff = (got.numpy().astype(np.int64) - want.astype(np.int64))
        assert np.abs(diff).max() <= 1
    assert tpm.LAUNCHES["posit_matmul_grouped"] == 0   # no kernel on the CPU
    # the ops entry points route here
    if fmt_a is None and fmt_out is None:
        np.testing.assert_array_equal(
            tops.matmul_posit_weights_grouped(_t(a), _t(b), tformats.P16_2)
            .numpy(), got.numpy())


# ---------------------------------------------------------------------------
# bit_exact serving: greedy streams against the reference engine
# ---------------------------------------------------------------------------


def test_bit_exact_engine_streams_match_reference():
    """command-r's tiny serving config under validate_bit_exact (P(13,2)
    weights and activations through the PDPU, float KV pages): greedy
    streams equal to the reference engine's, the fused decode reported off
    (decode_step, logits head, host sampler), the pool clean."""
    jcfg = jconfigs.get_tiny_serving("command_r_35b",
                                     jpolicy("validate_bit_exact"))
    tcfg = tconfigs.get_tiny_serving("command_r_35b",
                                     tpolicy("validate_bit_exact"))
    jparams = jax.jit(lambda k: japi.pack_params(japi.init(k, jcfg), jcfg))(
        jax.random.key(8))
    tparams = tpacking.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         tcfg, "cpu")
    rng = np.random.default_rng(9)
    system = rng.integers(0, jcfg.vocab_size, 16)
    prompts = [np.concatenate([system, rng.integers(0, jcfg.vocab_size, n)])
               .astype(np.int32) for n in (3, 9, 1)]
    out = []
    for eng, req in ((JEngine(jcfg, jparams, batch_slots=2, max_seq=48),
                      JRequest),
                     (TEngine(tcfg, tparams, batch_slots=2, max_seq=48,
                              device="cpu"), TRequest)):
        for rid, p in enumerate(prompts):
            eng.submit(req(rid=rid, prompt=p, max_new_tokens=4))
        out.append({r.rid: list(map(int, r.out_tokens)) for r in eng.run()})
        assert not eng.execution_summary()["fused_decode"]
    assert out[1] == out[0]
    assert eng.pages_in_use == 0
    assert eng.cache["k"].dtype == torch.float32   # float pages (no KV format)
