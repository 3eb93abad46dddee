"""PyTorch port vs the JAX reference: the paper's host references, which
the port keeps as its own copies (`repro_torch.core.posit_np`, `posit_py`,
`discrete`, `hwmodel`).  They are numpy float64 / int64 and Python
`Fraction` semantic oracles in both packages, so everything is held
bitwise: codes, decoded values (NaR as NaN in the same places), the
baselines' float64 outputs and accuracy figures, and the hardware model's
floats.  The port's own plain PDPU (`core/pdpu.py`, what the chunked-PDPU
kernel K8 is held to) is held bitwise to the port's `pdpu_chunked_dot_np`.

HOST_REFS_FULL=1 widens the sampled sweeps (posit_py on every code of the
8- and 10-bit formats, more PDPU rows).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmarks.workload import conv1_workload
from repro.core import discrete as jdiscrete
from repro.core import hwmodel as jhw
from repro.core import posit_np as jpnp
from repro.core import posit_py as jppy

from repro_torch.core import discrete, hwmodel, pdpu
from repro_torch.core import posit_np as pnp
from repro_torch.core import posit_py as ppy
from repro_torch.core.formats import (P8_0, P8_1, P8_2, P10_2, P13_2, P16_1,
                                      P16_2, PDPU_P10_16_N8_W14,
                                      PDPU_P13_16_N4_W14, PDPU_P13_16_N8_W10,
                                      PDPU_P13_16_N8_W14, PDPU_P16_16_N4_W14,
                                      PDPU_QUIRE_P13_16_N4, PDPUConfig)

FULL = os.environ.get("HOST_REFS_FULL") == "1"
FORMATS = (P16_2, P16_1, P13_2, P10_2, P8_2, P8_1, P8_0)
PAPER_CFGS = (PDPU_P16_16_N4_W14, PDPU_P13_16_N4_W14, PDPU_P13_16_N8_W14,
              PDPU_P10_16_N8_W14, PDPU_P13_16_N8_W10, PDPU_QUIRE_P13_16_N4)
# the configurations the paper's Table I and the examples evaluate
TABLE1_CFGS = PAPER_CFGS + (
    PDPUConfig(P8_2, P8_2, N=4, w_m=10), PDPUConfig(P16_2, P16_2, N=8, w_m=14),
    PDPUConfig(P13_2, P16_2, N=4, w_m=4096)) + tuple(
    PDPUConfig(P13_2, P16_2, N=N, w_m=w)
    for N in (4, 8) for w in (8, 10, 12, 14, 18, 24))


def _same(a, b):
    """Bitwise equality of two float64 / int arrays (NaN where NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float64:
        a, b = a.view(np.int64), b.view(np.int64)
    return bool((a == b).all())


def _all_codes(fmt):
    return np.arange(1 << fmt.n, dtype=np.int64)


@pytest.mark.parametrize("fmt", FORMATS, ids=str)
def test_decode_np_every_code(fmt):
    codes = _all_codes(fmt)
    got = pnp.decode_np(codes, fmt)
    assert _same(got, jpnp.decode_np(codes, fmt))
    for g, w in zip(pnp.decode_unpacked_np(codes, fmt),
                    jpnp.decode_unpacked_np(codes, fmt)):
        assert _same(g, w)
    assert np.isnan(got[fmt.nar_code]) and got[0] == 0


def _boundaries(fmt):
    """The values halfway between adjacent positive codes, and the f64
    neighbours of each, with their negations."""
    vals = jpnp.decode_np(np.arange(1, fmt.nar_code, dtype=np.int64), fmt)
    vals = np.sort(vals[vals > 0])
    mid = (vals[:-1] + vals[1:]) / 2
    near = np.concatenate([mid, np.nextafter(mid, 0), np.nextafter(mid, np.inf),
                           vals[:1] / 2, vals[-1:] * 2])
    return np.concatenate([near, -near])


@pytest.mark.parametrize("fmt", FORMATS, ids=str)
def test_encode_and_quantize_np(fmt):
    """Seeded values over the format's range (and 0, +-inf, NaN) and every
    rounding boundary with its f64 neighbours."""
    rng = np.random.default_rng(fmt.n * 10 + fmt.es)
    x = np.concatenate([
        rng.normal(0, 1, 5000) * 2.0 ** rng.integers(-40, 40, 5000),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e300, -1e-300],
        _boundaries(fmt)])
    got = pnp.encode_np(x, fmt)
    assert _same(got, jpnp.encode_np(x, fmt))
    assert _same(pnp.quantize_np(x, fmt), jpnp.quantize_np(x, fmt))
    # round trip: every code encodes back to itself
    codes = _all_codes(fmt)
    back = pnp.encode_np(pnp.decode_np(codes, fmt), fmt)
    assert (back == np.where(codes == fmt.nar_code, fmt.nar_code, codes)).all()


def _rand_codes(rng, fmt, shape):
    return rng.integers(0, 1 << fmt.n, size=shape)


@pytest.mark.parametrize("cfg", PAPER_CFGS, ids=lambda c: c.name)
def test_pdpu_dot_np_and_chunked(cfg):
    """One PDPU step on random codes (NaR and zero included by chance and by
    hand) and a chunked dot of K 64 from a non-zero accumulator."""
    rng = np.random.default_rng(cfg.N * 100 + cfg.w_m)
    M = 4000 if FULL else 600
    va = _rand_codes(rng, cfg.fmt_in, (M, cfg.N))
    vb = _rand_codes(rng, cfg.fmt_in, (M, cfg.N))
    acc = _rand_codes(rng, cfg.fmt_out, (M,))
    va[:8] = 0
    vb[8:16, 0] = cfg.fmt_in.nar_code
    got = pnp.pdpu_dot_np(va, vb, acc, cfg)
    assert _same(got, jpnp.pdpu_dot_np(va, vb, acc, cfg))
    a = pnp.encode_np(rng.normal(0, 1, (200, 64)), cfg.fmt_in)
    b = pnp.encode_np(rng.normal(0, 1, (200, 64)), cfg.fmt_in)
    acc = pnp.encode_np(rng.normal(0, 1, 200), cfg.fmt_out)
    assert _same(pnp.pdpu_chunked_dot_np(a, b, cfg, acc),
                 jpnp.pdpu_chunked_dot_np(a, b, cfg, acc))
    assert _same(pnp.pdpu_chunked_dot_np(a, b, cfg),
                 jpnp.pdpu_chunked_dot_np(a, b, cfg))


@pytest.mark.parametrize("cfg", PAPER_CFGS[:-1], ids=lambda c: c.name)
def test_port_pdpu_bitwise_chunked_dot_np(cfg):
    """The port's plain PDPU (`core/pdpu.py`, int64 tensors wrapped to the
    reference's int32) against the port's own numpy golden, on random codes
    and on a chunked dot of K 64 (the quire configuration is numpy-only:
    its accumulator does not fit the int32 datapath)."""
    rng = np.random.default_rng(cfg.N * 7 + cfg.w_m)
    va = _rand_codes(rng, cfg.fmt_in, (600, cfg.N))
    vb = _rand_codes(rng, cfg.fmt_in, (600, cfg.N))
    acc = _rand_codes(rng, cfg.fmt_out, (600,))
    got = pdpu.pdpu_dot(torch.from_numpy(va), torch.from_numpy(vb),
                        torch.from_numpy(acc), cfg)
    assert (got.numpy() == pnp.pdpu_dot_np(va, vb, acc, cfg)).all()
    a = pnp.encode_np(rng.normal(0, 1, (64, 64)), cfg.fmt_in)
    b = pnp.encode_np(rng.normal(0, 1, (64, 64)), cfg.fmt_in)
    acc = pnp.encode_np(rng.normal(0, 1, 64), cfg.fmt_out)
    got = pdpu.pdpu_chunked_dot(torch.from_numpy(a), torch.from_numpy(b), cfg,
                                torch.from_numpy(acc))
    assert (got.numpy() == pnp.pdpu_chunked_dot_np(a, b, cfg, acc)).all()


def test_discrete_baselines_on_conv1_workload():
    """Every baseline of the paper's Fig. 1 on the conv1-shaped workload,
    and the accuracy metric over their outputs."""
    a, b = conv1_workload(n_positions=8, seed=0)
    exact = (a * b).sum(-1)
    acc = exact[::-1].copy()
    rounders = [("fp64", discrete.round_fp64, jdiscrete.round_fp64),
                ("fp32", discrete.round_fp32, jdiscrete.round_fp32),
                ("fp16", discrete.round_fp16, jdiscrete.round_fp16)] + [
        (str(f), discrete.make_round_posit(f), jdiscrete.make_round_posit(f))
        for f in (P16_2, P13_2, P8_2)]
    for name, rnd, jrnd in rounders:
        assert _same(rnd(a), jrnd(a)), name
        for N in (4, 8):
            got = discrete.dpu_discrete(a, b, N, rnd)
            assert _same(got, jdiscrete.dpu_discrete(a, b, N, jrnd)), name
            assert discrete.accuracy_pct(got, exact) == \
                jdiscrete.accuracy_pct(got, exact)
        got = discrete.dpu_fma_cascade(a, b, rnd, acc)
        assert _same(got, jdiscrete.dpu_fma_cascade(a, b, jrnd, acc)), name
    for cfg in PAPER_CFGS:
        got = discrete.dpu_pdpu_fused(a, b, cfg, acc)
        assert _same(got, jdiscrete.dpu_pdpu_fused(a, b, cfg, acc))
        assert discrete.accuracy_pct(got, exact) == \
            jdiscrete.accuracy_pct(got, exact)
    got = discrete.dpu_quire(a, b, P13_2, P16_2)
    assert _same(got, jdiscrete.dpu_quire(a, b, P13_2, P16_2))
    y = np.array([1.0, 0.0, -2.0, 5.0])
    ref = np.array([1.0, 0.0, 1.0, 0.0])
    assert discrete.accuracy_pct(y, ref, clip=0.5) == \
        jdiscrete.accuracy_pct(y, ref, clip=0.5)


def test_example_workload_copy_is_the_reference_workload():
    """wm_sensitivity_study_torch.py keeps its own copies of
    `conv1_workload` and `hit_rate_pct`: bitwise the benchmark's."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import wm_sensitivity_study_torch as twin
    from benchmarks.bench_table1 import hit_rate_pct
    for kw in (dict(n_positions=8, seed=0), dict(n_positions=5, seed=3,
                                                pad_to=4, batch=2)):
        for got, want in zip(twin.conv1_workload(**kw), conv1_workload(**kw)):
            assert _same(got, want)
    a, b = conv1_workload(n_positions=4, seed=1)
    y = discrete.dpu_pdpu_fused(a, b, PDPU_P13_16_N8_W10)
    exact = (a * b).sum(-1)
    for tau in (0.01, 0.1):
        assert twin.hit_rate_pct(y, exact, tau) == hit_rate_pct(y, exact, tau)


@pytest.mark.parametrize("cfg", TABLE1_CFGS, ids=lambda c: c.name)
def test_hwmodel_report_bitwise(cfg):
    got, want = hwmodel.report(cfg), jhw.report(cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert hwmodel.area_um2(cfg) == jhw.area_um2(cfg)
    assert hwmodel.area_um2(cfg, w_m=20) == jhw.area_um2(cfg, w_m=20)
    assert hwmodel.delay_ns(cfg) == jhw.delay_ns(cfg)
    assert hwmodel.power_mw(cfg) == jhw.power_mw(cfg)
    assert hwmodel.stage_breakdown(cfg) == jhw.stage_breakdown(cfg)
    assert got.row() == want.row()


@pytest.mark.parametrize("fmt", (P16_2, P13_2, P10_2, P8_2, P8_0), ids=str)
def test_posit_py_exact_codec(fmt):
    """The Fraction oracle on sampled codes (every code of the narrow
    formats under HOST_REFS_FULL): decode, encode back, floats in and out,
    and both agree with the numpy codec."""
    rng = np.random.default_rng(fmt.n)
    if FULL and fmt.n <= 10:
        codes = list(range(1 << fmt.n))
    else:
        codes = [0, fmt.nar_code, 1, fmt.mask] + [
            int(c) for c in rng.integers(0, 1 << fmt.n, 200)]
    for c in codes:
        v = ppy.decode_exact(c, fmt)
        assert v == jppy.decode_exact(c, fmt)
        f = ppy.to_float(c, fmt)
        assert np.array_equal(f, jppy.to_float(c, fmt), equal_nan=True)
        assert np.array_equal(f, pnp.decode_np(np.int64(c), fmt),
                              equal_nan=True)
        if v is not None:
            assert ppy.encode_exact(v, fmt) == jppy.encode_exact(v, fmt) == c
    for x in list(rng.normal(0, 1, 100) * 2.0 ** rng.integers(-30, 30, 100)) \
            + [0.0, float("inf"), float("nan"), 1e-300, -1e300]:
        got = ppy.from_float(float(x), fmt)
        assert got == jppy.from_float(float(x), fmt)
        assert got == int(pnp.encode_np(np.float64(x), fmt))


@pytest.mark.parametrize("cfg", PAPER_CFGS, ids=lambda c: c.name)
def test_posit_py_dot_models(cfg):
    """`quire_dot_exact` and the staged `pdpu_dot_model` on sampled code
    vectors, against the reference's and, for the staged model, the numpy
    datapath."""
    rng = np.random.default_rng(cfg.w_m)
    M = 60 if FULL else 20
    va = _rand_codes(rng, cfg.fmt_in, (M, cfg.N))
    vb = _rand_codes(rng, cfg.fmt_in, (M, cfg.N))
    acc = _rand_codes(rng, cfg.fmt_out, (M,))
    staged = pnp.pdpu_dot_np(va, vb, acc, cfg)
    for i in range(M):
        args = ([int(x) for x in va[i]], [int(x) for x in vb[i]],
                int(acc[i]), cfg.fmt_in, cfg.fmt_out)
        q = ppy.quire_dot_exact(*args)
        assert q == jppy.quire_dot_exact(*args)
        m = ppy.pdpu_dot_model(*args, cfg.w_m, cfg.guard_bits, cfg.sticky)
        assert m == jppy.pdpu_dot_model(*args, cfg.w_m, cfg.guard_bits,
                                        cfg.sticky)
        if cfg.w_m < 60:
            assert m == staged[i], i


def test_host_refs_import_no_jax_or_repro():
    import subprocess
    import sys
    code = ("import sys, repro_torch.core.posit_np, repro_torch.core.posit_py, "
            "repro_torch.core.discrete, repro_torch.core.hwmodel; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')); print(bad); "
            "sys.exit(1 if bad else 0)")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    assert subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True).returncode == 0
