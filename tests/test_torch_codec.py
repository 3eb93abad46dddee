"""PyTorch port vs the JAX reference: posit formats and the codec.

Every result here is integer-domain or built from bits, so every check is
bitwise: format-derived constants, decode on every code of every format
(the port's core codec and its codec-kernel wrapper against the
reference's jnp codec and its Pallas kernel in interpret mode), and
encode / pack on a sorted sweep of f32 bit patterns with the specials
(+-0, subnormals, +-inf, nan, beyond maxpos, bf16-rounded values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import posit as jposit
from repro.kernels import posit_codec as jcodec

from repro_torch.core import formats as tformats
from repro_torch.core import posit as tposit
from repro_torch.kernels import ops as tops

# tests/test_codec_properties.py:FORMATS, plus the paged-KV P(16,1)
FORMAT_NES = [(8, 2), (8, 0), (8, 1), (10, 2), (13, 2), (12, 3), (16, 2),
              (16, 0), (6, 1), (16, 1)]
_PROPS = ("useed_log2", "mask", "sign_mask", "nar_code", "maxpos_code",
          "minpos_code", "max_scale", "min_scale", "frac_bits",
          "storage_bits")
_JSTORE = {8: jnp.int8, 16: jnp.int16}


def _fmts(n, es):
    return jformats.PositFormat(n, es), tformats.PositFormat(n, es)


def _bits_sweep():
    """Sorted f32 bit patterns: a seeded spread over all 2**32 patterns,
    the specials, values beyond maxpos, and bf16-rounded values."""
    rng = np.random.default_rng(2024)
    spread = np.sort(rng.integers(0, 2 ** 32, 120_000, dtype=np.uint64))
    specials = np.array([0x00000000, 0x80000000, 0x00000001, 0x807FFFFF,
                         0x00400000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00001, 0x7F7FFFFF, 0xFF7FFFFF, 0x00800000,
                         0x3F800000, 0xBF800000], np.uint64)
    big = np.array([1e20, -1e20, 3.4e38, 7.2e16, 2.0 ** 60],
                   np.float32).view(np.uint32).astype(np.uint64)
    bf16 = (rng.integers(0, 2 ** 16, 4096, dtype=np.uint64) << 16)
    bits = np.concatenate([spread, specials, big, bf16]).astype(np.uint32)
    return bits.view(np.float32)


SWEEP = _bits_sweep()


@pytest.mark.parametrize("n,es", FORMAT_NES)
def test_format_properties_equal(n, es):
    j, t = _fmts(n, es)
    for prop in _PROPS:
        assert getattr(t, prop) == getattr(j, prop), prop
    assert str(t) == str(j)


def test_named_formats_and_pdpu_configs_equal():
    for name in ("P16_2", "P16_1", "P13_2", "P10_2", "P8_2", "P8_1", "P8_0"):
        j, t = getattr(jformats, name), getattr(tformats, name)
        assert (t.n, t.es) == (j.n, j.es), name
    for name in ("PDPU_P16_16_N4_W14", "PDPU_P13_16_N4_W14",
                 "PDPU_P13_16_N8_W14", "PDPU_P10_16_N8_W14",
                 "PDPU_P13_16_N8_W10", "PDPU_QUIRE_P13_16_N4"):
        j, t = getattr(jformats, name), getattr(tformats, name)
        assert (t.name, t.N, t.w_m, t.guard_bits, t.sticky) == \
            (j.name, j.N, j.w_m, j.guard_bits, j.sticky), name


@pytest.mark.parametrize("n,es", FORMAT_NES)
def test_decode_all_codes_bitwise(n, es):
    jf, tf = _fmts(n, es)
    codes = np.arange(1 << n, dtype=np.int64)
    want = np.asarray(jposit.decode(jnp.asarray(codes, jnp.int32), jf))
    got = tposit.decode(torch.from_numpy(codes), tf).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the kernel wrapper (plain version on the CPU) against the Pallas
    # kernel in interpret mode, in the storage container
    store = tposit.storage_dtype(tf)
    wrapped = ((codes + (1 << (jf.storage_bits - 1)))
               % (1 << jf.storage_bits)) - (1 << (jf.storage_bits - 1))
    rows = 1 << (n // 2)
    c2 = wrapped.reshape(rows, -1)
    jk = np.asarray(jcodec.decode(jnp.asarray(c2, _JSTORE[jf.storage_bits]),
                                  jf, block_r=rows, block_c=c2.shape[1],
                                  interpret=True))
    tk = tops.decode(torch.from_numpy(c2).to(store), tf).numpy()
    np.testing.assert_array_equal(tk.view(np.int32), jk.view(np.int32))
    np.testing.assert_array_equal(tk.reshape(-1).view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("n,es", FORMAT_NES)
def test_encode_sweep_bitwise(n, es):
    jf, tf = _fmts(n, es)
    want = np.asarray(jposit.encode(jnp.asarray(SWEEP), jf))
    got = tposit.encode(torch.from_numpy(SWEEP), tf).numpy()
    np.testing.assert_array_equal(got, want)
    want_p = np.asarray(jposit.pack(jnp.asarray(SWEEP), jf))
    got_p = tposit.pack(torch.from_numpy(SWEEP), tf).numpy()
    assert got_p.dtype == want_p.dtype
    np.testing.assert_array_equal(got_p, want_p)


@pytest.mark.parametrize("n,es", [(8, 2), (16, 2), (16, 1)])
def test_encode_kernel_wrapper_bitwise(n, es):
    """ops.encode (plain on the CPU) == the Pallas encode kernel."""
    jf, tf = _fmts(n, es)
    v = SWEEP[:(SWEEP.size // 512) * 512].reshape(-1, 512)
    want = np.asarray(jcodec.encode(jnp.asarray(v), jf, block_r=v.shape[0],
                                    block_c=512, interpret=True))
    got = tops.encode(torch.from_numpy(v), tf).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # a transposed view encodes elementwise like its contiguous copy
    tv = torch.from_numpy(v).T
    np.testing.assert_array_equal(tops.encode(tv, tf).numpy(), got.T)


@pytest.mark.parametrize("n,es", [(8, 2), (16, 2), (13, 2)])
def test_bf16_and_quantize_bitwise(n, es):
    jf, tf = _fmts(n, es)
    x = np.random.default_rng(n).normal(0, 3, 4096).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jb = jnp.asarray(x).astype(jnp.bfloat16)
    np.testing.assert_array_equal(tposit.encode(xb, tf).numpy(),
                                  np.asarray(jposit.encode(jb, jf)))
    got = tposit.quantize(xb, tf).to(torch.float32).numpy()
    want = np.asarray(jposit.quantize(jb, jf).astype(jnp.float32))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    unpacked = tposit.unpack(tposit.pack(torch.from_numpy(x), tf), tf).numpy()
    want_u = np.asarray(jposit.unpack(jposit.pack(jnp.asarray(x), jf), jf))
    np.testing.assert_array_equal(unpacked.view(np.int32),
                                  want_u.view(np.int32))


def test_bit_length32_matches_reference():
    x = np.concatenate([np.arange(0, 70000, 7),
                        np.array([2 ** 31 - 1, 2 ** 30, 2 ** 16])])
    want = np.asarray(jposit.bit_length32(jnp.asarray(x, jnp.int32)))
    got = tposit.bit_length32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_codec_slices_large_inputs(monkeypatch):
    """Inputs above the slice size take the sliced loop: same bits."""
    tf = tformats.P16_2
    x = torch.from_numpy(SWEEP[:50_000].copy())
    whole_enc, whole_dec = tposit.pack(x, tf), tposit.decode(
        tposit.pack(x, tf), tf)
    monkeypatch.setattr(tposit, "_SLICE", 4096)
    np.testing.assert_array_equal(tposit.pack(x, tf).numpy(),
                                  whole_enc.numpy())
    np.testing.assert_array_equal(
        tposit.decode(whole_enc, tf).numpy().view(np.int32),
        whole_dec.numpy().view(np.int32))
