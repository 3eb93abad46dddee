"""PDPU — the fused posit dot-product unit, bit-faithful in plain PyTorch
(port of `repro.core.pdpu`).

The paper's 6-stage datapath (Fig. 4) on integer tensors:

  S1 Decode     : 2N+1 posit decoders (the only decodes)
  S2 Multiply   : exact integer mantissa products + exponent comparator tree
  S3 Align      : shift into the W_m-wide window at e_max, truncate, 2's-comp
  S4 Accumulate : sum of N+1 aligned terms
  S5 Normalize  : leading-zero count -> final scale / significand
  S6 Encode     : one posit rounding + pack (the only encode)

The reference runs this datapath in int32.  Here it runs on int64 tensors
(as the port's codec, `core/posit.py`) and every step that can leave the
int32 range wraps explicitly (`_wrap32`), so the codes are the reference's
bit for bit.  These functions are the plain version the chunked-PDPU GEMM
kernel (`kernels/pdpu_dot.py`, K8) is held against.
"""
from __future__ import annotations

import math

import torch

from . import posit
from .formats import PDPUConfig

_I64 = torch.int64
_NEG_INF = -(1 << 24)


def _wrap32(x):
    """int64 -> the int32 value with the same low 32 bits (int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _validate(cfg: PDPUConfig):
    fbi = cfg.fmt_in.frac_bits
    if 2 * (fbi + 1) + 2 + cfg.guard_bits > 31:
        raise ValueError("input mantissa product exceeds the int32 datapath")
    hi_bits = cfg.w_m + cfg.guard_bits + math.ceil(math.log2(cfg.N + 1)) + 1
    if hi_bits > 31:
        raise ValueError(
            f"w_m={cfg.w_m}, N={cfg.N} accumulator needs {hi_bits} bits > "
            f"int32; use an int64 or quire model for wide w_m")


def pdpu_dot(va_codes, vb_codes, acc_codes, cfg: PDPUConfig):
    """out = round(acc + Va . Vb) through the W_m-aligned fused datapath.

    va_codes, vb_codes: integer tensors [..., N] of cfg.fmt_in codes;
    acc_codes: [...] of cfg.fmt_out codes.  Returns int32 fmt_out codes."""
    _validate(cfg)
    fi, fo, w_m = cfg.fmt_in, cfg.fmt_out, cfg.w_m

    # ---- S1: decode (sole decode stage) -----------------------------------
    za, na, sa, ea, fa = posit.decode_unpacked(va_codes, fi)
    zb, nb, sb, eb, fb_ = posit.decode_unpacked(vb_codes, fi)
    zc, nc, sc, ec, fc = posit.decode_unpacked(acc_codes, fo)
    any_nar = torch.any(na | nb, dim=-1) | nc
    fbi, fbo = fi.frac_bits, fo.frac_bits

    # ---- S2: mantissa products + comparator tree ---------------------------
    prod = fa * fb_                      # [..., N]; 2*fbi frac bits, in [1,4)
    s_ab = sa ^ sb
    e_ab = ea + eb
    e_ab = torch.where(za | zb, torch.full_like(e_ab, _NEG_INF), e_ab)
    e_c = torch.where(zc, torch.full_like(ec, _NEG_INF), ec)
    e_max = torch.maximum(e_ab.amax(dim=-1), e_c)
    all_zero = e_max == _NEG_INF
    e_max_s = torch.where(all_zero, torch.zeros_like(e_max), e_max)

    # ---- S3: align into the w_m window (LSB weight 2**(e_max+2-w_m)) -------
    G = cfg.guard_bits
    lsb_w = e_max_s + 2 - w_m

    def _align(frac, e, fb, lsb):
        sh = (e - fb) - lsb + G
        sh = torch.where(e == _NEG_INF, torch.full_like(sh, -31), sh)
        sh = torch.clamp(sh, -31, 31)
        left = _wrap32(frac << torch.clamp(sh, min=0))
        right_sh = torch.clamp(-sh, max=31)
        right = frac >> torch.clamp(right_sh, min=0)
        out = torch.where(sh >= 0, left, right)
        if cfg.sticky:
            mask = _wrap32((torch.ones_like(frac) << torch.clamp(right_sh, min=0))
                           - 1)
            dropped = torch.where(sh < 0, frac & mask, torch.zeros_like(frac))
            out = out | (dropped != 0).to(_I64)
        return out

    t = _align(prod, e_ab, 2 * fbi, lsb_w[..., None])
    t = torch.where(s_ab == 1, -t, t)    # two's complement conversion
    tc = _align(fc, e_c, fbo, lsb_w)
    tc = torch.where(sc == 1, -tc, tc)

    # ---- S4: accumulate (int add == the recursive CSA tree) ----------------
    ssum = _wrap32(t.sum(dim=-1) + tc)
    f_s = (ssum < 0).to(_I64)
    sm = _wrap32(ssum.abs())

    # ---- S5: normalize -----------------------------------------------------
    p = posit.bit_length32(torch.clamp(sm, min=1)) - 1   # MSB index
    f_scale = (e_max_s + 2 - w_m - G) + p

    # ---- S6: one posit rounding + pack (sole encode stage) -----------------
    code = posit.encode_core(f_s, f_scale, sm, p, torch.zeros_like(all_zero), fo)
    code = torch.where(all_zero | (sm == 0), torch.zeros_like(code), code)
    code = torch.where(any_nar, torch.full_like(code, fo.nar_code), code)
    return code.to(torch.int32)


def pdpu_chunked_dot(a_codes, b_codes, cfg: PDPUConfig, acc_codes=None):
    """Long dot product by chunk-size-N PDPU accumulation (paper §III-C).

    a_codes, b_codes: [..., K], K % N == 0.  The running accumulator lives
    in fmt_out between chunks, the hardware dataflow of one PDPU instance
    walking a dot product over K/N cycles."""
    K = a_codes.shape[-1]
    N = cfg.N
    if K % N != 0:
        raise ValueError(f"dot length {K} not divisible by chunk size {N}")
    shape = torch.broadcast_shapes(a_codes.shape[:-1], b_codes.shape[:-1])
    if acc_codes is None:
        acc = torch.zeros(shape, dtype=torch.int32, device=a_codes.device)
    else:
        acc = acc_codes.to(torch.int32)
    for j in range(K // N):
        acc = pdpu_dot(a_codes[..., j * N:(j + 1) * N],
                       b_codes[..., j * N:(j + 1) * N], acc, cfg)
    return acc


def pdpu_matmul_exact(a_codes, b_codes, cfg: PDPUConfig):
    """[M, K] x [K, N_out] posit matmul through chunked PDPU accumulation:
    what an accelerator tiling its GEMM onto PDPU chunk units computes,
    output element by output element.  Returns int32 fmt_out codes."""
    M, K = a_codes.shape
    K2, N_out = b_codes.shape
    if K != K2:
        raise ValueError(f"contraction mismatch {tuple(a_codes.shape)} x "
                         f"{tuple(b_codes.shape)}")
    # broadcast views: each chunk step materializes only [M, N_out, N]
    return pdpu_chunked_dot(a_codes[:, None, :], b_codes.T[None, :, :], cfg)
