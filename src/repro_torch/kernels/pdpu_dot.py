"""Bit-exact chunked-PDPU GEMM: the CUDA kernel and its plain version.

`pdpu_matmul` (K8, `csrc/pdpu_dot.cu`) replaces
`repro/kernels/pdpu_dot.py:pdpu_matmul`: [M, K] x [K, N_out] posit codes
through chunk-size-N PDPUs, the paper's S1-S6 integer datapath with the
W_m alignment truncation and the accumulator rounded to `cfg.fmt_out`
after every chunk.  Every output code is what a silicon PDPU array with
that chunk size and alignment width produces.  On a CUDA tensor the
wrapper launches the kernel; on a CPU tensor it runs the plain version,
`core/pdpu.pdpu_matmul_exact`; on a meta tensor it counts the launch
it would make (`kernels/work.py`).  K must hold whole chunks; M and N_out
need not divide any tile.

The kernel has one datapath in two kinds of variant (`pdpu_variant`): the
paper's Table I configurations that the reference names
(`core/formats.py`'s PDPU_*) fixed at compile time -- `p13_16_n4` (the
bit_exact policy's), `p16_16_n4`, `p13_16_n8`, `p10_16_n8`,
`p13_16_n8_w10` -- and `posit`, every other configuration with its
fields and shifts at run time.  Both carry each accumulator as decoded
fields from one chunk step to the next; `pdpu_matmul_fields` states that
rearranged chain in plain PyTorch (for any valid configuration).  The
W_m 256 quire of Table I is refused by `pdpu._validate`, as the reference
refuses it: its accumulator does not fit the int32 datapath.
"""
from __future__ import annotations

import torch

from repro_torch.core import formats, pdpu, posit
from repro_torch.core.formats import P13_2, P16_2, PDPUConfig
from . import _build, work
from .posit_codec import round_abs_plain

_CHUNKS = (1, 2, 4, 8, 16)
_CODE_DTYPES = (torch.int8, torch.int16, torch.int32)
# the compile-time variants (csrc/pdpu_dot.cu), by configuration: the
# bit_exact policy's PDPU and the other Table I configurations the
# reference names, each at its defaults (2 guard bits, sticky)
FIXED = PDPUConfig(P13_2, P16_2, N=4, w_m=14, guard_bits=2, sticky=True)
NAMED = {FIXED: "p13_16_n4",
         formats.PDPU_P16_16_N4_W14: "p16_16_n4",
         formats.PDPU_P13_16_N8_W14: "p13_16_n8",
         formats.PDPU_P10_16_N8_W14: "p10_16_n8",
         formats.PDPU_P13_16_N8_W10: "p13_16_n8_w10"}
_VARIANTS = {"posit": 0, "p13_16_n4": 1, "p16_16_n4": 2, "p13_16_n8": 3,
             "p10_16_n8": 4, "p13_16_n8_w10": 5}
# launches of the kernel since the last reset (kernels/ops.reset_launches);
# "pdpu_matmul:<variant>" counts them by `pdpu_variant`
LAUNCHES = {"pdpu_matmul": 0} | {f"pdpu_matmul:{v}": 0 for v in _VARIANTS}
_SENT = -(1 << 20)   # the exponent field of a zero operand / accumulator
_FW = 20             # fraction bits of S6's log-domain word
_M32 = 0xFFFFFFFF


def pdpu_variant(cfg: PDPUConfig) -> str:
    """K8's kernel for a configuration: its compile-time variant for a
    Table I configuration of `NAMED` (formats, N, W_m, guard bits and
    sticky all equal), the run-time `posit` kernel for every other one."""
    return NAMED.get(cfg, "posit")


def _shift_terms(cfg: PDPUConfig):
    """(CP, CA): the left shift of a product's / the accumulator's
    significand in S3 when its exponent is the chunk's e_max."""
    return (cfg.w_m - 2 - 2 * cfg.fmt_in.frac_bits + cfg.guard_bits,
            cfg.w_m - 2 - cfg.fmt_out.frac_bits + cfg.guard_bits)


def _term(v, r, m, sticky: bool):
    """S3 of one term as the kernel runs it: v shifted right by r (shifts
    clamp at 32), the dropped bits' OR into the LSB when sticky, xor the
    sign mask m (0 or 2**32 - 1)."""
    rc = torch.clamp(r, max=32)
    t = v >> rc
    if sticky:
        t = t | ((v & ((1 << rc) - 1)) != 0).to(torch.int64)
    return t ^ m


def round_fields(mag, e_max, cfg: PDPUConfig):
    """S6 of the fields chain (every variant), giving the next step's
    accumulator: the rounding of mag * 2**(e_max + 2 - W_m - G) into
    fmt_out, in the log domain.  The posit pattern's round to nearest
    even is the round of
    Y = S 2**FW + fraction (S the scale) at bit D = es + FW - n_avail,
    n_avail = n - 1 - rlen the exponent and fraction bits the regime
    leaves: Y's bits above es + FW are the regime's k, so a carry out of
    the exponent is the regime's carry.  With n_avail = 0 the code's last
    bit is the regime's terminator, the inverse of k's parity, so ties
    flip; S clamped to [-maxs - 1, maxs] gives minpos / maxpos beyond.
    Returns (sig, ec): the result's significand << max(CA, 0) (0 for zero)
    and its scale (`_SENT` for zero)."""
    fo, fw = cfg.fmt_out, _FW
    _, ca = _shift_terms(cfg)
    z = 32 - posit.bit_length32(mag)
    S = e_max + (2 - cfg.w_m - cfg.guard_bits) + 31 - z
    maxs = (fo.n - 2) << fo.es
    Sc = torch.clamp(S, -maxs - 1, maxs)
    k = Sc >> fo.es
    m = k ^ (k >> 31)                       # rlen = m + 2
    D = fo.es + fw - fo.n + 3 + m
    L = (mag << torch.clamp(z, max=31)) & _M32
    Y = Sc * (1 << fw) + (((L << 1) & _M32) >> (32 - fw))
    lsb = ((Y >> D) ^ (m >= fo.n - 3).to(torch.int64)) & 1
    Yr = ((Y + (1 << (D - 1)) - 1 + lsb) >> D) << D
    sig = ((Yr & ((1 << fw) - 1)) | (1 << fw)) \
        >> (fw - fo.frac_bits - max(ca, 0))
    live = mag != 0
    return torch.where(live, sig, 0), torch.where(live, Yr >> fw, _SENT)


def pdpu_matmul_fields(a_codes, b_codes, cfg: PDPUConfig):
    """K8's fields chain (every variant) in plain PyTorch: [M, K] x [K,
    N_out] fmt_in codes -> int32 fmt_out codes, bit for bit
    `pdpu_matmul_plain`.  Operands as fields (significand, exponent field
    d, sign mask; a zero has significand 0 and d = `_SENT`), every S3 term
    a right shift by e_max - d of a value pre-shifted by its fixed left
    shift, two's complement as xor plus a count, S6 in the log domain
    (`round_fields`), the accumulator carried as fields and packed into a
    code once at the end, NaR a per-row / per-column flag."""
    pdpu._validate(cfg)
    fi, N = cfg.fmt_in, cfg.N
    M, K = a_codes.shape
    N_out = b_codes.shape[1]
    if K % N:
        raise ValueError(f"K={K} not divisible by PDPU chunk size N={N}")
    cp, ca = _shift_terms(cfg)

    def fields(codes, offset):
        zero, nar, sign, scale, frac = posit.decode_unpacked(codes, fi)
        live = ~(zero | nar)
        return (torch.where(live, frac, 0),
                torch.where(live, scale + offset, _SENT),
                torch.where(live & (sign == 1), _M32, 0), nar)

    # a product is fa * fb << max(CP, 0), its d = scale_a + scale_b +
    # min(CP, 0): the right shift is e_max - d
    fa, da, ma, nar_a = fields(a_codes.to(torch.int64) & fi.mask, min(cp, 0))
    fb, db, mb, nar_b = fields(b_codes.to(torch.int64) & fi.mask, 0)
    nar = nar_a.any(dim=1)[:, None] | nar_b.any(dim=0)[None, :]
    zeros = torch.zeros((M, N_out), dtype=torch.int64, device=a_codes.device)
    sig, ec, neg = zeros, zeros + _SENT, zeros
    for j in range(0, K, N):
        v = (fa[:, None, j:j + N] * fb.T[None, :, j:j + N]) << max(cp, 0)
        d = da[:, None, j:j + N] + db.T[None, :, j:j + N]
        m = ma[:, None, j:j + N] ^ mb.T[None, :, j:j + N]
        e_max = torch.maximum(d.amax(dim=-1) - min(cp, 0), ec)
        s = _term(v, e_max[..., None] - d, m, cfg.sticky).sum(dim=-1) \
            + (m & 1).sum(dim=-1) + (neg & 1) \
            + _term(sig, e_max - ec - min(ca, 0), neg, cfg.sticky)
        s = ((s + (1 << 31)) & _M32) - (1 << 31)     # the int32 sum
        sig, ec = round_fields(s.abs(), e_max, cfg)
        neg = torch.where(s < 0, _M32, 0)
    # the code, packed once: the value is a posit of fmt_out, so the
    # rounding only packs it
    fo = cfg.fmt_out
    code = round_abs_plain(
        ec, sig << (31 - fo.frac_bits - max(ca, 0)), fo)
    out = torch.where(neg != 0, (-code) & fo.mask, code)
    out = torch.where(sig != 0, out, 0)
    return torch.where(nar, fo.nar_code, out).to(torch.int32)


def pdpu_matmul_plain(a_codes, b_codes, cfg: PDPUConfig):
    """The datapath output by output in plain PyTorch (int32 codes)."""
    mask = cfg.fmt_in.mask
    return pdpu.pdpu_matmul_exact(a_codes.to(torch.int64) & mask,
                                  b_codes.to(torch.int64) & mask, cfg)


def pdpu_matmul(a_codes, b_codes, cfg: PDPUConfig):
    """[M, K] fmt_in codes x [K, N_out] fmt_in codes -> [M, N_out] int32
    fmt_out codes.  Codes may sit in any integer container (the int16
    container sign-extends, so only the low n bits are read).  b_codes may
    be a transposed view (the tied embedding as the logits head)."""
    if a_codes.ndim != 2 or b_codes.ndim != 2:
        raise ValueError(f"pdpu_matmul takes 2-D operands, got "
                         f"{tuple(a_codes.shape)} x {tuple(b_codes.shape)}")
    M, K = a_codes.shape
    K2, N_out = b_codes.shape
    if K != K2:
        raise ValueError("contraction mismatch")
    if K % cfg.N:
        raise ValueError(f"K={K} not divisible by PDPU chunk size N={cfg.N}")
    pdpu._validate(cfg)
    if a_codes.device.type == "cpu":
        return pdpu_matmul_plain(a_codes, b_codes, cfg)
    for name, t in (("a", a_codes), ("b", b_codes)):
        if t.dtype not in _CODE_DTYPES:
            raise TypeError(f"pdpu_matmul: {name} must hold integer codes, "
                            f"got {t.dtype}")
    if cfg.N not in _CHUNKS:
        raise ValueError(f"pdpu_matmul: the kernel takes chunk sizes "
                         f"{_CHUNKS}, got N={cfg.N}")
    if cfg.fmt_in.n > 16 or cfg.fmt_out.n > 16:
        raise ValueError("pdpu_matmul: formats of at most 16 bits")
    # the kernel reads int16 containers; the low n bits of a code survive
    # the conversion from any container, and an int16 view stays a view
    a16 = a_codes.to(torch.int16).contiguous()
    b16 = b_codes.to(torch.int16)
    if not (b16.stride(1) == 1 or b16.stride(0) == 1):
        b16 = b16.contiguous()
    dev = a16.device
    if a16.device != b16.device or dev.type not in ("cuda", "meta"):
        raise ValueError(f"pdpu_matmul: tensors must share one CUDA device, "
                         f"got {a16.device} and {b16.device}")
    out = torch.empty((M, N_out), dtype=torch.int32, device=dev)
    if M and N_out:
        variant = pdpu_variant(cfg)
        keys = ("pdpu_matmul", f"pdpu_matmul:{variant}")
        if work.is_meta(a16):
            work.record(keys, work.pdpu(M, K, N_out, cfg.N,
                                        work.pdpu_step_ops(cfg.N,
                                                           cfg.sticky)))
            return out
        lib = _build.library("pdpu_dot")
        fi, fo = cfg.fmt_in, cfg.fmt_out
        _build.check(lib.pdpu_matmul_launch(
            a16.data_ptr(), b16.data_ptr(), out.data_ptr(), M, K, N_out,
            a16.stride(0), a16.stride(1), b16.stride(0), b16.stride(1),
            fi.n, fi.es, fo.n, fo.es, cfg.N, cfg.w_m, cfg.guard_bits,
            int(cfg.sticky), _VARIANTS[variant], _build.stream_of(a16)),
            "pdpu_matmul")
        work.count(LAUNCHES, keys)
    return out
