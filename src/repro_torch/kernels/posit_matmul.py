"""Posit GEMMs with in-kernel decode: the CUDA kernels and their plain
versions.

`posit_matmul` (K6, `csrc/posit_matmul.cu`) replaces
`repro/kernels/posit_matmul.py:posit_matmul`: [M, K] posit codes x [K, N]
posit codes, decoded in the kernel, accumulated in f32, returned as f32
or encoded once into `fmt_out`.  `posit_gemv_f` (`csrc/posit_gemv_f.cu`)
is the float weight path at decode rows: [M <= 8, K] f32 or bf16
activations x [K, N] posit codes (or the transpose of [N, K] codes, the
tied head), each code decoded next to its dot; it replaces, on that path,
K1's decode of the whole operand (`repro/kernels/posit_codec.py:decode`)
before the reference's `jnp.dot`.  `posit_matmul_grouped` (K9,
`csrc/posit_matmul_grouped.cu`) replaces `:posit_matmul_grouped`, the MoE
expert-stack form [E, M, K] x [E, K, N] with float or coded activations
(a split-K GEMV at serving rows, a split-bf16 tensor-core GEMM at the
training rows: `grouped_variant`).
On a CUDA tensor a wrapper launches its kernel; on a CPU tensor it runs
the plain version (decode the coded operands, an f32 matmul, optional
encode); on a meta tensor it counts the launch it would make
(`kernels/work.py`).  M, N and K need not divide any tile.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.formats import P13_2, P16_2, PositFormat
from repro_torch.core.posit import storage_dtype, to_container
from . import _build, work
from .posit_codec import decode_plain, encode_plain

# launches of each kernel since the last reset (kernels/ops.reset_launches);
# "posit_matmul:<variant>" counts K6's launches by `matmul_variant`
LAUNCHES = {"posit_matmul": 0, "posit_matmul:gemv_p16_2": 0,
            "posit_matmul:gemv": 0, "posit_matmul:tc_p16_2": 0,
            "posit_matmul:tc": 0, "posit_matmul:tiled": 0,
            "posit_matmul_grouped": 0, "posit_matmul_grouped:p16_2": 0,
            "posit_matmul_grouped:posit": 0, "posit_matmul_grouped:tc": 0,
            "posit_matmul_grouped:tc_p13_2": 0,
            "posit_gemv_f": 0, "posit_gemv_f:p16_2": 0,
            "posit_gemv_f:posit": 0, "posit_gemv_f:p16_2_t": 0,
            "posit_gemv_f:posit_t": 0}
_CODE_DTYPES = (torch.int8, torch.int16)

# K6's split-K GEMV (M <= GEMV_MAX_M): a block owns GEMV_BN columns (32
# threads x 8 codes) and one K split whose row count is a multiple of
# GEMV_ROWS (8 warps x 4 rows in flight) and at most GEMV_MAX_ROWS (its
# decoded activation rows live in shared memory); the splits aim at
# GEMV_BLOCKS blocks, 4 per SM of an H100.
GEMV_MAX_M = 8
GEMV_BN = 256
GEMV_ROWS = 32
GEMV_MAX_ROWS = 2048
GEMV_BLOCKS = 4 * 132
# K6's split-bf16 tensor-core GEMM (M > GEMV_MAX_M): a block owns a
# TC_BM x TC_BN output tile and one K split of a multiple of TC_BK rows;
# the splits aim at TC_BLOCKS blocks, one per SM of an H100.
TC_BM = 128
TC_BN = 128
TC_BK = 64
TC_BLOCKS = 132
_VARIANTS = {"tiled": 0, "gemv": 1, "gemv_p16_2": 2, "tc": 3, "tc_p16_2": 4}
# The float GEMV (`posit_gemv_f`): a block owns GEMV_F_TILE columns of
# [K, N] codes and one K split of a multiple of GEMV_F_ROWS rows (8 warps
# x 4 rows a warp-load x 8 loads: one iteration of the register loop, two
# ring slots), at most GEMV_F_MAX_K (its f32 activations live in shared
# memory); the splits aim at GEMV_F_BLOCK_CODES codes a block and at most
# GEMV_BLOCKS blocks.  Over the transpose of [N, K] codes a block owns
# GEMV_F_TILE output rows and one K split of GEMV_T_SPLIT codes (8 warps x
# 256, each lane's 8 activations in registers).  From (N, K) alone.
GEMV_F_TILE = 64
GEMV_F_ROWS = 256
GEMV_F_MAX_K = 2048
GEMV_F_BLOCK_CODES = 1 << 15
GEMV_T_SPLIT = 2048
# K9's grouped GEMV: a block owns one expert's GROUPED_BM-row tile,
# GEMV_BN columns and one K split (rows a multiple of GEMV_ROWS, at most
# GEMV_MAX_ROWS); the splits aim at GROUPED_EXPERT_BLOCKS blocks an
# occupied expert, so the 32 experts a decode step routes to fill the
# card's 132 SMs.
GROUPED_BM = 8
GROUPED_EXPERT_BLOCKS = 24
# K9's split-bf16 tensor-core GEMM (M > GROUPED_BM, coded activations): a
# block owns one expert's GROUPED_TC_BM-row tile, GROUPED_TC_BN weight
# columns and one K split of a multiple of GROUPED_TC_BK rows; the splits
# aim at GROUPED_TC_EXPERT_BLOCKS blocks an expert.
GROUPED_TC_BM = 64
GROUPED_TC_BN = 128
GROUPED_TC_BK = 64
GROUPED_TC_EXPERT_BLOCKS = 8
_GROUPED_VARIANTS = {"posit": 0, "p16_2": 1, "tc": 2, "tc_p13_2": 3}
# what a launcher returns for a configuration it does not take
_REFUSED = -1


def split_bf16(x):
    """x (f32) -> (hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi): the
    two terms K6's tensor-core variant multiplies.  For a decoded posit of
    at most 14 significand bits hi + lo == x exactly."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _split_exponents(n: int, es: int) -> tuple[int, int]:
    """(least, greatest) binary exponent of the nonzero bf16 terms of
    `split_bf16` over every code of P(n, es) but NaR."""
    fmt = PositFormat(n, es)
    x = decode_plain(to_container(torch.arange(1 << n, dtype=torch.int64),
                                  fmt), fmt)
    x = x[torch.isfinite(x) & (x != 0)]
    terms = torch.cat([t.to(torch.float32) for t in split_bf16(x)]).abs()
    _, e = torch.frexp(terms[terms != 0])
    return int(e.min()) - 1, int(e.max()) - 1


def split_exact(fmt_a: PositFormat, fmt_b: PositFormat) -> bool:
    """Whether every product of a `split_bf16` term of a fmt_a value and
    one of a fmt_b value is a normal, finite f32 (so exact: 8 x 8
    significand bits), as the tensor-core variant needs."""
    lo_a, hi_a = _split_exponents(fmt_a.n, fmt_a.es)
    lo_b, hi_b = _split_exponents(fmt_b.n, fmt_b.es)
    return hi_a + hi_b <= 126 and lo_a + lo_b >= -126


def matmul_variant(M: int, fmt_a: PositFormat, fmt_b: PositFormat,
                   b_dtype) -> str:
    """K6's kernel for an [M, K] x [K, N] call: the split-K GEMV at decode
    shapes (M <= GEMV_MAX_M), the split-bf16 tensor-core GEMM above where
    the split is exact for both formats (`split_exact`), else the f32 SIMT
    tiles; "_p16_2" marks the compile-time P(16,2) decode for int16
    P(16,2) weights (every a13 projection)."""
    p16_2 = (fmt_b.n, fmt_b.es) == (16, 2) and b_dtype == torch.int16
    if M <= GEMV_MAX_M:
        return "gemv_p16_2" if p16_2 else "gemv"
    if not split_exact(fmt_a, fmt_b):
        return "tiled"
    return "tc_p16_2" if p16_2 else "tc"


def split_k(N: int, K: int) -> tuple[int, int]:
    """(rows per split KS, number of splits S) of the split-K GEMV.  Split
    s covers K rows [s * KS, min(K, (s + 1) * KS)), so the splits cover
    [0, K) once, in split order, none empty; S is at least 1 (K = 0 gives
    one empty split and zero sums)."""
    tiles = -(-N // GEMV_BN)
    want = max(1, -(-GEMV_BLOCKS // max(tiles, 1)))
    rows = -(-K // want)
    ks = min(max(-(-rows // GEMV_ROWS) * GEMV_ROWS, GEMV_ROWS), GEMV_MAX_ROWS)
    return ks, max(1, -(-K // ks))


def tc_split_k(M: int, N: int, K: int) -> tuple[int, int]:
    """(rows per split KS, number of splits S) of the tensor-core GEMM:
    KS a multiple of TC_BK, split s covers K rows [s * KS, min(K, (s + 1)
    * KS)) (rows past K are zeros), none empty, S >= 1; output tiles
    times splits come near TC_BLOCKS where K allows."""
    tiles = -(-M // TC_BM) * -(-N // TC_BN)
    want = max(1, TC_BLOCKS // max(tiles, 1))
    steps = max(1, -(-K // TC_BK))
    ks = -(-steps // min(want, steps)) * TC_BK
    return ks, max(1, -(-K // ks))


# Tolerance constant of `sum_bound`, in units of u sqrt(K) ||a_i . b_j||_2.
# On an H100 the kernel's sums came within 4.0 units of torch.matmul's at
# the serving shapes, while weights rounded to bf16 landed 816 or more
# units off and one K tile left out 22000 or more (`chip_smoke.py` prints
# all three): 16 leaves a factor 4 on the sound side and 50 on the other.
SUM_TOL = 16.0


def sum_bound(a_codes, b_codes, fmt_a: PositFormat | None,
              fmt_b: PositFormat):
    """Tolerance between two f32 sums of the same K products of random
    sign taken in different orders: SUM_TOL * u * sqrt(K) *
    sqrt(sum_k (a_ik b_kj)^2), u = 2^-24.  Each sum's rounding errors walk
    at random, so the gap grows as sqrt(K) u times the products' scale,
    not as the worst case K u.  fmt_a None takes float activations; a
    leading expert dim batches.  Returns [..., M, N] f32."""
    K = a_codes.shape[-1]
    a = _operand(a_codes, fmt_a).double()
    b = decode_plain(b_codes, fmt_b).double()
    norm = torch.matmul(a * a, b * b).sqrt()
    return (SUM_TOL * 2.0 ** -24 * K ** 0.5 * norm).float()


def _operand(a, fmt: PositFormat | None):
    """Activations as f32: decoded codes, or the float values."""
    return a.to(torch.float32) if fmt is None else decode_plain(a, fmt)


def posit_matmul_plain(a_codes, b_codes, fmt_a: PositFormat,
                       fmt_b: PositFormat, fmt_out: PositFormat | None = None):
    """decode(A) @ decode(B) in f32, then one encode to fmt_out if set."""
    out = torch.matmul(decode_plain(a_codes, fmt_a), decode_plain(b_codes, fmt_b))
    return out if fmt_out is None else encode_plain(out, fmt_out)


def _check_codes(name: str, t, fmt: PositFormat):
    if t.dtype not in _CODE_DTYPES:
        raise TypeError(f"posit_matmul: {name} must hold int8/int16 codes, "
                        f"got {t.dtype}")
    if fmt.storage_bits != t.element_size() * 8:
        raise TypeError(f"posit_matmul: {fmt} codes live in "
                        f"int{fmt.storage_bits}, {name} is {t.dtype}")


def posit_matmul(a_codes, b_codes, fmt_a: PositFormat, fmt_b: PositFormat,
                 fmt_out: PositFormat | None = None):
    """[M, K] codes x [K, N] codes -> [M, N] f32 (fmt_out None) or fmt_out
    codes in their storage dtype."""
    if a_codes.ndim != 2 or b_codes.ndim != 2:
        raise ValueError(f"posit_matmul takes 2-D operands, got "
                         f"{tuple(a_codes.shape)} x {tuple(b_codes.shape)}")
    M, K = a_codes.shape
    K2, N = b_codes.shape
    if K != K2:
        raise ValueError(f"contraction mismatch {tuple(a_codes.shape)} x "
                         f"{tuple(b_codes.shape)}")
    if a_codes.device.type == "cpu":
        return posit_matmul_plain(a_codes, b_codes, fmt_a, fmt_b, fmt_out)
    _check_codes("a", a_codes, fmt_a)
    _check_codes("b", b_codes, fmt_b)
    _build.require_cuda("posit_matmul", a_codes, b_codes)
    dev = a_codes.device
    if fmt_out is None:
        out = torch.empty((M, N), dtype=torch.float32, device=dev)
    else:
        dt = storage_dtype(fmt_out)
        if dt not in _CODE_DTYPES:
            raise ValueError(f"posit_matmul writes int8/int16 codes, not {dt}")
        out = torch.empty((M, N), dtype=dt, device=dev)
    if M and N:
        variant = matmul_variant(M, fmt_a, fmt_b, b_codes.dtype)
        ks, splits, a_split = 0, 0, None
        if variant.startswith("gemv"):
            ks, splits = split_k(N, K)
        elif variant.startswith("tc"):
            ks, splits = tc_split_k(M, N, K)
            # the activations' hi / lo bf16 rows, decoded once per call
            a_split = torch.empty((2, -(-M // TC_BM) * TC_BM, splits * ks),
                                  dtype=torch.bfloat16, device=dev)
        # per-split partial sums, reduced in split order (one split of the
        # tensor-core GEMM with an f32 output writes `out` directly)
        direct = variant.startswith("tc") and splits == 1 and fmt_out is None
        partial = (torch.empty((splits, M, N), dtype=torch.float32,
                               device=dev) if splits and not direct else None)
        keys = ("posit_matmul", f"posit_matmul:{variant}")
        if work.is_meta(a_codes):
            work.record(keys, work.matmul(
                M, K, N, a_codes.element_size(), b_codes.element_size(),
                out.element_size(), variant))
            return out
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        lib = _build.library("posit_matmul")
        _build.check(lib.posit_matmul_launch(
            a_codes.data_ptr(), b_codes.data_ptr(),
            out.data_ptr() if fmt_out is None else None,
            None if fmt_out is None else out.data_ptr(),
            ptr(partial), ptr(a_split), M, N, K,
            a_codes.element_size(), fmt_a.n, fmt_a.es,
            b_codes.element_size(), fmt_b.n, fmt_b.es,
            0 if fmt_out is None else out.element_size(),
            fmt_out.n if fmt_out else 0, fmt_out.es if fmt_out else 0,
            _VARIANTS[variant], ks, splits, _build.stream_of(a_codes)),
            "posit_matmul")
        work.count(LAUNCHES, keys)
    return out


def _gemv_f_layout(w_codes):
    """"kn" for contiguous [K, N] codes, "t" for the transpose of
    contiguous [N, K] codes (read as they lie), None for another view."""
    if w_codes.is_contiguous():
        return "kn"
    if w_codes.ndim == 2 and w_codes.T.is_contiguous():
        return "t"
    return None


def gemv_f_variant(M: int, fmt_w: PositFormat, w_codes) -> str:
    """The float weight path's kernel for x [M, K] @ w_codes [K, N]: at
    most GEMV_MAX_M rows the float GEMV (`posit_gemv_f`): "p16_2", the
    compile-time P(16,2) decode, for int16 P(16,2) codes (every serving
    checkpoint), else "posit", the run-time decode of any format, with
    "_t" where w_codes is the transpose of contiguous [N, K] codes (the
    tied head; another non-contiguous view is copied to [K, N] first).
    Above: "decode", K1 over the whole operand then `torch.matmul`."""
    if M > GEMV_MAX_M:
        return "decode"
    p16_2 = (fmt_w.n, fmt_w.es) == (16, 2) and w_codes.dtype == torch.int16
    return ("p16_2" if p16_2 else "posit") + (
        "_t" if _gemv_f_layout(w_codes) == "t" else "")


def gemv_f_split_k(N: int, K: int) -> tuple[int, int]:
    """(rows per split KS, number of splits S) of the float GEMV over
    [K, N] codes: split s covers K rows [s * KS, min(K, (s + 1) * KS)) in
    split order, none empty, S >= 1 (K = 0: one empty split); KS a
    multiple of GEMV_F_ROWS of at most GEMV_F_MAX_K; blocks come near
    GEMV_F_BLOCK_CODES codes each, at most GEMV_BLOCKS of them, where K
    allows.  From (N, K) alone, so a row's sums never depend on M."""
    tiles = -(-N // GEMV_F_TILE)
    blocks = min(GEMV_BLOCKS, max(1, -(-K * N // GEMV_F_BLOCK_CODES)))
    want = max(1, -(-blocks // max(tiles, 1)))
    rows = -(-K // want)
    ks = min(max(-(-rows // GEMV_F_ROWS) * GEMV_F_ROWS, GEMV_F_ROWS),
             GEMV_F_MAX_K)
    return ks, max(1, -(-K // ks))


def split_k_t(N: int, K: int) -> tuple[int, int]:
    """(codes per split KS, number of splits S) of the float GEMV over
    the transpose of [N, K] codes: KS = GEMV_T_SPLIT, split s covers
    [s * KS, min(K, (s + 1) * KS)) in split order, none empty, S >= 1
    (K = 0: one empty split).  The tiles alone fill the card at a head's
    N (vocab / GEMV_F_TILE blocks)."""
    return GEMV_T_SPLIT, max(1, -(-K // GEMV_T_SPLIT))


# The P(16,2) decode of the float GEMV (csrc/p16_2_table.cuh): a code u
# (16 bits) splits into idx = u >> 7 and its low byte; where the regime
# run is at most 5 the value is fma(m, T, B) of idx's entry, m the f32 of
# bits 0x3F000000 | (u & 0xFF) << 16.  GEMV_F_TABLE_SLOW: the idx whose
# run is longer (zero, NaR, the magnitudes beyond 2^-20 and 2^20): B nan,
# the kernel decodes those codes in full.
GEMV_F_TABLE_SLOW = tuple(i for i in range(512) if (i + 4) & 0xFF < 8)


def _bf16_bits(x):
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


@functools.lru_cache(maxsize=None)
def gemv_f_p16_2_table() -> torch.Tensor:
    """[512] int32 by idx = u >> 7 of a P(16,2) code u: the bf16 bits of
    B = V0 - 128 step in the high half and of T = 128 step / 2^(b - 1) in
    the low half (V0 the value at u = idx * 128, step its increment a unit
    of u's 7 low bits, b = idx & 1); both exact in bf16.  Built from the
    port's decode (two codes an entry); the entries of GEMV_F_TABLE_SLOW
    hold B = nan and T's bits 0x0001 (bit 0 set on them alone).  On the
    CPU."""
    idx = torch.arange(512, dtype=torch.int64)
    v = decode_plain(to_container(torch.stack([idx * 128, idx * 128 + 1]),
                                  P16_2), P16_2).double()
    step = v[1] - v[0]
    base = v[0] - 128.0 * step
    scale = 128.0 * step * 2.0 ** (1 - (idx & 1)).double()
    slow = torch.tensor(GEMV_F_TABLE_SLOW)
    base[slow], scale[slow] = float("nan"), 0.0
    for t in (base, scale):
        if not torch.equal(t.to(torch.bfloat16).double().nan_to_num(),
                           t.nan_to_num()):
            raise AssertionError("gemv_f_p16_2_table: an entry is not "
                                 "exact in bf16")
    entry = _bf16_bits(base) << 16 | _bf16_bits(scale)
    entry[slow] = 0x7FC00001  # bit 0: the kernel's cue for the full decode
    return (entry - ((entry >> 31) << 32)).to(torch.int32)


def gemv_f_p16_2_decode_plain(codes):
    """The float GEMV's P(16,2) decode of int16 codes, stated in plain
    PyTorch: the table's fma where it holds (exact: computed in f64, one
    rounding to f32), the full decode for GEMV_F_TABLE_SLOW's codes."""
    u = codes.to(torch.int64) & 0xFFFF
    entry = gemv_f_p16_2_table().to(torch.int64)[u >> 7] & 0xFFFFFFFF

    def f32(bits):
        return (bits - ((bits >> 31) << 32)).to(torch.int32).view(
            torch.float32).double()

    base, scale = f32(entry & 0xFFFF0000), f32((entry << 16) & 0xFFFFFFFF)
    m = f32(0x3F000000 | (u & 0xFF) << 16)
    return torch.where(torch.isnan(base), decode_plain(codes, P16_2),
                       (m * scale + base).float())


@functools.lru_cache(maxsize=None)
def _gemv_f_device_table(dev) -> torch.Tensor:
    """`gemv_f_p16_2_table()` on `dev`, uploaded once."""
    return gemv_f_p16_2_table().to(dev)


# the float GEMV's tile tickets by device: zero between calls (the last
# block of a tile sets its ticket back), so created once; a larger array
# is added when a call needs one, and the smaller ones stay alive (a
# captured CUDA graph may still point at them)
_GEMV_F_TICKETS: dict = {}


def _gemv_f_tickets(dev, tiles: int) -> torch.Tensor:
    kept = _GEMV_F_TICKETS.setdefault(dev, [])
    if not kept or kept[-1].numel() < tiles:
        kept.append(torch.zeros(max(tiles, 4096), dtype=torch.int32,
                                device=dev))
    return kept[-1]


def posit_gemv_f_plain(x, w_codes, fmt_w: PositFormat):
    """x (float, cast to f32) @ decode(w_codes) in f32."""
    return torch.matmul(x.to(torch.float32), decode_plain(w_codes, fmt_w))


def posit_gemv_f(x, w_codes, fmt_w: PositFormat):
    """[M, K] float activations x [K, N] posit codes -> [M, N] f32, M <=
    GEMV_MAX_M on the card, in one launch.  x in f32 or bf16 is read as
    it lies (other floats are cast to f32 first); w_codes contiguous
    [K, N], or the transpose of contiguous [N, K] codes, read in place.
    `gemv_f_variant` names the kernel ("p16_2*": the table decode of
    `gemv_f_p16_2_table`); the K splits are `gemv_f_split_k`'s ([K, N])
    or `split_k_t`'s (transposed), from (N, K) alone, and the last block
    of each tile adds them (a ticket a tile, `_gemv_f_tickets`, set back
    to 0 by that block: no memset).  Within `sum_bound(x, w_codes, None,
    fmt_w)` of the plain version; bitwise equal across calls, and a row's
    result does not depend on M or on the other rows.  Bound by HBM bytes
    (2 a code) on an H100.  Besides the per-call scratch, the first call
    on a device keeps the table (2 KB) and the tickets there; calls on one
    device must not overlap on two streams (they share the tickets)."""
    if x.ndim != 2 or w_codes.ndim != 2:
        raise ValueError(f"posit_gemv_f takes 2-D operands, got "
                         f"{tuple(x.shape)} x {tuple(w_codes.shape)}")
    M, K = x.shape
    K2, N = w_codes.shape
    if K != K2:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} x "
                         f"{tuple(w_codes.shape)}")
    if x.device.type == "cpu":
        return posit_gemv_f_plain(x, w_codes, fmt_w)
    if M > GEMV_MAX_M:
        raise ValueError(f"posit_gemv_f takes at most {GEMV_MAX_M} rows, "
                         f"got {M}")
    if not x.is_floating_point():
        raise TypeError(f"posit_gemv_f takes float activations, got "
                        f"{x.dtype}")
    _check_codes("b", w_codes, fmt_w)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    x = x.contiguous()
    variant = gemv_f_variant(M, fmt_w, w_codes)
    transposed = variant.endswith("_t")
    b = w_codes.T if transposed else w_codes.contiguous()
    _build.require_cuda("posit_gemv_f", x, b)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M and N:
        ks, splits = split_k_t(N, K) if transposed else gemv_f_split_k(N, K)
        # per-split partial sums, added in split order by each tile's last
        # block (one split writes `out` directly)
        partial = torch.empty((splits, M, N), dtype=torch.float32,
                              device=x.device) if splits > 1 else None
        keys = ("posit_gemv_f", f"posit_gemv_f:{variant}")
        if work.is_meta(x):
            work.record(keys, work.gemv_f(M, K, N, x.element_size(),
                                          b.element_size()))
            return out
        p16_2 = variant.startswith("p16_2")
        tickets = (_gemv_f_tickets(x.device, -(-N // GEMV_F_TILE))
                   if splits > 1 else None)
        table = _gemv_f_device_table(x.device) if p16_2 else None
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        lib = _build.library("posit_gemv_f")
        err = lib.posit_gemv_f_launch(
            x.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(partial),
            ptr(tickets), ptr(table), M, N, K,
            0 if x.dtype == torch.float32 else 1, b.element_size(),
            fmt_w.n, fmt_w.es, int(transposed), int(p16_2), ks, splits,
            _build.stream_of(x))
        if err == _REFUSED:
            raise ValueError(f"posit_gemv_f: the {variant} kernel does not "
                             f"take {x.dtype} x {b.dtype} at M={M}")
        _build.check(err, "posit_gemv_f")
        work.count(LAUNCHES, keys)
    return out


def grouped_variant(M: int, fmt_a: PositFormat | None, fmt_b: PositFormat,
                    b_dtype) -> str:
    """K9's kernel for an [E, M, K] x [E, K, N] call.  Above GROUPED_BM
    rows with coded activations, int16 weights and an exact bf16 split of
    both formats (`split_exact`): the split-bf16 tensor-core GEMM, "tc_p13_2"
    (the P(13,2) decode table) for P(13,2) weights (every training expert
    stack), else "tc" (the run-time decode).  Otherwise the split-K GEMV:
    "p16_2", the compile-time P(16,2) decode, for int16 P(16,2) weights
    (every serving expert stack), else "posit", the run-time decode of any
    format."""
    if (M > GROUPED_BM and fmt_a is not None and b_dtype == torch.int16
            and split_exact(fmt_a, fmt_b)):
        return "tc_p13_2" if fmt_b == P13_2 else "tc"
    return ("p16_2" if (fmt_b.n, fmt_b.es) == (16, 2)
            and b_dtype == torch.int16 else "posit")


def grouped_split_k(M: int, N: int, K: int) -> tuple[int, int]:
    """(rows per split KS, number of splits S) of K9's grouped GEMV, from
    the shapes alone (never from the routing, so an expert's sums do not
    depend on the other experts' rows).  Split s covers K rows [s * KS,
    min(K, (s + 1) * KS)), in split order, none empty; S >= 1 (K = 0: one
    empty split)."""
    tiles = -(-M // GROUPED_BM) * -(-N // GEMV_BN)
    want = max(1, -(-GROUPED_EXPERT_BLOCKS // max(tiles, 1)))
    rows = -(-K // want)
    ks = min(max(-(-rows // GEMV_ROWS) * GEMV_ROWS, GEMV_ROWS), GEMV_MAX_ROWS)
    return ks, max(1, -(-K // ks))


def grouped_tc_split_k(M: int, N: int, K: int) -> tuple[int, int]:
    """(rows per split KS, number of splits S) of K9's tensor-core GEMM,
    from the shapes alone (never from E or the routing): KS a multiple of
    GROUPED_TC_BK, split s covers K rows [s * KS, min(K, (s + 1) * KS))
    (rows past K are zeros), in split order, none empty, S >= 1; an
    expert's tiles times splits come near GROUPED_TC_EXPERT_BLOCKS where K
    allows."""
    tiles = -(-M // GROUPED_TC_BM) * -(-N // GROUPED_TC_BN)
    want = max(1, -(-GROUPED_TC_EXPERT_BLOCKS // max(tiles, 1)))
    steps = max(1, -(-K // GROUPED_TC_BK))
    ks = -(-steps // min(want, steps)) * GROUPED_TC_BK
    return ks, max(1, -(-K // ks))


@functools.lru_cache(maxsize=None)
def p13_2_table() -> torch.Tensor:
    """[8192] int32, the decode table of K9's "tc_p13_2" variant: entry c
    (a 13-bit P(13,2) code) holds the bf16 bits of hi = bf16(x) in its low
    half and of lo = bf16(x - hi) in its high half, x = decode(c)
    (`split_bf16`; hi + lo == x, NaR -> nan in both).  On the CPU."""
    x = decode_plain(to_container(torch.arange(1 << 13, dtype=torch.int64),
                                  P13_2), P13_2)
    hi, lo = (t.view(torch.int16).to(torch.int64) & 0xFFFF
              for t in split_bf16(x))
    # the 32-bit pattern as int32: less 2^32 where lo's sign bit is set
    return ((hi | lo << 16) - ((lo >> 15) << 32)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _device_table(dev) -> torch.Tensor:
    """`p13_2_table()` on `dev`, uploaded once."""
    return p13_2_table().to(dev)


def occupied_rows_plain(a, fmt_a: PositFormat | None):
    """[E] int32: one past the last row of each expert's [M, K] slab that
    holds a non-zero activation (a code other than 0, a float other than
    +-0), 0 for an expert no token was routed to; the plain statement of
    K9's pre-pass.  The kernel writes zeros for the rows from there on."""
    E, M = a.shape[:2]
    if M == 0:
        return torch.zeros(E, dtype=torch.int32, device=a.device)
    vals = a if fmt_a is not None else a.to(torch.float32)
    hit = (vals != 0).any(-1)                               # [E, M]
    last = hit * torch.arange(1, M + 1, device=a.device)
    return last.amax(-1).to(torch.int32)


def posit_matmul_grouped_plain(a, b_codes, fmt_a: PositFormat | None,
                               fmt_b: PositFormat,
                               fmt_out: PositFormat | None = None):
    """Per expert: decode(A) (or the f32 activations) @ decode(B) in f32,
    then one encode to fmt_out if set."""
    out = torch.matmul(_operand(a, fmt_a), decode_plain(b_codes, fmt_b))
    return out if fmt_out is None else encode_plain(out, fmt_out)


def posit_matmul_grouped(a, b_codes, fmt_a: PositFormat | None,
                         fmt_b: PositFormat,
                         fmt_out: PositFormat | None = None):
    """[E, M, K] x [E, K, N] codes -> [E, M, N] f32 (fmt_out None) or
    fmt_out codes in their storage dtype.  fmt_a None takes `a` as float
    activations (cast to f32), otherwise `a` holds fmt_a codes.

    On the card the kernel skips, per expert, the rows from
    `occupied_rows_plain` on (the dispatch buffer's empty capacity, and
    every row of an expert no token was routed to) and writes +0.0 there
    (code 0 under fmt_out): equal to the plain version wherever no weight
    code is NaR, which packing never writes (finite values saturate).
    `grouped_variant` picks the kernel (the split-bf16 tensor-core GEMM
    for coded activations above GROUPED_BM rows, else the split-K GEMV);
    the K splits are `grouped_tc_split_k`'s or `grouped_split_k`'s."""
    if a.ndim != 3 or b_codes.ndim != 3:
        raise ValueError(f"posit_matmul_grouped takes 3-D operands, got "
                         f"{tuple(a.shape)} x {tuple(b_codes.shape)}")
    E, M, K = a.shape
    Eb, K2, N = b_codes.shape
    if E != Eb or K != K2:
        raise ValueError(f"grouped mismatch {tuple(a.shape)} x "
                         f"{tuple(b_codes.shape)}")
    if a.device.type == "cpu":
        return posit_matmul_grouped_plain(a, b_codes, fmt_a, fmt_b, fmt_out)
    if fmt_a is None:
        if not a.is_floating_point():
            raise TypeError("posit_matmul_grouped: fmt_a None takes float "
                            f"activations, got {a.dtype}")
        a = a.to(torch.float32).contiguous()
        a_kind = 0
    else:
        _check_codes("a", a, fmt_a)
        a_kind = a.element_size()
    _check_codes("b", b_codes, fmt_b)
    _build.require_cuda("posit_matmul_grouped", a, b_codes)
    dev = a.device
    if fmt_out is None:
        out = torch.empty((E, M, N), dtype=torch.float32, device=dev)
    else:
        dt = storage_dtype(fmt_out)
        if dt not in _CODE_DTYPES:
            raise ValueError(f"posit_matmul_grouped writes int8/int16 codes, "
                             f"not {dt}")
        out = torch.empty((E, M, N), dtype=dt, device=dev)
    if E and M and N:
        variant = grouped_variant(M, fmt_a, fmt_b, b_codes.dtype)
        tc = variant.startswith("tc")
        rows = torch.empty((E,), dtype=torch.int32, device=dev)
        a_split = table = None
        if tc:
            ks, splits = grouped_tc_split_k(M, N, K)
            # the activations' hi / lo bf16 tiles, split once per call
            mp = -(-M // GROUPED_TC_BM) * GROUPED_TC_BM
            a_split = torch.empty((2 * E * mp * splits * ks,),
                                  dtype=torch.bfloat16, device=dev)
            if variant == "tc_p13_2":
                table = _device_table(dev)
        else:
            ks, splits = grouped_split_k(M, N, K)
        # per-split partial sums, reduced in split order (one split of the
        # tensor-core GEMM with an f32 output writes `out` directly)
        direct = tc and splits == 1 and fmt_out is None
        partial = None if direct else torch.empty(
            (splits, E, M, N), dtype=torch.float32, device=dev)
        keys = ("posit_matmul_grouped", f"posit_matmul_grouped:{variant}")
        if work.is_meta(a):
            # shapes only: every expert's rows occupied
            work.record(keys, work.grouped(
                E, M, K, N, a.element_size(), b_codes.element_size(),
                out.element_size(), variant))
            return out
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        lib = _build.library("posit_matmul_grouped")
        err = lib.posit_matmul_grouped_launch(
            a.data_ptr(), b_codes.data_ptr(),
            out.data_ptr() if fmt_out is None else None,
            None if fmt_out is None else out.data_ptr(), rows.data_ptr(),
            ptr(partial), ptr(a_split), ptr(table), E, M, N, K, a_kind,
            fmt_a.n if fmt_a else 0, fmt_a.es if fmt_a else 0,
            b_codes.element_size(), fmt_b.n, fmt_b.es,
            0 if fmt_out is None else out.element_size(),
            fmt_out.n if fmt_out else 0, fmt_out.es if fmt_out else 0,
            _GROUPED_VARIANTS[variant], ks, splits, _build.stream_of(a))
        if err == _REFUSED:
            raise ValueError(
                f"posit_matmul_grouped: the {variant} kernel does not take "
                f"{a.dtype} activations x {b_codes.dtype} weights, or needs "
                f"more shared memory than this card gives a block")
        _build.check(err, "posit_matmul_grouped")
        work.count(LAUNCHES, keys)
    return out
