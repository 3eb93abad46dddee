"""PyTorch port vs the JAX reference: multi-query paged attention, the
4-D q [B, T, Hq, Dh] form of `ops.paged_attention` (the speculative
verify's attention; K7 on the card).

The port runs its plain version (CPU tensors); the reference runs its
Pallas multi-query kernel in interpret mode.  Same numpy inputs, seeded,
built as `tests/test_kernels.py` builds them (valid random codes of every
page, a distinct page run per slot, lengths counting the T new tokens).

Tolerances: outputs are f32 sums in another order (XLA einsum in the
streaming kernel vs a dense PyTorch softmax), held to rtol = atol = 1e-5
as in `tests/test_torch_kernels.py`; the partials' running max is held to
the same tolerance.  Within the port, the t_block tilings and the T = 1
form against the 3-D path are bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.kernels import ops as jops

from repro_torch.core import formats as tformats
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

RTOL = ATOL = 1e-5
_FMT = {"P16_1": (jformats.P16_1, tformats.P16_1),
        "P8_2": (jformats.P8_2, tformats.P8_2), None: (None, None)}


def _setup(seed=1, fmt="P16_1", B=3, T=4, Hq=4, Hkv=2, Dh=8, ps=4, M=5,
           lengths=(7, 15, 12)):
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * M
    F = Hkv * Dh
    jf, _ = _FMT[fmt]
    if jf is None:
        kp = rng.normal(0, 1, (n_pages, ps, F)).astype(np.float32)
        vp = rng.normal(0, 1, (n_pages, ps, F)).astype(np.float32)
    else:
        dt = {8: np.int8, 16: np.int16}[jf.storage_bits]

        def codes():
            c = rng.integers(0, 1 << jf.n, (n_pages, ps, F))
            c = np.where(c == jf.nar_code, 0, c)
            return (((c + (1 << (jf.storage_bits - 1)))
                     % (1 << jf.storage_bits))
                    - (1 << (jf.storage_bits - 1))).astype(dt)

        kp, vp = codes(), codes()
    bt = (1 + np.arange(B * M).reshape(B, M)).astype(np.int32)
    q = rng.normal(0, 1, (B, T, Hq, Dh)).astype(np.float32)
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _both(inputs, fmt, window, cap=0.0, page_ok=None, partials=False,
          t_block=None):
    q, kp, vp, bt, ln = inputs
    jf, tf = _FMT[fmt]
    win = np.array([window], np.int32)
    want = jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ln), jnp.asarray(win), fmt_kv=jf, softcap_val=cap,
        page_ok=None if page_ok is None else jnp.asarray(page_ok),
        partials=partials, t_block=t_block)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = tops.paged_attention(
        t(q), t(kp), t(vp), t(bt), t(ln), t(win), fmt_kv=tf,
        softcap_val=cap, page_ok=None if page_ok is None else t(page_ok),
        partials=partials, t_block=t_block)
    if not partials:
        want, got = (want,), (got,)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _close(want, got):
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t_block", [1, 2, 4, None])
def test_mq_matches_reference(t_block):
    want, got = _both(_setup(), "P16_1", 1 << 30, cap=20.0, t_block=t_block)
    _close(want, got)


CASES = {
    # name: (fmt, lengths, window, softcap, page_ok, partials)
    "window_softcap": ("P16_1", (7, 15, 12), 5, 12.0, False, False),
    "p8_2_pages": ("P8_2", (9, 20, 4), 1 << 30, 0.0, False, False),
    "float_pages": (None, (5, 17, 8), 1 << 30, 0.0, False, False),
    "partials": ("P16_1", (7, 15, 12), 1 << 30, 0.0, False, True),
    "page_ok_partials": ("P8_2", (11, 19, 14), 6, 3.0, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mq_cases_match_reference(case):
    fmt, lengths, window, cap, use_ok, partials = CASES[case]
    seed = 10 + sorted(CASES).index(case)
    inputs = _setup(seed=seed, fmt=fmt, lengths=lengths)
    ok = None
    if use_ok:
        ok = (np.random.default_rng(seed).random((3, 5)) > 0.3) \
            .astype(np.int32)
    want, got = _both(inputs, fmt, window, cap, page_ok=ok, partials=partials)
    _close(want, got)


def test_mq_zero_length_slot_gives_zeros():
    inputs = _setup(lengths=(7, 15, 0))
    (want,), (got,) = _both(inputs, "P16_1", 1 << 30, cap=20.0)
    np.testing.assert_array_equal(got[2], 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    (_, m, l) = _both(inputs, "P16_1", 1 << 30, partials=True)[1]
    assert (m[2] == np.float32(-2e38)).all() and (l[2] == 0).all()


def _port(inputs, window=1 << 30, **kw):
    q, kp, vp, bt, ln = (torch.from_numpy(np.array(a)) for a in inputs)
    win = torch.tensor([window], dtype=torch.int32)
    return q, kp, vp, bt, ln, win


def test_mq_t_block_bitwise_neutral():
    q, kp, vp, bt, ln, win = _port(_setup())
    outs = [tops.paged_attention(q, kp, vp, bt, ln, win, fmt_kv=tformats.P16_1,
                                 softcap_val=20.0, t_block=tb)
            for tb in (1, 2, 4, None)]
    for o in outs[1:]:
        assert torch.equal(outs[0], o)
    with pytest.raises(ValueError, match="t_block=3 must divide T=4"):
        tops.paged_attention(q, kp, vp, bt, ln, win, fmt_kv=tformats.P16_1,
                             t_block=3)


@pytest.mark.parametrize("partials", [False, True])
def test_mq_t1_equals_3d_path_bitwise(partials):
    q, kp, vp, bt, ln, win = _port(_setup())
    kw = dict(fmt_kv=tformats.P16_1, softcap_val=7.0, partials=partials)
    o3 = tops.paged_attention(q[:, 0], kp, vp, bt, ln - 3, win, **kw)
    o4 = tops.paged_attention(q[:, :1], kp, vp, bt, ln - 3, win, **kw)
    if not partials:
        o3, o4 = (o3,), (o4,)
    for a, b in zip(o3, o4):
        assert torch.equal(a, b[:, 0])


def test_mq_rows_equal_3d_path_at_their_lengths():
    """Row i of a T-token call is the 3-D call at length lengths - T + i + 1
    (the plain version states both densely; on the card K7 against K3 is
    held bitwise by the gpu tests)."""
    q, kp, vp, bt, ln, win = _port(_setup())
    T = q.shape[1]
    o4 = tops.paged_attention(q, kp, vp, bt, ln, win, fmt_kv=tformats.P16_1)
    for i in range(T):
        o3 = tops.paged_attention(q[:, i].contiguous(), kp, vp, bt,
                                  ln - T + i + 1, win, fmt_kv=tformats.P16_1)
        torch.testing.assert_close(o4[:, i], o3, rtol=RTOL, atol=ATOL)


# (block-table width M, page size): serving tables, the long prompt's,
# tiny and ragged ones
SPLIT_TABLES = [(16, 16), (80, 16), (5, 4), (6, 16), (3, 64), (7, 5),
                (1, 16), (0, 16)]


def _runs(M: int, ps: int, head_dim: int) -> list[list[tuple]]:
    """Each split's pieces (page, first key, end key) in the table's span,
    as the kernels cut them (`csrc/paged_attention.cu`: split s covers
    keys [s KS, (s + 1) KS), a piece is its keys on one page)."""
    ks, n_splits = tpa.attention_splits(M, ps, head_dim)
    out = []
    for s in range(n_splits):
        k0, k1 = s * ks, min(M * ps, (s + 1) * ks)
        out.append([(p, max(k0, p * ps), min(k1, (p + 1) * ps))
                    for p in range(k0 // ps, -(-k1 // ps))])
    return out


@pytest.mark.parametrize("M,ps", SPLIT_TABLES)
def test_attention_splits_cover_pages_once_in_order(M, ps):
    """K3 / K7 split a block table into S runs of SP whole pages when a
    page fits a split: the runs cover [0, M) once, ascending, none empty
    (M = 0: one), at most SPLIT_KEYS keys each unless one page is longer,
    SP from the page size alone, the same at every head_dim."""
    for head_dim in (16, 128, 256):
        ks, n_splits = tpa.attention_splits(M, ps, head_dim)
        assert ks % ps == 0
        sp = ks // ps
        assert sp >= 1 and n_splits >= 1
        runs = [list(range(s * sp, min(M, (s + 1) * sp)))
                for s in range(n_splits)]
        assert [p for run in runs for p in run] == list(range(M))
        assert all(runs) or M == 0
        assert sp * ps <= max(tpa.SPLIT_KEYS, ps)
        assert all(tpa.attention_splits(m, ps, head_dim)[0] == ks
                   for m in range(1, 90))
        assert [[p for p, _, _ in run] for run in _runs(M, ps, head_dim)] \
            == (runs if M else [[]])


def _old_splits(M: int, page_size: int) -> tuple[int, int]:
    """The split geometry before pages could be cut (pages per split,
    splits): kept where it ran, every page size that fits a split."""
    sp = max(1, tpa.SPLIT_KEYS // page_size)
    return sp, max(1, -(-M // sp))


@pytest.mark.parametrize("head_dim", [16, 32, 64, 80, 96, 128, 160, 192,
                                      224, 256])
def test_attention_splits_cut_large_pages(head_dim):
    """For every page size that divides 1024 (the engine's FLASH_CHUNK):
    the splits tile the span in order, none holds more than MAX_SPLIT_KEYS
    keys, its K and V rows fit a block's shared memory (a mirror of
    `smem_bytes`), a page that fits a split keeps the old whole-page
    geometry, and a larger page is cut into equal pieces of
    `split_key_cap(head_dim)` keys."""
    cap = tpa.split_key_cap(head_dim)
    assert cap & (cap - 1) == 0 and cap <= tpa.MAX_SPLIT_KEYS
    assert tpa.split_smem_bytes(cap, head_dim) <= tpa.BLOCK_SMEM
    for ps in (1 << k for k in range(11)):
        for M in (1, 3, 8):
            ks, n = tpa.attention_splits(M, ps, head_dim)
            assert ks <= tpa.MAX_SPLIT_KEYS
            assert tpa.split_smem_bytes(ks, head_dim) <= tpa.BLOCK_SMEM
            keys = [k for run in _runs(M, ps, head_dim)
                    for _, lo, hi in run for k in range(lo, hi)]
            assert keys == list(range(M * ps))
            whole = tpa.split_smem_bytes(ps, head_dim) <= tpa.BLOCK_SMEM \
                and ps <= tpa.MAX_SPLIT_KEYS
            if whole:
                sp, n_old = _old_splits(M, ps)
                assert (ks, n) == (sp * ps, n_old)
            else:
                assert (ks, n) == (cap, M * ps // cap)
                assert all(len(run) == 1 for run in _runs(M, ps, head_dim))
    # a page size that is not a power of two: pieces straddle pages
    assert _runs(2, 200, 128)[1] == [(0, 128, 200), (1, 200, 256)]


def _row_pages(length: int, M: int, page_size: int, window: int,
              ok_row=None) -> list[int]:
    """The pages a query row at position length - 1 visits, ascending:
    before its last page, inside its window, page_ok set (as K3's skip)."""
    n = min(M, -(-length // page_size)) if length > 0 else 0
    return [p for p in range(n)
            if p * page_size + page_size - 1 > length - 1 - window
            and (ok_row is None or ok_row[p])]


def _visits(length: int, piece: tuple, M: int, window: int, ok_row) -> bool:
    """K3's rule for a piece (page, first key, end key): it starts before
    the row's position + 1, ends inside its window, page_ok set."""
    p, lo, hi = piece
    return (p < M and lo < length and hi - 1 > length - 1 - window
            and (ok_row is None or bool(ok_row[p])))


def _split_schedule(lengths, T: int, t_block: int, M: int, page_size: int,
                   window: int, page_ok=None, head_dim: int = 8) -> dict:
    """The pieces of pages each row of a call visits, by split, as the
    kernels' grid (`csrc/paged_attention.cu`) takes them: blocks (split s,
    slot b, token tile) load the split's pieces any of their rows visits;
    a row attends the loaded pieces it visits itself.  Returns {(b, t):
    [(s, [pieces...]), ...]} over the splits in order (T = 1, t_block = 1
    is K3)."""
    runs = _runs(M, page_size, head_dim)
    out = {}
    for b, length in enumerate(lengths):
        ok_row = None if page_ok is None else page_ok[b]
        for z in range(T // t_block):
            rows = range(z * t_block, (z + 1) * t_block)
            for s, run in enumerate(runs):
                mine = {t: [pc for pc in run
                            if _visits(length - T + t + 1, pc, M, window,
                                       ok_row)]
                        for t in rows}
                loaded = {pc for pieces in mine.values() for pc in pieces}
                for t in rows:
                    out.setdefault((b, t), []).append(
                        (s, [pc for pc in run
                             if pc in loaded and pc in mine[t]]))
    return out


# (lengths counting the T new tokens, window, page_ok rows or None)
SCHEDULES = {
    "full": ([96, 17, 4, 50, 1, 33], 1 << 30, None),
    "window": ([96, 70, 9, 33, 64, 65], 20, None),
    "page_ok": ([96, 2, 50, 17, 80, 32], 1 << 30,
                [[1, 1, 0, 1, 1, 0]] * 6),
}


def _check_schedule(name, T, t_block, M, ps, head_dim, scale=1):
    """Every row visits each of its pieces exactly once, in ascending
    order and in the split that holds it; the keys it visits hold every
    key it attends and lie on the pages K3's page rule gives; a K7 row
    meets the same splits and pieces as a K3 row of the same length."""
    lengths, window, ok = SCHEDULES[name]
    lengths = [n * scale for n in lengths]
    window = window if window > 1 << 20 else window * scale
    if ok is not None:   # the pattern repeated over the table's M pages
        ok = [[row[p % len(row)] for p in range(M)] for row in ok]
    mq = _split_schedule(lengths, T, t_block, M, ps, window, ok, head_dim)
    whole = tpa.attention_splits(M, ps, head_dim)[0] % ps == 0
    for (b, t), splits in mq.items():
        length = lengths[b] - T + t + 1
        ok_row = None if ok is None else ok[b]
        k3 = _split_schedule([length], 1, 1, M, ps, window,
                             None if ok is None else [ok[b]],
                             head_dim)[(0, 0)]
        assert splits == k3
        assert [s for s, _ in splits] == list(range(len(splits)))
        pieces = [pc for _, run in splits for pc in run]
        assert pieces == sorted(set(pieces))
        pages = _row_pages(length, M, ps, window, ok_row)
        keys = {k for _, lo, hi in pieces for k in range(lo, hi)}
        attended = {k for k in range(min(length, M * ps))
                    if length - 1 - k < window
                    and (ok_row is None or ok_row[k // ps])}
        assert attended <= keys
        assert {k // ps for k in keys} <= set(pages)
        if whole:
            assert [p for p, _, _ in pieces] == pages


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("T,t_block", [(4, 1), (4, 2), (4, 4), (3, 3),
                                       (8, 8), (8, 2)])
def test_split_schedule_rows_match_k3(name, T, t_block):
    """Through the kernels' grid (blocks of t_block tokens load the pages
    any of their rows visits), every row visits each of its pages exactly
    once, in ascending order and in the split that holds it, and a K7 row
    meets the same splits and pages as a K3 row of the same length."""
    _check_schedule(name, T, t_block, 6, 16, 8)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("ps,head_dim", [(256, 128), (128, 256),
                                         (1024, 256), (200, 128)])
def test_split_schedule_cut_pages_match_k3(name, ps, head_dim):
    """The same over pages cut into several splits (lengths and windows
    scaled by 16 so that rows end inside pages and across pieces): a row
    skips the pieces past its position or before its window."""
    for T, t_block in ((4, 2), (8, 8), (3, 1)):
        _check_schedule(name, T, t_block, 6 * 16 * 16 // ps or 1, ps,
                        head_dim, scale=16)
