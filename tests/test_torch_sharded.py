"""PyTorch port vs the JAX reference: kv_pages-sharded page pools.

The port mirrors `tests/test_sharded_serving.py` on the CPU.  A sharded
pool is a list of sub-pools, shard s holding the global page ids
[s * pages_per_shard, (s + 1) * pages_per_shard); block tables keep
global ids (models/paged.py).  Here every shard is a CPU device.

  * the id contract: `PagedLayout` mapping, range errors, `for_slots`,
    `localize_ids` (the reference's under `jax.vmap` with an axis name,
    element i standing for shard i) — bitwise;
  * the page helpers under a shard (inserts, gathers, the fork) against
    the reference's under `jax.vmap` — bitwise, trash pages excluded;
  * the sharded `PageAllocator`, driven by one seeded sequence of alloc /
    share / free calls with and without `prefer_shard` through both
    packages, compared after every call — bitwise;
  * the rule helpers (`spec_for`, `mesh_axes_for`, `mesh_axis_size`,
    `tree_specs`), the reference's given a mesh stand-in of the same
    shape;
  * `merge_attn_partials` over pages split across simulated owners:
    bitwise the port's unsharded plain K3 for a slot whose pages lie on
    one owner, and within RTOL / ATOL of the reference's `paged_attention`
    in interpret mode, 3-D and 4-D q;
  * K5's plain version with `hist_pool_k/v` + `hist_bt` against the
    reference's `ops.prefill_attention_paged` with the same arguments
    (interpret mode): page writes bitwise (trash excluded), attention
    within `tests/test_torch_prefill.py`'s tolerances, and bitwise the
    port's unsharded call;
  * engine streams of the port at 2 and 4 shards against the reference's
    1-device engine at `get_tiny_serving` for the transformer, MoE and
    hybrid families with f32 and coded KV: shared and duplicate prefixes
    (copy-on-write), sampling with the reference's gumbel noise injected;
    a slot spanning every shard; the per-shard budget guard and the mesh
    validation; reclamation after an oversubscribed drain;
  * one reference subprocess (forced host devices) running its 2-device
    engine: its block tables and per-shard occupancy after every step
    equal the port's, bitwise.

Tolerances: RTOL = ATOL = 1e-6 for the merge against the reference (the
reference's own test's); K5's attention as in `test_torch_prefill.py`.
Tokens, codes, ids and allocator state are bitwise.
"""
import functools
import inspect
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.formats import P8_2 as JP8_2, P16_1 as JP16_1, \
    P16_2 as JP16_2
from repro.core.quant import QuantPolicy as JPolicy
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import paged as jpaged
from repro.parallel import sharding as jsharding
from repro.serve import PageAllocator as JAllocator
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JEngine

from repro_torch import configs as tconfigs
from repro_torch.core.formats import P8_2 as TP8_2, P16_1 as TP16_1, \
    P16_2 as TP16_2
from repro_torch.core.quant import QuantPolicy as TPolicy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import packing as tpacking
from repro_torch.models import paged as tpaged
from repro_torch.models.module import ParamSpec
from repro_torch.parallel import sharding as tsharding
from repro_torch.parallel.sharding import Mesh
from repro_torch.serve import PageAllocator as TAllocator
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServingEngine as TEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: run this module's torch work on one thread (torch's
    pool stalls when the suite's other workers hold the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cpu_mesh(n):
    return make_serving_mesh(n, devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# the id contract
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("ps,n_pages,n_shards", [(4, 12, 3), (4, 8, 2),
                                                 (16, 20, 4), (8, 9, 1)])
def test_layout_mapping_matches_reference(ps, n_pages, n_shards):
    jl = jpaged.PagedLayout(ps, n_pages, n_shards)
    tl = tpaged.PagedLayout(ps, n_pages, n_shards)
    assert (tl.pages_per_shard, tl.capacity, tl.pages_per_slot(37)) == \
        (jl.pages_per_shard, jl.capacity, jl.pages_per_slot(37))
    for g in range(-2, n_pages + 3):
        for name in ("shard_of", "local_id", "is_trash"):
            assert _outcome(getattr(tl, name), g) == \
                _outcome(getattr(jl, name), g), (name, g)
    for s in range(-1, n_shards + 2):
        for loc in range(-1, tl.pages_per_shard + 2):
            assert _outcome(tl.global_id, s, loc) == \
                _outcome(jl.global_id, s, loc), (s, loc)


def test_layout_validation_and_for_slots_match_reference():
    for args in ((4, 10, 3), (4, 4, 4), (0, 8, 1), (4, 8, 0), (4, 1, 1)):
        with pytest.raises(ValueError):
            jpaged.PagedLayout(*args)
        with pytest.raises(ValueError):
            tpaged.PagedLayout(*args)
    for batch, max_seq, ps, n_pages, ns in [(3, 17, 4, None, 1),
                                            (3, 17, 4, None, 2),
                                            (3, 17, 4, None, 3),
                                            (4, 64, 16, None, 4),
                                            (2, 64, 16, 12, 2),
                                            (5, 100, 8, None, 3)]:
        jl = jpaged.PagedLayout.for_slots(batch, max_seq, ps, n_pages,
                                          n_shards=ns)
        tl = tpaged.PagedLayout.for_slots(batch, max_seq, ps, n_pages,
                                          n_shards=ns)
        assert (tl.page_size, tl.n_pages, tl.n_shards) == \
            (jl.page_size, jl.n_pages, jl.n_shards)
        assert tl.capacity >= batch * tl.pages_per_slot(max_seq) \
            or n_pages is not None


@pytest.mark.parametrize("pps,n_shards", [(4, 2), (3, 4)])
def test_localize_ids_matches_reference(pps, n_shards):
    rng = np.random.default_rng(pps)
    ids = rng.integers(0, pps * n_shards, (3, 7)).astype(np.int32)
    shard = jpaged.PageShard(axis="s", n_shards=n_shards)
    jloc, jown = jax.vmap(lambda _: jpaged.localize_ids(jnp.asarray(ids), pps,
                                                        shard),
                          axis_name="s")(jnp.arange(n_shards))
    for s in range(n_shards):
        loc, own = tpaged.localize_ids(_t(ids), pps, s)
        assert loc.dtype == torch.int32
        np.testing.assert_array_equal(loc.numpy(), np.asarray(jloc[s]))
        np.testing.assert_array_equal(own.numpy(), np.asarray(jown[s]))


def _split(pool, n_shards, axis=0):
    return [torch.from_numpy(np.ascontiguousarray(p))
            for p in np.split(pool, n_shards, axis=axis)]


def test_sharded_page_helpers_match_reference():
    """insert_tokens / insert_chunk / insert_chunk_batched / gather_slot(s)
    / fork_page under a shard against the reference's under vmap: the
    owned pages bitwise (trash pages excluded), the gathers bitwise, and
    both equal to the single pool's."""
    rng = np.random.default_rng(5)
    ns, pps, ps, F = 2, 4, 4, 6
    P = ns * pps
    pool = rng.integers(-128, 128, (P, ps, F)).astype(np.int8)
    bt = np.array([[1, 5, 2, 0], [6, 7, 3, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([9, 3, 0], np.int32)
    vals = rng.integers(-128, 128, (3, F)).astype(np.int8)
    chunk = rng.integers(-128, 128, (3, 5, F)).astype(np.int8)
    starts = np.array([2, 0, 0], np.int32)
    jshard = jpaged.PageShard(axis="s", n_shards=ns)
    tshard = tpaged.PageShard(["cpu"] * ns)
    owned = np.array([not (g % pps == 0) for g in range(P)])
    stacked = jnp.asarray(pool.reshape(ns, pps, ps, F))

    def vm(fn):
        return np.asarray(jax.vmap(fn, axis_name="s")(stacked)).reshape(
            P, *pool.shape[1:])

    cases = {
        "insert_tokens": (
            lambda p: jpaged.insert_tokens(p, jnp.asarray(bt),
                                           jnp.asarray(lengths),
                                           jnp.asarray(vals), shard=jshard),
            lambda p, sh: tpaged.insert_tokens(p, _t(bt), _t(lengths),
                                               _t(vals), shard=sh)),
        "insert_chunk": (
            lambda p: jpaged.insert_chunk(p, jnp.asarray(bt[0]), 2,
                                          jnp.asarray(chunk[0]),
                                          shard=jshard),
            lambda p, sh: tpaged.insert_chunk(p, _t(bt[0]), 2, _t(chunk[0]),
                                              shard=sh)),
        "insert_chunk_batched": (
            lambda p: jpaged.insert_chunk_batched(
                p, jnp.asarray(bt), jnp.asarray(starts), jnp.asarray(chunk),
                shard=jshard),
            lambda p, sh: tpaged.insert_chunk_batched(
                p, _t(bt), _t(starts), _t(chunk), shard=sh)),
    }
    for name, (jfn, tfn) in cases.items():
        want = vm(jfn)
        subs = _split(pool.copy(), ns)
        got = torch.cat(tfn(subs, tshard)).numpy()
        np.testing.assert_array_equal(got[owned], want[owned], err_msg=name)
        single = tfn(_t(pool), None).numpy()
        np.testing.assert_array_equal(got[owned], single[owned],
                                      err_msg=name)
    # gathers: the reference's psum of owned rows == the single pool's
    # gather (sub-pools allocated apart: the global pool is their copy)
    want = np.asarray(jax.vmap(lambda p: jpaged.gather_slots(
        p, jnp.asarray(bt), shard=jshard), axis_name="s")(stacked))[0]
    got = tpaged.gather_slots(_split(pool, ns), _t(bt), shard=tshard)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tpaged.gather_slots(_t(pool), _t(bt)).numpy())
    got1 = tpaged.gather_slot(_split(pool, ns), _t(bt[1]), shard=tshard)
    np.testing.assert_array_equal(got1.numpy(), want[1])
    # fork across shards (src 2 on shard 0, dst 6 on shard 1) and within
    layered = rng.integers(-128, 128, (3, P, ps, F)).astype(np.int8)
    for dst, src in ((6, 2), (3, 1), (1, 7)):
        want = np.asarray(jax.vmap(
            lambda p: jpaged.fork_page(p, jnp.int32(dst), jnp.int32(src),
                                       shard=jshard), axis_name="s")(
            jnp.asarray(layered.reshape(3, ns, pps, ps, F).swapaxes(0, 1))))
        want = want.swapaxes(0, 1).reshape(layered.shape)
        subs = _split(layered.copy(), ns, axis=1)
        got = torch.cat(tpaged.fork_page(subs, dst, src, shard=tshard),
                        1).numpy()
        np.testing.assert_array_equal(got[:, owned], want[:, owned])
        np.testing.assert_array_equal(got[:, dst], layered[:, src])


@pytest.mark.parametrize("family", ["transformer", "hybrid"])
def test_global_pool_views_one_device_pool(family):
    """init_cache lays the shards of one device out as consecutive blocks
    of one tensor: global_pool gives a layer's global pool as a view of it
    (a write through a sub-pool shows there), equal to the concatenation;
    a pool on another device, or sub-pools allocated apart, is copied."""
    from repro_torch.models import api as tapi
    cfg = tconfigs.get_tiny_serving(ARCHS[family])
    layout = tpaged.PagedLayout(4, 12, 3)
    shard = tpaged.PageShard(["cpu"] * 3)
    cache = tapi.init_cache(cfg, 2, 16, layout, device="cpu", shard=shard)
    for key in ("k", "v"):
        subs = tpaged.layer_pools(cache[key], 0)
        assert [tuple(t.shape[:1]) for t in subs] == [(4,)] * 3
        glob = tpaged.global_pool(subs, "cpu")
        assert glob.data_ptr() == subs[0].data_ptr()
        subs[2][1].fill_(7)
        assert torch.equal(glob, torch.cat(subs)) and bool(
            (glob[9] == 7).all())
        apart = [t.clone() for t in subs]
        copy = tpaged.global_pool(apart, "cpu")
        assert torch.equal(copy, glob)
        assert copy.data_ptr() != apart[0].data_ptr()
        assert tpaged.global_pool(subs, "meta").device.type == "meta"


# ---------------------------------------------------------------------------
# the sharded allocator, call by call
# ---------------------------------------------------------------------------


def _alloc_state(a):
    return (a._free, a._refs, a.capacity, a.pages_per_shard, a.pages_free,
            a.pages_in_use, a.pages_free_by_shard, a.pages_in_use_by_shard,
            a.peak_in_use, a.total_allocs)


@pytest.mark.parametrize("n_pages,n_shards,seed", [(12, 3, 0), (16, 4, 1),
                                                   (10, 2, 2), (9, 1, 3)])
def test_sharded_allocator_matches_reference_call_by_call(n_pages, n_shards,
                                                          seed):
    rng = np.random.default_rng(seed)
    ja, ta = JAllocator(n_pages, n_shards), TAllocator(n_pages, n_shards)
    held = []
    for _ in range(300):
        op = rng.integers(0, 4)
        if op <= 1:
            n = int(rng.integers(0, 6))
            prefer = (int(rng.integers(0, n_shards))
                      if op == 1 else None)
            got = ta.alloc(n, prefer_shard=prefer)
            assert got == ja.alloc(n, prefer_shard=prefer)
            if got:
                held.extend(got)
        elif op == 2 and held:
            pages = [held[i] for i in rng.choice(len(held),
                                                 min(2, len(held)), False)]
            ta.share(pages)
            ja.share(pages)
            held.extend(pages)
        elif held:
            i = int(rng.integers(0, len(held)))
            assert ta.free([held[i]]) == ja.free([held[i]])
            held.pop(i)
        assert _alloc_state(ta) == _alloc_state(ja)
        for p in range(n_pages):
            assert ta.shard_of(p) == ja.shard_of(p)
            assert ta.refcount(p) == ja.refcount(p)
    for pages, fn in (([0], "share"), ([n_pages - 1], "free")):
        if ja.refcount(pages[0]) == 0:
            with pytest.raises(ValueError):
                getattr(ta, fn)(pages)
            with pytest.raises(ValueError):
                getattr(ja, fn)(pages)


def test_sharded_allocator_rejects_bad_shapes():
    for args in ((10, 3), (4, 4), (1, 1)):
        with pytest.raises(ValueError):
            JAllocator(*args)
        with pytest.raises(ValueError):
            TAllocator(*args)


# ---------------------------------------------------------------------------
# the rule helpers
# ---------------------------------------------------------------------------


def _jmesh(names, sizes):
    """The reference's helpers read `mesh.shape` alone: a stand-in of the
    same axes (the test process's JAX has one device)."""
    return types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                 axis_names=tuple(names))


@pytest.mark.parametrize("names,sizes", [(("model",), (2,)),
                                         (("data",), (1,)),
                                         (("data", "model"), (2, 4)),
                                         (("pod", "data", "model"), (2, 2, 2))])
def test_rule_helpers_match_reference(names, sizes):
    tm = Mesh(names, sizes, ["cpu"] * int(np.prod(sizes)))
    jm = _jmesh(names, sizes)
    for logical in ("kv_pages", "kv_heads", "batch", "layers", "embed"):
        assert tsharding.mesh_axes_for(logical, tm) == \
            jsharding.mesh_axes_for(logical, jm)
        assert tsharding.mesh_axis_size(logical, tm) == \
            jsharding.mesh_axis_size(logical, jm)
    shapes = [((2, 8, 4, 4), ("layers", "kv_pages", None, "kv_heads")),
              ((2, 7, 4, 4), ("layers", "kv_pages", None, "kv_heads")),
              ((8, 16), ("batch", "embed")), ((6, 4), ("batch", "mlp")),
              ((3, 12), ("kv_pages", "kv_seq"))]
    for shape, axes in shapes:
        assert tsharding.spec_for(shape, axes, tm) == \
            tuple(jsharding.spec_for(shape, axes, jm)), (shape, axes)
    rules = tsharding.ShardingRules().replace(kv_pages=("data", "model"))
    jrules = jsharding.ShardingRules().replace(kv_pages=("data", "model"))
    assert tsharding.spec_for((2, 8, 4, 4), shapes[0][1], tm, rules) == \
        tuple(jsharding.spec_for((2, 8, 4, 4), shapes[0][1], jm, jrules))
    tree = {"k": ParamSpec((2, 8, 4, 4), shapes[0][1], "zeros", torch.int8),
            "length": ParamSpec((8,), ("batch",), "zeros", torch.int32)}
    got = tsharding.tree_specs(tree, tm)
    assert got == {k: tsharding.spec_for(v.shape, v.logical_axes, tm)
                   for k, v in tree.items()}


def test_kv_pages_rule_on_a_model_mesh():
    """The reference's multi-device rule test, on the port's mesh: kv_pages
    takes 'model', kv_heads then finds it taken, a page count 'model'
    does not divide falls back to replicated."""
    m = _cpu_mesh(2)
    assert m.shape == {"model": 2} and m.devices == (torch.device("cpu"),) * 2
    assert tsharding.mesh_axes_for("kv_pages", m) == ("model",)
    assert tsharding.mesh_axis_size("kv_pages", m) == 2
    axes = ("layers", "kv_pages", None, "kv_heads")
    assert tsharding.spec_for((2, 8, 4, 4), axes, m) == \
        (None, "model", None, None)
    assert tsharding.spec_for((2, 7, 4, 4), axes, m) == \
        (None, None, None, "model")
    one = Mesh(("data",), (1,), ["cpu"])
    assert tsharding.mesh_axes_for("kv_pages", one) == ()
    assert tsharding.mesh_axis_size("kv_pages", one) == 1
    assert tsharding.spec_for((2, 8, 4, 4), axes, one) == (None,) * 4
    with pytest.raises(ValueError):
        Mesh(("data", "model"), (2, 2), ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_serving_mesh(2)


# ---------------------------------------------------------------------------
# the log-sum-exp merge of per-owner partials
# ---------------------------------------------------------------------------


def _merge_inputs(four_d):
    rng = np.random.default_rng(0)
    B, T, Hq, Hkv, Dh, ps = 3, 4, 2, 1, 4, 4
    n_pages = 8
    k = rng.normal(size=(n_pages, ps, Hkv * Dh)).astype(np.float32)
    v = rng.normal(size=(n_pages, ps, Hkv * Dh)).astype(np.float32)
    q = rng.normal(size=(B, T, Hq, Dh) if four_d else (B, Hq, Dh)) \
        .astype(np.float32)
    bt = np.array([[1, 2, 3, 0],     # split across owners
                   [4, 5, 0, 0],     # entirely owner-1 pages
                   [6, 7, 1, 2]], np.int32)
    lengths = np.array([11, 6, 15], np.int32)
    return q, k, v, bt, lengths


@pytest.mark.parametrize("four_d", [False, True], ids=["3d", "4d"])
@pytest.mark.parametrize("owners", [2, 4])
def test_merge_partials_matches_full_kernel(four_d, owners):
    """The plain K3 over one pool with complementary page_ok masks, merged:
    the reference's full kernel within RTOL / ATOL, and bitwise the port's
    full plain K3 for slot 1, whose pages all lie on one owner."""
    q, k, v, bt, lengths = _merge_inputs(four_d)
    window = np.full((1,), 1 << 30, np.int32)
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(lengths), jnp.full((3,), 1 << 30, jnp.int32)))
    args = [_t(a) for a in (q, k, v, bt, lengths, window)]
    full = tops.paged_attention(*args)
    groups = {2: [[1, 2, 3], [4, 5, 6, 7]],
              4: [[1, 2], [3], [4, 5], [6, 7]]}[owners]
    parts = [tops.paged_attention(
        *args, page_ok=_t(np.isin(bt, g).astype(np.int32)), partials=True)
        for g in groups]
    merged = tops.merge_attn_partials(*([p[j] for p in parts]
                                        for j in range(3)))
    np.testing.assert_allclose(merged.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(full.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(merged[1].numpy(), full[1].numpy())
    # stacked partials merge to the same values as the lists
    stacked = tops.merge_attn_partials(
        *(torch.stack([p[j] for p in parts]) for j in range(3)))
    assert torch.equal(stacked, merged)
    with pytest.raises(ValueError):
        tops.merge_attn_partials(parts[0][0][None], parts[0][1][None],
                                 parts[0][2][None, :1])


# ---------------------------------------------------------------------------
# K5 with global history
# ---------------------------------------------------------------------------

HQ, HKV, DH, PS, M, NS = 4, 2, 8, 4, 6, 2
# name: (fmt, compute dtype, activation dtype, C, starts, flash_chunk)
K5_CASES = {
    "p16_1_f32": ("p16_1", "f32", "f32", 8, [0, 5, 13], 1024),
    "p8_2_bf16": ("p8_2", "bf16", "bf16", 8, [2, 9], 1024),
    "f32_pool": (None, "f32", "f32", 4, [3, 11], 1024),
    "streaming": ("p16_1", "f32", "f32", 4, [9, 17], 8),
}
FMTS = {"p16_1": (JP16_1, TP16_1), "p8_2": (JP8_2, TP8_2), None: (None, None)}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pool(rng, fmt, shape):
    if fmt is None:
        return rng.normal(0, 1, shape).astype(np.float32)
    jf = FMTS[fmt][0]
    raw = rng.integers(0, 1 << jf.n, shape)
    raw = np.where(raw == jf.nar_code, 0, raw)
    w = jf.storage_bits
    half = 1 << (w - 1)
    return (((raw + half) & ((1 << w) - 1)) - half).astype(
        np.int8 if w == 8 else np.int16)


def _k5_inputs(seed, fmt, C, starts):
    """A global pool of NS shards of pps pages; slot b's pages alternate
    between the shards, so every slot spans both."""
    rng = np.random.default_rng(seed)
    B = len(starts)
    pps = 1 + -(-B * M // NS)
    n_pages = NS * pps
    F = HKV * DH
    pk, pv = _pool(rng, fmt, (n_pages, PS, F)), _pool(rng, fmt,
                                                     (n_pages, PS, F))
    free = [[s * pps + i for i in range(1, pps)] for s in range(NS)]
    bt = np.zeros((B, M), np.int32)
    for b in range(B):
        for j in range(-(-(starts[b] + C) // PS)):
            bt[b, j] = free[(b + j) % NS].pop(0)
    q = rng.normal(0, 1, (B, C, HQ, DH)).astype(np.float32)
    k = rng.normal(0, 1, (B, C, HKV, DH)).astype(np.float32)
    v = rng.normal(0, 1, (B, C, HKV, DH)).astype(np.float32)
    return pk, pv, bt, pps, q, k, v


@pytest.mark.parametrize("name", sorted(K5_CASES))
def test_prefill_global_history_matches_reference(name):
    """Each shard's call: history from the global pool by global id, writes
    into its own sub-pool through the localized table and page_ok — the
    reference's call with the same arguments."""
    fmt, compute, act, C, starts, chunk = K5_CASES[name]
    pk, pv, bt, pps, q, k, v = _k5_inputs(sorted(K5_CASES).index(name), fmt,
                                          C, starts)
    jf, tf = FMTS[fmt]
    (jcd, tcd), (jad, tad) = DT[compute], DT[act]
    w = np.full((1,), 2 ** 30, np.int32)
    st = np.asarray(starts, np.int32)

    def tpool(a):
        t = torch.from_numpy(a.copy())
        return t.to(tcd) if fmt is None else t

    def jpool(a):
        return jnp.asarray(a, jcd) if fmt is None else jnp.asarray(a)

    tq, tk, tv = (torch.from_numpy(a).to(tad) for a in (q, k, v))
    kw = dict(fmt_kv=tf, compute_dtype=tcd, flash_chunk=chunk)
    # the unsharded call over the global pool
    ref_attn, _, _ = tops.prefill_attention_paged(
        tq, tk, tv, tpool(pk), tpool(pv), _t(bt), _t(st), _t(w), **kw)
    for s in range(NS):
        lo = s * pps
        loc = np.where((bt >= lo) & (bt < lo + pps), bt - lo, 0) \
            .astype(np.int32)
        ok = ((bt >= lo) & (bt < lo + pps)).astype(np.int32)
        want_attn, want_k, want_v = jops.prefill_attention_paged(
            jnp.asarray(q, jad), jnp.asarray(k, jad), jnp.asarray(v, jad),
            jpool(pk[lo:lo + pps]), jpool(pv[lo:lo + pps]), jnp.asarray(loc),
            jnp.asarray(st), jnp.asarray(w), fmt_kv=jf, compute_dtype=jcd,
            flash_chunk=chunk, hist_pool_k=jpool(pk), hist_pool_v=jpool(pv),
            hist_bt=jnp.asarray(bt), page_ok=jnp.asarray(ok))
        sub_k, sub_v = tpool(pk[lo:lo + pps]), tpool(pv[lo:lo + pps])
        got_attn, got_k, got_v = tops.prefill_attention_paged(
            tq, tk, tv, sub_k, sub_v, _t(loc), _t(st), _t(w),
            hist_pool_k=tpool(pk), hist_pool_v=tpool(pv), hist_bt=_t(bt),
            page_ok=_t(ok), **kw)
        assert got_k is sub_k and got_attn.dtype == tq.dtype
        f32 = lambda x: np.asarray(x, np.float32) if not isinstance(  # noqa
            x, torch.Tensor) else x.to(torch.float32).numpy() \
            if x.is_floating_point() else x.numpy()
        want_k = np.asarray(want_k.astype(jnp.float32)) if fmt is None \
            else np.asarray(want_k)
        want_v = np.asarray(want_v.astype(jnp.float32)) if fmt is None \
            else np.asarray(want_v)
        np.testing.assert_array_equal(f32(got_k)[1:], want_k[1:])
        np.testing.assert_array_equal(f32(got_v)[1:], want_v[1:])
        wa = np.asarray(want_attn.astype(jnp.float32))
        if act == "bf16":
            np.testing.assert_allclose(f32(got_attn), wa, rtol=2.0 ** -7,
                                       atol=0)
        else:
            np.testing.assert_allclose(f32(got_attn), wa, rtol=5e-5,
                                       atol=5e-5 * np.abs(wa).max())
        # the same history bytes: bitwise the unsharded call
        assert torch.equal(got_attn, ref_attn)


def test_prefill_global_history_validation():
    pk, pv, bt, pps, q, k, v = _k5_inputs(9, "p16_1", 4, [0, 3])
    base = [_t(a) for a in (q, k, v, pk, pv, bt)] + [
        torch.tensor([0, 3], dtype=torch.int32),
        torch.tensor([2 ** 30], dtype=torch.int32)]
    with pytest.raises(ValueError, match="hist_bt"):
        tops.prefill_attention_paged(*base, fmt_kv=TP16_1,
                                     hist_pool_k=_t(pk), hist_pool_v=_t(pv))
    with pytest.raises(ValueError, match="page shape"):
        tops.prefill_attention_paged(*base, fmt_kv=TP16_1,
                                     hist_pool_k=_t(pk[:, :2]),
                                     hist_pool_v=_t(pv[:, :2]),
                                     hist_bt=_t(bt))


# ---------------------------------------------------------------------------
# the engine at get_tiny_serving
# ---------------------------------------------------------------------------

ARCHS = {"transformer": "command_r_35b", "moe": "qwen3_moe_235b",
         "hybrid": "jamba_1_5_large"}


def _policies(kv):
    if kv == "f32":
        return JPolicy(), TPolicy()
    return (JPolicy(weights=JP16_2, kv_cache=JP8_2),
            TPolicy(weights=TP16_2, kv_cache=TP8_2))


@functools.lru_cache(maxsize=None)
def _model(family, kv):
    jq, tq = _policies(kv)
    arch = ARCHS[family]
    jcfg = jconfigs.get_tiny_serving(arch, jq)
    tcfg = tconfigs.get_tiny_serving(arch, tq)
    jparams = jax.jit(lambda key: japi.init(key, jcfg))(jax.random.key(0))
    tparams = tpacking.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _jax_noise(base_seed):
    base = jax.random.key(base_seed)

    def noise_fn(seed, draw, vocab):
        key = jax.random.fold_in(jax.random.fold_in(base, seed), draw)
        return np.asarray(japi.sample_noise(key[None], vocab))[0]

    return noise_fn


def _queue(vocab):
    """Mixed lengths: a donor, its exact duplicate (copy-on-write of the
    tail page), a 58-token prompt (16 pages with its new tokens: more than
    three shards of 4 hold, so it spans all of them), a prompt sharing two
    full pages, an unrelated one."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, 11).astype(np.int32)
    return [base.copy(), base.copy(),
            rng.integers(0, vocab, 58).astype(np.int32),
            np.concatenate([base[:8], rng.integers(0, vocab, 5)
                            .astype(np.int32)]),
            rng.integers(0, vocab, 6).astype(np.int32)]


def _serve(eng, req_cls, prompts, new=6):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new_tokens=new))
    return {r.rid: list(map(int, r.out_tokens)) for r in eng.run()}


def _serve_spans(eng, prompts, new=6):
    """`_serve` on the port, also returning the most shards any slot's
    pages covered after a step."""
    for i, p in enumerate(prompts):
        eng.submit(TRequest(rid=i, prompt=p.copy(), max_new_tokens=new))
    widest = 0
    while eng.step():
        for pages in eng.slot_pages:
            widest = max(widest, len({eng.allocator.shard_of(p)
                                      for p in pages}))
    return {r.rid: list(map(int, r.out_tokens)) for r in eng.done}, widest


def _drained(eng):
    a = eng.allocator
    assert a.pages_in_use == 0 and a.pages_in_use_by_shard == [0] * a.n_shards
    assert a.pages_free_by_shard == [a.pages_per_shard - 1] * a.n_shards
    assert not a._refs and not eng._held and not eng.prefix_index
    assert all(not p for p in eng.slot_pages)


# pages of 4 and chunks of 4 and 1: the 8-token shared prefix ends on a
# page and a chunk boundary (a hybrid maps a prefix only there); 24 pages:
# at 4 shards 5 usable a shard
ENGINE = dict(batch_slots=2, max_seq=64, page_size=4, prefill_buckets=(4, 1),
              n_pages=24, greedy=False, temperature=0.8, top_k=8,
              base_seed=3)


@pytest.mark.parametrize("kv", ["f32", "coded"])
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_mesh_engine_token_parity(family, kv):
    """The port at 2 and 4 shards emits the reference 1-device engine's
    streams on a queue with shared and duplicate prefixes and a slot that
    spans every shard (prefilled by the fused kernel from the gathered
    global pool), greedy over f32 pages and sampling with the reference's
    noise over coded ones, and reclaims every shard's pages."""
    jcfg, tcfg, jparams, tparams = _model(family, kv)
    prompts = _queue(jcfg.vocab_size)
    # greedy over f32 pages, sampled over coded ones
    kw = dict(ENGINE, greedy=kv == "f32")
    jeng = JEngine(jcfg, jparams, **kw)
    want = _serve(jeng, JRequest, prompts)
    for n in (2, 4):
        teng = TEngine(tcfg, tparams, mesh=_cpu_mesh(n), device="cpu",
                       noise_fn=_jax_noise(ENGINE["base_seed"]), **kw)
        assert teng.n_shards == n and teng.layout.n_shards == n
        assert len(teng.cache["k"]) == n
        assert teng.execution_summary()["fused_prefill"]
        got, widest = _serve_spans(teng, prompts)
        assert got == want, n
        assert widest == n
        for key in ("shared_admissions", "pages_shared", "cow_forks"):
            assert teng.stats[key] == jeng.stats[key], key
        assert teng.stats["shared_admissions"] >= 1
        s = teng.execution_summary()
        assert s["kv_shards"] == n and s["pages_in_use_by_shard"] == [0] * n
        assert teng.kv_cache_summary()["pages_in_use_by_shard"] == [0] * n
        _drained(teng)


def test_mesh_engine_budget_guard_and_validation():
    """Admission rejects a request the per-shard budgets cannot hold (one
    trash page per shard), naming them; the same pool unsharded admits
    it; meshes the kv_pages rule does not cover, a pool the shard count
    does not divide and speculation over shards raise; a 1-shard mesh and
    an SSM engine ignore the mesh."""
    _, tcfg, _, tparams = _model("transformer", "coded")
    ps = tcfg.quant.kv_page_size
    big = TRequest(rid=0, prompt=np.zeros(2 * ps + 1, np.int32),
                   max_new_tokens=ps)
    eng = TEngine(tcfg, tparams, batch_slots=1, max_seq=4 * ps, n_pages=4,
                  mesh=_cpu_mesh(2), device="cpu")
    assert eng.allocator.capacity == 2
    with pytest.raises(ValueError, match="2 per-device budgets of 1 pages"):
        eng.submit(big)
    TEngine(tcfg, tparams, batch_slots=1, max_seq=4 * ps, n_pages=4,
            device="cpu").submit(big)
    data = Mesh(("data", "model"), (2, 1), ["cpu"] * 2)
    with pytest.raises(ValueError, match="kv_pages"):
        TEngine(tcfg, tparams, batch_slots=1, max_seq=4 * ps, mesh=data,
                device="cpu")
    both = Mesh(("data", "model"), (2, 2), ["cpu"] * 4)
    rules_both = tsharding.ShardingRules().replace(kv_pages=("data", "model"))
    assert tsharding.mesh_axes_for("kv_pages", both, rules_both) == \
        ("data", "model")
    with pytest.raises(ValueError, match="divide"):
        TEngine(tcfg, tparams, batch_slots=1, max_seq=4 * ps, n_pages=5,
                mesh=_cpu_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="sharded page pools"):
        TEngine(tcfg, tparams, batch_slots=1, max_seq=4 * ps, speculate_k=3,
                mesh=_cpu_mesh(2), device="cpu")
    one = TEngine(tcfg, tparams, batch_slots=1, max_seq=4 * ps,
                  mesh=_cpu_mesh(1), device="cpu")
    assert one.n_shards == 1 and one.mesh is None
    dense = TEngine(tcfg, tparams, batch_slots=1, max_seq=4 * ps,
                    paged=False, mesh=data, device="cpu")
    assert dense.n_shards == 1 and dense.mesh is None


def test_mesh_engine_reclaims_after_oversubscribed_drain():
    """A queue larger than the pool (admission waits for reclaimed pages,
    slots spill across shards) drains completely at 2 shards, with the
    streams of the unsharded pool."""
    _, tcfg, _, tparams = _model("transformer", "coded")
    ps = tcfg.quant.kv_page_size
    rng = np.random.default_rng(3)
    base = rng.integers(0, tcfg.vocab_size, 2 * ps).astype(np.int32)
    reqs = []
    for i in range(6):
        tail = rng.integers(0, tcfg.vocab_size,
                            rng.integers(1, 2 * ps)).astype(np.int32)
        reqs.append((np.concatenate([base, tail]) if i % 2 else tail,
                     int(rng.integers(1, ps))))

    def run(mesh):
        eng = TEngine(tcfg, tparams, batch_slots=2, max_seq=6 * ps, n_pages=8,
                      mesh=mesh, device="cpu")
        for i, (p, n) in enumerate(reqs):
            eng.submit(TRequest(rid=i, prompt=p, max_new_tokens=n))
        return {r.rid: list(map(int, r.out_tokens)) for r in eng.run()}, eng

    got, eng = run(_cpu_mesh(2))
    assert len(got) == 6 and got == run(None)[0]
    _drained(eng)
    assert eng.execution_summary()["pages_in_use_by_shard"] == [0, 0]


# ---------------------------------------------------------------------------
# the reference's 2-device engine: block tables and occupancy, step by step
# ---------------------------------------------------------------------------

# 2 shards of 5 pages of 4 tokens: 8 usable pages against requests of up
# to 7 (the queue waits for reclaimed pages, and slots spill)
_TRACE_QUEUE = dict(batch_slots=2, max_seq=32, n_pages=10, page_size=4,
                    prefill_buckets=(4, 1))


def _trace_requests(vocab):
    rng = np.random.default_rng(4)
    base = rng.integers(0, vocab, 8).astype(np.int32)
    out = []
    for i in range(7):
        tail = rng.integers(0, vocab, int(rng.integers(1, 13))) \
            .astype(np.int32)
        out.append((np.concatenate([base, tail]) if i % 3 else tail,
                    int(rng.integers(1, 9))))
    return out


def _trace(eng, reqs, req_cls):
    """Block tables and per-shard occupancy after every engine step."""
    for i, (p, n) in enumerate(reqs):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new_tokens=n))
    steps = []
    while eng.step():
        steps.append([eng.block_tables.tolist(),
                      list(eng.allocator.pages_in_use_by_shard)])
    return steps


def test_block_tables_match_reference_two_device_engine():
    """The reference's engine on a forced 2-device host mesh (one
    subprocess) and the port's at 2 CPU shards, on an oversubscribed queue
    with shared prefixes: equal block tables and per-shard occupancy after
    every step.  Allocation does not depend on the generated tokens (no
    eos), so each side draws its own weights."""
    code = textwrap.dedent("""
        import json
        import jax, numpy as np
        from repro import configs
        from repro.core.quant import QuantPolicy
        from repro.models import api
        from repro.serve import Request, ServingEngine
        from repro.launch.mesh import make_serving_mesh
        _TRACE_QUEUE = {queue!r}
    """).format(queue=_TRACE_QUEUE) + "\n".join(
        textwrap.dedent(inspect.getsource(f))
        for f in (_trace_requests, _trace)) + textwrap.dedent("""
        cfg = configs.get_tiny_serving("command_r_35b", QuantPolicy())
        params = api.init(jax.random.key(1), cfg)
        eng = ServingEngine(cfg, params, mesh=make_serving_mesh(2),
                            **_TRACE_QUEUE)
        assert eng.n_shards == 2
        reqs = _trace_requests(cfg.vocab_size)
        print("TRACE" + json.dumps(_trace(eng, reqs, Request)))
    """)
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    want = json.loads(r.stdout.split("TRACE", 1)[1])
    _, tcfg, _, tparams = _model("transformer", "f32")
    eng = TEngine(tcfg, tparams, mesh=_cpu_mesh(2), device="cpu",
                  **_TRACE_QUEUE)
    got = _trace(eng, _trace_requests(tcfg.vocab_size), TRequest)
    assert got == want
    assert any(len({b // 5 for b in row if b}) > 1
               for step, _ in got for row in step), "no slot spilled"
    _drained(eng)
