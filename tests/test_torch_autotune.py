"""PyTorch port vs the JAX reference: the kernel autotune cache
(`kernels/autotune.py`), its dispatch-time resolution (`kernels/ops.py`
`_resolve`) and the sweep CLI (`launch/autotune.py`), on the CPU, after
the pattern of `tests/test_autotune.py`.

Keys, buckets and digests are held equal to the reference's on the same
inputs and the same backend string.  The only tunable knob, K7's
`t_block`, changes no value bit, so resolution through any cache contents
leaves outputs bitwise unchanged; on the CPU the plain version ignores the
tile, so these tests observe the resolved value through a spy on the
kernel wrapper and the hit / miss accounting.  The sweep itself times on
a card (`tests/test_torch_gpu.py`, `chip_smoke.py` phase 16c).
"""
import json

import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.kernels import autotune as jautotune

from repro_torch.core import formats
from repro_torch.core import posit
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import autotune as launch_autotune

H100 = "cuda:NVIDIA H100 80GB HBM3"


@pytest.fixture
def scratch_cache():
    """Restore the process-wide cache after a test swaps it out."""
    yield
    autotune.reset_cache(None)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 8, 9, 1000), (256,), (4, 4, 16, 16,
                                                              1024), (0, 3)])
def test_shape_bucket_matches_reference(shape):
    assert autotune.shape_bucket(shape) == jautotune.shape_bucket(shape)


@pytest.mark.parametrize("fmts", [("P16_2", None), ("P8_2",), (None,),
                                  ("P16_1", "P13_2")])
@pytest.mark.parametrize("backend", [H100, "cpu"])
def test_keys_and_digests_match_reference(fmts, backend):
    """make_key and key_digest: equal to the reference's for the same
    shape, formats and backend string, in every kernel name."""
    tf = tuple(None if f is None else getattr(formats, f, None)
               or formats.PositFormat(13, 2) for f in fmts)
    jf = tuple(None if f is None else getattr(jformats, f, None)
               or jformats.PositFormat(13, 2) for f in fmts)
    shape = (200, 300, 100, 7, 1024)
    key = autotune.make_key(shape, tf)
    assert key == jautotune.make_key(shape, jf)
    for kernel in ("paged_attention", "posit_matmul", "decode_sample"):
        assert autotune.key_digest(kernel, backend, key) == \
            jautotune.key_digest(kernel, backend, key)


def test_key_digest_stable_and_discriminating():
    key = autotune.make_key((4, 4, 16, 16, 1024), (formats.P8_2,))
    d = autotune.key_digest("paged_attention", H100, key)
    same = autotune.make_key((3, 3, 9, 9, 1000), (formats.P8_2,))
    assert autotune.key_digest("paged_attention", H100, same) == d
    assert autotune.key_digest("posit_matmul", H100, key) != d
    assert autotune.key_digest("paged_attention", "cpu", key) != d
    other = autotune.make_key((4, 4, 16, 16, 1024), (formats.P16_1,))
    assert autotune.key_digest("paged_attention", H100, other) != d


def test_backend_names_the_device():
    want = (f"cuda:{torch.cuda.get_device_name(0)}"
            if torch.cuda.is_available() else "cpu")
    assert autotune.backend_name() == want
    assert autotune.AutotuneCache().backend == want


def test_tunables_change_no_value_bit():
    """Only K7's query-token tile is tunable; the candidates are the
    reference's; split counts (sum orders) are not knobs."""
    assert autotune.TUNABLES == {"paged_attention": {"t_block": (1, 2, 4,
                                                                 8)}}
    assert autotune.TUNABLES["paged_attention"] == \
        jautotune.TUNABLES["paged_attention"]
    assert list(autotune.candidates("paged_attention")) == \
        list(jautotune.candidates("paged_attention"))


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------


def test_cache_roundtrip_and_hit_accounting(tmp_path):
    c = autotune.AutotuneCache(backend="cpu")
    c.put("paged_attention", (4, 8, 8, 16, 128), {"t_block": 2},
          fmts=(formats.P16_1,), ms=1.0)
    path = c.save(str(tmp_path / "sub" / "cache.json"))
    loaded = autotune.AutotuneCache.load(path)
    loaded.backend = "cpu"
    assert loaded.lookup("paged_attention", (3, 5, 7, 9, 100),
                         (formats.P16_1,)) == {"t_block": 2}
    assert loaded.lookup("paged_attention", (3, 5, 7, 9, 100),
                         (formats.P8_2,)) is None
    assert loaded.report() == {"paged_attention": {"hits": 1, "misses": 1}}
    with open(path) as f:
        raw = json.load(f)
    assert raw["version"] == autotune.CACHE_VERSION
    assert raw["generated_by"] == "launch/autotune.py"
    for digest, ent in raw["entries"].items():
        assert digest == autotune.key_digest(ent["kernel"], raw["backend"],
                                             ent["key"])


def test_reference_written_cache_reads_in_the_port(tmp_path):
    """A cache the reference's class writes for a backend reads back in
    the port's under the same backend string (one schema, one digest)."""
    c = jautotune.AutotuneCache(backend=H100)
    c.put("paged_attention", (4, 4, 16, 16, 1024), {"t_block": 4},
          fmts=(jformats.P8_2,))
    path = c.save(str(tmp_path / "cache.json"))
    port = autotune.AutotuneCache.load(path)
    port.backend = H100
    assert port.lookup("paged_attention", (4, 4, 16, 16, 1024),
                       (formats.P8_2,)) == {"t_block": 4}


def test_cache_version_bump_invalidates_wholesale(tmp_path):
    c = autotune.AutotuneCache()
    c.put("paged_attention", (4, 4, 16, 16, 1024), {"t_block": 2},
          fmts=(formats.P8_2,))
    path = c.save(str(tmp_path / "cache.json"))
    with open(path) as f:
        raw = json.load(f)
    raw["version"] = autotune.CACHE_VERSION + 1
    with open(path, "w") as f:
        json.dump(raw, f)
    assert autotune.AutotuneCache.load(path).entries == {}


def test_missing_file_loads_empty(tmp_path):
    assert autotune.AutotuneCache.load(str(tmp_path / "nope.json")).entries \
        == {}


def test_env_var_cache_path_and_off(tmp_path, monkeypatch, scratch_cache):
    c = autotune.AutotuneCache()
    c.put("paged_attention", (4, 4, 16, 16, 1024), {"t_block": 1},
          fmts=(formats.P8_2,))
    path = c.save(str(tmp_path / "cache.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    assert autotune.cache_path() == path
    autotune.reset_cache(None)   # reload from the env path
    assert autotune.lookup("paged_attention", (4, 4, 16, 16, 1024),
                           (formats.P8_2,)) == {"t_block": 1}
    assert autotune.hit_report() == {"paged_attention": {"hits": 1,
                                                         "misses": 0}}
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    assert autotune.lookup("paged_attention", (4, 4, 16, 16, 1024),
                           (formats.P8_2,)) is None
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert autotune.cache_path() == autotune.DEFAULT_CACHE_PATH
    assert autotune.DEFAULT_CACHE_PATH.endswith("build/autotune_cache.json")


# ---------------------------------------------------------------------------
# dispatch-time resolution through ops.py
# ---------------------------------------------------------------------------


def _mq_inputs(seed, B=2, T=4, Hq=4, Hkv=2, Dh=8, ps=4, M=4):
    rng = np.random.default_rng(seed)
    fmt = formats.P16_1
    n_pages = 1 + B * M
    kv = torch.from_numpy(rng.normal(0, 1, (2, n_pages, ps, Hkv * Dh))
                          .astype(np.float32))
    kp, vp = posit.pack(kv[0], fmt), posit.pack(kv[1], fmt)
    bt = torch.from_numpy(1 + np.arange(B * M).reshape(B, M)).to(torch.int32)
    lengths = torch.tensor([7, 11][:B], dtype=torch.int32)
    win = torch.full((1,), 2 ** 30, dtype=torch.int32)
    q = torch.from_numpy(rng.normal(0, 1, (B, T, Hq, Dh)).astype(np.float32))
    return (q, kp, vp, bt, lengths, win), fmt, (B, T, M, ps, Hkv * Dh)


def _spy(monkeypatch):
    """Record the t_block each K7 wrapper call receives."""
    seen = []
    real = pa.paged_attention

    def wrapper(*a, **kw):
        seen.append(kw.get("t_block"))
        return real(*a, **kw)

    monkeypatch.setattr(pa, "paged_attention", wrapper)
    return seen


@pytest.mark.parametrize("T,cached,want", [(4, 2, 2), (4, 8, 4), (6, 4, 3),
                                           (5, 4, None), (3, 2, None)])
def test_ops_resolves_t_block_with_degrade(monkeypatch, scratch_cache, T,
                                           cached, want):
    """A cached t_block reaches K7's wrapper when it divides T, degrades to
    the largest divisor of T below it, or is dropped (the kernel's
    default) where that divisor falls under the floor (prime T); the
    output stays bitwise the untuned one."""
    args, fmt, key = _mq_inputs(31 + T, T=T)
    seen = _spy(monkeypatch)
    autotune.reset_cache(autotune.AutotuneCache())      # empty: a miss
    untuned = ops.paged_attention(*args, fmt_kv=fmt)
    c = autotune.AutotuneCache()
    c.put("paged_attention", key, {"t_block": cached}, fmts=(fmt,))
    autotune.reset_cache(c)
    got = ops.paged_attention(*args, fmt_kv=fmt)
    assert c.hits == {"paged_attention": 1}
    assert seen == [None, want]
    assert torch.equal(got, untuned)


def test_ops_explicit_t_block_wins(monkeypatch, scratch_cache):
    args, fmt, key = _mq_inputs(12)
    seen = _spy(monkeypatch)
    c = autotune.AutotuneCache()
    c.put("paged_attention", key, {"t_block": 4}, fmts=(fmt,))
    autotune.reset_cache(c)
    got = ops.paged_attention(*args, fmt_kv=fmt, t_block=1)
    assert seen == [1]
    assert c.hits == {} and c.misses == {}       # no lookup at all
    assert torch.equal(got, ops.paged_attention(*args, fmt_kv=fmt,
                                                t_block=2))


def test_ops_three_d_query_skips_the_cache(monkeypatch, scratch_cache):
    """K3 (one token a slot) has no tile: no lookup."""
    args, fmt, _ = _mq_inputs(13)
    c = autotune.AutotuneCache()
    autotune.reset_cache(c)
    ops.paged_attention(args[0][:, 0].contiguous(), *args[1:], fmt_kv=fmt)
    assert c.hits == {} and c.misses == {}


def test_largest_divisor_and_degrade_rule_match_reference():
    from repro.kernels import ops as jops
    for n in range(1, 40):
        for cap in (1, 2, 3, 4, 8, 16, 32):
            assert ops._largest_divisor(n, cap) == \
                jops._largest_divisor(n, cap)
            assert ops._degrade_tile(n, cap) == jops._degrade_tile(n, cap)
        assert ops._degrade_tile(n, None) is None


def test_ops_resolve_fills_only_missing_params(scratch_cache):
    c = autotune.AutotuneCache()
    c.put("paged_attention", (4, 4, 16, 16, 1024), {"t_block": 8},
          fmts=(formats.P8_2,))
    autotune.reset_cache(c)
    kw = ops._resolve("paged_attention", (4, 4, 16, 16, 1024),
                      (formats.P8_2,), {"t_block": 2}, ("t_block",))
    assert kw == {"t_block": 2} and c.misses == {} and c.hits == {}
    kw = ops._resolve("paged_attention", (4, 4, 16, 16, 1024),
                      (formats.P8_2,), {}, ("t_block",))
    assert kw == {"t_block": 8}
    kw = ops._resolve("paged_attention", (4, 4, 16, 16, 1024),
                      (formats.P16_2,), {}, ("t_block",))
    assert kw == {}


# ---------------------------------------------------------------------------
# the sweep and its CLI
# ---------------------------------------------------------------------------


def test_sweep_and_cli_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.sweep("paged_attention", (4, 4, 16, 16, 1024),
                       lambda p: (lambda: None))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_autotune.main(["--quick"])


def test_sweep_points_and_runner_cover_the_serving_verify():
    """The sweep's K7 points are the verify's serving shape (4 slots, 4
    tokens, 16-token P(8,2) pages, 8 KV heads of 128); the runner's
    thunks launch K7 with each candidate (here its plain version) and
    give the same values."""
    points = launch_autotune.sweep_points(quick=False)
    assert set(points) == set(autotune.TUNABLES)
    assert ((4, 4, 16, 16, 1024), (formats.P8_2,)) in points["paged_attention"]
    assert len(launch_autotune.sweep_points(quick=True)["paged_attention"]) \
        == 1
    shape = (2, 4, 3, 4, 256)
    run = launch_autotune._runner("paged_attention", shape, (formats.P8_2,),
                                  torch.Generator().manual_seed(0), "cpu")
    outs = [run(p)() for p in autotune.candidates("paged_attention")
            if 4 % p["t_block"] == 0]
    assert outs[0].shape == (2, 4, 16, 128)
    assert all(torch.equal(o, outs[0]) for o in outs)
