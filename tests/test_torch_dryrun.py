"""The dry run (`repro_torch.launch.dryrun`) and the step analysis
(`repro_torch.launch.step_analysis`) on the CPU.

Per-device bytes of every parameter, optimizer-state and cache leaf of
every config on both production meshes equal the reference's
(`repro.parallel.sharding.spec_for` on a `jax.sharding.AbstractMesh`, its
`_opt_state_shardings` over `jax.eval_shape(opt.init)`), and so do the
parameter counts and model flops.  `analyze_step` passes the twins of
tests/test_hlo_analysis.py and counts every layer of a model; each
kernel's work formula (`kernels/work.py`) reproduces a bound of PERF.md
§6 at that row's shape.  Every (arch x runnable shape) cell is reckoned
at full width, 2 layers (a hybrid one period); `DRYRUN_FULL=1` reckons
them at full depth instead.
"""
import math
import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.quant import policy_by_name
from repro_torch.kernels import work
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW, make_host_mesh, make_production_mesh
from repro_torch.launch.step_analysis import HostRead, analyze_step
from repro_torch.models import api
from repro_torch.models.config import DECODE_32K, TRAIN_4K, ShapeConfig

FULL = bool(os.environ.get("DRYRUN_FULL"))
# cells whose step reads a device value on the host (none: the MoE aux
# loss counts its experts into fixed bins, as the reference does)
HOST_READ_CELLS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Meta ops are host work: one thread, as the suite's other workers
    hold the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS to 512
    host devices; the variable is restored at once, so no subprocess a
    later test starts in this worker inherits it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as rd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return rd


def _ref_mesh(multi_pod: bool):
    from jax.sharding import AbstractMesh
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _ref_bytes(leaves, shardings):
    return [math.prod(s.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
            for a, s in zip(leaves, shardings)]


# ---------------------------------------------------------------------------
# per-device bytes, parameter counts, model flops against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_per_device_bytes_match_the_reference(ref, arch):
    import jax
    from jax.sharding import NamedSharding
    from repro import configs as rconfigs
    from repro.models import api as rapi
    from repro.models.module import abstract_params as rabstract
    from repro.parallel import sharding as rsharding

    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    rps = rapi.param_specs(rcfg)
    rleaves = jax.tree.leaves(rps, is_leaf=ref._IS_SPEC)
    ropt = jax.eval_shape(ref._opt_for(rcfg).init, rabstract(rps))
    rcache = None if cfg.is_encoder else jax.tree.leaves(
        rapi.cache_specs(rcfg, DECODE_32K.global_batch, DECODE_32K.seq_len),
        is_leaf=ref._IS_SPEC)
    for multi_pod in (False, True):
        mesh, rmesh = make_production_mesh(multi_pod=multi_pod), \
            _ref_mesh(multi_pod)

        def ref_specs(leaves):
            return [NamedSharding(rmesh, rsharding.spec_for(
                s.shape, s.logical_axes, rmesh)) for s in leaves]

        want = {"params": _ref_bytes(rleaves, ref_specs(rleaves)),
                "opt_state": _ref_bytes(
                    jax.tree.leaves(ropt), jax.tree.leaves(
                        ref._opt_state_shardings(ropt, rps, rmesh)))}
        cells = [dryrun.build_cell(cfg, TRAIN_4K, mesh)]
        if rcache is not None:
            want["cache"] = _ref_bytes(rcache, ref_specs(rcache))
            cells.append(dryrun.build_cell(cfg, DECODE_32K, mesh))
        for kind, ref_bytes in want.items():
            cell = cells[-1] if kind == "cache" else cells[0]
            got = [dryrun.shard_bytes(t, s, mesh) for t, s in
                   zip(dryrun.flat(cell.state[kind]), cell.specs[kind])]
            assert got == ref_bytes, (arch, multi_pod, kind)
            assert dryrun.memory(cell)["rules"][kind] == sum(ref_bytes)


def test_counts_and_model_flops_match_the_reference(ref):
    from repro import configs as rconfigs
    from repro.models import api as rapi
    from repro.models.module import param_count as rcount
    from repro_torch.models.module import param_count
    for arch in configs.ARCH_NAMES:
        cfg, rcfg = configs.get(arch), rconfigs.get(arch)
        assert param_count(api.param_specs(cfg)) == \
            rcount(rapi.param_specs(rcfg))
        n = ref._active_params(rcfg)
        assert dryrun._active_params(cfg) == n
        for shape in configs.runnable_shapes(arch):
            want = {"train": 6.0 * n * shape.tokens,
                    "prefill": 2.0 * n * shape.tokens,
                    "decode": 2.0 * n * shape.global_batch}[shape.kind]
            assert dryrun.model_flops(cfg, shape) == want


def test_production_meshes_are_shapes_only():
    for multi_pod, shape in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.shape == shape
        assert {d.type for d in mesh.devices} == {"meta"}
    assert make_host_mesh(2, 4, 3).shape == {"pod": 3, "data": 2, "model": 4}


# ---------------------------------------------------------------------------
# analyze_step: the twins of tests/test_hlo_analysis.py
# ---------------------------------------------------------------------------

def _x(*shape):
    return torch.empty(shape, device="meta")


def _flops(fn, *args):
    return analyze_step(fn, *args)["flops"]


def test_single_matmul():
    assert _flops(torch.matmul, _x(128, 128), _x(128, 128)) == 2 * 128 ** 3


def _loop(x, w, n):
    for _ in range(n):
        x = torch.matmul(x, w)
    return x


def test_loop_counts_every_iteration():
    assert _flops(lambda x, w: _loop(x, w, 17), _x(128, 128),
                  _x(128, 128)) == 17 * 2 * 128 ** 3


def test_nested_loop():
    def f(x, w):
        for _ in range(5):
            x = _loop(x, w, 3)
        return x
    assert _flops(f, _x(128, 128), _x(128, 128)) == 15 * 2 * 128 ** 3


def test_rectangular_matmul_contraction():
    assert _flops(torch.matmul, _x(32, 512), _x(512, 8)) == 2 * 32 * 512 * 8


def test_hbm_bytes_scale_with_the_loop():
    b1 = analyze_step(torch.matmul, _x(128, 128), _x(128, 128))["hbm_bytes"]
    b17 = analyze_step(lambda x, w: _loop(x, w, 17), _x(128, 128),
                       _x(128, 128))["hbm_bytes"]
    assert b1 == 3 * 128 * 128 * 4 and b17 == 17 * b1


def test_layers_double_the_per_layer_work():
    """A serving prefill at full width (packed weights, serve_fused_p16)
    at 1, 2 and 4 layers: going from 2 to 4 layers adds twice what 1 to 2
    adds, in flops, bytes, device launches and each kernel's launches."""
    base = configs.get("command_r_35b").replace(
        quant=policy_by_name("serve_fused_p16"))
    shape = ShapeConfig("p", 128, 2, "prefill")
    recs = {}
    for n in (1, 2, 4):
        cell = dryrun.build_cell(base.replace(n_layers=n), shape,
                                 make_host_mesh(), packed=True)
        recs[n] = analyze_step(cell.fn, *cell.args)
    for key in ("flops", "hbm_bytes", "device_ops"):
        assert recs[4][key] - recs[2][key] == 2 * (recs[2][key]
                                                   - recs[1][key]) > 0
    launches = recs[4]["launches"]
    assert launches["posit_decode:p16_2"] > 0
    for k in launches:
        assert launches[k] - recs[2]["launches"][k] == \
            2 * (recs[2]["launches"][k] - recs[1]["launches"].get(k, 0))


def test_peak_counts_live_storage_once():
    """Views share their storage; a freed temporary leaves the peak; the
    inputs are live from the start."""
    def f(x):
        y = x * 2                 # 4 KB live beside x
        z = y.view(-1)[:10]       # a view: no new bytes
        t = z.sum()               # 4 bytes
        del y, z                  # y's storage freed
        return t, x + 1           # 4 KB again: the peak stays
    rec = analyze_step(f, _x(32, 32))
    assert rec["peak_live_bytes"] == 2 * 32 * 32 * 4 + 4
    assert rec["device_ops"] == 3      # the mul, the sum, the add


def test_host_reads_are_named():
    with pytest.raises(HostRead, match="test_torch_dryrun|outside"):
        analyze_step(lambda x: float(x.sum()), _x(4))


# ---------------------------------------------------------------------------
# each kernel's work formula against a PERF.md §6 bound at that row's shape
# ---------------------------------------------------------------------------

_LAYER_KN = ((8192, 8192), (8192, 1024), (8192, 1024), (8192, 8192),
             (8192, 22528), (8192, 22528), (22528, 8192))
_MINITRON_KN = ((4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
                (4096, 16384), (4096, 16384), (16384, 4096))
_QWEN3_EXPERTS = ((4096, 1536), (4096, 1536), (1536, 4096))


def _k5_gemma3_window():
    """gemma3-4b's tc256 chunk (PERF.md §6 row 6): B 4, C 64, 8 / 4 heads of
    256, pages of 16, M 128, starts 1024, 1100, 1500, 1960 (slot 1 shares
    slot 0's first 64 pages), window 1024, slot 3's writes masked."""
    starts, window, C, ps, shared = (1024, 1100, 1500, 1960), 1024, 64, 16, 64
    rows = set()
    for b, s in enumerate(starts):
        for r in range(max(0, s - window + 1), s):
            slot = 0 if b == 1 and r // ps < shared else b
            rows.add((slot, r))
    pairs = sum(min(s + j + 1, window) for s in starts for j in range(C))
    return work.prefill(4, C, 8, 4, 256, 2, 1, len(rows), 3 * C, pairs,
                        "tc256")


BOUND_ROWS = {
    # row 1: K1 p16_2 [8192, 22528] int16 -> f32
    "K1 decode": (work.decode(8192 * 22528, 2), 0.3305, "bytes"),
    # row 1: the float GEMV over a command-r layer's 7 projections at M 4
    "float GEMV layer": (work.total(work.gemv_f(4, k, n, 2, 2)
                                    for k, n in _LAYER_KN), 0.4212, "bytes"),
    # row 2: K2 [256000, 8192] f32 -> int16 P(16,2)
    "K2 encode": (work.encode(256000 * 8192, 2), 3.7561, "bytes"),
    # row 3: K3, B 4, 64 / 8 heads of 128, pages of 16, M 16, lengths
    # 256, 137, 0, 64 (29 pages, 457 keys), int8
    "K3": (work.paged_attention(4, 1, 64, 8, 128, 29 * 16, 1, 16, 457),
           0.0004, "bytes"),
    # row 5: K4, B 4, D 8192, V 256000, int16 head, bf16 rows, sampled
    "K4": (work.decode_sample(4, 8192, 256000, 2, 2, False), 1.2533,
           "bytes"),
    # row 6: K5 tc256 at gemma3-4b's chunk, window 1024 (the exact form)
    "K5 tc256": (_k5_gemma3_window(), 0.0043, "operations"),
    # row 7: K6 tc, minitron's 7 projections at M 512 (the exact form)
    "K6 tc training": (work.total(work.matmul(512, k, n, 2, 2, 4, "tc")
                                  for k, n in _MINITRON_KN), 1.0075,
                       "operations"),
    # row 7: K6 split-K GEMV, a13 at M 4 over command-r's layer
    "K6 gemv": (work.total(work.matmul(4, k, n, 2, 2, 4, "gemv_p16_2")
                           for k, n in _LAYER_KN), 0.4212, "bytes"),
    # row 8: K9 p16_2, E 128, M 8, f32 activations, qwen3's expert GEMMs
    "K9 serving": (work.total(work.grouped(128, 8, k, n, 4, 2, 4, "p16_2")
                              for k, n in _QWEN3_EXPERTS), 1.4630, "bytes"),
    # row 8: K9 tc_p13_2, E 128, M 40 (qwen3's training capacity)
    "K9 training": (work.total(work.grouped(128, 40, k, n, 2, 2, 4,
                                            "tc_p13_2")
                               for k, n in _QWEN3_EXPERTS), 1.5159, "bytes"),
    # row 9: K8's fields chain by its source count (pdpu_step_ops: 138
    # a step at N 8, sticky; every code decoded once), P(10/16,2) N 8, M 4,
    # K 8192, N 1024
    "K8 posit": (work.pdpu(4, 8192, 1024, 8), 0.0447, "operations"),
    # the merge: 2 / 4 shards' partials of [4, 64] rows x 128
    "merge 2 shards": (work.merge(2, 256, 128), 0.0001, "bytes"),
    "merge 4 shards": (work.merge(4, 256, 128), 0.0002, "bytes"),
}


@pytest.mark.parametrize("row", sorted(BOUND_ROWS))
def test_work_formula_reproduces_the_perf_bound(row):
    w, ms, by = BOUND_ROWS[row]
    s, got_by = w.bound_s(HW)
    assert round(s * 1e3, 4) == ms and got_by == by


# ---------------------------------------------------------------------------
# every cell, reckoned
# ---------------------------------------------------------------------------

def _sweep_cfg(arch, shape):
    """The config at full width, 2 layers (a hybrid one period; all of
    them under DRYRUN_FULL), under the policy the port runs such a cell
    with: paper_mixed fused for training (one microbatch here, the
    reference's 8 under DRYRUN_FULL), serve_fused_p16 over packed weights
    for serving."""
    cfg = configs.get(arch)
    if not FULL:
        cfg = cfg.replace(n_layers=cfg.attn_interval
                          if cfg.family == "hybrid" else 2)
    name = "paper_mixed" if shape.kind == "train" else "serve_fused_p16"
    quant = policy_by_name(name)
    if shape.kind == "train":
        quant = quant.with_execution("fused")
    return cfg.replace(quant=quant)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_every_cell_is_reckoned(arch):
    mesh = make_production_mesh()
    for shape in configs.runnable_shapes(arch):
        cfg = _sweep_cfg(arch, shape)
        cell = dryrun.build_cell(cfg, shape, mesh,
                                 accum=None if FULL else 1,
                                 packed=shape.kind != "train")
        if (arch, shape.name) in HOST_READ_CELLS:
            with pytest.raises(HostRead,
                               match=HOST_READ_CELLS[(arch, shape.name)]):
                dryrun.analyze(cell)
            continue
        rec = dryrun.analyze(cell)
        port = rec["memory"]["port"]
        assert rec["peak_live_bytes"] >= port["total"] > 0
        assert rec["memory"]["rules"]["total"] < port["total"]
        assert rec["work"]["flops"] > 0 and rec["work"]["device_ops"] > 0
        assert rec["roofline"]["dominant"] in ("compute", "memory")
        launches = rec["work"]["launches"]
        assert any(":" not in k for k in launches), (arch, shape.name)
        if shape.kind == "train":
            assert launches["posit_encode:p13_2"] > 0
            assert launches.get("posit_matmul:tc", 0) \
                + launches.get("posit_matmul_grouped:tc_p13_2", 0) > 0


# ---------------------------------------------------------------------------
# exchanges, counted where the port's code hands them over
# ---------------------------------------------------------------------------

def test_compressed_reduction_counts_what_a_pod_sends():
    """The compressed step over (pod 2, data 2, model 1) meta positions:
    pod 0 hands each leaf's int8 segment to its owner (all_to_all) and its
    summed segment to the other pod (all_gather), ceil(L / 2) bytes each;
    K2 / K1 `p8_2` launch per leaf as the step's own code does."""
    from repro_torch.models.module import abstract_params, tree_leaves
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.train import step as step_lib
    cfg = configs.get_smoke("mamba2_1_3b").replace(
        n_layers=1, quant=policy_by_name("paper_mixed").with_execution("fused"))
    opt = adamw(constant_schedule(1e-3))
    ts = step_lib.make_train_step_compressed(cfg, opt,
                                             make_host_mesh(2, 1, 2))
    params = abstract_params(api.param_specs(cfg))
    state = step_lib.TrainState(params, opt.init(params),
                                torch.zeros((), dtype=torch.int32))
    batch = api.input_specs(cfg, ShapeConfig("t", 16, 4, "train"))
    rec = analyze_step(ts, (state, ts.init_err(params)), batch)
    segs = [-(-p.numel() // 2) for p in tree_leaves(params)]
    assert rec["collective_per_op"] == {
        "compressed_psum:all_to_all": sum(segs),
        "compressed_psum:all_gather": sum(segs)}
    assert rec["collective_counts"]["compressed_psum:all_to_all"] == len(segs)
    assert rec["launches"]["posit_encode:p8_2"] == 4 * len(segs)


def test_sharded_decode_counts_partials_and_merges():
    """A decode step over a pool split in two shards (meta): each layer
    one K3 a shard, one merge, and the second shard's (o, m, l) handed to
    it."""
    from repro_torch.models import paged
    cfg = configs.get_smoke("command_r_35b").replace(
        quant=policy_by_name("serve_fused_p16"))
    B, max_seq = 2, 64
    layout = paged.PagedLayout.for_slots(B, max_seq, 16, n_shards=2)
    shard = paged.PageShard(["meta"] * 2)
    params = dryrun.abstract_params(dryrun.packed_param_specs(cfg))
    cache = api.init_cache(cfg, B, max_seq, layout, device="meta",
                           shard=shard)
    rec = analyze_step(lambda p, t, c: api.decode_step(p, t, c, cfg,
                                                       shard=shard),
                       params, torch.empty(B, dtype=torch.int32,
                                           device="meta"), cache)
    L = cfg.n_layers
    assert rec["launches"]["paged_attention"] == 2 * L
    assert rec["launches"]["merge_attn_partials"] == L
    rows = B * cfg.n_heads
    assert rec["collective_per_op"] == {
        "paged:partials": L * rows * (cfg.head_dim + 2) * 4}


@pytest.mark.parametrize("n_shards", [2, 4])
def test_history_gather_counts_one_sub_pool_a_position(n_shards):
    """`paged.global_pool` (K5's global history): on meta, the placement
    of the shards on separate cards, one sub-pool's bytes a position
    sends, whatever the number of shards; sub-pools already on the
    gathering device (a view of one pool, or apart) send nothing."""
    from repro_torch.models import paged
    sub = (3, 4, 16, 32)
    pages = [torch.empty(sub, dtype=torch.int8, device="meta")
             for _ in range(n_shards)]
    rec = analyze_step(lambda *p: paged.global_pool(list(p), "meta"),
                       *pages)
    assert rec["collective_per_op"] == {"paged:history": math.prod(sub)}
    assert rec["collective_counts"] == {"paged:history": 1}

    class Sent:
        def __init__(self):
            self.calls = []

        def exchange(self, name, nbytes):
            self.calls.append((name, nbytes))

    whole = torch.arange(n_shards * math.prod(sub), dtype=torch.int32).to(
        torch.int8).reshape((n_shards * sub[0],) + sub[1:])
    views = list(whole.split(sub[0]))
    apart = [v.clone() for v in views]
    sent = Sent()
    work._RECORDERS.append(sent)
    try:
        got_view = paged.global_pool(views, "cpu")
        got_apart = paged.global_pool(apart, "cpu")
    finally:
        work._RECORDERS.pop()
    assert sent.calls == []
    assert got_view.data_ptr() == whole.data_ptr()
    assert torch.equal(got_view, whole) and torch.equal(got_apart, whole)
