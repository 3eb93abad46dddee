"""Dry run: reckon every (arch x shape x mesh) cell without a device
(PyTorch port of `repro.launch.dryrun`).

The reference lowers and compiles each cell for a TPU pod and reads XLA's
memory and cost analyses.  The port has no XLA: `build_cell` makes a
cell's state and inputs on the meta device (shapes and dtypes, no data)
and `analyze` reckons, for each cell,

  memory.rules  the per-device bytes of the parameters, optimizer state,
                batch and cache under the sharding rule table
                (`parallel.sharding.spec_for`): the reference's argument
                bytes on that mesh;
  memory.port   what the port's own placement holds on a position of that
                mesh: it shards no weights, optimizer state or
                activations, and its serving mesh splits only a paged
                cache's pages (a dense cache stays whole); the host-side
                scalars (an optimizer's step) are not the device's;
  work          one step on meta under `step_analysis.analyze_step`:
                flops, HBM bytes, launches by kernel and variant, the
                peak of live device bytes (inputs and state live from the
                start, so it holds memory.port) and the roofline terms on
                the H100's peaks (`launch.mesh.HW`);
  fits          whether that peak fits the card's 80 GB.

The step is the port's, on one position (the port's placement), whatever
the mesh: `useful_flops_ratio` is the model flops over that step's flops.
Nothing is allocated on any device.

    python -m repro_torch.launch.dryrun --arch gemma3_4b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all \\
        --both-meshes --continue-on-error --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import api
from repro_torch.models.config import shape_by_name
from repro_torch.models.module import (abstract_params, param_bytes,
                                       param_count, tree_leaves)
from repro_torch.models.packing import packed_param_specs
from repro_torch.optim import adafactor, adamw, cosine_schedule
from repro_torch.parallel import sharding
from repro_torch.train import step as step_lib

# gradient-accumulation factor per train cell, the reference's: a
# microbatch of 32 sequences under the 16- and 32-way batch shardings
TRAIN_ACCUM = 8
_KINDS = ("params", "opt_state", "batch", "cache")


def _opt_for(cfg):
    """adafactor above 100e9 parameters (factored second moment), else
    AdamW, as the reference picks."""
    n = param_bytes(api.param_specs(cfg)) / 4
    lr = cosine_schedule(3e-4, 2000, 100_000)
    return adafactor(lr) if n > 100e9 else adamw(lr)


def flat(tree) -> list:
    """The tensors of a tree of dicts (sorted keys), tuples (NamedTuple
    states, in field order) and tensors: the reference's leaf order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat(tree[k])]
    if isinstance(tree, tuple):
        return [t for x in tree for t in flat(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def opt_state_specs(opt_abs, pspecs, mesh) -> list:
    """Specs of the optimizer state's leaves (`flat` order), the
    reference's rule: a moment takes the axes of the first parameter
    (sorted-key order) whose shape it matches, or whose shape less its
    last dim (adafactor's row factor), or less its second-to-last (the
    column factor); the rest replicate."""
    flat_p = tree_leaves(pspecs)

    def for_array(a):
        shape = tuple(a.shape)
        for ps in flat_p:
            if shape == ps.shape:
                return sharding.spec_for(shape, ps.logical_axes, mesh)
            if len(ps.shape) >= 2 and shape == ps.shape[:-1]:
                return sharding.spec_for(shape, ps.logical_axes[:-1], mesh)
            if len(ps.shape) >= 2 and shape == ps.shape[:-2] + ps.shape[-1:]:
                return sharding.spec_for(
                    shape, ps.logical_axes[:-2] + ps.logical_axes[-1:], mesh)
        return (None,) * len(shape)

    return [for_array(a) for a in flat(opt_abs)]


def _spec_list(spec_tree, mesh) -> list:
    return [sharding.spec_for(ps.shape, ps.logical_axes, mesh)
            for ps in tree_leaves(spec_tree)]


def shard_bytes(t, spec, mesh) -> int:
    """Bytes of one position's shard of t under spec."""
    n = t.element_size()
    for dim, entry in zip(t.shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        div = 1
        for a in axes:
            div *= mesh.shape[a]
        n *= dim // div
    return n


@dataclasses.dataclass
class Cell:
    """One config x shape x mesh: `fn(*args)` is the step, `state` the
    meta trees by kind (params, opt_state, batch, cache; None where the
    cell has none), `specs` their leaves' specs under the rule table and
    `logical` their logical axes, in `flat` order."""
    cfg: object
    shape: object
    mesh: object
    fn: object
    args: tuple
    state: dict
    specs: dict
    logical: dict


def build_cell(cfg, shape, mesh, accum=None, packed: bool = False) -> Cell:
    """The cell's meta state and step, as the reference's `build_lowered`
    builds them: parameters from the specs (posit-packed where `packed`,
    as a serving checkpoint holds them), for train cells the optimizer
    state (`_opt_for`) and `make_train_step(cfg, opt, accum)`, for prefill
    `api.prefill` (an encoder `api.apply`) and for decode `decode_step`
    over the dense cache; the cache of decode cells and of non-encoder
    prefill cells from `api.cache_specs`."""
    accum = accum or TRAIN_ACCUM
    pspecs = packed_param_specs(cfg) if packed else api.param_specs(cfg)
    params = abstract_params(pspecs)
    batch = api.input_specs(cfg, shape)
    state, specs, logical = ({k: None for k in _KINDS} for _ in range(3))
    state["params"], specs["params"] = params, _spec_list(pspecs, mesh)
    logical["params"] = [ps.logical_axes for ps in tree_leaves(pspecs)]
    state["batch"] = batch
    logical["batch"] = [("batch",) + (None,) * (a.ndim - 1)
                        for a in flat(batch)]
    specs["batch"] = [sharding.spec_for(a.shape, ax, mesh)
                      for a, ax in zip(flat(batch), logical["batch"])]
    if shape.kind == "decode" or (shape.kind == "prefill"
                                  and not cfg.is_encoder):
        cspecs = api.cache_specs(cfg, shape.global_batch, shape.seq_len)
        state["cache"] = abstract_params(cspecs)
        specs["cache"] = _spec_list(cspecs, mesh)
        logical["cache"] = [ps.logical_axes for ps in tree_leaves(cspecs)]
    if shape.kind == "train":
        opt = _opt_for(cfg)
        opt_abs = opt.init(params)
        state["opt_state"] = opt_abs
        specs["opt_state"] = opt_state_specs(opt_abs, pspecs, mesh)
        train_state = step_lib.TrainState(params, opt_abs,
                                          torch.zeros((), dtype=torch.int32))
        fn = step_lib.make_train_step(cfg, opt, accum=accum)
        args = (train_state, batch)
    elif shape.kind == "prefill":
        if cfg.is_encoder:
            fn = lambda p, b: api.apply(p, b, cfg)  # noqa: E731
        else:
            fn = lambda p, b: api.prefill(  # noqa: E731
                p, b, cfg, max_seq=shape.seq_len, device="meta")
        args = (params, batch)
    elif shape.kind == "decode":
        fn = lambda p, t, c: api.decode_step(p, t, c, cfg)  # noqa: E731
        args = (params, batch["tokens"], state["cache"])
    else:
        raise ValueError(shape.kind)
    return Cell(cfg, shape, mesh, fn, args, state, specs, logical)


def port_bytes(t, logical, mesh) -> int:
    """Bytes of t on one position under the port's placement: whole,
    but a paged pool's pages split over the mesh's kv_pages axis; nothing
    for a host tensor."""
    if t.device.type != "meta":
        return 0
    n = t.numel() * t.element_size()
    if logical is not None and "kv_pages" in logical:
        n //= sharding.mesh_axis_size("kv_pages", mesh)
    return n


def memory(cell: Cell) -> dict:
    """{"rules": ..., "port": ...}: per-position bytes by kind and their
    total (see the module docstring)."""
    rules, port = {}, {}
    for kind in _KINDS:
        if cell.state[kind] is None:
            continue
        leaves = flat(cell.state[kind])
        rules[kind] = sum(shard_bytes(t, s, cell.mesh)
                          for t, s in zip(leaves, cell.specs[kind]))
        axes = cell.logical[kind] or [None] * len(leaves)
        port[kind] = sum(port_bytes(t, ax, cell.mesh)
                         for t, ax in zip(leaves, axes))
    rules["total"] = sum(rules.values())
    port["total"] = sum(port.values())
    return {"rules": rules, "port": port}


def _active_params(cfg) -> int:
    """Parameters touched per token (MoE: top-k routed experts and the
    shared ones), the reference's count."""
    total = param_count(api.param_specs(cfg))
    if cfg.n_experts == 0:
        return total
    expert = cfg.d_model * cfg.moe_d_ff * 3
    if cfg.family == "hybrid":
        n_moe = sum(1 for i in range(cfg.n_layers) if cfg.layer_is_moe(i))
    else:
        n_moe = cfg.n_layers
    return total - n_moe * (cfg.n_experts - cfg.top_k) * expert


def model_flops(cfg, shape) -> float:
    """6 N D for a train cell, 2 N D for a prefill's tokens, 2 N B for a
    decode step (N the active parameters)."""
    n = _active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch


def analyze(cell: Cell, step: dict | None = None) -> dict:
    """The cell's record; `step` an earlier `analyze_step` record of the
    same config, shape and state to reuse (the port's step does not
    depend on the mesh)."""
    t0 = time.perf_counter()
    if step is None:
        step = analyze_step(cell.fn, *cell.args)
    cfg, shape, mesh = cell.cfg, cell.shape, cell.mesh
    n_dev = len(mesh.devices)
    mf = model_flops(cfg, shape)
    terms = {k: step[k] for k in ("compute_s", "memory_s", "collective_s")}
    terms.update(
        dominant=max((("compute", terms["compute_s"]),
                      ("memory", terms["memory_s"]),
                      ("collective", terms["collective_s"])),
                     key=lambda kv: kv[1])[0],
        model_flops_total=mf, model_flops_per_dev=mf / n_dev,
        step_flops=step["flops"],
        useful_flops_ratio=mf / step["flops"] if step["flops"] else None)
    work = {k: v for k, v in step.items()
            if k not in ("compute_s", "memory_s", "collective_s",
                         "peak_live_bytes")}
    return {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(mesh.shape), "devices": n_dev,
        "params": param_count(api.param_specs(cfg)),
        "active_params": _active_params(cfg),
        "memory": memory(cell),
        "peak_live_bytes": step["peak_live_bytes"],
        "fits": step["peak_live_bytes"] <= HW["hbm_bytes"],
        "work": work,
        "collectives": {"per_op": step["collective_per_op"],
                        "counts": step["collective_counts"],
                        "total_bytes": step["collective_bytes"]},
        "roofline": terms,
        "hw": {k: HW[k] for k in ("name", "interconnect")},
        "analysis_seconds": time.perf_counter() - t0,
    }


def run_cell(arch, shape_name, multi_pod, out_dir=None, cfg_overrides=None,
             tag="", accum=None, steps=None):
    """Reckon one cell and write its record to
    `out_dir/<arch>__<shape>__<mesh tag>[__<tag>].json`.  `steps` (a dict)
    keeps each (arch, shape)'s step record for the other mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_tag = "multipod_2x16x16" if multi_pod else "pod_16x16"
    cfg = configs.get(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = shape_by_name(shape_name)
    cell = build_cell(cfg, shape, mesh, accum=accum)
    key = (arch, shape_name)
    rec = analyze(cell, None if steps is None else steps.get(key))
    if steps is not None:
        steps[key] = {**rec["work"], "peak_live_bytes": rec["peak_live_bytes"],
                      **{k: rec["roofline"][k] for k in
                         ("compute_s", "memory_s", "collective_s")}}
    rec["mesh_tag"] = mesh_tag
    rec["variant"] = tag or "baseline"
    m = rec["memory"]
    print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}"
          f"{' x ' + tag if tag else ''}: OK ({rec['analysis_seconds']:.1f}s) "
          f"rules {m['rules']['total']:.4g} B/dev, port "
          f"{m['port']['total']:.4g} B, peak {rec['peak_live_bytes']:.4g} B, "
          f"fits={rec['fits']} dominant={rec['roofline']['dominant']} "
          f"flops={rec['work']['flops']:.3g}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{mesh_tag}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix for variants")
    ap.add_argument("--quant", default=None,
                    help="QuantPolicy name (none|paper_mixed|serve_p16_kv8|...)")
    ap.add_argument("--cast-params-early", action="store_true")
    ap.add_argument("--shard-expert-cap", action="store_true")
    ap.add_argument("--tp-bf16-reduce", action="store_true")
    ap.add_argument("--fsdp-gather-weights", action="store_true")
    ap.add_argument("--moe-grouped-dispatch", action="store_true")
    ap.add_argument("--accum", type=int, default=None,
                    help="gradient accumulation steps for train cells")
    args = ap.parse_args(argv)

    overrides = {}
    if args.quant:
        from repro_torch.core.quant import policy_by_name
        overrides["quant"] = policy_by_name(args.quant)
    for flag in ("cast_params_early", "shard_expert_cap", "tp_bf16_reduce",
                 "fsdp_gather_weights", "moe_grouped_dispatch"):
        if getattr(args, flag):
            overrides[flag] = True

    archs = configs.ARCH_NAMES if args.arch == "all" else [args.arch]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    steps = {}
    for arch in archs:
        shapes = ([s.name for s in configs.runnable_shapes(arch)]
                  if args.shape == "all" else [args.shape])
        for shape_name in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape_name, mp, args.out,
                             cfg_overrides=overrides or None, tag=args.tag,
                             accum=args.accum, steps=steps)
                except Exception as e:
                    failures.append((arch, shape_name, mp, repr(e)))
                    print(f"[dryrun] {arch} x {shape_name} x multipod={mp}: "
                          f"FAIL {e}")
                    traceback.print_exc()
                    if not args.continue_on_error:
                        raise
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("   ", f)
        raise SystemExit(1)
    print("[dryrun] all requested cells reckoned.")


if __name__ == "__main__":
    main()
