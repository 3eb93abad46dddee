"""Training step: microbatched gradient accumulation, the posit-aware
loss and the optimizer update (PyTorch port of `repro.train.step`).

The global batch is split into `accum` microbatches; each runs forward
and backward (each layer recomputed in the backward under
`cfg.remat == "layer"`), its gradients accumulating into the parameters'
`.grad` (the first microbatch's gradient becomes `.grad`, later ones add
in place: the reference's 0 + g1 + g2, bitwise), which are then divided
by `accum` in place.  Holding one f32 gradient per parameter, not a sum
beside each microbatch's gradient, is what lets a full-width model train
on one card.  The execution plan in `cfg.quant` picks the GEMM datapath
of forward and backward: fake_quant (STE on float dots) or fused (the
serving kernels' forward, the STE backward of `kernels/ops.py`); bit_exact
is rejected up front.

The step updates the state's tensors in place (parameters, optimizer
moments) and returns a new `TrainState` holding them.

`make_train_step_compressed` runs the same loss over the replicas of a
("pod", "data", "model") mesh and reduces their gradients across the
slow 'pod' axis with the posit-compressed exchange of `optim.compress`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.formats import P8_2
from repro_torch.models import api, common
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import compress
from repro_torch.optim.optimizers import Optimizer


class TrainState(NamedTuple):
    params: object
    opt_state: object
    step: torch.Tensor


def init_state(generator: torch.Generator, cfg: ModelConfig, opt: Optimizer,
               device="cuda") -> TrainState:
    """Random parameters drawn from `generator` on `device` (a card by
    default), the optimizer's initial state, step 0."""
    params = api.init(generator, cfg, device)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32))


def loss_fn(params, batch, cfg: ModelConfig, aux_weight: float = 0.01):
    """Mean cross-entropy of the model's logits against batch["labels"],
    plus `aux_weight` times the MoE family's load-balance loss; returns
    (loss, {"ce", "aux"})."""
    if cfg.cast_params_early:
        cd = cfg.compute_dtype
        params = tree_map(
            lambda p: p.to(cd) if p.dtype == torch.float32 else p, params)
    if cfg.family in ("moe", "hybrid"):
        logits, aux = api.apply(params, batch, cfg, with_aux=True)
    else:
        logits = api.apply(params, batch, cfg)
        aux = 0.0
    loss = common.cross_entropy(logits, batch["labels"])
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _count(n: int, like):
    """n as an f32 tensor on like's device: a true divisor there (on the
    card PyTorch divides by a host scalar through its reciprocal)."""
    return torch.tensor(n, dtype=torch.float32, device=like.device)


def make_train_step(cfg: ModelConfig, opt: Optimizer, accum: int = 1):
    """Returns train_step(state, batch) -> (state', metrics), batch a dict
    of [B, S] tensors on the parameters' device, B divisible by accum."""
    cfg.quant.require_trainable()

    def train_step(state: TrainState, batch):
        B = batch["labels"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not divisible by accum {accum}")
        params = state.params
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        msum = None
        for i in range(accum):
            mb = {k: v.reshape((accum, B // accum) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            loss, metrics = loss_fn(params, mb, cfg)
            loss.backward()
            m = {"loss": loss, **metrics}
            m = {k: torch.as_tensor(v, dtype=torch.float32,
                                    device=loss.device).detach()
                 for k, v in m.items()}
            msum = m if msum is None else {k: msum[k] + m[k] for k in m}
        with torch.no_grad():
            for p in leaves:
                if p.grad is None:   # a parameter the loss does not reach
                    p.grad = torch.zeros_like(p)
                p.grad.div_(_count(accum, p))
            grads = tree_map(lambda p: p.grad, params)
            metrics = {k: torch.div(v, _count(accum, v))
                       for k, v in msum.items()}
            updates, opt_state = opt.update(grads, state.opt_state, params)
            del grads
            for p in leaves:
                p.grad = None
            for p, u in zip(leaves, tree_leaves(updates)):
                p.add_(u)
            del updates
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch, cfg)
        return {"loss": loss, **metrics}
    return eval_step


# ---------------------------------------------------------------------------
# posit-compressed cross-pod gradient reduction
# ---------------------------------------------------------------------------


def make_train_step_compressed(cfg: ModelConfig, opt: Optimizer, mesh,
                               fmt=None, accum: int = 1):
    """Train step with a P(8,2)-compressed gradient all-reduce over 'pod'.

    `mesh` is a port `Mesh` (parallel/sharding.py) with axes ("pod",
    "data", "model"), e.g. `launch.mesh.make_train_mesh`.  Data parallel
    over (pod, data): the batch's leading dim splits into n_pods x n_data
    blocks in the reference's pod-major order (replica p n_data + d takes
    block p n_data + d); each replica takes its local gradient on its mesh
    device (the first of its 'model' group: the reference runs 'model'
    replicated here, so the group's other devices would repeat it).
    Gradients are averaged in f32 over the fast in-pod 'data' axis, then
    reduced over the slow 'pod' axis by `compress.compressed_psum_leaf`
    (int8 codes between pods, persistent error feedback); the metrics are
    the mean over every replica.  The optimizer updates the parameters
    once, in place, on the mesh's first device, where they live; replicas
    on other devices take a copy each step.

    Replicas that share a device run one after another, and a pod's data
    replicas on one device sum their gradients in place in the
    parameters' `.grad` (data order), so a step holds the masters, the
    optimizer state, n_pods error trees and n_pods gradient trees, plus
    one leaf's reduction at a time.  The error tree (`init_err`) has a
    leading pod dim, as the reference's; pod i's residuals are row i, on
    the mesh's first device, updated in place and returned.

    Returns train_step((state, err_tree), batch) -> ((state', err_tree'),
    metrics); `train_step.init_err(params)` makes the zero error tree.
    Like the reference's, the step takes each replica's batch whole:
    `accum` must be 1."""
    cfg.quant.require_trainable()
    fmt = fmt or P8_2
    if accum != 1:
        raise ValueError("make_train_step_compressed takes each replica's "
                         "batch whole (accum 1), as the reference's does")
    if tuple(mesh.axis_names) != ("pod", "data", "model"):
        raise ValueError(f"the compressed step needs a ('pod', 'data', "
                         f"'model') mesh, got axes {mesh.axis_names}")
    n_pods, n_data, n_model = mesh.sizes
    n_rep = n_pods * n_data
    # replica p n_data + d on the first device of its model group
    rep_dev = [mesh.devices[r * n_model] for r in range(n_rep)]

    def init_err(params):
        """Per-pod persistent error-feedback residuals, stacked on a pod
        dim: f32 zeros [n_pods, *shape] beside each parameter."""
        return tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape),
                                              dtype=torch.float32,
                                              device=p.device), params)

    def train_step(state_and_err, batch):
        state, err_tree = state_and_err
        params = state.params
        B = batch["labels"].shape[0]
        if B % n_rep:
            raise ValueError(f"batch {B} is not divisible by the {n_rep} "
                             f"(pod, data) replicas")
        home = tree_leaves(params)[0].device
        copies = {home: params}
        for dev in rep_dev:
            if dev not in copies:
                copies[dev] = tree_map(lambda p: p.detach().to(dev), params)
        msum = None
        pod_grads = []
        for p in range(n_pods):
            # the f32 mean over 'data': each device's replicas add into
            # its copy's .grad in data order, devices then in order
            used = []
            for d in range(n_data):
                r = p * n_data + d
                dev = rep_dev[r]
                prm = copies[dev]
                if dev not in used:
                    used.append(dev)
                    for t in tree_leaves(prm):
                        t.requires_grad_(True)
                        t.grad = None
                local = {k: v.reshape((n_rep, B // n_rep)
                                      + tuple(v.shape[1:]))[r].to(dev)
                         for k, v in batch.items()}
                loss, metrics = loss_fn(prm, local, cfg)
                loss.backward()
                m = {k: torch.as_tensor(v, dtype=torch.float32,
                                        device=home).detach()
                     for k, v in {"loss": loss, **metrics}.items()}
                msum = m if msum is None else {k: msum[k] + m[k] for k in m}
                del loss, metrics
            with torch.no_grad():
                acc = None
                for dev in used:
                    leaves = tree_leaves(copies[dev])
                    g = [t.grad if t.grad is not None else torch.zeros_like(t)
                         for t in leaves]
                    for t in leaves:
                        t.grad = None
                    if acc is None:
                        acc = g
                    else:
                        for a, b in zip(acc, g):
                            a.add_(b.to(a.device))
                    del g
                for a in acc:
                    a.div_(_count(n_data, a))
            pod_grads.append(acc)
        with torch.no_grad():
            reduced = []
            err_leaves = tree_leaves(err_tree)
            pod_dev = [rep_dev[p * n_data] for p in range(n_pods)]
            for i, e in enumerate(err_leaves):
                gs = [pod_grads[p][i] for p in range(n_pods)]
                errs = [e[p].to(pod_dev[p]) for p in range(n_pods)]
                red, new = compress.compressed_psum_leaf(gs, errs, fmt)
                for p in range(n_pods):
                    e[p].copy_(new[p])
                    pod_grads[p][i] = None
                reduced.append(red[0].to(home))
                del gs, errs, red, new
            del pod_grads
            grads = tree_unflatten(params, reduced)
            del reduced
            metrics = {k: torch.div(v, _count(n_rep, v))
                       for k, v in msum.items()}
            updates, opt_state = opt.update(grads, state.opt_state, params)
            del grads
            for t, u in zip(tree_leaves(params), tree_leaves(updates)):
                t.add_(u)
            del updates
        return ((TrainState(params, opt_state, state.step + 1), err_tree),
                metrics)

    train_step.init_err = init_err
    return train_step
