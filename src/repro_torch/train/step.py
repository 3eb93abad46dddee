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
moments) and returns a new `TrainState` holding them.  The reference's
posit-compressed cross-pod step (`make_train_step_compressed`) is not
ported: it needs sharding (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import api, common
from repro_torch.models.config import ModelConfig
from repro_torch.models.module import tree_leaves, tree_map
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
    """Mean cross-entropy of the model's logits against batch["labels"];
    returns (loss, {"ce", "aux"}).  Dense family only (the MoE auxiliary
    loss waits for `moe.apply`)."""
    if cfg.cast_params_early:
        cd = cfg.compute_dtype
        params = tree_map(
            lambda p: p.to(cd) if p.dtype == torch.float32 else p, params)
    if cfg.family in ("moe", "hybrid"):
        raise NotImplementedError(
            f"training of family {cfg.family!r} is not ported yet")
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
