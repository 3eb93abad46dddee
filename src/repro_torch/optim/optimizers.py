"""Optimizers and learning-rate schedules (PyTorch port of
`repro.optim.optimizers`).

The interface is the reference's, over nested dicts of tensors:
``opt.init(params) -> state``, ``opt.update(grads, state, params) ->
(updates, state)``; the caller adds the updates to the parameters.  The
update math is the reference's, operation for operation (AdamW's b2 0.95
and decoupled decay, adafactor's factored second moment), not
`torch.optim`'s: parity with the reference is the point.

Memory: the moment tensors are updated in place (the returned state holds
the same tensors as the one passed in), and each leaf's temporaries are
freed before the next leaf's, so an update holds the moments, the
gradients and the new updates at once and little else.  Scalars (the
step, the learning rate, bias corrections) are 0-dim f32 tensors on the
host, as the reference's traced f32 scalars; a divisor moves to the
leaf's device first, because on the card PyTorch divides by a host scalar
as a multiply by its reciprocal, which rounds differently.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.models.module import tree_leaves, tree_map

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)


def _scalar(v) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32)


def _on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device)


def _tree_zip(fn, *trees):
    """fn over the leaves of same-structured nested dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_zip(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


# ---------------------------------------------------------------------------
# schedules (step -> 0-dim f32 learning rate)
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(_F32)
        warm = peak_lr * (step + 1) / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(_scalar(math.pi) * prog))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


def constant_schedule(lr_val: float):
    return lambda step: _scalar(lr_val)


# ---------------------------------------------------------------------------
# gradient transforms
# ---------------------------------------------------------------------------

def global_norm(tree):
    """sqrt of the sum over leaves (sorted-key order) of sum(x^2), f32."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(_F32))).cpu()
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(g, max_norm: float):
    return torch.minimum(_scalar(1.0), torch.div(
        _scalar(max_norm), torch.maximum(g, _scalar(1e-9))))


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda x: x * scale, tree), g


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor
    mu: object
    nu: object


def adamw(lr: Callable, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=_F32)  # noqa: E731
        return AdamState(torch.zeros((), dtype=torch.int32),
                         tree_map(z, params), tree_map(z, params))

    def update(grads, state, params):
        # clip_by_global_norm's factor, applied leaf by leaf below
        scale = (None if max_grad_norm is None
                 else _clip_scale(global_norm(grads), max_grad_norm))
        step = state.step + 1
        stepf = step.to(_F32)
        bc1 = 1 - torch.pow(_scalar(b1), stepf)
        bc2 = 1 - torch.pow(_scalar(b2), stepf)
        neg_lr = -lr(step)

        def leaf(g, m, v, p):
            g = g.to(_F32)
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            del g
            u = torch.div(m, _on(bc1, m))
            den = torch.div(v, _on(bc2, v)).sqrt_().add_(eps)
            u.div_(den)
            del den
            u.add_(p.to(_F32) * weight_decay)
            return u.mul_(neg_lr).to(p.dtype)

        updates = _tree_zip(leaf, grads, state.mu, state.nu, params)
        return updates, AdamState(step, state.mu, state.nu)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------

class FactorState(NamedTuple):
    step: torch.Tensor
    vr: object  # row stats (or the full v for leaves below 2-D)
    vc: object  # column stats (or a 0-dim placeholder)


def adafactor(lr: Callable, eps=1e-30, clip_thresh=1.0,
              weight_decay=0.0) -> Optimizer:
    def init(params):
        def vr(p):
            return (torch.zeros(p.shape[:-1], dtype=_F32, device=p.device)
                    if p.ndim >= 2 else torch.zeros_like(p, dtype=_F32))

        def vc(p):
            return (torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=_F32,
                                device=p.device)
                    if p.ndim >= 2 else torch.zeros((), dtype=_F32,
                                                    device=p.device))

        return FactorState(torch.zeros((), dtype=torch.int32),
                           tree_map(vr, params), tree_map(vc, params))

    def update(grads, state, params):
        step = state.step + 1
        beta = 1.0 - (step.to(_F32) + 1) ** -0.8
        neg_lr = -lr(step)

        def leaf(g, vr, vc, p):
            g = g.to(_F32)
            g2 = torch.square(g) + eps
            if p.ndim >= 2:
                vr_n = beta * vr + (1 - beta) * g2.mean(-1)
                vc_n = beta * vc + (1 - beta) * g2.mean(-2)
                denom = torch.div(
                    vr_n[..., None] * vc_n[..., None, :],
                    torch.clamp(vr_n.mean(-1)[..., None, None], min=eps))
                u = g * torch.rsqrt(denom + eps)
            else:
                vr_n = beta * vr + (1 - beta) * g2
                vc_n = vc
                u = g * torch.rsqrt(vr_n + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = torch.div(u, torch.clamp(
                torch.div(rms, _on(_scalar(clip_thresh), rms)), min=1.0))
            u = u + weight_decay * p.to(_F32)
            return (neg_lr * u).to(p.dtype), vr_n, vc_n

        out = _tree_zip(leaf, grads, state.vr, state.vc, params)
        pick = lambda i: _tree_zip(lambda t: t[i], out)  # noqa: E731
        return pick(0), FactorState(step, pick(1), pick(2))

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# SGD + momentum (baseline)
# ---------------------------------------------------------------------------

class SgdState(NamedTuple):
    step: torch.Tensor
    mom: object


def sgdm(lr: Callable, momentum=0.9) -> Optimizer:
    def init(params):
        return SgdState(torch.zeros((), dtype=torch.int32),
                        tree_map(lambda p: torch.zeros_like(p, dtype=_F32),
                                 params))

    def update(grads, state, params):
        step = state.step + 1
        neg_lr = -lr(step)

        def leaf(m, g):
            return m.mul_(momentum).add_(g.to(_F32))

        mom = _tree_zip(leaf, state.mom, grads)
        updates = _tree_zip(lambda m, p: (neg_lr * m).to(p.dtype), mom,
                            params)
        return updates, SgdState(step, mom)

    return Optimizer(init, update)


def by_name(name: str, lr_fn) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn)
    if name == "adafactor":
        return adafactor(lr_fn)
    if name == "sgdm":
        return sgdm(lr_fn)
    raise KeyError(f"unknown optimizer '{name}'")
