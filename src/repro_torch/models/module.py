"""Minimal parameter system (PyTorch port of `repro.models.module`).

A model is described by a tree (nested dicts) of `ParamSpec`s; `init_params`
materializes it on a device from an explicit `torch.Generator`.  The draws
do not match the reference's `jax.random` streams: parity tests carry the
reference's parameters over instead (`packing.params_from_numpy`).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | fan_in | embed
    dtype: Any = torch.float32


def tree_map(fn, tree):
    """Apply fn to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    """Leaves of a nested-dict tree, in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _init_leaf(s: ParamSpec, generator: torch.Generator, device):
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    if s.init in ("normal", "embed", "fan_in"):
        std = {"normal": 0.02, "embed": 1.0}.get(s.init)
        if std is None:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = 1.0 / math.sqrt(fan_in)
        out = torch.randn(s.shape, generator=generator, device=device,
                          dtype=torch.float32)
        return out.mul_(std).to(s.dtype)
    if s.init.startswith("const:"):
        return torch.full(s.shape, float(s.init.split(":")[1]), dtype=s.dtype,
                          device=device)
    raise ValueError(f"unknown init '{s.init}'")


def init_params(generator: torch.Generator, specs, device):
    """Materialize a spec tree on `device`, drawing leaves in sorted-key
    order from `generator` (which must live on that device)."""
    if isinstance(specs, dict):
        return {k: init_params(generator, specs[k], device)
                for k in sorted(specs)}
    return _init_leaf(specs, generator, device)


def param_count(specs) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(specs)))


def param_bytes(specs) -> int:
    return int(sum(np.prod(s.shape) * s.dtype.itemsize
                   for s in tree_leaves(specs)))
