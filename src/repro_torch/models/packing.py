"""One-shot param packing: float weights -> posit-code weight tensors
(PyTorch port of `repro.models.packing`, dense family).

Only the weights consumed through the GEMM dispatch layer pack (the
attention and MLP projections, and an untied head); norms and the
embedding, read by indexing, stay float.  Packing is one rounding per
weight (posit encode), identical to the reference's `pack_params`; the
encode runs through `kernels.ops.encode` (K2 on CUDA), one layer at a
time so the transient stays one layer wide.

`params_from_numpy` carries a parameter tree of the JAX package (leaves
as numpy arrays, float masters or packed codes) over to the port.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.formats import PositFormat
from repro_torch.core.posit import storage_dtype
from repro_torch.kernels import ops
from .config import ModelConfig
from .module import tree_leaves, tree_map

_ATTN_NAMES = ("wq", "wk", "wv", "wo")
_MLP_NAMES = ("wi_gate", "wi_up", "wo_mlp")
_PORTED_FAMILIES = ("dense",)


def packable_paths(cfg: ModelConfig) -> Tuple[Tuple[str, ...], ...]:
    """Paths (key tuples) of the weight leaves that pack to posit codes."""
    if cfg.family not in _PORTED_FAMILIES:
        raise NotImplementedError(
            f"param packing for family '{cfg.family}' is not ported yet "
            f"(have {_PORTED_FAMILIES}; ROADMAP queue 1)")
    paths = [("layers", n) for n in _ATTN_NAMES + _MLP_NAMES]
    if not cfg.tie_embeddings:
        paths.append(("head",))
    return tuple(paths)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _fmt(cfg: ModelConfig, fmt: PositFormat, what: str) -> PositFormat:
    fmt = fmt or cfg.quant.weights
    if fmt is None:
        raise ValueError(f"{what} needs a weights format "
                         f"(cfg.quant.weights or explicit fmt)")
    return fmt


def pack_params(params, cfg: ModelConfig, fmt: PositFormat = None):
    """Replace every packable float weight with posit codes (int8/int16).
    Layer-stacked leaves [L, ...] encode one layer at a time."""
    fmt = _fmt(cfg, fmt, "pack_params")
    packed = _copy_tree(params)
    for path in packable_paths(cfg):
        leaf = _get(params, path)
        if path[0] == "layers":
            codes = torch.empty(leaf.shape, dtype=storage_dtype(fmt),
                                device=leaf.device)
            for i in range(leaf.shape[0]):
                codes[i] = ops.encode(leaf[i].to(torch.float32), fmt)
        else:
            codes = ops.encode(leaf.to(torch.float32), fmt)
        _set(packed, path, codes)
    return packed


def packed_param_specs(cfg: ModelConfig, fmt: PositFormat = None):
    """param_specs with packable leaves re-typed to the code storage dtype —
    the `like` tree for restoring a packed checkpoint."""
    from . import api

    fmt = _fmt(cfg, fmt, "packed_param_specs")
    out = _copy_tree(api.param_specs(cfg))
    for path in packable_paths(cfg):
        spec = _get(out, path)
        _set(out, path, spec._replace(dtype=storage_dtype(fmt)))
    return out


def pack_manifest(cfg: ModelConfig, fmt: PositFormat = None) -> dict:
    """Checkpoint `extra` metadata marking a packed-weights checkpoint."""
    fmt = _fmt(cfg, fmt, "pack_manifest")
    return {"packed_weights": True, "weights_format": str(fmt),
            "weights_n": fmt.n, "weights_es": fmt.es}


def weight_bytes(params) -> int:
    """Total weight storage footprint (device-resident bytes)."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(params)))


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """The reference's parameter tree (nested dicts of numpy arrays, float
    masters or packed codes) -> the port's parameters on `device`.  Leaf
    names and layouts are kept ([L, D, N] stacks, embed [V, D]); every leaf
    the config's param_specs names must be present."""
    from repro_torch import resolve_device
    from . import api

    device = resolve_device(device)
    expected = {"/".join(p) for p in _spec_paths(api.param_specs(cfg))}
    got = {"/".join(p) for p in _spec_paths(tree)}
    if expected != got:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"{sorted(expected ^ got)[:5]}")
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def _spec_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], prefix + (k,))
    else:
        yield prefix
