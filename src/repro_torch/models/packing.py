"""One-shot param packing: float weights -> posit-code weight tensors
(PyTorch port of `repro.models.packing`).

Only the weights consumed through the GEMM dispatch layer pack (the
attention and MLP projections, the routed expert stacks and shared
experts of a MoE, the SSM in / out projections, and an untied head);
norms, routers, conv taps, the SSM scan's parameters, the embedding, read
by indexing, and a stub frontend's `frontend_proj` (a plain float product)
stay float.  Packing is one rounding per weight (posit
encode), identical to the reference's `pack_params`; the encode runs
through `kernels.ops.encode` (K2 on CUDA), one layer (or hybrid block) at
a time so the transient stays that wide; `unpack_params` decodes the codes
back (K1 on CUDA).

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
_EXPERT_NAMES = ("we_gate", "we_up", "we_down")   # stacked: qdot_grouped
_SHARED_EXPERT_NAMES = ("ws_gate", "ws_up", "ws_down")
_SSM_NAMES = ("in_proj", "out_proj")
_STACKS = ("layers", "blocks")


def packable_paths(cfg: ModelConfig) -> Tuple[Tuple[str, ...], ...]:
    """Paths (key tuples) of the weight leaves that pack to posit codes."""
    if cfg.family == "hybrid":
        # jamba-style blocks: attention, mamba, dense-FFN and MoE sub-trees
        paths = [("blocks", "attn", n) for n in _ATTN_NAMES]
        paths += [("blocks", "mamba", n) for n in _SSM_NAMES]
        paths += [("blocks", "ffn", n) for n in _MLP_NAMES]
        paths += [("blocks", "moe", n) for n in _EXPERT_NAMES]
    else:
        if cfg.family == "moe":
            names = _ATTN_NAMES + _EXPERT_NAMES
            if cfg.n_shared_experts:
                names += _SHARED_EXPERT_NAMES
        elif cfg.family == "ssm":
            names = _SSM_NAMES
        else:   # dense, encoder, vlm
            names = _ATTN_NAMES + _MLP_NAMES
        paths = [("layers", n) for n in names]
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
    Stacked leaves ([L, ...] layers, [nb, ...] hybrid blocks) encode one
    entry of the stack at a time."""
    fmt = _fmt(cfg, fmt, "pack_params")
    packed = _copy_tree(params)
    for path in packable_paths(cfg):
        leaf = _get(params, path)
        if path[0] in _STACKS:
            codes = torch.empty(leaf.shape, dtype=storage_dtype(fmt),
                                device=leaf.device)
            for i in range(leaf.shape[0]):
                codes[i] = ops.encode(leaf[i].to(torch.float32), fmt)
        else:
            codes = ops.encode(leaf.to(torch.float32), fmt)
        _set(packed, path, codes)
    return packed


def unpack_params(params, cfg: ModelConfig, fmt: PositFormat = None,
                  dtype=torch.float32):
    """Inverse of pack_params: decode every code leaf back to float values
    of `dtype` (K1 on CUDA; decoded to f32, then cast).  Stacked leaves
    decode one entry of the stack at a time."""
    fmt = _fmt(cfg, fmt, "unpack_params")
    out = _copy_tree(params)
    for path in packable_paths(cfg):
        leaf = _get(params, path)
        if path[0] in _STACKS:
            vals = torch.empty(leaf.shape, dtype=dtype, device=leaf.device)
            for i in range(leaf.shape[0]):
                vals[i] = ops.decode(leaf[i], fmt).to(dtype)
        else:
            vals = ops.decode(leaf, fmt).to(dtype)
        _set(out, path, vals)
    return out


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
    names and layouts are kept ([L, D, N] stacks, a hybrid's [nb, ...]
    blocks, embed [V, D]); every leaf
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
