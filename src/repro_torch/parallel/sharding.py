"""Logical-axis sharding rules (PyTorch port of `repro.parallel.sharding`).

Every parameter and cache leaf of `repro_torch.models` carries logical
axis names (`ParamSpec.logical_axes`); the rule table maps them onto the
physical axes of a mesh, dropping any assignment whose dimension the mesh
axis does not divide or whose axis the mesh lacks.  The serving engine
reads one rule from it, `kv_pages`: the mesh axis its page pool splits
over (models/paged.py, serve/engine.py).

`Mesh` is the port's own small mesh: axis names, their sizes and the
devices in row-major order.  A spec is a plain tuple with one entry per
dimension: None (replicated), an axis name, or a tuple of axis names.

Not ported: `constrain`, `shard_map` and `sharding_for`.  They hand specs
to XLA's partitioner (`with_sharding_constraint`, GSPMD, a fully-manual
`shard_map`), which has no PyTorch counterpart.  The engine dispatches
each shard's work explicitly instead (models/paged.py's `PageShard`).

Physical axes:
  pod   : slowest interconnect — data parallel only
  data  : data parallel + parameter sharding
  model : tensor / expert parallel; the paged KV pool's page dimension
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

# logical axis -> mesh axis (or tuple of mesh axes). None = replicate.
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",        # sequence-sharded KV cache (long-context decode)
    "kv_pages": "model",      # paged KV: the page pool shards over the same
                              # axis as kv_seq (a page is a sequence block)
    "embed": "data",
    "embed_act": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_cap": "data",
    "expert_mlp": None,
    "vocab": "model",
    "layers": None,
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    "stack": None,
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named device mesh: `axis_names` with sizes `sizes`, `devices` the
    flat row-major list of torch devices (a device may repeat: several
    shards of one card)."""

    axis_names: tuple
    sizes: tuple
    devices: tuple

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "sizes", tuple(int(n) for n in self.sizes))
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        n = 1
        for s in self.sizes:
            n *= s
        if n != len(self.devices):
            raise ValueError(f"a mesh of shape {self.sizes} needs {n} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.sizes))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple = tuple(sorted(DEFAULT_RULES.items()))

    def as_dict(self):
        return dict(self.rules)

    def replace(self, **kw):
        d = self.as_dict()
        d.update(kw)
        return ShardingRules(tuple(sorted(d.items())))


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             mesh: Mesh, rules: ShardingRules = ShardingRules()) -> tuple:
    """The spec of a leaf: assignments that do not divide evenly, that name
    axes missing from this mesh (e.g. 'pod' on one pod) or whose axes an
    earlier dimension already took are dropped (a tuple shrinks from the
    right first)."""
    table = rules.as_dict()
    sizes = mesh.shape
    used = set()
    entries = []
    for dim, name in zip(shape, logical_axes):
        phys = table.get(name) if name is not None else None
        if phys is None:
            entries.append(None)
            continue
        phys_t = tuple(a for a in (phys if isinstance(phys, (tuple, list))
                                   else (phys,))
                       if a in sizes and a not in used)

        def size_of(axes):
            out = 1
            for a in axes:
                out *= sizes[a]
            return out

        size = size_of(phys_t)
        while phys_t and (size <= 1 or dim % size != 0):
            phys_t = phys_t[:-1]
            size = size_of(phys_t)
        if not phys_t or size <= 1 or dim % size != 0:
            entries.append(None)
            continue
        used.update(phys_t)
        entries.append(phys_t if len(phys_t) > 1 else phys_t[0])
    return tuple(entries)


def mesh_axes_for(logical: str, mesh: Mesh,
                  rules: ShardingRules = ShardingRules()) -> tuple:
    """Physical mesh axes the rule table maps `logical` onto, restricted to
    axes present in this mesh (absent ones are dropped, the fallback
    `spec_for` applies)."""
    phys = rules.as_dict().get(logical)
    if phys is None:
        return ()
    phys_t = phys if isinstance(phys, (tuple, list)) else (phys,)
    return tuple(a for a in phys_t if a in mesh.shape)


def mesh_axis_size(logical: str, mesh: Mesh,
                   rules: ShardingRules = ShardingRules()) -> int:
    """Devices a `logical` axis shards over on this mesh (1 when its
    physical axes are absent: replicated)."""
    out = 1
    for a in mesh_axes_for(logical, mesh, rules):
        out *= mesh.shape[a]
    return out


def tree_specs(spec_tree, mesh: Mesh, rules: ShardingRules = ShardingRules()):
    """A nested-dict tree of ParamSpecs (models/module.py) -> the same tree
    of specs."""
    from repro_torch.models.module import tree_map
    return tree_map(lambda ps: spec_for(ps.shape, ps.logical_axes, mesh,
                                        rules), spec_tree)
