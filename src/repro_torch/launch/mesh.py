"""Serving mesh construction (PyTorch port of `repro.launch.mesh`).

`make_production_mesh` / `make_host_mesh` (the reference's TPU pod
meshes) and `HW` (a TPU's peak figures) are not ported: the port runs on
one card or a few, and `chip_smoke.py` carries the H100's figures.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.parallel.sharding import Mesh


def make_serving_mesh(n_devices: int = 0,
                      devices: Optional[Sequence] = None) -> Mesh:
    """1-D ("model",) mesh of n_devices shards, the axis the sharding rules
    map kv_pages onto, so `ServingEngine(mesh=...)` splits its page pool
    n_devices ways.

    Placement: `devices` when given (its first n_devices entries; n_devices
    0 takes them all), else shard i on cuda:(i mod torch.cuda.device_count())
    — on one card every shard is a page range of cuda:0, on n cards shard i
    is card i.  Raises without a card unless `devices` is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_serving_mesh places shards on CUDA devices and none is "
                "available; pass devices=[...] (e.g. torch.device('cpu') per "
                "shard) to build a mesh on other devices")
        count = torch.cuda.device_count()
        n = n_devices or count
        devices = [torch.device("cuda", i % count) for i in range(n)]
    else:
        devices = [torch.device(d) for d in devices]
        n = n_devices or len(devices)
        if n > len(devices):
            raise ValueError(f"{n} shards need {n} devices, got "
                             f"{len(devices)}")
        devices = devices[:n]
    return Mesh(("model",), (n,), tuple(devices))


def placement(mesh: Mesh) -> str:
    """One line naming each shard's device, e.g. 'model[0]=cuda:0
    model[1]=cuda:0'."""
    name = mesh.axis_names[0] if len(mesh.axis_names) == 1 else "device"
    return " ".join(f"{name}[{i}]={d}" for i, d in enumerate(mesh.devices))

