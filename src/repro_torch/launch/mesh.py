"""Serving and training mesh construction (PyTorch port of
`repro.launch.mesh`).

`make_production_mesh` / `make_host_mesh` (the reference's TPU pod
meshes) and `HW` (a TPU's peak figures) are not ported: the port runs on
one card or a few, and `chip_smoke.py` carries the H100's figures.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.parallel.sharding import Mesh


def _place(n: int, devices: Optional[Sequence], what: str) -> tuple:
    """n devices: the first n of `devices` (n 0: all of them), else
    cuda:(i mod torch.cuda.device_count()) for i < n (n 0: one a card).
    Raises without a card unless `devices` is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} places its devices on CUDA and none is "
                "available; pass devices=[...] (e.g. torch.device('cpu') per "
                "entry) to build a mesh on other devices")
        count = torch.cuda.device_count()
        n = n or count
        return tuple(torch.device("cuda", i % count) for i in range(n))
    devices = [torch.device(d) for d in devices]
    n = n or len(devices)
    if n > len(devices):
        raise ValueError(f"{n} mesh positions need {n} devices, got "
                         f"{len(devices)}")
    return tuple(devices[:n])


def make_serving_mesh(n_devices: int = 0,
                      devices: Optional[Sequence] = None) -> Mesh:
    """1-D ("model",) mesh of n_devices shards, the axis the sharding rules
    map kv_pages onto, so `ServingEngine(mesh=...)` splits its page pool
    n_devices ways.

    Placement: `devices` when given (its first n_devices entries; n_devices
    0 takes them all), else shard i on cuda:(i mod torch.cuda.device_count())
    — on one card every shard is a page range of cuda:0, on n cards shard i
    is card i.  Raises without a card unless `devices` is given."""
    devices = _place(n_devices, devices, "make_serving_mesh")
    return Mesh(("model",), (len(devices),), devices)


def make_train_mesh(n_pods: int, n_data: int,
                    devices: Optional[Sequence] = None) -> Mesh:
    """("pod", "data", "model") mesh of n_pods x n_data x 1 replicas for
    `train.make_train_step_compressed`, row-major: replica p n_data + d on
    the (p n_data + d)-th device, placed by `make_serving_mesh`'s rule (on
    one card every replica is cuda:0 and they run one after another)."""
    if n_pods < 1 or n_data < 1:
        raise ValueError(f"a mesh of {n_pods} pods x {n_data} data replicas")
    devices = _place(n_pods * n_data, devices, "make_train_mesh")
    return Mesh(("pod", "data", "model"), (n_pods, n_data, 1), devices)


def placement(mesh: Mesh) -> str:
    """One line naming each shard's device, e.g. 'model[0]=cuda:0
    model[1]=cuda:0'."""
    name = mesh.axis_names[0] if len(mesh.axis_names) == 1 else "device"
    return " ".join(f"{name}[{i}]={d}" for i, d in enumerate(mesh.devices))

