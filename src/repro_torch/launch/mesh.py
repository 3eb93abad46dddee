"""Mesh construction and the card's figures (PyTorch port of
`repro.launch.mesh`).

`make_serving_mesh` / `make_train_mesh` place their positions on cards
(or on the devices passed).  `make_production_mesh` / `make_host_mesh`
are the reference's pod meshes as shapes only: every position is the meta
device, so the dry run (launch/dryrun.py) reckons a cell on them without
touching a device.  `HW` holds the figures of the card the port runs on,
an NVIDIA H100 80GB HBM3 at 700 W, from its data sheet: the dry run's
roofline terms and PERF.md's bounds divide by them.
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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, shape only: 16 x 16 ("data",
    "model"), or 2 x 16 x 16 with "pod" in front, every position on the
    meta device."""
    if multi_pod:
        return make_host_mesh(16, 16, 2)
    return make_host_mesh(16, 16)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1) -> Mesh:
    """A ("data", "model") mesh, ("pod", "data", "model") when pod > 1,
    every position on the meta device (shapes only)."""
    if pod > 1:
        axes, sizes = ("pod", "data", "model"), (pod, data, model)
    else:
        axes, sizes = ("data", "model"), (data, model)
    n = 1
    for s in sizes:
        n *= s
    return Mesh(axes, sizes, (torch.device("meta"),) * n)


# NVIDIA H100 80GB HBM3 (SXM), 700 W, data sheet: the rates PERF.md §6's
# bounds use.  No figure here was measured.
HW = {
    "name": "NVIDIA H100 80GB HBM3, 700 W (data sheet)",
    "peak_flops_bf16": 989e12,     # dense bf16 on the tensor cores, FLOP/s
    "peak_flops_f32": 67e12,       # f32 FMA outside the tensor cores
    "peak_int32_ops": 16.7e12,     # 64 INT32 lanes x 132 SMs x 1.98 GHz
    "hbm_bw": 3.35e12,             # HBM3, B/s
    "hbm_bytes": 80e9,
    # NVLink 4's data-sheet figure, 900 GB/s a card both ways: 450 GB/s
    # for the bytes a position sends.  Not measured (one card).
    "interconnect_bw": 450e9,
    "interconnect": "NVLink 4, data sheet (900 GB/s both ways), not measured",
}
