"""What one step does on the card, counted on meta tensors (PyTorch port
of `repro.launch.hlo_analysis`).

The reference parses the compiled per-device HLO and multiplies loop
bodies by their trip counts.  The port has no HLO: `analyze_step(fn,
*args)` runs the step itself on meta tensors (shapes and dtypes, no
data, no device) under a `TorchDispatchMode` and counts every operation
as the card would run it eagerly, one launch each, nothing fused.  The
layers run as a Python loop, so every layer is counted: the reference's
trip-count problem does not arise.

  flops            : 2 * out * contracted of every matmul-family op (mm,
                     bmm, addmm, baddbmm, convolution), as the reference
                     counts a dot, plus each hand kernel's products
  hbm_bytes        : operand plus output bytes of every device op (the
                     reference's top-level-op proxy; eagerly each op is a
                     launch), plus each hand kernel's bytes
                     (`kernels/work.py`)
  launches         : hand-kernel launches by kernel and by
                     "kernel:variant", the keys of `ops.launch_counts()`
  device_ops       : every launch on the device, hand kernels and aten
  compute_s        : the operations over the peak of their class (f32 FMA,
                     bf16 tensor cores, int32 lanes)
  collective_*     : bytes a mesh position hands to another, counted where
                     the port's own code hands them over
                     (`kernels/work.exchange`), under the exchange's name
  transfers        : copies between host and device (a host scalar moved
                     to the device, a device value copied to the host)
  peak_live_bytes  : the most bytes of device storage live at once, the
                     step's inputs and state live from the start; views
                     share their storage's bytes

A read of a device value on the host that steers what runs next (`.item()`,
`bool(t)`, `.tolist()`, an output sized by the data such as `nonzero`)
cannot be answered on meta: it raises `HostRead`, naming the op and the
line of the port that made it.  A device value copied to the host and used
as a value (a norm moved to the host, then multiplied back in) stays
abstract: the copy is counted and the step goes on.
"""
from __future__ import annotations

import collections
import math
import os
import traceback

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import work as work_mod

aten = torch.ops.aten

# ops that run no kernel: allocations and the alias-only ops (views are
# picked out by their schema)
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.detach.default,
         aten.lift_fresh.default, aten._unsafe_view.default,
         aten.alias.default}
# ops whose output or result a host read of device values decides
_HOST_READS = {aten._local_scalar_dense.default, aten.nonzero.default,
               aten.masked_select.default, aten.bincount.default,
               aten.repeat_interleave.Tensor, aten._unique2.default,
               aten.unique_consecutive.default, aten.unique_dim.default}
_MATMULS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class HostRead(RuntimeError):
    """A device value read on the host, which a step on meta cannot
    answer; the message names the op and the port's line."""


def _tensors(x, out: list) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _where() -> str:
    """file:line function of the innermost frame of the port's own code
    outside this module and the kernels' work table."""
    here = os.path.abspath(__file__)
    for fr in reversed(traceback.extract_stack()):
        f = os.path.abspath(fr.filename)
        if f.startswith(_PKG) and f != here:
            return f"{os.path.relpath(f, os.path.dirname(_PKG))}:{fr.lineno} " \
                   f"{fr.name}"
    return "outside the port"


def _matmul_flops(func, args, out) -> float:
    if func in _MATMULS:
        a = args[-2]
        return 2.0 * out.numel() * a.shape[-1]
    if func is aten.convolution.default:
        w = args[1]
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    return 0.0


class StepAnalysis(TorchDispatchMode):
    """Counts the device work of what runs under it (see the module
    docstring).  `live` holds the tensors (inputs, state) whose storage is
    live before the first op."""

    def __init__(self, live=()):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.ops = collections.Counter()          # rate class -> operations
        self.launches = collections.Counter()
        self.device_ops = 0
        self.collective_per_op = collections.Counter()
        self.collective_counts = collections.Counter()
        self.transfers = {"h2d_bytes": 0, "h2d_copies": 0,
                          "d2h_bytes": 0, "d2h_copies": 0}
        self._live = {}
        self._cur = 0
        self.peak_live_bytes = 0
        for t in live:
            self._track(t)

    # -- hooks of kernels/work.py ------------------------------------------
    def kernel(self, keys, w: work_mod.Work):
        for k in keys:
            self.launches[k] += 1
        self.device_ops += 1
        self.flops += w.flops
        self.hbm_bytes += w.bytes
        self.ops[w.rate] += w.ops

    def exchange(self, name: str, nbytes: int):
        self.collective_per_op[name] += int(nbytes)
        self.collective_counts[name] += 1

    # -- storage lifetimes --------------------------------------------------
    def _track(self, t):
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        if ref in self._live:
            return
        self._live[ref] = st.nbytes()
        self._cur += st.nbytes()
        if self._cur > self.peak_live_bytes:
            # drop the storages freed since: the count then is exact
            for r in [r for r in self._live if r.expired()]:
                self._cur -= self._live.pop(r)
            self.peak_live_bytes = max(self.peak_live_bytes, self._cur)

    # -- the dispatch -------------------------------------------------------
    def __enter__(self):
        work_mod._RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work_mod._RECORDERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in = _tensors(kwargs, _tensors(args, []))
        on_meta = any(t.device.type == "meta" for t in flat_in)
        if on_meta and func in _HOST_READS:
            raise HostRead(f"host read of a device value: {func} at "
                           f"{_where()}")
        if func is aten._to_copy.default and flat_in[0].device.type == "meta" \
                and torch.device(kwargs.get("device") or "meta").type != "meta":
            # a device value copied to the host: it stays abstract
            src = flat_in[0]
            self.transfers["d2h_bytes"] += _nbytes(src)
            self.transfers["d2h_copies"] += 1
            return torch.empty(src.shape, dtype=kwargs.get("dtype")
                               or src.dtype, device="meta")
        if func is aten.copy_.default and args[0].device.type != "meta" \
                and args[1].device.type == "meta":
            self.transfers["d2h_bytes"] += _nbytes(args[1])
            self.transfers["d2h_copies"] += 1
            return args[0]
        out = func(*args, **kwargs)
        flat_out = _tensors(out, [])
        if not on_meta and not any(t.device.type == "meta" for t in flat_out):
            return out                       # host work: not the device's
        if any(t.device.type != "meta" for t in flat_in if t.dim()) or (
                func in (aten._to_copy.default, aten.copy_.default)
                and any(t.device.type != "meta" for t in flat_in)):
            self.transfers["h2d_bytes"] += sum(
                _nbytes(t) for t in flat_in if t.device.type != "meta")
            self.transfers["h2d_copies"] += 1
        if func not in _FREE and not func.is_view:
            self.device_ops += 1
            self.hbm_bytes += sum(_nbytes(t) for t in flat_in + flat_out
                                  if t.device.type == "meta")
            f = _matmul_flops(func, args, flat_out[0]) if flat_out else 0.0
            if f:
                self.flops += f
                half = flat_out[0].dtype in (torch.bfloat16, torch.float16)
                self.ops["bf16" if half else "f32"] += f
        for t in flat_out:
            self._track(t)
        return out

    def record(self, hw: dict) -> dict:
        """The counts, with the roofline terms on `hw`'s peaks."""
        compute_s = sum(n / hw[work_mod.PEAK_KEYS[r]]
                        for r, n in self.ops.items())
        coll = sum(self.collective_per_op.values())
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": coll,
            "collective_per_op": dict(self.collective_per_op),
            "collective_counts": dict(self.collective_counts),
            "launches": dict(sorted(self.launches.items())),
            "device_ops": self.device_ops,
            "ops_by_rate": dict(self.ops),
            "transfers": dict(self.transfers),
            "peak_live_bytes": self.peak_live_bytes,
            "compute_s": compute_s,
            "memory_s": self.hbm_bytes / hw["hbm_bw"],
            "collective_s": coll / hw["interconnect_bw"],
        }


def analyze_step(fn, *args, hw: dict | None = None) -> dict:
    """Run fn(*args) once, its tensors on meta, under a StepAnalysis and
    return its record (roofline terms on `hw`, the H100's by default).
    Every tensor in args counts as live from the start."""
    from repro_torch.launch.mesh import HW
    with StepAnalysis(_tensors(args, [])) as an:
        fn(*args)
    return an.record(hw or HW)
