"""A serving engine's step as one device program: a CUDA graph captured
once and replayed (the port's counterpart of the reference's `jax.jit`
step programs).

The reference wraps every device step of its engine in `jax.jit`, so a
fused decode step is one program.  Eagerly the port dispatches each
operation of a step from Python and the card waits on the host between
them.  A `StepGraph` runs a step body as one CUDA graph instead.  Its first
call runs the body eagerly on a side stream, a warm-up: it builds the
kernel libraries, uploads the float GEMV's decode table, grows the GEMV's
ticket arrays and lets cuBLAS set up its per-stream state, none of which a
capture could do.  The second call captures the body into the memory pool
that an engine's graphs share and replays it; every later call replays
it.  The body reads its inputs from static buffers, which the caller fills
(`copy_`) before each call and passes in every call, and the outputs of a
replay are static too: the caller copies them out before the next call.

The kernel wrappers count their launches in Python as they launch
(`kernels/ops.py`).  The launches counted while a graph captures become
the graph's delta (`ops.captured_launches`): the capture counts none, and
each replay adds the delta, so `ops.launch_counts()` reads as an eager
run's would.

On the CPU, and on a card inside `disable_graphs()` (the counterpart of
`jax.disable_jit()`), a StepGraph calls its body eagerly on the same
static buffers: the plain route, as every kernel wrapper takes its plain
version for CPU tensors.  On a card a capture or a replay that fails
raises; a step never falls back to eager dispatch.  A body may not read a
device value on the host (`.item()`, `nonzero`, a copy to the host) nor
copy a host tensor to the card, since a capture can hold neither:
`check_capturable` runs a body on meta tensors and raises `HostRead` for
both (`launch/step_analysis.py`).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ops

_disabled = 0


@contextlib.contextmanager
def disable_graphs():
    """Inside, every StepGraph calls its body eagerly and neither captures
    nor replays, as `jax.disable_jit()` runs jitted functions op by op: to
    compare a graphed run with an eager one, or to debug a step."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def graphs_enabled() -> bool:
    return _disabled == 0


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


class CudaGraphs:
    """The card's route: the warm-up on a side stream, captures into one
    memory pool (`torch.cuda.graph_pool_handle()`), replays on the current
    stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()

    def warmup(self, fn):
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = fn()
            main.wait_stream(side)
            for t in _tensors(out):
                t.record_stream(main)
        return out

    def capture(self, fn):
        """(the graph, its static outputs).  A capture that fails leaves
        the current stream as it found it (torch's context manager does not
        when the capture's end raises)."""
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    out = fn()
            finally:
                torch.cuda.set_stream(stream)
        return graph, out

    def replay(self, graph):
        with torch.cuda.device(self.device):
            graph.replay()


def _backend(device: torch.device):
    """The graph route for a device: the card's, or None (eager)."""
    return CudaGraphs(device) if device.type == "cuda" else None


class StepGraph:
    """One step body, eager at its first call, captured at its second,
    replayed at every later one (see the module docstring).  `replays`
    counts replays, `eager_calls` the calls that ran the body eagerly;
    `delta` is the launches a replay makes, by `ops.launch_counts()` key.
    The backend of a device is shared by the engine's graphs (one pool)."""

    def __init__(self, name: str, backend=None):
        self.name = name
        self._backend = backend
        self._graph = None
        self._inputs = None
        self._outputs = None
        self.delta: dict = {}
        self.warmed = False
        self.replays = 0
        self.eager_calls = 0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, body, **inputs):
        """body(**inputs): eagerly, or by a replay of its graph."""
        if self._backend is None or not graphs_enabled():
            self.eager_calls += 1
            return body(**inputs)
        if not self.warmed:
            out = self._backend.warmup(lambda: body(**inputs))
            self.warmed = True
            self.eager_calls += 1
            return out
        if self._graph is None:
            with ops.captured_launches() as delta:
                graph, out = self._backend.capture(lambda: body(**inputs))
            self._graph, self._outputs, self._inputs = graph, out, inputs
            self.delta = delta
        elif inputs.keys() != self._inputs.keys() or any(
                inputs[k] is not t for k, t in self._inputs.items()):
            raise ValueError(f"step graph {self.name!r}: a replay reads the "
                             f"buffers it was captured with, got others")
        self._backend.replay(self._graph)
        ops.add_launches(self.delta)
        self.replays += 1
        return self._outputs


def check_capturable(body, **inputs):
    """Run body(**inputs), its tensors on the meta device, under the dry
    run's dispatch mode, and raise `step_analysis.HostRead` where a capture
    would fail: a device value read on the host, or a copy between host
    and device.  Returns the step's record (`StepAnalysis.record`)."""
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.step_analysis import HostRead, StepAnalysis
    with StepAnalysis(list(inputs.values())) as an:
        body(**inputs)
    moved = {k: v for k, v in an.transfers.items() if v}
    if moved:
        raise HostRead(f"a copy between host and device in the step: "
                       f"{moved}")
    return an.record(HW)
