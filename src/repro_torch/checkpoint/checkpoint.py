"""Atomic, async checkpoints in the reference's format (PyTorch port of
`repro.checkpoint`).

Layout of one checkpoint:
    <dir>/step_000000123.tmp-<pid>-<us>/   (written)
        manifest.json    (step, array shapes/dtypes, caller `extra`)
        shard_h000.npz   (every array, keyed by its "/"-joined tree path)
    <dir>/step_000000123/                  (atomic rename; manifest last)

Tree paths are the reference's: a dict key as itself, a NamedTuple field
as "." + its name, a list or tuple item as its index; so either package
reads what the other wrote.  `CheckpointManager` writes (atomic rename,
keep-last retention, a background writer for `save_async` after the
device -> host copies taken on the caller's thread) and restores onto a
device; the module-level `restore` returns numpy arrays for
`models.packing.params_from_numpy`.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.module import ParamSpec

_SEP = "/"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


def _children(tree):
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in sorted(tree.items())]
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, ParamSpec):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ParamSpec):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix=()):
    """{"/"-joined path: leaf} of a nested dict / NamedTuple / list tree."""
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(prefix): tree}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, prefix + (k,)))
    return out


def _rebuild(like, leaf, prefix=()):
    """`like`'s structure with each leaf replaced by leaf(path, like_leaf)."""
    kids = _children(like)
    if kids is None:
        return leaf(_SEP.join(prefix), like)
    vals = [_rebuild(v, leaf, prefix + (k,)) for k, v in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def tree_paths(tree):
    """The sorted checkpoint keys of a tree."""
    return sorted(_flatten(tree))


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array that shares no memory with the caller (the
    optimizer updates its state in place while a background write runs)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("checkpoints hold numpy dtypes; bf16 has none")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


# ---------------------------------------------------------------------------
# reader functions (numpy out)
# ---------------------------------------------------------------------------

def all_steps(directory: str):
    out = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> dict:
    """The committed manifest of one checkpoint (shapes/dtypes/extra)."""
    with open(os.path.join(_step_dir(directory, step), "manifest.json")) as f:
        return json.load(f)


def restore(directory: str, step: int, like: Any):
    """Load one checkpoint into the structure of `like` (nested dicts,
    NamedTuples, lists; only the structure is read).  Returns numpy
    arrays."""
    path = os.path.join(_step_dir(directory, step), "shard_h000.npz")
    with np.load(path) as z:
        host = {k: z[k] for k in z.files}
    want = set(_flatten(like))
    if want != set(host):
        raise ValueError(f"checkpoint/tree structure mismatch: "
                         f"{sorted(want ^ set(host))[:5]} ...")
    return _rebuild(like, lambda key, _: host[key])


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Writes and restores checkpoints under `directory`, keeping the
    last `keep_last` committed steps (0 keeps all)."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------- write path ----------------
    def save(self, step: int, tree: Any, blocking: bool = True,
             extra: Optional[dict] = None):
        """Copy every leaf to host memory on this thread, then write (in
        the background unless `blocking`).  `extra` is caller metadata
        stored verbatim in the manifest (e.g. `packing.pack_manifest`)."""
        self.wait()  # one write in flight at a time
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if blocking:
            self._write(step, host, extra)
        else:
            self._thread = threading.Thread(
                target=self._write_guard, args=(step, host, extra),
                daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.save(step, tree, blocking=False, extra=extra)

    def _write_guard(self, step, host, extra):
        try:
            self._write(step, host, extra)
        except BaseException as e:  # raised again by the next wait()
            self._error = e

    def _write(self, step: int, host: dict, extra: Optional[dict] = None):
        final = _step_dir(self.dir, step)
        if os.path.exists(os.path.join(final, "manifest.json")):
            return  # this step is already committed: saving is idempotent
        tmp = final + f".tmp-{os.getpid()}-{int(time.time() * 1e6)}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "shard_h000.npz"), **host)
        manifest = {
            "step": step,
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in host.items()},
            "format": 1,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self):
        """Join the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(_step_dir(self.dir, s), ignore_errors=True)

    # ---------------- read path ----------------
    def all_steps(self):
        return all_steps(self.dir)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.dir)

    def read_manifest(self, step: int) -> dict:
        return read_manifest(self.dir, step)

    def restore(self, step: int, like: Any, device=None):
        """Load `step` into the structure of `like` as tensors, each on its
        `like` leaf's device; a `like` leaf on the meta device (e.g. from
        `api.abstract_state`), or no tensor at all, goes to `device`."""
        self.wait()
        host = _flatten(restore(self.dir, step, like))

        def leaf(key, ref):
            dev = device
            if isinstance(ref, torch.Tensor) and not ref.is_meta:
                dev = ref.device
            elif dev is None:
                raise ValueError(f"restore: give a device for '{key}'")
            return torch.from_numpy(host[key]).to(dev)

        return _rebuild(like, leaf)
