"""Reader of the reference's checkpoint format (`repro.checkpoint`).

Layout of one committed checkpoint:
    <dir>/step_000000123/
        manifest.json    (step, array shapes/dtypes, caller `extra`)
        shard_h000.npz   (every array, keyed by its "/"-joined tree path)

Pure numpy and json: `restore` returns the tree as numpy arrays, which
`models.packing.params_from_numpy` moves onto a device.  Writing is not
ported yet (ROADMAP queue 1, item 1).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np

_SEP = "/"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


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


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield prefix


def restore(directory: str, step: int, like: Any):
    """Load one checkpoint into the structure of `like` (a nested-dict tree
    of anything; only its keys are read).  Returns numpy arrays."""
    path = os.path.join(_step_dir(directory, step), "shard_h000.npz")
    with np.load(path) as z:
        host = {k: z[k] for k in z.files}
    want = {_SEP.join(p) for p in _paths(like)}
    if want != set(host):
        raise ValueError(f"checkpoint/tree structure mismatch: "
                         f"{sorted(want ^ set(host))[:5]} ...")

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        return host[_SEP.join(prefix)]

    return build(like)
