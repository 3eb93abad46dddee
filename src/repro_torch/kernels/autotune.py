"""Kernel autotuner: per-(shape bucket, posit format, backend) launch
caches (PyTorch port of `repro.kernels.autotune`).

A kernel's launch knobs have defaults in its wrapper; this module resolves
them through a persisted cache at dispatch time (`kernels/ops.py:
_resolve`), so a sweep run once on a card (`launch/autotune.py`) serves
every later process on that card without a code change.  Only knobs that
change no bit of any output are tunable: the cache may hold any value of
a knob and every entry point gives the same values.

Cache JSON schema (version `CACHE_VERSION`)
-------------------------------------------

    {
      "version": 1,
      "backend": "cuda:NVIDIA H100 80GB HBM3",  # `backend_name()` at sweep
      "generated_by": "launch/autotune.py",
      "entries": {
        "<digest>": {
          "kernel": "paged_attention",          # tunable name (TUNABLES key)
          "key":    {"shape": [4, 4, 32, 16, 1024], "fmts": ["P8_2"]},
          "params": {"t_block": 2},
          "ms":     0.031                       # best time on the card
        }, ...
      }
    }

Key digest
----------

`key_digest(kernel, backend, key)` = first 16 hex chars of blake2b over the
canonical (sorted keys, no whitespace) JSON of `{"version", "kernel",
"backend", "key"}`, as the reference computes it, so an entry is
invalidated by a schema bump, another backend (another card's name) or
any change to the key.  The key's shape is bucketed (`shape_bucket`: each
dim rounded up to the next power of two, at least 8), so one sweep covers
a band of sizes.

The cache lives at `cache_path()`: `REPRO_AUTOTUNE_CACHE` when set, else
`build/autotune_cache.json` in the repository (listed in `.gitignore`:
a sweep's results belong to the card it ran on, so none is committed).
`REPRO_AUTOTUNE=off` (or 0) disables lookups.

Tunables
--------

`TUNABLES` names each port kernel's knobs that change no value bit.  K7's
query-token tile `t_block` (`kernels/paged_attention.py`): every row of a
block is computed from that row alone, so any tile gives the same bits.
Knobs that change the order of a sum are not tunable and stay fixed:
K6's `posit_matmul.split_k` / `tc_split_k`, K9's `grouped_split_k` /
`grouped_tc_split_k`, K3 / K7's key split (`attention_splits`) and K5's
`tc256_splits`.  K1 / K2 launch a fixed 256 threads a block and expose no
knob.

Not ported: the reference's `oracle_cost` and `hlo_cost`, which model a
TPU's padded tiles through `launch.mesh.HW` and read XLA's HLO; the sweep
here times every candidate on the card with CUDA events instead.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
from pathlib import Path

import torch

CACHE_VERSION = 1
DEFAULT_CACHE_PATH = str(Path(__file__).resolve().parents[3] / "build"
                         / "autotune_cache.json")


def _enabled() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "on").lower() not in ("0", "off")


def cache_path() -> str:
    return os.environ.get("REPRO_AUTOTUNE_CACHE", DEFAULT_CACHE_PATH)


def backend_name() -> str:
    """The cache's backend: "cuda:<the card's name>" with a card, else
    "cpu"."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(0)}"
    return "cpu"


def shape_bucket(shape) -> tuple:
    """Round each dim up to the next power of two (min 8): the cache key's
    shape component, so one tuned entry covers a band of problem sizes."""
    out = []
    for d in shape:
        b = 8
        while b < d:
            b *= 2
        out.append(b)
    return tuple(out)


def _fmt_name(fmt) -> str:
    if fmt is None:
        return "f32"
    return f"P{fmt.n}_{fmt.es}"


def make_key(shape, fmts=()) -> dict:
    """Canonical cache key contents: bucketed shape + posit format names."""
    return {"shape": list(shape_bucket(shape)),
            "fmts": [_fmt_name(f) for f in fmts]}


def key_digest(kernel: str, backend: str, key: dict) -> str:
    blob = json.dumps({"version": CACHE_VERSION, "kernel": kernel,
                       "backend": backend, "key": key},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(blob.encode(), digest_size=8).hexdigest()


# kernel name -> candidate values of each knob; "paged_attention" is the
# reference's name for the multi-query tile, keyed by (B, T, M, page size,
# Hkv x head_dim) and the KV format
TUNABLES = {
    "paged_attention": {"t_block": (1, 2, 4, 8)},
}


def candidates(kernel: str):
    """Full parameter grid of a tunable kernel."""
    space = TUNABLES[kernel]
    names = sorted(space)
    for vals in itertools.product(*(space[n] for n in names)):
        yield dict(zip(names, vals))


class AutotuneCache:
    """In-memory view of one cache JSON + hit/miss accounting."""

    def __init__(self, backend: str | None = None,
                 entries: dict | None = None):
        self.backend = backend or backend_name()
        self.entries = dict(entries or {})
        self.hits: dict = {}
        self.misses: dict = {}

    @classmethod
    def load(cls, path: str | None = None) -> "AutotuneCache":
        path = path or cache_path()
        backend = backend_name()
        if not os.path.exists(path):
            return cls(backend)
        with open(path) as f:
            raw = json.load(f)
        if raw.get("version") != CACHE_VERSION:
            return cls(backend)  # a schema bump invalidates the whole file
        return cls(backend, raw.get("entries", {}))

    def save(self, path: str | None = None) -> str:
        path = path or cache_path()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = {"version": CACHE_VERSION, "backend": self.backend,
                   "generated_by": "launch/autotune.py",
                   "entries": self.entries}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        return path

    def lookup(self, kernel: str, shape, fmts=()) -> dict | None:
        """Tuned params for (kernel, bucketed shape, formats) or None;
        counts per-kernel hits and misses for `report`."""
        key = make_key(shape, fmts)
        ent = self.entries.get(key_digest(kernel, self.backend, key))
        if ent is not None and ent.get("kernel") == kernel:
            self.hits[kernel] = self.hits.get(kernel, 0) + 1
            return dict(ent["params"])
        self.misses[kernel] = self.misses.get(kernel, 0) + 1
        return None

    def put(self, kernel: str, shape, params: dict, fmts=(),
            ms: float | None = None):
        key = make_key(shape, fmts)
        self.entries[key_digest(kernel, self.backend, key)] = {
            "kernel": kernel, "key": key, "params": dict(params), "ms": ms}

    def report(self) -> dict:
        """Per-kernel {hits, misses} since load."""
        kernels = sorted(set(self.hits) | set(self.misses))
        return {k: {"hits": self.hits.get(k, 0),
                    "misses": self.misses.get(k, 0)} for k in kernels}


_CACHE: AutotuneCache | None = None


def get_cache() -> AutotuneCache:
    global _CACHE
    if _CACHE is None:
        _CACHE = AutotuneCache.load()
    return _CACHE


def reset_cache(cache: AutotuneCache | None = None):
    """Swap or clear the process-wide cache (tests; the CLI after a
    sweep)."""
    global _CACHE
    _CACHE = cache


def lookup(kernel: str, shape, fmts=()) -> dict | None:
    """Dispatch-time resolution hook (ops.py): tuned params or None.
    Honors REPRO_AUTOTUNE=off."""
    if not _enabled():
        return None
    return get_cache().lookup(kernel, shape, fmts)


def hit_report() -> dict:
    cache = _CACHE
    return cache.report() if cache is not None else {}


def _time_ms(fn, reps: int) -> float:
    """Device time of one call of fn: a warm-up call, then reps calls
    between two CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep(kernel: str, shape, run, fmts=(), reps: int = 20):
    """Tune one (kernel, shape, formats) point on the card.

    `run(params) -> thunk` builds a zero-argument callable that launches
    the kernel with candidate `params`.  Every candidate is timed (`reps`
    launches after a warm-up, CUDA events).  Returns (best_params, best_ms,
    table), the table holding each candidate's params and ms (or the
    error that refused it).  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("autotune.sweep times kernels on a CUDA card and "
                           "none is available")
    table = []
    best = None
    for params in candidates(kernel):
        try:
            ms = _time_ms(run(params), reps)
        except (RuntimeError, ValueError) as e:   # a launch refused
            table.append({"params": params, "ms": None, "error": str(e)})
            continue
        table.append({"params": params, "ms": ms})
        if best is None or ms < best[1]:
            best = (params, ms)
    if best is None:
        raise RuntimeError(f"no timeable candidate for {kernel} @ {shape}")
    return best[0], best[1], table
