"""Autotune sweep CLI (PyTorch port of `repro.launch.autotune`): time the
tunable launch knobs on the card and write the cache that `kernels/ops.py`
resolves them from.

    PYTHONPATH=src python -m repro_torch.launch.autotune [--commit]
                                                         [--out PATH]
                                                         [--reps N] [--quick]

Sweeps every tunable kernel (`kernels/autotune.TUNABLES`) over the serving
shapes below, times every candidate with CUDA events and prints each
candidate's time and the winner.  `--commit` writes the cache to its
default path (`kernels/autotune.cache_path()`: `build/autotune_cache.json`
unless `REPRO_AUTOTUNE_CACHE` names another); `--out` writes anywhere
else; without either the sweep is a dry run.  It raises without a card:
the winners belong to the card they were timed on (the cache's backend is
its name), and there is no CPU sweep.

Not ported: `--prune-factor` and `--oracle-check`, which drive the
reference's TPU cost oracle and HLO accounting.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P8_2
from repro_torch.kernels import autotune, ops


def sweep_points(quick: bool):
    """Sweep points (shape, fmts) per tunable kernel.  K7 (key: B, T, M,
    page size, Hkv x head_dim): the speculative verify at the serving
    defaults (4 slots, k = 4, 16-token pages of P(8,2) codes, 8 KV heads
    of 128), over phase 5's 256-token tables and the long prompt's 1280."""
    paged = [((4, 4, 16, 16, 1024), (P8_2,)),
             ((4, 4, 80, 16, 1024), (P8_2,))]
    if quick:
        paged = paged[:1]
    return {"paged_attention": paged}


def _runner(kernel: str, shape, fmts, generator, device):
    """Build `run(params) -> thunk` for one sweep point (see
    `autotune.sweep`); inputs are drawn once and closed over.  K7's query
    heads are command-r's 8 a KV head, of 128 dims."""
    if kernel != "paged_attention":
        raise KeyError(kernel)
    B, T, M, ps, F = shape
    (fmt,) = fmts
    Dh = 128 if F % 128 == 0 else F
    Hkv = F // Dh
    n_pages = 1 + B * M
    q = torch.randn(B, T, 8 * Hkv, Dh, generator=generator, device=device)
    kv = torch.randn(2, n_pages, ps, F, generator=generator, device=device)
    kp, vp = (posit.pack(t, fmt) for t in kv) if fmt else kv.unbind(0)
    bt = (1 + torch.arange(B * M, device=device, dtype=torch.int32)
          ).reshape(B, M)
    lengths = torch.full((B,), M * ps, dtype=torch.int32, device=device)
    win = torch.full((1,), 2 ** 30, dtype=torch.int32, device=device)
    return lambda p: (lambda: ops.paged_attention(
        q, kp, vp, bt, lengths, win, fmt_kv=fmt, **p))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--commit", action="store_true",
                    help="write the cache to its default path "
                         "(kernels/autotune.cache_path())")
    ap.add_argument("--out", default=None,
                    help="write the cache JSON to this path instead")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--quick", action="store_true",
                    help="one sweep point per kernel (smoke)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the autotune sweep times kernels on a CUDA card "
                           "and none is available")

    device = torch.device("cuda")
    generator = torch.Generator(device=device).manual_seed(0)
    cache = autotune.AutotuneCache()
    print(f"backend: {cache.backend}")
    for kernel, points in sweep_points(args.quick).items():
        for shape, fmts in points:
            run = _runner(kernel, shape, fmts, generator, device)
            params, ms, table = autotune.sweep(kernel, shape, run,
                                               fmts=fmts, reps=args.reps)
            cache.put(kernel, shape, params, fmts=fmts, ms=ms)
            for row in table:
                took = ("refused: " + row["error"] if row["ms"] is None
                        else f"{row['ms']:.4f} ms")
                print(f"  {kernel} @ {shape} {row['params']}: {took}")
            print(f"{kernel} @ {autotune.shape_bucket(shape)} "
                  f"{[autotune._fmt_name(f) for f in fmts]}: {params} "
                  f"({ms:.4f} ms)")
    if args.commit or args.out:
        path = cache.save(args.out or autotune.cache_path())
        print(f"wrote {len(cache.entries)} entries -> {path}")
    else:
        print(f"{len(cache.entries)} entries swept (dry run; --commit or "
              f"--out to write them)")
    return cache


if __name__ == "__main__":
    main()
