"""Serving entry point (continuous batching), the twin of
`repro.launch.serve`:

    python -m repro_torch.launch.serve --arch gemma3_4b --smoke \
        --requests 8 --quant serve_p16_kv8

Speculative decoding (a draft policy proposes, one batched multi-query
verify commits the matching prefix; streams equal plain decode's):

    python -m repro_torch.launch.serve --arch gemma3_4b --smoke \
        --requests 8 --quant serve_fused_p16 --speculate 4

A page pool sharded over kv_pages (`--mesh-model n`: n shards, shard i on
cuda:(i mod the card count), so on one card n page ranges of cuda:0; the
placement is printed):

    python -m repro_torch.launch.serve --arch command_r_35b --smoke \
        --quant serve_fused_p16 --mesh-model 2

`--device cpu` runs every kernel's plain version (shards then all on the
CPU).  The weights are random, drawn from a torch.Generator seeded 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.quant import policy_by_name
from repro_torch.models import api
from repro_torch.serve import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--quant", default="none")
    ap.add_argument("--dense", action="store_true",
                    help="dense KV cache instead of the paged pool")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size (default: quant policy kv_page_size)")
    ap.add_argument("--sample", action="store_true",
                    help="temperature/top-k sampling instead of greedy")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--mesh-model", type=int, default=0,
                    help="shard the paged KV pool over this many shards "
                         "(0 = single pool)")
    ap.add_argument("--speculate", type=int, default=0,
                    help="speculative decoding span k (>= 2; draft policy "
                         "= quant.with_draft(), bitwise-identical tokens)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    if not args.sample and (args.temperature != 1.0 or args.top_k):
        raise SystemExit("--temperature/--top-k only take effect with "
                         "--sample (greedy decoding ignores them)")

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = cfg.replace(quant=policy_by_name(args.quant))
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to serve")
    dev = resolve_device(args.device)
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    mesh = None
    if args.mesh_model > 1:
        from repro_torch.launch.mesh import make_serving_mesh, placement
        mesh = make_serving_mesh(
            args.mesh_model,
            devices=None if dev.type == "cuda" else [dev] * args.mesh_model)
        print(f"[serve] mesh: {placement(mesh)}")
        dev = mesh.devices[0]
    engine = ServingEngine(cfg, params, batch_slots=args.slots,
                           max_seq=args.max_seq, paged=not args.dense,
                           page_size=args.page_size,
                           greedy=not args.sample,
                           temperature=args.temperature, top_k=args.top_k,
                           speculate_k=args.speculate, mesh=mesh, device=dev)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        engine.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    done = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    layout = (f"paged(ps={engine.layout.page_size}, "
              f"peak={engine.allocator.peak_in_use}/"
              f"{engine.allocator.capacity} pages)"
              if engine.paged else "dense")
    print(f"[serve] {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s) kv dtype="
          f"{'posit' if cfg.quant.kv_cache else cfg.dtype} cache={layout}")
    if args.speculate:
        s = engine.execution_summary()
        print(f"[serve] speculation: k={s['speculate_k']} "
              f"rounds={s['speculation_rounds']} "
              f"accept_rate={s['speculation_accept_rate']:.3f} "
              f"committed={s['speculation_committed_tokens']}")
    if engine.paged and engine.n_shards > 1:
        occ = engine.allocator.pages_in_use_by_shard
        per = engine.allocator.pages_per_shard - 1
        print("[serve] per-device page occupancy: "
              + " ".join(f"d{i}={u}/{per}" for i, u in enumerate(occ)))
    return done


if __name__ == "__main__":
    main()
