"""Serving with posit-packed weights + a paged posit-KV cache, through the
PyTorch port on a CUDA card.  The twin of `examples/serve_posit_lm.py`:

  1. a float checkpoint's qdot weights are packed once to P(16,2) codes
     (int16: half the bf16 bytes, a quarter of the f32 bytes),
  2. the packed tree is checkpointed with pack metadata in the manifest,
  3. `ServingEngine.from_checkpoint` restores the codes and serves them
     with the KV cache held as posit-coded pages: prompts prefill in
     bucketed chunks (same-size chunks of several slots batched into one
     pass, one fused prefill kernel launch per layer) straight into
     block-table pages, requests sharing the demo's system prompt map the
     same physical prefix pages (refcounted, copy-on-write past the
     prefix), decode attends them through the paged-attention kernel
     (block-table gather + in-kernel posit decode) and samples in the
     fused head kernel, and retired requests hand their pages back,
  4. the same checkpoint is re-served activation-coded
     (`serve_fused_p16_a13`): both GEMM operands at int16 code width.

The port has no kernel autotuner (its kernels use fixed launch shapes), so
where the reference prints the autotune report this prints the kernel
launches of the run (`ops.launch_counts()`).  SERVE_DEMO_REQUESTS /
SERVE_DEMO_TOKENS shrink the demo.

    PYTHONPATH=src python examples/serve_posit_lm_torch.py
    PYTHONPATH=src python examples/serve_posit_lm_torch.py --device cpu
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.quant import policy_by_name
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.serve import Request, ServingEngine


def main(device: str = "cuda"):
    device = resolve_device(device)
    n_req = int(os.environ.get("SERVE_DEMO_REQUESTS", "10"))
    max_new = int(os.environ.get("SERVE_DEMO_TOKENS", "12"))

    cfg = configs.get_smoke("command_r_35b").replace(
        quant=policy_by_name("serve_fused_p16"))
    params = api.init(torch.Generator(device=device).manual_seed(0), cfg,
                      device=device)

    # one-shot pack pass: float masters -> posit code tensors (int16)
    packed = api.pack_params(params, cfg)
    f32_bytes = api.weight_bytes(params)
    packed_bytes = api.weight_bytes(packed)
    print(f"weights: {f32_bytes} B float -> {packed_bytes} B packed "
          f"({f32_bytes / packed_bytes:.2f}x smaller)")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir)
        mgr.save(0, packed, extra=api.pack_manifest(cfg))
        engine = ServingEngine.from_checkpoint(cfg, ckpt_dir, batch_slots=4,
                                               max_seq=96, page_size=16,
                                               device=device)
        kv = engine.kv_cache_summary()
        print(f"engine resident: {engine.weight_bytes()} B weights; paged KV "
              f"pool {kv['kv_bytes']} B ({engine.cache['k'].dtype} codes, "
              f"page_size={engine.layout.page_size}) + "
              f"{kv['metadata_bytes']} B block-table/position metadata")
        rng = np.random.default_rng(0)
        # repeated-system-prompt traffic: every request opens with the same
        # 32-token "system prompt" (two full pages: prefix sharing maps them
        # once) followed by a short per-request question
        system = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
        prompts = [np.concatenate([system,
                                   rng.integers(0, cfg.vocab_size, 4)
                                   .astype(np.int32)])
                   for _ in range(n_req)]
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
        ops.reset_launches()
        t0 = time.perf_counter()
        # step once to catch the pool mid-flight, then drain
        engine.step()
        mid = engine.kv_cache_summary()
        print(f"mid-flight: {engine.pages_in_use} pages in use / "
              f"{engine.pages_free} free "
              f"({mid['kv_bytes_in_use']} B of coded KV backing tokens); "
              f"{engine.pages_shared_mapped} shared page refs mapped beyond "
              f"their first block table")
        occ = engine.allocator.pages_in_use_by_shard
        budget = engine.allocator.pages_per_shard - 1
        print(f"per-device page occupancy ({engine.n_shards} shard(s), "
              f"budget {budget} pages each): "
              + " ".join(f"d{i}={u}/{budget}" for i, u in enumerate(occ)))
        done = engine.run()
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        batches = engine.stats["prefill_batch_sizes"]
        n_chunks = sum(k * v for k, v in batches.items())
        print(f"prefix sharing: {engine.stats['shared_admissions']} of "
              f"{len(done)} requests admitted onto shared prefix pages "
              f"({engine.stats['pages_shared']} page refs shared, "
              f"{engine.stats['cow_forks']} COW forks); fresh pages "
              f"allocated: {engine.allocator.total_allocs}")
        print(f"batched prefill: {n_chunks} chunks in "
              f"{sum(batches.values())} device calls "
              f"(batch-size histogram {dict(sorted(batches.items()))})")
        summ = engine.execution_summary()
        # each chunk group ran as 1 program (fused) or 3 (decomposed
        # fallback), so the counter pair recovers the per-chunk coverage
        n_pc, n_pp = summ["prefill_chunks"], summ["prefill_device_programs"]
        n_fused = (3 * n_pc - n_pp) // 2
        print(f"fused prefill: {'on' if summ['fused_prefill'] else 'off'} — "
              f"{n_pp} attention-stage device programs for {n_pc} chunk "
              f"groups: {n_fused} fused (1 program) / {n_pc - n_fused} "
              f"fallback (3 programs)")
        n_ds, n_dp = summ["decode_steps"], summ["decode_device_programs"]
        print(f"fused decode: {'on' if summ['fused_decode'] else 'off'} — "
              f"{n_dp / max(n_ds, 1):.1f} device programs per decode step "
              f"({n_dp} programs / {n_ds} steps; 1 fused = model+head+"
              f"sampler in one dispatch, 2 decomposed)")
        print(f"kernel launches this run ({engine.device.type}; the plain "
              f"versions on the CPU count none): {launches or 'none'}")

        # coded-page storage ratio: what the dense f32 worst-case cache
        # would allocate vs the coded pages that peak traffic touched
        dense_f32 = 2 * cfg.n_layers * engine.B * engine.S \
            * cfg.n_kv_heads * cfg.head_dim * 4
        peak = engine.kv_cache_summary()["kv_bytes_peak"]
        print(f"decode-state storage: dense f32 would allocate {dense_f32} B; "
              f"peak coded pages in flight {peak} B "
              f"({dense_f32 / peak:.1f}x smaller)")

        # activation-coded serving: same packed checkpoint, activations now
        # travel as P(13,2) codes through the both-operands coded GEMM
        cfg_act = cfg.replace(quant=policy_by_name("serve_fused_p16_a13"))
        engine_act = ServingEngine.from_checkpoint(
            cfg_act, ckpt_dir, batch_slots=4, max_seq=96, device=device)
        n_act = min(4, n_req)
        for i, p in enumerate(prompts[:n_act]):
            engine_act.submit(Request(rid=i, prompt=p,
                                      max_new_tokens=max_new))
        done_act = engine_act.run()

    tok = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s on {engine.device})")
    print(f"execution plan: {cfg.quant.execution} "
          f"(weights {cfg.quant.weights}, kv {cfg.quant.kv_cache}, "
          f"pages reclaimed: {engine.pages_free}/{engine.allocator.capacity} "
          f"free)")
    print(f"sample continuation: {done[0].out_tokens}")
    print(f"activation-coded plan: {engine_act.execution_summary()}")
    by_rid = {r.rid: r.out_tokens for r in done}
    match = sum(by_rid[r.rid] == r.out_tokens for r in done_act) \
        / len(done_act)
    print(f"activation-coded vs float-activation continuations: "
          f"{match:.0%} identical over {len(done_act)} requests "
          f"(both operands int16 codes vs f32 activations)")
    return done, done_act


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    main(ap.parse_args().device)
