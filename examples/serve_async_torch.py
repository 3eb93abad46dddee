"""Async continuous-batching serving with SLO classes, preemption,
streaming, and posit-native speculative decoding, through the PyTorch port
on a CUDA card.  The twin of `examples/serve_async.py`.

What this walks through (and asserts, so it runs as a smoke):
  1. an `AsyncServingFrontend` drains a mixed-SLO queue: low-priority
     batch requests fill every slot, then a high-priority *interactive*
     request arrives mid-flight and PREEMPTS a batch slot — the victim's
     pages flow through the engine's refcount/held-page paths, its
     request requeues, and its client stream resumes exactly where it
     left off (the front end dedups the bit-identical replay by count);
  2. per-token streaming callbacks fire in generation order and the
     streamed view matches each request's final token list;
  3. speculative decoding rides underneath: a draft policy over the SAME
     posit-coded KV pages proposes k tokens per round and one multi-query
     paged-attention launch (K7) verifies them — acceptance is exact, so
     every token stream is bitwise identical to a plain synchronous engine
     run of the same requests (asserted);
  4. TTFT / inter-token-latency histograms and the speculation accept
     rate surface through `frontend.execution_summary()`.

SERVE_ASYNC_REQUESTS / SERVE_ASYNC_TOKENS shrink the demo.

    PYTHONPATH=src python examples/serve_async_torch.py
    PYTHONPATH=src python examples/serve_async_torch.py --device cpu
"""
import argparse
import asyncio
import os

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core.formats import P8_2, P16_2
from repro_torch.core.quant import QuantPolicy
from repro_torch.models import api
from repro_torch.serve import AsyncServingFrontend, Request, ServingEngine

SPEC_K = 4


def config():
    return configs.get_tiny_serving(
        "command_r_35b", QuantPolicy(weights=P16_2, kv_cache=P8_2))


def run(n_req: int, max_new: int, device="cuda", params=None):
    """Serve `n_req` batch requests and one interactive one, `max_new`
    tokens each, plainly and then async + speculatively; asserts the
    streams equal.  `params` defaults to a seeded random init.  Returns
    (the plain engine's streams {rid: tokens}, the front end's summary)."""
    device = resolve_device(device)
    cfg = config()
    if params is None:
        params = api.init(torch.Generator(device=device).manual_seed(0), cfg,
                          device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 6 + 3 * i).astype(np.int32)
               for i in range(n_req)]
    interactive_prompt = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)

    # ---- reference: plain synchronous serving, no speculation, no async
    ref_engine = ServingEngine(cfg, params, batch_slots=2, max_seq=64,
                               device=device)
    for i, p in enumerate(prompts):
        ref_engine.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    ref_engine.submit(Request(rid=100, prompt=interactive_prompt,
                              max_new_tokens=max_new))
    reference = {r.rid: list(r.out_tokens) for r in ref_engine.run()}

    # ---- async + speculative serving of the same traffic
    engine = ServingEngine(cfg, params, batch_slots=2, max_seq=64,
                           speculate_k=SPEC_K, device=device)
    frontend = AsyncServingFrontend(engine)
    streams: dict = {}

    def on_token(rid, idx, tok):
        out = streams.setdefault(rid, [])
        assert idx == len(out), f"stream {rid} skipped/replayed index {idx}"
        out.append(tok)

    async def clients():
        tickets = [
            frontend.submit(p, max_new_tokens=max_new, slo="batch",
                            on_token=on_token, rid=i)
            for i, p in enumerate(prompts)]
        # wait until every slot is busy with batch traffic, then drop in the
        # interactive request — with no free slot it must preempt a batch one
        while (engine.slot_phase == 0).any() or not engine.queue:
            if all(t.state != "pending" for t in tickets):
                break
            await asyncio.sleep(0)
        t_int = frontend.submit(interactive_prompt, max_new_tokens=max_new,
                                slo="interactive", on_token=on_token, rid=100)
        results = {t.rid: await t.wait() for t in tickets}
        results[t_int.rid] = await t_int.wait()
        return results

    async def main():
        results, _ = await asyncio.gather(clients(), frontend.run())
        return results

    results = asyncio.run(main())
    summary = frontend.execution_summary()

    assert set(results) == set(reference)
    for rid, toks in reference.items():
        assert results[rid] == toks, (
            f"rid {rid}: async+speculative stream diverged from the plain "
            f"engine: {results[rid]} vs {toks}")
        assert streams[rid] == toks, f"rid {rid}: streamed view diverged"
    assert summary["speculative"] and summary["speculation_rounds"] > 0
    assert not engine.queue and engine.pages_in_use == 0

    print(f"[serve_async] drained {len(results)} requests "
          f"({sum(len(t) for t in results.values())} tokens) — every stream "
          f"bitwise equal to the plain synchronous engine")
    note = (" (interactive request displaced a batch slot mid-decode; victim "
            "replayed bit-identically, stream dedup'd)"
            if summary["frontend_preemptions"] else
            " (queue drained before the interactive arrival needed a slot)")
    print(f"[serve_async] preemptions: {summary['frontend_preemptions']}{note}")
    print(f"[serve_async] speculation: k={summary['speculate_k']}, "
          f"{summary['speculation_rounds']} rounds, accept rate "
          f"{summary['speculation_accept_rate']:.2f}, "
          f"{summary['speculation_committed_tokens']} tokens committed "
          f"speculatively")
    ttft, itl = summary["ttft_ms"], summary["itl_ms"]
    print(f"[serve_async] TTFT p50={ttft['p50_ms']:.1f}ms "
          f"p95={ttft['p95_ms']:.1f}ms over {ttft['count']} requests; "
          f"ITL p50={itl['p50_ms']:.1f}ms p95={itl['p95_ms']:.1f}ms over "
          f"{itl['count']} intervals")
    print(f"[serve_async] histogram buckets: ttft={ttft['buckets']} "
          f"itl={itl['buckets']}")
    return reference, summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    run(int(os.environ.get("SERVE_ASYNC_REQUESTS", "4")),
        int(os.environ.get("SERVE_ASYNC_TOKENS", "8")),
        ap.parse_args().device)
