"""Unified model API — dispatch by config family (PyTorch port of
`repro.models.api`; the dense family of slice 1).

    param_specs(cfg)                                  -> tree[ParamSpec]
    init(generator, cfg, device)                      -> params
    decode_step(params, tokens, cache, cfg)           -> (logits, cache')
    decode_and_sample(params, tokens, cache, cfg, ...) -> (tokens, cache')
    prefill_chunk(_batched)(...)                      -> (logits, cache')
    cache_specs / init_cache                          -> paged KV cache
    sample_noise(generator, batch, vocab, device)     -> gumbel [B, V]

Posit-packed parameters (`packing.pack_params`) are accepted everywhere:
the GEMM dispatch layer detects integer code containers.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import common, transformer
from .config import ModelConfig
from .module import init_params
from .packing import (pack_manifest, pack_params,  # noqa: F401
                      packed_param_specs, weight_bytes)
from .paged import PagedLayout


def _mod(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family '{cfg.family}' is not ported yet (ROADMAP queue 1)")
    return transformer


def param_specs(cfg: ModelConfig):
    return _mod(cfg).param_specs(cfg)


def init(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random parameters on `device`, drawn from `generator` (which must
    live on that device)."""
    from repro_torch import resolve_device
    return init_params(generator, param_specs(cfg), resolve_device(device))


def decode_step(params, tokens, cache, cfg: ModelConfig):
    return _mod(cfg).decode_step(params, tokens, cache, cfg)


def sample_noise(generator: torch.Generator, batch: int, vocab_size: int,
                 device="cpu"):
    """Standard-gumbel noise [batch, V] from a torch.Generator: the noise
    `argmax(noise + logits / T)` samples with (categorical sampling)."""
    u = torch.rand((batch, vocab_size), generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny, max=1.0 - 2 ** -24)))


def decode_and_sample(params, tokens, cache, cfg: ModelConfig, noise,
                      temperature, *, greedy: bool, top_k: int):
    """One decode step with the fused head + sampler: ([B] int32 tokens,
    cache'), the tokens equal to `decode_step` followed by the engine
    sampler.  noise: [B, V] f32 gumbel rows (None when greedy)."""
    spec = common.SampleSpec(noise=noise, temperature=temperature,
                             greedy=greedy, top_k=top_k)
    return _mod(cfg).decode_step(params, tokens, cache, cfg, sample=spec)


def prefill_chunk(params, tokens, cache, slot: int, cfg: ModelConfig):
    """Process one prompt chunk [1, C] for one slot of the paged cache."""
    return _mod(cfg).prefill_chunk(params, tokens, cache, slot, cfg)


def prefill_chunk_batched(params, tokens, cache, active, cfg: ModelConfig):
    """Advance every active slot by one same-size chunk in one [B, C] pass."""
    return _mod(cfg).prefill_chunk_batched(params, tokens, cache, active, cfg)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                layout: Optional[PagedLayout] = None):
    return _mod(cfg).cache_specs(cfg, batch, max_seq, layout)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               layout: Optional[PagedLayout] = None, device="cuda"):
    from repro_torch import resolve_device
    return _mod(cfg).init_cache(cfg, batch, max_seq, layout,
                                device=resolve_device(device))
