"""Unified model API — dispatch by config family (PyTorch port of
`repro.models.api`; the dense, MoE, SSM and hybrid families).

    param_specs(cfg)                                  -> tree[ParamSpec]
    init(generator, cfg, device)                      -> params
    apply(params, batch, cfg, **kw)                   -> logits [B, S, V]
    prefill(params, batch, cfg, max_seq, device)      -> (logits, dense cache)
    input_specs(cfg, shape) / abstract_state(cfg)     -> meta tensors
    decode_step(params, tokens, cache, cfg, active=None) -> (logits, cache')
    decode_and_sample(params, tokens, cache, cfg, ..., active=None)
                                                      -> (tokens, cache')
    decode_verify(params, tokens, cache, cfg, ...)    -> ([B, T] tokens, cache')
    prefill_chunk(_batched)(...)                      -> (logits, cache')
    cache_specs / init_cache                          -> paged or dense KV cache
                                                         (+ recurrent states)
    sample_noise(generator, batch, vocab)             -> gumbel [B, V]

Posit-packed parameters (`packing.pack_params`, inverted by
`unpack_params`) are accepted everywhere: the GEMM dispatch layer detects
integer code containers.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import common, hybrid, mamba, moe, transformer
from .config import ModelConfig, ShapeConfig
from .module import abstract_params, init_params
from .packing import (pack_manifest, pack_params,  # noqa: F401
                      packed_param_specs, unpack_params, weight_bytes)
from .paged import PagedLayout


_FAMILIES = {"dense": transformer, "moe": moe, "ssm": mamba,
             "hybrid": hybrid}


def _mod(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family '{cfg.family}' is not ported yet (ROADMAP queue 1)")
    return _FAMILIES[cfg.family]


def param_specs(cfg: ModelConfig):
    return _mod(cfg).param_specs(cfg)


def init(generator: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random parameters on `device`, drawn from `generator` (which must
    live on that device)."""
    from repro_torch import resolve_device
    return init_params(generator, param_specs(cfg), resolve_device(device))


def apply(params, batch, cfg: ModelConfig, **kw):
    """Whole-sequence forward (training): batch {"tokens": [B, S]} -> f32
    logits [B, S, V].  `kw` goes to the family's `apply`: `collect_cache`
    (each attention layer's (k, v)) and, for the MoE and hybrid families,
    `with_aux` (the layers' mean load-balance loss, returned last)."""
    return _mod(cfg).apply(params, batch, cfg, **kw)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, with_labels=True):
    """Model inputs for one shape cell as meta tensors (shapes and dtypes,
    no storage): train / prefill a [B, S] token batch (plus [B, S] labels
    for train), decode one token per row."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: stub frontends (vlm / encoder) are not ported yet")
    B, S = shape.global_batch, shape.seq_len

    def meta(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta(B)}
    batch = {"tokens": meta(B, S)}
    if with_labels and shape.kind == "train":
        batch["labels"] = meta(B, S)
    return batch


def abstract_state(cfg: ModelConfig):
    """The parameter tree as meta tensors."""
    return abstract_params(param_specs(cfg))


def prefill(params, batch, cfg: ModelConfig, max_seq: Optional[int] = None,
            device="cuda"):
    """Whole-sequence prefill: batch {"tokens": [B, S]} (tensors or numpy,
    moved to `device`, where `params` must live) -> (f32 logits [B, S, V],
    the dense cache after the prompt, length S: KV rows [L, B, max(max_seq,
    S), Hkv*Dh] and, for the SSM and hybrid families, the recurrent
    states)."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    return _mod(cfg).prefill(params, batch, cfg, max_seq=max_seq)


def decode_step(params, tokens, cache, cfg: ModelConfig, active=None):
    return _mod(cfg).decode_step(params, tokens, cache, cfg, active=active)


def sample_noise(generator: torch.Generator, batch: int, vocab_size: int,
                 device=None):
    """Standard-gumbel noise [batch, V] from a torch.Generator: the noise
    `argmax(noise + logits / T)` samples with (categorical sampling).  It is
    drawn on `device`, by default the generator's own."""
    if device is None:
        device = generator.device
    u = torch.rand((batch, vocab_size), generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny, max=1.0 - 2 ** -24)))


def decode_and_sample(params, tokens, cache, cfg: ModelConfig, noise,
                      temperature, *, greedy: bool, top_k: int, active=None):
    """One decode step with the fused head + sampler: ([B] int32 tokens,
    cache'), the tokens equal to `decode_step` followed by the engine
    sampler.  noise: [B, V] f32 gumbel rows (None when greedy); `active`
    as `decode_step`'s."""
    spec = common.SampleSpec(noise=noise, temperature=temperature,
                             greedy=greedy, top_k=top_k)
    return _mod(cfg).decode_step(params, tokens, cache, cfg, sample=spec,
                                 active=active)


def decode_verify(params, tokens, cache, cfg: ModelConfig, noise,
                  temperature, *, greedy: bool, top_k: int):
    """k-token speculative verify: tokens [B, T] (the committed next token
    and T-1 draft proposals per slot) under the serve policy, with one
    multi-query paged-attention launch per layer and one head + sampler
    launch over the B*T rows.  Returns ([B, T] int32 target tokens, cache'
    with length + T): row (b, j) is bitwise the token T sequential
    `decode_and_sample` calls would emit at that position given the same
    inputs.

    noise: [B*T, V] f32 gumbel rows, b-major (row b * T + j is slot b's
    draw j; None when greedy); temperature: python float."""
    mod = _mod(cfg)
    if not hasattr(mod, "decode_verify"):
        raise NotImplementedError(
            f"family {cfg.family!r} has no k-token verify step")
    spec = common.SampleSpec(noise=noise, temperature=temperature,
                             greedy=greedy, top_k=top_k)
    return mod.decode_verify(params, tokens, cache, cfg, sample=spec)


def prefill_chunk(params, tokens, cache, slot: int, cfg: ModelConfig):
    """Process one prompt chunk [1, C] for one slot of the paged or the
    dense cache."""
    return _mod(cfg).prefill_chunk(params, tokens, cache, slot, cfg)


def prefill_chunk_batched(params, tokens, cache, active, cfg: ModelConfig):
    """Advance every active slot by one same-size chunk in one [B, C] pass."""
    return _mod(cfg).prefill_chunk_batched(params, tokens, cache, active, cfg)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                layout: Optional[PagedLayout] = None):
    return _mod(cfg).cache_specs(cfg, batch, max_seq, layout)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               layout: Optional[PagedLayout] = None, device="cuda"):
    """The zeroed KV cache: dense with layout=None, else paged."""
    from repro_torch import resolve_device
    return _mod(cfg).init_cache(cfg, batch, max_seq, layout,
                                device=resolve_device(device))
