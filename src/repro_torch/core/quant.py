"""Posit quantization policy and execution-plan table (PyTorch port of
`repro.core.quant`).

A `QuantPolicy` says which tensors are stored/computed in which posit
format and which GEMM datapath (`execution`) runs every model matmul:

  fake_quant : decode(encode(x)) on both operands, then a plain f32 dot
               (`kernels/dispatch.fake_quantize`).
  fused      : weights travel as posit *codes* (int8/int16) and are decoded
               exactly next to the dot (`kernels/ops.matmul_posit_weights`:
               a GEMV that decodes in-kernel at decode rows, the codec
               kernel right before the dot above), f32 accumulation; with
               `activations` set, both operands travel as codes through
               the coded GEMM kernel (`kernels/ops.fused_matmul`).
  bit_exact  : the chunked-PDPU datapath, bit for bit the paper's W_m
               accumulator (`kernels/ops.pdpu_matmul`).

The serving knobs (`kv_page_size`, `prefix_sharing`, `batched_prefill`,
`fused_prefill`, `fused_decode`) keep the reference's meanings and
defaults, and the port's engine implements all of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .formats import PositFormat, PDPUConfig, P16_2, P16_1, P13_2, P8_2
from . import posit

@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """One row of the execution-plan table: how a datapath may be used.

    trainable : autograd flows through it (an STE backward exists).
    servable  : the serving engine may run it on the decode hot path.
    datapath  : one-line description of what actually executes.
    """

    trainable: bool
    servable: bool
    datapath: str


PLAN_TABLE = {
    "fake_quant": ExecutionPlan(
        trainable=True, servable=True,
        datapath="STE fake-quantization + plain f32 dot"),
    "fused": ExecutionPlan(
        trainable=True, servable=True,
        datapath="packed posit codes -> codec-kernel decode, f32 "
                 "accumulate; STE backward for QAT"),
    "bit_exact": ExecutionPlan(
        trainable=False, servable=True,
        datapath="chunked-PDPU kernel (S1..S6 integer datapath, W_m "
                 "alignment truncation); forward-only validation"),
}
EXECUTION_PLANS = tuple(PLAN_TABLE)
TRAINABLE_PLANS = tuple(p for p, row in PLAN_TABLE.items() if row.trainable)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which tensors travel through which posit format (None = keep float).

    weights     : storage/compute format of weight matrices.
    activations : format applied to matmul activations (inputs).
    kv_cache    : serving KV-cache storage format.
    grad_allreduce : gradient compression format for cross-replica reduce.
    accum_dtype : wide accumulation dtype — the W_m analogue.
    execution   : which GEMM datapath runs the matmuls (see PLAN_TABLE and
                  kernels/dispatch.py): 'fake_quant' | 'fused' |
                  'bit_exact'.  fake_quant and fused are trainable (both
                  carry STE backwards); bit_exact is forward-only.
    kv_page_size : tokens per KV page when serving with a paged cache
                  (models/paged.py): the KV pool is [n_pages, kv_page_size,
                  Hkv*Dh] at `kv_cache` code width and the paged-attention
                  kernel gathers/decodes pages by block table.
                  Dense serving ignores it.
    prefix_sharing : serving-scheduler knob — requests whose prompts share
                  a prefix map the same physical KV pages (refcounted,
                  copy-on-write on divergence) and only prefill the
                  unshared tail, turning repeated-system-prompt traffic
                  from O(requests x prompt) into O(unique prefix) prefill
                  compute and KV pages.  Paged serving only; the engine
                  ctor can override per instance.
    batched_prefill : serving-scheduler knob — prefill chunks of the same
                  bucket size from multiple slots run as one
                  [batch_slots, chunk] program (api.prefill_chunk_batched)
                  instead of a per-slot loop: one compile per bucket and
                  one device call per (step, bucket) regardless of how
                  many slots are filling.
    fused_prefill : serving-kernel knob — paged prefill chunks run the
                  fused prefill program (kernels/prefill_attention.py):
                  chunk attention + posit KV encode + page scatter in ONE
                  device program instead of three (flash_attention,
                  kv_encode, insert_chunk).  Bit-identical to the
                  decomposed path for arbitrary spans — history beyond one
                  flash chunk streams through the kernel's running flash
                  softmax page-by-page; only a page size that does not
                  divide `paged.FLASH_CHUNK` still forces the decomposed
                  fallback (paged.fused_prefill_span_ok).
    fused_decode : serving-kernel knob — each paged decode step runs
                  attention + logits-head GEMM + sampling epilogue as ONE
                  device program (common.sample_head /
                  kernels ops.decode_sample) instead of a decode dispatch
                  followed by a sampler dispatch.  Bit-identical tokens;
                  bit_exact execution keeps the decomposed pair (its head
                  GEMM has no fused replay).
    pdpu_n, pdpu_w_m : chunk size and alignment width of the PDPU instance
                  used by the 'bit_exact' plan (paper Table I knobs).
    """

    weights: Optional[PositFormat] = None
    activations: Optional[PositFormat] = None
    kv_cache: Optional[PositFormat] = None
    grad_allreduce: Optional[PositFormat] = None
    accum_dtype: torch.dtype = torch.float32
    execution: str = "fake_quant"
    kv_page_size: int = 16
    prefix_sharing: bool = True
    batched_prefill: bool = True
    fused_prefill: bool = True
    fused_decode: bool = True
    pdpu_n: int = 4
    pdpu_w_m: int = 14

    def __post_init__(self):
        if self.execution not in EXECUTION_PLANS:
            raise ValueError(
                f"unknown execution plan '{self.execution}' (have {EXECUTION_PLANS})")
        if self.execution != "fake_quant" and self.weights is None:
            raise ValueError(
                f"execution='{self.execution}' requires a posit weights format")

    @property
    def enabled(self) -> bool:
        return any(f is not None for f in (self.weights, self.activations, self.kv_cache))

    def maybe_quant_kv(self, kv):
        if self.kv_cache is None:
            return kv
        return posit.quantize(kv, self.kv_cache)

    @property
    def plan(self) -> ExecutionPlan:
        """Plan-table row for the selected execution datapath."""
        return PLAN_TABLE[self.execution]

    @property
    def trainable(self) -> bool:
        """True if autograd flows through this policy's datapath."""
        return self.plan.trainable

    def require_trainable(self) -> "QuantPolicy":
        """Raise early (before tracing) when the selected datapath cannot
        back-propagate — the same condition the dispatch-layer grad barrier
        enforces lazily under autograd."""
        if not self.trainable:
            raise ValueError(
                f"execution plan '{self.execution}' is not differentiable; "
                f"trainable plans are {TRAINABLE_PLANS}.  Switch with "
                f"QuantPolicy.with_execution(...) for QAT — bit_exact is a "
                f"forward-only validation datapath.")
        return self

    def with_execution(self, plan: str) -> "QuantPolicy":
        """Same formats, different datapath — e.g. train fake_quant, then
        serve the identical policy fused."""
        return dataclasses.replace(self, execution=plan)

    def with_serving_activations(self, fmt: PositFormat) -> "QuantPolicy":
        """Activation-format serving knob: encode matmul activations to
        `fmt` posit codes and run the both-operands fused kernel, trading a
        rounding per activation element for code-width GEMM operand
        bandwidth (int8/int16 instead of f32 GEMM operands)."""
        return dataclasses.replace(self, activations=fmt, execution="fused")

    def with_draft(self, weights: Optional[PositFormat] = None,
                   execution: str = "fake_quant") -> "QuantPolicy":
        """Speculative-draft policy derived from this serving policy.

        `kv_cache` and `kv_page_size` are kept identical — the draft model
        writes (placeholder) codes into the very pages the target verify
        pass re-encodes and attends, so draft/verify agree on every page
        address and code width and speculative acceptance is exact by
        construction, never approximate.  Only the compute side gets
        cheaper: `execution` defaults to the fake_quant stand-in (plain
        f32 dots over fake-quantized masters — no packed-kernel launches
        on the draft path) and `weights` may narrow the draft's weight
        code (e.g. P(8, 0) via the plan table) for a bandwidth-bound
        draft."""
        return dataclasses.replace(
            self,
            weights=weights if weights is not None else self.weights,
            execution=execution)

    def pdpu_config(self) -> PDPUConfig:
        """PDPU instance for the bit_exact plan: inputs in the weights
        format, accumulator/output in the paper's wider P(16,es)."""
        fmt_in = self.weights or self.activations
        if fmt_in is None:
            raise ValueError("bit_exact plan needs a posit weights/activations format")
        fmt_out = PositFormat(max(fmt_in.n, 16), fmt_in.es)
        return PDPUConfig(fmt_in, fmt_out, N=self.pdpu_n, w_m=self.pdpu_w_m)


# The paper's headline mixed-precision configuration, P(13/16,2):
# low-precision inputs, higher-precision accumulation.
PAPER_MIXED = QuantPolicy(weights=P13_2, activations=P13_2)
# Uniform P(16,2) (Table I row 3).
UNIFORM_P16 = QuantPolicy(weights=P16_2, activations=P16_2)
# Serving policy: posit weights + posit KV cache, float activations.
SERVE_P16_KV8 = QuantPolicy(weights=P16_2, kv_cache=P8_2)
# Serving fast path: packed posit weights through the fused plan.
SERVE_FUSED_P16 = QuantPolicy(weights=P16_2, kv_cache=P8_2, execution="fused")
# Activation-coded serving: both operands travel as posit codes through the
# both-operands fused kernel (the accuracy/bandwidth trade — one extra
# rounding per activation element for int16 instead of f32 GEMM operands).
SERVE_FUSED_P16_A13 = SERVE_FUSED_P16.with_serving_activations(P13_2)
# Paged serving: fused weights + P(16,1)-coded KV pages of 16 tokens — the
# paged runtime's default (decode state at int16 code width, allocated per
# page in flight instead of per max_seq slot).
SERVE_PAGED_P16 = QuantPolicy(weights=P16_2, kv_cache=P16_1,
                              execution="fused", kv_page_size=16)
# Hardware-faithful validation: every matmul through the chunked-PDPU kernel.
VALIDATE_BIT_EXACT = QuantPolicy(weights=P13_2, activations=P13_2,
                                 execution="bit_exact")
# No quantization (baseline).
NONE = QuantPolicy()


def policy_by_name(name: str) -> QuantPolicy:
    table = {
        "none": NONE,
        "paper_mixed": PAPER_MIXED,
        "uniform_p16": UNIFORM_P16,
        "serve_p16_kv8": SERVE_P16_KV8,
        "serve_fused_p16": SERVE_FUSED_P16,
        "serve_fused_p16_a13": SERVE_FUSED_P16_A13,
        "serve_paged_p16": SERVE_PAGED_P16,
        "validate_bit_exact": VALIDATE_BIT_EXACT,
    }
    if name not in table:
        raise KeyError(f"unknown quant policy '{name}' (have {sorted(table)})")
    return table[name]
