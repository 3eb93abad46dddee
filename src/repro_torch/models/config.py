"""Unified model configuration (PyTorch port of `repro.models.config`).

The fields are those of the reference, so a configuration reads the same
in both packages; `compute_dtype` is a torch dtype."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.quant import QuantPolicy, NONE as QUANT_NONE

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention variants
    causal: bool = True             # False => bidirectional encoder
    sliding_window: Optional[int] = None   # local attention window
    global_interval: int = 0        # gemma3: every k-th layer is global
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    qk_norm: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    moe_interval: int = 1           # MoE FFN every k-th layer (1 = all)
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_interval: int = 0          # hybrid: every k-th layer is attention

    # modality frontend (STUB per assignment: precomputed embeddings in)
    frontend: Optional[str] = None  # 'audio_stub' | 'vision_stub'
    frontend_tokens: int = 0        # prefix length contributed by frontend
    frontend_dim: int = 0           # embedding dim delivered by the stub

    # numerics / technique
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"
    quant: QuantPolicy = QUANT_NONE
    remat: str = "layer"            # none | layer
    scan_layers: bool = True
    tie_embeddings: bool = True

    # perf knobs (EXPERIMENTS.md §Perf hillclimb)
    cast_params_early: bool = False  # cast f32 master->compute dtype before
                                     # use so FSDP all-gathers ship bf16/f16
    shard_expert_cap: bool = False   # shard the MoE [E, C, D] dispatch
                                     # buffer's capacity dim over 'data'
    tp_bf16_reduce: bool = False     # dot outputs in compute dtype so the
                                     # TP partial-sum all-reduces ship bf16
                                     # (on-device MXU accumulation stays
                                     # wide; cross-shard sums round per
                                     # shard — the PDPU "acc in fmt_out"
                                     # contract applied across devices)
    fsdp_gather_weights: bool = False  # constrain weights to drop the FSDP
                                       # shard before each matmul: XLA then
                                       # all-gathers (bf16) weight shards
                                       # instead of partial-summing f32
                                       # activation tensors over 'data'
    moe_grouped_dispatch: bool = False  # GShard-style per-sequence routing
                                        # groups: sort/scatter are local to
                                        # each batch shard instead of one
                                        # global [T*k, D] gather/scatter
                                        # that SPMD resolves by replicate+
                                        # all-reduce (see EXPERIMENTS §Perf)

    # derived ---------------------------------------------------------------
    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def is_encoder(self) -> bool:
        return self.family == "encoder"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_is_global(self, idx: int) -> bool:
        """gemma3-style 5 local : 1 global pattern."""
        if self.sliding_window is None or self.global_interval == 0:
            return True
        return (idx + 1) % self.global_interval == 0

    def layer_is_attn(self, idx: int) -> bool:
        """jamba-style 1 attention : 7 mamba pattern."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return self.attn_interval > 0 and idx % self.attn_interval == 0

    def layer_is_moe(self, idx: int) -> bool:
        if self.n_experts == 0:
            return False
        return (idx % self.moe_interval) == (self.moe_interval - 1)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape '{name}'")
