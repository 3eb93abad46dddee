"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]

long_500k RUNS: 7-in-8 layers are O(1)/token Mamba; the attention layers
read the 500k KV cache linearly per decode step.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536, rope_theta=10_000.0,
    attn_interval=8, moe_interval=2,
    n_experts=16, top_k=2, moe_d_ff=24576,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    capacity_factor=2.5,  # avoid routing drops at smoke scale (decode==forward tests)
    name="jamba-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=96, vocab_size=257, attn_interval=2, moe_interval=2,
    n_experts=4, top_k=2, moe_d_ff=96, ssm_state=16, ssm_head_dim=8,
    ssm_chunk=8, dtype="float32")

SHAPE_SKIPS = {}
