"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained.
[arXiv:2401.06066; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=102400, rope_theta=10_000.0,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408, moe_interval=1,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    capacity_factor=2.5,  # no routing drops at smoke scale
    name="deepseek-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, vocab_size=499, n_experts=8,
    n_shared_experts=2, top_k=3, moe_d_ff=32, dtype="float32")

SHAPE_SKIPS = {
    "long_500k": "pure full attention: 500k-context decode excluded by "
                 "assignment rule",
}
