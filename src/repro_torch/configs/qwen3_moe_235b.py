"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151936, rope_theta=1_000_000.0, qk_norm=True,
    n_experts=128, top_k=8, moe_d_ff=1536, moe_interval=1,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    capacity_factor=2.5,  # no routing drops at smoke scale
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, vocab_size=499, n_experts=8, top_k=2,
    moe_d_ff=48, dtype="float32")

SHAPE_SKIPS = {
    "long_500k": "pure full attention: 500k-context decode excluded by "
                 "assignment rule",
}
