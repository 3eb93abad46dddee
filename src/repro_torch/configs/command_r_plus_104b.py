"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000, rope_theta=75_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="command-r-plus-104b-smoke", n_layers=2, d_model=96, n_heads=6,
    n_kv_heads=2, head_dim=16, d_ff=264, vocab_size=503, dtype="float32")

SHAPE_SKIPS = {
    "long_500k": "pure full attention: 500k-context decode excluded by "
                 "assignment rule",
}
