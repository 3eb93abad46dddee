"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron. [arXiv:2407.14679; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000, rope_theta=10_000.0,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    name="minitron-8b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=509, dtype="float32")

SHAPE_SKIPS = {
    "long_500k": "pure full attention: 500k-context decode excluded by "
                 "assignment rule",
}
