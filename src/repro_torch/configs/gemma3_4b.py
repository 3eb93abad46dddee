"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global sliding attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

long_500k RUNS for this arch: 5-in-6 layers are sliding-window
(sub-quadratic); the global layers attend into the existing KV cache,
linear per decode step.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144, rope_theta=1_000_000.0,
    sliding_window=1024, global_interval=6, qk_norm=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="gemma3-4b-smoke", n_layers=6, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=160, vocab_size=511,
    sliding_window=8, dtype="float32")

SHAPE_SKIPS = {}
