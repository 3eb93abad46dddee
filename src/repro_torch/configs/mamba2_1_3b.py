"""mamba2-1.3b [ssm]: 48L d_model=2048, attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]

long_500k RUNS: attention-free, O(1) state per decoded token.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="mamba2-smoke", n_layers=2, d_model=64, vocab_size=97,
    ssm_state=16, ssm_head_dim=8, ssm_chunk=8, dtype="float32")

SHAPE_SKIPS = {}
