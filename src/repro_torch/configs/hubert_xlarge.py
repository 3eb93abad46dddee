"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 —
encoder-only (wav2vec2-style backbone). [arXiv:2106.07447; unverified]

The convolutional audio frontend is a STUB, as in the reference:
`api.input_specs` gives precomputed frame embeddings [B, S, 512].
Encoder-only => no decode_32k / long_500k cells.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, causal=False,
    frontend="audio_stub", frontend_dim=512,
    tie_embeddings=False,
)

SMOKE = CONFIG.replace(
    name="hubert-xlarge-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=59, frontend_dim=24,
    dtype="float32")

SHAPE_SKIPS = {
    "decode_32k": "encoder-only architecture: no autoregressive decode step",
    "long_500k": "encoder-only architecture: no autoregressive decode step",
}
