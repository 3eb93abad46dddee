"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384
vocab=257216 — SigLIP vision frontend + gemma decoder. [arXiv:2407.07726; hf]

The SigLIP tower is a STUB, as in the reference: `api.input_specs` gives
256 precomputed patch embeddings [B, 256, 1152], which `frontend_proj`
projects and prepends to the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216, rope_theta=10_000.0,
    frontend="vision_stub", frontend_tokens=256, frontend_dim=1152,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="paligemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    head_dim=16, d_ff=128, vocab_size=509, frontend_tokens=4,
    frontend_dim=24, dtype="float32")

SHAPE_SKIPS = {
    "long_500k": "pure full attention: 500k-context decode excluded by "
                 "assignment rule",
}
