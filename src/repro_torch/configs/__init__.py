"""Architecture registry of the PyTorch port (port of `repro.configs`).

The registry holds the configurations the port runs: the dense
`command_r_35b`, `command_r_plus_104b`, `gemma3_4b` (5:1 local:global
sliding-window attention, qk-norm) and `minitron_8b` (the training
example's default), the two MoE models `qwen3_moe_235b` and
`deepseek_moe_16b`, the SSM `mamba2_1_3b` and the hybrid
`jamba_1_5_large`; the stub-frontend names (`hubert_xlarge`,
`paligemma_3b`) raise KeyError until they are ported (ROADMAP queue 1).  `get(name)` / `get_smoke(name)` /
`get_tiny_serving(name)` mirror the reference and return equal shapes;
`shape_skips(name)` gives the assigned shape cells an arch does not run,
with reasons, and `runnable_shapes(name)` the others.
"""
from __future__ import annotations

import importlib

ARCH_NAMES = ("command_r_35b", "command_r_plus_104b", "gemma3_4b",
              "minitron_8b", "qwen3_moe_235b", "deepseek_moe_16b",
              "jamba_1_5_large", "mamba2_1_3b")

_ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES}


def _module(name: str):
    name = _ALIASES.get(name, name)
    if name not in ARCH_NAMES:
        raise KeyError(f"arch '{name}' is not ported yet (have {ARCH_NAMES})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def get_tiny_serving(name: str, quant=None):
    """Reduced-further smoke config for fast CPU serving parity checks
    (the reference's `get_tiny_serving` geometry)."""
    cfg = get_smoke(name)
    shrink = {
        "command_r_35b": dict(n_layers=1, d_model=16, n_heads=2,
                              n_kv_heads=1, head_dim=8, d_ff=32,
                              vocab_size=64),
        "mamba2_1_3b": dict(n_layers=1, vocab_size=64),
        "jamba_1_5_large": dict(n_layers=2, d_model=32, d_ff=48,
                                moe_d_ff=48, vocab_size=64),
        "qwen3_moe_235b": dict(n_layers=1, d_model=32, n_experts=4,
                               top_k=2, moe_d_ff=16, vocab_size=64),
    }.get(_ALIASES.get(name, name), {})
    if quant is not None:
        shrink["quant"] = quant
    return cfg.replace(**shrink)


def shape_skips(name: str) -> dict:
    """shape_name -> reason, for cells this arch skips by assignment rule."""
    return getattr(_module(name), "SHAPE_SKIPS", {})


def runnable_shapes(name: str):
    from repro_torch.models.config import ALL_SHAPES
    skips = shape_skips(name)
    return tuple(s for s in ALL_SHAPES if s.name not in skips)
