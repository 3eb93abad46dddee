"""Architecture registry of the PyTorch port (port of `repro.configs`).

The port's slice 1 covers the dense serving main path, so the registry
holds `command_r_35b` only; other names raise KeyError until their family
is ported (ROADMAP queue 1).  `get(name)` / `get_smoke(name)` /
`get_tiny_serving(name)` mirror the reference and return equal shapes.
"""
from __future__ import annotations

import importlib

ARCH_NAMES = ("command_r_35b",)

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
    }.get(_ALIASES.get(name, name), {})
    if quant is not None:
        shrink["quant"] = quant
    return cfg.replace(**shrink)
