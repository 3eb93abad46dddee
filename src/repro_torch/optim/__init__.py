"""Optimizers and schedules (PyTorch port of `repro.optim`)."""
from .optimizers import (  # noqa: F401
    Optimizer, adamw, adafactor, sgdm, by_name,
    cosine_schedule, constant_schedule, clip_by_global_norm, global_norm,
)
