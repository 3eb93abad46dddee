"""Optimizers, schedules and the posit-compressed gradient reduction
(PyTorch port of `repro.optim`)."""
from .optimizers import (  # noqa: F401
    Optimizer, adamw, adafactor, sgdm, by_name,
    cosine_schedule, constant_schedule, clip_by_global_norm, global_norm,
)
from . import compress  # noqa: F401
