"""Deterministic, resumable, host-sharded data pipeline."""
from .pipeline import DataConfig, Pipeline  # noqa: F401
