"""Paged posit-KV serving engine: continuous batching, prefix sharing with
copy-on-write pages, fused prefill and fused decode (see engine.py)."""
from .engine import PageAllocator, Request, ServingEngine  # noqa: F401
