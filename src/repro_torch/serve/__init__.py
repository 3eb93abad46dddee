"""Paged posit-KV serving engine."""
from .engine import PageAllocator, Request, ServingEngine  # noqa: F401
