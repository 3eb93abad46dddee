"""Paged posit-KV serving: the engine (continuous batching, prefix sharing
with copy-on-write pages, fused prefill and fused decode, speculative
decoding, preemption; engine.py) and an asyncio front end with SLO
classes, deadlines, preemption and streaming (frontend.py)."""
from .engine import PageAllocator, Request, ServingEngine  # noqa: F401
from .frontend import (AsyncServingFrontend, SLOClass, Ticket,  # noqa: F401
                       DeadlineExceeded, INTERACTIVE, BATCH)
