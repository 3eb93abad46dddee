"""Fault-tolerance control plane: heartbeats, stragglers, elastic rescale."""
from .fault_tolerance import (  # noqa: F401
    HeartbeatConfig, HeartbeatMonitor, NaNGuard, RescalePlan,
    StragglerDetector, plan_rescale,
)
