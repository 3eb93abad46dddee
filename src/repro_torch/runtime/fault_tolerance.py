"""Fault-tolerance runtime: heartbeats, straggler detection, restart and
elastic-rescale planning (port of `repro.runtime.fault_tolerance`; pure
Python, the same verdicts).

The failure model: slow devices (stragglers), dead hosts (restart from a
checkpoint on fewer or more hosts) and flaky steps (a non-finite loss).
This module is the control plane, host logic testable without a card;
`train.trainer` feeds it step times and losses and acts on its verdicts.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Dict, List, Optional


@dataclasses.dataclass
class HeartbeatConfig:
    interval_s: float = 10.0
    miss_budget: int = 3          # missed beats before declared dead
    straggler_zscore: float = 3.0  # step-time z-score threshold
    straggler_window: int = 50
    min_steps_for_stats: int = 10


class HeartbeatMonitor:
    """Tracks per-host liveness from heartbeat timestamps."""

    def __init__(self, hosts: List[str], cfg: HeartbeatConfig = HeartbeatConfig()):
        self.cfg = cfg
        self.last_beat: Dict[str, float] = {h: time.monotonic() for h in hosts}

    def beat(self, host: str, now: Optional[float] = None):
        self.last_beat[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        budget = self.cfg.interval_s * self.cfg.miss_budget
        return [h for h, t in self.last_beat.items() if now - t > budget]


class StragglerDetector:
    """Online step-time outlier detection (median + MAD z-score).

    In synchronous data parallelism a straggler shows up as the global
    step time inflating, so the trainer feeds global step durations; with
    per-host telemetry, feed per-host times through the same API.
    """

    def __init__(self, cfg: HeartbeatConfig = HeartbeatConfig()):
        self.cfg = cfg
        self.times: deque = deque(maxlen=cfg.straggler_window)

    def observe(self, step_time_s: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        flagged = False
        if len(self.times) >= self.cfg.min_steps_for_stats:
            med = sorted(self.times)[len(self.times) // 2]
            mad = sorted(abs(t - med) for t in self.times)[len(self.times) // 2]
            sigma = 1.4826 * max(mad, 1e-9)
            flagged = (step_time_s - med) / sigma > self.cfg.straggler_zscore
        self.times.append(step_time_s)
        return flagged

    def stats(self):
        if not self.times:
            return {}
        med = sorted(self.times)[len(self.times) // 2]
        return {"median_s": med, "n": len(self.times)}


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    """What an elastic restart looks like after a membership change."""
    old_hosts: int
    new_hosts: int
    new_mesh_shape: tuple
    restore_step: int
    data_start_step: int
    note: str


def plan_rescale(available_hosts: int, chips_per_host: int,
                 restore_step: int, model_axis: int = 16,
                 pods: int = 1) -> RescalePlan:
    """Choose the largest valid mesh on the surviving hosts.

    Keeps the model axis fixed (TP degree is a property of the sharded
    layout) and shrinks/grows the data axis; the pod axis drops to 1 if a
    whole pod is lost.  Checkpoints are mesh-elastic, and the data pipeline
    is step-indexed, so the plan is just (mesh, step).
    """
    chips = available_hosts * chips_per_host
    if chips < model_axis:
        raise RuntimeError(
            f"{chips} chips cannot host model axis {model_axis}; "
            "restore requires at least one full model-parallel group")
    data_axis = chips // (model_axis * pods)
    while data_axis > 1 and (model_axis * data_axis * pods) > chips:
        data_axis -= 1
    shape = (pods, data_axis, model_axis) if pods > 1 else (data_axis, model_axis)
    return RescalePlan(
        old_hosts=-1, new_hosts=available_hosts,
        new_mesh_shape=shape, restore_step=restore_step,
        data_start_step=restore_step,
        note=f"elastic restart on {chips} chips: mesh {shape}, "
             f"deterministic data resume at step {restore_step}")


class NaNGuard:
    """Detects non-finite loss and decides skip vs restore."""

    def __init__(self, max_consecutive: int = 3):
        self.max_consecutive = max_consecutive
        self.consecutive = 0

    def observe(self, loss: float) -> str:
        """-> 'ok' | 'skip' (drop this step) | 'restore' (roll back)."""
        if math.isfinite(loss):
            self.consecutive = 0
            return "ok"
        self.consecutive += 1
        return "restore" if self.consecutive >= self.max_consecutive else "skip"
