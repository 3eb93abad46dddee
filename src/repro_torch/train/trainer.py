"""Training loop with its control plane (PyTorch port of
`repro.train.trainer`): checkpoint / restart, the NaN guard's rollback,
straggler detection, async saves, deterministic data resume and a
per-step history.  Eager PyTorch: each step runs the kernels as it goes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data.pipeline import Pipeline
from repro_torch.models import api
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim.optimizers import Optimizer
from repro_torch.runtime.fault_tolerance import NaNGuard, StragglerDetector
from . import step as step_lib


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    accum: int = 1
    async_ckpt: bool = True
    keep_last: int = 3


class Trainer:
    """Runs `make_train_step` over `pipeline`'s batches on `device` (a card
    by default; raises without one)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, opt: Optimizer,
                 pipeline: Pipeline, tcfg: TrainerConfig = TrainerConfig(),
                 device="cuda"):
        self.cfg = cfg
        self.shape = shape
        self.opt = opt
        self.pipeline = pipeline
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.train_step = step_lib.make_train_step(cfg, opt, tcfg.accum)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, tcfg.keep_last)
                     if tcfg.ckpt_dir else None)
        self.straggler = StragglerDetector()
        self.nan_guard = NaNGuard()
        self.history: list = []

    # -- state lifecycle -----------------------------------------------------
    def init_or_restore(self, generator: torch.Generator) -> step_lib.TrainState:
        """The latest checkpoint's state if there is one, else a fresh
        state drawn from `generator` (which lives on the trainer's
        device)."""
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                # parameters and moments on the meta device land on the
                # card; the step counters stay host scalars
                params = api.abstract_state(self.cfg)
                like = step_lib.TrainState(
                    params, self.opt.init(params),
                    torch.zeros((), dtype=torch.int32))
                state = self.ckpt.restore(latest, like, device=self.device)
                print(f"[trainer] restored step {latest}")
                return state
        return step_lib.init_state(generator, self.cfg, self.opt, self.device)

    # -- main loop -------------------------------------------------------------
    def run(self, generator: torch.Generator, steps: Optional[int] = None):
        state = self.init_or_restore(generator)
        start = int(state.step)
        steps = steps if steps is not None else self.tcfg.total_steps
        last_good = start
        it = self.pipeline.iterator(start)
        t_tokens = self.shape.tokens
        try:
            for s in range(start, steps):
                batch = self._to_device(next(it))
                t0 = time.perf_counter()
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])  # waits for the step's kernels
                dt = time.perf_counter() - t0

                verdict = self.nan_guard.observe(loss)
                if (verdict == "restore" and self.ckpt is not None
                        and self.ckpt.all_steps()):
                    print(f"[trainer] non-finite loss "
                          f"x{self.nan_guard.consecutive}; rolling back to "
                          f"step {last_good}")
                    state = self.init_or_restore(generator)
                    it.close()
                    it = self.pipeline.iterator(int(state.step))
                    continue
                if self.straggler.observe(dt):
                    print(f"[trainer] straggler step {s}: {dt:.3f}s (median "
                          f"{self.straggler.stats().get('median_s', 0):.3f}s)")

                self.history.append({"step": s, "loss": loss, "time_s": dt,
                                     "tokens_per_s": t_tokens / max(dt, 1e-9)})
                if (s + 1) % self.tcfg.log_every == 0:
                    print(f"[trainer] step {s + 1} loss {loss:.4f} "
                          f"ce {float(metrics['ce']):.4f} {dt * 1e3:.0f}ms")
                if self.ckpt is not None and (s + 1) % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(s + 1, state,
                                   blocking=not self.tcfg.async_ckpt)
                    last_good = s + 1
        finally:
            it.close()
        if self.ckpt is not None:
            self.ckpt.save(steps, state, blocking=True)
        return state

    def _to_device(self, batch):
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
