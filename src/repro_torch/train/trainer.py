"""Trainer: the RUN and RESTORE half of the paper's RUN -> DETECT -> ISOLATE ->
RESTORE loop, on one device.

Port of ``repro.train.trainer``: the BSP train step (``train/steps.py``),
frequent checkpoints (in-memory replica + async disk flush), a
``StepMonitor`` anchored at the step boundary, and a restore from the newest
valid checkpoint; the data pipeline is a pure function of (seed, step), so a
restored job consumes exactly the stream it would have. The DETECT/ISOLATE
branch (fault injector, simulated cluster, steering, the C4D master and its
telemetry) waits for the detection slice of the port (ROADMAP.md, Queue 1):
``train`` refuses a fault schedule.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.config import RunConfig, ShapeSpec
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train.hooks import StepMonitor
from repro_torch.train.steps import make_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclass
class TrainerReport:
    steps_run: int = 0
    restarts: int = 0
    detections: List[dict] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    downtime_steps: int = 0
    metrics: List[Dict[str, float]] = field(default_factory=list)   # per step, on the host


class Trainer:
    """Weights from ``model.init_weights`` with a ``torch.Generator`` seeded
    ``run.train.seed``; ``device=None`` means ``cuda``."""

    def __init__(self, run: RunConfig, shape: ShapeSpec, workdir: str, device=None,
                 use_kernel: bool = True, checkpoint_async: bool = True):
        self.run = run
        self.shape = shape
        self.device = resolve_device(device)
        self.model = build_model(run, device=self.device, use_kernel=use_kernel)
        self.model.init_weights(torch.Generator(self.device).manual_seed(run.train.seed))
        self.params = dict(self.model.named_parameters())
        self.opt_cfg = adamw.OptimizerConfig(kind=run.parallel.optimizer_state,
                                             weight_decay=run.train.weight_decay)
        self.opt_state = adamw.init_state(self.opt_cfg, self.params)
        self.ckpt = CheckpointManager(workdir, keep=run.train.keep_checkpoints,
                                      async_disk=checkpoint_async)
        self.pipeline = TokenPipeline(run.model, shape, PipelineConfig(seed=run.train.seed))
        self.monitor = StepMonitor()
        self.report = TrainerReport()
        self._step_fn = make_train_step(self.model, run, self.opt_cfg)
        self.step = 0

    # ------------------------------------------------------------------
    def _tree(self):
        return {"params": self.params, "opt": self.opt_state, "step": np.asarray(self.step)}

    def _save_checkpoint(self, blocking: bool = False):
        self.ckpt.save(self.step, self._tree(), blocking=blocking)

    @torch.no_grad()
    def restore(self, step: Optional[int] = None) -> int:
        """Load the newest valid checkpoint (or ``step``'s) into the model and
        the optimizer state; the next step trained is the restored one."""
        s, tree = self.ckpt.restore(self._tree(), step)
        for name, p in self.params.items():
            p.copy_(tree["params"][name])
        self.opt_state = _to_device(tree["opt"], self.device)
        self.step = int(tree["step"])
        log.info("restored step %d", s)
        return s

    # ------------------------------------------------------------------
    def train(self, n_steps: int, injector=None) -> TrainerReport:
        if injector is not None and getattr(injector, "schedule", None):
            raise NotImplementedError(
                "fault injection needs the C4D detection slice of the port "
                "(ROADMAP.md, Queue 1 items 2-4)")
        run = self.run
        self._save_checkpoint(blocking=True)  # step-0 baseline
        target = self.step + n_steps
        while self.step < target:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch(self.step).items()}
            self.monitor.start()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step on the device
            self.monitor.stop(self.step)
            self.report.losses.append(loss)
            self.report.metrics.append({k: float(v) for k, v in metrics.items()})
            self.report.steps_run += 1
            self.step += 1
            if self.step % run.train.checkpoint_every == 0:
                self._save_checkpoint()
        self.ckpt.wait()
        return self.report


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)
