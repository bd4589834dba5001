"""Fault-tolerant Trainer: the paper's RUN -> DETECT -> ISOLATE -> RESTORE
loop, on one device or on a mesh.

Port of ``repro.train.trainer``:
  * the BSP train step (``train/steps.py``), rebuilt after a restart; with a
    ``DeviceMesh`` the sharded step (the JAX package's FSDP/TP/EP placements,
    each rank computing its ``model`` shard of the batch axes' rows, every
    rank one process running this loop; the model is drawn on its shards a
    block at a time, the draws those of one device),
  * frequent checkpoints (in-memory replica + async disk flush) of full
    tensors under the one-device keys, so that a mesh run and a one-device
    run restore each other's; on a mesh every rank keeps the replica and
    rank 0 alone writes the disk,
  * C4D integration: a ``StepMonitor`` anchored at the step boundary; a
    ``FaultInjector`` produces enhanced-CCL telemetry faults and the C4D
    master (``core/c4d/master.py``, on the Trainer's device) issues verdicts,
  * elastic restart: the implicated node is isolated, a backup takes its
    place (``SimCluster``), and the job restores from the newest valid
    checkpoint, memory first; the data pipeline is a pure function of
    (seed, step), so the restored job consumes exactly the stream it would
    have.

The control-plane pieces (cluster, steering, C4D master, telemetry) are
injectable, so the live driver (``repro_torch.scenarios.live``) can replay a
drill's fault script on this loop against shared state.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.config import RunConfig, ShapeSpec
from repro_torch.core.c4d.master import C4DMaster
from repro_torch.core.cluster import SimCluster, SteeringService
from repro_torch.core.faults import Fault, RingJobTelemetry
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.parallel import tensor
from repro_torch.parallel.compression import ErrorFeedback
from repro_torch.train.hooks import StepMonitor
from repro_torch.train.steps import (gather, init_train_state, jax_leaves, make_train_step,
                                     shard_train_state)

log = logging.getLogger("repro_torch.trainer")


class SimulatedFault(RuntimeError):
    def __init__(self, fault: Fault, step: int):
        super().__init__(f"injected {fault.kind} at step {step}")
        self.fault = fault
        self.step = step


@dataclass
class FaultInjector:
    """Schedule telemetry-level faults at given steps (tests/examples)."""
    schedule: Dict[int, Fault] = field(default_factory=dict)

    def check(self, step: int) -> Optional[Fault]:
        return self.schedule.get(step)


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
    ``run.train.seed``; ``device=None`` means ``cuda``. The default C4D
    master runs its detection on the same device.

    With int8 compression the optimizer state starts with ``ef`` as zeros,
    where the JAX Trainer adds it at the first step: its step-0 checkpoint
    then lacks ``opt/ef`` and a restore to it after an int8 step raises
    ``KeyError``; here the restore completes, with the same numbers, since
    the residual starts at zero either way.

    ``mesh``: a ``DeviceMesh`` (``launch.mesh.make_local_mesh``) over the
    process group on ``device``'s type; ``params`` and ``opt_state`` are
    then the sharded step's DTensors (``full_params`` gathers them). Every
    rank runs the same seeded control plane and reaches the same actions."""

    def __init__(self, run: RunConfig, shape: ShapeSpec, workdir: str, device=None,
                 mesh=None,
                 sim_nodes: int = 4, use_kernel: bool = True,
                 checkpoint_async: bool = True,
                 cluster: Optional[SimCluster] = None,
                 steering: Optional[SteeringService] = None,
                 c4d: Optional[C4DMaster] = None,
                 telemetry: Optional[RingJobTelemetry] = None):
        self.run = run
        self.shape = shape
        self.device = resolve_device(device)
        self.opt_cfg = adamw.OptimizerConfig(kind=run.parallel.optimizer_state,
                                             weight_decay=run.train.weight_decay)
        generator = torch.Generator(self.device).manual_seed(run.train.seed)
        int8 = run.parallel.grad_compression == "int8"
        self.mesh = mesh
        writes = True
        if mesh is None:
            self.model = build_model(run, device=self.device, use_kernel=use_kernel)
            self.model.init_weights(generator)
            self.params = dict(self.model.named_parameters())
            self.opt_state = adamw.init_state(self.opt_cfg, self.params, jax_leaves(self.model))
            if int8:
                self.opt_state["ef"] = ErrorFeedback.init(self.params)
        else:
            import torch.distributed as dist
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for a {self.device.type} Trainer")
            # the model on this rank's shards, drawn a block at a time
            self.model = build_model(run, device="meta", use_kernel=use_kernel)
            tensor.build_sharded(self.model, mesh, generator)
            self.placements = tensor.placements(self.model, mesh)
            self.params, self.opt_state = init_train_state(self.model, self.opt_cfg, mesh, int8)
            writes = dist.get_rank() == 0
        self.ckpt = CheckpointManager(workdir, keep=run.train.keep_checkpoints,
                                      async_disk=checkpoint_async, disk=writes)
        self.pipeline = TokenPipeline(run.model, shape, PipelineConfig(seed=run.train.seed))
        self.monitor = StepMonitor()
        # simulated production cluster + C4D control plane; each piece can be
        # injected by an outer composition layer (the live driver shares one
        # cluster and telemetry stream across the drill)
        self.cluster = cluster or SimCluster(n_active=sim_nodes,
                                             n_backup=max(1, sim_nodes // 4))
        self.steering = steering or SteeringService(self.cluster)
        self.telemetry = telemetry or RingJobTelemetry(n_ranks=sim_nodes * 8,
                                                       seed=run.train.seed)
        self.c4d = c4d or C4DMaster(n_ranks=self.telemetry.n, ranks_per_node=8,
                                    device=self.device)
        self.report = TrainerReport()
        self._step_fn = self._make_step()
        self.step = 0

    def _make_step(self):
        if self.mesh is None:
            return make_train_step(self.model, self.run, self.opt_cfg)
        return make_train_step(self.model, self.run, self.opt_cfg, self.mesh)

    # ------------------------------------------------------------------
    def _tree(self):
        return {"params": self.params, "opt": self.opt_state, "step": np.asarray(self.step)}

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The parameters as full tensors (on a mesh, a collective)."""
        return gather(self.params)

    def _save_checkpoint(self, blocking: bool = False):
        self.ckpt.save(self.step, gather(self._tree()), blocking=blocking)

    @torch.no_grad()
    def restore(self, step: Optional[int] = None) -> int:
        """Load the newest valid checkpoint (or ``step``'s) into the model and
        the optimizer state; the next step trained is the restored one."""
        s, tree = self.ckpt.restore(self._tree(), step)
        if self.mesh is None:
            for name, p in self.params.items():
                p.copy_(tree["params"][name])
            self.opt_state = _to_device(tree["opt"], self.device)
        else:
            self.params, self.opt_state = shard_train_state(
                _to_device(tree["params"], self.device), _to_device(tree["opt"], self.device),
                self.opt_cfg, self.mesh, self.placements)
        self.step = int(tree["step"])
        log.info("restored step %d", s)
        return s

    # ------------------------------------------------------------------
    def _handle_fault(self, fault: Fault, at_step: int):
        """The C4D pipeline: telemetry -> verdict -> isolate -> restore."""
        t0 = time.perf_counter()
        actions = []
        windows = 0
        while not actions and windows < 4:
            win = self.telemetry.window(window_id=windows, faults=[fault])
            actions = self.c4d.ingest(win)
            windows += 1
        detection_s = windows * self.c4d.window_period_s
        replaced = []
        for a in actions:
            repl, _ = self.steering.execute(a.node_id, t=at_step,
                                            reason=a.verdicts[0].syndrome)
            replaced.append((a.node_id, repl))
        # elastic restart over the (same-sized) healthy host set: on real
        # hardware the device list changes and the step is rebuilt over it
        self._build_after_restart()
        restored = self.restore()
        self.report.restarts += 1
        self.report.detections.append({
            "fault": fault.kind, "at_step": at_step,
            "verdicts": [v.syndrome for a in actions for v in a.verdicts],
            "isolated": replaced, "detection_windows": windows,
            "detection_s_model": detection_s,
            "restored_step": restored,
            "wall_s": time.perf_counter() - t0,
        })
        self.report.downtime_steps += max(at_step - restored, 0)
        log.warning("fault %s handled: restored step %d, swapped %s",
                    fault.kind, restored, replaced)

    def _build_after_restart(self):
        if self.mesh is not None:
            from repro_torch.launch.mesh import rebuild
            self.mesh = rebuild(self.mesh)
        self._step_fn = self._make_step()

    # ------------------------------------------------------------------
    def train(self, n_steps: int,
              injector: Optional[FaultInjector] = None) -> TrainerReport:
        run = self.run
        self._save_checkpoint(blocking=True)  # step-0 baseline
        target = self.step + n_steps
        while self.step < target:
            fault = injector.check(self.step) if injector else None
            if fault is not None:
                # remove from schedule so the retried step does not re-fault
                injector.schedule.pop(self.step, None)
                self._handle_fault(fault, self.step)
                continue
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
