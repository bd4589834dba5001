"""The port's RUN -> DETECT -> ISOLATE -> RESTORE loop and its live driver.

``repro_torch.train.trainer.Trainer`` with a ``FaultInjector``, on the CPU
(``device="cpu"``: the detection kernels' plain versions, reached through
the wrappers that launch the CUDA kernels on the card), at the smollm-135m
and gemma2-2b smoke configs. The JAX Trainer does not import on this jax
(``jax_compat``), so the detection half is held to a replay of its
``_handle_fault`` loop through the JAX package's NumPy ``C4DMaster``,
``SimCluster`` and ``SteeringService`` over its own ``RingJobTelemetry`` with
the Trainer's seed: verdicts, isolated/backup nodes and detection windows
must be equal. The restore half is exact: after a fault and its replay,
losses and every parameter are bit-equal to a fault-free run's
(``torch.equal``), and the step-0 in-memory replica is still bit-equal to
its file on disk. On the card (``-m gpu``) the same loop launches the CUDA
kernels.
"""
import dataclasses
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.c4d.master import C4DMaster as RefC4DMaster
from repro.core.cluster import SimCluster as RefSimCluster
from repro.core.cluster import SteeringService as RefSteeringService
from repro.core.faults import Fault as RefFault
from repro.core.faults import RingJobTelemetry as RefRingJobTelemetry
from repro.scenarios import library as ref_library
from repro.scenarios import live as ref_live
from repro_torch.checkpoint.manager import CheckpointManager, _leaves
from repro_torch.common.config import ShapeSpec
from repro_torch.configs import get_smoke_config
from repro_torch.core.faults import Fault
from repro_torch.core.torchsim import BACKEND_ENV, detectors
from repro_torch.kernels import ops, slow_fold, window_score
from repro_torch.launch import train as train_cli
from repro_torch.scenarios import library, live, run
from repro_torch.train.trainer import FaultInjector, Trainer

KINDS = ["crash", "slow_src", "slow_dst", "comm_hang", "noncomm_hang", "straggler", "sdc"]
ARCHS = ["smollm-135m", "gemma2-2b"]


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Calls of each detection kernel's wrapper, by the device of its input."""
    calls = Counter()

    def counted(mod, entry, name):
        real = getattr(mod, entry)

        def wrapper(*args, **kw):
            calls[(name, args[0].device.type)] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, entry, wrapper)

    counted(window_score, "window_score", "window_score")
    counted(window_score, "row_select", "row_select")
    counted(slow_fold, "slow_fold", "slow_fold")
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    return calls


def _trainer(arch, workdir, device="cpu", **kw):
    run_cfg = get_smoke_config(arch)
    shape = ShapeSpec("t", run_cfg.train.seq_len, run_cfg.train.global_batch, "train")
    return Trainer(run_cfg, shape, workdir=str(workdir), device=device,
                   checkpoint_async=False, **kw)


def _reference_handle(kind, rank, seed, at_step, sim_nodes=4):
    """The JAX Trainer's ``_handle_fault`` detection and isolation, through
    the JAX package's NumPy control plane. Returns the detection record's
    verdicts, isolated pairs and windows, and the active nodes after it."""
    cluster = RefSimCluster(n_active=sim_nodes, n_backup=max(1, sim_nodes // 4))
    steering = RefSteeringService(cluster)
    telemetry = RefRingJobTelemetry(n_ranks=sim_nodes * 8, seed=seed)
    c4d = RefC4DMaster(n_ranks=telemetry.n, ranks_per_node=8)
    fault = RefFault(kind, rank=rank)
    actions, windows = [], 0
    while not actions and windows < 4:
        actions = c4d.ingest(telemetry.window(window_id=windows, faults=[fault]))
        windows += 1
    replaced = [(a.node_id, steering.execute(a.node_id, t=at_step,
                                             reason=a.verdicts[0].syndrome)[0])
                for a in actions]
    return ([v.syndrome for a in actions for v in a.verdicts], replaced, windows,
            cluster.active_nodes)


# --- the fault loop ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_fault_detect_isolate_restore(arch, tmp_path, wrapper_calls):
    tr = _trainer(arch, tmp_path, sim_nodes=4)
    rep = tr.train(14, injector=FaultInjector({7: Fault("crash", rank=9)}))
    assert rep.restarts == 1
    det = rep.detections[0]
    assert det["fault"] == "crash"
    assert det["isolated"], "backup swap must have happened"
    out_node, in_node = det["isolated"][0]
    assert out_node == 9 // 8                # the faulty rank's node
    assert det["restored_step"] <= 7
    assert rep.steps_run == 14 - det["restored_step"] + 7
    assert rep.downtime_steps == 7 - det["restored_step"]
    assert set(det) == {"fault", "at_step", "verdicts", "isolated", "detection_windows",
                        "detection_s_model", "restored_step", "wall_s"}
    # the isolated node left the active set; a backup joined
    assert out_node not in tr.cluster.active_nodes
    assert in_node in tr.cluster.active_nodes
    # the handler's master ran the torch backend on the Trainer's device
    assert {dev for _, dev in wrapper_calls} == {"cpu"}
    assert wrapper_calls[("window_score", "cpu")] == det["detection_windows"]


@pytest.mark.parametrize("arch", ARCHS)
def test_restarted_run_is_deterministic(arch, tmp_path):
    """Final params after a mid-run fault + restore equal a fault-free run's
    (checkpoint restore + seed-addressable data => exact replay), and the
    replayed steps repeat the first pass's losses."""
    tr1 = _trainer(arch, tmp_path / "a")
    clean = tr1.train(12)
    tr2 = _trainer(arch, tmp_path / "b")
    rep2 = tr2.train(12, injector=FaultInjector({6: Fault("slow_src", rank=3)}))
    assert rep2.restarts == 1
    restored = rep2.detections[0]["restored_step"]
    assert rep2.losses[:6] == clean.losses[:6]
    assert rep2.losses[6:] == clean.losses[restored:]
    assert set(tr1.params) == set(tr2.params)
    for name, p in tr1.params.items():
        assert torch.equal(p, tr2.params[name]), name
    opt1, opt2 = dict(_leaves(tr1.opt_state)), dict(_leaves(tr2.opt_state))
    assert set(opt1) == set(opt2)
    for name, t in opt1.items():
        assert torch.equal(t, opt2[name]), name


@pytest.mark.parametrize("kind", KINDS)
def test_detection_equals_the_reference_replay(kind, tmp_path, wrapper_calls):
    tr = _trainer("smollm-135m", tmp_path)
    rep = tr.train(3, injector=FaultInjector({1: Fault(kind, rank=9)}))
    verdicts, replaced, windows, active = _reference_handle(
        kind, 9, tr.run.train.seed, at_step=1)
    det = rep.detections[0]
    assert (det["verdicts"], det["isolated"], det["detection_windows"]) == \
        (verdicts, replaced, windows)
    assert det["detection_s_model"] == windows * 30.0
    assert tr.cluster.active_nodes == active
    assert rep.restarts == 1 and rep.steps_run == 3 + 1
    # each window of the handler went through the kernels' wrappers on the
    # CPU: the handler ingests object windows, whose prefilter is the agents'
    # NumPy fold, so no row select; the z fold in every window without a hang
    hang = kind in ("crash", "comm_hang", "noncomm_hang")
    assert {dev for _, dev in wrapper_calls} == {"cpu"}
    assert wrapper_calls[("window_score", "cpu")] == windows
    assert wrapper_calls[("slow_fold", "cpu")] == (0 if hang else windows)
    assert wrapper_calls[("row_select", "cpu")] == 0


def test_in_memory_replica_survives_the_restore_and_the_replay(tmp_path):
    """``restore`` copies the replica into the live tensors: no later AdamW
    step may write into it. After a fault, its replay and more steps, the
    step-0 replica is still bit-equal to the step-0 file on disk."""
    tr = _trainer("gemma2-2b", tmp_path)
    initial = {n: p.detach().clone() for n, p in tr.params.items()}
    rep = tr.train(6, injector=FaultInjector({3: Fault("crash", rank=9)}))
    assert rep.restarts == 1 and rep.detections[0]["restored_step"] == 0
    assert 0 in tr.ckpt.memory
    disk = CheckpointManager(str(tmp_path), async_disk=False)._validate(0)
    assert disk is not None and set(disk) == set(tr.ckpt.memory[0])
    for k, t in disk.items():
        assert torch.equal(t, tr.ckpt.memory[0][k]), k
    for n, p in initial.items():
        assert torch.equal(tr.ckpt.memory[0][f"params/{n}"], p), n


def test_cpu_trainer_with_a_fault_needs_no_card(tmp_path, monkeypatch, wrapper_calls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = _trainer("smollm-135m", tmp_path)
    assert str(tr.c4d.device) == "cpu"
    rep = tr.train(3, injector=FaultInjector({1: Fault("crash", rank=9)}))
    assert rep.restarts == 1 and rep.detections[0]["verdicts"] == ["comm_hang"]
    assert {dev for _, dev in wrapper_calls} == {"cpu"}
    assert wrapper_calls[("window_score", "cpu")] == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _trainer("smollm-135m", tmp_path / "card", device=None)


def test_train_cli_injects_a_fault(tmp_path, capsys):
    train_cli.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "4",
                    "--inject-fault", "crash:2", "--workdir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert out["restarts"] == 1 and len(out["detections"]) == 1
    det = out["detections"][0]
    assert det["fault"] == "crash" and det["at_step"] == 2 and det["restored_step"] == 0
    assert det["isolated"] == [[0, 4]]           # rank 3 is on node 0; backup 4
    assert out["steps_run"] == 4 + 2


# --- the live driver ----------------------------------------------------------------

@pytest.mark.parametrize("name", ref_library.names())
def test_live_fault_schedule_equals_the_reference(name):
    for n_steps in (12, 20):
        got = live.fault_schedule(library.get(name), n_steps)
        want = ref_live.fault_schedule(ref_library.get(name), n_steps)
        assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
            {k: dataclasses.astuple(v) for k, v in want.items()}


def test_live_drive_single_nic_down(tmp_path, wrapper_calls):
    """The scripted drill replays on the real Trainer: real steps, real
    checkpoint restore, isolation on the shared SimCluster."""
    spec = library.get("single_nic_down")
    rep = live.drive(spec, workdir=str(tmp_path), n_steps=12, sim_nodes=4, device="cpu")
    assert rep["restarts"] == 1
    assert rep["steps_run"] >= 12
    det = rep["detections"][0]
    assert det["fault"] == "crash"
    assert det["isolated"], "backup swap must have happened"
    assert rep["isolated_nodes"], "shared cluster must show the isolation"
    assert rep["final_loss"] is not None
    assert rep["scheduled_faults"] == {
        str(k): v.kind for k, v in ref_live.fault_schedule(ref_library.get(
            "single_nic_down"), 12).items()}
    assert {dev for _, dev in wrapper_calls} == {"cpu"}
    assert wrapper_calls[("window_score", "cpu")] == det["detection_windows"]


def test_run_cli_live_replays_on_the_trainer(tmp_path, capsys):
    out = tmp_path / "rep.json"
    assert run.main(["--scenario", "single_nic_down", "--live", "--live-steps", "8",
                     "--device", "cpu", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["live"]["mode"] == "live_trainer" and rep["live"]["n_steps"] == 8
    assert rep["live"]["restarts"] == 1 and rep["live"]["isolated_nodes"]
    assert "scenario      : single_nic_down" in capsys.readouterr().out


# --- on the card ----------------------------------------------------------------------

@pytest.mark.gpu
def test_trainer_fault_loop_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    tr1 = _trainer("gemma2-2b", tmp_path / "a", device=None)
    clean = tr1.train(6)
    tr2 = _trainer("gemma2-2b", tmp_path / "b", device=None)
    detectors.reset_launch_counts()
    ops.reset_launch_counts()
    rep = tr2.train(6, injector=FaultInjector({3: Fault("crash", rank=9)}))
    launches = detectors.launch_counts()
    verdicts, replaced, windows, _ = _reference_handle("crash", 9, tr2.run.train.seed, 3)
    det = rep.detections[0]
    assert (det["verdicts"], det["isolated"], det["detection_windows"]) == \
        (verdicts, replaced, windows)
    assert launches["window_score"] == windows and launches["slow_fold"] == 0
    assert ops.launch_counts()["rmsnorm"] > 0
    assert rep.losses[:3] + rep.losses[6:] == clean.losses
    for name, p in tr1.params.items():
        assert torch.equal(p, tr2.params[name]), name
