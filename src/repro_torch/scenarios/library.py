"""The shipped scenario library — ≥8 end-to-end fault drills.

Each entry reproduces (or stresses beyond) a concrete paper artefact; the
mapping is documented per scenario and in docs/scenarios.md.  Scenarios are
plain ``ScenarioSpec`` values: copy one and edit the event script to author
your own (worked example in docs/scenarios.md).
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.scenarios.spec import (Assertions, FailLink, InjectFault, JobSpec,
                                  RestoreLink, ScenarioSpec, StartJob,
                                  StopJob, two_host_jobs)

MIN = 60.0
_REGISTRY: Dict[str, Callable[[int], ScenarioSpec]] = {}


def register(fn: Callable[[int], ScenarioSpec]) -> Callable[[int], ScenarioSpec]:
    spec = fn(0)
    _REGISTRY[spec.name] = fn
    return fn


def names() -> List[str]:
    return sorted(_REGISTRY)


def get(name: str, seed: int = 0) -> ScenarioSpec:
    try:
        return _REGISTRY[name](seed)
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; choose from {names()}")


# ---------------------------------------------------------------------------
# node-fault family (Table 1 / Table 3)
# ---------------------------------------------------------------------------

@register
def single_nic_down(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="single_nic_down",
        description="One node's NIC dies mid-run (ECC/NVLink-class crash): "
                    "hang detected in one window, node isolated, backup "
                    "swapped, restart from the last 10-min checkpoint.",
        paper_ref="Table 1 (ecc_nvlink), Table 3 phases, Fig. 1",
        seed=seed, duration_s=2 * 3600.0,
        jobs=(JobSpec(0, tuple(range(16))),),
        events=(InjectFault(t=43 * MIN, job_id=0, error_class="ecc_nvlink"),),
        assertions=Assertions(max_detection_s=60.0, min_localization=1.0,
                              min_restarts=1, min_goodput_frac=0.55),
    )


@register
def silent_pcie_degradation(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="silent_pcie_degradation",
        description="A PCIe link silently degrades (ack_timeout-class "
                    "comm-slow, no crash): the delay-matrix row analysis "
                    "needs the confirmation streak before isolating.",
        paper_ref="§3.1 Case 1, Fig. 6 row outlier, Table 1 (ack_timeout)",
        seed=seed, duration_s=2 * 3600.0,
        jobs=(JobSpec(0, tuple(range(16))),),
        events=(InjectFault(t=33 * MIN, job_id=0, kind="slow_src",
                            rank=13, severity=9.0),),
        assertions=Assertions(max_detection_s=90.0, min_localization=1.0,
                              min_restarts=1),
    )


@register
def straggler_gpu(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="straggler_gpu",
        description="One GPU computes slowly (late into every collective): "
                    "receiver-wait analysis implicates the *sender's* "
                    "compute path while transfer bandwidth stays healthy.",
        paper_ref="§3.1 Case 2 (non-communication slow)",
        seed=seed, duration_s=2 * 3600.0,
        jobs=(JobSpec(0, tuple(range(16))),),
        events=(InjectFault(t=52 * MIN, job_id=0, kind="straggler",
                            rank=21, severity=25.0),),
        assertions=Assertions(max_detection_s=90.0, min_localization=1.0,
                              min_restarts=1),
    )


@register
def nccl_timeout_storm(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="nccl_timeout_storm",
        description="Three communication hangs in quick succession on "
                    "different nodes (an unstable rail): every one must be "
                    "detected immediately (hangs pre-empt the confirmation "
                    "streak) and the backup pool must absorb all swaps.",
        paper_ref="Table 1 (nccl_timeout 20 % of errors), §3.1 hang detection",
        seed=seed, duration_s=4 * 3600.0,
        n_nodes=32,                 # backup pool of 4: every swap must land
        jobs=(JobSpec(0, tuple(range(16))),),
        events=(InjectFault(t=37 * MIN, job_id=0, kind="comm_hang", rank=3),
                InjectFault(t=95 * MIN, job_id=0, kind="comm_hang", rank=11),
                InjectFault(t=160 * MIN, job_id=0, kind="comm_hang", rank=27)),
        assertions=Assertions(max_detection_s=60.0, min_localization=1.0,
                              min_restarts=3),
    )


@register
def fault_during_restart(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="fault_during_restart",
        description="A second fault lands while the first restart is still "
                    "in flight (cascading failure): it manifests the moment "
                    "the job resumes and triggers a second full cycle.",
        paper_ref="§2 motivation (cascading failures), Table 3 phases",
        seed=seed, duration_s=3 * 3600.0,
        jobs=(JobSpec(0, tuple(range(16))),),
        events=(InjectFault(t=63 * MIN, job_id=0, error_class="cuda_error"),
                # ~2 min later: first drill is still inside diagnosis
                InjectFault(t=65 * MIN, job_id=0, kind="comm_hang", rank=30)),
        assertions=Assertions(min_restarts=2, min_localization=1.0),
    )


# ---------------------------------------------------------------------------
# divergence family (Flare-style train-signal anomalies) + attribution
# ---------------------------------------------------------------------------

@register
def silent_data_corruption(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="silent_data_corruption",
        description="One rank silently corrupts its gradients (SDC): no "
                    "comm syndrome at all — only the divergence channel's "
                    "grad-norm analysis can see it.  The train-signal "
                    "detector must localise the rank and trigger the full "
                    "isolation cycle.",
        paper_ref="Flare (arXiv 2502.05413) divergence detection; "
                  "ROADMAP new-telemetry-channel item",
        seed=seed, duration_s=2 * 3600.0,
        divergence=True,
        jobs=(JobSpec(0, tuple(range(16))),),
        events=(InjectFault(t=40 * MIN, job_id=0, kind="sdc",
                            rank=9, severity=5.0),),
        assertions=Assertions(max_detection_s=90.0, min_localization=1.0,
                              min_restarts=1),
    )


@register
def loss_spike_cascade(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="loss_spike_cascade",
        description="A loss-spiking rank followed by a NaN-producing rank "
                    "an hour later: the loss spike waits out the "
                    "confirmation streak, the overflow acts immediately "
                    "(hang-like) — both full isolation cycles, zero comm "
                    "telemetry involved.",
        paper_ref="Flare (arXiv 2502.05413); overflow = immediate action",
        seed=seed, duration_s=3 * 3600.0,
        divergence=True,
        jobs=(JobSpec(0, tuple(range(16))),),
        events=(InjectFault(t=30 * MIN, job_id=0, kind="loss_spike",
                            rank=14, severity=12.0),
                InjectFault(t=90 * MIN, job_id=0, kind="nan_rank",
                            rank=26, severity=2.0)),
        assertions=Assertions(max_detection_s=90.0, min_localization=1.0,
                              min_restarts=2),
    )


@register
def degraded_pcie_attribution(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="degraded_pcie_attribution",
        description="The silent-PCIe drill rerun with root-cause "
                    "attribution on, plus a genuine bad cable later: the "
                    "dependency cover must name the culprit rank (not just "
                    "its ring) for the host fault and the exact link for "
                    "the cable, so isolation lands on the culprit host.",
        paper_ref="Mycroft (arXiv 2509.03018) dependency attribution; "
                  "§3.1 Case 1",
        seed=seed, duration_s=3 * 3600.0,
        attribution=True,
        jobs=(JobSpec(0, tuple(range(16))),),
        events=(InjectFault(t=33 * MIN, job_id=0, kind="slow_src",
                            rank=13, severity=9.0),
                InjectFault(t=100 * MIN, job_id=0, kind="slow_link",
                            rank=5, severity=10.0)),
        assertions=Assertions(min_localization=1.0, min_restarts=2,
                              min_attribution=1.0),
    )


# ---------------------------------------------------------------------------
# fabric family (Figs. 9/11/12)
# ---------------------------------------------------------------------------

@register
def cascading_spine_flaps(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="cascading_spine_flaps",
        description="Three leaf-spine links flap in sequence mid-run; C4P "
                    "dynamic LB re-routes around each, the netsim->telemetry "
                    "bridge lets C4D observe the degradation, and confirmed "
                    "links are blacklisted for re-planning.",
        paper_ref="Fig. 11/12 (link failure tolerance), §3.2 blacklist",
        seed=seed, duration_s=2 * 3600.0, qps_per_port=2,
        jobs=two_host_jobs(8),
        events=(FailLink(t=20 * MIN, link=("ls", 0, 0)),
                FailLink(t=45 * MIN, link=("ls", 2, 1)),
                RestoreLink(t=70 * MIN, link=("ls", 0, 0)),
                FailLink(t=80 * MIN, link=("sl", 3, 4))),
        assertions=Assertions(min_goodput_frac=0.85),
    )


@register
def multijob_contention(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="multijob_contention",
        description="A 2-server job shares the spines with 7 tenants that "
                    "arrive and leave; run on both fabrics (with/without "
                    "C4P) to quantify what load-aware path allocation buys "
                    "under contention.",
        paper_ref="Fig. 9 (multi-tenant traffic engineering)",
        seed=seed, duration_s=2 * 3600.0, qps_per_port=1,
        compare_fabrics=True,
        jobs=(JobSpec(0, (0, 8)),),
        events=tuple(
            [StartJob(t=10 * MIN + j * 5 * MIN, job_id=j, hosts=(j, 8 + j))
             for j in range(1, 8)]
            + [StopJob(t=100 * MIN, job_id=j) for j in range(1, 8)]),
        assertions=Assertions(c4p_ge_ecmp=True, min_goodput_frac=0.7),
    )


@register
def ecmp_vs_c4p_ab(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="ecmp_vs_c4p_ab",
        description="Full A/B on a contended 2:1-oversubscribed fabric: 8 "
                    "concurrent jobs, a spine link failure mid-run, one "
                    "node fault — identical event script on ECMP and C4P "
                    "fabrics; C4P must deliver >= ECMP goodput.",
        paper_ref="Fig. 9 (+65.5 % at 2:1), Fig. 11, Table 3",
        seed=seed, duration_s=3 * 3600.0,
        oversubscription=2.0, qps_per_port=2, compare_fabrics=True,
        jobs=two_host_jobs(8),
        events=(FailLink(t=30 * MIN, link=("ls", 0, 2)),
                InjectFault(t=90 * MIN, job_id=0, error_class="nccl_timeout")),
        assertions=Assertions(c4p_ge_ecmp=True),
    )
