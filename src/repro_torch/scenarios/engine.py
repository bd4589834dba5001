"""Campaign engine: a thin composition root over the runtime kernel.

One ``CampaignEngine`` run interprets a ``ScenarioSpec`` by registering the
scenario services (``repro_torch.scenarios.services``) on a deterministic
``repro_torch.runtime.EventBus`` sharing one virtual clock:

  * ``DowntimeService`` — goodput integral + Table-3 phase accounting;
  * ``FabricService`` — live fabric (C4P/ECMP) with probe-driven re-planning;
  * ``C4DService`` — per-fault reference detection *and* the always-on
    streaming detector (measured latency, fault-free false-positive rate).

The root only parses the spec, admits the initial jobs, schedules the
event script, runs the bus, and assembles the services' report fragments —
all behaviour lives in the services (docs/runtime.md, docs/scenarios.md).

Copy of ``repro.scenarios.engine`` for the port.  ``device`` is where the
torch backend runs (``None``: the card, raising without one; ``"cpu"``: the
kernels' plain versions); it is resolved only where a detector actually
takes the torch backend, so ``backend="numpy"`` needs no device.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.torchsim import use_backend
from repro_torch.runtime import EventBus, Service
from repro_torch.scenarios.services import (C4DService, DowntimeService,
                                      FabricService, JobAdmitted, RunContext)
from repro_torch.scenarios.spec import Event, ScenarioSpec, evaluate_assertions


def build_services(ctx: RunContext) -> List[Service]:
    """The standard service set (delivery order is by priority, so callers
    may register these in any order without changing the run)."""
    return [DowntimeService(ctx), FabricService(ctx), C4DService(ctx)]


class CampaignEngine:
    """Interprets one ``ScenarioSpec`` (optionally overriding the fabric
    mode, for A/B variants) and produces the JSON-ready report dict."""

    def __init__(self, spec: ScenarioSpec, fabric_mode: Optional[str] = None,
                 service_factory: Optional[
                     Callable[[RunContext], List[Service]]] = None,
                 device=None):
        self.spec = spec
        self.mode = fabric_mode or spec.fabric
        self.kernel = EventBus(seed=spec.seed)
        self.ctx = RunContext(spec, self.mode, self.kernel.rng, device=device)
        for svc in (service_factory or build_services)(self.ctx):
            self.kernel.register(svc)

    def run(self) -> dict:
        """The run, under ``use_backend(spec.backend)``, so that every
        component that resolves the default — grouped medians, the detector,
        the water-filling deep inside C4P — takes the spec's backend."""
        spec, kernel = self.spec, self.kernel
        with use_backend(spec.backend):
            kernel.start(spec.duration_s)
            for js in spec.jobs:
                kernel.publish(JobAdmitted(js))
            for ev in spec.sorted_events():
                kernel.schedule(ev.t, ev)
            kernel.drain()
            kernel.stop()
            return self._report()

    # ------------------------------------------------------------------
    def _timeline(self) -> List[dict]:
        return [{"t": t, "type": type(ev).__name__,
                 **{k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in ev.__dict__.items() if k != "t"}}
                for t, kind, ev in self.kernel.trace
                if kind == "event" and isinstance(ev, Event)]

    def _report(self) -> dict:
        spec = self.spec
        down: DowntimeService = self.kernel.service("downtime")
        c4d: C4DService = self.kernel.service("c4d")
        acct = down.accounting_report()
        faults = down.fault_records
        lat = [f["detection_s"] for f in faults]
        hits = sum(1 for f in faults if f["localized"])
        att_attempts = sum(1 for f in faults
                           if f.get("culprit_hit") is not None)
        att_hits = sum(1 for f in faults if f.get("culprit_hit"))
        return {
            "scenario": spec.name,
            "description": spec.description,
            "paper_ref": spec.paper_ref,
            "fabric": self.mode,
            "seed": spec.seed,
            "duration_s": spec.duration_s,
            "restarts": down.restarts,
            "detection": {
                "n_faults": len(faults),
                "latencies_s": lat,
                "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
                "localization_hits": hits,
                "localization_accuracy":
                    hits / len(faults) if faults else 1.0,
                # root-cause attribution (0/0 unless spec.attribution)
                "attribution_attempts": att_attempts,
                "attribution_hits": att_hits,
                "faults": faults,
            },
            "network": c4d.network_report(),
            "streaming": c4d.streaming_report(),
            "downtime": acct["downtime"],
            "goodput": acct["goodput"],
            "timeline": self._timeline(),
        }


def run_scenario(spec: ScenarioSpec, device=None) -> dict:
    """Run one spec; with ``compare_fabrics`` the same drill runs on both
    fabrics (identical seed/events) and the primary report carries a
    ``variants`` section plus the A/B goodput comparison.

    ``spec.backend`` scopes the kernel backend for each arm's run
    (``CampaignEngine.run``). ``device`` is where the torch backend runs."""
    if spec.compare_fabrics:
        variants = {mode: CampaignEngine(spec, fabric_mode=mode,
                                         device=device).run()
                    for mode in ("c4p", "ecmp")}
        report = dict(variants[spec.fabric if spec.fabric in variants else "c4p"])
        c4p = variants["c4p"]["goodput"]
        ecmp = variants["ecmp"]["goodput"]
        report["variants"] = {
            m: {k: v[k] for k in ("fabric", "goodput", "downtime",
                                  "detection", "restarts")}
            for m, v in variants.items()}
        report["ab"] = {
            "c4p_effective_gbps": c4p["effective_gbps"],
            "ecmp_effective_gbps": ecmp["effective_gbps"],
            "gain_pct": 100.0 * (c4p["effective_gbps"]
                                 / max(ecmp["effective_gbps"], 1e-9) - 1.0),
        }
        checks = evaluate_assertions(spec.assertions, report,
                                     variants=report["variants"])
    else:
        report = CampaignEngine(spec, device=device).run()
        checks = evaluate_assertions(spec.assertions, report)
    report["checks"] = checks
    report["passed"] = all(c["ok"] for c in checks)
    return report
