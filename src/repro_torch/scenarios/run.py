"""Scenario + campaign CLI.

Single-trial drills (one hand-scripted ``ScenarioSpec``):

    PYTHONPATH=src python -m repro_torch.scenarios.run --list
    PYTHONPATH=src python -m repro_torch.scenarios.run --scenario single_nic_down
    PYTHONPATH=src python -m repro_torch.scenarios.run --all --json reports/
    PYTHONPATH=src python -m repro_torch.scenarios.run --scenario ecmp_vs_c4p_ab --json -

Monte Carlo campaigns (randomized trial populations, docs/campaigns.md):

    PYTHONPATH=src python -m repro_torch.scenarios.run --campaign fleet_smoke
    PYTHONPATH=src python -m repro_torch.scenarios.run --campaign fleet_1024 \
        --trials 64 --gpus 1024 --workers 4 --json reports/ --md reports/

Continuous fleets (live multi-tenant simulation, docs/fleet.md):

    PYTHONPATH=src python -m repro_torch.scenarios.run --fleet fleet_hour
    PYTHONPATH=src python -m repro_torch.scenarios.run --fleet fleet_day \
        --json reports/ --md reports/

ROC sweeps (paired operating-point grids, docs/detection.md "Precision"):

    PYTHONPATH=src python -m repro_torch.scenarios.run --sweep roc_smoke
    PYTHONPATH=src python -m repro_torch.scenarios.run --sweep detector_stress_roc \
        --json reports/ --md reports/
    PYTHONPATH=src python -m repro_torch.scenarios.run --campaign fleet_smoke \
        --operating-point "mad=6,streak=3,hl=16"

``--sweep`` exits non-zero when the selected point misses its targets
(FP <= fp_target at reference clean recall within the latency budget);
``--operating-point`` applies a parsed ``OperatingPoint`` to every
scenario and campaign in the same invocation, so a sweep winner can be
cross-checked on the drill library and the full fleet engine.

Copy of ``repro.scenarios.run`` for the port, with ``--device``: the
detection windows of drills, campaigns, sweeps and fleets run on the torch
backend (the port's default) on the card unless ``--device cpu`` (the
kernels' plain versions) or ``--backend numpy`` is given; ``--live`` trains
on the same device.

Per-scenario reports carry detection latency, localisation verdicts, the
Table-3 downtime phase breakdown, and effective goodput; campaign reports
carry the fleet aggregates (detection precision/recall, MTTR percentiles,
goodput/efficiency CIs bracketing the paper's claims).  ``--json`` writes
the machine-readable report (a file per scenario/campaign when given a
directory, stdout with ``-``); ``--md`` additionally renders the campaign
markdown.  ``--seed`` flows through spec factories *and* the campaign
samplers, and is surfaced in every JSON report, so one flag fully
determines the output.  Exit status is non-zero when any scenario's spec
assertions fail (CI uses this as the scenario-smoke gate).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List

from repro_torch.core.torchsim import use_backend
from repro_torch.scenarios import fleet, library, montecarlo, precision
from repro_torch.scenarios.engine import run_scenario


def _summary_lines(rep: dict) -> List[str]:
    det = rep["detection"]
    down = rep["downtime"]
    good = rep["goodput"]
    lines = [
        f"scenario      : {rep['scenario']}  [{rep['fabric']}]  seed={rep['seed']}",
        f"paper ref     : {rep['paper_ref']}",
        f"restarts      : {rep['restarts']}",
        f"detection     : {det['n_faults']} fault(s), "
        f"mean latency {det['mean_latency_s']:.0f} s, "
        f"localization {det['localization_hits']}/{det['n_faults']}",
    ]
    if det.get("attribution_attempts"):
        lines.append(
            f"attribution   : {det['attribution_hits']}/"
            f"{det['attribution_attempts']} culprit-set hits")
    lines += [
        "downtime      : total {:.0f} s ({:.2%} of run) = det {:.0f} + "
        "diag/iso {:.0f} + post-ckpt {:.0f} + reinit {:.0f}".format(
            down["total_s"], down["fraction_of_duration"],
            down["detection_s"], down["diagnosis_isolation_s"],
            down["post_checkpoint_s"], down["re_initialization_s"]),
        f"goodput       : {good['effective_gbps']:.1f} / "
        f"{good['ideal_gbps']:.1f} Gbps effective ({good['fraction']:.2%})",
    ]
    if rep["network"]["n_events"]:
        obs = sum(1 for d in rep["network"]["detections"] if d["observed"])
        lines.append(f"network       : {rep['network']['n_events']} fabric "
                     f"observation(s), {obs} seen by C4D")
    st = rep.get("streaming")
    if st and st["windows"]:
        fp = ("n/a" if st["fault_free_fp_rate"] is None
              else f"{st['fault_free_fp_rate']:.4f}")
        lines.append(
            f"streaming     : {st['windows']} windows @ {st['tick_s']:.0f} s, "
            f"{st['detected']}/{st['detected'] + st['missed']} faults seen "
            f"online, fault-free FP rate {fp}")
    if "ab" in rep:
        ab = rep["ab"]
        lines.append(f"A/B           : C4P {ab['c4p_effective_gbps']:.1f} vs "
                     f"ECMP {ab['ecmp_effective_gbps']:.1f} Gbps "
                     f"({ab['gain_pct']:+.1f} %)")
    for c in rep["checks"]:
        mark = "PASS" if c["ok"] else "FAIL"
        lines.append(f"assert {mark}   : {c['name']} "
                     f"(value={c['value']}, limit={c['limit']})")
    return lines


def _write_json(rep: dict, dest: str, stem: str) -> None:
    if dest == "-":
        json.dump(rep, sys.stdout, indent=1, default=str)
        sys.stdout.write("\n")
        return
    if dest.endswith(".json") and not os.path.isdir(dest):
        path = dest                  # explicit single-file destination
    else:
        # anything else is a directory: one report per scenario/campaign,
        # so multi-target runs never silently overwrite each other
        os.makedirs(dest, exist_ok=True)
        path = os.path.join(dest, f"{stem}.json")
    with open(path, "w") as f:
        json.dump(rep, f, indent=1, default=str)


def _write_text(text: str, dest: str, stem: str) -> None:
    if dest == "-":
        sys.stdout.write(text)
        return
    if dest.endswith(".md") and not os.path.isdir(dest):
        path = dest
    else:
        os.makedirs(dest, exist_ok=True)
        path = os.path.join(dest, f"{stem}.md")
    with open(path, "w") as f:
        f.write(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios.run",
        description="Run end-to-end C4 fault drills and Monte Carlo "
                    "campaigns on the port (docs/scenarios.md, "
                    "docs/campaigns.md).")
    ap.add_argument("--list", action="store_true",
                    help="list shipped scenarios + campaigns and exit")
    ap.add_argument("--scenario", action="append", default=[],
                    help="scenario name (repeatable)")
    ap.add_argument("--all", action="store_true", help="run every scenario")
    ap.add_argument("--campaign", action="append", default=[],
                    help="Monte Carlo campaign name (repeatable)")
    ap.add_argument("--sweep", action="append", default=[],
                    help="ROC operating-point sweep name (repeatable)")
    ap.add_argument("--fleet", action="append", default=[],
                    help="continuous fleet simulation name (repeatable; "
                         "docs/fleet.md)")
    ap.add_argument("--operating-point", default=None, metavar="SPEC",
                    help="apply a detection operating point to scenarios "
                         "and campaigns, e.g. 'mad=6,streak=3,hl=16' "
                         "(keys: mad, suspect, streak, hang, hl, warm)")
    ap.add_argument("--trials", type=int, default=None,
                    help="override the campaign's trial count")
    ap.add_argument("--gpus", type=int, default=None,
                    help="override the campaign's simulated GPUs per trial")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool width for campaign trials "
                         "(report is identical for any value)")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed threaded through spec factories and campaign "
                         "samplers (default: each target's own default)")
    ap.add_argument("--backend", default=None,
                    choices=["numpy", "torch", "auto"],
                    help="detection backend for scenarios, campaigns, "
                         "sweeps and fleets (default: REPRO_TORCH_SIM_BACKEND env var "
                         "or torch)")
    ap.add_argument("--device", default=None,
                    help="where the torch backend and --live run (default: "
                         "cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--attribution", action="store_true",
                    help="turn on root-cause attribution (Mycroft-style "
                         "dependency cover) for every scenario and "
                         "campaign in this invocation")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write report(s) as JSON: a *.json file, a "
                         "directory (one file per target), or '-' for "
                         "stdout")
    ap.add_argument("--md", default=None, metavar="PATH",
                    help="write campaign report(s) as markdown: a *.md "
                         "file, a directory, or '-' for stdout")
    ap.add_argument("--no-assert", action="store_true",
                    help="report assertion failures but exit 0")
    ap.add_argument("--live", action="store_true",
                    help="also replay the fault script on the real trainer "
                         "(see repro_torch.scenarios.live)")
    ap.add_argument("--live-steps", type=int, default=14,
                    help="trainer steps for --live replay")
    args = ap.parse_args(argv)

    if args.list:
        for name in library.names():
            spec = library.get(name)
            print(f"{name:28s} {spec.paper_ref}")
        for name in montecarlo.names():
            cam = montecarlo.get(name)
            print(f"{name:28s} [campaign: {cam.n_trials} trials x "
                  f"{cam.gpus} GPUs] {cam.paper_ref}")
        for name in precision.names():
            sw = precision.get(name)
            print(f"{name:28s} [sweep: {sw.n_trials} trials x "
                  f"{len(sw.grid())} points] {sw.paper_ref}")
        for name in fleet.names():
            fs = fleet.get(name)
            print(f"{name:28s} [fleet: {fs.duration_s / 3600.0:.0f} h x "
                  f"{fs.gpus} GPUs] {fs.paper_ref}")
        return 0

    targets = library.names() if args.all else args.scenario
    if not targets and not args.campaign and not args.sweep and not args.fleet:
        ap.error("nothing to do: pass --list, --scenario NAME, "
                 "--campaign NAME, --sweep NAME, --fleet NAME, or --all")

    op = None
    if args.operating_point:
        from repro_torch.core.c4d.master import OperatingPoint
        op = OperatingPoint.parse(args.operating_point)

    failed: List[str] = []
    for name in targets:
        spec = library.get(name, seed=args.seed if args.seed is not None else 0)
        if op is not None or args.backend is not None or args.attribution:
            import dataclasses
            over = {}
            if op is not None:
                over["operating_point"] = op
            if args.backend is not None:
                over["backend"] = args.backend
            if args.attribution:
                over["attribution"] = True
            spec = dataclasses.replace(spec, **over)
        rep = run_scenario(spec, device=args.device)
        if args.live:
            import tempfile

            from repro_torch.scenarios import live
            with tempfile.TemporaryDirectory() as tmp:
                rep["live"] = live.drive(spec, workdir=tmp,
                                         n_steps=args.live_steps,
                                         device=args.device)
        if args.json != "-" and args.md != "-":
            # keep console text off stdout whenever any '-' destination
            # owns the stream (scenario + campaign runs can share it)
            for line in _summary_lines(rep):
                print(line)
            print()
        if args.json:
            _write_json(rep, args.json, rep["scenario"])
        if not rep["passed"]:
            failed.append(name)

    for name in args.campaign:
        cam = montecarlo.get(name, seed=args.seed, n_trials=args.trials,
                             gpus=args.gpus, operating_point=op,
                             backend=args.backend,
                             attribution=True if args.attribution else None)
        t0 = time.perf_counter()
        report = montecarlo.run_campaign(cam, workers=max(args.workers, 1),
                                         device=args.device)
        wall = time.perf_counter() - t0
        if args.json != "-" and args.md != "-":
            for line in report.summary_lines():
                print(line)
            print(f"wall          : {wall:.1f} s "
                  f"({len(report.trials)} trials, workers={args.workers})")
            print()
        if args.json:
            _write_json(report.to_json(), args.json, cam.name)
        if args.md:
            _write_text(report.to_markdown(), args.md, cam.name)

    for name in args.fleet:
        fs = fleet.get(name, seed=args.seed, gpus=args.gpus,
                       operating_point=op, backend=args.backend,
                       attribution=True if args.attribution else None)
        t0 = time.perf_counter()
        frep = fleet.run_fleet(fs, workers=max(args.workers, 1),
                               device=args.device)
        wall = time.perf_counter() - t0
        if args.json != "-" and args.md != "-":
            for line in frep.summary_lines():
                print(line)
            print(f"wall          : {wall:.1f} s "
                  f"({len(frep.rolling)} rolling segments)")
            print()
        if args.json:
            _write_json(frep.to_json(), args.json, fs.name)
        if args.md:
            _write_text(frep.to_markdown(), args.md, fs.name)

    for name in args.sweep:
        sw = precision.get(name, seed=args.seed, n_trials=args.trials)
        t0 = time.perf_counter()
        with use_backend(args.backend):
            srep = precision.run_sweep(sw, device=args.device)
        wall = time.perf_counter() - t0
        if args.json != "-" and args.md != "-":
            for line in srep.summary_lines():
                print(line)
            print(f"wall          : {wall:.1f} s "
                  f"({sw.n_trials} trials x {len(srep.points) + 1} points)")
            print()
        if args.json:
            _write_json(srep.to_json(), args.json, sw.name)
        if args.md:
            from repro_torch.scenarios.report import render_sweep_markdown
            _write_text(render_sweep_markdown(srep), args.md, sw.name)
        if not srep.meets_targets:
            failed.append(name)

    if failed and not args.no_assert:
        print(f"assertions failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
