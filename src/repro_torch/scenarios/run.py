"""Scenario CLI of the port: the single-trial drills.

    PYTHONPATH=src python -m repro_torch.scenarios.run --list
    PYTHONPATH=src python -m repro_torch.scenarios.run --scenario single_nic_down
    PYTHONPATH=src python -m repro_torch.scenarios.run --all --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios.run --all --json reports/
    PYTHONPATH=src python -m repro_torch.scenarios.run --scenario ecmp_vs_c4p_ab --json -

Copy of the drill half of ``repro.scenarios.run``, with ``--device``: the
detection windows run on the torch backend (the port's default) on the card
unless ``--device cpu`` (the kernels' plain versions) or ``--backend numpy``
is given.  Each report carries detection latency, localisation verdicts, the
Table-3 downtime phase breakdown, and effective goodput.  ``--json`` writes
the machine-readable report (a file per scenario when given a directory,
stdout with ``-``).  ``--seed`` flows through the spec factories and is
surfaced in every JSON report.  Exit status is non-zero when any scenario's
spec assertions fail.  Campaigns, sweeps, fleets and the live-trainer replay
are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from repro_torch.scenarios import library
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios.run",
        description="Run end-to-end C4 fault drills on the port "
                    "(docs/scenarios.md).")
    ap.add_argument("--list", action="store_true",
                    help="list shipped scenarios and exit")
    ap.add_argument("--scenario", action="append", default=[],
                    help="scenario name (repeatable)")
    ap.add_argument("--all", action="store_true", help="run every scenario")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed threaded through spec factories "
                         "(default: each target's own default)")
    ap.add_argument("--backend", default=None,
                    choices=["numpy", "torch", "auto"],
                    help="detection backend for every scenario (default: "
                         "REPRO_TORCH_SIM_BACKEND env var or torch)")
    ap.add_argument("--device", default=None,
                    help="where the torch backend runs (default: cuda; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("--attribution", action="store_true",
                    help="turn on root-cause attribution (Mycroft-style "
                         "dependency cover) for every scenario in this "
                         "invocation")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write report(s) as JSON: a *.json file, a "
                         "directory (one file per target), or '-' for "
                         "stdout")
    ap.add_argument("--no-assert", action="store_true",
                    help="report assertion failures but exit 0")
    args = ap.parse_args(argv)

    if args.list:
        for name in library.names():
            spec = library.get(name)
            print(f"{name:28s} {spec.paper_ref}")
        return 0

    targets = library.names() if args.all else args.scenario
    if not targets:
        ap.error("nothing to do: pass --list, --scenario NAME, or --all")

    failed: List[str] = []
    for name in targets:
        spec = library.get(name, seed=args.seed if args.seed is not None else 0)
        if args.backend is not None or args.attribution:
            import dataclasses
            over = {}
            if args.backend is not None:
                over["backend"] = args.backend
            if args.attribution:
                over["attribution"] = True
            spec = dataclasses.replace(spec, **over)
        rep = run_scenario(spec, device=args.device)
        if args.json != "-":
            # keep console text off stdout when the JSON owns the stream
            for line in _summary_lines(rep):
                print(line)
            print()
        if args.json:
            _write_json(rep, args.json, rep["scenario"])
        if not rep["passed"]:
            failed.append(name)

    if failed and not args.no_assert:
        print(f"assertions failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
