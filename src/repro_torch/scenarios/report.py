"""Campaign reports: JSON for CI artifacts, markdown for humans.

A ``CampaignReport`` is the deterministic output of
``montecarlo.run_campaign``: the campaign distribution it measured, one
compact record per trial (each carrying its own seed), and the fleet
aggregates of ``repro_torch.scenarios.stats``.  ``to_json`` is byte-stable for a
given ``CampaignSpec`` — no wall-clock, host, or ordering nondeterminism —
which is what the seeded-determinism test and the CI artifact diff rely
on.  ``to_markdown`` renders the same content as the paper-claim table
plus distribution summaries (``experiments/summarize.py --campaign``
renders saved JSON reports through the same code).

Copy of ``repro.scenarios.report`` for the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


def _fmt(x: Optional[float], nd: int = 2, suffix: str = "") -> str:
    if x is None:
        return "—"
    return f"{x:.{nd}f}{suffix}"


def _ci(block: dict, nd: int = 2, suffix: str = "") -> str:
    if not block or block.get("mean") is None:
        return "—"
    return (f"{block['mean']:.{nd}f}{suffix} "
            f"[{block['ci_lo']:.{nd}f}, {block['ci_hi']:.{nd}f}]")


@dataclass
class CampaignReport:
    """Deterministic result of one Monte Carlo campaign (docs/campaigns.md).

    ``campaign`` embeds the full ``CampaignSpec`` (distribution + seed),
    ``trials`` the per-trial records of ``stats.trial_metrics`` (each with
    the trial's engine seed), ``aggregates`` the fleet statistics of
    ``stats.aggregate`` — detection precision/recall against injected
    ground truth, MTTR/latency percentiles, and the paper-claim brackets
    (abstract: 30 % error-overhead cut, 15 % comm-cost cut, 30-45 %
    efficiency gain)."""
    campaign: dict
    trials: List[dict] = field(default_factory=list)
    aggregates: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"campaign": self.campaign,
                "name": self.campaign.get("name"),
                "seed": self.campaign.get("seed"),
                "n_trials": len(self.trials),
                "trials": self.trials,
                "aggregates": self.aggregates}

    def to_markdown(self) -> str:
        return render_markdown(self.to_json())

    def summary_lines(self) -> List[str]:
        """Console summary (the CLI's non-JSON output)."""
        agg = self.aggregates
        det = agg["detection"]
        ov = agg["overhead"]
        eff = agg["efficiency"]
        cam = self.campaign
        lines = [
            f"campaign      : {cam['name']}  seed={cam['seed']}  "
            f"trials={len(self.trials)}  gpus={cam['gpus']}",
            f"paper ref     : {cam['paper_ref']}",
            f"faults        : {det['n_faults']} injected | "
            f"precision {det['precision']:.3f} | recall {det['recall']:.3f}",
            f"det latency   : p50 {_fmt(det['latency_s']['p50'], 0)} s | "
            f"p90 {_fmt(det['latency_s']['p90'], 0)} s | "
            f"p99 {_fmt(det['latency_s']['p99'], 0)} s",
            f"MTTR          : p50 {_fmt(ov['mttr_s']['p50'], 0)} s | "
            f"p90 {_fmt(ov['mttr_s']['p90'], 0)} s | "
            f"p99 {_fmt(ov['mttr_s']['p99'], 0)} s "
            f"(baseline p50 {_fmt(ov['baseline_mttr_s']['p50'], 0)} s)",
        ]
        fams = det.get("per_family", {})
        if len(fams) > 1:
            for fam in sorted(fams):
                c = fams[fam]
                lines.append(
                    f"  {fam:<12}: {c['n_faults']} faults | "
                    f"precision {c['precision']:.3f} | "
                    f"recall {c['recall']:.3f}")
        att = det.get("attribution", {})
        if att.get("attempts"):
            lines.append(
                f"attribution   : {att['hits']}/{att['attempts']} culprit "
                f"hits ({_fmt(att['hit_rate'], 3)})")
        st = agg.get("streaming")
        if st and st["latency_s"]["n"]:
            lines.append(
                f"online det    : p50 {_fmt(st['latency_s']['p50'], 0)} s | "
                f"p99 {_fmt(st['latency_s']['p99'], 0)} s | "
                f"recall {_fmt(st['online_recall'], 3)} | "
                f"fault-free FP rate {_fmt(st['fault_free_fp_rate'], 4)}")
        lines += [
            f"goodput       : {_ci(eff['goodput_frac'], 3)} of ideal",
            f"overhead cut  : {_ci(ov['cut_pct_points'], 1, ' pt')} "
            f"(paper ~30 pt of month)",
        ]
        comm = agg["communication"]
        if comm["ab_gain_pct"]["mean"] is not None:
            lines.append(
                f"comm cost cut : {_ci(comm['cost_cut_pct'], 1, ' %')} "
                f"(paper ~15 %)")
            lines.append(
                f"efficiency    : {_ci(eff['gain_pct'], 1, ' %')} gain "
                f"(paper 30-45 %) "
                f"{'brackets paper' if eff['gain_pct']['brackets_paper'] else 'outside paper range'}")
        return lines


def render_markdown(rep: dict) -> str:
    """Markdown for a campaign-report JSON dict (also used on saved files)."""
    cam = rep["campaign"]
    agg = rep["aggregates"]
    det = agg["detection"]
    ov = agg["overhead"]
    comm = agg["communication"]
    eff = agg["efficiency"]
    out = [
        f"# Campaign `{cam['name']}`",
        "",
        f"{cam.get('description', '')}",
        "",
        f"*{rep['n_trials']} trials · {cam['gpus']} simulated GPUs/trial · "
        f"seed {cam['seed']} · paper: {cam.get('paper_ref', '')}*",
        "",
        "## Paper-claim brackets",
        "",
        "| claim | measured (95 % CI) | paper | brackets? |",
        "|---|---|---|---|",
        f"| error-induced overhead cut | {_ci(ov['cut_pct_points'], 1, ' pt')}"
        f" | ~30 pt of month (Table 3) "
        f"| {'yes' if ov['cut_pct_points']['brackets_paper'] else 'no'} |",
        f"| communication cost cut | {_ci(comm['cost_cut_pct'], 1, ' %')} "
        f"| ~15 % (abstract) "
        f"| {'yes' if comm['cost_cut_pct']['brackets_paper'] else 'no'} |",
        f"| system efficiency gain | {_ci(eff['gain_pct'], 1, ' %')} "
        f"| 30-45 % (abstract) "
        f"| {'yes' if eff['gain_pct']['brackets_paper'] else 'no'} |",
        "",
        "## Detection (vs injected ground truth)",
        "",
        "| metric | value |",
        "|---|---|",
        f"| injected faults | {det['n_faults']} |",
        f"| true / false positives | {det['true_positives']} / "
        f"{det['false_positives']} |",
        f"| false negatives | {det['false_negatives']} |",
        f"| precision | {det['precision']:.3f} |",
        f"| recall | {det['recall']:.3f} |",
        f"| latency p50 / p90 / p99 | {_fmt(det['latency_s']['p50'], 0)} / "
        f"{_fmt(det['latency_s']['p90'], 0)} / "
        f"{_fmt(det['latency_s']['p99'], 0)} s |",
    ]
    if det["network_events"]:
        out.append(f"| fabric events observed | "
                   f"{det['network_observed_rate']:.2f} "
                   f"(edge hit {det['network_edge_hit_rate']:.2f}) |")
    fams = det.get("per_family", {})
    if len(fams) > 1:
        out += [
            "",
            "### Per fault family",
            "",
            "| family | faults | TP/FP/FN | precision | recall |",
            "|---|---|---|---|---|",
        ]
        for fam in sorted(fams):
            c = fams[fam]
            out.append(
                f"| {fam} | {c['n_faults']} | {c['true_positives']}/"
                f"{c['false_positives']}/{c['false_negatives']} "
                f"| {c['precision']:.3f} | {c['recall']:.3f} |")
    att = det.get("attribution", {})
    if att.get("attempts"):
        out.append("")
        out.append(f"Root-cause attribution: {att['hits']}/{att['attempts']} "
                   f"culprit-set hits ({_fmt(att['hit_rate'], 3)}).")
    st = rep["aggregates"].get("streaming")
    if st and st["latency_s"]["n"]:
        out += [
            "",
            "## Always-on streaming detection (measured on the clock)",
            "",
            "| metric | value |",
            "|---|---|",
            f"| online latency p50 / p90 / p99 | "
            f"{_fmt(st['latency_s']['p50'], 0)} / "
            f"{_fmt(st['latency_s']['p90'], 0)} / "
            f"{_fmt(st['latency_s']['p99'], 0)} s |",
            f"| online detected / missed | {st['detected']} / {st['missed']} |",
            f"| online recall | {_fmt(st['online_recall'], 3)} |",
            f"| fault-free windows | {st['fault_free_windows']} |",
            f"| fault-free false-positive rate | "
            f"{_fmt(st['fault_free_fp_rate'], 4)} |",
        ]
    out += [
        "",
        "## Downtime (MTTR per fault, Table-3 phases)",
        "",
        "| | p50 | p90 | p99 | mean |",
        "|---|---|---|---|---|",
        f"| C4D | {_fmt(ov['mttr_s']['p50'], 0)} s | "
        f"{_fmt(ov['mttr_s']['p90'], 0)} s | "
        f"{_fmt(ov['mttr_s']['p99'], 0)} s | "
        f"{_fmt(ov['mttr_s']['mean'], 0)} s |",
        f"| no-C4D baseline | {_fmt(ov['baseline_mttr_s']['p50'], 0)} s | "
        f"{_fmt(ov['baseline_mttr_s']['p90'], 0)} s | "
        f"{_fmt(ov['baseline_mttr_s']['p99'], 0)} s | "
        f"{_fmt(ov['baseline_mttr_s']['mean'], 0)} s |",
        "",
        f"Goodput fraction {_ci(eff['goodput_frac'], 3)}, downtime fraction "
        f"{_ci(eff['downtime_frac'], 4)}.",
        "",
        "## Trials",
        "",
        "| trial | seed | faults | TP/FP/FN | goodput | A/B gain |",
        "|---|---|---|---|---|---|",
    ]
    for i, t in enumerate(rep["trials"]):
        gain = (f"{t['ab_gain_pct']:+.1f} %" if "ab_gain_pct" in t else "—")
        out.append(
            f"| {i} | {t['seed']} | {t['n_faults']} "
            f"| {t['true_positives']}/{t['false_positives']}"
            f"/{t['false_negatives']} | {t['goodput_frac']:.3f} | {gain} |")
    out.append("")
    return "\n".join(out)


def _sweep_row(p: dict, marker: str = "") -> str:
    lat = p["latency_windows"]
    return (f"| {p['label']}{marker} | {p['fault_free_fp_rate']:.4f} "
            f"| {p['recall']:.3f} | {p['clean_recall']:.3f} "
            f"| {p['marginal_detected']}/{p['marginal_episodes']} "
            f"| {p['precision']:.3f} "
            f"| {_fmt(lat['p50'], 1)} / {_fmt(lat['p99'], 1)} "
            f"| {p['monthly_cost_gpu_h']:.0f} |")


def render_sweep_markdown(rep: dict) -> str:
    """Markdown for an ROC sweep-report JSON dict (``SweepReport.to_json``
    shape; ``experiments/summarize.py --campaign`` detects it by its
    ``points`` key)."""
    if hasattr(rep, "to_json"):         # accept the live report object too
        rep = rep.to_json()
    sw = rep["sweep"]
    sel = rep["selected"]
    out = [
        f"# ROC sweep `{sw['name']}`",
        "",
        f"{sw.get('description', '')}",
        "",
        f"*{sw['n_trials']} trials x {len(rep['points'])} grid points · "
        f"seed {sw['seed']} · {sw['windows']} windows/trial · "
        f"paper: {sw.get('paper_ref', '')}*",
        "",
        f"Selected operating point: **`{sel['label']}`** — fault-free FP "
        f"rate {sel['fault_free_fp_rate']:.4f} (target <= {sw['fp_target']}),"
        f" recall {sel['recall']:.3f} (clean {sel['clean_recall']:.3f}), "
        f"latency p99 {_fmt(sel['latency_windows']['p99'], 1)} windows, "
        f"{sel['monthly_cost_gpu_h']:.0f} GPU-h/month at "
        f"{sw['cost']['fleet_gpus']} GPUs.  Targets "
        f"{'met' if rep['meets_targets'] else 'NOT met'}.",
        "",
        "| operating point | FP rate | recall | clean | marginal "
        "| precision | latency p50/p99 (w) | cost (GPU-h/mo) |",
        "|---|---|---|---|---|---|---|---|",
        _sweep_row(rep["reference"]),
    ]
    for p in rep["points"]:
        out.append(_sweep_row(
            p, marker=" ◀" if p["label"] == sel["label"] else ""))
    out += [
        "",
        "Reference row is the pinned PR 5 cross-sectional detector "
        "(single-window robust-z, streak 2).  Cost prices false isolations "
        "at the Table-3 restart tail and missed faults at the "
        "BASELINE_JUN23 MTTR counterfactual; the marginal column counts "
        "near-threshold episodes only.",
        "",
    ]
    return "\n".join(out)
