"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --smoke --steps 4 --device cpu

Port of ``repro.launch.train``: the same flags and JSON keys, plus
``--device`` (default ``cuda``; ``cpu`` only when asked). ``--smoke`` uses
the reduced same-family config. One device, no mesh: ``--data`` and
``--model`` must be 1. ``--inject-fault KIND:STEP`` runs the C4D detect ->
isolate -> restore loop mid-training, its detection on the same device.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile

from repro_torch.common.config import SHAPES, ShapeSpec
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.faults import Fault
from repro_torch.train.trainer import FaultInjector, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--shape", default=None,
                    help="shape grid name; default = config's train shape")
    ap.add_argument("--inject-fault", default=None, metavar="KIND:STEP",
                    help="e.g. slow_src:7 or crash:5")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; there is no automatic CPU fallback")
    args = ap.parse_args(argv)
    if args.data != 1 or args.model != 1:
        ap.error("the port trains on one device: --data and --model must be 1")

    logging.basicConfig(level=logging.INFO)
    run = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.shape:
        shape = SHAPES[args.shape]
    else:
        shape = ShapeSpec("train", run.train.seq_len, run.train.global_batch, "train")
    trainer = Trainer(run, shape, workdir=args.workdir, device=args.device)

    injector = None
    if args.inject_fault:
        kind, step = args.inject_fault.split(":")
        injector = FaultInjector({int(step): Fault(kind, rank=3)})

    report = trainer.train(args.steps, injector=injector)
    out = {
        "arch": run.model.name,
        "steps_run": report.steps_run,
        "restarts": report.restarts,
        "first_loss": report.losses[0] if report.losses else None,
        "last_loss": report.losses[-1] if report.losses else None,
        "detections": report.detections,
        "step_stats": trainer.monitor.summary(),
        "checkpoints_saved": trainer.ckpt.save_count,
    }
    print(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
