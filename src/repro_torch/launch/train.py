"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --smoke --steps 4 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch gemma2-2b --smoke --steps 4 --device cpu --data 2 --model 2

Port of ``repro.launch.train``: the same flags and JSON keys, plus
``--device`` (default ``cuda``; ``cpu`` only when asked). ``--smoke`` uses
the reduced same-family config. ``--data``/``--model`` above 1 train on a
(data, model) mesh (``launch.mesh.make_local_mesh``) over a process group of
data x model ranks, one process a device, as ``torchrun`` starts them; rank
0 prints. ``--inject-fault KIND:STEP`` runs the C4D detect -> isolate ->
restore loop mid-training, its detection on the same device, on every rank.
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
from repro_torch.launch.mesh import make_local_mesh
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
    mesh = None
    if args.data * args.model > 1:
        try:
            mesh = make_local_mesh(args.data, args.model, device=args.device)
        except (RuntimeError, ValueError) as e:
            ap.error(str(e))

    logging.basicConfig(level=logging.INFO)
    run = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.shape:
        shape = SHAPES[args.shape]
    else:
        shape = ShapeSpec("train", run.train.seq_len, run.train.global_batch, "train")
    trainer = Trainer(run, shape, workdir=args.workdir, device=args.device, mesh=mesh)

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
    if mesh is None or mesh.get_rank() == 0:
        print(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
