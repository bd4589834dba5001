"""The dry run's train_4k cells on the 16x16 mesh with the port's
``attn_activation_sharding`` "auto", beside each config's "off": the
roofline at one microbatch (``launch.dryrun.run_cell``) and the FLOPs of a
rank's attention scores and PV products under both, traced at 2 units (a
``FlopCounterMode`` around the plain attention's core).

    PYTHONPATH=src python scripts/dryrun_attn_modes.py [ARCH ...] [--out DIR]

Records go to DIR (default experiments/dryrun_torch/attn_auto); one JSON
line an arch on stdout. Counted on the meta device: no card."""
from __future__ import annotations

import argparse
import dataclasses
import json

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common.config import SHAPES
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.models import attention
from repro_torch.models.model import attn_activation_mode

SIZES = {"data": 16, "model": 16}


def with_mode(run, mode: str, microbatches=None):
    parallel = dataclasses.replace(run.parallel, attn_activation_sharding=mode)
    if microbatches is not None:
        parallel = dataclasses.replace(parallel, microbatches=microbatches)
    return run.replace(parallel=parallel)


def attention_flops(run) -> float:
    """A rank's attention score and PV FLOPs in the train step at 2 units
    and one microbatch."""
    real, seen = attention._softmax_attend, []

    def counted(*args, **kw):
        with FlopCounterMode(display=False) as fc:
            out = real(*args, **kw)
        seen.append(fc.get_total_flops())
        return out

    attention._softmax_attend = counted
    try:
        dr.trace_cell(run, SHAPES["train_4k"], SIZES, units=2)
    finally:
        attention._softmax_attend = real
    return float(sum(seen))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--out", default=f"{dr.DEFAULT_OUT}/attn_auto")
    args = ap.parse_args(argv)
    for arch in args.archs:
        run = get_config(arch)
        auto = with_mode(run, "auto")
        rec = dr.run_cell(arch, "train_4k", False, True, args.out, run=auto)
        roof = rec["roofline"]
        print(json.dumps({
            "arch": arch, "mode": attn_activation_mode(auto),
            "peak_bytes": rec["memory"]["peak_bytes"], "t_comp_s": roof["t_comp_s"],
            "t_mem_s": roof["t_mem_s"], "t_coll_s": roof["t_coll_s"],
            "dominant": roof["dominant"], "roofline_fraction": roof["roofline_fraction"],
            "collective_counts": roof["collective_counts"],
            "attention_flops_2_units": {m: attention_flops(with_mode(run, m, 1))
                                        for m in ("off", "auto")}}), flush=True)


if __name__ == "__main__":
    main()
