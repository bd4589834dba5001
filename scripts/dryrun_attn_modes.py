"""The dry run's cells on the 16x16 mesh under ``attn_activation_sharding``
modes, one row a config and mode: the roofline (a train cell's at one
microbatch; ``launch.dryrun.run_cell``) and the FLOPs of a rank's attention
scores and PV products, traced at 2 units (a ``FlopCounterMode`` around the
plain attention's core).

    PYTHONPATH=src python scripts/dryrun_attn_modes.py [ARCH ...]
        [--shape train_4k|prefill_32k] [--modes off auto sequence] [--out DIR]

Records go to DIR/<mode> (default experiments/dryrun_torch/attn_<shape>);
one JSON line a config and mode on stdout. Counted on the meta device: no
card."""
from __future__ import annotations

import argparse
import dataclasses
import json

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common.config import SHAPES
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.models import attention
from repro_torch.models.model import ATTN_MODES, attn_activation_mode

SIZES = {"data": 16, "model": 16}


def with_mode(run, mode: str, microbatches=None):
    parallel = dataclasses.replace(run.parallel, attn_activation_sharding=mode)
    if microbatches is not None:
        parallel = dataclasses.replace(parallel, microbatches=microbatches)
    return run.replace(parallel=parallel)


def attention_flops(run, shape) -> float:
    """A rank's attention score and PV FLOPs in the cell's step at 2 units
    and one microbatch."""
    real, seen = attention._softmax_attend, []

    def counted(*args, **kw):
        with FlopCounterMode(display=False) as fc:
            out = real(*args, **kw)
        seen.append(fc.get_total_flops())
        return out

    attention._softmax_attend = counted
    try:
        dr.trace_cell(run, shape, SIZES, units=2)
    finally:
        attention._softmax_attend = real
    return float(sum(seen))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--shape", choices=("train_4k", "prefill_32k"), default="train_4k")
    ap.add_argument("--modes", nargs="+", choices=ATTN_MODES, default=["auto"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = args.out or f"{dr.DEFAULT_OUT}/attn_{args.shape}"
    shape = SHAPES[args.shape]
    for arch in args.archs:
        run = get_config(arch)
        for mode in args.modes:
            cell = with_mode(run, mode)
            rec = dr.run_cell(arch, args.shape, False, True, f"{out}/{mode}", run=cell)
            roof = rec["roofline"]
            print(json.dumps({
                "arch": arch, "shape": args.shape, "mode": mode,
                "resolves": attn_activation_mode(cell),
                "traced_rank": rec["parallel"]["traced_rank"],
                "peak_bytes": rec["memory"]["peak_bytes"], "fits": rec["memory"]["fits"],
                "t_comp_s": roof["t_comp_s"], "t_mem_s": roof["t_mem_s"],
                "t_coll_s": roof["t_coll_s"], "dominant": roof["dominant"],
                "roofline_fraction": roof["roofline_fraction"],
                "collective_counts": roof["collective_counts"],
                "attention_flops_2_units": attention_flops(with_mode(run, mode, 1), shape)}),
                flush=True)


if __name__ == "__main__":
    main()
