"""The C4P fabrics that water-filling is held and timed on, and the C4P main
path over them.

- ``clos_fabric(n_hosts)``: tests/test_netsim_perf.py's Fig. 2 scenario (a
  FlowSet), the Fig. 2 fabric at 128 hosts, the 10,240-GPU fabric at 1,280;
- ``main_path_fabric`` / ``run_main_path``: C4P at the Fig. 2 fabric's width
  (``FabricState`` in C4P mode, 2 QPs a port, a 64-host ring job and 8
  two-host tenants), evaluated with the dynamic load balancer and without,
  a leaf-spine link failed and re-probed, one more job, evaluated again;
- ``balancer_flowset``: the FlowSet of the main path's balancer call;
- ``waterfill_inputs``: the water-filling kernel's inputs for one
  ``FlowSet.max_min`` call.

Run as a file, it times the main path on the card, with the ``repro_torch``
package under ``--src`` (default: this checkout's), so that two checkouts
can be compared on one card in one run::

    python3 src/repro_torch/scenarios/c4p_fabrics.py [--src DIR]

It prints one JSON line: the wall s of each of ``REPEATS`` runs at
``torch`` on the card (the first included; the kernel's build and the
card's context come before it) and of ``NUMPY_REPEATS`` at ``numpy``, the
water-filling launches a run, and, from one profiled run, the card's busy
s (every kernel and copy) and the water-filling kernels' share of it. It
uses only the API that the port has had since water-filling came to the
card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

FIG2_HOSTS, BIG_HOSTS = 128, 1280                 # 2,048 and 20,480 flows
REPEATS, NUMPY_REPEATS = 6, 2


def clos_fabric(n_hosts: int):
    """tests/test_netsim_perf.py's Fig. 2 scenario on ``n_hosts`` hosts (a
    ring job on the even hosts, a two-host tenant on each pair of the
    others, ECMP, 16 flows a host). Returns a FlowSet."""
    from repro_torch.core.c4p.master import job_ring_requests
    from repro_torch.core.c4p.pathalloc import ecmp_allocate
    from repro_torch.core.flowset import FlowSet
    from repro_torch.core.topology import ClosTopology
    topo = ClosTopology(n_hosts=n_hosts, n_leaf_pairs=n_hosts // 8, n_spines=8,
                        n_host_groups=n_hosts // 8)
    hosts = [(i * 2) % n_hosts for i in range(n_hosts // 2)]
    free = sorted(set(range(n_hosts)) - set(hosts))
    flows = ecmp_allocate(topo, job_ring_requests(0, hosts, topo.nics_per_host), seed=0)
    half = len(free) // 2
    for b in range(half):
        flows += ecmp_allocate(topo, job_ring_requests(
            100 + b, [free[b], free[b + half]], topo.nics_per_host), seed=77 * b)
    for i, f in enumerate(flows):
        f.flow_id = i
    return FlowSet(topo, flows)


def main_path_fabric(device=None):
    """The main path's FabricState with its first nine jobs placed."""
    from repro_torch.core.topology import ClosTopology
    from repro_torch.scenarios.fabric import FabricState
    topo = ClosTopology(n_hosts=FIG2_HOSTS, n_leaf_pairs=16, n_spines=8, n_host_groups=16)
    fab = FabricState(topo, mode="c4p", qps_per_port=2, device=device)
    fab.add_job(0, [(i * 2) % FIG2_HOSTS for i in range(64)])
    for k, b in enumerate(range(1, 17, 2)):
        fab.add_job(1 + k, [b, b + 32])
    return fab


def run_main_path(backend: str, device=None):
    """The main path at ``backend`` (``device`` is the card's at ``torch``).
    Returns (its four evaluations, the busbw of the third)."""
    from repro_torch.core.torchsim import use_backend
    with use_backend(backend):
        fab = main_path_fabric(device if backend == "torch" else None)
        out = [fab.evaluate(cnp_jitter=0.05, seed=3), fab.evaluate(dynamic_lb=False, seed=4)]
        link = sorted(x for x in fab.topo.path_links(0, 2, 0, 0, 0, 0) if x[0] == "ls")[0]
        fab.fail_link(link)
        fab.probe_refresh()
        fab.add_job(99, [3, 35])
        out += [fab.evaluate(seed=5), fab.evaluate(dynamic_lb=False, seed=6)]
        return out, fab.all_busbw(out[2])


def balancer_flowset(device):
    """The FlowSet of the main path's balancer call: the main path's
    fabric evaluated with the dynamic load balancer and CNP jitter 0.05."""
    from repro_torch.core.torchsim import use_backend
    fab = main_path_fabric(device)
    with use_backend("torch"):
        fab.evaluate(cnp_jitter=0.05, seed=3)
    return fab.master.flow_set()


def waterfill_inputs(fs, device, jitter: float = 0.0, seed: int = 0):
    """The kernel's inputs for one ``max_min`` call, on ``device``: (the
    incidence by link, floored weights, aliveness, capacity after the
    jitter draw ``max_min`` makes) and the incidence by flow."""
    import numpy as np
    import torch
    from repro_torch.kernels import waterfill as wf
    cap = fs.base_cap.copy()
    if jitter:
        cap *= 1.0 - jitter * np.random.default_rng(seed).uniform(0.0, 1.0, size=fs.n_links)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        *wf.link_csr(fs.pair_flow, fs.pair_link, fs.n_links), np.maximum(fs.weights, 1e-9),
        fs.alive_mask(), cap)]
    by_flow = [torch.from_numpy(a).to(device)
               for a in wf.flow_csr(fs.pair_flow, fs.pair_link, fs.n_flows)]
    return args, by_flow


def _busy_s(run) -> tuple:
    """(s of every kernel and copy on the card, s of the water-filling
    kernels) in one profiled call of ``run``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = fill = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            busy += e.self_device_time_total / 1e6
            if "waterfill" in e.key:
                fill += e.self_device_time_total / 1e6
    return busy, fill


def main(argv=None) -> int:
    here = Path(__file__).resolve()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(here.parents[2]),
                    help="the directory that holds the repro_torch package to time")
    args = ap.parse_args(argv)
    src = str(Path(args.src).resolve())
    if "repro_torch" in sys.modules:
        raise SystemExit("run this file by its path, so that --src picks the package")
    if sys.path and Path(sys.path[0] or ".").resolve() == here.parent:
        sys.path.pop(0)            # the script's own directory holds modules of the package
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import waterfill as wf
    if not torch.cuda.is_available():
        print("no CUDA device: the main path is timed on the card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _build.build_all(["waterfill"])
    torch.zeros(1, device=dev).sum().item()      # the card's context, before the first run
    torch_s, launches = [], []
    for _ in range(REPEATS):
        before = wf.launches
        t0 = time.perf_counter()
        run_main_path("torch", dev)
        torch.cuda.synchronize()
        torch_s.append(time.perf_counter() - t0)
        launches.append(wf.launches - before)
    numpy_s = []
    for _ in range(NUMPY_REPEATS):
        t0 = time.perf_counter()
        run_main_path("numpy")
        numpy_s.append(time.perf_counter() - t0)
    busy, fill = _busy_s(lambda: run_main_path("torch", dev))
    print(json.dumps({"src": src, "torch_s": torch_s, "numpy_s": numpy_s,
                      "waterfill_launches": launches, "profiled_busy_s": busy,
                      "profiled_waterfill_s": fill}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
