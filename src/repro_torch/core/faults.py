"""Fault taxonomy, injection, and telemetry synthesis.

Table 1 of the paper gives the production error mix (all surfacing to users
as generic "NCCL Error"s) and how often each class is localisable:

    CUDA Error          12.5%   localized 100%
    ECC/NVLink Error    27.5%   localized 100%
    NCCL timeout        20.0%   localized 75%
    ACK timeout         27.5%   localized 81.8%
    Network/Others      12.5%   localized 40%

``RingJobTelemetry`` synthesises the enhanced-CCL telemetry of a healthy
ring-allreduce job and injects fault signatures — this is what the C4D
detectors consume everywhere the pipeline runs: tests, the Table-3 downtime
simulation, and the scenario campaign engine (all through
``repro.scenarios.detection.DetectionHarness``; the detection pipeline
actually runs per error, it is not a sampled constant).

Copy of ``repro.core.faults`` for the port: the seeded window source of its
tests and of ``chip_smoke.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.c4d.telemetry import (CommunicatorInfo, Heartbeat, OpRecord,
                                      TelemetryArrays, TelemetryWindow,
                                      TrainSignals, TransportRecord)

# ---------------------------------------------------------------------------
# Taxonomy (Table 1)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ErrorClass:
    name: str
    probability: float
    localization_rate: float      # fraction C4D can pin to a component
    syndrome: str                 # dominant telemetry signature


TABLE1 = [
    ErrorClass("cuda_error",   0.125, 1.000, "crash"),
    ErrorClass("ecc_nvlink",   0.275, 1.000, "crash"),
    ErrorClass("nccl_timeout", 0.200, 0.750, "comm_hang"),
    ErrorClass("ack_timeout",  0.275, 0.818, "comm_slow"),
    ErrorClass("network_other",0.125, 0.400, "link_slow"),
]


def sample_error_class(rng: np.random.Generator) -> ErrorClass:
    p = np.array([e.probability for e in TABLE1])
    return TABLE1[int(rng.choice(len(TABLE1), p=p / p.sum()))]


# Divergence family (Flare, arXiv 2502.05413): anomalies that never touch
# the network — the comm channel is structurally blind to all three.  The
# mix is not from Table 1 (the paper only counts comm-surfacing errors);
# probabilities are the relative rates Flare reports for numeric faults.
DIVERGENCE_TABLE = [
    ErrorClass("silent_data_corruption", 0.40, 0.95, "divergence_grad"),
    ErrorClass("loss_spike",             0.35, 0.90, "divergence_loss"),
    ErrorClass("nan_rank",               0.25, 1.00, "divergence_overflow"),
]

DIVERGENCE_KINDS = ("sdc", "loss_spike", "nan_rank")


def fault_family(kind: str) -> str:
    """Which detector vertical owns a fault kind: the train-signal
    divergence channel or the enhanced-CCL comm channel."""
    return "divergence" if kind in DIVERGENCE_KINDS else "comm"


def sample_divergence_class(rng: np.random.Generator) -> ErrorClass:
    p = np.array([e.probability for e in DIVERGENCE_TABLE])
    return DIVERGENCE_TABLE[int(rng.choice(len(DIVERGENCE_TABLE),
                                           p=p / p.sum()))]


# ---------------------------------------------------------------------------
# Injectable faults (telemetry-level signatures)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Fault:
    kind: str                     # slow_src | slow_dst | slow_link | straggler |
                                  # comm_hang | noncomm_hang | crash |
                                  # sdc | loss_spike | nan_rank
    rank: Optional[int] = None
    link: Optional[Tuple[int, int]] = None
    severity: float = 8.0         # latency multiplier / delay seconds


def _fault_maps(faults: Sequence[Fault]):
    """Fault list -> per-kind lookup maps, shared by both window paths so
    the taxonomy handling cannot drift between the scalar and vectorized
    synthesisers (their equivalence is pinned)."""
    return (
        {f.rank for f in faults if f.kind in ("comm_hang", "crash")},
        {f.rank for f in faults if f.kind == "noncomm_hang"},
        {f.rank: f.severity for f in faults if f.kind == "slow_src"},
        {f.rank: f.severity for f in faults if f.kind == "slow_dst"},
        {f.link: f.severity for f in faults if f.kind == "slow_link"},
        {f.rank: f.severity for f in faults if f.kind == "straggler"},
    )


class RingJobTelemetry:
    """Synthetic enhanced-CCL telemetry of a BSP ring-allreduce job."""

    def __init__(self, n_ranks: int, iters_per_window: int = 10,
                 base_transfer_s: float = 0.010, base_wait_s: float = 0.0015,
                 msg_bytes: int = 64 << 20, jitter: float = 0.04, seed: int = 0,
                 channel_strides: Sequence[int] = (1, 3, 5, 7)):
        # NCCL-style multi-channel rings: each channel is a different ring
        # permutation (stride), so every rank talks to several distinct peers
        # per window — this is what populates the Fig. 6 delay matrix beyond
        # a single diagonal and makes row/column analysis meaningful.
        self.n = n_ranks
        self.iters = iters_per_window
        self.base_transfer = base_transfer_s
        self.base_wait = base_wait_s
        self.msg_bytes = msg_bytes
        self.jitter = jitter
        self.rng = np.random.default_rng(seed)
        self.channel_strides = [s for s in channel_strides
                                if np.gcd(s, n_ranks) == 1] or [1]
        # training-side signal channel (divergence detection): its own RNG
        # stream, so exporting train signals never perturbs the pinned comm
        # jitter sequence above (7919 is an arbitrary fixed stream key)
        self.base_loss = 2.0
        self.base_grad = 1.0
        self.train_jitter = 0.02
        self.train_rng = np.random.default_rng([seed, 7919])

    def window(self, window_id: int = 0,
               faults: Sequence[Fault] = ()) -> TelemetryWindow:
        n = self.n
        rng = self.rng
        comm = CommunicatorInfo(comm_id=0, n_ranks=n, ranks=tuple(range(n)))
        win = TelemetryWindow(window_id=window_id, comms=[comm])
        (hang_ranks, nc_hang_ranks, slow_src, slow_dst, slow_link,
         straggler) = _fault_maps(faults)

        t = 0.0
        op_period = self.base_transfer * 2.2
        seq = {r: 0 for r in range(n)}
        for it in range(self.iters):
            for stride in self.channel_strides:
                for r in range(n):
                    dst = (r + stride) % n
                    if r in hang_ranks or r in nc_hang_ranks:
                        continue  # emits nothing this window after the hang point
                    transfer = self.base_transfer * (1 + self.jitter * rng.standard_normal())
                    transfer = abs(transfer) + 1e-6
                    wait = abs(self.base_wait * (1 + self.jitter * rng.standard_normal()))
                    if r in slow_src:
                        transfer *= slow_src[r]
                    if dst in slow_dst:
                        transfer *= slow_dst[dst]
                    if (r, dst) in slow_link:
                        transfer *= slow_link[(r, dst)]
                    if r in straggler:
                        # sender late into the collective: receiver waits, link fine
                        wait += self.base_transfer * straggler[r]
                    t_post = t + it * op_period
                    t_start = t_post + wait
                    t_end = t_start + transfer
                    win.transports.append(TransportRecord(
                        iteration=it, src_rank=r, dst_rank=dst,
                        msg_bytes=self.msg_bytes, t_post=t_post, t_start=t_start,
                        t_end=t_end))
                    win.ops.append(OpRecord(
                        iteration=it, rank=r, comm_id=0, op_type="allreduce",
                        algorithm="ring", dtype="bf16",
                        element_count=self.msg_bytes // 2,
                        t_start=t_post, t_end=t_end, seq=seq[r]))
                    seq[r] += 1
            for r in range(n):
                if r in hang_ranks or r in nc_hang_ranks:
                    continue
                win.heartbeats.append(Heartbeat(rank=r, iteration=it,
                                                seq=seq[r], t=(it + 1) * op_period))
        # hung ranks: heartbeat frozen at an early seq (comm hang had started
        # the collective; non-comm hang never reached it)
        for r in hang_ranks:
            win.heartbeats.append(Heartbeat(rank=r, iteration=0, seq=1, t=op_period))
            win.transports.append(TransportRecord(
                iteration=0, src_rank=r, dst_rank=(r + 1) % n,
                msg_bytes=self.msg_bytes, t_post=0.0, t_start=self.base_wait,
                t_end=self.base_wait + self.base_transfer))
        for r in nc_hang_ranks:
            win.heartbeats.append(Heartbeat(rank=r, iteration=0, seq=0, t=op_period))
        win.t_begin, win.t_end = 0.0, self.iters * op_period
        return win

    def window_arrays(self, window_id: int = 0,
                      faults: Sequence[Fault] = ()) -> TelemetryArrays:
        """Vectorized ``window``: same telemetry as a struct-of-arrays.

        Consumes the jitter RNG stream in exactly the scalar order (per
        iteration, per channel, per active rank: transfer draw then wait
        draw), so a telemetry instance can interleave both paths and stay
        reproducible; columns match ``window()`` record-for-record
        (equivalence pinned in tests/test_c4d_vectorized.py).  This is the
        synthesis path the Monte Carlo campaigns run at 1024+ ranks.
        """
        n = self.n
        rng = self.rng
        comm = CommunicatorInfo(comm_id=0, n_ranks=n, ranks=tuple(range(n)))
        (hang_ranks, nc_hang_ranks, slow_src, slow_dst, slow_link,
         straggler) = _fault_maps(faults)

        op_period = self.base_transfer * 2.2
        strides = self.channel_strides
        S, I = len(strides), self.iters
        act = np.array([r for r in range(n)
                        if r not in hang_ranks and r not in nc_hang_ranks],
                       dtype=np.int64)
        m = act.size
        # one draw covering every (iteration, channel, rank) cell, in the
        # scalar loop's order: transfer jitter then wait jitter per record
        jit = rng.standard_normal(I * S * m * 2).reshape(I, S, m, 2)
        transfer = np.abs(self.base_transfer * (1 + self.jitter * jit[..., 0])) + 1e-6
        wait = np.abs(self.base_wait * (1 + self.jitter * jit[..., 1]))

        dst = (act[None, :] + np.asarray(strides, np.int64)[:, None]) % n  # (S, m)
        src_mult = np.ones(n)
        for r, sev in slow_src.items():
            src_mult[r] = sev
        dst_mult = np.ones(n)
        for r, sev in slow_dst.items():
            dst_mult[r] = sev
        link_mult = np.ones((S, m))
        for (a, b), sev in slow_link.items():
            link_mult[(act[None, :] == a) & (dst == b)] = sev
        # multiplying by exactly 1.0 is a bit-level no-op, so applying the
        # multiplier columns unconditionally matches the scalar if-guards
        transfer = ((transfer * src_mult[act][None, None, :])
                    * dst_mult[dst][None, :, :]) * link_mult[None, :, :]
        wait_add = np.zeros(n)
        for r, sev in straggler.items():
            wait_add[r] = self.base_transfer * sev
        wait = wait + wait_add[act][None, None, :]

        t_post = np.broadcast_to(
            (np.arange(I) * op_period)[:, None, None], (I, S, m))
        t_start = t_post + wait
        t_end = t_start + transfer

        tr_src = np.broadcast_to(act[None, None, :], (I, S, m)).ravel()
        tr_dst = np.broadcast_to(dst[None, :, :], (I, S, m)).ravel()
        op_rank = tr_src.copy()          # op layer mirrors the main loop only
        seq_at = (np.arange(I)[:, None] * S + np.arange(S)[None, :])  # (I, S)
        op_seq = np.broadcast_to(seq_at[:, :, None], (I, S, m)).ravel()

        hb_rank = np.broadcast_to(act[None, :], (I, m)).ravel()
        hb_seq = np.broadcast_to(((np.arange(I) + 1) * S)[:, None], (I, m)).ravel()
        hb_t = np.broadcast_to(((np.arange(I) + 1) * op_period)[:, None],
                               (I, m)).ravel()

        # hung ranks (same trailing records as the scalar path): comm hang
        # froze after starting the collective, non-comm hang never reached it
        ch = list(hang_ranks)
        nc = list(nc_hang_ranks)
        if ch:
            tr_src = np.r_[tr_src, np.asarray(ch, np.int64)]
            tr_dst = np.r_[tr_dst, (np.asarray(ch, np.int64) + 1) % n]
            t_post = np.r_[t_post.ravel(), np.zeros(len(ch))]
            t_start = np.r_[t_start.ravel(), np.full(len(ch), self.base_wait)]
            t_end = np.r_[t_end.ravel(),
                          np.full(len(ch), self.base_wait + self.base_transfer)]
        else:
            t_post, t_start, t_end = t_post.ravel(), t_start.ravel(), t_end.ravel()
        if ch or nc:
            hb_rank = np.r_[hb_rank, np.asarray(ch + nc, np.int64)]
            hb_seq = np.r_[hb_seq, np.ones(len(ch), np.int64),
                           np.zeros(len(nc), np.int64)]
            hb_t = np.r_[hb_t, np.full(len(ch) + len(nc), op_period)]

        return TelemetryArrays(
            window_id=window_id, comms=[comm],
            tr_src=tr_src, tr_dst=tr_dst,
            tr_bytes=np.full(tr_src.size, self.msg_bytes, np.int64),
            tr_post=t_post, tr_start=t_start, tr_end=t_end,
            hb_rank=hb_rank, hb_seq=hb_seq, hb_t=hb_t,
            op_rank=op_rank, op_seq=op_seq,
            t_begin=0.0, t_end=I * op_period)


    def train_signals(self, window_id: int = 0,
                      faults: Sequence[Fault] = ()) -> TrainSignals:
        """Per-rank training signals for one window (the Flare channel).

        Healthy BSP ranks see statistically identical shards: loss decays
        slowly with the window index and both loss and grad-norm carry a
        small iid jitter.  Divergence faults perturb only the culprit
        rank's column: ``sdc`` inflates the gradient norm (with a mild
        loss echo), ``loss_spike`` inflates the loss, ``nan_rank`` emits
        overflow events.  Draws come from ``train_rng`` only — the comm
        jitter stream is untouched whether or not this is called.
        """
        n = self.n
        jit = self.train_rng.standard_normal(2 * n).reshape(2, n)
        decay = 1.0 / (1.0 + 0.01 * window_id)
        loss = np.abs(self.base_loss * decay
                      * (1 + self.train_jitter * jit[0])) + 1e-6
        grad = np.abs(self.base_grad
                      * (1 + self.train_jitter * jit[1])) + 1e-6
        overflow = np.zeros(n, np.int64)
        for f in faults:
            if f.rank is None or not (0 <= f.rank < n):
                continue
            if f.kind == "sdc":
                grad[f.rank] *= f.severity
                loss[f.rank] *= 1 + 0.05 * max(f.severity - 1.0, 0.0)
            elif f.kind == "loss_spike":
                loss[f.rank] *= f.severity
            elif f.kind == "nan_rank":
                overflow[f.rank] += max(int(round(f.severity)), 1)
        return TrainSignals(rank=np.arange(n, dtype=np.int64),
                            loss=loss, grad_norm=grad, overflow=overflow)


def fault_for_class(cls: ErrorClass, rank: int, n_ranks: int,
                    rng: np.random.Generator) -> Fault:
    """Instantiate a concrete telemetry fault for a Table-1 error class."""
    if cls.syndrome == "crash":
        return Fault("crash", rank=rank)
    if cls.syndrome == "comm_hang":
        return Fault("comm_hang", rank=rank)
    if cls.syndrome == "comm_slow":
        return Fault("slow_src", rank=rank, severity=float(rng.uniform(5, 15)))
    if cls.syndrome == "divergence_grad":
        return Fault("sdc", rank=rank, severity=float(rng.uniform(3, 8)))
    if cls.syndrome == "divergence_loss":
        return Fault("loss_spike", rank=rank,
                     severity=float(rng.uniform(6, 20)))
    if cls.syndrome == "divergence_overflow":
        return Fault("nan_rank", rank=rank, severity=float(rng.uniform(1, 4)))
    # link_slow
    return Fault("slow_link", link=(rank, (rank + 1) % n_ranks),
                 severity=float(rng.uniform(5, 15)))
