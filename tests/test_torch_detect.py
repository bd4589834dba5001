"""The port's C4D detection loop vs the JAX package's NumPy composite.

``repro_torch.core`` (telemetry, prefilter, composite detector, streaming
master, torch backend) on ``device="cpu"``, where the CUDA kernels' wrappers
compute their plain float64/int64 versions, must equal ``repro``'s
``C4DDetector(backend="numpy")`` and NumPy ``C4DMaster``: verdict lists field
for field with scores bit-equal (compared as ``float.hex``), node actions,
and ``AdaptiveBaseline`` arrays bit-equal. The JAX package's detection path
runs here only with its ``enable_x64`` names pointed at
``jax.enable_x64(True)`` (jax 0.9 dropped ``jax.experimental.enable_x64``):
the per-kernel reference path (``analyze_arrays_reference``) is held to the
JAX package's that way, and to the NumPy composite. The CUDA kernels run only
on the card (``-m gpu``): each is held bit-equal to its plain version.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.jaxsim.detectors as jax_detectors
import repro.core.jaxsim.kernels as jax_kernels
import repro.core.jaxsim.waterfill as jax_waterfill
from repro.core.c4d import telemetry as ref_tel
from repro.core.c4d.baseline import AdaptiveBaseline as RefBaseline
from repro.core.c4d.detector import C4DDetector as RefDetector
from repro.core.c4d.detector import DetectorConfig as RefDetectorConfig
from repro.core.c4d.detector import Verdict as RefVerdict
from repro.core.c4d.master import C4DMaster as RefMaster
from repro.core.c4d.master import NodeAction as RefNodeAction
from repro.core.c4d.master import OperatingPoint as RefOperatingPoint
from repro.core.faults import Fault as RefFault
from repro.core.faults import RingJobTelemetry as RefTelemetry
from repro_torch import convert, resolve_device
from repro_torch.core import torchsim
from repro_torch.core.c4d import telemetry as tel
from repro_torch.core.c4d.baseline import AdaptiveBaseline
from repro_torch.core.c4d.detector import C4DDetector, DetectorConfig, Verdict
from repro_torch.core.c4d.master import C4DMaster, NodeAction, OperatingPoint
from repro_torch.core.faults import Fault, RingJobTelemetry
from repro_torch.core.torchsim import detectors as tdet
from repro_torch.core.torchsim import kernels as tk
from repro_torch.kernels import _build, detect_ref, slow_fold, window_score


def _sibling(name):
    """A test module of this directory, loaded from its file (``tests`` may
    name another package where pytest runs)."""
    spec = importlib.util.spec_from_file_location(f"_torch_detect_{name}",
                                                  Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_golden = _sibling("test_c4d_vectorized")
GOLDEN_FAULTS, N = _golden.GOLDEN_FAULTS, _golden.N
#: tests/test_jaxsim.py's PAD_BUCKET_RANKS: three pad buckets of the window
PAD_BUCKET_RANKS = (N, 48, 96)

CPU = "cpu"
OP = dict(mad_threshold=5.0, confirm_streak=2)     # tests/test_jaxsim.py's operating point


def _port_faults(faults):
    return [Fault(f.kind, rank=f.rank, link=f.link, severity=f.severity) for f in faults]


def _vkey(v):
    return (v.syndrome, v.rank, v.link, float(v.score).hex(), v.detail)


def _akey(a):
    return (a.node_id, a.action, [_vkey(v) for v in a.verdicts], tuple(a.culprits))


def _windows(n, seed, faults_seq):
    """The same seeded windows from the reference's telemetry and the port's."""
    rt, pt = RefTelemetry(n_ranks=n, seed=seed), RingJobTelemetry(n_ranks=n, seed=seed)
    return ([rt.window_arrays(i, f) for i, f in enumerate(faults_seq)],
            [pt.window_arrays(i, _port_faults(f)) for i, f in enumerate(faults_seq)])


def _assert_baselines_equal(a, b):
    for attr in ("_mean", "_dev", "_count"):
        for kind in ("delay", "wait", "hb"):
            x, y = getattr(a, attr)[kind], getattr(b, attr)[kind]
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (attr, kind)


# --- copies of the NumPy modules ---------------------------------------------

@pytest.mark.parametrize("faults", GOLDEN_FAULTS)
def test_window_arrays_byte_equal_to_reference(faults):
    (r,), (p,) = _windows(48, 3, [faults])
    for f in ("tr_src", "tr_dst", "tr_bytes", "tr_post", "tr_start", "tr_end", "hb_rank",
              "hb_seq", "hb_t", "op_rank", "op_seq"):
        x, y = getattr(r, f), getattr(p, f)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("ours,theirs", [(Verdict, RefVerdict), (DetectorConfig, RefDetectorConfig),
                                         (OperatingPoint, RefOperatingPoint),
                                         (NodeAction, RefNodeAction)])
def test_copied_dataclasses_have_the_reference_fields(ours, theirs):
    def spec(cls):
        return [(f.name, f.type, f.default if f.default is not dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]
    assert spec(ours) == spec(theirs)


# --- the composite detector and the streaming master ---------------------------

@pytest.mark.parametrize("n", PAD_BUCKET_RANKS)
@pytest.mark.parametrize("faults", GOLDEN_FAULTS)
def test_golden_verdicts_equal_numpy_composite(faults, n):
    (r,), (p,) = _windows(n, 9, [faults])
    want = RefDetector(backend="numpy").analyze(r, n)
    got = C4DDetector(backend="torch", device=CPU).analyze(p, n)
    assert [_vkey(v) for v in got] == [_vkey(v) for v in want]
    # the port's own NumPy composite is the reference's too
    assert [_vkey(v) for v in C4DDetector(backend="numpy").analyze(p, n)] == \
        [_vkey(v) for v in want]


@pytest.mark.parametrize("op", [None, OP])
def test_streaming_master_actions_and_baseline_equal(op):
    faults_seq = [GOLDEN_FAULTS[i % len(GOLDEN_FAULTS)] for i in range(1, 13)]
    # two windows in a row of each slow fault, so that streaks confirm
    faults_seq = [f for pair in zip(faults_seq[::2], faults_seq[::2]) for f in pair]
    ref_wins, port_wins = _windows(N, 5, faults_seq)
    if op is None:
        ref = RefMaster(n_ranks=N, ranks_per_node=8)
        port = C4DMaster(n_ranks=N, ranks_per_node=8, backend="torch", device=CPU)
    else:
        ref = RefMaster.from_operating_point(RefOperatingPoint(**op), n_ranks=N)
        port = C4DMaster.from_operating_point(OperatingPoint(**op), n_ranks=N,
                                              backend="torch", device=CPU)
    acted = 0
    for wid, (rw, pw) in enumerate(zip(ref_wins, port_wins)):
        ra, pa = ref.ingest(rw), port.ingest(pw)
        assert [_akey(a) for a in pa] == [_akey(a) for a in ra], wid
        acted += len(ra)
    assert acted > 0 and len(ref_wins) >= 12
    assert port._pending == ref._pending
    if op is not None:
        _assert_baselines_equal(port.baseline, ref.baseline)
        assert port.node_states() == ref.node_states()


def test_ingest_batch_equals_sequential_ingests():
    faults_seq = [GOLDEN_FAULTS[i % len(GOLDEN_FAULTS)] for i in range(8)]
    ref_wins, port_a = _windows(N, 13, faults_seq)
    _, port_b = _windows(N, 13, faults_seq)
    ref = RefMaster(n_ranks=N, ranks_per_node=8)
    seq = C4DMaster(n_ranks=N, ranks_per_node=8, backend="torch", device=CPU)
    bat = C4DMaster(n_ranks=N, ranks_per_node=8, backend="torch", device=CPU)
    want = [[_akey(a) for a in ref.ingest(w)] for w in ref_wins]
    got_seq = [[_akey(a) for a in seq.ingest(w)] for w in port_a]
    tdet.reset_launch_counts()
    got_bat = [[_akey(a) for a in acts] for acts in bat.ingest_batch(port_b)]
    assert got_bat == got_seq == want
    assert bat._pending == seq._pending == ref._pending
    # CPU tensors: the wrappers computed their plain versions, launching nothing
    assert tdet.launch_counts() == {"window_score": 0, "row_select": 0, "slow_fold": 0}


def test_batched_scorer_on_mixed_layouts_matches_single_windows():
    """Windows of one bucket whose layouts differ (a hang adds a transport)
    stack their layouts; each verdict list equals the one-window path."""
    cfg = DetectorConfig()
    faults_seq = [[], [Fault("comm_hang", rank=3)], [Fault("slow_src", rank=5)],
                  [Fault("crash", rank=7)], [Fault("slow_link", link=(3, 4))]]
    _, wins = _windows(N, 11, faults_seq)
    batched = tdet.score_windows_batched(wins, cfg, n_ranks=N, device=CPU)
    for w, got in zip(wins, batched):
        assert got == tdet.analyze_arrays(w, cfg, n_ranks=N, device=CPU)


def _cut(window, transports: bool, heartbeats: bool):
    """``window`` with its transports and/or heartbeats taken out."""
    kw = {}
    for f in dataclasses.fields(window):
        a = getattr(window, f.name)
        if (f.name.startswith("tr_") and not transports) or \
                (f.name.startswith("hb_") and not heartbeats):
            a = a[:0]
        kw[f.name] = a
    return type(window)(**kw)


EMPTY_CASES = [(False, True), (True, False), (False, False)]


@pytest.mark.parametrize("transports,heartbeats", EMPTY_CASES)
def test_window_without_transports_or_heartbeats(transports, heartbeats):
    """Zero groups or zero heartbeats (kernel shapes G = 0, H = 0), alone and
    batched beside a full window, equal the NumPy composite."""
    (r,), (p,) = _windows(N, 1, [[Fault("slow_src", rank=5)]])
    want = RefDetector(backend="numpy").analyze(_cut(r, transports, heartbeats), N)
    w = _cut(p, transports, heartbeats)
    got = C4DDetector(backend="torch", device=CPU).analyze(w, N)
    assert [_vkey(v) for v in got] == [_vkey(v) for v in want]
    full = RefDetector(backend="numpy").analyze(r, N)
    batched = tdet.score_windows_batched([w, p, w], DetectorConfig(), n_ranks=N, device=CPU)
    assert [[_vkey(v) for v in vs] for vs in batched] == \
        [[_vkey(v) for v in vs] for vs in (want, full, want)]


def test_baseline_taken_over_mid_stream():
    """A port detector continues a reference stream from the reference
    baseline's arrays (``convert.baseline_from_reference``)."""
    faults_seq = [[]] * 4 + [[RefFault("slow_src", rank=5)]] * 4
    ref_wins, port_wins = _windows(N, 21, faults_seq)
    cfg = RefOperatingPoint(**OP).detector_config()
    ref_det, base = RefDetector(cfg, backend="numpy"), RefBaseline(N, half_life=16.0)
    for w in ref_wins[:4]:
        ref_det.analyze(w, N, baseline=base)
    state = dict(n_ranks=base.n, half_life=base.half_life, warm_windows=base.warm_windows,
                 clip_sigma=base.clip_sigma, mean=base._mean, dev=base._dev,
                 count=base._count)
    ours = convert.baseline_from_reference(state)
    _assert_baselines_equal(ours, base)
    det = C4DDetector(OperatingPoint(**OP).detector_config(), backend="torch", device=CPU)
    for rw, pw in zip(ref_wins[4:], port_wins[4:]):
        want = ref_det.analyze(rw, N, baseline=base)
        assert [_vkey(v) for v in det.analyze(pw, N, baseline=ours)] == \
            [_vkey(v) for v in want]
    _assert_baselines_equal(ours, base)


# --- grouped medians and the plain kernels ------------------------------------

@pytest.mark.parametrize("n_keys,size,scale", [(40, 1000, 1.0), (3, 600, 1e3), (500, 4000, 1e-6)])
def test_grouped_median_torch_equals_reference(n_keys, size, scale):
    rng = np.random.default_rng(n_keys)
    keys = rng.integers(0, n_keys, size) * 7919 - 11
    vals = np.abs(rng.normal(size=size)) * scale
    vals[::17] = vals[0]                      # ties
    uk0, m0 = ref_tel.grouped_median(keys, vals, backend="numpy")
    uk1, m1 = tel.grouped_median(keys, vals, backend="torch", device=CPU)
    assert uk0.tobytes() == uk1.tobytes() and m0.tobytes() == m1.tobytes()
    gk, med, counts, valid = tk.grouped_median_kernel(torch.from_numpy(keys),
                                                      torch.from_numpy(vals))
    assert gk[valid].numpy().tobytes() == uk0.tobytes()
    assert med[valid].numpy().tobytes() == m0.tobytes()


@pytest.mark.parametrize("faults", GOLDEN_FAULTS[:6])
def test_matrices_and_prefilter_equal_reference(faults):
    (r,), (p,) = _windows(48, 3, [faults])
    for ref_fn, fn in ((ref_tel.delay_matrix, tel.delay_matrix),
                       (ref_tel.wait_matrix, tel.wait_matrix)):
        want = ref_fn(r, 48, backend="numpy")
        got = fn(p, 48, backend="torch", device=CPU)
        assert want.tobytes() == got.tobytes()
    from repro.core.c4d.agent import prefilter_arrays as ref_prefilter
    from repro_torch.core.c4d.agent import prefilter_arrays
    want = ref_prefilter(r, 8, n_ranks=48)
    got = prefilter_arrays(p, 8, n_ranks=48, backend="torch", device=CPU)
    for f in ("tr_src", "tr_dst", "tr_bytes", "tr_post", "tr_start", "tr_end"):
        assert getattr(want, f).tobytes() == getattr(got, f).tobytes(), f


def _layout(keys):
    lay = tdet._WindowLayout(keys)
    lt = lay.device_tensors(torch.device(CPU))
    return lay, lt


def test_plain_window_kernel_equals_numpy():
    """``fused_window_kernel``'s plain version against the NumPy computation
    of the same arrays: grouped medians, last seqs, the hang median, deficit
    and hang mask, is_src."""
    n = 48
    (r,), (p,) = _windows(n, 4, [[RefFault("comm_hang", rank=7)]])
    lay, lt = _layout(p.tr_src * n + p.tr_dst)
    pw = tdet._PackedWindow(p, n, None)
    offsets = np.random.default_rng(0).uniform(-1, 1, n)
    hb = [torch.from_numpy(a)[None] for a in (pw.hb_rank, pw.hb_seq)]
    res = tk.fused_window_kernel(torch.from_numpy(pw.values)[None], lt["order"], lt["starts"],
                                 lt["counts"], lt["gkey"], *hb,
                                 torch.from_numpy(offsets)[None], 3.0, n=n)
    _, dmed = ref_tel.grouped_median(r.tr_src * n + r.tr_dst,
                                     r.tr_transfer() / np.maximum(r.tr_bytes, 1))
    uk, wmed = ref_tel.grouped_median(r.tr_src * n + r.tr_dst, r.tr_wait())
    assert res["dmed"][0].numpy().tobytes() == dmed.tobytes()
    assert res["wmed"][0].numpy().tobytes() == wmed.tobytes()
    seqs = np.full(n, np.iinfo(np.int64).min)
    np.maximum.at(seqs, r.hb_rank, r.hb_seq)
    present = np.zeros(n, bool)
    present[r.hb_rank] = True
    med = np.median(seqs[present].astype(float))
    deficit = med - seqs.astype(float)
    is_src = np.zeros(n, bool)
    is_src[uk // n] = True
    assert res["seqs"][0].numpy().tobytes() == seqs.tobytes()
    assert float(res["med"][0]) == med
    assert res["deficit"][0].numpy().tobytes() == deficit.tobytes()
    assert (res["hung"][0].numpy() == (present & (deficit - offsets >= 3.0))).all()
    assert (res["present"][0].numpy() == present).all()
    assert (res["is_src"][0].numpy() == is_src).all()
    assert res["hung"][0, 7]


def test_plain_window_kernel_without_heartbeats_reads_inf():
    n = 32
    lay, lt = _layout(np.array([5, 5, 40], np.int64))
    vals = torch.tensor([[[1.0, 2.0, 3.0], [0.5, 0.25, 0.0]]], dtype=torch.float64)
    hb = (torch.zeros((1, 0), dtype=torch.int64),) * 2
    res = tk.fused_window_kernel(vals, lt["order"], lt["starts"], lt["counts"], lt["gkey"],
                                 *hb, torch.zeros((1, n), dtype=torch.float64), 3.0, n=n)
    assert res["dmed"][0].tolist() == [1.5, 3.0] and res["wmed"][0].tolist() == [0.375, 0.0]
    assert float(res["med"][0]) == float("inf") and not res["hung"].any()
    assert res["is_src"][0].nonzero().flatten().tolist() == [0, 1]
    # a group of no samples reads +inf, as the reference's all-+inf row does
    empty = tk.row_median(vals, lt["order"], torch.tensor([[0, 2, 3]]),
                          torch.tensor([[2, 1, 0]]))
    assert empty[0, 0].tolist() == [1.5, 3.0, float("inf")]


def _numpy_fold_max(seg, vals, n):
    """np.maximum.at from -inf, and where its answer depends on the order of
    the groups, the fold's rule: +0.0 over -0.0, and a NaN with the sign bit
    over one without (each case has one NaN of each sign)."""
    out = np.full(n, -np.inf)
    with np.errstate(invalid="ignore"):
        np.maximum.at(out, seg, vals)
    for r in np.unique(seg):
        v = vals[seg == r]
        nans = v[np.isnan(v)]
        if nans.size:
            neg = nans[np.signbit(nans)]
            out[r] = (neg if neg.size else nans)[0]
        elif out[r] == 0:
            out[r] = 0.0 if (~np.signbit(v[v == 0])).any() else -0.0
    return out


@pytest.mark.parametrize("case", detect_ref.FOLD_CASES)
def test_plain_slow_fold_equals_numpy(case):
    """``slow_fold_kernel``'s plain version against a NumPy computation with
    np.add.at / np.maximum.at on inputs that reach the fold's edges
    (``detect_ref.fold_cases``): keys sorted or shuffled, a source's run of
    100 groups, NaN of both signs and +-0.0, batches of windows on shared or
    own keys. Ranks 120-159 source no group and ranks 0-39 receive none, so
    their folds read the identities (-inf, 0)."""
    gkey, dmed, wmed, cd, sd, cw, sw, n = detect_ref.fold_cases(case)
    thr, rcf, min_obs = 1.5, 0.6, 1
    t = [torch.from_numpy(a) for a in (gkey, dmed, wmed, cd, sd, cw, sw)]
    res = {k: v.numpy() for k, v in tk.slow_fold_kernel(*t, thr, rcf, min_obs, n=n).items()}
    for w in range(dmed.shape[0]):
        key = gkey[min(w, gkey.shape[0] - 1)]
        zd = (dmed[w] - cd[w]) / sd[w]
        zw = (wmed[w] - cw[w]) / sw[w]
        src, dst = key // n, key % n
        hot = zd > thr
        for name, seg in (("row", src), ("col", dst)):
            hot_n, obs_n = np.zeros(n, np.int64), np.zeros(n, np.int64)
            np.add.at(hot_n, seg, hot)
            np.add.at(obs_n, seg, 1)
            sel = (obs_n >= min_obs) & (hot_n >= np.maximum(1.0, rcf * obs_n)) & (hot_n >= 2)
            assert res[f"{name}_hot"][w].tobytes() == hot_n.tobytes()
            assert res[f"{name}_obs"][w].tobytes() == obs_n.tobytes()
            assert res[f"{name}_score"][w].tobytes() == _numpy_fold_max(seg, zd, n).tobytes()
            assert (res[f"{name}_sel"][w] == sel).all()
        wmask = (zw > thr) & ~hot
        wscore = np.full(n, -np.inf)
        np.maximum.at(wscore, src[wmask], zw[wmask])
        assert res["wait_score"][w].tobytes() == wscore.tobytes()
        assert (res["wait_sel"][w] == (np.bincount(src[wmask], minlength=n) > 0)).all()
        point = hot & ~res["row_sel"][w][src] & ~res["col_sel"][w][dst]
        assert (res["point"][w] == point).all() and res["zd"][w].tobytes() == zd.tobytes()
        assert np.isneginf(res["row_score"][w][120:]).all() and not res["row_obs"][w][120:].any()
        assert np.isneginf(res["col_score"][w][:40]).all() and not res["col_obs"][w][:40].any()
        assert res["row_sel"][w][2]
    if case == "NaN and signed zeros":
        row = res["row_score"][0]
        assert np.signbit(row[np.isnan(row)]).any()      # a sign-bit NaN won a max
        assert row[7] == 0 and not np.signbit(row[7])    # +0.0 over -0.0
        assert np.isneginf(row[8]) and res["row_obs"][0][8] > 0


def test_fold_key_orders_every_float64_and_inverts():
    """``fold_key`` is a bijection onto int64 that orders -inf lowest, the
    numbers as floats (-0.0 below +0.0) and every NaN above +inf."""
    rng = np.random.default_rng(3)
    bits = np.r_[rng.integers(-2**63, 2**63 - 1, 20000, dtype=np.int64),
                 np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324, -5e-324]).view(np.int64),
                 np.array([0xFFF8000000000001, 0x7FF0000000000001, 0xFFFFFFFFFFFFFFFF],
                          np.uint64).view(np.int64)]
    x = torch.from_numpy(bits).view(torch.float64)
    k = detect_ref.fold_key(x)
    assert torch.equal(detect_ref.from_fold_key(k).view(torch.int64), x.view(torch.int64))
    v = x.numpy()
    fin = ~np.isnan(v)
    assert (np.diff(v[fin][np.argsort(k.numpy()[fin])]) >= 0).all()
    assert k.numpy()[~fin].min() > k.numpy()[v == np.inf].max()
    assert int(detect_ref.fold_key(torch.tensor([-np.inf], dtype=torch.float64))) == -2**63
    zeros = detect_ref.fold_key(torch.tensor([-0.0, 0.0], dtype=torch.float64))
    assert zeros[0] < zeros[1]


def test_row_select_reads_large_groups_and_batches():
    """Groups above a thread's 16 samples (the prefilter's per-node groups)
    and a batch of two windows over one shared layout."""
    rng = np.random.default_rng(2)
    keys = np.repeat(np.arange(5, dtype=np.int64), [1, 33, 320, 64, 2])
    rng.shuffle(keys)
    lay, lt = _layout(keys)
    assert lay.max_count == 320 and lay.large.tolist() == [1, 2, 3]
    vals = np.abs(rng.normal(size=(2, 3, keys.size)))
    out = window_score.row_select(torch.from_numpy(vals), lt["order"], lt["starts"],
                                  lt["counts"], large=lt["large"], max_count=lay.max_count)
    assert out.shape == (3, 2, lay.g)
    for b in range(2):
        for v in range(3):
            _, want = ref_tel.grouped_median(keys, vals[b, v])
            assert out[v, b].numpy().tobytes() == want.tobytes()


#: a NaN with the sign bit and a payload: NumPy sorts it last like any NaN
NEG_NAN = np.array([0xFFF8000000000001], np.uint64).view(np.float64)[0]
#: a group of n samples: key ``g`` repeated n times for each n
_SIZES = lambda *ns: np.repeat(np.arange(len(ns), dtype=np.int64), ns)   # noqa: E731


def _value_case(name):
    """(keys, values) of one parity case; keys in any order, values any float64."""
    rng = np.random.default_rng(len(name))
    if name == "mixed signs":
        keys = rng.integers(0, 60, 4000) * 7919 - 11
        return keys, rng.normal(size=4000) * 10.0 ** rng.integers(-300, 300, 4000)
    if name == "all negative":
        keys = rng.integers(0, 40, 3000)
        return keys, -np.abs(rng.normal(size=3000)) - 1e-9
    if name == "signed zeros, both orders":
        # each group holds -0.0 and +0.0 in both orders; the odd groups'
        # middles are -0.0, the even groups' differ in sign or tie
        vals = [-0.0, 0.0, -0.0,   0.0, -0.0, -0.0,   -0.0, -0.0, 0.0,   0.0, -0.0,
                -0.0, 0.0,   1.0, -0.0, 0.0, -1.0,   0.0, -0.0, 2.0, -0.0, -2.0]
        return _SIZES(3, 3, 3, 2, 2, 4, 5), np.array(vals)
    if name == "NaN of both signs, even and odd groups":
        vals = [np.nan, 1.0, NEG_NAN,   2.0, np.nan, -np.nan, 3.0,   NEG_NAN,
                NEG_NAN, 1.0, 2.0, -np.nan,   5.0, 6.0, np.nan, -1.0, 0.0, 7.0,
                np.nan,   NEG_NAN, -4.0]
        return _SIZES(3, 4, 5, 6, 1, 2), np.array(vals)
    if name == "+-inf":
        vals = [np.inf, -np.inf, 1.0,   -np.inf, -np.inf, np.inf, 0.0,   np.inf, np.inf,
                -np.inf, 2.0, 3.0,   np.inf, np.nan, -np.inf, 0.0, -0.0, 1.0]
        return _SIZES(3, 4, 5, 6), np.array(vals)
    if name == "padding: [1, NaN] beside a group of 3":
        return np.array([0, 1, 0, 1, 1]), np.array([1.0, 3.0, np.nan, 1.0, 2.0])
    if name == "one group of 5,000":
        return np.full(5000, 42), rng.normal(size=5000)
    if name == "one group of 20,000":
        vals = rng.normal(size=20000)
        vals[::97] = -0.0
        vals[1::89] = 0.0
        return np.full(20000, 7), vals
    raise KeyError(name)


VALUE_CASES = ["mixed signs", "all negative", "signed zeros, both orders",
               "NaN of both signs, even and odd groups", "+-inf",
               "padding: [1, NaN] beside a group of 3", "one group of 5,000",
               "one group of 20,000"]


def _same(a, b):
    """float64 arrays bit for bit, any NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all() and
                (a[~nan].view(np.int64) == b[~nan].view(np.int64)).all())


@pytest.mark.parametrize("case", VALUE_CASES)
def test_row_select_takes_any_float64_and_group_size(case):
    """The torch backend's grouped median and the row select's CPU path,
    bit-equal to the reference NumPy fold (a stable lexsort: -0.0 ties +0.0
    in input order, every NaN last in input order)."""
    keys, vals = _value_case(case)
    uk0, m0 = ref_tel.grouped_median(keys, vals, backend="numpy")
    uk1, m1 = tel.grouped_median(keys, vals, backend="torch", device=CPU)
    assert uk0.tobytes() == uk1.tobytes() and _same(m0, m1)
    lay, lt = _layout(keys)
    out = window_score.row_select(torch.from_numpy(vals).view(1, 1, -1), lt["order"],
                                  lt["starts"], lt["counts"], large=lt["large"],
                                  max_count=lay.max_count)
    assert _same(out[0, 0].numpy(), m0)
    # the reference's own formulation from raw keys agrees too
    gk, med, _, valid = tk.grouped_median_kernel(torch.from_numpy(keys.astype(np.int64)),
                                                 torch.from_numpy(vals))
    assert gk[valid].numpy().tobytes() == uk0.tobytes() and _same(med[valid].numpy(), m0)
    if case == "signed zeros, both orders":
        assert np.signbit(m0).any() and (~np.signbit(m0)).any()


def test_row_select_takes_a_batch_of_70000_windows():
    """70,000 one-sample windows over one shared layout in one call (the
    kernel once took at most 65,535): each reads its own sample."""
    rng = np.random.default_rng(70)
    vals = rng.normal(size=70_000) * 1e3
    vals[::7] = -0.0
    vals[3::11] = np.nan
    lay, lt = _layout(np.array([5], np.int64))
    out = window_score.row_select(torch.from_numpy(vals).view(-1, 1, 1), lt["order"],
                                  lt["starts"], lt["counts"], large=lt["large"],
                                  max_count=lay.max_count)
    _, want = ref_tel.grouped_median(np.arange(vals.size), vals, backend="numpy")
    assert out.shape == (1, 70_000, 1) and _same(out[0, :, 0].numpy(), want)


def test_smoke_signed_tier_checks_run_on_cpu(monkeypatch):
    """``chip_smoke.py``'s row-select checks at every tier (signed, zero, NaN
    and infinite samples; 70,000 windows), rehearsed on the CPU: there the
    wrapper is its plain version, and the planted fault (a median by the raw
    int64 bit pattern) must still read unequal at each size."""
    spec = importlib.util.spec_from_file_location(
        "_torch_detect_chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "DEV", CPU)
    assert smoke.signed_tiers() >= 0.0


def test_wrappers_refuse_wrong_dtypes():
    lay, lt = _layout(np.arange(4, dtype=np.int64))
    vals = torch.tensor([[[1.0, -2.0, 2.0, 3.0]]], dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        window_score.row_select(vals.float(), lt["order"], lt["starts"], lt["counts"],
                                large=lt["large"], max_count=lay.max_count)
    z = torch.zeros((1, 16), dtype=torch.float64)
    with pytest.raises(TypeError, match="gkey"):
        slow_fold.slow_fold(z, z, z, z, z, z, z, 5.0, 0.6, 1, n=4)


def _bad_fold_inputs():
    z, k = torch.zeros((2, 6), dtype=torch.float64), torch.zeros((1, 6), dtype=torch.int64)
    return {
        "float32 medians": ((k, z.float(), z, z, z, z, z), 4, TypeError, "dmed"),
        "wmed not 2-d": ((k, z, z[0], z, z, z, z), 4, TypeError, "wmed"),
        "scale_d of another shape": ((k, z, z, z, z[:, :5], z, z), 4, ValueError, "scale_d"),
        "center_w non-contiguous": ((k, z, z, z, z, z.t().contiguous().t(), z), 4, ValueError,
                                    "center_w"),
        "scale_w on another device": ((k, z, z, z, z, z, z.to("meta")), 4, ValueError,
                                      "scale_w"),
        "gkey of another width": ((k[:, :5], z, z, z, z, z, z), 4, ValueError, "gkey"),
        "gkey of 3 windows for 2": ((torch.zeros((3, 6), dtype=torch.int64), z, z, z, z, z, z),
                                    4, ValueError, "gkey"),
        "no ranks": ((k, z, z, z, z, z, z), 0, ValueError, "n=0"),
    }


@pytest.mark.parametrize("case", sorted(_bad_fold_inputs()))
def test_slow_fold_names_what_it_rejects(case):
    """Each rejected input raises the error that names the input and rule."""
    args, n, kind, words = _bad_fold_inputs()[case]
    with pytest.raises(kind, match=words):
        slow_fold.slow_fold(*args, 5.0, 0.6, 1, n=n)


def _negative_waits(window):
    """``window`` with two transports in three started before they were
    posted (wait ``t_start - t_post`` below 0, so most medians are too),
    transfers unchanged."""
    neg = np.arange(window.tr_start.size) % 3 != 0
    wait = window.tr_start - window.tr_post
    start = np.where(neg, window.tr_post - wait - 1e-4, window.tr_start)
    end = window.tr_end - window.tr_start + start
    return dataclasses.replace(window, tr_start=start, tr_end=end)


@pytest.mark.parametrize("faults", [[], [RefFault("slow_src", rank=5)]])
def test_negative_waits_through_prefilter_and_analyze(faults):
    """A window with negative waits (``reports_to_window`` input is not held
    to the telemetry's signs) through the prefilter and the composite: equal
    to the reference NumPy path."""
    from repro.core.c4d.agent import prefilter_arrays as ref_prefilter
    from repro_torch.core.c4d.agent import prefilter_arrays
    (r,), (p,) = _windows(N, 17, [faults])
    r, p = _negative_waits(r), _negative_waits(p)
    assert (p.tr_wait() < 0).any()
    want = ref_prefilter(r, 8, n_ranks=N)
    got = prefilter_arrays(p, 8, n_ranks=N, backend="torch", device=CPU)
    for f in ("tr_src", "tr_dst", "tr_bytes", "tr_post", "tr_start", "tr_end"):
        assert getattr(want, f).tobytes() == getattr(got, f).tobytes(), f
    assert (got.tr_wait() < 0).any()
    for rw, pw in ((r, p), (want, got)):
        ref_v = RefDetector(backend="numpy").analyze(rw, N)
        assert [_vkey(v) for v in C4DDetector(backend="torch", device=CPU).analyze(pw, N)] \
            == [_vkey(v) for v in ref_v]


def test_layout_cache_bounds(monkeypatch):
    monkeypatch.setattr(tdet, "_LAYOUT_CACHE", [])
    monkeypatch.setattr(tdet, "_LAYOUT_CACHE_MAX_ELEMENTS", 1000)
    assert tdet._LAYOUT_CACHE_MAX == 8
    for i in range(12):                                  # the entry bound
        tdet._layout_for(np.arange(10, dtype=np.int64) + 100 * i)
    info = tdet.layout_cache_info()
    assert info["entries"] == 8 and info["max_elements"] == 1000
    big = np.arange(300, dtype=np.int64)                 # 600 elements of the 1000
    tdet._layout_for(big)
    tdet._layout_for(big + 1000)                         # evicts everything behind it
    assert [e.keys[0] for e in tdet._LAYOUT_CACHE] == [1000]
    hits = tdet.layout_cache_info()["hits"]
    assert tdet._layout_for(big + 1000) is tdet._LAYOUT_CACHE[0]
    assert tdet.layout_cache_info()["hits"] == hits + 1
    # equal sizes, other keys: a new layout, never the cached one
    assert tdet._layout_for(big + 2000).keys[0] == 2000


# --- the per-kernel reference path ------------------------------------------------

@pytest.fixture
def x64(monkeypatch):
    """The JAX package's jit kernels on this jax: its ``enable_x64`` names
    call ``jax.enable_x64(True)`` (nothing in ``src/repro`` changes)."""
    jax = pytest.importorskip("jax")
    scope = lambda: jax.enable_x64(True)      # noqa: E731
    for mod in (jax_kernels, jax_waterfill, jax_detectors):
        monkeypatch.setattr(mod, "enable_x64", scope)


@pytest.mark.parametrize("n", PAD_BUCKET_RANKS)
@pytest.mark.parametrize("faults", GOLDEN_FAULTS)
def test_reference_path_equals_jax_reference_and_numpy(faults, n, x64):
    (r,), (p,) = _windows(n, 9, [faults])
    want = RefDetector(backend="numpy").analyze(r, n)
    jit = jax_detectors.analyze_arrays_reference(r, RefDetectorConfig(), n_ranks=n)
    got = tdet.analyze_arrays_reference(p, DetectorConfig(), n_ranks=n, device=CPU)
    assert [_vkey(v) for v in jit] == [_vkey(v) for v in want]
    assert [_vkey(v) for v in got] == [_vkey(v) for v in want]


def test_reference_path_advances_the_baseline_as_numpy(x64):
    """A 12-window stream with an adaptive baseline: verdicts and baseline
    arrays equal to the NumPy composite's and to the JAX reference path's."""
    faults_seq = [GOLDEN_FAULTS[i % len(GOLDEN_FAULTS)] for i in range(1, 13)]
    ref_wins, port_wins = _windows(N, 5, faults_seq)
    cfg = OperatingPoint(**OP).detector_config()
    ref_cfg = RefOperatingPoint(**OP).detector_config()
    numpy_base, jit_base, ours = RefBaseline(N), RefBaseline(N), AdaptiveBaseline(N)
    det = RefDetector(ref_cfg, backend="numpy")
    for rw, pw in zip(ref_wins, port_wins):
        want = [_vkey(v) for v in det.analyze(rw, N, baseline=numpy_base)]
        assert [_vkey(v) for v in jax_detectors.analyze_arrays_reference(
            rw, ref_cfg, n_ranks=N, baseline=jit_base)] == want
        assert [_vkey(v) for v in tdet.analyze_arrays_reference(
            pw, cfg, n_ranks=N, baseline=ours, device=CPU)] == want
    _assert_baselines_equal(ours, numpy_base)
    _assert_baselines_equal(jit_base, numpy_base)


@pytest.mark.parametrize("transports,heartbeats", EMPTY_CASES)
def test_reference_path_without_transports_or_heartbeats(transports, heartbeats):
    (r,), (p,) = _windows(N, 1, [[Fault("slow_src", rank=5)]])
    want = RefDetector(backend="numpy").analyze(_cut(r, transports, heartbeats), N)
    got = tdet.analyze_arrays_reference(_cut(p, transports, heartbeats), DetectorConfig(),
                                        n_ranks=N, device=CPU)
    assert [_vkey(v) for v in got] == [_vkey(v) for v in want]


def _pad(rows, fill, dtype):
    width = max(len(r) for r in rows)
    out = np.full((len(rows), width), fill, dtype)
    for b, r in enumerate(rows):
        out[b, :len(r)] = r
    return torch.from_numpy(out)


def test_batched_twins_equal_a_loop_over_single_windows():
    """Windows of three sizes in one batch, padded as the reference pads
    (PAD_KEY and +inf; heartbeats and sources masked): each row's real part
    equals the unbatched twin on that window alone."""
    n = 48
    wins = [RingJobTelemetry(n_ranks=m, seed=4).window_arrays(
        0, [Fault("comm_hang", rank=3)] if m == 40 else []) for m in (32, 40, 48)]
    keys = [w.tr_src.astype(np.int64) * n + w.tr_dst for w in wins]
    dv = [w.tr_transfer() / np.maximum(w.tr_bytes, 1) for w in wins]
    wv = [w.tr_wait() for w in wins]
    got = tk.batched_pair_median(_pad(keys, detect_ref.PAD_KEY, np.int64),
                                 _pad(dv, np.inf, np.float64), _pad(wv, np.inf, np.float64))
    for b in range(len(wins)):
        one = tk.pair_median(*(torch.from_numpy(a[b]) for a in (keys, dv, wv)))
        t = keys[b].size
        for g, o in zip(got, one):
            assert torch.equal(g[b, :t], o)
        assert not got[5][b, t:].any() and not got[4][b, t:].any()
    rng = np.random.default_rng(3)
    offsets = rng.uniform(0, 1, size=(len(wins), n))
    hb_rank = [w.hb_rank.astype(np.int64) for w in wins]
    hb_seq = [w.hb_seq.astype(np.int64) for w in wins]
    src = [w.tr_src.astype(np.int64) for w in wins]
    valid = [np.ones(len(x), bool) for x in hb_rank]
    svalid = [np.ones(len(x), bool) for x in src]
    got = tk.batched_hang(_pad(hb_rank, 0, np.int64), _pad(hb_seq, 0, np.int64),
                          _pad(valid, False, bool), _pad(src, 0, np.int64),
                          _pad(svalid, False, bool), torch.from_numpy(offsets), 3.0, n=n)
    for b in range(len(wins)):
        one = tk.hang(*(torch.from_numpy(a[b]) for a in (hb_rank, hb_seq, src, offsets)),
                      3.0, n=n)
        for k, v in one.items():
            assert torch.equal(got[k][b], v), k
    assert got["hung"][1].any() and not got["hung"][0].any()


# --- the backend switch and the default device ---------------------------------

def test_backend_registry(monkeypatch):
    monkeypatch.delenv(torchsim.BACKEND_ENV, raising=False)
    assert torchsim.get_default_backend() == "torch"
    with torchsim.use_backend("numpy"):
        assert torchsim.resolve_backend() == "numpy"
    assert torchsim.resolve_backend() == "torch"
    with pytest.raises(torchsim.BackendError):
        torchsim.resolve_backend("jax")
    monkeypatch.setenv(torchsim.BACKEND_ENV, "auto")
    assert torchsim.effective_backend(ranks=torchsim.AUTO_DETECT_RANKS - 1) == "numpy"
    assert torchsim.effective_backend(ranks=torchsim.AUTO_DETECT_RANKS) == "torch"
    assert torchsim.effective_backend(elements=torchsim.AUTO_MEDIAN_ELEMENTS - 1) == "numpy"
    assert torchsim.effective_backend(elements=torchsim.AUTO_MEDIAN_ELEMENTS) == "torch"


def test_torch_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (w,) = _windows(N, 1, [[]])
    for call in (lambda: C4DDetector().analyze(w, N),
                 lambda: C4DMaster(n_ranks=N).ingest(w),
                 lambda: tel.grouped_median(np.arange(3), np.ones(3))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(RuntimeError):
        resolve_device(None)


def test_build_flags_hold_the_detection_kernels_exact():
    for name in ("window_score", "slow_fold"):
        assert name in _build.KERNELS and "--fmad=false" in _build.flags(name)
        assert str(_build._target(name)) != str(_build._target("rmsnorm"))
    assert "--fmad=false" not in _build.flags("rmsnorm")
    src = (_build.CSRC / "window_score.cu").read_text()
    assert f"SMALL_GROUP = {window_score.SMALL_GROUP};" in src
    assert f"WARP_GROUP = {window_score.WARP_GROUP};" in src


# --- on the card only ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bit_equal(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, 16384])
def test_kernels_bit_equal_to_plain_on_card(cuda, n):
    faults = [Fault("slow_src", rank=5), Fault("slow_link", link=(3, 4))]
    w = RingJobTelemetry(n_ranks=n, seed=3).window_arrays(0, faults)
    pw = tdet._PackedWindow(w, n, None)
    lay = pw.layout
    rng = np.random.default_rng(n)
    hb_seq = rng.integers(0, 50, pw.hb_seq.size)       # spread seqs: a real median
    offsets = rng.uniform(0, 2, n)
    host = [pw.values[None], pw.hb_rank[None], hb_seq[None], offsets[None]]
    outs = []
    for dev in (cuda, torch.device(CPU)):
        lt = lay.device_tensors(dev)
        vals, hr, hs, off = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host)
        res = window_score.window_score(vals, lt["order"], lt["starts"], lt["counts"],
                                        lt["gkey"], hr, hs, off, 3.0, n=n, large=lt["large"],
                                        max_count=lay.max_count)
        cs = [torch.from_numpy(a).to(dev)[None] for key, kind in (("dmed", "delay"),
                                                                  ("wmed", "wait"))
              for a in tdet._mixed_center_scale(res[key][0].cpu().numpy(), lay.gkey, n, None,
                                                kind)]
        fold = slow_fold.slow_fold(lt["gkey"], res["dmed"], res["wmed"], *cs, 5.0, 0.6, 1, n=n)
        outs.append((res, fold))
    (res_c, fold_c), (res_p, fold_p) = outs
    for k in res_p:
        assert _bit_equal(res_c[k], res_p[k]), k
    for k in fold_p:
        assert _bit_equal(fold_c[k], fold_p[k]), k
    assert fold_p["row_sel"][0, 5]
    # the prefilter's row select: per-node groups (320 samples) through the CTA path
    keys = w.tr_src // 8
    absdev = np.abs(w.tr_wait() - np.median(w.tr_wait()))
    uk0, m0 = tel.grouped_median(keys, absdev, backend="numpy")
    uk1, m1 = tel.grouped_median(keys, absdev, backend="torch", device=cuda)
    assert uk0.tobytes() == uk1.tobytes() and m0.tobytes() == m1.tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("case", detect_ref.FOLD_CASES)
def test_slow_fold_cases_bit_equal_on_card(cuda, case):
    """The fold kernel on the inputs of ``detect_ref.fold_cases`` (shuffled
    keys, runs across warps, NaN and +-0.0, batches), bit-equal to its plain
    version on the card, and one launch a call."""
    gkey, *vals, n = detect_ref.fold_cases(case)
    args = [torch.from_numpy(a).to(cuda) for a in (gkey, *vals)]
    before = slow_fold.launches
    got = slow_fold.slow_fold(*args, 1.5, 0.6, 1, n=n)
    want = tk.slow_fold_kernel(*args, 1.5, 0.6, 1, n=n)
    assert slow_fold.launches == before + 1
    for k in want:
        assert _bit_equal(got[k], want[k]), k
    assert got["row_sel"][:, 2].all()


@pytest.mark.gpu
@pytest.mark.parametrize("transports,heartbeats", EMPTY_CASES)
def test_card_window_without_transports_or_heartbeats(cuda, transports, heartbeats):
    w = _cut(RingJobTelemetry(n_ranks=N, seed=1).window_arrays(0, [Fault("slow_src", rank=5)]),
             transports, heartbeats)
    want = C4DDetector(backend="numpy").analyze(w, N)
    for got in (C4DDetector(backend="torch").analyze(w, N),
                tdet.score_windows_batched([w, w], DetectorConfig(), n_ranks=N)[1]):
        assert [_vkey(v) for v in got] == [_vkey(v) for v in want]


@pytest.mark.gpu
def test_card_reference_path_equals_numpy_composite(cuda):
    for faults in GOLDEN_FAULTS:
        w = RingJobTelemetry(n_ranks=1024, seed=9).window_arrays(0, faults)
        want = C4DDetector(backend="numpy").analyze(w, 1024)
        got = tdet.analyze_arrays_reference(w, DetectorConfig(), n_ranks=1024, device=cuda)
        assert [_vkey(v) for v in got] == [_vkey(v) for v in want]


@pytest.mark.gpu
def test_card_verdicts_equal_numpy_composite(cuda):
    for faults in GOLDEN_FAULTS:
        w = RingJobTelemetry(n_ranks=1024, seed=9).window_arrays(0, faults)
        want = C4DDetector(backend="numpy").analyze(w, 1024)
        assert [_vkey(v) for v in C4DDetector(backend="torch").analyze(w, 1024)] == \
            [_vkey(v) for v in want]


CARD_GROUP_SIZES = [1, 2, 10, 16, 17, 32, 33, 240, 512, 513, 4096, 4097, 20000]


def _signed_groups(size, rng):
    """Five groups of ``size`` samples, one for each kind of input: mixed
    signs, all negative, signed zeros in both orders, NaN of both signs,
    +-inf among finite values; keys shuffled."""
    mixed = rng.normal(size=size) * 10.0 ** rng.integers(-200, 200, size)
    neg = -np.abs(rng.normal(size=size)) - 1e-12
    zeros = np.where(rng.random(size) < 0.5, -0.0, 0.0)
    zeros[::5] = rng.normal(size=zeros[::5].size)
    nans = rng.normal(size=size)
    nans[rng.random(size) < 0.4] = np.nan
    nans[rng.random(size) < 0.2] = NEG_NAN
    infs = rng.normal(size=size)
    infs[rng.random(size) < 0.3] = np.inf
    infs[rng.random(size) < 0.3] = -np.inf
    keys = np.repeat(np.arange(5, dtype=np.int64) * 1000 - 7, size)
    vals = np.concatenate([mixed, neg, zeros, nans, infs])
    perm = rng.permutation(keys.size)
    return keys[perm], vals[perm]


@pytest.mark.gpu
@pytest.mark.parametrize("size", CARD_GROUP_SIZES)
def test_row_select_tiers_on_card(cuda, size):
    """Every tier of the row select (a thread up to 16 samples, a warp up to
    512, a CTA above) on signed, zero, NaN and infinite samples: equal to its
    plain version and to NumPy, bit for bit (NaN equal to NaN)."""
    keys, vals = _signed_groups(size, np.random.default_rng(size))
    lay = tdet._WindowLayout(keys)
    got = []
    for dev in (cuda, torch.device(CPU)):
        lt = lay.device_tensors(dev)
        v = torch.from_numpy(vals).to(dev).view(1, 1, -1)
        got.append(window_score.row_select(v, lt["order"], lt["starts"], lt["counts"],
                                           large=lt["large"], max_count=lay.max_count))
    card, plain = (g[0, 0].cpu().numpy() for g in got)
    _, want = ref_tel.grouped_median(keys, vals, backend="numpy")
    assert _same(card, plain) and _same(card, want)
    uk, med = tel.grouped_median(keys, vals, backend="torch", device=cuda)
    assert uk.tobytes() == lay.gkey.tobytes() and _same(med, want)


@pytest.mark.gpu
def test_row_select_batch_of_70000_on_card(cuda):
    """70,000 windows in one call over a shared layout of groups of 1, 2, 10,
    17 and 33 samples (thread and warp tiers), signed and NaN samples: equal
    to the plain version on the card."""
    rng = np.random.default_rng(7)
    keys = np.repeat(np.arange(5, dtype=np.int64), [1, 2, 10, 17, 33])
    lay = tdet._WindowLayout(keys[rng.permutation(keys.size)])
    lt = lay.device_tensors(cuda)
    vals = rng.normal(size=(70_000, 1, keys.size))
    vals[rng.random(vals.shape) < 0.05] = np.nan
    vals[rng.random(vals.shape) < 0.05] = -0.0
    v = torch.from_numpy(vals).to(cuda)
    out = window_score.row_select(v, lt["order"], lt["starts"], lt["counts"],
                                  large=lt["large"], max_count=lay.max_count)
    want = tk.row_median(v, lt["order"], lt["starts"], lt["counts"])
    assert out.shape == (1, 70_000, 5) and _same(out.cpu().numpy(), want.cpu().numpy())
