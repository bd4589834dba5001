"""The ``roc_smoke`` ROC sweep on the port against the JAX package's.

``repro_torch.scenarios.precision.run_sweep`` replays each trial's window
stream through a fresh C4D master a grid point, at the port's default
backend (``torch``; on the CPU the detection kernels' plain versions,
reached through the wrappers that launch the CUDA kernels on the card). Its
report, selected operating point and summary must equal the JAX package's
``run_sweep`` (NumPy) on the shipped ``roc_smoke``: 4 trials of 130 windows,
the reference and 18 grid points. Kept apart from
``tests/test_torch_campaigns.py`` because the two sweeps take about two
minutes on the CPU.
"""
import dataclasses
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from repro.scenarios import precision as ref_precision
from repro_torch.core.torchsim import BACKEND_ENV
from repro_torch.kernels import slow_fold, window_score
from repro_torch.scenarios import precision


def test_roc_smoke_sweep_equals_the_reference(monkeypatch):
    calls = Counter()
    for mod, entry in ((window_score, "window_score"), (window_score, "row_select"),
                       (slow_fold, "slow_fold")):
        real = getattr(mod, entry)

        def wrapper(*args, _real=real, _name=entry, **kw):
            calls[(_name, args[0].device.type)] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, entry, wrapper)
    monkeypatch.delenv(BACKEND_ENV, raising=False)

    want = ref_precision.run_sweep(ref_precision.get("roc_smoke"))
    got = precision.run_sweep(precision.get("roc_smoke"), device="cpu")
    assert got.to_json() == want.to_json()
    assert got.selected == want.selected and got.meets_targets == want.meets_targets
    assert dataclasses.asdict(precision.selected_operating_point(got)) == \
        dataclasses.asdict(ref_precision.selected_operating_point(want))
    assert got.summary_lines() == want.summary_lines()
    assert set(calls) == {(k, "cpu") for k in ("window_score", "row_select", "slow_fold")}, calls
