"""The port's version gate (``repro_torch.common.torch_compat``) on the CPU.

``parse_version`` is held equal to the JAX package's on that package's own
strings, computed by a JAX child (``_dist.JaxChild``: ``jax_compat``
imported under jax 0.4.37, since its gate refuses this jax), and pinned on
torch's release strings. ``check_supported`` raises below ``MIN_TORCH`` and
only warns, once, above ``NEWEST_TESTED``; ``device_error`` and
``check_device`` are held on both of their branches with the capability and
the CUDA version given or monkeypatched; ``kernels/_build.build_all``
refuses a card before it starts ``nvcc``. Everything is exact (no tolerance).
"""
import json
import os
import warnings

import pytest
import torch

from _dist import JaxChild
from repro_torch.common import torch_compat as tc

JAX_STRINGS = ["0.4.37", "0.5.0.dev20250101", "0.6.1rc1", "0.4.35", "1.0"]
TORCH_STRINGS = {"2.11.0+cu128": (2, 11, 0), "2.13.0+cpu": (2, 13, 0),
                 "2.12.0a0+git3f1e2d4": (2, 12, 0), "2.6.0.dev20250101": (2, 6, 0)}

JAX_SIDE = """
import json
out = {}
for s in STRINGS:
    out[s] = list(jc.parse_version(s))
try:
    jc.parse_version("not-a-version")
except jc.JaxCompatError as e:
    out["garbage"] = type(e).__name__
with open(os.path.join(OUT, "parse.json"), "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_parse(tmp_path_factory):
    child = JaxChild(JAX_SIDE.replace("STRINGS", repr(JAX_STRINGS)),
                     tmp_path_factory.mktemp("compat"), n_devices=1)
    with open(os.path.join(child.result(), "parse.json")) as f:
        return json.load(f)


def test_parse_version_equals_the_jax_packages(jax_parse):
    for s in JAX_STRINGS:
        assert list(tc.parse_version(s)) == jax_parse[s], s
    assert jax_parse["garbage"] == "JaxCompatError"
    with pytest.raises(tc.TorchCompatError, match="cannot parse"):
        tc.parse_version("not-a-version")


@pytest.mark.parametrize("version", sorted(TORCH_STRINGS))
def test_parse_version_reads_torch_release_strings(version):
    assert tc.parse_version(version) == TORCH_STRINGS[version]


@pytest.mark.parametrize("bad", ["2.4.1", "2.0.0+cu118", "1.13.1"])
def test_below_the_minimum_raises_with_the_detected_version(bad):
    with pytest.raises(tc.TorchCompatError) as exc:
        tc.check_supported(bad)
    assert bad in str(exc.value) and "2.5" in str(exc.value)


@pytest.mark.parametrize("good", ["2.5.0", "2.11.0+cu128", "2.13.0+cpu", "2.13.1"])
def test_inside_the_range_passes_silently(good):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tc.check_supported(good) == tc.parse_version(good)


def test_above_the_newest_tested_warns_once_and_does_not_raise(monkeypatch):
    monkeypatch.setattr(tc, "_WARNED", set())
    with pytest.warns(UserWarning, match="2.14.0.*newer"):
        assert tc.check_supported("2.14.0") == (2, 14, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tc.check_supported("2.14.0") == (2, 14, 0)
        with pytest.warns(UserWarning, match="3.0.0"):
            tc.check_supported("3.0.0")


def test_installed_torch_is_supported():
    v = tc.check_supported()
    assert v >= tc.MIN_TORCH and v == tc.parse_version(torch.__version__)


@pytest.mark.parametrize("capability, cuda, reason", [
    ((9, 0), "12.8", None),
    ((9, 0), "12.0", None),
    ((8, 0), "12.8", "capability (8, 0)"),
    ((10, 0), "12.8", "capability (10, 0)"),
    ((9, 0), "11.8", "CUDA 11.8"),
    ((9, 0), None, "without CUDA"),
])
def test_device_error(capability, cuda, reason):
    err = tc.device_error(capability, cuda)
    if reason is None:
        assert err is None
    else:
        assert reason in err


def test_check_device_reads_the_card_and_torch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (9, 0))
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    assert tc.check_device(0) == (9, 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (8, 0))
    with pytest.raises(tc.TorchCompatError, match="CUDA device 1: .*capability"):
        tc.check_device(1)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (9, 0))
    monkeypatch.setattr(torch.version, "cuda", "11.8")
    with pytest.raises(tc.TorchCompatError, match="CUDA 11.8"):
        tc.check_device(0)


def test_build_refuses_the_card_before_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    started = []
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", lambda *a, **k: started.append(a))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (8, 0))
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    with pytest.raises(tc.TorchCompatError, match="sm_90a"):
        _build.build_all(["rmsnorm"])
    assert not started
