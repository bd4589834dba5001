"""The serving slice of the port against the JAX package, on the CPU.

The JAX ``LM`` (``use_kernel=False``, fp32) is initialised from a key, its
parameters are converted with ``repro_torch.convert``, and both packages
prefill the same ``synthetic_batch`` and then decode greedily past the smoke
window of 16 tokens. ``repro.models.transformer.shard_activations`` is patched
to the identity: on this jax it fails without a mesh, and with no mesh it
returns its input unchanged anyway.

Logit tolerance 1e-4 (atol = rtol): both sides run in fp32, so they differ
only by the order of sums, which four layers and the soft-caps grow from
~1e-6 to ~1e-5 at most. Greedy tokens must be equal.
"""
import collections
import dataclasses
import functools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

import repro.configs as jax_configs
import repro.models.model as jax_model
import repro.models.moe as jax_moe
import repro.models.transformer as jax_transformer
from repro.common.config import ShapeSpec as JaxShapeSpec
from repro_torch.common.config import ShapeSpec
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_mod
from repro_torch.models.model import build_model, synthetic_batch
from repro_torch.train.steps import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
PROMPT, STEPS, BATCH = 12, 12, 2        # decode positions 12..23 cross the window of 16


@pytest.fixture
def no_shard(monkeypatch):
    monkeypatch.setattr(jax_transformer, "shard_activations", lambda x: x)
    monkeypatch.setattr(jax_moe, "_maybe_shard", lambda x, spec: x)


def _gated(params, seed=3):
    """``params`` with every cross-attention ``gate`` and ``ffn_gate`` drawn
    from N(0, 1): at the JAX init they are zero and a cross block is the
    identity. Other trees come back unchanged."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(0, 1, a.shape), a.dtype)
        if path[-1].key in ("gate", "ffn_gate") else a, params)


def _fp32(run):
    return run.replace(parallel=dataclasses.replace(run.parallel, param_dtype="float32"))


def _as_bits(a):
    """The bytes of a torch or JAX array, bf16 included."""
    a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 \
        else np.asarray(a)
    return a.tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_matches_jax_through_decode_past_the_window(arch, no_shard):
    """Token models decode their greedy tokens; the audio family decodes a
    zero frame a step, as the JAX entry point's stub front end does; the vlm
    family's steps carry the prompt's image embeddings, its gates non-zero."""
    jcfg = jax_configs.get_smoke_config(arch).model
    jm = jax_transformer.LM(jcfg, param_dtype=jnp.float32, remat="none", use_kernel=False)
    params = _gated(jm.init(jax.random.key(0)))
    run = _fp32(get_smoke_config(arch))
    model = build_model(run, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), run.model))

    jbatch = jax_model.synthetic_batch(jcfg, JaxShapeSpec("p", PROMPT, BATCH, "prefill"), seed=1)
    tbatch = synthetic_batch(run.model, ShapeSpec("p", PROMPT, BATCH, "prefill"), seed=1,
                             device="cpu")
    assert tbatch.keys() == jbatch.keys()
    for key in jbatch:
        assert _as_bits(tbatch[key]) == _as_bits(jbatch[key]), key
    audio = "embeddings" in jbatch

    max_len = PROMPT + STEPS
    jcache = jm.init_cache(BATCH, max_len, dtype=jnp.float32)
    tcache = model.init_cache(BATCH, max_len, dtype=torch.float32)
    jprefill = jax.jit(functools.partial(jm.forward, mode="prefill", head="last"))
    jdecode = jax.jit(lambda p, b, c, pos: jm.forward(p, b, mode="decode", cache=c, pos=pos))
    tprefill, tdecode = make_prefill_step(model), make_decode_step(model)
    frame = np.zeros((BATCH, 1, jcfg.d_model), np.float32)

    jl, _, jcache = jprefill(params, jbatch, cache=jcache)
    tl, tcache = tprefill(tbatch, tcache)
    assert tl.shape == (BATCH, 1, run.model.vocab_size)
    for i in range(STEPS + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"step {i}")
        jtok = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        ttok = torch.argmax(tl[:, -1], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok, err_msg=f"step {i}")
        if i == STEPS:
            break
        jstep = {"embeddings": jnp.asarray(frame)} if audio else {
            "tokens": jnp.asarray(jtok)[:, None]}
        tstep = {"embeddings": torch.from_numpy(frame)} if audio else {"tokens": ttok[:, None]}
        if "vision_embed" in jbatch:
            jstep["vision_embed"], tstep["vision_embed"] = jbatch["vision_embed"], tbatch[
                "vision_embed"]
        jl, _, jcache = jdecode(params, jstep, jcache, jnp.asarray(PROMPT + i, jnp.int32))
        tl, tcache = tdecode(tstep, tcache, PROMPT + i)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_prefill_equals_a_one_shot_jax_prefill(arch, no_shard, monkeypatch):
    """``serve`` runs an untimed prefill and decode step first, then the timed
    prefill; its logits equal the JAX entry point's one prefill from a zero
    cache (the same weights, the gates non-zero). A recurrent block's prefill
    starts from the state in its cache, so this holds only because the timed
    prefill gets a fresh cache: from the warm-up's cache, zamba2's and
    xlstm's logits would start from the warm-up's final state."""
    jcfg = jax_configs.get_smoke_config(arch).model
    jm = jax_transformer.LM(jcfg, param_dtype=jnp.float32, remat="none", use_kernel=False)
    params = _gated(jm.init(jax.random.key(2)))
    run = _fp32(get_smoke_config(arch))
    model = build_model(run, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), run.model))
    model.init_weights = lambda generator: model          # keep the JAX weights
    monkeypatch.setattr(serve_mod, "build_model", lambda run, device, use_kernel: model)
    res = serve_mod.serve(run, batch=BATCH, prompt_len=PROMPT, decode_steps=3, device="cpu")
    jbatch = jax_model.synthetic_batch(jcfg, JaxShapeSpec("s", PROMPT, BATCH, "prefill"), seed=1)
    want, _, _ = jm.forward(params, jbatch, mode="prefill", head="last",
                            cache=jm.init_cache(BATCH, PROMPT + 3, dtype=jnp.float32))
    np.testing.assert_allclose(res["prefill_logits"].numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_head_full_matches_head_last():
    run = _fp32(get_smoke_config("gemma2-2b"))
    model = build_model(run, device="cpu").init_weights(torch.Generator().manual_seed(0))
    tokens = synthetic_batch(run.model, ShapeSpec("p", 20, 2, "prefill"), device="cpu")["tokens"]
    full, _ = model(tokens, mode="prefill", cache=model.init_cache(2, 20, torch.float32))
    last, _ = model(tokens, mode="prefill", cache=model.init_cache(2, 20, torch.float32),
                    head="last")
    assert full.shape == (2, 20, run.model.vocab_size)
    torch.testing.assert_close(full[:, -1:], last)
    with pytest.raises(ValueError, match="mode"):
        model(tokens, mode="train", cache=model.init_cache(2, 20, torch.float32))


def test_serve_cli_on_cpu_prints_the_jax_keys(capsys):
    serve_mod.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                    "--prompt-len", "20", "--decode-steps", "4"])
    out = json.loads(capsys.readouterr().out)
    assert {"arch", "prefill_s", "decode_s", "decode_tok_per_s",
            "sampled_tokens_head"} <= set(out)
    assert out["device"] == "cpu"
    assert out["kernel_launches"] == {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0}
    assert np.asarray(out["sampled_tokens_head"]).shape == (2, 5)


@pytest.mark.parametrize("arch", ["yi-34b", "stablelm-12b", "musicgen-medium"])
def test_serve_cli_serves_the_dense_and_audio_archs_on_cpu(arch, capsys):
    serve_mod.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "20",
                    "--decode-steps", "4"])
    out = json.loads(capsys.readouterr().out)
    assert {"arch", "prefill_s", "decode_s", "decode_tok_per_s",
            "sampled_tokens_head"} <= set(out)
    assert out["arch"] == get_smoke_config(arch).model.name
    toks = np.asarray(out["sampled_tokens_head"])
    assert toks.shape == (2, 5)
    assert 0 <= toks.min() and toks.max() < get_smoke_config(arch).model.vocab_size


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "zamba2-7b", "xlstm-125m"])
def test_serve_cli_serves_the_vision_hybrid_and_recurrent_archs_on_cpu(arch, capsys):
    serve_mod.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "20",
                    "--decode-steps", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == get_smoke_config(arch).model.name
    toks = np.asarray(out["sampled_tokens_head"])
    assert toks.shape == (2, 5)
    assert 0 <= toks.min() and toks.max() < get_smoke_config(arch).model.vocab_size
    assert out["kernel_launches"] == {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0}


def test_serve_is_deterministic_for_a_seed():
    run = get_smoke_config("smollm-135m")
    a = serve_mod.serve(run, prompt_len=16, decode_steps=3, device="cpu", seed=5)
    b = serve_mod.serve(run, prompt_len=16, decode_steps=3, device="cpu", seed=5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    torch.testing.assert_close(a["prefill_logits"], b["prefill_logits"])


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")


def test_entry_points_raise_without_gpu_at_default_device(no_cuda):
    run = get_smoke_config("gemma2-2b")
    shape = ShapeSpec("p", 8, 1, "prefill")
    for call in (lambda: serve_mod.serve(run, prompt_len=8, decode_steps=1),
                 lambda: build_model(run),
                 lambda: synthetic_batch(run.model, shape),
                 lambda: serve_mod.main(["--arch", "gemma2-2b", "--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(no_cuda, where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=script.parent, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _smoke_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("_torch_serve_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# (profiled windows: one call, then 10 calls; device ms of one call, None, or
# SystemExit where the run must fail)
DEVICE_MS_CASES = {
    "every window recorded": ([{"k_a": (2, 4.0), "Memset": (1, 1.0)}, {"k_a": (20, 40.0)}],
                              0.004),
    "a launch dropped": ([{"k_a": (2, 4.0)}, {"k_a": (18, 36.0)}], 0.004),
    "the single call dropped": ([{}, {"k_a": (20, 40.0), "k_b": (10, 30.0)}], 0.007),
    "every window dropped": ([{}, {}], None),
    "a kernel missing from the name list": ([{"k_a": (1, 2.0), "k_new": (1, 1.0)},
                                             {"k_a": (10, 20.0), "k_new": (10, 10.0)}],
                                            SystemExit),
}


@pytest.mark.parametrize("case", sorted(DEVICE_MS_CASES))
def test_chip_smoke_device_time_per_launch(case, monkeypatch):
    """``device_ms``: each kernel's mean a launch times the launches of one
    call; windows the profiler dropped read as such, not as time; a launched
    kernel that is in no name list fails the run."""
    smoke = _smoke_module()
    windows, want = DEVICE_MS_CASES[case]
    windows = list(windows)
    monkeypatch.setattr(smoke, "_profiled", lambda fn, calls: windows.pop(0))
    if want is SystemExit:
        with pytest.raises(SystemExit):
            smoke.device_ms(lambda: None, 10, ("k_a", "k_b"))
        return
    got = smoke.device_ms(lambda: None, 10, ("k_a", "k_b"))
    assert got == pytest.approx(want) if want is not None else got is None
    assert not windows


BF16, FP32 = "bfloat16", "float32"
# kind, q and k shapes, dtype, the kernels a call launched (profiler) -> the run fails
PATH_CASES = {
    "stablelm-12b flash on wgmma": ("flash", (1, 8, 32, 160), (1, 8, 8, 160), BF16,
                                    {"flash_wgmma_kernel": 1}, False),
    "stablelm-12b flash on the CUDA cores": ("flash", (1, 8, 32, 160), (1, 8, 8, 160), BF16,
                                             {"flash_fwd_kernel": 1}, True),
    "stablelm-12b decode on the TMA kernel": ("decode", (1, 1, 32, 160), (1, 8, 8, 160), BF16,
                                              {"decode_tma_kernel": 1}, False),
    "stablelm-12b decode on split-K": ("decode", (1, 1, 32, 160), (1, 8, 8, 160), BF16,
                                       {"decode_partial_kernel": 1, "decode_combine_kernel": 1},
                                       True),
    "fp32 at 160 on the CUDA cores": ("flash", (1, 8, 32, 160), (1, 8, 8, 160), FP32,
                                      {"flash_fwd_kernel": 1}, False),
    "bf16 at 320 on split-K": ("decode", (1, 1, 8, 320), (1, 8, 4, 320), BF16,
                               {"decode_partial_kernel": 1, "decode_combine_kernel": 1}, False),
    "group 16 in two passes": ("decode", (1, 1, 32, 128), (1, 8, 2, 128), BF16,
                               {"decode_tma_kernel": 2}, False),
    "group 16 in one launch": ("flash", (1, 8, 32, 128), (1, 8, 2, 128), BF16,
                               {"flash_wgmma_kernel": 1}, True),
    "nothing recorded": ("flash", (1, 8, 32, 112), (1, 8, 8, 112), BF16, {}, True),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_chip_smoke_path_check_holds_the_profile_to_the_dispatch_rule(case):
    """``path_check``: a timed attention row fails unless the kernels one
    call launched are those the wrappers' rule names for its shape, once a
    group pass each; at stablelm-12b's head_dim 160 that is the wgmma flash
    and the TMA decode, never a CUDA-core or split-K kernel."""
    smoke = _smoke_module()
    kind, q_shape, k_shape, dtype, calls, fails = PATH_CASES[case]
    q = torch.empty(q_shape, dtype=getattr(torch, dtype))
    k = torch.empty(k_shape, dtype=getattr(torch, dtype))
    if fails:
        with pytest.raises(SystemExit):
            smoke.path_check(case, kind, q, k, calls)
    else:
        smoke.path_check(case, kind, q, k, calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_counts_the_launches_of_a_forward(arch, monkeypatch):
    """``norms_per_forward`` and ``attention_applications``, from which the
    card's exact launch counts are derived, against the norm and flash calls
    of one prefill of the smoke model (zamba2's shared block once a unit,
    the cross and recurrent blocks' two norms each); ``mixer_outputs``
    records one output a block application and leaves no patch behind."""
    from repro_torch.kernels import ops
    smoke = _smoke_module()
    calls = collections.Counter()
    for name in ("rmsnorm", "flash_attention"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, real=real, name=name, **kw:
                            calls.update([name]) or real(*a, **kw))
    run = _fp32(get_smoke_config(arch))
    model = build_model(run, device="cpu").init_weights(torch.Generator().manual_seed(0))
    batch = synthetic_batch(run.model, ShapeSpec("p", 8, 1, "prefill"), device="cpu")
    records = []
    with smoke.mixer_outputs(model, records):
        make_prefill_step(model)(batch, model.init_cache(1, 8, torch.float32))
    assert calls["rmsnorm"] == smoke.norms_per_forward(run.model)
    assert calls["flash_attention"] == smoke.attention_applications(run.model)
    assert len(records) == sum(k != "cross" for k in model.kinds)
    assert not any(name in vars(m) for m in model.modules()
                   for name in ("forward_aux", "prefill", "decode"))


FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    assert FORBIDDEN.search("from repro.kernels import ref") and FORBIDDEN.search("import jax")
    assert not FORBIDDEN.search("from repro_torch.kernels import ref")
