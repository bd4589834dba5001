"""Serving entry point: prefill + batched greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --prompt-len 4352 --decode-steps 32 --batch 2

Port of ``repro.launch.serve``: the same flags and JSON keys, plus
``--device`` (default ``cuda``; ``cpu`` only when asked) and the kernels'
launch counts. One device, no mesh. Unlike the JAX entry point, which builds
its model with ``use_kernel=False``, this one serves through the CUDA kernels.
Weights are random, drawn from a ``torch.Generator`` with a fixed seed. For
the audio family the prompt is frame embeddings and every decode step feeds a
zero frame (the stub front end, as in the JAX entry point); the greedy tokens
are then codebook ids. For the vlm family the prompt carries image
embeddings, and so does every decode step. The timed prefill starts from a
zero cache, as the JAX entry point's one prefill does.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.common.config import RunConfig, ShapeSpec
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels import ops as kops
from repro_torch.models.model import DTYPES, build_model, synthetic_batch
from repro_torch.train.steps import make_decode_step, make_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(run: RunConfig, *, batch: int = 2, prompt_len: int = 64, decode_steps: int = 16,
          device=None, seed: int = 0, use_kernel: bool = True) -> Dict[str, Any]:
    """Prefill ``batch`` synthetic prompts, then ``decode_steps`` greedy steps.
    ``kernel_launches`` counts the timed prefill and decode steps only.

    Returns the JSON fields of the CLI plus ``tokens`` (B, decode_steps + 1)
    and ``prefill_logits`` (B, 1, vocab) float32, both on the CPU, and
    ``weight_bytes`` (the bytes of the model's parameters)."""
    dev = resolve_device(device)
    model = build_model(run, device=dev, use_kernel=use_kernel)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    shape = ShapeSpec("serve", prompt_len, batch, "prefill")
    prompt = synthetic_batch(run.model, shape, seed=1, device=dev)
    cache = model.init_cache(batch, prompt_len + decode_steps,
                             dtype=DTYPES[run.parallel.param_dtype])
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    # every decode step carries the prompt's image embeddings (vlm)
    extra = {"vision_embed": prompt["vision_embed"]} if "vision_embed" in prompt else {}
    if "embeddings" in prompt:  # audio: a zero frame a step (stub front end)
        frame = torch.zeros((batch, 1, run.model.d_model), dtype=model.param_dtype, device=dev)

        def step_batch(tokens):
            return {"embeddings": frame, **extra}
    else:
        def step_batch(tokens):
            return {"tokens": tokens[:, None], **extra}
    # one untimed prefill and decode step first, so that the times below are
    # those of a warm server (library handles, allocator, kernel loading)
    logits, cache = prefill(prompt, cache)
    if decode_steps:
        decode(step_batch(torch.argmax(logits[:, -1], dim=-1).to(torch.int32)), cache,
               prompt_len)
    # then a fresh cache: a recurrent block's prefill starts from the state in
    # its cache, which the warm-up left at the end of its decode step
    del cache
    cache = model.init_cache(batch, prompt_len + decode_steps,
                             dtype=DTYPES[run.parallel.param_dtype])
    launches0 = kops.launch_counts()

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(prompt, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    tokens = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out_tokens = [tokens]
    t0 = time.perf_counter()
    for i in range(decode_steps):
        logits, cache = decode(step_batch(tokens), cache, prompt_len + i)
        tokens = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        out_tokens.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks = torch.stack(out_tokens, dim=1).cpu().numpy()
    launches = {k: v - launches0[k] for k, v in kops.launch_counts().items()}
    return {
        "arch": run.model.name,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * decode_steps / max(t_decode, 1e-9),
        "sampled_tokens_head": toks[:, :8].tolist(),
        "kernel_launches": launches,
        "tokens": toks,
        "prefill_logits": prefill_logits.float().cpu(),
        "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; there is no automatic CPU fallback")
    args = ap.parse_args(argv)
    if args.data != 1 or args.model != 1:
        ap.error("the port serves on one device: --data and --model must be 1")

    run = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    res = serve(run, batch=args.batch, prompt_len=args.prompt_len,
                decode_steps=args.decode_steps, device=args.device)
    print(json.dumps({
        "arch": res["arch"],
        "device": res["device"],
        "prefill_s": round(res["prefill_s"], 4),
        "decode_s": round(res["decode_s"], 4),
        "decode_tok_per_s": round(res["decode_tok_per_s"], 1),
        "sampled_tokens_head": res["sampled_tokens_head"],
        "kernel_launches": res["kernel_launches"],
    }, indent=1))


if __name__ == "__main__":
    main()
