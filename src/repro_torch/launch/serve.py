"""Serving entry point: prefill + batched greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --prompt-len 4352 --decode-steps 32 --batch 2
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch gemma2-2b --smoke --device cpu --batch 4 --data 2

Port of ``repro.launch.serve``: the same flags and JSON keys, plus
``--device`` (default ``cuda``; ``cpu`` only when asked) and the kernels'
launch counts. ``--data``/``--model`` above 1 serve on a (data, model) mesh
over data x model ranks (``torchrun``): the parameters replicated (every rank
draws them from the same seed), each data rank prefilling and decoding its
rows of the batch, and rank 0 printing the JSON over the gathered tokens. A
MoE model's decode step routes the batch as one group, so on a mesh each
data rank's rows are a group of their own. ``serve(..., mesh,
sharded=True)`` serves as the JAX package's dry run places a serve step
(``lower_cell``): the weights on this rank's shards under ``param_specs``
(``build_sharded``, with the ``zero_rules``), the caches on its shards under
``cache_spec`` (the cache length rounded up to a multiple of ``model``: the
sequence over ``model``), each layer computed on its shard
(``parallel.tensor``, ``models/attention.py``). Unlike the JAX entry point, which builds
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

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.config import RunConfig, ShapeSpec
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import DTYPES, build_model, synthetic_batch
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.train.steps import (batch_coordinate, local_batch, make_decode_step,
                                     make_prefill_step, mark_batch)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(run: RunConfig, *, batch: int = 2, prompt_len: int = 64, decode_steps: int = 16,
          device=None, seed: int = 0, use_kernel: bool = True, mesh=None,
          sharded: bool = False) -> Dict[str, Any]:
    """Prefill ``batch`` synthetic prompts, then ``decode_steps`` greedy steps.
    ``kernel_launches`` counts the timed prefill and decode steps only.

    Returns the JSON fields of the CLI plus ``tokens`` (B, decode_steps + 1)
    and ``prefill_logits`` (B, 1, vocab) float32, both on the CPU, and
    ``weight_bytes`` (the bytes of the model's parameters). With a ``mesh``
    this rank serves its rows of the batch (all of it where the batch axes
    do not divide it), and ``tokens`` and ``prefill_logits`` are gathered
    over the ranks: every rank returns the whole batch's. With ``sharded``
    the weights and caches are this rank's shards (module docstring); the
    draws are the one-device model's."""
    dev = resolve_device(device)
    if sharded:
        if mesh is None:
            raise ValueError("sharded serving needs a mesh")
        model = build_model(run, device="meta", use_kernel=use_kernel)
        attn_zero, moe_zero = shd.zero_rules(run, mesh)
        tensor.build_sharded(model, mesh, torch.Generator(device=dev).manual_seed(seed),
                             attn_zero=attn_zero, moe_zero=moe_zero)
    else:
        model = build_model(run, device=dev, use_kernel=use_kernel)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    shape = ShapeSpec("serve", prompt_len, batch, "prefill")
    prompt = synthetic_batch(run.model, shape, seed=1, device=dev)
    if mesh is not None:
        if sharded:
            mark_batch(model.tp, batch, 1, batch_coordinate(mesh)[1])
        prompt = local_batch(prompt, 1, *batch_coordinate(mesh))
        batch = next(iter(prompt.values())).shape[0]
    cache_len = prompt_len + decode_steps
    if sharded:
        cache_len = shd.serve_cache_len(cache_len, mesh)
    cache = model.init_cache(batch, cache_len, dtype=DTYPES[run.parallel.param_dtype])
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
    cache = model.init_cache(batch, cache_len, dtype=DTYPES[run.parallel.param_dtype])
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
    prefill_logits = prefill_logits.float().cpu()
    if mesh is not None and batch_coordinate(mesh)[1] > 1:
        toks, prefill_logits = _gather_rows(mesh, toks, prefill_logits)
    launches = {k: v - launches0[k] for k, v in kops.launch_counts().items()}
    return {
        "arch": run.model.name,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": toks.shape[0] * decode_steps / max(t_decode, 1e-9),
        "sampled_tokens_head": toks[:, :8].tolist(),
        "kernel_launches": launches,
        "tokens": toks,
        "prefill_logits": prefill_logits,
        "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
    }


def _gather_rows(mesh, toks, logits):
    """Every rank's rows, in the order of the batch: one rank of each batch
    coordinate (ranks along ``model`` hold the same rows)."""
    import torch.distributed as dist
    mine = (*batch_coordinate(mesh), toks, logits)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, mine)
    by_coord = {r: (t, lg) for r, n, t, lg in rows}
    if len(by_coord) == 1:                  # a replicated batch
        return toks, logits
    order = sorted(by_coord)
    return (np.concatenate([by_coord[r][0] for r in order]),
            torch.cat([by_coord[r][1] for r in order]))


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
    mesh = None
    if args.data * args.model > 1:
        try:
            mesh = make_local_mesh(args.data, args.model, device=args.device)
        except (RuntimeError, ValueError) as e:
            ap.error(str(e))

    run = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    res = serve(run, batch=args.batch, prompt_len=args.prompt_len,
                decode_steps=args.decode_steps, device=args.device, mesh=mesh)
    if mesh is not None and mesh.get_rank() != 0:
        return
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
