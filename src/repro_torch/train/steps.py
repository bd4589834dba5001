"""Train and serve steps.

Port of ``repro.train.steps``. ``make_train_step`` builds the BSP superstep:
microbatched gradient accumulation, global-norm clipping, the schedule and
the optimizer update. ``make_prefill_step`` / ``make_decode_step`` build the
serving path; they run under ``torch.no_grad`` and update the KV cache in
place and return it, so the call sites read like the JAX ones.

The port runs on one device, so there is no cross-pod reduction and the
int8-compressed one (``grad_compression="int8"``) is not ported.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.common.config import RunConfig
from repro_torch.models.model import DTYPES, lm_loss
from repro_torch.optim import adamw


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int) -> List[Dict[str, torch.Tensor]]:
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"global batch {b} does not split into {k} microbatches")
    return [{name: v[i * (b // k):(i + 1) * (b // k)] for name, v in batch.items()}
            for i in range(k)]


def make_grad_fn(model, run: RunConfig):
    """Returns accumulate(params, batch) -> (loss, metrics, grads), the
    gradient half of the train step. ``params`` is
    ``dict(model.named_parameters())``. With k = ``microbatches`` > 1 the
    gradients of the k microbatches are summed in ``grad_accum_dtype`` and
    divided by k, and the loss is the mean; the metrics are the last
    microbatch's. With k = 1 the gradients keep the parameters' dtype."""
    k = max(run.parallel.microbatches, 1)
    acc_dtype = DTYPES[run.parallel.grad_accum_dtype]

    def grads_of(params, batch):
        for p in params.values():       # no gradient left by an earlier backward
            p.grad = None
        loss, metrics = lm_loss(model, batch)
        loss.backward()
        grads = {}
        for name, p in params.items():
            grads[name], p.grad = p.grad, None
        return loss.detach(), {m: v.detach() for m, v in metrics.items()}, grads

    def accumulate(params, batch):
        if k == 1:
            return grads_of(params, batch)
        acc = {n: torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
               for n, p in params.items()}
        loss_sum = 0.0
        for one in _split_microbatches(batch, k):
            loss, metrics, g = grads_of(params, one)
            for n, a in acc.items():
                a += g[n].to(acc_dtype)
            del g
            loss_sum = loss_sum + loss
        for a in acc.values():        # in place: the accumulator is the gradient
            a /= k
        return loss_sum / k, metrics, acc

    return accumulate


def make_train_step(model, run: RunConfig, opt_cfg: adamw.OptimizerConfig):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is ``dict(model.named_parameters())``: the step writes the
    update into those tensors in place and returns the same dict. The
    metrics are those of ``make_grad_fn`` (the last microbatch's, as in the
    JAX package) plus ``grad_norm`` (before clipping) and ``lr``."""
    pcfg, tcfg = run.parallel, run.train
    if pcfg.grad_compression == "int8":
        raise NotImplementedError(
            "int8 gradient compression is not ported: it belongs to parallel/compression.py "
            "(ROADMAP.md, Queue 1, \"parallel/ and launch/mesh.py on torch.distributed\")")
    if pcfg.grad_compression != "none":
        raise ValueError(f"grad_compression {pcfg.grad_compression!r}")
    accumulate = make_grad_fn(model, run)

    def step(params, opt_state, batch):
        _, metrics, grads = accumulate(params, batch)
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip_norm)
        lr = adamw.warmup_cosine(opt_state["step"], base_lr=tcfg.learning_rate,
                                 warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads, opt_state, lr)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return step


def make_prefill_step(model):
    @torch.no_grad()
    def prefill(batch, cache):
        logits, cache = model(batch["tokens"], mode="prefill", cache=cache, head="last")
        return logits, cache
    return prefill


def make_decode_step(model):
    @torch.no_grad()
    def decode(batch, cache, pos: int):
        logits, cache = model(batch["tokens"], mode="decode", cache=cache, pos=pos)
        return logits, cache
    return decode
