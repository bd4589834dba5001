"""Serve steps: prefill and one decode step.

Port of ``make_prefill_step`` / ``make_decode_step`` of ``repro.train.steps``.
The training step is not ported yet. A step updates the KV cache in place and
returns it, so the call sites read like the JAX ones.
"""
from __future__ import annotations


def make_prefill_step(model):
    def prefill(batch, cache):
        logits, cache = model(batch["tokens"], mode="prefill", cache=cache, head="last")
        return logits, cache
    return prefill


def make_decode_step(model):
    def decode(batch, cache, pos: int):
        logits, cache = model(batch["tokens"], mode="decode", cache=cache, pos=pos)
        return logits, cache
    return decode
