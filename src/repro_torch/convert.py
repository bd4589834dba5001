"""Convert the JAX package's parameters into an ``LM`` state dict.

``params_from_jax(params, cfg)`` takes the JAX ``LM.init`` tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the dict to pass to
``LM.load_state_dict``. The JAX tree stacks the weights of the dense segment on
a leading units axis (``params["segments"][0]["unit"]["0"]``); here that axis
is unstacked into ``blocks.<layer>``. Weights keep the JAX ``(in, out)``
orientation: the port computes ``x @ w`` as the JAX package does, so nothing is
transposed. The tree's ``embed`` (absent for the audio family) and ``head``
(an untied read-out) are carried across where present, and so are the qk
norms' ``attn.q_norm.scale`` / ``attn.k_norm.scale``, per layer like every
block weight.

``baseline_from_reference(state)`` carries a detector's state across: it takes
the arrays of a reference ``AdaptiveBaseline`` as numpy and returns the port's
``AdaptiveBaseline`` holding copies of them, so that a port master can take
over a stream mid-way.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.common.config import ModelConfig


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def params_from_jax(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    segments = params["segments"]
    if len(segments) != 1 or set(segments[0]["unit"]) != {"0"} or segments[0]["shared"]:
        raise ValueError("only a single dense segment (one block per unit) is ported")
    state = {"final_norm.scale": params["final_norm"]["scale"]}
    if "embed" in params:
        state["embed.table"] = params["embed"]["table"]
    if "head" in params:
        state["head"] = params["head"]
    for name, stacked in _flatten(segments[0]["unit"]["0"]):
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"{name}: {stacked.shape[0]} units for {cfg.n_layers} layers")
        for layer in range(cfg.n_layers):
            state[f"blocks.{layer}.{name}"] = stacked[layer]
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def baseline_from_reference(state: Dict[str, Any]):
    """``state``: ``n_ranks``, ``half_life``, ``warm_windows``, ``clip_sigma``
    and the ``mean``, ``dev`` and ``count`` dicts (by kind: ``delay``,
    ``wait``, ``hb``) of a reference ``AdaptiveBaseline``, as numpy arrays.
    Returns the port's ``AdaptiveBaseline`` with copies of those arrays."""
    from repro_torch.core.c4d.baseline import AdaptiveBaseline
    base = AdaptiveBaseline(int(state["n_ranks"]), half_life=float(state["half_life"]),
                            warm_windows=int(state["warm_windows"]),
                            clip_sigma=float(state["clip_sigma"]))
    for attr, dtype in (("mean", np.float64), ("dev", np.float64), ("count", np.int64)):
        ours = getattr(base, f"_{attr}")
        for kind, arr in state[attr].items():
            arr = np.asarray(arr)
            if kind not in ours or arr.shape != ours[kind].shape:
                raise ValueError(f"{attr}[{kind!r}]: shape {arr.shape}, expected "
                                 f"{ours[kind].shape if kind in ours else 'no such kind'}")
            ours[kind] = arr.astype(dtype, copy=True)
    return base
