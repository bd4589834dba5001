"""Convert the JAX package's parameters into an ``LM`` state dict.

``params_from_jax(params, cfg)`` takes the JAX ``LM.init`` tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the dict to pass to
``LM.load_state_dict``. The JAX tree stacks the weights of the dense segment on
a leading units axis (``params["segments"][0]["unit"]["0"]``); here that axis
is unstacked into ``blocks.<layer>``. Weights keep the JAX ``(in, out)``
orientation: the port computes ``x @ w`` as the JAX package does, so nothing is
transposed.
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
    state = {"embed.table": params["embed"]["table"],
             "final_norm.scale": params["final_norm"]["scale"]}
    for name, stacked in _flatten(segments[0]["unit"]["0"]):
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"{name}: {stacked.shape[0]} units for {cfg.n_layers} layers")
        for layer in range(cfg.n_layers):
            state[f"blocks.{layer}.{name}"] = stacked[layer]
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
