"""Convert the JAX package's parameters into an ``LM`` state dict.

``params_from_jax(params, cfg)`` takes the JAX ``LM.init`` tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the dict to pass to
``LM.load_state_dict``. The JAX tree stacks the weights of each segment on a
leading units axis (``params["segments"][i]["unit"]["0"]``: one segment, or
deepseek's dense segment and then its MoE segment); here the segments' units
are unstacked, in order, into ``blocks.<layer>``. Weights keep the JAX ``(in, out)``
orientation: the port computes ``x @ w`` as the JAX package does, so nothing is
transposed. The tree's ``embed`` (absent for the audio family) and ``head``
(an untied read-out) are carried across where present, and so are the qk
norms' ``attn.q_norm.scale`` / ``attn.k_norm.scale``, the MLA leaves
(``attn.w_dkv``, ``w_krope``, ``w_uk``, ``w_uv``, ``wo``, ``kv_norm.scale``,
``w_dq``, ``w_uq``, ``q_norm.scale`` or ``w_q``) and the MoE leaves
(``moe.router``, ``moe.wi_*``, ``moe.wo``, ``moe.shared.*``,
``moe.dense_residual.*``), per layer like every block weight.

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
    """Each leaf of ``params`` to the one ``LM`` parameter of its shape."""
    state = {"final_norm.scale": params["final_norm"]["scale"]}
    if "embed" in params:
        state["embed.table"] = params["embed"]["table"]
    if "head" in params:
        state["head"] = params["head"]
    layer_start = 0
    for seg in params["segments"]:
        if set(seg["unit"]) != {"0"} or seg["shared"]:
            raise ValueError("only segments of one block a unit, with no shared block, "
                             "are ported")
        leaves = list(_flatten(seg["unit"]["0"]))
        n_units = leaves[0][1].shape[0]
        for name, stacked in leaves:
            if stacked.shape[0] != n_units:
                raise ValueError(f"{name}: {stacked.shape[0]} units, the segment has {n_units}")
            for u in range(n_units):
                state[f"blocks.{layer_start + u}.{name}"] = stacked[u]
        layer_start += n_units
    if layer_start != cfg.n_layers:
        raise ValueError(f"the segments hold {layer_start} layers for {cfg.n_layers}")
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
