"""Convert the JAX package's parameters into an ``LM`` state dict.

``params_from_jax(params, cfg)`` takes the JAX ``LM.init`` tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the dict to pass to
``LM.load_state_dict``. The JAX tree stacks the weights of each segment on a
leading units axis: ``params["segments"][s]["unit"][str(pos)]`` holds the
block at position ``pos`` of every unit of segment ``s``, and
``["shared"][str(pos)]`` a block whose one weight set every unit applies
(zamba2's attention block, unstacked). Here the units are unstacked, in order
of application, into ``blocks.<layer>`` (a unit's positions in order, the
units in order, the segments in order: deepseek's dense segment and then its
MoE segment, zamba2's units and then its tail), and a shared block goes to
``shared_attn``. Weights keep the JAX ``(in, out)`` orientation: the port
computes ``x @ w`` as the JAX package does, so nothing is transposed. Every
leaf lands on one parameter of the same name: ``embed`` (absent for the audio
family) and ``head`` (an untied read-out) where present, the qk norms, the MLA
and MoE leaves, a cross block's ``xattn.*`` and ``ffn_gate``, a recurrent
block's ``cell.*``.

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
    """Each leaf of ``params`` to the one ``LM`` parameter of its name."""
    state = {"final_norm.scale": params["final_norm"]["scale"]}
    if "embed" in params:
        state["embed.table"] = params["embed"]["table"]
    if "head" in params:
        state["head"] = params["head"]
    shared = [block for seg in params["segments"] for block in seg["shared"].values()]
    if len(shared) > 1:
        raise ValueError(f"{len(shared)} shared blocks: the port has one")
    for block in shared:
        state.update((f"shared_attn.{name}", leaf) for name, leaf in _flatten(block))
    layer = 0
    for seg in params["segments"]:
        stacks = {pos: list(_flatten(block)) for pos, block in seg["unit"].items()}
        n_units = next(iter(stacks.values()))[0][1].shape[0]
        for name, stacked in (leaf for leaves in stacks.values() for leaf in leaves):
            if stacked.shape[0] != n_units:
                raise ValueError(f"{name}: {stacked.shape[0]} units, the segment has {n_units}")
        positions = sorted(stacks, key=int)
        for u in range(n_units):
            for pos in positions:
                for name, stacked in stacks[pos]:
                    state[f"blocks.{layer}.{name}"] = stacked[u]
                layer += 1
    if layer != cfg.n_layers:
        raise ValueError(f"the segments hold {layer} layers for {cfg.n_layers}")
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
