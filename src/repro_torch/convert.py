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

``opt_state_from_jax(state, cfg)`` takes the JAX package's optimizer state
(``repro.optim.adamw.init_state``'s tree, as numpy) and returns the port's
(``repro_torch.optim.adamw.tree_layout``): a stacked leaf's state split into
its layers' rows, or, where the optimizer updates the stack as one, its
factored ``nu_col`` or its 8-bit blocks held by the stack's first layer. With
``params_from_jax`` it gives a port Trainer the reference's training state
(``Trainer.params`` / ``opt_state``). ``opt_state_to_jax(state, cfg, like)``
is its inverse, into the structure of the JAX tree ``like``.

``baseline_from_reference(state)`` carries a detector's state across: it takes
the arrays of a reference ``AdaptiveBaseline`` as numpy and returns the port's
``AdaptiveBaseline`` holding copies of them, so that a port master can take
over a stream mid-way.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.common.config import ModelConfig

STATE_KEYS = frozenset(("mu", "nu", "nu_row", "nu_col", "mu_q", "mu_s", "nu_q", "nu_s"))


def _is_state(val) -> bool:
    """An optimizer state leaf: a dict of the optimizer's tensors."""
    return isinstance(val, dict) and bool(val) and set(val) <= STATE_KEYS


def _flatten(tree: Dict[str, Any], prefix: str = "", leaf=lambda v: not isinstance(v, dict)):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if leaf(val):
            yield name, val
        else:
            yield from _flatten(val, name + ".", leaf)


def _jax_leaves(tree: Dict[str, Any], cfg: ModelConfig, leaf):
    """(path in ``tree``, the port's names, value) for each leaf of a tree
    shaped as the JAX ``LM.init``'s parameters (``leaf`` tells a leaf): a
    stacked leaf's names are its layers, in the order of its units
    (``transformer.stack_positions``); any other leaf's its one name."""
    from repro_torch.models.transformer import stack_positions
    out = [(("final_norm", "scale"), ["final_norm.scale"], tree["final_norm"]["scale"])]
    if "embed" in tree:
        out.append((("embed", "table"), ["embed.table"], tree["embed"]["table"]))
    if "head" in tree:
        out.append((("head",), ["head"], tree["head"]))
    where = stack_positions(cfg)
    for s, seg in enumerate(tree["segments"]):
        for pos, block in seg["shared"].items():
            out += [(("segments", s, "shared", pos, *name.split(".")), [f"shared_attn.{name}"],
                     val) for name, val in _flatten(block, leaf=leaf)]
        for pos, block in seg["unit"].items():
            layers = [i for i, w in enumerate(where) if w == (s, int(pos))]
            out += [(("segments", s, "unit", pos, *name.split(".")),
                     [f"blocks.{i}.{name}" for i in layers], val)
                    for name, val in _flatten(block, leaf=leaf)]
    return out


def params_from_jax(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Each leaf of ``params`` to the one ``LM`` parameter of its name."""
    if sum(len(seg["shared"]) for seg in params["segments"]) > 1:
        raise ValueError("more than one shared block: the port has one")
    state = {}
    for path, names, leaf in _jax_leaves(params, cfg, lambda v: not isinstance(v, dict)):
        if not names[0].startswith("blocks."):
            state[names[0]] = leaf
            continue
        if leaf.shape[0] != len(names):
            raise ValueError(f"{'/'.join(map(str, path))}: {leaf.shape[0]} units, the "
                             f"config's stack has {len(names)}")
        state.update((n, leaf[i]) for i, n in enumerate(names))
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def opt_state_from_jax(state: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX package's optimizer state ({"step", "m"}, numpy leaves) ->
    the port's (``adamw.init_state``'s layout; module docstring)."""
    from repro_torch.models.transformer import LM
    shapes = {n: tuple(p.shape) for n, p in LM(cfg, device="meta").named_parameters()}
    m: Dict[str, Dict[str, Any]] = {}
    for _, names, st in _jax_leaves(state["m"], cfg, _is_state):
        if not names[0].startswith("blocks."):
            m[names[0]] = dict(st)
        elif "mu_q" in st:              # 8-bit: each layer's slice of the blocks, or all
            nb, rest = divmod(math.prod(shapes[names[0]]), st["mu_q"].shape[1])
            if rest:
                m.update({n: {} for n in names})
                m[names[0]] = dict(st)
            else:
                m.update({n: {k: v[i * nb:(i + 1) * nb] for k, v in st.items()}
                          for i, n in enumerate(names)})
        elif "nu_row" in st and np.ndim(st["mu"]) == 2:    # a factored stack of vectors
            m.update({n: {"mu": st["mu"][i], "nu_row": st["nu_row"][i]}
                      for i, n in enumerate(names)})
            m[names[0]]["nu_col"] = st["nu_col"]
        else:
            m.update({n: {k: v[i] for k, v in st.items()} for i, n in enumerate(names)})
    if set(m) != set(shapes):
        raise ValueError(f"the state holds {len(m)} leaves for {len(shapes)} parameters")
    return {"step": _to_torch(state["step"]).to(torch.int32),
            "m": {n: {k: _to_torch(v) for k, v in m[n].items()} for n in shapes}}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def opt_state_to_jax(state: Dict[str, Any], cfg: ModelConfig, like: Dict[str, Any]):
    """The port's optimizer state -> the JAX package's, in the structure of
    the JAX state ``like`` (whose values are not read); numpy leaves, a bf16
    moment widened to float32 (exactly)."""
    m = state["m"]
    out = copy.deepcopy({"m": like["m"]}, memo={id(v): v for _, _, v in
                                               _jax_leaves(like["m"], cfg, _is_state)})["m"]

    def put(path, value):
        node = out
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
    for path, names, _ in _jax_leaves(like["m"], cfg, _is_state):
        sts = [m[n] for n in names]
        if not names[0].startswith("blocks."):
            leaf = {k: _to_numpy(v) for k, v in sts[0].items()}
        elif "mu_q" in sts[0]:
            leaf = {k: np.concatenate([_to_numpy(st[k]) for st in sts]) if all(sts)
                    else _to_numpy(v) for k, v in sts[0].items()}
        elif "nu_col" in sts[0] and sts[0]["nu_row"].dim() == 0:
            leaf = {"mu": np.stack([_to_numpy(st["mu"]) for st in sts]),
                    "nu_row": np.stack([_to_numpy(st["nu_row"]) for st in sts]),
                    "nu_col": _to_numpy(sts[0]["nu_col"])}
        else:
            leaf = {k: np.stack([_to_numpy(st[k]) for st in sts]) for k in sts[0]}
        put(path, leaf)
    return {"step": np.asarray(_to_numpy(state["step"])), "m": out}


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
