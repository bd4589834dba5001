"""Sharding rules: parameter, batch and cache specs, and their placements.

Port of ``repro.parallel.sharding``, in two layers:

  * pure functions of (name, shape, mesh axis sizes) that return a spec: a
    tuple with one entry a tensor dim, ``None`` (replicated), a mesh axis
    name, or a tuple of axis names (major to minor), as a ``PartitionSpec``
    lists them. A test needs no process group for these;
  * ``placements`` / ``shard_tensor``, which turn a spec into DTensor
    placements on a ``DeviceMesh`` and cut a full tensor into this rank's
    shard.

Logical axes: ``fsdp`` (the ZeRO-3 axis, ``data``, or ``("pod", "data")``
with ``fsdp_over_pod``), ``tp`` (``model``: heads, FFN hidden, experts,
vocab), ``dp`` (the batch, ``("pod", "data")``). A dim the mesh does not
divide falls back to a prefix of its axes, then to replication, and one mesh
axis shards at most one dim of a tensor.

Names are the port's parameter names (``blocks.3.attn.wq``), matched with
``.`` read as ``/``. The port keeps one tensor a layer, so a rule is aligned
to the trailing dims as the JAX package aligns it to a stacked leaf, and the
spec is that of the JAX leaf without its leading units dim.

``mesh`` in the pure layer is a ``DeviceMesh``, a mapping of axis name to
size in mesh order, or any object with ``axis_names`` and a ``shape``
mapping.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Spec = Tuple  # one entry a dim: None, an axis name, or a tuple of axis names

LOGICAL_TO_MESH = {
    "fsdp": ("data",),
    "fsdp_pod": ("pod", "data"),
    "tp": ("model",),
    "dp": ("pod", "data"),
    None: None,
}

# (path regex, logical spec per dim). First match wins. The JAX package's
# rules, read against the port's names with "." as "/" (``blocks/3/attn/wq``);
# the leading None of a stacked rule is the units dim the port does not have.
PARAM_RULES: List[Tuple[str, Optional[Tuple]]] = [
    (r"embed/table$",            ("tp", "fsdp")),
    (r"^head$",                  ("fsdp", "tp")),
    (r"final_norm",              (None,)),
    # --- attention ---
    (r"attn/wq$",                (None, "fsdp", "tp")),
    (r"attn/wk$",                (None, "fsdp", "tp")),
    (r"attn/wv$",                (None, "fsdp", "tp")),
    (r"attn/wo$",                (None, "tp", "fsdp")),
    (r"attn/(q_norm|k_norm)",    (None, None)),
    # --- MLA ---
    (r"attn/w_dkv$",             (None, "fsdp", None)),
    (r"attn/w_krope$",           (None, "fsdp", None)),
    (r"attn/w_uk$",              (None, None, "tp")),
    (r"attn/w_uv$",              (None, None, "tp")),
    (r"attn/w_dq$",              (None, "fsdp", None)),
    (r"attn/w_uq$",              (None, None, "tp")),
    (r"attn/kv_norm",            (None, None)),
    # --- cross attention ---
    (r"xattn/wq$",               (None, "fsdp", "tp")),
    (r"xattn/w[kv]$",            (None, "fsdp", "tp")),
    (r"xattn/wo$",               (None, "tp", "fsdp")),
    (r"xattn/gate$",             (None,)),
    # --- dense MLP ---
    (r"mlp/wi_(gate|up)$",       (None, "fsdp", "tp")),
    (r"mlp/wo$",                 (None, "tp", "fsdp")),
    # --- MoE (experts over tp = EP) ---
    (r"moe/router$",             (None, "fsdp", None)),
    (r"moe/wi_(gate|up)$",       (None, "tp", "fsdp", None)),
    (r"moe/wo$",                 (None, "tp", None, "fsdp")),
    (r"moe/(shared|dense_residual)/wi_(gate|up)$", (None, "fsdp", "tp")),
    (r"moe/(shared|dense_residual)/wo$",           (None, "tp", "fsdp")),
    # --- mamba2 ---
    (r"cell/in_proj$",           (None, "fsdp", "tp")),
    (r"cell/conv_w$",            (None, None, "tp")),
    (r"cell/conv_b$",            (None, "tp")),
    (r"cell/out_proj$",          (None, "tp", "fsdp")),
    (r"cell/(A_log|dt_bias|D)$", (None, "tp")),
    # --- mLSTM / sLSTM ---
    (r"cell/up$",                (None, "fsdp", "tp")),
    (r"cell/w[qkv]$",            (None, "fsdp", "tp")),
    (r"cell/wif$",               (None, "fsdp", None)),
    (r"cell/down$",              (None, "tp", "fsdp")),
    (r"cell/w$",                 (None, "fsdp", "tp")),
    (r"cell/r$",                 (None, None, "tp", None, None)),
    (r"cell/out$",               (None, "fsdp", "tp")),
    (r"cell/(b|if_bias)$",       (None, None)),
    # --- everything else (norm scales, gates, biases) replicated ---
    (r".*",                      None),
]

ATTN_W_RE = re.compile(r"attn/w[qkvo]$")
MOE_W_RE = re.compile(r"moe/(wi_(gate|up)|wo)$")
# ZeRO-style expert weights: the non-contracted dim over fsdp
MOE_ZERO_SPEC = (None, "tp", None, "fsdp")
BATCH_AXES = ("pod", "data")


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if hasattr(mesh, "axis_names"):
        return {a: int(mesh.shape[a]) for a in mesh.axis_names}
    return dict(mesh)


def _path(name: str) -> str:
    return name.replace(".", "/")


def _resolve(logical, sizes: Dict[str, int], dim: int, fsdp_over_pod: bool):
    if logical is None:
        return None
    if logical == "fsdp" and fsdp_over_pod and "pod" in sizes:
        logical = "fsdp_pod"
    axes = tuple(a for a in LOGICAL_TO_MESH[logical] if a in sizes)
    # the whole tuple, else its longest prefix that divides the dim
    for k in range(len(axes), 0, -1):
        if dim % math.prod(sizes[a] for a in axes[:k]) == 0:
            return axes[:k] if k > 1 else axes[0]
    return None


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _dedupe(shape, logical, sizes, fsdp_over_pod) -> Spec:
    """Resolve each dim; a mesh axis already used by an earlier dim leaves
    the later dim replicated."""
    used: set = set()
    out = []
    for dim, lg in zip(shape, logical):
        r = _resolve(lg, sizes, dim, fsdp_over_pod)
        if any(a in used for a in _axes_of(r)):
            out.append(None)
            continue
        used.update(_axes_of(r))
        out.append(r)
    return tuple(out)


def spec_for_path(name: str, shape: Sequence[int], mesh, fsdp_over_pod: bool = False,
                  rules=PARAM_RULES) -> Spec:
    sizes = mesh_sizes(mesh)
    path = _path(name)
    for pattern, logical in rules:
        if re.search(pattern, path):
            if logical is None:
                return (None,) * len(shape)
            nl, nd = len(logical), len(shape)
            logical = (None,) * (nd - nl) + tuple(logical) if nl < nd else tuple(logical[nl - nd:])
            return _dedupe(shape, logical, sizes, fsdp_over_pod)
    return (None,) * len(shape)


def param_specs(shapes: Dict[str, Sequence[int]], mesh, fsdp_over_pod: bool = False,
                attn_zero: bool = False, moe_zero: bool = False) -> Dict[str, Spec]:
    """A spec a parameter. ``shapes``: {name: shape or tensor}. ``attn_zero``
    shards an attention projection's input dim over data x model and nothing
    else; ``moe_zero`` shards an expert tensor's non-contracted dim over
    fsdp (``repro.parallel.sharding.param_specs``)."""
    sizes = mesh_sizes(mesh)
    both = tuple(a for a in ("data", "model") if a in sizes)
    total = math.prod(sizes[a] for a in both)
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape.shape if isinstance(shape, torch.Tensor) else shape)
        path = _path(name)
        if attn_zero and ATTN_W_RE.search(path) and len(shape) >= 2 and shape[-2] % total == 0:
            out[name] = (None,) * (len(shape) - 2) + (both, None)
        elif moe_zero and MOE_W_RE.search(path) and len(shape) >= 3:
            out[name] = _dedupe(shape, MOE_ZERO_SPEC[-len(shape):], sizes, fsdp_over_pod)
        else:
            out[name] = spec_for_path(name, shape, mesh, fsdp_over_pod)
    return out


BLOCK_KEYS = ("mu_q", "mu_s", "nu_q", "nu_s")
FACTORED_KEYS = ("nu_row", "nu_col")


def stacked(name: str) -> bool:
    """The JAX package stacks every block's parameter with its segment's
    other units on a leading units dim; the port keeps one tensor a layer
    (``transformer.stacked_leaves`` names the stack)."""
    return name.startswith("blocks.")


def opt_state_specs(specs: Dict[str, Spec], state: Dict[str, Dict]) -> Dict[str, Dict[str, Spec]]:
    """The spec of each optimizer state tensor: the JAX package's
    ``opt_state_shardings``, which gives a state leaf its parameter's spec
    where the leaf has the parameter's rank and replicates the rest, read
    against the JAX leaf (``stacked``: one rank more than the port's, its
    spec the port's after a units dim). ``specs``: each parameter's spec;
    ``state``: ``adamw.init_state(...)["m"]`` (tensors or shapes), in the
    port's layout (``adamw.tree_layout``).

    So a moment of the parameter's shape, or a layer's row of the stacked
    leaf's (``adamw``'s two, the factored ``mu``, a per-layer scalar's
    ``mu`` and ``nu``), takes the spec. The factored ``nu_row`` and
    ``nu_col`` are whole: they have one rank less than their leaf in the JAX
    package, whether a layer holds its rows or the first layer of a stack of
    vectors holds the leaf's ``nu_col``. The 8-bit blocks (n, block) are
    2-D, and take the JAX leaf's spec where that leaf is 2-D: an unstacked
    matrix (the embedding, an untied read-out), or a stack of per-layer
    vectors, (None,) then the vector's spec, whether its first layer holds
    the blocks of every layer or each layer a slice of them. The spec is
    the JAX package's even where its axes do not divide a block tensor's dim
    (an (n, 1) scale); ``fit_spec`` places it."""
    out = {}
    for name, leaf in state.items():
        spec = tuple(specs[name])
        jax_spec = ((None,) + spec) if stacked(name) else spec
        out[name] = {}
        for key, t in leaf.items():
            shape = tuple(t.shape) if isinstance(t, torch.Tensor) else tuple(t)
            if key in BLOCK_KEYS:
                out[name][key] = jax_spec if len(jax_spec) == 2 else (None,) * len(shape)
            elif key in FACTORED_KEYS or len(shape) != len(spec):
                out[name][key] = (None,) * len(shape)
            else:
                out[name][key] = spec
    return out


def fit_spec(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """``spec`` with each dim's axes cut to the longest prefix whose sizes
    divide the dim, as the parameter rules resolve a dim. The JAX package's
    jit refuses an argument whose spec does not divide its dim; where the
    optimizer rule names such axes (an 8-bit (n, 1) scale over ``data``),
    the port holds that dim whole on each rank, which is also what GSPMD's
    padded layout of a size-one dim stores on every device."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        axes = _axes_of(entry)
        k = len(axes)
        while k and dim % math.prod(sizes[a] for a in axes[:k]):
            k -= 1
        out.append(None if not k else axes[0] if k == 1 else axes[:k])
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's shard of ``shape`` under ``spec`` (whose axes divide it)."""
    sizes = mesh_sizes(mesh)
    return tuple(d // math.prod(sizes[a] for a in _axes_of(e)) for d, e in zip(shape, spec))


def spec_of(placement: list, mesh, ndim: int) -> Spec:
    """The spec of DTensor placements (``placements``' inverse)."""
    from torch.distributed.tensor import Shard
    dims: List[List[str]] = [[] for _ in range(ndim)]
    for name, pl in zip(mesh_sizes(mesh), placement):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not d else d[0] if len(d) == 1 else tuple(d) for d in dims)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh_sizes(mesh))


def batch_spec(shape: Sequence[int], mesh) -> Spec:
    """The leading (global batch) dim over pod x data when they divide it."""
    sizes = mesh_sizes(mesh)
    dp = batch_axes(mesh)
    total = math.prod(sizes[a] for a in dp)
    spec = [None] * len(shape)
    if len(shape) >= 1 and total > 1 and shape[0] % total == 0:
        spec[0] = dp if len(dp) > 1 else dp[0]
    return tuple(spec)


def batch_specs(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, Spec]:
    return {k: batch_spec(tuple(v.shape), mesh) for k, v in batch.items()}


def zero_rules(run, mesh) -> Tuple[bool, bool]:
    """(attn_zero, moe_zero) of ``run`` (a ``RunConfig``) on ``mesh`` by the
    JAX package's rule (``lower_cell``): ``attn_zero_sharding`` "on", or
    "auto" where the heads do not divide the ``model`` size and the model has
    no MLA; ``moe_zero`` where ``moe_weight_sharding`` is "zero"."""
    az = run.parallel.attn_zero_sharding
    tp = mesh_sizes(mesh).get("model", 1)
    attn_zero = az == "on" or (az == "auto" and run.model.n_heads % tp != 0
                               and run.model.mla is None)
    return attn_zero, run.parallel.moe_weight_sharding == "zero"


def cache_spec(shape: Sequence[int], mesh) -> Spec:
    """A cache leaf of one block application, (B, ...state): the batch over
    pod x data when they divide it; the largest state dim that ``model``
    divides over ``model`` (kv heads when they divide, else the sequence),
    the later dim on a tie; a leaf under two dims replicated."""
    sizes = mesh_sizes(mesh)
    dp = batch_axes(mesh)
    dp_total = math.prod(sizes[a] for a in dp)
    tp = sizes.get("model", 1)
    spec: List = [None] * len(shape)
    if len(shape) < 2:
        return tuple(spec)
    if shape[0] % dp_total == 0 and dp_total > 1:
        spec[0] = dp if len(dp) > 1 else dp[0]
    if tp > 1:
        cands = [(shape[i], i) for i in range(1, len(shape))
                 if shape[i] % tp == 0 and shape[i] >= tp]
        if cands:
            spec[max(cands)[1]] = "model"
    return tuple(spec)


def serve_cache_len(max_len: int, mesh) -> int:
    """A serve cache's length on a mesh: ``max_len`` rounded up to a multiple
    of the ``model`` size, so that ``cache_spec`` puts ``model`` on the
    sequence, as it does at every shape of the JAX package's grid (the keys
    past the position being decoded are masked)."""
    tp = mesh_sizes(mesh).get("model", 1)
    return -(-max_len // tp) * tp


def cache_specs(cache: list, mesh) -> list:
    """``LM.init_cache``'s list with each tensor replaced by its spec."""
    return [None if c is None else type(c)(*(cache_spec(tuple(t.shape), mesh) for t in c))
            for c in cache]


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """One DTensor placement a mesh dim: ``Shard(d)`` where the spec names
    the axis at dim d, else ``Replicate()``. Several axes on one dim must be
    in mesh order (JAX's major-to-minor order is then DTensor's)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def shard_tensor(full: torch.Tensor, mesh, placement: list):
    """The DTensor whose local tensor is this rank's own copy of its shard of
    ``full`` (every rank holds the same ``full``; nothing is sent)."""
    from torch.distributed.tensor import DTensor, Shard
    local = full
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placement):
        if isinstance(pl, Shard):
            local = local.chunk(mesh.mesh.shape[i], dim=pl.dim)[coord[i]]
    return DTensor.from_local(local.clone(), mesh, placement)


def param_placements(params: Dict[str, torch.Tensor], mesh, **kw) -> Dict[str, list]:
    return {n: placements(s, mesh) for n, s in param_specs(params, mesh, **kw).items()}
