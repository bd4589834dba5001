"""The tensor-parallel collectives (``repro_torch.parallel.tensor``) on a gloo
(data 2, model 2) mesh of four spawned ranks (``_dist.run_world``), forward
and backward, exactly (small integers in fp32):

  * ``copy_in`` (Megatron's f): identity forward, the gradient summed over
    ``model`` backward; ``reduce_out`` (g): the sum over ``model`` forward,
    identity backward;
  * ``gather_batch``: a shard whole over ``data``, the gradient
    reduce-scattered back (summed over ``data``); ``whole``: whole over both
    axes, the gradient summed over ``data`` and this rank's slice over
    ``model``, or with ``partial`` summed over ``model`` too; ``gather_model``
    over ``model`` alone;
  * ``batch_mean``: the mean over the batch ranks, and the gradient summed
    over them; ``full`` and ``shard``: a stored shard whole and back.

Each rank's input is a function of its coordinate, so the expected values
are computed here in NumPy.
"""
import json
import os

import numpy as np
import pytest
import torch

from _dist import run_world

HERE = os.path.abspath(__file__)
SPEC = ("data", "model")          # a (4, 6) whole tensor, rows over data, columns over model
WHOLE = np.arange(24, dtype=np.float32).reshape(4, 6)
OPS = ("copy_in", "reduce_out", "gather_batch", "whole", "whole_partial", "gather_model",
       "batch_mean", "full_shard")


def _x(d, m):
    """A rank's small input: its coordinate in every element."""
    return np.full((2, 3), 10 * d + m + 1, dtype=np.float32)


def ranks(rank, world, out):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.tensor import TensorParallel
    mesh = make_local_mesh(2, 2, device="cpu")
    tp = TensorParallel(mesh)
    d, m = tp.coord["data"], tp.coord["model"]
    res = {"coord": [d, m]}

    def shard():
        p = torch.from_numpy(WHOLE[2 * d:2 * d + 2, 3 * m:3 * m + 3].copy()).requires_grad_()
        p.tp_spec = SPEC
        return p

    def run(name, fn, x):
        y = fn(x)
        # a weight that differs by rank, so each rank's gradient is its own
        (y * (1 + rank)).sum().backward()
        res[name] = {"y": y.detach().tolist(), "grad": x.grad.tolist()}

    run("copy_in", tp.copy_in, torch.from_numpy(_x(d, m)).requires_grad_())
    run("reduce_out", tp.reduce_out, torch.from_numpy(_x(d, m)).requires_grad_())
    run("gather_batch", tp.gather_batch, shard())
    run("whole", tp.whole, shard())
    run("whole_partial", lambda p: tp.whole(p, partial=True), shard())
    run("gather_model", lambda x: tp.gather_model(x, 1),
        torch.from_numpy(_x(d, m)).requires_grad_())
    run("batch_mean", tp.batch_mean, torch.from_numpy(_x(d, m)).requires_grad_())
    full = tp.full(torch.from_numpy(WHOLE[2 * d:2 * d + 2, 3 * m:3 * m + 3].copy()), SPEC)
    res["full_shard"] = {"full": full.tolist(), "back": tp.shard(full, SPEC).tolist()}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = run_world(f"{HERE}:ranks", 4, tmp_path_factory.mktemp("tp"))
    res = {}
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            got = json.load(f)
        res[tuple(got["coord"])] = dict(got, rank=r)
    return res


def _expected(op, d, m, w):
    """(forward, gradient) on the rank at (d, m); ``w[(d, m)]`` is each
    rank's weight on its output (1 + its rank)."""
    shard = WHOLE[2 * d:2 * d + 2, 3 * m:3 * m + 3]
    ones = np.ones((2, 3), np.float32)
    if op == "copy_in":
        return _x(d, m), ones * sum(w[(d, k)] for k in range(2))
    if op == "reduce_out":
        return _x(d, 0) + _x(d, 1), ones * w[(d, m)]
    if op == "gather_batch":       # (4, 3): this model column block, whole over data
        return WHOLE[:, 3 * m:3 * m + 3], ones * sum(w[(k, m)] for k in range(2))
    if op == "whole":              # summed over data, this rank's slice over model
        return WHOLE, ones * sum(w[(k, m)] for k in range(2))
    if op == "whole_partial":
        return WHOLE, ones * sum(w[(k, j)] for k in range(2) for j in range(2))
    if op == "gather_model":
        return np.concatenate([_x(d, 0), _x(d, 1)], axis=1), ones * w[(d, m)]
    if op == "batch_mean":
        return (_x(0, m) + _x(1, m)) / 2, ones * sum(w[(k, m)] for k in range(2)) / 2
    raise KeyError(op)


@pytest.mark.parametrize("op", OPS)
def test_tensor_parallel_collectives_forward_and_backward(op, world):
    w = {c: 1 + res["rank"] for c, res in world.items()}
    for (d, m), res in world.items():
        if op == "full_shard":
            np.testing.assert_array_equal(res[op]["full"], WHOLE)
            np.testing.assert_array_equal(res[op]["back"],
                                          WHOLE[2 * d:2 * d + 2, 3 * m:3 * m + 3])
            continue
        y, grad = _expected(op, d, m, w)
        np.testing.assert_array_equal(res[op]["y"], y, err_msg=f"{op} forward at {(d, m)}")
        np.testing.assert_array_equal(res[op]["grad"], grad, err_msg=f"{op} grad at {(d, m)}")
