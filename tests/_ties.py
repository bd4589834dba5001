"""Which parameter elements of an 8-bit optimizer step may take another
update than the reference's, element by element.

From the second step on, an element's update reads its moments' codes from
the step before. Where one code differs by one between two runs (its
float32 value sat on a rounding tie, which the order of the sums decides),
the element takes another update. Where the second moment's code is 0, the
second moment is the step's own (1 - b2) g^2 alone, and the update
mu / (0.22 |g| + eps) turns the rounding of a small gradient into a change
of up to the learning rate. ``unsettled`` names those elements, so that a
test can hold every other element at its tolerance.
"""
import math

import numpy as np


def unsettled(m, want, shapes, stacks):
    """{parameter: bool mask of its shape}, true where the first or the
    second moment's code differs between the 8-bit states ``m`` and
    ``want`` ({parameter: {key: codes}}, tensors or arrays), or where the
    second moment's code is 0 in either. ``shapes``: each parameter's whole
    shape; ``stacks``: {stacked leaf: its members in layer order}
    (``adamw.stacks``), whose blocks lie over the members laid end to end
    and are held by the first member."""
    first = {n: ms for ms in stacks.values() for n in ms}
    out = {}
    for n, shape in shapes.items():
        ms = first.get(n, [n])
        a, b = ({k: np.asarray(v) for k, v in s[ms[0]].items()} for s in (m, want))
        mask = ((a["mu_q"] != b["mu_q"]) | (a["nu_q"] != b["nu_q"])
                | (a["nu_q"] == 0) | (b["nu_q"] == 0)).reshape(-1)
        start = sum(math.prod(shapes[x]) for x in ms[:ms.index(n)])
        out[n] = mask[start:start + math.prod(shape)].reshape(shape)
    return out
