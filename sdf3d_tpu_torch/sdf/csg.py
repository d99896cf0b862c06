"""CSG combinators (the port of ``sdf3d_tpu/sdf/csg.py``): the hard union.

The other operators of the JAX package are not ported yet.
"""

from __future__ import annotations

import torch

from sdf3d_tpu_torch.sdf.node import SDFNode


class Union(SDFNode):
    """Hard union ``min(a, b)``."""

    fields = ("a", "b")

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        return torch.minimum(self.a.distance(p), self.b.distance(p))


def union(*nodes: SDFNode) -> SDFNode:
    """Left-fold hard union of any number of nodes."""
    out = nodes[0]
    for n in nodes[1:]:
        out = Union(a=out, b=n)
    return out
