"""Hard union: the least of the children's distances, every child evaluated."""

import torch


def distance(p, prm, kids, static):
    out = kids[0](p)
    for kid in kids[1:]:
        out = torch.minimum(out, kid(p))
    return out
