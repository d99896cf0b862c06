"""Sphere ``length(p - center) - radius``."""

import torch


def distance(p, prm, kids, static):
    q = p - prm["center"]
    return torch.sqrt((q * q).sum(-1)) - prm["radius"]
