"""Half-space ``dot(normal, p) - offset``."""


def distance(p, prm, kids, static):
    return (p * prm["normal"]).sum(-1) - prm["offset"]
