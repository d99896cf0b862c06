"""The gradient all-reduce of the sharded fits (the port of the dispatcher of
``sdf3d_tpu/parallel/collectives.py``).

:func:`allreduce_tree` flattens a list of tensors into one vector and sums
it over the mesh with one ``dist.all_reduce`` (``"psum"``, the default of
``FitConfig.allreduce``), so a step costs one collective, however many
leaves the gradient has.  The JAX package's opt-in ring kernels K7
(``"pallas_ring"``) and K8 (``"pallas_rs_ag"``) become peer-to-peer ring
kernels on Hopper, which need two cards or CUDA IPC between processes: they
are ROADMAP item 15b and raise ``NotImplementedError`` here.  Their
schedules, :func:`ring_schedule` and :func:`rs_ag_schedule`, are pure
Python and are kept as data for them (the tests hold them to the JAX
package's).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sdf3d_tpu_torch.parallel.mesh import Mesh

#: ``FitConfig.allreduce`` values of the ring kernels (K7, K8; item 15b).
RING_ALLREDUCES = ("pallas_ring", "pallas_ring_interpret", "pallas_rs_ag", "pallas_rs_ag_interpret")


def ring_schedule(num: int) -> list:
    """The two-stream latency-ring op sequence, as data:
    ``[(op, stream, step), ...]`` with ``op`` in ``start`` (issue stream's
    step-``s`` copy to the right neighbour), ``wait`` (block on its arrival)
    and ``accum`` (add the arrived chunk into the output), ``stream`` in
    ``A``, ``B``.  Every ``accum`` but the last runs while the other
    stream's copy is in flight."""
    ops = [("start", "A", 0), ("start", "B", 0)]
    for step in range(num - 1):
        for stream in ("A", "B"):
            ops.append(("wait", stream, step))
            ops.append(("accum", stream, step))
            if step + 1 < num - 1:
                ops.append(("start", stream, step + 1))
    return ops


def rs_ag_schedule(num: int, backpressure: bool = False) -> list:
    """The two-stream reduce-scatter + all-gather op sequence, as data:
    ``[(op, stream, k), ...]`` with ``k`` the global step,
    ``0 <= k < 2(num-1)``: steps ``k < num-1`` reduce-scatter (``accum``),
    the rest all-gather (``copy``).  ``backpressure=True`` adds the
    consumption acks: ``bp_signal`` after each accum/copy tells the left
    neighbour the slot may be rewritten; ``bp_wait`` before a start that
    reuses a slot (step ``k`` reuses step ``k-2``'s) waits for the right
    neighbour's ack."""
    total = 2 * (num - 1)
    ops = [("start", "A", 0), ("start", "B", 0)]
    for k in range(total):
        for stream in ("A", "B"):
            ops.append(("wait", stream, k))
            ops.append(("accum" if k < num - 1 else "copy", stream, k))
            if backpressure and k + 2 < total:
                ops.append(("bp_signal", stream, k))
            if k + 1 < total:
                if backpressure and k + 1 >= 2:
                    ops.append(("bp_wait", stream, k + 1))
                ops.append(("start", stream, k + 1))
    return ops


def check_allreduce(allreduce: str) -> None:
    """Raise for an ``allreduce`` value the port does not run (before any
    work starts)."""
    if allreduce in RING_ALLREDUCES:
        raise NotImplementedError(
            f"allreduce={allreduce!r}: the ring all-reduce kernels K7/K8 are not ported yet (ROADMAP item 15b); "
            "use 'psum'")
    if allreduce != "psum":
        raise ValueError(f"unknown allreduce {allreduce!r}")


def allreduce_tree(tensors, allreduce: str, mesh: Mesh) -> list:
    """The sums over the mesh of the tensors ``tensors`` (a sequence), each
    in its shape and type: one flat float64 vector through one ``dist.all_reduce``
    (``"psum"``; under gloo a card's vector goes through host memory); at
    mesh size 1, the tensors themselves.  The ring kernels raise
    (:func:`check_allreduce`)."""
    check_allreduce(allreduce)
    tensors = list(tensors)
    if mesh.size == 1:
        return tensors
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    via = flat.cpu() if dist.get_backend(mesh.group) == "gloo" else flat  # gloo: through host memory
    dist.all_reduce(via, op=dist.ReduceOp.SUM, group=mesh.group)
    flat = via.to(flat.device)
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape).to(t.dtype))
        off += n
    return out


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's ``obj`` (any picklable object) on every rank of the mesh
    (``dist.broadcast_object_list``; NCCL stages it on this rank's card)."""
    if mesh.size == 1:
        return obj
    device = mesh.device if dist.get_backend(mesh.group) == "nccl" else None
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=device)
    return box[0]
