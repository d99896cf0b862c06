"""The gradient all-reduce of the sharded fits (the port of
``sdf3d_tpu/parallel/collectives.py``).

:func:`allreduce_tree` flattens a list of tensors into one float64 vector
and sums it over the mesh once a step, however many leaves the gradient
has, by the value of ``FitConfig.allreduce``:

- ``"psum"`` (the default): one ``dist.all_reduce``;
- ``"pallas_ring"``: :func:`pallas_psum` with ``algorithm="auto"``:
  the latency ring K7 below :func:`_rs_ag_threshold` elements, the
  reduce-scatter + all-gather ring K8 from it on (JAX's rule);
- ``"pallas_rs_ag"``: K8 whatever the size;
- ``"pallas_ring_interpret"``, ``"pallas_rs_ag_interpret"``: the kernels'
  plain versions on any device (the caller's explicit request, as JAX's
  interpreter is).

The kernels and their plain versions are in ``ring_kernel.py``: a CUDA
tensor runs the kernel, a CPU tensor the plain version.  The kernels add in
the vector's own type, so the fit's sums stay in float64.  Their schedules,
:func:`ring_schedule` and :func:`rs_ag_schedule`, are data (the tests hold
them to the JAX package's); the kernels and the plain versions walk them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sdf3d_tpu_torch.parallel import ring_kernel
from sdf3d_tpu_torch.parallel.mesh import Mesh

#: ``FitConfig.allreduce`` values of the ring kernels (K7, K8).
RING_ALLREDUCES = ("pallas_ring", "pallas_ring_interpret", "pallas_rs_ag", "pallas_rs_ag_interpret")
_SUBLANES, _LANES = 8, 128


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
    """Raise for an ``allreduce`` value the port does not know (before any
    work starts)."""
    if allreduce != "psum" and allreduce not in RING_ALLREDUCES:
        raise ValueError(f"unknown allreduce {allreduce!r}")


def _rs_ag_threshold(num_devices: int) -> int:
    """The flat length from which ``algorithm="auto"`` picks K8 (JAX's
    rule, copied: below it the padded RS+AG plane cost more than its wire
    savings on the TPU)."""
    return num_devices * _SUBLANES * 2 * _LANES


def resolve_algorithm(algorithm: str, n: int, num_devices: int) -> str:
    """``"ring"`` or ``"rs_ag"`` for a vector of ``n`` elements: ``"auto"``
    picks what JAX's ``pallas_psum`` picks."""
    if algorithm == "auto":
        return "rs_ag" if n >= _rs_ag_threshold(num_devices) else "ring"
    if algorithm not in ("ring", "rs_ag"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return algorithm


def pallas_psum(x: torch.Tensor, mesh: Mesh, algorithm: str = "auto", collective_id: int | None = None,
                interpret: bool = False) -> torch.Tensor:
    """The sum of ``x`` (any shape) over the mesh with a ring kernel, in
    ``x``'s shape and type (the counterpart of JAX's ``pallas_psum``).

    ``algorithm``: ``"ring"`` (K7), ``"rs_ag"`` (K8) or ``"auto"``
    (:func:`resolve_algorithm`).  float32 and float64 are added in their
    own type, other types in float32, as JAX does.  ``collective_id`` keys
    the kernel's buffer set (``None``: 0 for K7, 1 for K8, JAX's defaults),
    so two reductions in one step with distinct ids never share buffers.
    ``interpret``: run the plain version on any device.  A mesh of size 1
    returns ``x``."""
    if mesh.size == 1:
        return x
    algorithm = resolve_algorithm(algorithm, x.numel(), mesh.size)
    flat = x.reshape(-1)
    if flat.dtype not in (torch.float32, torch.float64):
        flat = flat.to(torch.float32)
    flat = flat.contiguous()
    if algorithm == "ring":
        cid = 0 if collective_id is None else int(collective_id)
        if interpret:
            out = ring_kernel.ring_allreduce_plain(flat, mesh)
        else:
            out = ring_kernel.ring_allreduce(flat, mesh, cid)
    else:
        cid = 1 if collective_id is None else int(collective_id)
        if interpret:
            out = ring_kernel.rs_ag_plain(flat, mesh)
        else:
            out = ring_kernel.rs_ag_allreduce(flat, mesh, cid)
    return out.view(x.shape).to(x.dtype)


def _flatten(tensors, dtype) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def _split(flat: torch.Tensor, tensors) -> list:
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape).to(t.dtype))
        off += n
    return out


def pallas_psum_tree(tensors, mesh: Mesh, algorithm: str = "auto", collective_id: int | None = None,
                     interpret: bool = False) -> list:
    """The sums over the mesh of the tensors ``tensors`` (a sequence), each
    in its shape and type, with **one** ring kernel launch: the leaves are
    concatenated into one vector of their promoted type (at least float32),
    reduced with :func:`pallas_psum` and split back.  At mesh size 1, the
    tensors themselves."""
    tensors = list(tensors)
    if mesh.size == 1 or not tensors:
        return tensors
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = pallas_psum(_flatten(tensors, dtype), mesh, algorithm, collective_id, interpret)
    return _split(flat, tensors)


def allreduce_tree(tensors, allreduce: str, mesh: Mesh) -> list:
    """The sums over the mesh of the tensors ``tensors`` (a sequence), each
    in its shape and type, through one flat float64 vector: one
    ``dist.all_reduce`` (``"psum"``; under gloo a card's vector goes
    through host memory) or one ring kernel (the module docstring); at mesh
    size 1, the tensors themselves."""
    check_allreduce(allreduce)
    tensors = list(tensors)
    if mesh.size == 1:
        return tensors
    flat = _flatten(tensors, torch.float64)
    if allreduce in RING_ALLREDUCES:
        flat = pallas_psum(flat, mesh, algorithm="rs_ag" if "rs_ag" in allreduce else "auto",
                           interpret=allreduce.endswith("_interpret"))
    else:
        via = flat.cpu() if dist.get_backend(mesh.group) == "gloo" else flat  # gloo: through host memory
        dist.all_reduce(via, op=dist.ReduceOp.SUM, group=mesh.group)
        flat = via.to(flat.device)
    return _split(flat, tensors)


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's ``obj`` (any picklable object) on every rank of the mesh
    (``dist.broadcast_object_list``; NCCL stages it on this rank's card)."""
    if mesh.size == 1:
        return obj
    device = mesh.device if dist.get_backend(mesh.group) == "nccl" else None
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=device)
    return box[0]
