"""The ring all-reduce kernels K7 and K8 (the port of the Pallas kernels of
``sdf3d_tpu/parallel/collectives.py``), their plain PyTorch versions and the
device buffers they share between processes.

Two implementations of each function, the sum of a flat vector over the
ranks of a :class:`~sdf3d_tpu_torch.parallel.mesh.Mesh`:

- the CUDA kernels (``ops/csrc/collectives.cu``): K7, the latency ring
  (:func:`ring_allreduce_launch`), and K8, the reduce-scatter + all-gather
  ring (:func:`rs_ag_launch`).  A rank's kernel writes into its neighbours'
  device memory, opened by CUDA IPC, and polls flags in its own
  (:class:`RingBuffers`);
- :func:`ring_allreduce_plain` and :func:`rs_ag_plain`, which walk the same
  schedules (``collectives.ring_schedule``, ``rs_ag_schedule``) with
  ``dist.isend``/``dist.irecv`` to the right and left neighbours (under gloo
  through host memory) and add in the kernels' order, so the two give the
  same bits.

:func:`ring_allreduce` and :func:`rs_ag_allreduce` launch the kernel for a
CUDA tensor and run the plain version for a CPU tensor; their ``launches``
count kernel launches.

Both give every rank the same bits.  K7 keeps each arrival in a slot of its
own (one per step) and adds the N contributions in rank order; K8 reduces
each chunk along one path and copies it around.  Every wait in a kernel is
bounded by :data:`SPIN_LIMIT_S`: a peer that never arrives makes the wrapper
raise, naming the rank, the step and the stream.
"""

from __future__ import annotations

import ctypes
import functools
import socket

import torch
import torch.distributed as dist

from sdf3d_tpu_torch.parallel.mesh import Mesh

#: The time limit of one wait in the kernels, in seconds.
SPIN_LIMIT_S = 10.0
#: The smallest slot capacity a buffer set is allocated with (elements).
MIN_CAPACITY = 1024
_KIND = {"ring": 0, "rs_ag": 1}
_NAME = {"ring": "ring_allreduce", "rs_ag": "rs_ag_allreduce"}
_OPS = {1: "wait", 2: "bp_wait"}
_STATUS_INTS = 4


@functools.cache
def collectives_library():
    """``libsdf3d_collectives.so``, built at first use (an empty header: one
    library for every scene)."""
    from sdf3d_tpu_torch.ops import _build

    return _build.LIBRARIES.load("", "collectives")


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _neighbours(mesh: Mesh) -> tuple:
    """Global ranks of this rank's right and left neighbours on the ring."""
    n, d = mesh.size, mesh.rank
    glob = (lambda r: r) if mesh.group is None else (lambda r: dist.get_global_rank(mesh.group, r))
    return glob((d + 1) % n), glob((d - 1) % n)


def send_chunk(d: int, k: int, n: int) -> int:
    """K8's chunk that rank ``d`` sends at step ``k`` (JAX's ``send_chunk``)."""
    return (d - k) % n if k < n - 1 else (d + 1 - (k - (n - 1))) % n


def recv_chunk(d: int, k: int, n: int) -> int:
    """K8's chunk that rank ``d`` adds (reduce-scatter) or stores
    (all-gather) its step-``k`` arrival into (JAX's ``recv_chunk``)."""
    return (d - k - 1) % n if k < n - 1 else (d - (k - (n - 1))) % n


def rs_ag_chunk(n: int, n_ranks: int) -> int:
    """K8's chunk length for ``n`` elements: the vector is padded to
    ``2·n_ranks`` chunks (two streams of ``n_ranks``)."""
    return -(-n // (2 * n_ranks))


class RingBuffers:
    """One process's buffer set of one ring all-reduce: the region of
    ``mesh``'s group, ``collective_id``, kind (``"ring"`` or ``"rs_ag"``)
    and element type, and the peers' regions opened by CUDA IPC.

    Each rank allocates its region with ``cudaMalloc`` (its IPC handle
    exports that region alone), the handles are exchanged with
    ``dist.all_gather_object`` and every peer's region is opened once; a
    rank uses its own pointer for itself.  A region holds two parity sets:
    call ``c`` uses set ``c % 2`` with flag epoch ``c // 2 + 1``.  A rank
    cannot finish call ``c + 1`` before its right neighbour has started it
    (the ring's dependency chain), so when it writes into that neighbour's
    set for call ``c + 2`` the neighbour has finished call ``c``, the last
    reader of the set.  The slot capacity grows collectively: every rank
    calls with the same payload, so every rank regrows at the same call.
    """

    def __init__(self, mesh: Mesh, collective_id: int, kind: str, dtype: torch.dtype):
        if mesh.device.type != "cuda":
            raise ValueError(f"the ring kernels run on CUDA devices, not {mesh.device}")
        self.mesh, self.collective_id, self.kind, self.dtype = mesh, collective_id, kind, dtype
        self.elem = torch.empty((), dtype=dtype).element_size()
        self.capacity = 0
        self.calls = 0
        self.own = None
        self.peers: dict = {}
        self.failed = None
        self._status = (ctypes.c_int * (2 * _STATUS_INTS))()

    @property
    def device_index(self) -> int:
        return self.mesh.device.index if self.mesh.device.index is not None else torch.cuda.current_device()

    def pointer(self, rank: int) -> int:
        """The region of ``rank`` (this rank's own, or a peer's)."""
        return self.own if rank == self.mesh.rank else self.peers[rank]

    def ensure(self, capacity: int) -> None:
        """Make every slot hold ``capacity`` elements (collective: every
        rank calls it with the same value)."""
        if self.failed is not None:
            raise RuntimeError(f"these ring buffers are unusable after an earlier failure: {self.failed}")
        if capacity <= self.capacity:
            return
        capacity = max(capacity, 2 * self.capacity, MIN_CAPACITY)
        self.close(barrier=True)
        lib, dev = collectives_library(), self.device_index
        nbytes = ctypes.c_longlong()
        _check(lib.sdf3d_coll_region_bytes(_KIND[self.kind], self.mesh.size, capacity, self.elem,
                                           ctypes.byref(nbytes)), "sdf3d_coll_region_bytes")
        own = ctypes.c_void_p()
        _check(lib.sdf3d_coll_alloc(dev, nbytes.value, ctypes.byref(own)), "cudaMalloc of a ring region")
        handle = ctypes.create_string_buffer(64)
        _check(lib.sdf3d_ipc_get_handle(dev, own, handle), "cudaIpcGetMemHandle")
        infos = [None] * self.mesh.size
        dist.all_gather_object(infos, (socket.gethostname(), handle.raw), group=self.mesh.group)
        hosts = sorted({h for h, _ in infos})
        if len(hosts) > 1:
            lib.sdf3d_coll_free(dev, own)
            raise RuntimeError(f"the ring kernels share device memory by CUDA IPC, which needs every rank on one "
                               f"host; this mesh spans {hosts}")
        self.own, self.capacity, self.calls = own.value, capacity, 0
        for r, (_, raw) in enumerate(infos):
            if r != self.mesh.rank:
                peer = ctypes.c_void_p()
                _check(lib.sdf3d_ipc_open(dev, ctypes.create_string_buffer(raw, 64), ctypes.byref(peer)),
                       f"cudaIpcOpenMemHandle of rank {r}'s ring region")
                self.peers[r] = peer.value

    def next_call(self) -> tuple:
        """``(parity, epoch)`` of the next call."""
        c = self.calls
        self.calls += 1
        return c % 2, c // 2 + 1

    def check(self, stream: int, spin_s: float) -> None:
        """Wait for this rank's call to end and raise if a wait timed out."""
        lib = collectives_library()
        _check(lib.sdf3d_coll_status(self.device_index, self.own, self._status, stream), "reading the ring status")
        for s, name in enumerate("AB"):
            failed, op, step = self._status[s * _STATUS_INTS:s * _STATUS_INTS + 3]
            if failed:
                self.failed = (f"{_NAME[self.kind]}: rank {self.mesh.rank} of {self.mesh.size} (collective_id "
                               f"{self.collective_id}) waited {spin_s} s in vain at {_OPS.get(op, op)} of step "
                               f"{step}, stream {name}: a peer did not reach this all-reduce")
                raise RuntimeError(self.failed)

    def close(self, barrier: bool = False) -> None:
        """Wait for this rank's calls, close the peers' regions and free this
        rank's (``barrier``: once every rank has done the same before
        freeing, so no kernel still runs on these regions)."""
        if self.own is None:
            return
        lib, dev = collectives_library(), self.device_index
        torch.cuda.synchronize(self.mesh.device)
        for r, ptr in self.peers.items():
            _check(lib.sdf3d_ipc_close(dev, ctypes.c_void_p(ptr)), f"cudaIpcCloseMemHandle of rank {r}'s region")
        if barrier:
            dist.barrier(group=self.mesh.group)
        _check(lib.sdf3d_coll_free(dev, ctypes.c_void_p(self.own)), "cudaFree of a ring region")
        self.own, self.peers, self.capacity, self.calls = None, {}, 0, 0


_BUFFERS: dict = {}


def ring_buffers(mesh: Mesh, collective_id: int, kind: str, dtype: torch.dtype) -> RingBuffers:
    """The process's buffer set of this group, id, kind and type."""
    key = (id(mesh.group), mesh.size, mesh.rank, collective_id, kind, dtype)
    bufs = _BUFFERS.get(key)
    if bufs is None:
        bufs = _BUFFERS[key] = RingBuffers(mesh, collective_id, kind, dtype)
    return bufs


def close_all() -> None:
    """Close and free every buffer set of this process (collective: every
    rank calls it, before its process group is destroyed)."""
    for bufs in _BUFFERS.values():
        bufs.close(barrier=dist.is_initialized())
    _BUFFERS.clear()


def _check_vector(x: torch.Tensor, mesh: Mesh) -> None:
    if x.device.type != "cuda" or x.device != mesh.device:
        raise ValueError(f"the ring kernels take a vector on the mesh's card {mesh.device}, not {x.device}")
    if x.dtype not in (torch.float32, torch.float64) or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"the ring kernels take a contiguous 1-D float32 or float64 vector, not {x.dtype} "
                         f"{tuple(x.shape)}")


def ring_allreduce_launch(x: torch.Tensor, mesh: Mesh, collective_id: int = 0,
                          spin_s: float | None = None) -> torch.Tensor:
    """Launch K7 on ``x``'s card: the sum of the 1-D vector ``x`` over the
    mesh, added in rank order, in ``x``'s type.  Waits for the call to end;
    raises for inputs it does not take, on any launch error and when a wait
    passes ``spin_s`` seconds (default :data:`SPIN_LIMIT_S`); never falls
    back."""
    _check_vector(x, mesh)
    spin_s = SPIN_LIMIT_S if spin_s is None else spin_s
    n, size, d = x.numel(), mesh.size, mesh.rank
    bufs = ring_buffers(mesh, collective_id, "ring", x.dtype)
    bufs.ensure((n + 1) // 2)
    parity, epoch = bufs.next_call()
    out = torch.empty_like(x)
    lib = collectives_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdf3d_ring_allreduce(bufs.device_index, bufs.pointer(d), bufs.pointer((d + 1) % size),
                                       x.data_ptr(), out.data_ptr(), n, bufs.elem, size, d, parity, bufs.capacity,
                                       epoch, int(spin_s * 1e9), stream)
    _check(err, "sdf3d_ring_allreduce launch")
    ring_allreduce.launches += 1
    bufs.check(stream, spin_s)
    return out


def rs_ag_launch(x: torch.Tensor, mesh: Mesh, collective_id: int = 1, spin_s: float | None = None) -> torch.Tensor:
    """Launch K8 on ``x``'s card: the sum of the 1-D vector ``x`` over the
    mesh (zero-padded to ``2·N`` chunks around the kernel), in ``x``'s
    type.  Waits, raises and never falls back as
    :func:`ring_allreduce_launch`."""
    _check_vector(x, mesh)
    spin_s = SPIN_LIMIT_S if spin_s is None else spin_s
    n, size, d = x.numel(), mesh.size, mesh.rank
    m = rs_ag_chunk(n, size)
    bufs = ring_buffers(mesh, collective_id, "rs_ag", x.dtype)
    bufs.ensure(m)
    parity, epoch = bufs.next_call()
    out = torch.zeros(2 * size * m, dtype=x.dtype, device=x.device)
    out[:n] = x
    lib = collectives_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdf3d_rs_ag(bufs.device_index, bufs.pointer(d), bufs.pointer((d + 1) % size),
                              bufs.pointer((d - 1) % size), out.data_ptr(), out.numel(), bufs.elem, size, d, parity,
                              bufs.capacity, epoch, int(spin_s * 1e9), stream)
    _check(err, "sdf3d_rs_ag launch")
    rs_ag_allreduce.launches += 1
    bufs.check(stream, spin_s)
    return out[:n]


def _via(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` where the backend moves it: host memory under gloo."""
    return x.cpu() if dist.get_backend(mesh.group) == "gloo" else x


def ring_allreduce_plain(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Plain PyTorch version of K7: walks ``ring_schedule`` with
    ``dist.isend``/``dist.irecv``, each arrival kept in a slot of its own,
    then adds the N contributions in rank order (the kernel's bits)."""
    from sdf3d_tpu_torch.parallel.collectives import ring_schedule

    size, d = mesh.size, mesh.rank
    right, left = _neighbours(mesh)
    v = _via(x.reshape(-1), mesh).contiguous()
    h = (v.numel() + 1) // 2
    halves = {"A": v[:h], "B": v[h:]}
    slots = {s: [torch.empty_like(halves[s]) for _ in range(size - 1)] for s in "AB"}
    pending = {}
    for op, s, step in ring_schedule(size):
        if halves[s].numel() == 0:
            continue
        tag = 2 * step + "AB".index(s)
        if op == "start":
            src = halves[s] if step == 0 else slots[s][step - 1]
            pending[s] = (dist.isend(src, right, group=mesh.group, tag=tag),
                          dist.irecv(slots[s][step], left, group=mesh.group, tag=tag))
        elif op == "wait":
            for work in pending.pop(s):
                work.wait()
        # accum: the arrival stays in its slot for the sum in rank order.
    out = []
    for s in "AB":
        parts = [halves[s] if r == d else slots[s][(d - r - 1) % size] for r in range(size)]
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        out.append(acc)
    return torch.cat(out).to(x.device).view(x.shape)


def rs_ag_plain(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Plain PyTorch version of K8: walks ``rs_ag_schedule`` with
    ``dist.isend``/``dist.irecv`` over the zero-padded vector's ``2·N``
    chunks, adding (reduce-scatter) and storing (all-gather) each arrival
    as the kernel does (the kernel's bits)."""
    from sdf3d_tpu_torch.parallel.collectives import rs_ag_schedule

    size, d = mesh.size, mesh.rank
    right, left = _neighbours(mesh)
    n = x.numel()
    m = rs_ag_chunk(n, size)
    v = _via(x.reshape(-1), mesh)
    buf = torch.zeros(2 * size * m, dtype=x.dtype, device=v.device)
    buf[:n] = v
    if m == 0:
        return buf.to(x.device).view(x.shape)
    chunks = buf.view(2, size, m)
    arrivals = {s: [torch.empty(m, dtype=x.dtype, device=v.device) for _ in range(2)] for s in "AB"}
    pending = {}
    for op, s, k in rs_ag_schedule(size):
        si, slot = "AB".index(s), k % 2
        if op == "start":
            tag = 2 * k + si
            pending[s] = (dist.isend(chunks[si, send_chunk(d, k, size)], right, group=mesh.group, tag=tag),
                          dist.irecv(arrivals[s][slot], left, group=mesh.group, tag=tag))
        elif op == "wait":
            for work in pending.pop(s):
                work.wait()
        elif op == "accum":
            chunks[si, recv_chunk(d, k, size)] += arrivals[s][slot]
        else:  # copy
            chunks[si, recv_chunk(d, k, size)] = arrivals[s][slot]
    return buf[:n].to(x.device).view(x.shape)


def ring_allreduce(x: torch.Tensor, mesh: Mesh, collective_id: int = 0) -> torch.Tensor:
    """K7, the latency ring all-reduce (sum) of the 1-D vector ``x`` over
    the mesh: on the card it launches the CUDA kernel, on the CPU it runs
    the plain version.  ``ring_allreduce.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return ring_allreduce_plain(x, mesh)
    if x.device.type == "cuda":
        return ring_allreduce_launch(x, mesh, collective_id)
    raise ValueError(f"ring_allreduce runs on 'cuda' or 'cpu', not {x.device}")


#: Kernel launches in this process (the smoke resets and reads it).
ring_allreduce.launches = 0


def rs_ag_allreduce(x: torch.Tensor, mesh: Mesh, collective_id: int = 1) -> torch.Tensor:
    """K8, the reduce-scatter + all-gather ring all-reduce (sum) of the 1-D
    vector ``x`` over the mesh: on the card it launches the CUDA kernel, on
    the CPU it runs the plain version.  ``rs_ag_allreduce.launches`` counts
    kernel launches."""
    if x.device.type == "cpu":
        return rs_ag_plain(x, mesh)
    if x.device.type == "cuda":
        return rs_ag_launch(x, mesh, collective_id)
    raise ValueError(f"rs_ag_allreduce runs on 'cuda' or 'cpu', not {x.device}")


#: Kernel launches in this process (the smoke resets and reads it).
rs_ag_allreduce.launches = 0
