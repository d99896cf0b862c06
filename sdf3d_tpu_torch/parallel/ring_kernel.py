"""The ring all-reduce kernels K7 and K8 (the port of the Pallas kernels of
``sdf3d_tpu/parallel/collectives.py``), their plain PyTorch versions and the
device buffers they share between processes.

Two implementations of each function, the sum of a flat vector over the
ranks of a :class:`~sdf3d_tpu_torch.parallel.mesh.Mesh`:

- the CUDA kernels (``ops/csrc/collectives.cu``): K7, the latency ring
  (:func:`ring_allreduce_launch`), and K8, the reduce-scatter + all-gather
  ring (:func:`rs_ag_launch`).  A call is a few segment kernels; a segment
  writes into the right neighbour's device memory, opened by CUDA IPC, and
  stores its flags into host memory every rank maps; the host launches a
  segment once the flags it needs have arrived (:class:`RingBuffers`);
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
each chunk along one path and copies it around.  No kernel waits: every
wait is the host's, bounded by :data:`SPIN_LIMIT_S`, and a peer that never
arrives makes the wrapper raise, naming the rank, the step and the stream.
"""

from __future__ import annotations

import ctypes
import functools
import os
import secrets
import socket

import torch
import torch.distributed as dist

from sdf3d_tpu_torch.parallel.mesh import Mesh

#: The time limit of one wait of a call, in seconds.
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


class SharedSegment:
    """The host memory that holds a buffer set's flags, acks and status
    words: a POSIX shared-memory object mapped into this process and
    registered with CUDA (mapped, portable), so the kernels store flags into
    it and the host polls them.  Without ``name`` it creates a new zeroed
    object under a fresh name; with one it attaches that object.
    :meth:`unlink` removes the name (the mappings stay); :meth:`close`
    unregisters and unmaps."""

    def __init__(self, device_index: int, nbytes: int, name: str | None = None):
        lib = collectives_library()
        create = name is None
        if create:
            name = f"/sdf3d_coll_{os.getpid()}_{secrets.token_hex(6)}"
        self.device_index, self.name, self.nbytes = device_index, name, nbytes
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        err = lib.sdf3d_coll_shm_open(name.encode(), nbytes, int(create), ctypes.byref(host))
        if err != 0:
            raise OSError(err, f"shm_open of the ring flags {name!r}: {os.strerror(err)}")
        self.host = host.value
        err = lib.sdf3d_coll_sync_register(device_index, host, nbytes, ctypes.byref(dev))
        if err != 0:
            lib.sdf3d_coll_shm_close(host, nbytes)
            if create:
                lib.sdf3d_coll_shm_unlink(name.encode())
            if err == -2:
                raise RuntimeError(f"cuda:{device_index} cannot use registered host memory at its host address "
                                   "(cudaDevAttrCanUseHostPointerForRegisteredMem is 0): the ring kernels need it")
            _check(err, "cudaHostRegister of the ring flags")
        self.dev = dev.value

    def unlink(self) -> None:
        err = collectives_library().sdf3d_coll_shm_unlink(self.name.encode())
        if err != 0:
            raise OSError(err, f"shm_unlink of {self.name!r}: {os.strerror(err)}")

    def close(self) -> None:
        lib = collectives_library()
        _check(lib.sdf3d_coll_sync_unregister(self.device_index, ctypes.c_void_p(self.host)),
               "cudaHostUnregister of the ring flags")
        lib.sdf3d_coll_shm_close(ctypes.c_void_p(self.host), self.nbytes)
        self.host = self.dev = None


def timeout_message(kind: str, size: int, rank: int, sync: SharedSegment, spin_s: float, where: str = "") -> str:
    """What a rank's call that gave up waiting says: the rank, the size,
    and the step and the op of every stream still waiting (the rank's
    status words in the shared segment)."""
    status = (ctypes.c_int * (2 * _STATUS_INTS))()
    collectives_library().sdf3d_coll_status(_KIND[kind], size, ctypes.c_void_p(sync.host), rank, status)
    waits = [f"{_OPS.get(op, op)} of step {step}, stream {name}"
             for name, (failed, op, step, _) in zip("AB", (status[0:4], status[4:8])) if failed]
    return (f"{_NAME[kind]}: rank {rank} of {size}{where} waited {spin_s} s in vain at {'; '.join(waits)}: a peer "
            "did not reach this all-reduce")


class RingBuffers:
    """One process's buffer set of one ring all-reduce: the region of
    ``mesh``'s group, ``collective_id``, kind (``"ring"`` or ``"rs_ag"``)
    and element type, the peers' regions opened by CUDA IPC, and the shared
    host segment of the set's flags.

    Each rank allocates its region with ``cudaMalloc`` (its IPC handle
    exports that region alone); rank 0 creates the shared segment
    (:class:`SharedSegment`).  The handles and the segment's name are
    exchanged with ``dist.all_gather_object``, every peer's region is opened
    once and every rank maps the segment; after a barrier rank 0 unlinks its
    name, so no name outlives the set, whatever ends the processes.

    A region holds two parity sets: call ``c`` uses set ``c % 2`` with flag
    epoch ``c // 2 + 1``.  A call returns once its last segment is queued,
    so a rank's segments of call ``c`` may still be on its stream when it
    starts call ``c + 1``.  Only the left neighbour writes into a rank's set,
    so the set is safe to rewrite in call ``c + 2`` once the right neighbour
    has finished its call ``c`` on the card.  It has: the left rank's host
    reaches call ``c + 2`` only after its last wait of call ``c + 1``, which
    the ring's chain of forwarded arrivals ties to a flag stored by one of
    the right neighbour's segments of call ``c + 1``, and that segment ran
    on the right neighbour's stream after its segments of call ``c``.  The
    slot capacity grows collectively: every rank calls with the same
    payload, so every rank regrows at the same call.
    """

    def __init__(self, mesh: Mesh, collective_id: int, kind: str, dtype: torch.dtype):
        if mesh.device.type != "cuda":
            raise ValueError(f"the ring kernels run on CUDA devices, not {mesh.device}")
        self.mesh, self.collective_id, self.kind, self.dtype = mesh, collective_id, kind, dtype
        self.elem = torch.empty((), dtype=dtype).element_size()
        self.capacity = 0
        self.calls = 0
        self.own = None
        self.sync: SharedSegment | None = None
        self.peers: dict = {}
        self.failed = None

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
        if self.own is not None and capacity <= self.capacity:
            return
        capacity = max(capacity, 2 * self.capacity, MIN_CAPACITY)
        self.close(barrier=True)
        lib, dev, kind, size = collectives_library(), self.device_index, _KIND[self.kind], self.mesh.size
        nbytes, sync_bytes = ctypes.c_longlong(), ctypes.c_longlong()
        _check(lib.sdf3d_coll_region_bytes(kind, size, capacity, self.elem, ctypes.byref(nbytes)),
               "sdf3d_coll_region_bytes")
        _check(lib.sdf3d_coll_sync_bytes(kind, size, ctypes.byref(sync_bytes)), "sdf3d_coll_sync_bytes")
        own = ctypes.c_void_p()
        _check(lib.sdf3d_coll_alloc(dev, nbytes.value, ctypes.byref(own)), "cudaMalloc of a ring region")
        handle = ctypes.create_string_buffer(64)
        _check(lib.sdf3d_ipc_get_handle(dev, own, handle), "cudaIpcGetMemHandle")
        creator = self.mesh.rank == 0
        if creator:
            self.sync = SharedSegment(dev, sync_bytes.value)
        infos = [None] * size
        dist.all_gather_object(infos, (socket.gethostname(), handle.raw, self.sync and self.sync.name),
                               group=self.mesh.group)
        hosts = sorted({h for h, _, _ in infos})
        if len(hosts) > 1:
            lib.sdf3d_coll_free(dev, own)
            if creator:
                self.sync.unlink()
                self.sync.close()
                self.sync = None
            raise RuntimeError(f"the ring kernels share device memory by CUDA IPC and flags in shared host memory, "
                               f"which needs every rank on one host; this mesh spans {hosts}")
        self.own, self.capacity, self.calls = own.value, capacity, 0
        if not creator:
            self.sync = SharedSegment(dev, sync_bytes.value, infos[0][2])
        for r, (_, raw, _) in enumerate(infos):
            if r != self.mesh.rank:
                peer = ctypes.c_void_p()
                _check(lib.sdf3d_ipc_open(dev, ctypes.create_string_buffer(raw, 64), ctypes.byref(peer)),
                       f"cudaIpcOpenMemHandle of rank {r}'s ring region")
                self.peers[r] = peer.value
        dist.barrier(group=self.mesh.group)  # every rank has mapped the segment
        if creator:
            self.sync.unlink()

    def next_call(self) -> tuple:
        """``(parity, epoch)`` of the next call."""
        c = self.calls
        self.calls += 1
        return c % 2, c // 2 + 1

    def raise_timeout(self, spin_s: float) -> None:
        """After a call gave up waiting: raise :func:`timeout_message`; the
        buffers are unusable from here on."""
        self.failed = timeout_message(self.kind, self.mesh.size, self.mesh.rank, self.sync, spin_s,
                                      f" (collective_id {self.collective_id})")
        raise RuntimeError(self.failed)

    def close(self, barrier: bool = False) -> None:
        """Wait for this rank's calls, close the peers' regions, then (after
        a barrier with ``barrier``, so no rank's kernel still runs on these
        regions) unmap the shared segment and free this rank's region."""
        if self.own is None:
            return
        lib, dev = collectives_library(), self.device_index
        torch.cuda.synchronize(self.mesh.device)
        for r, ptr in self.peers.items():
            _check(lib.sdf3d_ipc_close(dev, ctypes.c_void_p(ptr)), f"cudaIpcCloseMemHandle of rank {r}'s region")
        if barrier:
            dist.barrier(group=self.mesh.group)
        self.sync.close()
        _check(lib.sdf3d_coll_free(dev, ctypes.c_void_p(self.own)), "cudaFree of a ring region")
        self.own, self.sync, self.peers, self.capacity, self.calls = None, None, {}, 0, 0


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


def _finish(err: int, bufs: RingBuffers, spin_s: float, what: str) -> None:
    if err == -1:
        bufs.raise_timeout(spin_s)
    _check(err, what)


def ring_allreduce_launch(x: torch.Tensor, mesh: Mesh, collective_id: int = 0,
                          spin_s: float | None = None) -> torch.Tensor:
    """Launch K7 on ``x``'s card: the sum of the 1-D vector ``x`` over the
    mesh, added in rank order, in ``x``'s type, on the current stream.  The
    host waits for each arrival before it launches the segment that needs
    it, and returns once the last segment is queued.  Raises for inputs it
    does not take, on any launch error and when a wait passes ``spin_s``
    seconds (default :data:`SPIN_LIMIT_S`); never falls back."""
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
                                       bufs.sync.host, bufs.sync.dev, x.data_ptr(), out.data_ptr(), n, bufs.elem,
                                       size, d, parity, bufs.capacity, epoch, int(spin_s * 1e9), stream)
    ring_allreduce.launches += err <= 0  # 0, or -1 after launching the segments before a timed-out wait
    _finish(err, bufs, spin_s, "sdf3d_ring_allreduce launch")
    return out


def rs_ag_launch(x: torch.Tensor, mesh: Mesh, collective_id: int = 1, spin_s: float | None = None) -> torch.Tensor:
    """Launch K8 on ``x``'s card: the sum of the 1-D vector ``x`` over the
    mesh (zero-padded to ``2·N`` chunks inside the kernel), in ``x``'s
    type.  Waits, raises and never falls back as
    :func:`ring_allreduce_launch`."""
    _check_vector(x, mesh)
    spin_s = SPIN_LIMIT_S if spin_s is None else spin_s
    n, size, d = x.numel(), mesh.size, mesh.rank
    m = rs_ag_chunk(n, size)
    bufs = ring_buffers(mesh, collective_id, "rs_ag", x.dtype)
    bufs.ensure(m)
    parity, epoch = bufs.next_call()
    out = torch.empty(2 * size * m, dtype=x.dtype, device=x.device)
    lib = collectives_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sdf3d_rs_ag(bufs.device_index, bufs.pointer(d), bufs.pointer((d + 1) % size), bufs.sync.host,
                              bufs.sync.dev, x.data_ptr(), out.data_ptr(), n, bufs.elem, size, d, parity,
                              bufs.capacity, epoch, int(spin_s * 1e9), stream)
    rs_ag_allreduce.launches += err <= 0
    _finish(err, bufs, spin_s, "sdf3d_rs_ag launch")
    return out[:n]


class LocalRing:
    """The ``n_ranks`` ranks of one ring all-reduce in this process, each
    with its own region and stream and one shared segment (no IPC, no
    process group): the kernels' cost without a switch between processes.
    :meth:`run` gives each rank a host thread (``sdf3d_coll_local_run``,
    threads of the library: no Python and no GIL between the calls) that
    makes its calls in a row, so each rank's host waits run beside the
    others'."""

    def __init__(self, kind: str, n_ranks: int, n: int, dtype: torch.dtype, device: torch.device):
        lib, self.kind, self.size, self.n = collectives_library(), kind, n_ranks, n
        self.device = torch.device(device)
        self.index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        self.elem = torch.empty((), dtype=dtype).element_size()
        self.m = rs_ag_chunk(n, n_ranks)
        self.capacity = max((n + 1) // 2 if kind == "ring" else self.m, 1)
        nbytes, sync_bytes = ctypes.c_longlong(), ctypes.c_longlong()
        _check(lib.sdf3d_coll_region_bytes(_KIND[kind], n_ranks, self.capacity, self.elem, ctypes.byref(nbytes)),
               "sdf3d_coll_region_bytes")
        _check(lib.sdf3d_coll_sync_bytes(_KIND[kind], n_ranks, ctypes.byref(sync_bytes)), "sdf3d_coll_sync_bytes")
        self.regions = []
        for _ in range(n_ranks):
            ptr = ctypes.c_void_p()
            _check(lib.sdf3d_coll_alloc(self.index, nbytes.value, ctypes.byref(ptr)), "cudaMalloc of a ring region")
            self.regions.append(ptr.value)
        self.sync = SharedSegment(self.index, sync_bytes.value)
        self.sync.unlink()
        self.streams = [torch.cuda.Stream(self.device) for _ in range(n_ranks)]
        self.calls = 0

    def run(self, xs: list, calls: int = 1, ranks=None, spin_s: float | None = None) -> list:
        """``calls`` all-reduces of the ranks' vectors ``xs`` (each rank its
        own contiguous 1-D tensor of ``n`` elements on the card) by the
        ranks in ``ranks`` (default all); returns each rank's sum of the last
        call (None for a rank that did not run) once every thread has queued
        its last segment, ordered before later work on the current stream.
        Raises :func:`timeout_message` for a rank whose wait passed
        ``spin_s``."""
        size, ranks = self.size, range(self.size) if ranks is None else ranks
        spin_s = SPIN_LIMIT_S if spin_s is None else spin_s
        current = torch.cuda.current_stream(self.device)
        outs = [None] * size
        for d in ranks:
            self.streams[d].wait_stream(current)
            outs[d] = torch.empty(self.n if self.kind == "ring" else 2 * size * self.m, dtype=xs[d].dtype,
                                  device=self.device)
        ptrs = ctypes.c_void_p * size
        errors = (ctypes.c_int * size)()
        _check(collectives_library().sdf3d_coll_local_run(
            self.index, _KIND[self.kind], size, ptrs(*self.regions), self.sync.host, self.sync.dev,
            ptrs(*[x.data_ptr() for x in xs]), ptrs(*[0 if o is None else o.data_ptr() for o in outs]), self.n,
            self.elem, self.capacity, self.calls, calls, sum(1 << d for d in ranks), int(spin_s * 1e9),
            ptrs(*[st.cuda_stream for st in self.streams]), errors), "sdf3d_coll_local_run")
        self.calls += calls
        for d in ranks:
            current.wait_stream(self.streams[d])
            if errors[d] == -1:
                raise RuntimeError(timeout_message(self.kind, size, d, self.sync, spin_s))
            _check(errors[d], f"{_NAME[self.kind]} launch of rank {d}")
        return [o if o is None else o[:self.n] for o in outs]

    def close(self) -> None:
        """Wait for the card, unmap the shared segment, free the regions."""
        lib = collectives_library()
        torch.cuda.synchronize(self.device)
        self.sync.close()
        for ptr in self.regions:
            _check(lib.sdf3d_coll_free(self.index, ctypes.c_void_p(ptr)), "cudaFree of a ring region")
        self.regions = []


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
