"""Build and load the CUDA kernels: nvcc into a shared library with a plain C
interface, loaded with ctypes.

A library is built from one generated header (``sdf3d_scene.cuh``,
ops/scene_program.py) and the sources of its kind:

- ``"render"``: the kernels of an analytic scene, the forward render and
  its tile-queue form (``csrc/render_kernel.cu``, ``sdf3d_render_fwd``,
  ``sdf3d_render_tiles``), the fused fit step and its tile-queue form
  (``csrc/fit_kernel.cu``, ``sdf3d_fit_step``, ``sdf3d_fit_step_tiles``:
  the target planes, the silhouette term's coverage plane, weight and
  softness, then partial rows and their float64 totals in one call) and the render
  backward (``csrc/render_bwd_kernel.cu``, ``sdf3d_render_bwd``: with or
  without the uniforms' gradient, chosen at launch, and its float64 totals
  in the same call; both totals by ``csrc/column_total.cuh``);
- ``"neural"``: the neural-scene forward render alone
  (``csrc/neural_kernel.cu``, ``sdf3d_neural_fwd``);
- ``"collectives"``: the ring all-reduces between processes and their
  buffers (``csrc/collectives.cu``, ``sdf3d_ring_allreduce``,
  ``sdf3d_rs_ag``, the region allocator, the CUDA IPC wrappers and the
  shared host segment of their flags: POSIX shared memory registered with
  CUDA).  It
  reads no scene: it is built from an empty header, one library for every
  scene.

The sources compile in parallel (one nvcc each), then link into one library,
cached by a hash of the kind, the header, every file under ``csrc/`` and the
flags, under ``build/sdf3d_tpu_torch/<hash>/`` beside the package.  A new
scene structure or static setting builds a new library; parameter values
never do.  nvcc is looked up in ``$CUDA_HOME/bin``, then
``/usr/local/cuda/bin``, then ``PATH``.

A build runs in a private temporary directory beside the final one and is
renamed into place when the library is linked, so processes that build the
same key at once (the ranks of a sharded run) never write into one
directory: the first rename wins, a later one finds the directory there and
discards its own copy.  ``KernelLibraries(host=True)`` builds the host
forms of the same sources with the C++ compiler (entry points with the
suffix ``_host``, no stream argument), the route of the CPU tests.

:func:`load_native` builds a host-only C++ source with a plain C interface
(the navigation controller of ``interact/``) with the C++ compiler into the
same build directory, keyed by a hash of the source and the flags, unless a
prebuilt library of the given name is in ``$SDF3D_NATIVE_DIR`` (the CMake
tree, as the JAX package's loader reads it).

``KernelLibraries.prefetch`` builds a queue of libraries on background
threads ahead of their first load (``chip_smoke.py`` queues every library it
knows up front); a load of a key in the queue waits for its build, or takes
it out of the queue if it has not started.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "sdf3d_tpu_torch"
SCENE_HEADER = "sdf3d_scene.cuh"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: The C++ compiler's flags of :func:`load_native`: those of the JAX package's
#: loader (``sdf3d_tpu/_native.py``), so both packages' builds of one source
#: give the same floats.
NATIVE_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
#: The C++ compiler's flags for the host forms (``KernelLibraries(host=True)``).
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O1", "-fPIC", "-Wall", "-Werror", "-Wno-unused-parameter")
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float
_I64 = ctypes.c_longlong
_U64 = ctypes.c_ulonglong
_STR = ctypes.c_char_p
# The collectives' entry points that both forms export: sizes, the shared
# host segment (POSIX shared memory) and the status words in it.
_COLL_COMMON = (
    ("sdf3d_coll_region_bytes", [_INT, _INT, _I64, _INT, _PTR]),
    ("sdf3d_coll_sync_bytes", [_INT, _INT, _PTR]),
    ("sdf3d_coll_shm_open", [_STR, _I64, _INT, _PTR]),
    ("sdf3d_coll_shm_close", [_PTR, _I64]),
    ("sdf3d_coll_shm_unlink", [_STR]),
    ("sdf3d_coll_status", [_INT, _INT, _PTR, _INT, _PTR]),
)


@dataclasses.dataclass(frozen=True)
class LibraryKind:
    """What a library of one kind is built from and exports: its file name,
    its sources under ``csrc/`` and its C entry points with their argument
    types (pointers, then H, W, stream; the fit step's silhouette weight and
    softness as floats, its view count V after W), and those of its host form
    (``host_entry_points``: the suffix ``_host``, no stream)."""

    lib_name: str
    sources: tuple
    entry_points: tuple  # ((name, argtypes), ...)
    host_entry_points: tuple


KINDS = {
    "render": LibraryKind("libsdf3d_render.so", ("render_kernel.cu", "fit_kernel.cu", "render_bwd_kernel.cu"), (
        ("sdf3d_render_fwd", [_PTR] * 6 + [_INT, _INT, _PTR]),
        ("sdf3d_render_tiles", [_PTR] * 8 + [_INT, _INT, _INT, _PTR]),
        ("sdf3d_fit_step", [_PTR] * 6 + [_FLT, _FLT] + [_PTR] * 2 + [_INT, _INT, _INT, _PTR]),
        ("sdf3d_fit_step_tiles", [_PTR] * 8 + [_FLT, _FLT] + [_PTR] * 2 + [_INT, _INT, _INT, _PTR]),
        ("sdf3d_fit_columns", [_PTR]),
        ("sdf3d_render_bwd", [_PTR] * 10 + [_INT, _INT, _INT, _PTR]),
    ), host_entry_points=(
        ("sdf3d_render_fwd_host", [_PTR] * 6 + [_INT, _INT]),
        ("sdf3d_render_tiles_host", [_PTR] * 8 + [_INT, _INT, _INT]),
        ("sdf3d_fit_step_host", [_PTR] * 6 + [_FLT, _FLT] + [_PTR] * 2 + [_INT, _INT, _INT]),
        ("sdf3d_fit_step_tiles_host", [_PTR] * 8 + [_FLT, _FLT] + [_PTR] * 2 + [_INT, _INT, _INT]),
        ("sdf3d_fit_retrace_host", [_PTR] * 7 + [_INT, _INT]),
        ("sdf3d_fit_columns", [_PTR]),
        ("sdf3d_render_bwd_host", [_PTR] * 10 + [_INT, _INT, _INT]),
    )),
    "neural": LibraryKind("libsdf3d_neural.so", ("neural_kernel.cu",), (
        ("sdf3d_neural_fwd", [_PTR] * 7 + [_INT, _INT, _PTR]),
    ), host_entry_points=(
        ("sdf3d_neural_fwd_host", [_PTR] * 6 + [_INT, _INT]),
        ("sdf3d_neural_fwd_blocks_host", [_PTR] * 6 + [_INT, _INT, _INT]),
    )),
    "collectives": LibraryKind("libsdf3d_collectives.so", ("collectives.cu",), (
        *_COLL_COMMON,
        ("sdf3d_ring_allreduce", [_INT] + [_PTR] * 6 + [_I64, _INT, _INT, _INT, _INT, _I64, _U64, _I64, _PTR]),
        ("sdf3d_rs_ag", [_INT] + [_PTR] * 6 + [_I64, _INT, _INT, _INT, _INT, _I64, _U64, _I64, _PTR]),
        ("sdf3d_coll_local_run", [_INT, _INT, _INT] + [_PTR] * 5 + [_I64, _INT, _I64, _I64, _INT, _U64, _I64, _PTR,
                                                                      _PTR]),
        ("sdf3d_coll_alloc", [_INT, _I64, _PTR]),
        ("sdf3d_coll_free", [_INT, _PTR]),
        ("sdf3d_coll_sync_register", [_INT, _PTR, _I64, _PTR]),
        ("sdf3d_coll_sync_unregister", [_INT, _PTR]),
        ("sdf3d_ipc_get_handle", [_INT, _PTR, _PTR]),
        ("sdf3d_ipc_open", [_INT, _PTR, _PTR]),
        ("sdf3d_ipc_close", [_INT, _PTR]),
    ), host_entry_points=(
        *_COLL_COMMON,
        ("sdf3d_ring_allreduce_host", [_INT, _PTR, _PTR, _I64, _INT, _INT, _INT, _INT, _I64, _I64, _PTR]),
        ("sdf3d_rs_ag_host", [_INT, _PTR, _PTR, _I64, _INT, _INT, _INT, _INT, _I64, _I64, _PTR]),
    )),
}


def find_nvcc() -> str:
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH")
    return found


def find_cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
    return found


class KernelLibraries:
    """Builds, caches and loads one kernel library per generated header and
    kind.

    ``builds`` counts the libraries built in this process (parallel
    compiles and a link each) and ``build_seconds`` their wall time;
    ``loaded`` counts the libraries loaded (built here or found in the build
    directory).  ``log(key)`` returns a build's compiler output (with
    ``-Xptxas -v``: registers, spills and shared memory per kernel).
    ``load_many`` builds several libraries at once, one thread each.
    ``prefetch`` builds libraries ahead of their first load on background
    threads (counted apart: ``prefetched``, ``prefetch_seconds``).
    ``host=True``: the host forms, built by the C++ compiler (module
    docstring).  ``csrc``: the sources' directory (a copy with a constant
    changed builds libraries of its own keys, loadable beside this one's).
    """

    def __init__(self, build_dir: pathlib.Path = BUILD_DIR, host: bool = False, csrc: pathlib.Path = CSRC):
        self.build_dir = pathlib.Path(build_dir)
        self.host = host
        self.csrc = pathlib.Path(csrc)
        self.builds = 0
        self.build_seconds = 0.0
        self.prefetched = 0
        self.prefetch_seconds = 0.0
        self._pending: dict[str, concurrent.futures.Future] = {}
        self._planning: list[threading.Event] = []
        self._loaded: dict[str, ctypes.CDLL] = {}
        self._by_structure: dict = {}
        self._csrc: tuple[str, ...] | None = None
        self._lock = threading.Lock()

    @property
    def loaded(self) -> int:
        return len(self._loaded)

    @property
    def flags(self) -> tuple:
        return HOST_FLAGS if self.host else NVCC_FLAGS

    def key(self, scene_header: str, kind: str = "render") -> str:
        """The build key: a hash of the kind, the header, every file under
        ``csrc/`` (names and texts) and the flags."""
        if self._csrc is None:
            self._csrc = tuple(f"{f.name}\0{f.read_text()}" for f in sorted(self.csrc.iterdir()) if f.is_file())
        h = hashlib.sha256()
        for part in (kind, scene_header, *self._csrc, " ".join(self.flags)):
            h.update(part.encode())
            h.update(b"\0")
        return h.hexdigest()[:20]

    def log(self, key: str) -> str:
        path = self.build_dir / key / "build.log"
        return path.read_text() if path.exists() else ""

    def load_for(self, structure, make_header, kind: str = "render") -> ctypes.CDLL:
        """``load(make_header(), kind)``, memoised on the hashable
        ``structure`` the header is a function of, so a frame of a known
        structure neither regenerates nor re-hashes its source."""
        lib = self._by_structure.get((kind, structure))
        if lib is None:
            lib = self.load(make_header(), kind)
            self._by_structure[(kind, structure)] = lib
        return lib

    def load_many(self, jobs) -> list:
        """``load_for(*job)`` for every job ``(structure, make_header,
        kind)``, the builds running at the same time."""
        with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
            futures = [pool.submit(self.load_for, *job) for job in jobs]
            return [f.result() for f in futures]

    def prefetch(self, jobs, workers: int = 2) -> concurrent.futures.Future:
        """Build the libraries of ``jobs`` (``load_for``'s ``(structure,
        make_header, kind)``) ahead of their first :meth:`load`, in the order
        given, ``workers`` at a time on background threads: each is compiled
        into the build directory and not loaded.  A :meth:`load` of a key
        the queue is building waits for that build; a key still waiting its
        turn is taken out of the queue and built by the load itself.  The
        queue's builds count in ``prefetched`` and ``prefetch_seconds``, not
        in ``builds``.  Returns a future of the whole queue (the number of
        libraries it built), which raises the first failed build.  The
        queue's headers are generated first, on one thread: until they are,
        a :meth:`load` waits for them too."""
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
        planned = threading.Event()
        self._planning.append(planned)

        def plan():
            futures = []
            try:
                for _, make_header, kind in jobs:
                    header = make_header()
                    key = self.key(header, kind)
                    with self._lock:
                        if key in self._pending or key in self._loaded:
                            continue
                        self._pending[key] = future = pool.submit(self._prefetch_one, key, header, KINDS[kind])
                    futures.append(future)
            finally:
                planned.set()
            return sum(f.result() for f in futures if not f.cancelled())

        planner = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        done = planner.submit(plan)
        done.add_done_callback(lambda _: (pool.shutdown(wait=False), planner.shutdown(wait=False)))
        return done

    def _prefetch_one(self, key: str, scene_header: str, spec: LibraryKind) -> int:
        path = self.build_dir / key / spec.lib_name
        if path.exists():
            return 0
        seconds = self._compile(path.parent, scene_header, spec)
        with self._lock:
            self.prefetched += 1
            self.prefetch_seconds += seconds
        return 1

    def load(self, scene_header: str, kind: str = "render") -> ctypes.CDLL:
        spec = KINDS[kind]
        key = self.key(scene_header, kind)
        lib = self._loaded.get(key)
        if lib is None:
            path = self.build_dir / key / spec.lib_name
            for planned in self._planning:
                planned.wait()
            with self._lock:
                pending = self._pending.get(key)
            if pending is not None and not pending.cancel():
                concurrent.futures.wait([pending])  # a failed prefetch is built (and raised) here
            if not path.exists():
                seconds = self._compile(path.parent, scene_header, spec)
                with self._lock:
                    self.builds += 1
                    self.build_seconds += seconds
            lib = ctypes.CDLL(str(path))
            for name, argtypes in spec.host_entry_points if self.host else spec.entry_points:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            with self._lock:
                self._loaded[key] = lib
        return lib

    def _commands(self, tmp: pathlib.Path, spec: LibraryKind):
        """The compile commands (one per source) and the link command of a
        build in ``tmp``."""
        objs = [tmp / (src + ".o") for src in spec.sources]
        out = tmp / spec.lib_name
        if self.host:
            cxx = find_cxx()
            compiles = [[cxx, *HOST_FLAGS, "-I", str(self.csrc), "-I", str(tmp), "-c", "-o", str(obj),
                         str(self.csrc / src)]
                        for src, obj in zip(spec.sources, objs)]
            return compiles, [cxx, "-shared", "-pthread", "-o", str(out), *map(str, objs)]
        nvcc = find_nvcc()
        compiles = [[nvcc, *NVCC_FLAGS, "-I", str(self.csrc), "-I", str(tmp), "-c", "-o", str(obj),
                     str(self.csrc / src)]
                    for src, obj in zip(spec.sources, objs)]
        return compiles, [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(out), *map(str, objs)]

    def _compile(self, out_dir: pathlib.Path, scene_header: str, spec: LibraryKind) -> float:
        """Build into a private temporary directory, then rename it to
        ``out_dir`` (module docstring); returns the build's seconds."""
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = pathlib.Path(tempfile.mkdtemp(prefix=out_dir.name + ".", dir=self.build_dir))
        try:
            (tmp / SCENE_HEADER).write_text(scene_header)
            compiles, link = self._commands(tmp, spec)
            t0 = time.perf_counter()
            # One compiler per source, all started together, then one link.
            procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                     for cmd in compiles]
            log, failed = [], []
            for cmd, proc in procs:
                out, _ = proc.communicate()
                log.append(" ".join(cmd) + "\n" + out)
                if proc.returncode != 0:
                    failed.append(out)
            if not failed:
                proc = subprocess.run(link, capture_output=True, text=True)
                log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    failed.append(proc.stderr)
            seconds = time.perf_counter() - t0
            (tmp / "build.log").write_text("\n".join(log))
            if failed:
                raise RuntimeError(f"the build of {out_dir / SCENE_HEADER} failed:\n" + "\n".join(failed))
            try:
                os.rename(tmp, out_dir)
            except OSError:
                # Another process published this key first; keep its copy.
                # A directory without the library (left by an interrupted
                # build) is replaced.
                if not (out_dir / spec.lib_name).exists():
                    shutil.rmtree(out_dir, ignore_errors=True)
                    os.rename(tmp, out_dir)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return seconds


#: The process's library cache.
LIBRARIES = KernelLibraries()


def load_native(src: pathlib.Path, build_dir: pathlib.Path = BUILD_DIR,
                prebuilt_name: str | None = None) -> ctypes.CDLL:
    """Load the shared library of the host C++ source ``src`` (a plain C
    interface).  In the JAX package's loader's order: a prebuilt library
    ``$SDF3D_NATIVE_DIR/<prebuilt_name>`` (the CMake build tree's, e.g.
    ``libsdf3d_navigation.so``) where the variable and that file exist;
    else the cached build ``build_dir/native/<stem>_<hash>.so``, the hash
    over the source and the flags; else one ``find_cxx()`` call with
    :data:`NATIVE_FLAGS` builds it there.  The library is written under a
    private name and renamed into place, so processes that build it at once
    never load a partial file.  Raises on a failed build."""
    prebuilt_dir = os.environ.get("SDF3D_NATIVE_DIR")
    if prebuilt_name and prebuilt_dir:
        candidate = pathlib.Path(prebuilt_dir) / prebuilt_name
        if candidate.exists():
            return ctypes.CDLL(str(candidate))
    src = pathlib.Path(src)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NATIVE_FLAGS).encode())
    out_dir = pathlib.Path(build_dir) / "native"
    path = out_dir / f"{src.stem}_{h.hexdigest()[:16]}.so"
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=path.name + ".", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run([find_cxx(), *NATIVE_FLAGS, str(src), "-o", tmp], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"the build of {src} failed:\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(path))
