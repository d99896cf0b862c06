"""Build and load the CUDA kernels: nvcc into a shared library with a plain C
interface, loaded with ctypes.

Each library holds the three kernels of one generated header
(``sdf3d_scene.cuh``, ops/scene_program.py): the forward render
(``csrc/render_kernel.cu``, ``sdf3d_render_fwd``), the fused fit step
(``csrc/fit_kernel.cu``, ``sdf3d_fit_step``) and the render backward
(``csrc/render_bwd_kernel.cu``, ``sdf3d_render_bwd``).  The three sources
compile in parallel (one nvcc each), then link into one library, cached by a
hash of the header, every file under ``csrc/`` and the flags, under
``build/sdf3d_tpu_torch/<hash>/`` beside the package.  A new scene structure
or static setting builds a new library; parameter values never do.  nvcc is
looked up in ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "sdf3d_tpu_torch"
SCENE_HEADER = "sdf3d_scene.cuh"
LIB_NAME = "libsdf3d_render.so"
SOURCES = ("render_kernel.cu", "fit_kernel.cu", "render_bwd_kernel.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
#: C entry points and their argument types (pointers, then H, W, stream).
ENTRY_POINTS = {
    "sdf3d_render_fwd": [_PTR] * 6 + [_INT, _INT, _PTR],
    "sdf3d_fit_step": [_PTR] * 6 + [_INT, _INT, _PTR],
    "sdf3d_render_bwd": [_PTR] * 9 + [_INT, _INT, _PTR],
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


class KernelLibraries:
    """Builds, caches and loads one kernel library per generated header.

    ``builds`` counts the libraries built in this process (three parallel
    nvcc compiles and a link each) and ``build_seconds`` their wall time; ``loaded`` counts the libraries loaded (built here or found
    in the build directory).  ``log(key)`` returns a build's compiler output
    (with ``-Xptxas -v``: registers, spills and shared memory per kernel).
    """

    def __init__(self, build_dir: pathlib.Path = BUILD_DIR):
        self.build_dir = pathlib.Path(build_dir)
        self.builds = 0
        self.build_seconds = 0.0
        self._loaded: dict[str, ctypes.CDLL] = {}
        self._by_structure: dict = {}
        self._csrc: tuple[str, ...] | None = None

    @property
    def loaded(self) -> int:
        return len(self._loaded)

    def key(self, scene_header: str) -> str:
        """The build key: a hash of the header, every file under ``csrc/``
        (names and texts) and the flags."""
        if self._csrc is None:
            self._csrc = tuple(f"{f.name}\0{f.read_text()}" for f in sorted(CSRC.iterdir()) if f.is_file())
        h = hashlib.sha256()
        for part in (scene_header, *self._csrc, " ".join(NVCC_FLAGS)):
            h.update(part.encode())
            h.update(b"\0")
        return h.hexdigest()[:20]

    def log(self, key: str) -> str:
        path = self.build_dir / key / "build.log"
        return path.read_text() if path.exists() else ""

    def load_for(self, structure, make_header) -> ctypes.CDLL:
        """``load(make_header())``, memoised on the hashable ``structure``
        the header is a function of, so a frame of a known structure neither
        regenerates nor re-hashes its source."""
        lib = self._by_structure.get(structure)
        if lib is None:
            lib = self._by_structure[structure] = self.load(make_header())
        return lib

    def load(self, scene_header: str) -> ctypes.CDLL:
        key = self.key(scene_header)
        lib = self._loaded.get(key)
        if lib is None:
            path = self.build_dir / key / LIB_NAME
            if not path.exists():
                self._compile(path.parent, scene_header)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._loaded[key] = lib
        return lib

    def _compile(self, out_dir: pathlib.Path, scene_header: str) -> None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / SCENE_HEADER).write_text(scene_header)
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        # One nvcc per source, all started together, then one link.
        objs, procs = [], []
        for src in SOURCES:
            obj = out_dir / (src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-I", str(out_dir), "-c", "-o", str(obj), str(CSRC / src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        # Link to a temporary name and rename, so a concurrent process never
        # loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        if not failed:
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr)
        seconds = time.perf_counter() - t0
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {out_dir / SCENE_HEADER}:\n" + "\n".join(failed))
        os.replace(tmp, out_dir / LIB_NAME)
        self.builds += 1
        self.build_seconds += seconds


#: The process's library cache.
LIBRARIES = KernelLibraries()
