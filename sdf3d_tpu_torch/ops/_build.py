"""Build and load the CUDA render kernel: nvcc into a shared library with a
plain C interface, loaded with ctypes.

Each library is compiled from ``csrc/render_kernel.cu`` with one generated
header (``sdf3d_scene.cuh``, ops/scene_program.py) and cached by a hash of
every source text and flag, under ``build/sdf3d_tpu_torch/<hash>/`` beside
the package.  A new scene structure or static setting builds a new library;
parameter values never do.  nvcc is looked up in ``$CUDA_HOME/bin``, then
``/usr/local/cuda/bin``, then ``PATH``.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


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
    """Builds, caches and loads one render library per generated header.

    ``builds`` counts nvcc runs in this process and ``build_seconds`` their
    wall time; ``loaded`` counts the libraries loaded (built here or found
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
        """The build key: a hash of every source text and flag."""
        if self._csrc is None:
            self._csrc = tuple((CSRC / n).read_text() for n in ("render_kernel.cuh", "render_kernel.cu"))
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
            ptr = ctypes.c_void_p
            lib.sdf3d_render_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ptr]
            lib.sdf3d_render_fwd.restype = ctypes.c_int
            self._loaded[key] = lib
        return lib

    def _compile(self, out_dir: pathlib.Path, scene_header: str) -> None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / SCENE_HEADER).write_text(scene_header)
        # Compile to a temporary name and rename, so a concurrent process
        # never loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-I", str(out_dir),
               "-o", tmp, str(CSRC / "render_kernel.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {out_dir / SCENE_HEADER}:\n{proc.stderr}"
            )
        os.replace(tmp, out_dir / LIB_NAME)
        self.builds += 1
        self.build_seconds += seconds


#: The process's library cache.
LIBRARIES = KernelLibraries()
