"""Checkpoint and resume for fits (the port of ``sdf3d_tpu/checkpoint.py``).

A checkpoint is a directory holding ``state.pt`` (a dict of ``state_dict``s,
the scene's and the optimizer's, written with ``torch.save``) and
``manifest.json`` (the step, the loss history and the fit's fingerprint).
Each file is written to a temporary name and moved into place with
``os.replace``, so a crash mid-write never corrupts the previous snapshot.
The format is the port's own: the JAX package (flax msgpack) cannot read it,
nor this module the JAX package's.

In a sharded run only rank 0 writes (``parallel.launch.is_primary``): the fit
state is replicated, so its copy is complete, and ranks racing
``os.replace`` on one directory would corrupt it.  Every rank may read.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import tempfile

import torch

from sdf3d_tpu_torch.parallel import launch


def _atomic_write(path: pathlib.Path, name: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=path, prefix=name + ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path / name)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(path: str | os.PathLike, state: dict, step: int, meta: dict | None = None) -> None:
    """Atomically write ``state`` (a dict of tensors and ``state_dict``s) and
    a manifest with ``step`` and ``meta`` to the directory ``path``; a no-op
    on every rank but rank 0 of a sharded run."""
    if not launch.is_primary():
        return
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    torch.save(state, buf)
    _atomic_write(path, "state.pt", buf.getvalue())
    manifest = {"step": int(step), **(meta or {})}
    _atomic_write(path, "manifest.json", json.dumps(manifest, indent=2).encode())


def load_checkpoint(path: str | os.PathLike, map_location=None):
    """``(state, manifest)`` from the directory ``path``, or ``(None, None)``
    when it holds no checkpoint.  Tensors load onto ``map_location``; only
    tensors and plain containers are unpickled (``weights_only``)."""
    path = pathlib.Path(path)
    state_file = path / "state.pt"
    if not state_file.exists():
        return None, None
    state = torch.load(state_file, map_location=map_location, weights_only=True)
    manifest = json.loads((path / "manifest.json").read_text())
    return state, manifest
