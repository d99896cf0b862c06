"""Local multi-process runs of the labs: one process per rank on this host,
their rendezvous on a free local port (``parallel.launch.initialize``)."""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(module: str, world: int, args: list, timeout: float = 600.0) -> list:
    """Run ``python -m module *args --rank r --world world --address
    tcp://127.0.0.1:<port>`` for every rank r at once and return each
    rank's result, the JSON object on the last line of its output, in rank
    order.  When a rank fails (or the time runs out) the others are stopped
    and this raises with the outputs; no process outlives the call."""
    address = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", module, *map(str, args), "--rank", str(r), "--world",
                               str(world), "--address", address], env=env, stdout=log, stderr=subprocess.STDOUT,
                              text=True) for r, log in enumerate(logs)]
    try:
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: its peers would wait for it until their own timeouts
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    failed = [f"rank {r} (exit {p.returncode}):\n{out[-3000:]}" for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{module} over {world} ranks failed:\n" + "\n".join(failed))
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]
