"""Run one cell of ``BENCHMARK.json`` once on the card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared with its limit.  The numbers compared
are also the last lines of standard error.  Without a card, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, the run prints no result and exits with a code other
than 0.

Every cache of the program stays at a fixed path inside the checkout: the
port's native libraries under ``build/sdf3d_tpu_torch`` (its own fixed
directory), Triton's, PyTorch's extensions' and CUDA's under
``build/portbench``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _caches() -> None:
    base = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    import torch

    from portbench.core import manifest

    want = manifest.cell(manifest.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"portbench: the cell needs {want} CUDA device(s); {have} visible")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return report(args.workload, args.seed, args.seconds, bool(args.trace), ROOT, "cuda")


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def report(workload: str, seed: int, seconds: float, traced: bool, root=ROOT, device="cuda",
           traffic_overrides=None) -> int:
    """Run the cell on ``device`` and print its result, unless a module that
    no run may load is loaded when the result would be printed."""
    from portbench.core import cell

    result, rows, loaded, _ = cell.run_cell(workload, seed, seconds, traced, root, device=device,
                                            traffic_overrides=traffic_overrides, log=_log)
    loaded = sorted(set(loaded) | set(cell.forbidden_modules()))
    if loaded:
        _log(f"portbench: modules loaded that no run may load: {', '.join(loaded)}")
        return 3
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    for name, value, limit in rows:
        _log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
