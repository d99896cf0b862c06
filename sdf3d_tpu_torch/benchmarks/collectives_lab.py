"""Collective message-count and wire-traffic lab (the port of
``benchmarks/collectives_lab.py``).

What can be checked without a slice of several cards:

- per-link wire traffic of both ring all-reduces, from the schedules the
  port's K7 and K8 walk (``parallel/collectives.py``: ``ring_schedule``,
  ``rs_ag_schedule``; the kernels and their plain versions send exactly
  the schedule's messages, so these are their message counts): K7 sends a
  half of the vector a message, K8 one of its ``2·N`` chunks
  (``ring_kernel.rs_ag_chunk``);
- the ``"auto"`` pick at each size (``collectives._rs_ag_threshold``);
- with ``--run``, K7 and K8 through ``pallas_psum`` over N processes on
  the card, each against its plain version (``interpret=True``) bit for
  bit, and against numpy's sum.  Processes that share a card exchange
  through host memory (gloo) and time the switch between them, not a link.

The JAX lab's padded planes ((8, 128)-multiple lanes) are the TPU's layout;
the port's buffers hold the vector unpadded (K8 pads to ``2·N`` equal
chunks only), so there is no padding tax to report.

    python -m sdf3d_tpu_torch.benchmarks.collectives_lab [--num 8] [--run] [--device cuda|cpu]

Prints a table, then one JSON object (``analysis``, and ``run`` with each
case and the kernel launches of rank 0).  ``--run`` runs on the card;
``--device cpu`` runs the plain versions in CPU processes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SIZES = (1 << 10, 16 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)
#: The sizes of ``--run`` (the JAX lab's first three).
RUN_SIZES = SIZES[:3]


def analyze(num: int, payload_bytes: int, itemsize: int = 4) -> dict:
    """Messages and bytes a link carries for one all-reduce of
    ``payload_bytes`` (float32 elements by default) over ``num`` ranks, for
    each ring, and what ``"auto"`` picks."""
    from sdf3d_tpu_torch.parallel.collectives import _rs_ag_threshold, ring_schedule, rs_ag_schedule
    from sdf3d_tpu_torch.parallel.ring_kernel import rs_ag_chunk

    n = payload_bytes // itemsize
    ring_msgs = sum(1 for op, _, _ in ring_schedule(num) if op == "start")
    rsag_msgs = sum(1 for op, _, _ in rs_ag_schedule(num) if op == "start")
    return {
        "payload_bytes": payload_bytes,
        "auto": "rs_ag" if n >= _rs_ag_threshold(num) else "ring",
        # K7: stream A carries the first ceil(n/2) elements, B the rest.
        "ring": {"messages_per_link": ring_msgs, "bytes_per_link": ring_msgs * n * itemsize // 2},
        "rs_ag": {"messages_per_link": rsag_msgs, "bytes_per_link": rsag_msgs * rs_ag_chunk(n, num) * itemsize},
    }


def run_rank(address: str, world: int, rank: int, device: str, sizes=RUN_SIZES, calls: int = 5) -> dict:
    """One rank of ``--run``: join the group, then for each size and ring
    the kernel's sum against its plain version's (bit for bit) and
    numpy's, and the host time of a call (``calls`` calls, synchronised)."""
    import numpy as np
    import torch

    from sdf3d_tpu_torch.parallel import launch, make_mesh, pallas_psum
    from sdf3d_tpu_torch.parallel.ring_kernel import ring_allreduce, rs_ag_allreduce

    launch.initialize(address, world_size=world, rank=rank, device=device)
    mesh = make_mesh(device)
    rng = np.random.default_rng(0)
    cases = []
    for size in sizes:
        x_all = rng.standard_normal((world, size // 4)).astype(np.float32)
        x = torch.from_numpy(x_all[rank]).to(mesh.device)
        for algorithm in ("ring", "rs_ag"):
            got = pallas_psum(x, mesh, algorithm).cpu()
            plain = pallas_psum(x, mesh, algorithm, interpret=True).cpu()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            for _ in range(calls):
                out = pallas_psum(x, mesh, algorithm)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            ms = (time.perf_counter() - t0) / calls * 1e3
            cases.append({"payload_bytes": size, "algorithm": algorithm, "bit_equal": bool(torch.equal(got, plain)),
                          "same_as_last_call": bool(torch.equal(out.cpu(), got)),
                          "max_abs_err_vs_numpy": float(np.max(np.abs(got.numpy() - x_all.sum(0)))), "ms": ms})
    launches = {"ring_allreduce": ring_allreduce.launches, "rs_ag_allreduce": rs_ag_allreduce.launches}
    backend = torch.distributed.get_backend()
    launch.shutdown()
    return {"rank": rank, "num": world, "device": mesh.device.type, "backend": backend, "cases": cases,
            "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdf3d_tpu_torch.benchmarks.collectives_lab", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--num", type=int, default=8)
    ap.add_argument("--run", action="store_true", help="K7 and K8 against their plain versions over --num processes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:  # one rank of --run
        print(json.dumps(run_rank(args.address, args.world, args.rank, args.device)), flush=True)
        return 0

    result = {"num": args.num, "analysis": [analyze(args.num, size) for size in SIZES]}
    print(f"{'payload':>10} {'auto':>6} | {'ring msgs':>9} {'ring B/link':>12} | "
          f"{'rsag msgs':>9} {'rsag B/link':>12} {'saving':>7}")
    for a in result["analysis"]:
        saving = a["ring"]["bytes_per_link"] / max(a["rs_ag"]["bytes_per_link"], 1)
        print(f"{a['payload_bytes']:>10} {a['auto']:>6} | {a['ring']['messages_per_link']:>9} "
              f"{a['ring']['bytes_per_link']:>12} | {a['rs_ag']['messages_per_link']:>9} "
              f"{a['rs_ag']['bytes_per_link']:>12} {saving:>6.2f}x")
    if args.run:
        import torch

        from sdf3d_tpu_torch.benchmarks._ranks import run_ranks

        if torch.device(args.device).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("--run runs on the card and no CUDA device is visible (--device cpu)")
            from sdf3d_tpu_torch.parallel.ring_kernel import collectives_library

            collectives_library()  # built once here, before the ranks start
        ranks = run_ranks("sdf3d_tpu_torch.benchmarks.collectives_lab", args.num, ["--device", args.device])
        bad = [(r["rank"], c) for r in ranks for c in r["cases"] if not c["bit_equal"]]
        for c in ranks[0]["cases"]:
            print(f"  {c['algorithm']:>5} {c['payload_bytes']:>9} B: bit_equal={c['bit_equal']} "
                  f"err_vs_numpy={c['max_abs_err_vs_numpy']:.3g} {c['ms']:.3f} ms")
        result["run"] = ranks[0]
        if bad:
            print(json.dumps(result), flush=True)
            raise AssertionError(f"a kernel differs from its plain version: {bad[:4]}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
