"""The control of the comparison that decides ``correct``: the reference
put in the program's place and computed in bfloat16, the precision next
below the configuration's float32, judged by the same comparison against
the float32 reference.  It has to come out as not correct.

    python3 -m portbench.control --workload <cell> --seeds <n> <n> <n> [--device cuda]

prints, for each seed, one JSON line of the numbers compared and their
limits.  A render cell's control renders a sample of the cell's views (drawn
from the seed).  A fit cell's control is a run of the cell at its size with
a short window (the program's fit jobs, and the job drawn for the check,
as in a run of the benchmark); at each checked step the reference in
bfloat16 takes the program's place from the state the program reached
there: its loss, its gradient and its Adam step from the program's moments
and that gradient are what the float32 reference judges.  The benchmark's
runs never run it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from portbench.core import cell as harness
from portbench.core import check, inputs, manifest
from portbench.reference import fit as ref_fit
from portbench.reference import shader
from portbench.reference.scene import PlainScene, spec_values


def control_numbers(workload: str, seed: int, root=manifest.ROOT, device="cpu", traffic_overrides=None,
                    dtype=torch.bfloat16) -> tuple:
    """``(numbers, limits)`` of the reference in ``dtype`` against the
    reference in float32 on the cell's inputs of ``seed``."""
    device = torch.device(device)
    mf = manifest.load(root)
    cell = manifest.cell(mf, workload)
    config = manifest.config(mf, cell["config"], root)
    traffic = {**manifest.traffic(cell["traffic"], root), **(traffic_overrides or {})}
    spec, W, H, settings = config["scene"], traffic["width"], traffic["height"], config["render"]
    limits = traffic["check"]["limits"]

    def side(dt):
        return (check.plain_light(config, dt, device), check.plain_material(config, dt, device))

    if traffic["kind"] == "render":
        _, views = inputs.render_views(traffic, seed)
        rng = inputs.streams(seed)["check"]
        pick = rng.choice(len(views), size=min(traffic["check"]["images"], len(views)), replace=False)
        pairs = []
        for v in sorted(pick):
            cam = check.plain_camera(views[v], device)
            low = shader.render(PlainScene(spec, spec_values(spec), dtype, device), cam, *side(dtype), settings, W, H)[0]
            ref = shader.render(PlainScene(spec, spec_values(spec), torch.float32, device), cam, *side(torch.float32),
                                settings, W, H)[0]
            pairs.append((low, ref))
        return check.render_numbers(pairs), limits
    stand_in = lower_precision(config, dtype, device)
    _, rows, _, _ = harness.run_cell(workload, seed, 0.5, False, root, device.type, traffic_overrides,
                                     log=lambda line: None, stand_in=stand_in)
    return {name: value for name, value, _ in rows}, limits


def lower_precision(config: dict, dtype, device):
    """The control's stand-in for a fit mix's run (``cell.run_cell``'s
    ``stand_in``): at each checked step, the reference in ``dtype`` at the
    program's parameters gives the loss and the gradient, and its Adam step
    from the program's moments and that gradient the next parameters."""
    light, mat = check.plain_light(config, dtype, device), check.plain_material(config, dtype, device)

    def stand_in(scene_of, keys, prog, camera, settings, target, lr):
        prog_low, prog_next, losses = {}, {}, {}
        for s, st in sorted(prog.items()):
            scene = scene_of(st["theta"], dtype)
            loss, grads = shader.loss_and_grads(scene, keys, camera, light, mat, settings, target)
            losses[s] = float(loss)
            prog_low[s] = {**st, "grad": {k: grads[k].to(scene.tensors[k].dtype) for k in keys}}
            prog_next[s] = {k: ref_fit.adam_step(scene.tensors[k].detach(), grads[k], st["m"][k].to(dtype),
                                                 st["v"][k].to(dtype), s + 1, lr)[0] for k in keys}
        return prog_low, prog_next, losses

    return stand_in


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        numbers, limits = control_numbers(args.workload, seed, device=args.device)
        failed = [k for k, v in numbers.items() if not (np.isfinite(v) and v <= limits[k])]
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers, "limits": limits,
                          "control_fails": bool(failed), "failed_numbers": failed}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
