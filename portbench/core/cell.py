"""One run of one cell: set-up, the measured window, and, once the window
has closed, the device's readings, the trace's reduction, the roofline's
work and the comparison with the reference.

A render cell's window is a closed loop of one client: each request is one
``render_batch`` call over the request's cameras (made on the host, as a
client sends them), then a device synchronisation; the next request starts
when it returns.  A fit cell's window runs fit jobs back to back, each one
``fit_scene`` call (which ends in a device synchronisation).  Either window
ends with the first request or job that returns after ``seconds`` (and not
before the job drawn for the check has returned); its rates are taken over
all of its work and all of its time, and a tail over all of its requests.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import sys
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from portbench.core import check, inputs, manifest, program, roofline, trace
from portbench.reference import shader
from portbench.reference.scene import PlainScene, spec_values, trainable_keys

#: Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "sdf3d_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def host_witness(device) -> dict:
    """The host's speed on fixed work, each part timed alone: a pure-Python
    loop (``python_s``), numpy (``numpy_s``: a sort of 2^21 seeded floats and
    20 products of 256×256 matrices) and, on the card, 2000 launches of an
    empty kernel with one synchronisation (``launch_us``, µs a launch).  A
    host-paced window reads against another run's through it."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(3_000_000):
        acc += i * i % 7
    out = {"python_s": time.perf_counter() - t0}
    rng = np.random.default_rng(0)
    x, m = rng.random(1 << 21), rng.random((256, 256))
    t0 = time.perf_counter()
    np.sort(x)
    for _ in range(20):
        m = m @ m
        m /= np.abs(m).max()
    out["numpy_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(2000):
            torch.cuda._sleep(0)
        torch.cuda.synchronize(device)
        out["launch_us"] = (time.perf_counter() - t0) / 2000 * 1e6
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear between ranks)."""
    return statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1] if len(values) > 1 else values[0]


@dataclasses.dataclass
class Run:
    """What one run measured; the metrics' readers read it."""

    cell: str
    kind: str  # "render" | "fit"
    width: int
    height: int
    seconds: float = 0.0  # the window's length by the host clock
    requests: int = 0  # requests or jobs
    frames: int = 0
    latencies: list = dataclasses.field(default_factory=list)  # s a request or job
    enqueue: list = dataclasses.field(default_factory=list)  # s a request, before its sync
    steps: int = 0
    setup_s: float = 0.0  # the process's age at the window's start, less reference_s
    reference_s: float = 0.0  # the reference's seconds in set-up (a fit's target)
    prepare_s: float = 0.0
    build: dict = dataclasses.field(default_factory=dict)
    trace: trace.Trace | None = None
    k1_bound_s: float | None = None  # the window's frames
    k3_bound_s: float | None = None  # the window's steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``rng``."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


class _StepRecorder:
    """The optimizer's state before the steps ``record`` of one fit job, read
    by ``torch.optim``'s global pre-step hook: the parameters, the gradient
    as the optimizer gets it, Adam's moments (zeros before the first step),
    keyed by ``keys`` in the optimizer's order."""

    def __init__(self, keys: list, record: set):
        self.keys, self.record, self.states, self.step = keys, record, {}, 0
        self.handle = register_optimizer_step_pre_hook(self)

    def __call__(self, opt, args, kwargs):
        if self.step in self.record:
            params = opt.param_groups[0]["params"]
            st = {"theta": {}, "grad": {}, "m": {}, "v": {}}
            for k, p in zip(self.keys, params):
                state = opt.state.get(p, {})
                st["theta"][k] = p.detach().clone()
                st["grad"][k] = p.grad.detach().clone()
                st["m"][k] = state["exp_avg"].clone() if "exp_avg" in state else torch.zeros_like(p)
                st["v"][k] = state["exp_avg_sq"].clone() if "exp_avg_sq" in state else torch.zeros_like(p)
            self.states[self.step] = st
        self.step += 1

    def close(self):
        self.handle.remove()


def run_cell(workload: str, seed: int, seconds: float, traced: bool, root=manifest.ROOT, device="cuda",
             traffic_overrides: dict | None = None, log=print, stand_in=None):
    """``(result, checks, forbidden, run)``: the result line's object, the
    numbers compared ``[(name, value, limit)]``, the forbidden modules found
    loaded once the reference, the roofline's counts and the metrics' readers
    have run, and the run's record.  ``log`` takes the lines printed before
    the result (standard error).  ``stand_in`` (the control's, a fit mix's
    only) replaces what the program computed at the checked steps before the
    comparison: ``stand_in(scene_of, keys, prog, camera, settings, target,
    lr) -> (prog, prog_next, prog_losses)``."""
    device = torch.device(device)
    host = torch.device("cpu")
    mf = manifest.load(root)
    cell = manifest.cell(mf, workload)
    config = manifest.config(mf, cell["config"], root)
    traffic = {**manifest.traffic(cell["traffic"], root), **(traffic_overrides or {})}
    streams = inputs.streams(seed)
    W, H = traffic["width"], traffic["height"]
    run = Run(cell=workload, kind=traffic["kind"], width=W, height=H)
    spec, settings = config["scene"], config["render"]
    cfg = program.render_config(config, W, H)
    lt, mat = program.light(config, host), program.material(config, host)
    plt, pmat = check.plain_light(config, torch.float32, device), check.plain_material(config, torch.float32, device)
    n_params = sum(int(np.asarray(x).size) for x in spec_values(spec).values())
    spans = trace.Spans(traced)
    check_spec = traffic["check"]

    if run.kind == "render":
        _, views = inputs.render_views(traffic, seed)
        scene = program.build_scene(spec, spec_values(spec)).to(device)
        cams = [program.camera(v, host) for v in views]

        def request(r):
            return program.render_batch(scene, [cams[i] for i in inputs.request_views(traffic, r)], lt, mat, cfg,
                                        device)

        t0 = time.perf_counter()
        first = request(0)
        _sync(device)
        run.prepare_s = time.perf_counter() - t0
        del first
    else:
        ref_cam = check.plain_camera(inputs.reference_camera(config), device)
        t0 = time.perf_counter()
        target, target_counts = shader.render(PlainScene(spec, spec_values(spec), device=device), ref_cam, plt, pmat,
                                              settings, W, H)
        _sync(device)
        run.reference_s = time.perf_counter() - t0
        keys = trainable_keys(spec)
        cam = program.camera(inputs.reference_camera(config), host)
        probe = program.build_scene(spec, spec_values(spec))
        flags = program.trainable(probe, spec, keys)
        order = program.trainable_order(probe, spec, keys)
        logged = check.logged_steps(traffic["steps"], traffic["log_every"])
        drawn = int(streams["check"].integers(check_spec["sample_jobs"]))
        # Step 0, the last step and, where the mix asks for it, a logged step drawn between them.
        mids = [s for s in logged if 0 < s < traffic["steps"] - 1] if check_spec.get("mid_step", True) else []
        checked = sorted({0, traffic["steps"] - 1} | ({int(streams["check"].choice(mids))} if mids else set()))
        record = set(checked) | {s + 1 for s in checked if s + 1 < traffic["steps"]}

        def job(j):
            values = inputs.job_values(config, seed, j)
            recorder = _StepRecorder(order, record) if j == drawn else None
            try:
                res = program.fit_scene(target, program.build_scene(spec, values), cam, lt, mat, cfg, traffic, flags,
                                        device)
            finally:
                if recorder is not None:
                    recorder.close()
            return values, res, recorder

        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        job(-1)
        run.prepare_s = time.perf_counter() - t0
    run.build = program.build_counters()
    log(f"[setup] scene_prepare_s {run.prepare_s!r} builds {run.build['builds']} "
        f"build_seconds {run.build['build_seconds']!r} reference_s {run.reference_s!r}")

    # ---- the window ----
    kept = _Reservoir(check_spec.get("keep_requests", 1), streams["check"])
    sample = None
    run.setup_s = process_age_s() - run.reference_s
    with trace.profiled(traced) as prof:
        with spans("window"):
            start = time.perf_counter()
            r = 0
            while True:
                t0 = time.perf_counter()
                if run.kind == "render":
                    with spans("request"):
                        with spans("enqueue"):
                            out = request(r)
                        t1 = time.perf_counter()
                        with spans("sync"):
                            _sync(device)
                    run.enqueue.append(t1 - t0)
                    run.frames += out.shape[0]
                    kept.offer((r, out))
                    del out
                else:
                    with spans("job"):
                        values, res, recorder = job(r)
                    run.steps += res.steps_run
                    if recorder is not None:
                        sample = (values, res.losses, program.leaf_values(res.scene, spec), recorder.states)
                    del res
                t2 = time.perf_counter()
                run.latencies.append(t2 - t0)
                r += 1
                if t2 - start >= seconds and (run.kind == "render" or sample is not None):
                    break
            run.seconds = t2 - start
    run.requests = r
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced:
        run.trace = trace.reduce(prof, spans)
        del prof
    log(f"[host] {host_witness(device)}")

    # ---- the reference: the comparison, and the roofline's counts ----
    t_ref = time.perf_counter()
    if run.kind == "render":
        frames = [(out[k], inputs.request_views(traffic, rr)[k]) for rr, out in kept.items for k in range(out.shape[0])]
        del kept
        pick = streams["check"].choice(len(frames), size=min(check_spec["images"], len(frames)), replace=False)
        truth = PlainScene(spec, spec_values(spec), device=device)
        refs, counts = {}, {}

        def reference(v):
            if v not in refs:
                refs[v], counts[v] = shader.render(truth, check.plain_camera(views[v], device), plt, pmat, settings,
                                                   W, H)
            return refs[v]

        numbers = check.render_numbers([(frames[i][0], reference(frames[i][1])) for i in sorted(pick)])
        del frames, refs
        if traced:
            for v in range(traffic["views"]):
                if v not in counts:
                    counts[v] = shader.render(truth, check.plain_camera(views[v], device), plt, pmat, settings,
                                              W, H)[1]
            per_frame = {v: roofline.k1_bound_s(spec, c, n_params) for v, c in counts.items()}
            run.k1_bound_s = sum(per_frame[v] for rr in range(run.requests) for v in inputs.request_views(traffic, rr))
    else:
        start_values, losses, end_values, states = sample
        prog_losses = dict(zip(logged, losses))
        prog = {s: states[s] for s in checked if s in states}
        prog_next = {s: (states[s + 1]["theta"] if s + 1 < traffic["steps"] else
                         {k: torch.as_tensor(end_values[k]) for k in keys}) for s in prog}
        if set(prog) != set(checked) or any(s + 1 < traffic["steps"] and s + 1 not in states for s in prog):
            numbers = {"start_gap": float("inf")}  # the optimizer never reached a checked step
        else:
            base = {k: np.asarray(v, np.float32) for k, v in start_values.items()}

            def scene_of(theta, dtype=torch.float32):
                return PlainScene(spec, {**base, **{k: t.detach().float().cpu().numpy() for k, t in theta.items()}},
                                  dtype, device)

            if stand_in is not None:
                prog, prog_next, prog_losses = stand_in(scene_of, keys, prog, ref_cam, settings, target,
                                                        traffic["learning_rate"])
            ref = check.reference_steps(scene_of, keys, prog, ref_cam, plt, pmat, settings, target,
                                        traffic["learning_rate"])
            numbers = check.fit_numbers({k: start_values[k] for k in keys}, prog, prog_next, prog_losses, ref)
            for st, rr in sorted(ref.items()):
                log(f"[check] step {st} loss {prog_losses.get(st)!r} ref {rr['loss']!r} " + " ".join(
                    f"{k} grad {float(prog[st]['grad'][k].norm())!r} ref {float(rr['grad'][k].norm())!r} "
                    f"step {float((prog_next[st][k].cpu() - prog[st]['theta'][k].cpu()).norm())!r} "
                    f"ref {float((rr['theta'][k].cpu() - prog[st]['theta'][k].cpu()).norm())!r}" for k in keys))
        if traced:
            run.k3_bound_s = roofline.k3_bound_s(spec, target_counts, n_params) * run.steps
    correct, rows = check.verdict(numbers, check_spec["limits"])
    log(f"[reference] seconds {time.perf_counter() - t_ref!r}")

    # ---- the result ----
    metrics = {}
    for m in manifest.metrics_of(mf, "per_layer" if traced else "end_to_end", workload):
        value = manifest.metric_reader(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    loaded = forbidden_modules()
    result = {"correct": bool(correct) and not loaded, "attempted": run.requests, "failed": 0, "metrics": metrics,
              "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    log(f"[window] {run.kind} requests {run.requests} frames {run.frames} steps {run.steps} "
        f"seconds {run.seconds!r} setup_s {run.setup_s!r} memory_peak_bytes {peak}")
    return result, rows, loaded, run
