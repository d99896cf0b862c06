"""The port's last four labs and ``suite --scaling``
(``sdf3d_tpu_torch/benchmarks/``) held to the JAX package's labs on the
same inputs, on the CPU (the kernels' plain versions)."""

import dataclasses
import io
import json
import pathlib
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import benchmarks.fast_profile as jax_fast_profile
import benchmarks.scaling_report as jax_scaling
import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.camera import camera_rays as jax_camera_rays
from sdf3d_tpu.parallel.tile_queue import plan_tiles as jax_plan_tiles
from sdf3d_tpu_torch.benchmarks import collectives_lab, fast_profile, perf_lab, scaling_report, suite
from sdf3d_tpu_torch.camera import camera_rays
from sdf3d_tpu_torch.parallel import ring_kernel
from sdf3d_tpu_torch.parallel.mesh import Mesh
from sdf3d_tpu_torch.parallel.tile_queue import plan_tiles

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(20261018)
SCENES = {"reference": (s.reference_scene, tt.reference_scene), "flagship": (s.flagship_scene, tt.flagship_scene),
          "fractal": (s.fractal_scene, tt.fractal_scene)}


def _stdout(fn, *args) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert fn(*args) == 0
    return buf.getvalue()


# ---- scaling_report ----

@pytest.mark.parametrize("n", [2, 3, 4, 8, 32])
@pytest.mark.parametrize("interleaved", [False, True])
def test_project_is_jaxs(n, interleaved):
    work = RNG.integers(0, 400, (1080,)).astype(np.float64)
    for th in (8, 24):
        assert scaling_report.project(work, n, th, interleaved) == jax_scaling.project(work, n, th, interleaved)


@pytest.mark.parametrize("policy", ["round_robin", "balanced"])
@pytest.mark.parametrize("n", [2, 4, 7, 32])
def test_project_tiles_is_jaxs(policy, n):
    exact = RNG.uniform(0, 1e4, (45, 3))
    est = exact * RNG.uniform(0.5, 1.5, exact.shape)
    ours = plan_tiles(1080, 1920, 24, 640, n, policy, est if policy == "balanced" else None)
    theirs = jax_plan_tiles(1080, 1920, 24, 640, n, policy, est if policy == "balanced" else None)
    np.testing.assert_array_equal(ours.rows, theirs.rows)
    assert scaling_report.project_tiles(exact, n, ours) == jax_scaling.project_tiles(exact, n, theirs)


def test_comm_factor_is_jaxs_model_with_the_cards_figures():
    for n in (1, 2, 8, 32):
        for nbytes in (72, 4 * 39, 1 << 20):
            # The model is JAX's: given JAX's TPU figures, JAX's numbers.
            assert scaling_report.comm_factor(n, nbytes, 1.89e-3, 1e-6, 45e9) == jax_scaling.comm_factor(n, nbytes)
    # The defaults are the card's (no TPU figure), and the step has none.
    assert (scaling_report.HOP_LATENCY_S, scaling_report.LINK_BYTES_PER_S) == (3.86e-5, 450e9)
    with pytest.raises(TypeError):
        scaling_report.comm_factor(2, 72)


def test_layout_records_are_jaxs(monkeypatch, tmp_path):
    """JAX's ``scaling_report.main`` and the port's ``layout_records`` on
    the same numpy step counts and estimates (JAX's march replaced by the
    arrays): the layouts' values equal, record by record."""
    W, H = 128, 64
    work = {name: RNG.integers(1, 200, (H, W)).astype(np.float32) for name in SCENES}
    est = {name: RNG.uniform(1, 200, (H // 8, W // 8)) for name in SCENES}
    order = iter(SCENES)
    current = {}

    def fake_steps(*a, **k):
        current["name"] = next(order)
        return work[current["name"]]

    monkeypatch.setattr(jax_scaling, "march_step_counts", fake_steps)
    monkeypatch.setattr("sdf3d_tpu.parallel.tile_queue.estimate_tile_work", lambda *a, **k: est[current["name"]])
    out = tmp_path / "jax.jsonl"
    monkeypatch.setattr(sys, "argv", ["scaling_report", "--width", str(W), "--height", str(H), "--tile-h", "8",
                                      "--out", str(out)])
    _stdout(lambda: jax_scaling.main() or 0)
    theirs = [json.loads(line) for line in out.read_text().splitlines()]
    ours = []
    for name in SCENES:
        ours += scaling_report.layout_records(name, work[name], est[name], W, H, 72, 1e-3, "b", tile_hs=(8,),
                                              queue_tile=(8, 128))
    assert len(ours) == len(theirs) == 3 * 5 * 4
    keys = ("scene", "resolution", "n_devices", "layout", "tile_h")
    for a, b in zip(ours, theirs):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
        assert a["value"] == b["value"] or (np.isnan(a["value"]) and np.isnan(b["value"]))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_march_step_counts_against_jax(name):
    """Per-ray march + shadow step counts at 32×24 against JAX's.  A ray may
    differ by one step where a step lands within an ulp of ε or the far
    limit: the two packages' ray directions differ in the last bit (their
    normalisations round differently on the CPU; ROADMAP Queue 3), and the
    fractal's distance takes a reciprocal square root, XLA's CPU ``rsqrt``
    against the port's ``1/sqrt``.  Allowed: 1% of the pixels, by one step each (0 of 768
    measured on each scene)."""
    W, H = 32, 24
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    o, d = jax_camera_rays(s.Camera.reference(), W, H, jcfg.ray_mode)
    want = np.asarray(jax_scaling.march_step_counts(SCENES[name][0](), o, d, jcfg.march, jcfg.shadow,
                                                    s.reference_light()))
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    to, td = camera_rays(tt.Camera.reference(), W, H, cfg.ray_mode)
    got = scaling_report.march_step_counts(SCENES[name][1](), to, td, cfg.march, cfg.shadow,
                                           tt.reference_light()).numpy()
    diff = np.abs(got - want)
    assert got.shape == (H, W) and got.sum() > W * H
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, f"{int((diff > 0).sum())} pixels differ"


def test_scaling_report_writes_only_where_asked(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    before = (REPO / "SCALING.jsonl").read_bytes(), (REPO / "SCALING.jsonl").stat().st_mtime_ns
    argv = ["--device", "cpu", "--width", "128", "--height", "64", "--queue-tile", "8", "128", "--tile-h", "8"]
    text = _stdout(scaling_report.main, argv + ["--step-ms", "0.5", "--step-card", "a test card"])
    records = [json.loads(line) for line in text.splitlines()]
    assert len(records) == 3 * 5 * 4 and not list(tmp_path.iterdir())
    assert [r["scene"] for r in records[::20]] == ["reference", "flagship", "fractal"]
    assert ((REPO / "SCALING.jsonl").read_bytes(), (REPO / "SCALING.jsonl").stat().st_mtime_ns) == before
    assert all(np.isfinite(r["value"]) and 0 < r["comm_factor"] <= 1 for r in records if r["n_devices"] <= 8)
    basis = records[0]["basis"]
    assert "measured on a test card" in basis and "H100" in basis and "0.5 ms" in basis
    # With --out it writes there, and the step is measured on this device.
    out = tmp_path / "records.jsonl"
    text = _stdout(scaling_report.main, argv + ["--out", str(out), "--width", "32", "--height", "24",
                                               "--queue-tile", "8", "32"])
    assert out.read_text() == text and "measured by this run on cpu" in json.loads(text.splitlines()[0])["basis"]


# ---- collectives_lab ----

class _Done:
    def wait(self):
        return True


@pytest.mark.parametrize("payload", [1024, 4 * 1001, 16 << 10])
@pytest.mark.parametrize("num", [2, 3, 5, 8])
def test_analyze_counts_what_the_rings_send(num, payload, monkeypatch):
    """``analyze``'s messages and bytes a link are those the rings send:
    the port's plain K7/K8 walk the same schedules as the kernels, here
    with ``dist.isend`` recorded (rank 0 of ``num``)."""
    sent = []

    def isend(t, dst, group=None, tag=0):
        sent.append(t.numel())
        return _Done()

    def irecv(t, src, group=None, tag=0):
        t.zero_()
        return _Done()

    monkeypatch.setattr(torch.distributed, "isend", isend)
    monkeypatch.setattr(torch.distributed, "irecv", irecv)
    monkeypatch.setattr(ring_kernel, "_neighbours", lambda mesh: (1 % mesh.size, (mesh.size - 1) % mesh.size))
    monkeypatch.setattr(ring_kernel, "_via", lambda x, mesh: x)
    mesh = Mesh(size=num, rank=0, device=torch.device("cpu"))
    a = collectives_lab.analyze(num, payload)
    x = torch.zeros(payload // 4)
    for kind, fn in (("ring", ring_kernel.ring_allreduce_plain), ("rs_ag", ring_kernel.rs_ag_plain)):
        sent.clear()
        fn(x, mesh)
        assert len(sent) == a[kind]["messages_per_link"] and 4 * sum(sent) == a[kind]["bytes_per_link"], kind
    from sdf3d_tpu_torch.parallel.collectives import resolve_algorithm

    assert a["auto"] == resolve_algorithm("auto", payload // 4, num)


def test_collectives_lab_message_counts_are_jaxs():
    import benchmarks.collectives_lab as jax_lab

    for num in (2, 4, 8):
        for size in collectives_lab.SIZES:
            ours, theirs = collectives_lab.analyze(num, size), jax_lab.analyze(num, size)
            assert ours["auto"] == theirs["auto"]
            for kind in ("ring", "rs_ag"):
                assert ours[kind]["messages_per_link"] == theirs[kind]["messages_per_link"]


# ---- fast_profile ----

@pytest.mark.parametrize("scene", ["reference", "flagship"])
def test_image_delta_against_jax(scene):
    """Parity against fast render at 64×48: the port's plain K1 on both
    profiles against JAX's ``render``.  PSNR within 0.05 dB (measured: 1e-5
    dB on the reference scene, 0.010 on the flagship), the same share of
    pixels moved past 1%."""
    got = fast_profile.image_delta(scene, 64, 48, device="cpu")
    want = jax_fast_profile.image_delta(scene, 64, 48)
    assert abs(got["psnr_db"] - float(want["psnr_db"])) < 0.05
    assert got["pixels_changed_gt_1pct"] == want["pixels_changed_gt_1pct"]
    assert abs(got["max_abs_err"] - want["max_abs_err"]) < 0.02


# ---- perf_lab ----

def test_perf_lab_runs_a_two_case_suite():
    from sdf3d_tpu_torch.ops import KernelConfig

    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=32, height=24)
    lines = []
    best = perf_lab.run({"fwd": (cfg, KernelConfig(), "fwd"), "fit": (cfg, KernelConfig(), "fit")}, rounds=2, iters=1,
                        device="cpu", out=lines.append)
    assert set(best) == {"fwd", "fit"} and all(np.isfinite(t) and t > 0 for t in best.values())
    assert [ln.split()[0] for ln in lines] == ["fwd", "fit"] and all("Mrays/s" in ln for ln in lines)
    # The suites hold no TPU-only knob: every case is a RenderConfig, a
    # KernelConfig and a mode.
    for fn in perf_lab.SUITES.values():
        for c, kc, mode in fn(cfg).values():
            assert isinstance(kc, KernelConfig) and mode in ("fwd", "fwd_scan", "fit", "fwd_bwd")


@pytest.mark.parametrize("mode", ["fwd_scan", "fwd_bwd"])
def test_perf_lab_serial_modes(mode):
    from sdf3d_tpu_torch.ops import KernelConfig

    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=16, height=8)
    fn, arg = perf_lab.make_fn(cfg, KernelConfig(), mode, device="cpu")
    out = fn(arg)
    assert out.shape == (perf_lab.FRAMES,) and bool(torch.isfinite(out).all())


# ---- suite --scaling ----

def test_suite_scaling_at_world_size_one():
    text = _stdout(suite.main, ["--scaling", "--device", "cpu", "--world-sizes", "1", "5", "--width", "32",
                                "--height", "24", "--iters", "1"])
    (rec,) = [json.loads(line) for line in text.splitlines()]  # 5 does not divide the height: skipped
    assert rec["metric"] == "scaling_rays_per_second" and rec["n_devices"] == 1 and rec["efficiency"] == 1.0
    assert rec["value"] > 0 and rec["shared_card"] is False and rec["device"] == "cpu"


def test_run_ranks_reports_a_failed_rank():
    """A rank that fails stops the run: the call raises with the outputs and
    leaves no process behind (``json.tool`` refuses the rank arguments; the
    first rank to fail may stop its peer before it has)."""
    from sdf3d_tpu_torch.benchmarks._ranks import run_ranks

    with pytest.raises(RuntimeError, match=r"rank \d \(exit 2\):\nusage: python -m json.tool"):
        run_ranks("json.tool", 2, [], timeout=60)
