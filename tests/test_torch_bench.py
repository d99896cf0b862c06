"""The port's bench (``sdf3d_tpu_torch/bench.py``) and its timers
(``utils/profiling.py``) on the CPU: the window rules against the JAX
package's ``sdf3d_tpu/bench.py`` on scripted window times, the payloads, the
fit chunk's losses against JAX's fit step, and the paths that must raise."""

import dataclasses
import json
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu.bench as jax_bench
import sdf3d_tpu.utils.profiling as jax_profiling
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.fit_kernel import l2_loss_and_grads as jax_l2_loss_and_grads
from sdf3d_tpu_torch import bench, cli
from sdf3d_tpu_torch.utils import profiling

torch.set_num_threads(1)

PC = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
PAYLOAD = {"metric", "value", "unit", "vs_baseline", "seconds_per_frame", "backend"}


class _Windows:
    """A scripted ``benchmark_fn``: returns the next window time and counts
    the windows."""

    def __init__(self, times):
        self.times, self.calls = list(times), 0

    def __call__(self, fn, *args, warmup=2, iters=10, **kwargs):
        t = self.times[self.calls]
        self.calls += 1
        return t


def _slopes(slopes, ts=1.0, k_small=16, k_large=64):
    """Window times [t_s, t_l, ...] whose rounds have these slopes."""
    out = []
    for sl in slopes:
        out += [ts, ts + sl * (k_large - k_small)]
    return out


SLOPE_CASES = {
    # Two slopes within 5% by round 8: stop there, the second best.
    "agree_round_8": _slopes([1e-3, 1.5e-3, 2e-3, 1.8e-3, 1.7e-3, 1.6e-3, 1.9e-3, 1.02e-3] + [5e-3] * 30),
    # No two within 5%: every round up to max_rounds.
    "never_agree": _slopes([1e-3 * 1.1 ** i for i in range(40)]),
    # One positive slope among negative ones.
    "one_positive": _slopes([-1e-3] * 5 + [4e-4] + [-2e-3] * 40),
    # None positive: the last large window over its frames.
    "none_positive": _slopes([-1e-3 * (1 + i) for i in range(40)], ts=2.0),
}


@pytest.fixture
def fake_clock(monkeypatch):
    """``time.perf_counter`` a second further at every call, ``time.sleep``
    a no-op (both packages' loops read the same clock)."""
    clock = iter(np.arange(1.0, 1e6))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    monkeypatch.setattr(time, "sleep", lambda seconds: None)


@pytest.mark.parametrize("case", sorted(SLOPE_CASES))
def test_slope_windows_match_jax(case, monkeypatch, fake_clock):
    got = {}
    for name, module, fn in (("jax", jax_profiling, jax_bench.robust_slope_seconds_per_frame),
                             ("port", profiling, bench.robust_slope_seconds_per_frame)):
        windows = _Windows(SLOPE_CASES[case])
        monkeypatch.setattr(module, "benchmark_fn", windows)
        got[name] = (fn(lambda k: k, (None,), k_small=16, k_large=64), windows.calls)
    assert got["port"] == got["jax"]
    rounds = got["port"][1] // 2
    assert rounds == {"agree_round_8": 8, "never_agree": 30, "one_positive": 30, "none_positive": 30}[case]


MIN_CASES = {
    # The two best agree by window 8, but the 4 s span (a second a clock
    # read, one read a check from window 8 on) ends at window 11.
    "agree": [0.30, 0.20, 0.25, 0.21, 0.40, 0.22, 0.26, 0.27] + [1.0] * 30,
    # The two best never within 5%: max_windows.
    "never_agree": [0.5 * 0.9 ** i for i in range(40)],
    # Agreement only at window 16.
    "late": [0.5 * 0.9 ** i for i in range(15)] + [0.5 * 0.9 ** 14 * 1.01] + [1.0] * 30,
}


@pytest.mark.parametrize("case", sorted(MIN_CASES))
def test_min_windows_match_jax(case, monkeypatch, fake_clock):
    got = {}
    for name, module, fn in (("jax", jax_profiling, jax_bench.robust_min_seconds),
                             ("port", profiling, bench.robust_min_seconds)):
        windows = _Windows(MIN_CASES[case])
        monkeypatch.setattr(module, "benchmark_fn", windows)
        got[name] = (fn(lambda: None), windows.calls)
    assert got["port"] == got["jax"]
    assert got["port"][1] == {"agree": 11, "never_agree": 30, "late": 16}[case]


@pytest.mark.parametrize("mode,engine", [("fwd", "kernel"), ("fwd_bwd", "kernel"), ("fwd", "torch")])
def test_run_benchmark_payload_on_cpu(mode, engine):
    r = bench.run_benchmark(width=32, height=24, engine=engine, mode=mode, iters=2, frames_per_dispatch=4,
                            device="cpu")
    assert set(r) == PAYLOAD
    assert r["metric"] == f"rays_per_second_24p_{mode}_{engine}"
    assert r["unit"] == "rays/s" and r["backend"] == "cpu"
    assert r["value"] > 0 and math.isfinite(r["value"])
    assert r["value"] == pytest.approx(32 * 24 / r["seconds_per_frame"])
    assert r["vs_baseline"] == pytest.approx(r["value"] / 1e9)


def test_fwd_bwd_chunk_losses_match_jax():
    """The ``fwd_bwd`` chunk's K losses (the fused fit step on a zero target,
    each step moving the parameters by 1e-30·g) against JAX's
    ``l2_loss_and_grads`` on the same cell (interpret mode), at every step."""
    make_fn, args = bench.make_workload(width=64, height=48, mode="fwd_bwd", device="cpu")
    losses = make_fn(4)(*args)
    assert losses.shape == (4,)
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=64, height=48)
    j_loss, _ = jax_l2_loss_and_grads(cfg, PC, s.reference_scene(), s.Camera.reference(), s.reference_light(),
                                      s.reference_material(), jnp.zeros((48, 64, 3), jnp.float32),
                                      wrt_uniforms=False)
    np.testing.assert_allclose(losses.numpy(), np.full(4, float(j_loss)), rtol=1e-5)


def test_fwd_chunk_matches_jax_turntable():
    """The ``fwd`` chunk (torch engine): camera i is the golden-angle orbit
    pose i at every K, each frame the image mean, as JAX's turntable."""
    make_fn, args = bench.make_workload(width=32, height=24, engine="torch", mode="fwd", device="cpu")
    means = make_fn(4)(*args)
    assert torch.equal(make_fn(8)(*args)[:4], means)
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=32, height=24)
    want = [float(s.render(s.reference_scene(), s.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0),
                           s.reference_light(), s.reference_material(), cfg).mean()) for i in range(4)]
    np.testing.assert_allclose(means.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("call", ["run_benchmark", "cli_bench"])
def test_bench_without_a_card_raises(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "run_benchmark":
            bench.run_benchmark()
        else:
            cli.main(["bench", "--width", "32", "--height", "24"])


@pytest.mark.parametrize("kwargs,match", [
    ({"scene_name": "fractal"}, None), ({"scene_name": "flagship"}, None),
    ({"engine": "torch"}, "item 5")])
def test_unported_cells_raise(kwargs, match):
    """The cells whose paths are not ported raise naming their item; the
    fractal's and the flagship's cells (ported: ROADMAP 13c, 13a) run."""
    if match is None:
        r = bench.run_benchmark(width=32, height=24, device="cpu", iters=1, frames_per_dispatch=1, **kwargs)
        assert r["value"] > 0 and math.isfinite(r["value"])
        return
    with pytest.raises(NotImplementedError, match=match):
        bench.run_benchmark(width=32, height=24, device="cpu", **kwargs)


def _fake_cells(monkeypatch, error=None):
    """``run_benchmark`` answering every cell at once (nothing runs at 4K or
    1080p here); the fractal's cell is ported since ROADMAP 13c."""

    def fake(**kw):
        if error is not None:
            raise error
        return {"value": 3e9, "seconds_per_frame": float(kw.get("width", 1920))}

    monkeypatch.setattr(bench, "run_benchmark", fake)


def test_extras_name_the_unported_items(monkeypatch):
    _fake_cells(monkeypatch)
    seen = []
    out = bench.run_extras(budget_s=900.0, on_update=seen.append, device="cpu")
    assert list(out) == ["fwd_4k", "fit_4k", "fit_fast_1080p", "fit_fractal_1080p", "fit_multiview_720p_v4"]
    assert out["fwd_4k"] == out["fit_4k"] == {"rays_per_second": 3e9, "seconds_per_frame": 3840.0}
    assert out["fit_fast_1080p"] == {"rays_per_second": 3e9, "seconds_per_frame": 1920.0}
    assert out["fit_fractal_1080p"] == {"rays_per_second": 3e9, "seconds_per_frame": 1920.0}
    assert out["fit_multiview_720p_v4"].startswith("error: NotImplementedError")
    assert "item 12" in out["fit_multiview_720p_v4"]
    assert len(seen) == 5 and seen[-1] == out
    json.dumps(out)


def test_extras_raise_on_a_failed_launch(monkeypatch):
    """Only a path that is not ported becomes an error string: a kernel
    build or launch error raises."""
    _fake_cells(monkeypatch, RuntimeError("sdf3d_fit_step launch failed: CUDA error 700"))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        bench.run_extras(device="cpu")


def test_benchmark_fn_windows():
    calls = []
    t = profiling.benchmark_fn(lambda x: calls.append(x) or torch.ones(2), 7, warmup=3, iters=5)
    assert calls == [7] * 8 and t >= 0.0
    assert profiling.benchmark_fn_latency(lambda: torch.zeros(1), warmup=1, iters=5) >= 0.0
    assert profiling.rays_per_second(1920, 1080, 0.5e-3) == pytest.approx(1920 * 1080 / 0.5e-3)
    with profiling.Timer() as timer:
        pass
    assert timer.seconds >= 0.0


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with profiling.profiler_trace(str(path)):
        torch.ones(64).sum()
    assert "traceEvents" in json.loads(path.read_text())


def test_cli_info(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("sdf3d_tpu_torch ") and out[1] == f"torch {torch.__version__}"
    assert "  cpu" in out


def test_suite_scene_cost_prints_jax_fields(monkeypatch, capsys):
    """``suite --scene-cost --device cpu`` (random_blobs n = 2, 4, 8, 16 on
    the plain version, here at 24x16) prints one line a size with the JAX
    suite's fields and values of its kind."""
    import functools

    import benchmarks.suite as jax_suite
    from sdf3d_tpu_torch.benchmarks import suite

    want = jax_suite.bench_scene_cost(width=16, height=12, iters=1)
    monkeypatch.setattr(suite, "bench_scene_cost", functools.partial(suite.bench_scene_cost, width=24, height=16,
                                                                      iters=1))
    assert suite.main(["--scene-cost", "--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [(r["metric"], r["n_primitives"], r["unit"]) for r in got] == [
        (r["metric"], r["n_primitives"], r["unit"]) for r in want]
    assert all(r["value"] > 0 and math.isfinite(r["value"]) for r in got)
