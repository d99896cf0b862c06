"""The comparison that decides ``correct`` fails what it should: its control
(the reference in bfloat16 in the program's place) on every mix, and whole
runs of the harness on the CPU (the port's plain versions, no look for a
card) with the timed path broken underneath: a step that returns its state
unchanged, half of the batch left out with the mean taken over the rest, an
answer altered where it is produced.  A sound run at the same size passes."""

import dataclasses
import importlib

import pytest
import torch

import sdf3d_tpu_torch.fit as port_fit
from portbench import control
from portbench.core import cell, program

FIT_LIMITS = {"start_gap": 0.0, "loss_gap": 1e-3, "grad_gap": 1e-2, "late_loss_gap": 1e-2, "late_grad_gap": 5e-2,
              "step_gap": 1e-2}
SMALL = {
    "reference.render_4k": {"width": 64, "height": 48, "frames_per_request": 2, "views": 4,
                            "check": {"keep_requests": 2, "images": 4,
                                      "limits": {"share_off": 1e-3, "mean_gap": 1e-4}}},
    "fractal.render_1080p": {"width": 32, "height": 24, "frames_per_request": 1, "views": 2,
                             "check": {"keep_requests": 2, "images": 2,
                                       "limits": {"share_off": 1e-3, "mean_gap": 1e-4}}},
    "reference.fit_4k": {"width": 48, "height": 32, "steps": 6, "log_every": 2,
                         "check": {"sample_jobs": 2, "limits": FIT_LIMITS}},
    "fractal.fit_1080p": {"width": 24, "height": 16, "steps": 3, "log_every": 2,
                          "check": {"sample_jobs": 1, "limits": FIT_LIMITS}},
}


def _run(workload, seconds=0.3, seed=2 ** 31 + 5):
    res, rows, loaded, _ = cell.run_cell(workload, seed, seconds, False, device="cpu",
                                         traffic_overrides=SMALL[workload], log=lambda line: None)
    assert not loaded
    return res["correct"], rows


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails(workload):
    numbers, limits = control.control_numbers(workload, 3, traffic_overrides=SMALL[workload])
    assert any(v > limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("workload", ["reference.render_4k", "reference.fit_4k"])
def test_sound_run_passes(workload):
    correct, rows = _run(workload)
    assert correct, rows


def test_render_state_unchanged_fails(monkeypatch):
    """Each request returns the images of the request before it (set-up's
    first): with one view a request and two views, every request after the
    window's first is off, and every request kept is compared."""
    real, last = program.render_batch, []

    def stale(scene, cameras, lt, mat, cfg, device):
        last.append(real(scene, cameras, lt, mat, cfg, device))
        return last[-2] if len(last) > 1 else last[-1]

    monkeypatch.setattr(program, "render_batch", stale)
    overrides = {**SMALL["reference.render_4k"], "width": 16, "height": 12, "frames_per_request": 1, "views": 2,
                 "check": {"keep_requests": 8, "images": 8, "limits": {"share_off": 1e-3, "mean_gap": 1e-4}}}
    res, rows, _, run = cell.run_cell("reference.render_4k", 2 ** 31 + 5, 2.0, False, device="cpu",
                                      traffic_overrides=overrides, log=lambda line: None)
    assert run.requests >= 2
    assert not res["correct"], rows


def test_render_answer_altered_fails(monkeypatch):
    real = program.render_batch
    monkeypatch.setattr(program, "render_batch", lambda *a: real(*a) * 1.01)
    assert not _run("reference.render_4k")[0]


def test_fit_state_unchanged_fails(monkeypatch):
    adam_module = importlib.import_module("torch.optim.adam")
    monkeypatch.setattr(adam_module, "adam", lambda *args, **kwargs: None)
    assert not _run("reference.fit_4k")[0]


def test_fit_half_batch_fails(monkeypatch):
    from sdf3d_tpu_torch.ops.fit_kernel import with_rows

    real = port_fit.fit_step_kernel

    def half(scene, prm, uni, target, cfg, kc, *args, **kwargs):
        top = dataclasses.replace(cfg, height=cfg.height // 2, ndc_height=cfg.height)
        loss, g, gu = real(scene, prm, with_rows(uni, 0, kc.tile_h), target[:, :cfg.height // 2].contiguous(), top,
                           kc, *args, **kwargs)
        return 2.0 * loss, 2.0 * g, gu

    monkeypatch.setattr(port_fit, "fit_step_kernel", half)
    assert not _run("reference.fit_4k")[0]


def test_fit_answer_altered_fails(monkeypatch):
    real = port_fit.fit_step_kernel

    def altered(*args, **kwargs):
        loss, g, gu = real(*args, **kwargs)
        return loss * 1.01, g, gu

    monkeypatch.setattr(port_fit, "fit_step_kernel", altered)
    assert not _run("reference.fit_4k")[0]
