"""The warp-divergence lab (``sdf3d_tpu_torch/benchmarks/divergence.py``) on
the CPU: its efficiency on planes whose answer is known, and its run on the
plain render at a small size."""

import json

import pytest
import torch

from sdf3d_tpu_torch.benchmarks import divergence


@pytest.mark.parametrize("wx,wy", divergence.SHAPES)
def test_warp_efficiency_of_known_planes(wx, wy):
    """Equal steps give 1; one busy lane in each 32-pixel warp gives 1/32;
    a ragged plane pads with idle lanes."""
    assert divergence.warp_efficiency(torch.full((16, 64), 7.0), wx, wy) == 1.0
    one = torch.zeros((16, 64))
    one[::wy, ::wx] = 5.0
    assert divergence.warp_efficiency(one, wx, wy) == pytest.approx(1.0 / 32.0)
    assert divergence.warp_efficiency(torch.ones((3, 33)), wx, wy) < 1.0


def test_divergence_lab_on_cpu(capsys):
    """At 64×48 on the CPU: one JSON line, both loops, an efficiency in (0,
    1] per warp shape, and the share of rays that march a shadow."""
    assert divergence.main(["--device", "cpu", "--width", "64", "--height", "48"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["width"], out["height"], out["device"]) == (64, 48, "cpu")
    for loop in ("primary", "shadow"):
        eff = out[loop]["warp_efficiency"]
        assert set(eff) == {f"{wx}x{wy}" for wx, wy in divergence.SHAPES}
        assert all(0.0 < e <= 1.0 for e in eff.values())
        assert 0.0 < out[loop]["mean_steps"] <= out[loop]["max_steps"]
    assert 0.0 < out["shadow"]["rays_marching"] < 1.0
