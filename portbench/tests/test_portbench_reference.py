"""The plain reference agrees with the port on the CPU at 64×48: its images
with the port's torch engine (``render``) and the render kernel's plain
version, its fit step's loss and gradient with the fit kernel's plain
version."""

import dataclasses

import numpy as np
import pytest
import torch

import sdf3d_tpu_torch as tt
from portbench.core import check, inputs, manifest, program
from portbench.reference import shader
from portbench.reference.scene import PlainScene, spec_values, trainable_keys

MF = manifest.load()
W, H = 64, 48


def _setup(name):
    config = manifest.config(MF, name)
    dev = torch.device("cpu")
    return (config, check.plain_light(config, torch.float32, dev), check.plain_material(config, torch.float32, dev),
            program.render_config(config, W, H))


@pytest.mark.parametrize("name", ["reference", "fractal"])
@pytest.mark.parametrize("azimuth", [0.0, 137.508])
def test_images_match_the_port(name, azimuth):
    config, lt, mat, cfg = _setup(name)
    spec = config["scene"]
    cam = inputs.orbit(azimuth, manifest.traffic("render_1080p")["orbit"])
    ref, counts = shader.render(PlainScene(spec, spec_values(spec)), check.plain_camera(cam, "cpu"), lt, mat,
                                config["render"], W, H)
    scene = program.build_scene(spec, spec_values(spec))
    pc, pl, pm = program.camera(cam, "cpu"), program.light(config, "cpu"), program.material(config, "cpu")
    torch_engine = tt.render(scene, pc, pl, pm, cfg)
    kernel_plain = program.render_batch(scene, [pc], pl, pm, cfg, "cpu")[0]
    for img in (torch_engine, kernel_plain):
        assert float((img - ref).abs().max()) < 1e-4
    assert counts["pixels"] == W * H and counts["primary"] > W * H and counts["shadow"] > 0


@pytest.mark.parametrize("name", ["reference", "fractal"])
def test_fit_step_matches_the_port(name):
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel
    from sdf3d_tpu_torch.ops.render_kernel import _U_K, pack_uniforms
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector

    config, lt, mat, cfg = _setup(name)
    spec = config["scene"]
    cam = inputs.reference_camera(config)
    target, _ = shader.render(PlainScene(spec, spec_values(spec)), check.plain_camera(cam, "cpu"), lt, mat,
                              config["render"], W, H)
    start = inputs.job_values(config, 11, 0)
    keys = trainable_keys(spec)
    loss, grads = shader.loss_and_grads(PlainScene(spec, start), keys, check.plain_camera(cam, "cpu"), lt, mat,
                                        config["render"], target)
    scene = program.build_scene(spec, start)
    flags = program.trainable(scene, spec, keys)
    uni = pack_uniforms(program.camera(cam, "cpu"), program.light(config, "cpu"), program.material(config, "cpu"))
    uni[_U_K] = config["render"]["shadow_k"]
    sizes = [int(np.asarray(v).size) for v in program.leaf_values(scene, spec).values()]
    slots = tuple(s for i, f in enumerate(flags) if not f for s in range(sum(sizes[:i]), sum(sizes[:i + 1])))
    p_loss, g, _ = fit_step_kernel(scene, scene_param_vector(scene), uni, target.permute(2, 0, 1).contiguous(), cfg,
                                   wrt_uniforms=False, frozen_slots=slots)
    assert abs(float(p_loss) - float(loss)) <= 1e-5 * float(loss)
    want = torch.cat([grads[k].reshape(-1) for k in keys]).float()
    got = torch.cat([g[sum(sizes[:i]):sum(sizes[:i + 1])] for i, f in enumerate(flags) if f])
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())
