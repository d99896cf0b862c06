"""The NeuralSDF family in the port against the JAX package: the MLP field, its
initialisation and distillation, the parameter vector and setup files, the
scene split of the neural kernel, and the banded renders."""

import dataclasses

import jax
import jax.flatten_util as fu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.ops.neural_kernel import NeuralRenderConfig as JaxNeuralRenderConfig
from sdf3d_tpu.render import render_aux_banded as jax_render_aux_banded
from sdf3d_tpu.sdf import neural_sdf as jax_neural_sdf
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig, split_neural
from sdf3d_tpu_torch.ops.scene_program import leaves, scene_param_vector
from sdf3d_tpu_torch.sdf import NeuralSDF, distill, distill_loss, load_setup, neural_sdf, save_setup
from sdf3d_tpu_torch.utils.parity import check_pixel_budget

torch.set_num_threads(1)

RNG = np.random.default_rng(20261016)


def _points(shape, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, shape + (3,)).astype(np.float32)


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("hidden", [16, 64])
def test_distance_matches_jax(hidden, depth):
    jm = jax_neural_sdf(key=depth, hidden=hidden, depth=depth, radius=0.4)
    pts = _points((7, 33))
    want = np.asarray(jm.distance(jnp.asarray(pts)))
    got = convert.from_jax(jm).distance(torch.from_numpy(pts))
    assert got.shape == (7, 33)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)


def test_geometric_init_approximates_sphere():
    m = neural_sdf(0, hidden=64, depth=3, radius=0.5)
    pts = torch.from_numpy(_points((512,)))
    d_m = m.distance(pts).detach().numpy()
    d_s = (torch.linalg.norm(pts, dim=-1) - 0.5).numpy()
    away = np.abs(d_s) > 0.15
    assert np.mean(np.sign(d_m[away]) == np.sign(d_s[away])) > 0.9
    assert np.mean(np.abs(d_m - d_s)) < 0.35


def test_batched_shapes_grad_and_generator():
    m = neural_sdf(0, hidden=16, depth=2)
    assert [tuple(w.shape) for w in m.weights] == [(3, 16), (16, 1)]
    assert m.distance(torch.zeros((4, 5, 3))).shape == (4, 5)
    m.distance(torch.zeros((4, 5, 3))).sum().backward()
    assert any(float(w.grad.abs().sum()) > 0 for w in m.weights)
    gen = torch.Generator()
    gen.manual_seed(3)
    a = neural_sdf(gen, hidden=8, depth=3)
    b = neural_sdf(3, hidden=8, depth=3)
    torch.testing.assert_close(scene_param_vector(a), scene_param_vector(b), rtol=0, atol=0)
    with pytest.raises(ValueError):
        neural_sdf(depth=1)


def test_softplus_keeps_the_exact_form_beyond_threshold_20():
    """beta·x = 30 is past torch's softplus threshold; JAX's logaddexp form
    keeps log1p(exp(−30)) there."""
    jm = jax_neural_sdf(key=0, hidden=8, depth=2)
    pts = np.full((1, 3), 0.3, np.float32)
    want = np.asarray(jm.replace(beta=jnp.float32(1000.0)).distance(jnp.asarray(pts)))
    tm = convert.from_jax(jm)
    with torch.no_grad():
        tm.beta.fill_(1000.0)
    np.testing.assert_allclose(tm.distance(torch.from_numpy(pts)).detach().numpy(), want, rtol=1e-6, atol=1e-7)


def test_distill_loss_matches_jax():
    jm = jax_neural_sdf(key=1, hidden=32, depth=3, radius=0.3)
    jt = s.sdf.union(s.sdf.sphere((-0.12, 0.4, 0.0), 0.18), s.sdf.sphere((0.15, 0.48, 0.0), 0.14))
    pts = _points((256,), -0.6, 0.8)

    def jax_loss(m):
        q = jnp.asarray(pts)
        mse = jnp.mean((m.distance(q) - jt.distance(q)) ** 2)
        g = jax.grad(lambda x: jnp.sum(m.distance(x)))(q)
        return mse + 0.1 * jnp.mean((jnp.sqrt(jnp.sum(g * g, axis=-1) + 1e-12) - 1.0) ** 2)

    want, want_g = jax.value_and_grad(jax_loss)(jm)
    tm, tt_target = convert.from_jax(jm), convert.from_jax(jt)
    loss = distill_loss(tm, tt_target, torch.from_numpy(pts), eikonal_weight=0.1)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    # The eikonal term stays in the graph: its gradient reaches every weight.
    loss.backward()
    got_g = torch.cat([leaf.grad.reshape(-1) for leaf in leaves(tm)])
    want_flat = np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(want_g)])
    np.testing.assert_allclose(got_g.numpy(), want_flat, rtol=1e-3, atol=1e-5 * np.abs(want_flat).max())
    mse = distill_loss(tm, tt_target, torch.from_numpy(pts), eikonal_weight=0.0)
    assert float(mse.detach()) < float(loss.detach())


def test_distill_sphere_accurate_near_surface():
    target = tt.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.2)
    m0 = neural_sdf(0, hidden=64, depth=3, radius=0.3)
    before = scene_param_vector(m0)
    m, losses = distill(m0, target, 1, steps=300, batch=2048, lo=(-0.6, -0.2, -0.6), hi=(0.6, 1.0, 0.6))
    assert len(losses) == 300 and isinstance(m, NeuralSDF)
    torch.testing.assert_close(scene_param_vector(m0), before, rtol=0, atol=0)  # the input is not modified
    assert losses[-1] < losses[0] * 0.2
    pts = torch.from_numpy(_points((512,), -0.4, 0.4)) + torch.tensor([0.0, 0.4, 0.0])
    with torch.no_grad():
        err = (m.distance(pts) - target.distance(pts)).abs()
    assert float(err.mean()) < 0.02


def _jax_neural_scene():
    return s.sdf.ground_plane() | jax_neural_sdf(key=0, hidden=16, depth=3, radius=0.3)


def test_param_vector_matches_ravel_pytree():
    js = _jax_neural_scene()
    np.testing.assert_array_equal(scene_param_vector(convert.from_jax(js)).numpy(), np.asarray(fu.ravel_pytree(js)[0]))
    back = jax_neural_sdf(key=0, hidden=16, depth=3, radius=0.3) | s.sdf.ground_plane()
    np.testing.assert_array_equal(scene_param_vector(convert.from_jax(back)).numpy(),
                                  np.asarray(fu.ravel_pytree(back)[0]))


def _assert_same_neural(jax_scene, port_scene):
    np.testing.assert_array_equal(scene_param_vector(port_scene).numpy(), np.asarray(fu.ravel_pytree(jax_scene)[0]))
    assert port_scene.b.precision == jax_scene.b.precision


def test_jax_setup_file_loads_bit_exact(tmp_path):
    js = s.sdf.ground_plane() | jax_neural_sdf(key=2, hidden=32, depth=3, radius=0.3)
    path = tmp_path / "neural.json"
    s.sdf.save_setup(path, js, s.Camera.reference(), config=s.REFERENCE_CONFIG)
    assert '"b64"' in path.read_text()  # the 32 x 32 weights are packed
    setup = load_setup(path)
    assert isinstance(setup["scene"].b, NeuralSDF)
    _assert_same_neural(js, setup["scene"])


def test_port_setup_file_loads_in_jax_bit_exact(tmp_path):
    js = _jax_neural_scene()
    path = tmp_path / "port.json"
    save_setup(path, convert.from_jax(js))
    back = s.sdf.load_setup(path)["scene"]
    np.testing.assert_array_equal(np.asarray(fu.ravel_pytree(back)[0]), np.asarray(fu.ravel_pytree(js)[0]))
    assert type(back.b).__name__ == "NeuralSDF" and back.b.precision == "high"
    assert [w.shape for w in back.b.weights] == [w.shape for w in js.b.weights]


def test_neural_render_config_from_jax():
    assert convert.from_jax(JaxNeuralRenderConfig(block_rays=512, check_every=4, interpret=True)) == \
        NeuralRenderConfig(block_rays=512)
    with pytest.raises(ValueError):
        NeuralRenderConfig(block_rays=100)


def test_split_validation():
    n = neural_sdf(0, hidden=8, depth=2)
    assert split_neural(n)[0] is None
    a, b = split_neural(tt.sdf.ground_plane() | n)
    assert isinstance(b, NeuralSDF) and type(a).__name__ == "Plane"
    a, b = split_neural(n | tt.sdf.ground_plane())
    assert isinstance(b, NeuralSDF) and type(a).__name__ == "Plane"
    with pytest.raises(ValueError):
        split_neural(tt.sdf.ground_plane() | tt.sdf.sphere())
    with pytest.raises(ValueError):
        split_neural(n | n)


W, H = 64, 40
JCFG = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H,
                           march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=48),
                           shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, max_steps=24))
VIEW = (s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0), s.reference_light(), s.reference_material())


@pytest.mark.parametrize("scene", ["reference", "neural"])
def test_banded_renders_match_render(scene):
    js = s.reference_scene() if scene == "reference" else _jax_neural_scene()
    ts = convert.from_jax(js)
    cfg = convert.from_jax(dataclasses.replace(JCFG, ao=dataclasses.replace(JCFG.ao, enabled=True)))
    view = [convert.from_jax(o) for o in VIEW]
    want = tt.render(ts, *view, cfg)
    banded = tt.render_banded(ts, *view, cfg, band_rows=16)  # 40 % 16 != 0: the pad path
    torch.testing.assert_close(banded, want, rtol=0, atol=1e-5)
    rgb, t, sh, ao = tt.render_aux_banded(ts, *view, cfg, band_rows=16)
    torch.testing.assert_close(rgb, want, rtol=0, atol=1e-5)
    assert t.shape == sh.shape == ao.shape == (H, W)
    assert float(ao.min()) < 1.0 and float(sh.min()) < 1.0

    jrgb, jt, jsh, jao = (np.asarray(x) for x in jax_render_aux_banded(
        js, *VIEW, dataclasses.replace(JCFG, ao=dataclasses.replace(JCFG.ao, enabled=True)), band_rows=16))
    # A neural field is rounded differently by the two matrix products, and
    # grazing shadow rays amplify it (utils/parity.py): the JAX package's own
    # bar for its neural engines (tests/test_neural.py:177-178), at most 0.5%
    # of the pixels off by more than 1e-3; the analytic scene keeps the
    # default budget.
    bar = dict(atol=1e-3, edge_frac=5e-3, hard=None) if scene == "neural" else {}
    check_pixel_budget(rgb, jrgb, "rgb", channel_axis=-1, **bar)
    check_pixel_budget(t.clamp(max=100.0), np.minimum(jt, 100.0), "t", relative=True, **bar)
    check_pixel_budget(sh, jsh, "shadow", **bar)
    check_pixel_budget(ao, jao, "ao", **bar)


def test_render_rays_banded_is_per_ray():
    ts = convert.from_jax(_jax_neural_scene())
    cfg = convert.from_jax(JCFG)
    view = [convert.from_jax(o) for o in VIEW]
    o, d = tt.camera_rays(view[0], W, H)
    torch.testing.assert_close(tt.render_rays_banded(ts, o, d, *view[1:], cfg, band_rows=7),
                               tt.render_rays(ts, o, d, *view[1:], cfg), rtol=0, atol=1e-5)


def test_neural_fit_waits_for_item_5():
    """ROADMAP item 5 has landed, and with it item 17a: a NeuralSDF scene
    fits on the kernel engine (the neural kernel forward, the planar shade
    re-traced as backward; ``tests/test_torch_neural_fit.py`` holds it to
    JAX), every weight tensor trained."""
    res = fit_scene(np.zeros((H, W, 3), np.float32), convert.from_jax(_jax_neural_scene()),
                    *(convert.from_jax(o) for o in VIEW), convert.from_jax(JCFG), FitConfig(steps=2, log_every=1),
                    device="cpu")
    assert res.steps_run == 2 and all(np.isfinite(res.losses)) and res.losses[1] < res.losses[0]
    assert isinstance(res.scene.b, tt.sdf.NeuralSDF)
