"""The neural kernel's plain PyTorch version against the JAX package's Pallas
neural kernel (``render_neural_forward``, interpret mode on the CPU) and its
XLA render; the neural render's gradients against ``jax.grad`` of JAX's
``render_neural``; the generated CUDA source built by a C++ compiler for the
CPU and held to the plain version."""

import ctypes
import dataclasses

import jax
import jax.flatten_util as fu
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene_program import _build_host_library

import sdf3d_tpu as s
import sdf3d_tpu_torch as tt
from sdf3d_tpu.ops.neural_kernel import NeuralRenderConfig as JaxNeuralRenderConfig
from sdf3d_tpu.ops.neural_kernel import render_neural as jax_render_neural
from sdf3d_tpu.ops.neural_kernel import render_neural_forward as jax_render_neural_forward
from sdf3d_tpu.sdf import neural_sdf as jax_neural_sdf
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.camera import focal_z
from sdf3d_tpu_torch.ops import render_kernel_forward, scene_program
from sdf3d_tpu_torch.ops.neural_kernel import (
    NeuralRenderConfig,
    neural_distance,
    render_neural,
    render_neural_forward,
    render_neural_forward_plain,
)
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward_plain
from sdf3d_tpu_torch.ops.render_kernel import pack_uniforms
from sdf3d_tpu_torch.ops.scene_program import cuda_neural_source, leaves, scene_param_vector
from sdf3d_tpu_torch.utils.parity import NEURAL_BAR, check_grads, check_planes, conditioned, gradient_mass

torch.set_num_threads(1)

W, H = 48, 36
BASE = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H,
                           march=dataclasses.replace(s.REFERENCE_CONFIG.march, max_steps=48),
                           shadow=dataclasses.replace(s.REFERENCE_CONFIG.shadow, max_steps=24))
JNC = JaxNeuralRenderConfig(block_rays=512, check_every=2, interpret=True)
CAMERAS = {"reference": s.Camera.reference, "orbit": lambda: s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)}


def _jax_scene(shape, hidden=32):
    m = jax_neural_sdf(key=0, hidden=hidden, depth=3, radius=0.3)
    return m if shape == "bare" else s.sdf.ground_plane() | m


def _port_inputs(jscene, jcam, jcfg):
    scene, cam, cfg = (convert.from_jax(o) for o in (jscene, jcam, jcfg))
    uni = pack_uniforms(cam, tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    return scene, cfg, scene_param_vector(scene), uni


# (scene shape, normals, AO, background, camera): both shapes, both normal
# schemes, AO on and off, a background, both cameras.
CASES = [
    ("union", "central", False, False, "orbit"),
    ("bare", "central", False, False, "reference"),
    ("union", "tetrahedron", True, False, "reference"),
    ("bare", "tetrahedron", False, True, "orbit"),
    ("union", "central", True, True, "orbit"),
]


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_plain_matches_jax_kernel(case):
    shape, normals, ao, bg, cam_name = case
    jcfg = dataclasses.replace(BASE, normals=normals, ao=dataclasses.replace(BASE.ao, enabled=ao),
                               background=(0.3, 0.2, 0.1) if bg else None)
    jscene, jcam = _jax_scene(shape), CAMERAS[cam_name]()
    rgb, t, sh, ao_plane = jax_render_neural_forward(jscene, jcam, s.reference_light(), s.reference_material(), jcfg,
                                                     JNC)
    want = (np.transpose(np.asarray(rgb), (2, 0, 1)), np.asarray(t), np.asarray(sh), np.asarray(ao_plane))
    scene, cfg, prm, uni = _port_inputs(jscene, jcam, jcfg)
    got = render_neural_forward_plain(scene, prm, uni, cfg)
    check_planes(got, want, cfg.march.max_distance, shape, **NEURAL_BAR)
    assert float(got[2].min()) < 0.5  # the case has shadowed pixels
    # The wrapper on CPU tensors runs the same plain version.
    again = render_neural_forward(scene, convert.from_jax(jcam), tt.reference_light(), tt.reference_material(), cfg,
                                  planar=True)
    for a, b in zip(again, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_matches_jax_xla_render():
    """The JAX package's bar for its neural kernel against its XLA render
    (tests/test_neural.py:177-178): at most 0.5% of the pixels off by more
    than 1e-3."""
    jscene, jcam = _jax_scene("union"), CAMERAS["orbit"]()
    want = np.asarray(s.render(jscene, jcam, s.reference_light(), s.reference_material(), BASE))
    scene, cfg, prm, uni = _port_inputs(jscene, jcam, BASE)
    got = render_neural_forward_plain(scene, prm, uni, cfg)[0].permute(1, 2, 0).numpy()
    diff = np.abs(got - want).max(-1)
    assert (diff > 1e-3).mean() < 5e-3, f"{(diff > 1e-3).sum()} pixels off"


def test_render_neural_gradients_match_jax():
    """Gradients of ⟨render, g⟩ for every weight, bias and β, the plane, the
    camera, the light and the material against ``jax.grad`` of JAX's
    ``render_neural`` (the Pallas forward in interpret mode, ``_planar_shade``
    as backward), the cotangent zero on grazing rays (``conditioned``).
    Bars (``check_grads``, rtol 1e-4): end to end, each side marching its own
    primal, 1e-3 of the gradient mass (measured 6.3e-5); the port's backward
    on JAX's own planes, 3e-4 of the mass (measured 7.2e-5).  The largest
    error is β's: its per-pixel term ``x·σ(βx)/β − softplus(βx)/β²`` is a
    difference of two nearly equal terms that the mass does not see.  Eight
    components exceed the analytic kernels' 1e-5: β and weights whose
    per-pixel terms all share a sign, off by about 2e-4 of their value
    (float32 through three layers)."""
    jscene, jcam = _jax_scene("union"), CAMERAS["orbit"]()
    jlight, jmat = s.reference_light(), s.reference_material()
    scene, cfg, prm, uni = _port_inputs(jscene, jcam, BASE)
    cam, light, mat = (convert.from_jax(o) for o in (jcam, jlight, jmat))
    _, t, sh, ao = render_neural_forward_plain(scene, prm, uni, cfg)
    dist = neural_distance(scene)
    keep = conditioned(dist, prm, uni, t, cfg)
    g = np.random.default_rng(5).normal(size=(3, H, W)).astype(np.float32) * keep.numpy()
    g_img = np.ascontiguousarray(np.transpose(g, (1, 2, 0)))

    views = [cam, light, mat]
    tensors = [getattr(o, f.name) for o in views for f in dataclasses.fields(o)]
    for x in tensors:
        x.requires_grad_(True)
    (render_neural(cfg, NeuralRenderConfig(), scene, cam, light, mat) * torch.from_numpy(g_img)).sum().backward()
    got = torch.cat([leaf.grad.reshape(-1) for leaf in leaves(scene)]
                    + [(x.grad if x.grad is not None else torch.zeros_like(x)).reshape(-1) for x in tensors])

    def loss(sc, c, l, m):
        return jnp.sum(jax_render_neural(BASE, JNC, sc, c, l, m) * jnp.asarray(g_img))

    jg = jax.grad(loss, argnums=(0, 1, 2, 3))(jscene, jcam, jlight, jmat)
    want = np.concatenate([np.asarray(fu.ravel_pytree(jg[0])[0])] + [
        np.asarray(getattr(jv, f.name), np.float32).ravel()
        for jv in jg[1:] for f in dataclasses.fields(jv)])

    # From the (P + 30) slots of the parameter vector and the uniforms to the
    # leaves: the scene's slots, then the uniform slots each camera, light
    # and material tensor fills (the fov through d focal_z / d fov; the
    # light's colour is in no uniform: 0).
    fov = cam.fov_deg.detach().clone().requires_grad_(True)
    (dfz,) = torch.autograd.grad(focal_z(fov, cfg.ray_mode), fov)
    P = prm.numel()

    def to_leaves(v, scale_fov):
        u = v[P:]
        fz = u[12] * (dfz.abs() if scale_fov else dfz)
        return torch.cat([v[:P], u[0:12], fz.reshape(1), u[13:16], torch.zeros(3), u[16:27]])

    mass = to_leaves(gradient_mass(dist, prm, uni, torch.from_numpy(g), t, sh, ao, cfg), True)
    check_grads(got, want, mass, rtol=1e-4, mass_tol=1e-3, label="render_neural end to end")
    # Every weight tensor and the plane receive a gradient.
    assert all(float(leaf.grad.abs().max()) > 0 for leaf in scene.b.weights)
    assert float(scene.a.normal.grad.abs().max()) > 0

    # The backward alone, on the primal planes of JAX's forward.
    _, jt, jsh, jao = (torch.from_numpy(np.array(x)) for x in jax_render_neural_forward(
        jscene, jcam, jlight, jmat, BASE, JNC))
    same = to_leaves(torch.cat(render_kernel_backward_plain(dist, prm, uni, torch.from_numpy(g), jt, jsh, jao, cfg)),
                     False)
    check_grads(same, want, mass, rtol=1e-4, mass_tol=3e-4, label="render_neural backward on JAX's planes")


def test_render_batch_runs_plain_neural_on_cpu():
    scene = convert.from_jax(_jax_scene("union", hidden=16))
    cfg = convert.from_jax(BASE)
    cams = [tt.Camera.orbit(azimuth_deg=a, elevation_deg=18.0) for a in (0.0, 120.0)]
    before = (render_neural_forward.launches, render_kernel_forward.launches)
    frames = tt.render_batch(scene, cams, tt.reference_light(), tt.reference_material(), cfg, engine="kernel",
                             device="cpu")
    assert (render_neural_forward.launches, render_kernel_forward.launches) == before
    assert frames.shape == (2, H, W, 3) and bool(torch.isfinite(frames).all())
    one = render_neural_forward(scene, cams[1], tt.reference_light(), tt.reference_material(), cfg)[0]
    torch.testing.assert_close(frames[1], one, rtol=0, atol=0)


class _Box(tt.sdf.SDFNode):
    """A node the port has no emitter for (a class of its own, not the
    port's ``sdf.Box``)."""

    fields = ("half_extents",)

    def __init__(self):
        super().__init__((0.1, 0.1, 0.1))


def test_kernel_paths_raise_for_unsupported_scenes():
    n = convert.from_jax(jax_neural_sdf(key=0, hidden=8, depth=2))
    cfg = convert.from_jax(BASE)
    view = (tt.Camera.reference(), tt.reference_light(), tt.reference_material())
    with pytest.raises(NotImplementedError, match="neural kernel"):
        render_kernel_forward(tt.sdf.ground_plane() | n, *view, cfg)
    with pytest.raises(NotImplementedError, match="render_banded"):
        tt.render_batch(n | n, [view[0]], *view[1:], cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="no render-kernel emitter for scene node _Box"):
        tt.render_batch(tt.sdf.Union(tt.sdf.ground_plane(), _Box()), [view[0]], *view[1:], cfg, device="cpu")
    with pytest.raises(ValueError, match="Union"):
        render_neural_forward(n | n, *view, cfg)


HOST_CASES = {
    "union-depth3": (lambda: tt.sdf.ground_plane() | tt.sdf.neural_sdf(0, hidden=16, depth=3, radius=0.3), {}),
    "neural-first-depth4-ao-bg": (
        lambda: tt.sdf.neural_sdf(1, hidden=8, depth=4, radius=0.3) | tt.sdf.ground_plane(),
        dict(ao=dataclasses.replace(tt.REFERENCE_CONFIG.ao, enabled=True), background=(0.2, 0.3, 0.4)),
    ),
    "bare-depth2-tetra-lambert": (
        lambda: tt.sdf.neural_sdf(2, hidden=16, depth=2, radius=0.3),
        dict(normals="tetrahedron", shading="lambert"),
    ),
    "odd-width-depth3": (lambda: tt.sdf.ground_plane() | tt.sdf.neural_sdf(3, hidden=6, depth=3, radius=0.3), {}),
    # The streamed weights: the resident limit lowered so that hidden 64's
    # H x H matrix streams through the ring of panels on the card.
    "streamed-depth3": (lambda: tt.sdf.ground_plane() | tt.sdf.neural_sdf(4, hidden=64, depth=3, radius=0.3), {}),
}


def _host_neural(source, tmp_path):
    tmp_path.mkdir(exist_ok=True)
    lib = _build_host_library(source, tmp_path, "neural_kernel.cu")
    lib.sdf3d_neural_fwd_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int]
    lib.sdf3d_neural_fwd_blocks_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    lib.sdf3d_tf32_product_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    lib.sdf3d_tf32_product_host.restype = None
    return lib


def _host_inputs(scene, cfg):
    cam = tt.Camera.orbit(azimuth_deg=25.0, elevation_deg=10.0)
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    out = [np.empty((3, cfg.height, cfg.width), np.float32)] + [
        np.empty((cfg.height, cfg.width), np.float32) for _ in range(3)]
    return prm, uni, out


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_generated_neural_source_on_cpu_matches_plain(case, tmp_path, monkeypatch):
    """The host form (the same slots and steps, the H x H products in
    emulated split TF32) against the plain version, within NEURAL_BAR."""
    scene_fn, overrides = HOST_CASES[case]
    scene = scene_fn()
    h, w = 48, 64
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=w, height=h, **overrides)
    if case.startswith("streamed"):
        monkeypatch.setattr(scene_program, "RESIDENT_BYTES", 16 * 1024)
    source = cuda_neural_source(scene, cfg, NeuralRenderConfig())
    assert ("resident = false;" in source) == case.startswith("streamed")
    lib = _host_neural(source, tmp_path)
    prm, uni, out = _host_inputs(scene, cfg)
    assert lib.sdf3d_neural_fwd_host(uni.numpy().ctypes.data, prm.numpy().ctypes.data, *(o.ctypes.data for o in out),
                                     h, w) == 0
    check_planes(out, render_neural_forward_plain(scene, prm, uni, cfg), cfg.march.max_distance, case,
                 **NEURAL_BAR)


def test_generated_neural_source_reads_weights_at_run_time():
    cfg, nc = tt.REFERENCE_CONFIG, NeuralRenderConfig()
    a = cuda_neural_source(tt.sdf.ground_plane() | tt.sdf.neural_sdf(0, hidden=16), cfg, nc)
    assert cuda_neural_source(tt.sdf.ground_plane() | tt.sdf.neural_sdf(1, hidden=16), cfg, nc) == a
    assert "offset = 4;" in a and "hidden = 16;" in a and "hp = 16;" in a and "resident = true;" in a
    assert cuda_neural_source(tt.sdf.neural_sdf(0, hidden=16), cfg, nc) != a
    assert cuda_neural_source(tt.sdf.ground_plane() | tt.sdf.neural_sdf(0, hidden=32), cfg, nc) != a
    wide = cuda_neural_source(tt.sdf.neural_sdf(0, hidden=256), cfg, nc)
    assert "resident = false;" in wide and "vec4 = true;" in wide
    assert "panel_rows = 32;" in wide and "stride = 260;" in wide
    odd = cuda_neural_source(tt.sdf.ground_plane() | tt.sdf.neural_sdf(0, hidden=20), cfg, nc)
    assert "hp = 24;" in odd and "stride = 28;" in odd and "qstride = 26;" in odd


def test_neural_tile_layout():
    """The tile's padding, strides and shared-memory layout at the crossover
    widths: a quarter warp's 16-byte quads of the split matrices (lanes 4g +
    q, g < 2) and the streamed panels' B fragment rows 2q and 2q + 1 fall on
    distinct banks, every block starts 16-byte aligned, hidden 64 and 128
    hold their matrices in shared memory and 256 streams them."""
    for hidden, resident, floats in ((64, True, 8872), (128, True, 34088), (256, False, 18216)):
        lay = scene_program.neural_layout(tt.sdf.ground_plane() | tt.sdf.neural_sdf(0, hidden=hidden))
        tile = scene_program.neural_tile(lay)
        banks = {(2 * q * tile.stride + g) % 32 for q in range(4) for g in range(8)}
        quads = {(q * tile.qstride + g) % 8 for q in range(4) for g in range(2)}
        assert len(banks) == 32 and len(quads) == 8 and tile.hp == hidden and tile.resident == resident
        assert all(v % 4 == 0 for v in (tile.sm_uni, tile.sm_mats, tile.stride))
        assert tile.smem_floats == floats and tile.smem_floats * 4 <= scene_program.SMEM_BYTES


@pytest.mark.parametrize("k", [64, 256])
def test_split_tf32_product_keeps_float32_accuracy(k, tmp_path):
    """The host form's three-pass TF32 product against float64, as the error
    relative to |A|.|B| over 4096 rows: within twice float32's own, where one
    TF32 pass is off by more than 5e-5 (about three digits)."""
    lib = _host_neural(cuda_neural_source(tt.sdf.neural_sdf(0, hidden=8), tt.REFERENCE_CONFIG,
                                          NeuralRenderConfig()), tmp_path)
    rng = np.random.default_rng(k)
    a = rng.normal(size=(4096, k)).astype(np.float32)
    b = rng.normal(size=(k, 8)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)

    def err(c):
        return float((np.abs(c - exact) / scale).max())

    f32 = np.zeros((4096, 8), np.float32)
    for q in range(k):  # float32 summed in k order
        f32 += a[:, q:q + 1] * b[q:q + 1, :]
    got = {}
    for passes in (3, 1):
        c = np.empty((4096, 8), np.float32)
        lib.sdf3d_tf32_product_host(a.ctypes.data, b.ctypes.data, c.ctypes.data, 4096, k, 8, passes)
        got[passes] = err(c)
    assert got[3] <= 2 * err(f32), (got, err(f32))
    assert got[1] > 5e-5, got


@pytest.mark.parametrize("block_rays,blocks", [(32, 1), (64, 5), (256, 2)])
def test_host_form_bits_do_not_depend_on_the_schedule(block_rays, blocks, tmp_path):
    """A pixel's bits depend on its own sequence of points alone: the host
    form with other slot counts and block counts (other rays share a tile,
    in another order) gives the bits of 96 slots in 3 blocks."""
    scene = tt.sdf.ground_plane() | tt.sdf.neural_sdf(5, hidden=16, depth=3, radius=0.3)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=40, height=30,
                              ao=dataclasses.replace(tt.REFERENCE_CONFIG.ao, enabled=True))
    planes = []
    for nc, nb in ((NeuralRenderConfig(block_rays=96), 3), (NeuralRenderConfig(block_rays=block_rays), blocks)):
        lib = _host_neural(cuda_neural_source(scene, cfg, nc), tmp_path / f"b{nc.block_rays}")
        prm, uni, out = _host_inputs(scene, cfg)
        assert lib.sdf3d_neural_fwd_blocks_host(uni.numpy().ctypes.data, prm.numpy().ctypes.data,
                                                *(o.ctypes.data for o in out), 30, 40, nb) == 0
        planes.append(out)
    for x, y in zip(*planes):
        assert x.tobytes() == y.tobytes()
