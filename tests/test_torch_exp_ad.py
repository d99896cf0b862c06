"""K9, the fit step's benchmark variants (``ops.fit_kernel.fit_step_variant``,
the port of ``benchmarks/exp_ad.py::make_variant``), on the CPU.

JAX's K9 cannot run here (``benchmarks/exp_ad.py`` passes no ``interpret`` to
its ``pallas_call``), so the variants' plain versions are held to JAX
functions that can: the interpret-mode fit kernel (``fit_step_kernel``) for
``full``, ``wrt_p``, ``primal``, ``noscatter`` and ``nopow``, and
``jax.value_and_grad`` of the kernel's shading expression
(``render_bwd_kernel._shade_tile``) on the faked planes for ``shade_only``.
The g++ build of every variant (the host form of the kernel function) is
held to its plain version, and the generated headers to K3's.
"""

import dataclasses
import functools
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.ops import PallasRenderConfig
from sdf3d_tpu.ops.fit_kernel import fit_step_kernel as jax_fit_step_kernel
from sdf3d_tpu.ops.render_bwd_kernel import _shade_tile
from sdf3d_tpu.ops.render_kernel import pack_uniforms as jax_pack_uniforms
from sdf3d_tpu.ops.render_kernel import render_kernel_forward as jax_render_kernel_forward
from sdf3d_tpu.ops.scene_program import compile_scene
from sdf3d_tpu.ops.scene_program import scene_param_vector as jax_scene_param_vector
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.benchmarks import exp_ad
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.ops.fit_kernel import (
    VARIANTS,
    _header_variant,
    fit_columns,
    fit_step_kernel_plain,
    fit_step_variant,
    fit_step_variant_plain,
)
from sdf3d_tpu_torch.ops.render_bwd_kernel import shade_planes
from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, pack_uniforms, pixel_planes, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.scene_program import FIT_VARIANTS, cuda_scene_source, scene_param_vector
from sdf3d_tpu_torch.utils.parity import check_grads, check_planes, conditioned, gradient_mass, primals_agree

torch.set_num_threads(1)

W, H = 64, 48
P = 8  # the reference scene's parameters
SHN = P + 26  # the shininess slot of the (P + 30) gradient
CONFIGS = ("short", "reference")


def _cfg(name):
    cfg = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
    if name == "short":
        cfg = dataclasses.replace(cfg, march=dataclasses.replace(cfg.march, max_steps=1),
                                  shadow=dataclasses.replace(cfg.shadow, max_steps=1))
    return cfg


def _pc(name):
    # One step is one evaluation in either kernel: the scalar guard of JAX's
    # unrolled march keeps max_steps exact (check_every=1 as exp_ad.py).
    return PallasRenderConfig(tile_h=8, tile_w=128, interpret=True, check_every=1 if name == "short" else 20)


@functools.cache
def _setup(name):
    """JAX's and the port's inputs under config ``name``: the reference
    scene, an orbit camera, and each side's target, in the form of the
    own-march fit comparisons (``test_torch_fit_kernel.py``): the JAX render
    plus seeded noise where the gradient is well conditioned and the two
    primals agree (``conditioned``, ``primals_agree``), elsewhere each side's
    own render, so that no residual there reaches either gradient.  The two
    renders are held to the image bar, which counts the pixels where they
    disagree (``disagree``)."""
    jcfg = _cfg(name)
    jscene, jcam = s.reference_scene(), s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    jlight, jmat = s.reference_light(), s.reference_material()
    j_planes = [torch.from_numpy(np.asarray(x).copy())
                for x in jax_render_kernel_forward(jscene, jcam, jlight, jmat, jcfg, _pc(name), planar=True)]
    scene, cam, light, mat, cfg = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat, jcfg))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
    uni[27] = cfg.shadow.k
    own = render_kernel_forward_plain(scene, prm, uni, cfg)
    check_planes(own, j_planes, cfg.march.max_distance)
    agree = primals_agree(own, j_planes, cfg.march.max_distance)
    keep = conditioned(scene, prm, uni, j_planes[1], cfg) & agree
    noise = torch.from_numpy(np.random.default_rng(6).uniform(-0.1, 0.1, (3, H, W)).astype(np.float32))
    target = torch.where(keep, j_planes[0] + noise, j_planes[0]).numpy()
    p_target = torch.where(keep, j_planes[0] + noise, own[0]).numpy()
    juni = jax_pack_uniforms(jcam, jlight, jmat, jcfg.ray_mode).at[27].set(jcfg.shadow.k)
    return {"jscene": jscene, "jcfg": jcfg, "juni": juni, "scene": scene, "cfg": cfg, "prm": prm, "uni": uni,
            "target": target, "p_target": p_target, "own": own, "disagree": int((~agree).sum())}


@functools.cache
def _jax_step(name, wrt_uniforms):
    """JAX's interpret-mode fit step: ``(loss, g_params, g_uniforms)``."""
    d = _setup(name)
    leaves, treedef = jax.tree_util.tree_flatten(d["jscene"])
    out = jax_fit_step_kernel(treedef, tuple(jnp.shape(x) for x in leaves), jax_scene_param_vector(d["jscene"]),
                              d["juni"], jnp.asarray(d["target"]), d["jcfg"], _pc(name), wrt_uniforms=wrt_uniforms)
    return tuple(np.asarray(x) for x in out)


def _port(name, variant):
    d = _setup(name)
    return fit_step_variant(variant, d["scene"], d["prm"], d["uni"], torch.from_numpy(d["p_target"]), d["cfg"])


def _mass(name):
    d = _setup(name)
    p_rgb, p_t, p_sh, p_ao = d["own"]
    return gradient_mass(d["scene"], d["prm"], d["uni"], 2.0 * (p_rgb - torch.from_numpy(d["p_target"])), p_t, p_sh,
                         p_ao, d["cfg"])


def _grad(out):
    return torch.cat([x for x in out[1:] if x is not None])


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("variant", ["full", "tgt3", "wrt_p"])
def test_gradient_variants_match_jax_fit_kernel(variant, config, record_property):
    """``full`` (and ``tgt3``, the same step on one stacked target) against
    JAX's fit kernel with the uniform gradients, ``wrt_p`` without: each
    marches its own primal, so the fit step's loosened bar, on the pixels
    where the two primals agree (``_setup``; ROADMAP Queue 3: JAX's own
    march moves with the ISA its CPU compiler targets)."""
    record_property("pixels_where_the_primals_disagree", _setup(config)["disagree"])
    wrt_uniforms = variant != "wrt_p"
    j_loss, j_gp, j_gu = _jax_step(config, wrt_uniforms)
    out = _port(config, variant)
    assert float(out[0]) == pytest.approx(float(j_loss), rel=1e-5)
    assert (out[2] is None) == (not wrt_uniforms)
    want = np.concatenate([j_gp, j_gu]) if wrt_uniforms else j_gp
    mass = _mass(config)[:want.size]
    check_grads(_grad(out), want, mass, rtol=1e-4, mass_tol=1e-4, max_tol=1e-3)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("variant", ["primal", "noscatter"])
def test_loss_only_variants_match_jax_loss(variant, config):
    loss, g_prm, g_uni = _port(config, variant)
    assert g_prm is None and g_uni is None
    assert float(loss) == pytest.approx(float(_jax_step(config, True)[0]), rel=1e-5)
    assert float(loss) == pytest.approx(float(_port(config, "full")[0]), rel=1e-6)


@pytest.mark.parametrize("config", CONFIGS)
def test_nopow_matches_full(config):
    """``nopow`` shades with x³·x³·x³·x³ for pow(x, 12) (the reference
    shininess is 12): the port's ``full`` on the same planes within 1e-5 of
    the gradient mass, and JAX's fit kernel at the fit step's bar; the
    shininess gradient is 0 (the chain ignores the exponent)."""
    assert float(_setup(config)["uni"][26]) == 12.0
    out, full = _port(config, "nopow"), _port(config, "full")
    assert float(out[2][26]) == 0.0
    keep = [k for k in range(P + 30) if k != SHN]
    mass = _mass(config)
    assert float(out[0]) == pytest.approx(float(full[0]), rel=1e-6)
    check_grads(_grad(out)[keep], _grad(full)[keep], mass[keep], rtol=1e-4, mass_tol=1e-5)
    j_loss, j_gp, j_gu = _jax_step(config, True)
    assert float(out[0]) == pytest.approx(float(j_loss), rel=1e-5)
    check_grads(_grad(out)[keep], np.concatenate([j_gp, j_gu])[keep], mass[keep], rtol=1e-4, mass_tol=1e-4,
                max_tol=1e-3)


@pytest.mark.parametrize("config", CONFIGS)
def test_shade_only_matches_jax_shade_tile(config):
    """``shade_only`` against ``jax.value_and_grad`` of the kernel's shading
    expression on the faked planes (t = 2, shadow 1, AO 1), the target's
    noise zero where the implicit-function term is ill-conditioned at t = 2
    (``conditioned``).  JAX's CPU ``rsqrt`` is not ``1/sqrt``, so its
    residual there is an ulp, not 0: the cross-package bar, 1e-4 of the mass."""
    d = _setup(config)
    scene, prm, uni, cfg = d["scene"], d["prm"], d["uni"], d["cfg"]
    ones = torch.ones((H, W))
    s_rgb = shade_planes(prm, uni, 2.0 * ones, ones, ones, scene, cfg, pixel_planes(uni, H, W))
    keep = conditioned(scene, prm, uni, 2.0 * ones, cfg)
    noise = torch.from_numpy(np.random.default_rng(7).uniform(-0.1, 0.1, (3, H, W)).astype(np.float32))
    target = (s_rgb.detach() + noise * keep).contiguous()
    loss, g_prm, g_uni = fit_step_variant("shade_only", scene, prm, uni, target, cfg)

    soa = compile_scene(d["jscene"])
    rows, cols = (jnp.asarray(x, jnp.float32) for x in np.meshgrid(np.arange(H), np.arange(W), indexing="ij"))
    tgt = jnp.asarray(target.numpy())
    f32 = jnp.float32

    def tile_loss(pv, uv):
        chans = _shade_tile(pv, uv, gpos=(rows, cols), t0=jnp.full((H, W), 2.0, f32), shadow_in=jnp.ones((H, W), f32),
                            ao_in=jnp.ones((H, W), f32), soa=soa, mat_soa=None, cfg=d["jcfg"], pc=_pc(config))
        return jnp.sum(sum((c - tgt[k]) ** 2 for k, c in enumerate(chans)))

    jprm, juni = jax_scene_param_vector(d["jscene"]), d["juni"]
    j_loss, (j_gp, j_gu) = jax.value_and_grad(tile_loss, argnums=(0, 1))(
        tuple(jprm[k] for k in range(P)), tuple(juni[k] for k in range(30)))
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    mass = gradient_mass(scene, prm, uni, 2.0 * (s_rgb.detach() - target), 2.0 * ones, ones, ones, cfg)
    check_grads(torch.cat([g_prm, g_uni]), np.array([float(x) for x in (*j_gp, *j_gu)], np.float32), mass,
                rtol=1e-4, mass_tol=1e-4)


def test_empty_variants_are_exact():
    """``empty``: the target's sum; ``empty_noin``: H·W, no input read.
    The target is quantized to 1/256, so every partial sum is exact."""
    d = _setup("short")
    target = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (3, H, W)).astype(np.float32) / 256)
    empty = fit_step_variant("empty", d["scene"], d["prm"], d["uni"], target, d["cfg"])
    noin = fit_step_variant("empty_noin", d["scene"], d["prm"], d["uni"], target, d["cfg"])
    assert float(empty[0]) == float(target.numpy().astype(np.float64).sum())
    assert float(noin[0]) == float(H * W)
    assert empty[1:] == (None, None) and noin[1:] == (None, None)


def test_full_is_k3_and_rejects_unknown_variants():
    d = _setup("reference")
    args = (d["scene"], d["prm"], d["uni"], torch.from_numpy(d["p_target"]), d["cfg"])
    for a, b in zip(fit_step_variant("full", *args), fit_step_kernel_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="variant"):
        fit_step_variant("scatter", *args)
    with pytest.raises(ValueError, match="frozen"):
        cuda_scene_source(d["scene"], d["cfg"], KernelConfig(), True, (0,), "primal")


@pytest.mark.parametrize("config", CONFIGS)
def test_variant_headers_differ_from_k3_only_in_the_variant(config):
    """``full``'s header is K3's byte for byte (so the same library and
    build key); every other variant's differs in one line, ``Fit::variant``."""
    d = _setup(config)
    k3 = cuda_scene_source(d["scene"], d["cfg"], KernelConfig(), True, ())
    assert cuda_scene_source(d["scene"], d["cfg"], KernelConfig(), True, (), "full") == k3
    libs = _build.KernelLibraries(tempfile.mkdtemp(prefix="sdf3d_key_"))
    keys = set()
    for v in FIT_VARIANTS[1:]:
        header = cuda_scene_source(d["scene"], d["cfg"], KernelConfig(), True, (), v)
        a, b = k3.splitlines(), header.splitlines()
        assert len(a) == len(b)
        diff = [(x, y) for x, y in zip(a, b) if x != y]
        assert len(diff) == 1 and "static constexpr int variant = " in diff[0][1], diff
        assert diff[0][1].strip() == f"static constexpr int variant = {FIT_VARIANTS.index(v)};  // {v}"
        keys.add(libs.key(header))
    assert len(keys) == len(FIT_VARIANTS) - 1


_HOST = {}


def _host_library(header):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    if "libs" not in _HOST:
        _HOST["libs"] = _build.KernelLibraries(tempfile.mkdtemp(prefix="sdf3d_host_"), host=True)
    return _HOST["libs"].load(header)


@pytest.mark.parametrize("variant", VARIANTS)
def test_host_form_matches_plain(variant):
    """Each variant's kernel function built with g++ (its host form, the
    same C++ as the CUDA kernel's per-pixel body) against its plain
    version, at 40×24 under the one-step config."""
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=40, height=24)
    cfg = exp_ad.short_config(cfg)
    scene = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    prm = scene_param_vector(scene)
    uni = pack_uniforms(tt.Camera.reference(), tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    target = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (3, 24, 40)).astype(np.float32) / 256)
    lib = _host_library(cuda_scene_source(scene, cfg, KernelConfig(), True, (), _header_variant(variant)))
    totals = np.zeros(fit_columns(lib)[0], np.float64)
    partials = np.zeros((-(-40 // 32) * -(-24 // 8), totals.size), np.float32)
    assert lib.sdf3d_fit_step_host(uni.numpy().ctypes.data, prm.numpy().ctypes.data,
                                   *(target[k].numpy().ctypes.data for k in range(3)), None, 0.0, 0.0, partials.ctypes.data,
                                   totals.ctypes.data, 24, 40, 1) == 0
    out = totals.astype(np.float32)
    loss, g_prm, g_uni = fit_step_variant_plain(variant, scene, prm, uni, target, cfg)
    if variant in ("empty", "empty_noin"):
        assert out.tolist() == [float(loss)]
        return
    assert float(out[-1]) == pytest.approx(float(loss), rel=1e-5)
    grads = [g for g in (g_prm, g_uni) if g is not None]
    if variant == "wrt_p":
        assert not out[P:-1].any()
        out = np.concatenate([out[:P], out[-1:]])
    assert out.size == 1 + sum(g.numel() for g in grads)
    if grads:
        planes = render_kernel_forward_plain(scene, prm, uni, cfg)
        if variant == "shade_only":
            ones = torch.ones((24, 40))
            planes = (shade_planes(prm, uni, 2.0 * ones, ones, ones, scene, cfg, pixel_planes(uni, 24, 40)),
                      2.0 * ones, ones, ones)
        mass = gradient_mass(scene, prm, uni, 2.0 * (planes[0] - target), *planes[1:], cfg)
        check_grads(out[:-1], torch.cat(grads), mass[:out.size - 1], rtol=1e-4, mass_tol=1e-4)


def test_make_variant_chunk_and_main_on_cpu(capsys):
    """``make_variant``'s chunk: 8 losses of the variant, unmoved by the
    1e-30 updates; ``main`` prints a line per timed variant and the kernel
    launches (none on the CPU)."""
    cfg = exp_ad.short_config(dataclasses.replace(tt.REFERENCE_CONFIG, width=32, height=24))
    fn, scene = exp_ad.make_variant("wrt_p", cfg, device="cpu")
    losses = fn(scene)
    assert losses.shape == (exp_ad.FRAMES,)
    prm = scene_param_vector(scene)
    uni = pack_uniforms(tt.Camera.reference(), tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    want = fit_step_variant("wrt_p", scene, prm, uni, torch.zeros((3, 24, 32)), cfg)[0]
    torch.testing.assert_close(losses, want.expand(exp_ad.FRAMES), rtol=1e-6, atol=0)
    assert exp_ad.main(["--device", "cpu", "--width", "16", "--height", "12"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["full", "wrt_p", "nopow", "primal", "launches"]
    assert all(ln.endswith(" ms") and float(ln.split()[1]) > 0 for ln in lines[:4])
    assert lines[-1].split() == ["launches", "0"]
