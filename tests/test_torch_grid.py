"""``sdf/grid.py`` (``VoxelGrid``, ``voxel_grid``, ``voxelize``) against the
JAX package (``tests/test_grid.py``'s cases), its files, and its routes:
no kernel takes a grid, ``render_kernel_diff`` renders it on the banded route
(JAX's ``_forward_any``), and the fits run on both engines.

Bars, each beside the error measured here:
- ``distance`` at seeded points (inside, outside, on the box's faces and
  its sample planes), its gradient to the samples and the points, and
  ``voxelize``'s samples: 1e-6 absolute (measured 0, 0, 0 and 6e-8); the
  origin's and spacing's gradients (sums of 2048 cancelling terms) 1e-6 of
  their mass (measured 5.4e-9); a NaN point gives NaN in both;
- files: bit for bit both ways (the samples base64-packed);
- ``render_kernel_diff`` of a grid against JAX's ``render_pallas``: the
  image at ``NEURAL_BAR`` (its shadow cancels as a neural field's does:
  measured at most 1.2e-4), and each package's image at the same bar
  against a float64 render (measured 1.8e-4 and 6.2e-5); the backward fed
  JAX's own planes against ``jax.vjp`` of JAX's ``_planar_shade`` at 1e-4
  relative plus 1e-5 of the largest component (measured 3.3e-5 of the
  largest, within the relative term), and end to end, each side marching
  its own primal, 1e-4 relative plus 1e-3 of the largest (measured 3.2e-5);
- three Adam steps of the kernel engine's grid fit against JAX's pallas
  engine: losses 1e-4 relative;
- the grid tagged with a material of its own (``Shaded``) on the same
  route: every leaf's gradient (the samples, the plane, the tag's material
  channels), the light's and the global material's against ``jax.vjp``
  through ``render_pallas`` at the grid's end-to-end bar (measured 7.5e-5 of
  the largest, within the relative term), the image at ``NEURAL_BAR``
  (measured at most 1.2e-4), the backward alone on JAX's planes against
  ``_planar_shade`` at the grid's bar (measured 7.5e-5 of the largest,
  within the relative term); tagged with the global material, the untagged
  image and grid gradient bit for bit; three Adam steps of its material
  against JAX's fit, losses 1e-4 relative (measured 1e-6).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.fit import FitConfig as JaxFitConfig
from sdf3d_tpu.fit import fit_scene as jax_fit_scene
from sdf3d_tpu.ops import PallasRenderConfig, render_pallas
from sdf3d_tpu.ops.render_kernel import pack_uniforms as jax_pack_uniforms
from sdf3d_tpu.ops.render_pallas import _planar_shade
from sdf3d_tpu.render import render_aux_banded as jax_render_aux_banded
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops import KernelConfig, pack_uniforms, render_kernel_forward
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel
from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff, render_kernel_rows
from sdf3d_tpu_torch.ops.render_bwd_kernel import planar_vjp, scene_distance
from sdf3d_tpu_torch.ops.scene_program import leaves, scene_param_vector
from sdf3d_tpu_torch.parallel import make_mesh
from sdf3d_tpu_torch.utils.parity import NEURAL_BAR, check_grads, check_pixel_budget

torch.set_num_threads(1)

W, H = 32, 24
JCFG = dataclasses.replace(s.REFERENCE_CONFIG, width=W, height=H)
CFG = convert.from_jax(JCFG)
PC = PallasRenderConfig(tile_h=8, tile_w=128, interpret=True)
NO_KERNEL = "VoxelGrid has no kernel"


def _double(obj):
    """A camera, light or material in float64."""
    return type(obj)(*(getattr(obj, f.name).detach().double() for f in dataclasses.fields(obj)))


def _jax_grid(res=12):
    """A sphere baked at ``res``³ over [-0.5, 0.5]³ around (0, 0.4, 0),
    unioned with the analytic ground plane (``tests/test_grid.py``'s
    scene, smaller)."""
    sphere = s.sdf.sphere(center=(0.0, 0.4, 0.0), radius=0.3)
    grid = s.sdf.voxelize(sphere, res, lo=(-0.5, -0.1, -0.5), hi=(0.5, 0.9, 0.5))
    return s.sdf.union(s.sdf.ground_plane(), grid)


def _points(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.0, 1.5, size=(n, 3)).astype(np.float32)
    # On the box's faces and on sample planes (u exactly integral).
    p[:16, 0] = -0.5
    p[16:32, 1] = 0.9
    p[32:48, 2] = np.float32(-0.5 + 3 * (1.0 / 11.0))
    return p


def test_distance_and_gradients_match_jax():
    jscene = _jax_grid()
    jgrid = jscene.b
    grid = convert.from_jax(jgrid)
    assert type(grid).__name__ == "VoxelGrid" and tuple(grid.values.shape) == (12, 12, 12)
    p = _points()
    want, vjp = jax.vjp(lambda g, q: g.distance(q), jgrid, jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    got = grid.distance(pt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    cot = np.random.default_rng(1).normal(size=p.shape[0]).astype(np.float32)
    jg_grid, jg_p = vjp(jnp.asarray(cot))
    g_values, g_origin, g_spacing, g_p = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                                             [grid.values, grid.origin, grid.spacing, pt])
    for name, a, b in (("values", g_values, jg_grid.values), ("points", g_p, jg_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6, err_msg=name)
    assert float(g_values.abs().sum()) > 0  # the gathers' backward scatters into the samples
    # The origin's and the spacing's gradients sum 2048 terms that cancel:
    # held to 1e-6 of their mass, each point's term from a copy of the grid
    # whose origin and spacing are one per point.
    per_point = tt.sdf.VoxelGrid(values=grid.values.detach(), origin=grid.origin.detach().expand(len(p), 3),
                                 spacing=grid.spacing.detach().expand(len(p), 1))
    terms = torch.autograd.grad((per_point.distance(torch.from_numpy(p)) * torch.from_numpy(cot)).sum(),
                                [per_point.origin, per_point.spacing])
    got_os = torch.cat([g_origin, g_spacing.reshape(1)])
    want_os = np.concatenate([np.asarray(jg_grid.origin), np.asarray(jg_grid.spacing).reshape(1)])
    print("[measured] grid origin and spacing:", check_grads(
        got_os, want_os, torch.cat([terms[0].abs().sum(0), terms[1].abs().sum().reshape(1)]), rtol=1e-6,
        mass_tol=1e-6, label="origin and spacing"))
    print("[measured] grid distance, values, points:", float((got.detach() - torch.from_numpy(np.asarray(want)))
                                                              .abs().max()),
          float(np.abs(g_values.numpy() - np.asarray(jg_grid.values)).max()),
          float(np.abs(g_p.numpy() - np.asarray(jg_p)).max()))


def test_nan_point_gives_nan_as_jax():
    jgrid = _jax_grid().b
    q = np.asarray([[np.nan, 0.2, 0.1], [0.1, np.inf, 0.0]], np.float32)
    want = np.asarray(jgrid.distance(jnp.asarray(q)))
    got = convert.from_jax(jgrid).distance(torch.from_numpy(q)).detach().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0])


def test_voxelize_and_voxel_grid_match_jax():
    jg = _jax_grid(16).b
    g = tt.sdf.voxelize(tt.sdf.sphere((0.0, 0.4, 0.0), 0.3), 16, lo=(-0.5, -0.1, -0.5), hi=(0.5, 0.9, 0.5))
    np.testing.assert_allclose(g.values.detach().numpy(), np.asarray(jg.values), rtol=0, atol=1e-6)
    print("[measured] voxelize:", float(np.abs(g.values.detach().numpy() - np.asarray(jg.values)).max()))
    np.testing.assert_array_equal(g.origin.detach().numpy(), np.asarray(jg.origin))
    np.testing.assert_array_equal(g.spacing.detach().numpy(), np.asarray(jg.spacing))
    with pytest.raises(ValueError, match="cubic"):
        tt.sdf.voxelize(tt.sdf.sphere(), 8, lo=(-1, -1, -1), hi=(1, 2, 1))
    with pytest.raises(ValueError, match="resolution"):
        tt.sdf.voxelize(tt.sdf.sphere(), 1)
    raw = np.random.default_rng(2).normal(size=(4, 5, 6)).astype(np.float32)
    for kw in ({}, {"extent": 3.0}, {"spacing": 0.25, "origin": (0.1, 0.2, 0.3)}):
        a, b = s.sdf.voxel_grid(raw, **kw), tt.sdf.voxel_grid(raw, **kw)
        for f in ("values", "origin", "spacing"):
            np.testing.assert_array_equal(getattr(b, f).detach().numpy(), np.asarray(getattr(a, f)))
    with pytest.raises(ValueError, match="Nz, Ny, Nx"):
        tt.sdf.voxel_grid(raw[0])


def test_files_round_trip_bit_exact_both_ways(tmp_path):
    jscene = _jax_grid()
    s.sdf.save_scene(tmp_path / "jax.json", jscene)
    port = tt.sdf.load_scene(tmp_path / "jax.json")
    assert '"b64"' in (tmp_path / "jax.json").read_text()
    want = np.asarray(jax.flatten_util.ravel_pytree(jscene)[0])
    np.testing.assert_array_equal(scene_param_vector(port).numpy(), want)
    np.testing.assert_array_equal(scene_param_vector(convert.from_jax(jscene)).numpy(), want)
    tt.sdf.save_scene(tmp_path / "port.json", port)
    back = s.sdf.load_scene(tmp_path / "port.json")
    np.testing.assert_array_equal(np.asarray(jax.flatten_util.ravel_pytree(back)[0]), want)
    assert type(back.b).__name__ == "VoxelGrid"
    with pytest.raises(ValueError, match="scene node"):
        tt.sdf.save_setup(tmp_path / "setup.json", port)
        tt.sdf.load_scene(tmp_path / "setup.json")


def test_kernel_paths_raise_on_a_grid():
    """No kernel takes a grid, as no Pallas kernel does in the JAX package:
    the kernel entry points raise, and nothing renders it quietly on the
    torch path instead."""
    scene = convert.from_jax(_jax_grid())
    view = (tt.Camera.reference(), tt.reference_light(), tt.reference_material())
    with pytest.raises(NotImplementedError, match=NO_KERNEL):
        tt.render_batch(scene, [view[0]], *view[1:], CFG, engine="kernel", device="cpu")
    with pytest.raises(NotImplementedError, match=NO_KERNEL):
        render_kernel_forward(scene, *view, CFG)
    with pytest.raises(NotImplementedError, match=NO_KERNEL):
        render_kernel_rows(scene, *view, CFG, KernelConfig(), 0, 0)
    prm = scene_param_vector(scene)
    uni = pack_uniforms(*view, CFG.ray_mode)
    with pytest.raises(NotImplementedError, match=NO_KERNEL):
        fit_step_kernel(scene, prm, uni, torch.zeros((3, H, W)), CFG)
    img = tt.render_batch(scene, [view[0]], *view[1:], CFG, engine="torch", device="cpu")[0]
    assert bool(torch.isfinite(img).all())


def test_render_kernel_diff_of_a_grid_matches_jax():
    jscene, jcam = _jax_grid(), s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    jlight, jmat = s.reference_light(), s.reference_material()
    scene, cam, light, mat = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat))
    g = np.random.default_rng(3).normal(size=(H, W, 3)).astype(np.float32)
    light.position.requires_grad_(True)
    img = render_kernel_diff(CFG, KernelConfig(), scene, cam, light, mat)
    (img * torch.from_numpy(g)).sum().backward()
    got = torch.cat([*(x.grad.reshape(-1) for x in leaves(scene)), light.position.grad]).numpy()
    out, pull = jax.vjp(lambda sc, l: render_pallas(JCFG, PC, sc, jcam, l, jmat), jscene, jlight)
    jg = pull(jnp.asarray(g))
    want = np.concatenate([np.asarray(jax.flatten_util.ravel_pytree(jg[0])[0]), np.asarray(jg[1].position)])
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3 * np.abs(want).max())
    print("[measured] grid end to end, of the largest:", float(np.abs(got - want).max() / np.abs(want).max()))

    # The image.  A shadow ray through the trilinear field cancels in
    # d2 = s² − inter² as a neural field's does, so it is held to NEURAL_BAR,
    # and so is each package's float32 image against a float64 render of the
    # same scene (the witness that the two differ by float32 rounding).
    want_img = torch.from_numpy(np.array(out))
    with torch.no_grad():
        f64 = tt.render_aux_banded(copy.deepcopy(scene).double(), *(_double(o) for o in (cam, light, mat)), CFG)[0]
    for name, a, b in (("port vs JAX", img.detach(), want_img), ("port vs float64", img.detach(), f64),
                       ("JAX vs float64", want_img, f64)):
        st = check_pixel_budget(a.double(), b.double(), f"grid image, {name}", channel_axis=-1, **NEURAL_BAR)
        print(f"[measured] grid image, {name}:", st)

    # The backward alone on JAX's planes: the re-trace on the scene's own
    # distance against jax.vjp of _planar_shade's generic branch.
    rgb_j, t_j, sh_j, ao_j = jax_render_aux_banded(jscene, jcam, jlight, jmat, JCFG)
    gp = np.ascontiguousarray(np.transpose(g, (2, 0, 1)))
    _, pull = jax.vjp(lambda sc: _planar_shade(JCFG, sc, jcam, jlight, jmat, t_j, sh_j, ao_j), jscene)
    want_p = np.asarray(jax.flatten_util.ravel_pytree(pull(jnp.asarray(gp))[0])[0])
    uni = pack_uniforms(cam, light, mat, CFG.ray_mode).detach()
    uni[27] = CFG.shadow.k
    np.testing.assert_allclose(uni.numpy(), np.asarray(jax_pack_uniforms(jcam, jlight, jmat, JCFG.ray_mode)
                                                       .at[27].set(JCFG.shadow.k)), rtol=0, atol=1e-6)
    planes = [torch.from_numpy(np.array(x)) for x in (t_j, sh_j, ao_j)]
    got_p, _ = planar_vjp(scene_distance(scene), scene_param_vector(scene), uni, torch.from_numpy(gp), *planes, CFG)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-4, atol=1e-5 * np.abs(want_p).max())
    print("[measured] grid backward on JAX's planes, of the largest:",
          float(np.abs(got_p.numpy() - want_p).max() / np.abs(want_p).max()))


def test_grid_fits_on_both_engines():
    """A grid's fit of its samples runs on both engines, unsharded and on a
    mesh (the banded route); the kernel engine's three Adam steps hold JAX's
    pallas engine's losses."""
    jscene0 = _jax_grid(8)
    jtarget_scene = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.0, 0.42, 0.0), radius=0.28))
    jcam, jlight, jmat = s.Camera.reference(), s.reference_light(), s.reference_material()
    target = np.asarray(s.render(jtarget_scene, jcam, jlight, jmat, JCFG))
    mask = (False, False, True, False, False)
    flags = iter(mask)
    jmask = jax.tree_util.tree_map(lambda _: next(flags), jscene0)
    jfc = JaxFitConfig(steps=3, learning_rate=3e-3, log_every=1, engine="pallas", pallas_interpret=True,
                       pallas_tile=(8, 128))
    want = jax_fit_scene(target, jscene0, jcam, jlight, jmat, JCFG, jfc, trainable=jmask)
    view = tuple(convert.from_jax(o) for o in (jcam, jlight, jmat))
    scene0 = convert.from_jax(jscene0)
    runs = {
        "kernel": fit_scene(target, scene0, *view, CFG, convert.from_jax(jfc), trainable=mask, device="cpu"),
        "kernel_mesh": fit_scene(target, scene0, *view, CFG, convert.from_jax(jfc), trainable=mask,
                                 mesh=make_mesh("cpu")),
        "torch": fit_scene(target, scene0, *view, CFG, FitConfig(steps=3, learning_rate=3e-3, log_every=1,
                                                                 engine="torch"), trainable=mask, device="cpu"),
    }
    np.testing.assert_allclose(runs["kernel"].losses, want.losses, rtol=1e-4)
    np.testing.assert_allclose(runs["kernel_mesh"].losses, runs["kernel"].losses, rtol=1e-5)
    for res in runs.values():
        assert res.steps_run == 3 and res.losses[-1] < res.losses[0]
        assert not torch.equal(res.scene.b.values, scene0.b.values)


def _jax_shaded_grid(res=12, mat=None):
    """:func:`_jax_grid` with the grid tagged by a material of its own (a
    non-default one unless ``mat`` is given)."""
    base = _jax_grid(res)
    if mat is None:
        mat = s.lighting.material(ambient=(0.3, 0.1, 0.05), diffuse=(0.9, 0.3, 0.1), specular=(0.2, 0.6, 0.4),
                                  shininess=20.0)
    return s.sdf.union(base.a, s.sdf.shaded(base.b, mat))


def test_render_kernel_diff_of_a_shaded_grid_matches_jax():
    """``Union(plane, Shaded(grid))`` on the banded route: the forward resolves
    the tag's material at each hit, the backward's re-trace
    (``render_bwd_kernel.SceneDistance.materials``) hands the gradient to the
    Shaded node's four material leaves and, where the plane is hit, to the
    global material's uniforms; every leaf, the light and the global material
    against ``jax.vjp`` through JAX's ``render_pallas``."""
    jscene, jcam = _jax_shaded_grid(), s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0)
    jlight, jmat = s.reference_light(), s.reference_material()
    scene, cam, light, mat = (convert.from_jax(o) for o in (jscene, jcam, jlight, jmat))
    assert type(scene.b).__name__ == "Shaded" and type(scene.b.child).__name__ == "VoxelGrid"
    np.testing.assert_array_equal(scene_param_vector(scene).numpy(),
                                  np.asarray(jax.flatten_util.ravel_pytree(jscene)[0]))
    g = np.random.default_rng(3).normal(size=(H, W, 3)).astype(np.float32)
    light.position.requires_grad_(True)
    mat_fields = [f.name for f in dataclasses.fields(mat)]
    for f in mat_fields:
        getattr(mat, f).requires_grad_(True)
    img = render_kernel_diff(CFG, KernelConfig(), scene, cam, light, mat)
    (img * torch.from_numpy(g)).sum().backward()
    got = torch.cat([*(x.grad.reshape(-1) for x in leaves(scene)), light.position.grad,
                     *(getattr(mat, f).grad.reshape(-1) for f in mat_fields)]).numpy()
    out, pull = jax.vjp(lambda sc, l, m: render_pallas(JCFG, PC, sc, jcam, l, m), jscene, jlight, jmat)
    jg = pull(jnp.asarray(g))
    want = np.concatenate([np.asarray(jax.flatten_util.ravel_pytree(jg[0])[0]), np.asarray(jg[1].position),
                           np.asarray(jax.flatten_util.ravel_pytree(jg[2])[0])])
    shaded_slots = slice(-13 - 10, -13)  # the Shaded node's material, then the light and the global material
    assert np.abs(got[shaded_slots]).min() > 0 and np.abs(got[-10:]).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3 * np.abs(want).max())
    print("[measured] shaded grid end to end, of the largest:", float(np.abs(got - want).max() / np.abs(want).max()))

    want_img = torch.from_numpy(np.array(out))
    st = check_pixel_budget(img.detach().double(), want_img.double(), "shaded grid image, port vs JAX",
                            channel_axis=-1, **NEURAL_BAR)
    print("[measured] shaded grid image, port vs JAX:", st)

    # The backward alone on JAX's planes, the global material included.
    rgb_j, t_j, sh_j, ao_j = jax_render_aux_banded(jscene, jcam, jlight, jmat, JCFG)
    gp = np.ascontiguousarray(np.transpose(g, (2, 0, 1)))
    _, pull = jax.vjp(lambda sc, m: _planar_shade(JCFG, sc, jcam, jlight, m, t_j, sh_j, ao_j), jscene, jmat)
    jg_p = pull(jnp.asarray(gp))
    want_p = np.concatenate([np.asarray(jax.flatten_util.ravel_pytree(x)[0]) for x in jg_p])
    uni = pack_uniforms(cam, light, mat, CFG.ray_mode).detach()
    uni[27] = CFG.shadow.k
    planes = [torch.from_numpy(np.array(x)) for x in (t_j, sh_j, ao_j)]
    g_prm, g_uni = planar_vjp(scene_distance(scene), scene_param_vector(scene), uni, torch.from_numpy(gp), *planes,
                              CFG)
    got_p = torch.cat([g_prm, g_uni[17:27]]).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-4, atol=1e-5 * np.abs(want_p).max())
    print("[measured] shaded grid backward on JAX's planes, of the largest:",
          float(np.abs(got_p - want_p).max() / np.abs(want_p).max()))


def test_shaded_grid_with_the_global_material_is_the_untagged_grid():
    """A ``Shaded`` node whose material is the global one renders the
    untagged scene's image bit for bit and gives its grid the same gradient;
    the gradient the untagged grid's hits hand the global material goes to
    the tag's leaves instead."""
    jmat = s.reference_material()
    cam, light, mat = (convert.from_jax(o) for o in (s.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0),
                                                      s.reference_light(), jmat))
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(H, W, 3)).astype(np.float32))
    runs = {}
    for name, jscene in (("untagged", _jax_grid()), ("tagged", _jax_shaded_grid(mat=jmat))):
        scene = convert.from_jax(jscene)
        m = copy.deepcopy(mat)
        for f in dataclasses.fields(m):
            getattr(m, f.name).requires_grad_(True)
        img = render_kernel_diff(CFG, KernelConfig(), scene, cam, light, m)
        (img * g).sum().backward()
        grid = scene.b if name == "untagged" else scene.b.child
        runs[name] = (img.detach(), grid.values.grad, scene, m)
    assert torch.equal(runs["tagged"][0], runs["untagged"][0])
    assert torch.equal(runs["tagged"][1], runs["untagged"][1]) and float(runs["tagged"][1].abs().max()) > 0
    tag, m_tagged, m_untagged = runs["tagged"][2].b, runs["tagged"][3], runs["untagged"][3]
    for f in ("ambient", "diffuse", "specular", "shininess"):
        total = getattr(tag, f).grad + getattr(m_tagged, f).grad
        torch.testing.assert_close(total, getattr(m_untagged, f).grad, rtol=1e-5, atol=1e-5)


def test_shaded_grid_fit_trains_its_material_as_jax():
    """Three Adam steps of the kernel engine's fit of the shaded grid's
    material against JAX's pallas engine: losses 1e-4 relative, as the
    untagged grid's fit (measured 1e-6); the Shaded node's material moves as
    JAX's.  The samples stay frozen: trained with the material, the two
    packages' samples after two steps differ by float32 rounding (4.8e-7)
    and the third loss by 2.1e-4 relative, while each package renders
    JAX's two-step scene to the same loss within 4e-6 (a march that flips
    at a pixel between two nearby parameter sets, not a difference of the
    renders)."""
    jscene0 = _jax_shaded_grid(8)
    jtarget = s.sdf.union(s.sdf.ground_plane(), s.sdf.shaded(s.sdf.sphere(center=(0.0, 0.42, 0.0), radius=0.28),
                                                             s.lighting.material(diffuse=(0.8, 0.4, 0.1))))
    jcam, jlight, jmat = s.Camera.reference(), s.reference_light(), s.reference_material()
    target = np.asarray(s.render(jtarget, jcam, jlight, jmat, JCFG))
    mask = (False, False, False, False, False, True, True, True, True)
    flags = iter(mask)
    jmask = jax.tree_util.tree_map(lambda _: next(flags), jscene0)
    jfc = JaxFitConfig(steps=3, learning_rate=3e-3, log_every=1, engine="pallas", pallas_interpret=True,
                       pallas_tile=(8, 128))
    want = jax_fit_scene(target, jscene0, jcam, jlight, jmat, JCFG, jfc, trainable=jmask)
    view = tuple(convert.from_jax(o) for o in (jcam, jlight, jmat))
    scene0 = convert.from_jax(jscene0)
    got = fit_scene(target, scene0, *view, CFG, convert.from_jax(jfc), trainable=mask, device="cpu")
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.steps_run == 3 and got.losses[-1] < got.losses[0]
    assert not torch.equal(got.scene.b.diffuse, scene0.b.diffuse)
    np.testing.assert_allclose(got.scene.b.diffuse.detach().numpy(), np.asarray(want.scene.b.material.diffuse),
                               rtol=1e-4, atol=1e-6)
    print("[measured] shaded grid fit losses, port / JAX:", got.losses, want.losses)
