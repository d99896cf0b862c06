"""The port's multi-process path (``sdf3d_tpu_torch/parallel/launch.py``).

- the per-rank row maps and rays against the JAX package's;
- a real 2-process ``torch.distributed`` run over gloo on the CPU: both
  ranks run ``fit_scene(mesh=...)`` in every layout, and the parent holds
  their trajectories to each other, to the port's unsharded fit and to the
  JAX package's sharded fit on its 8-device CPU mesh; exactly one rank
  writes checkpoints and metrics, and a resume takes rank 0's state;
- two processes building the same kernel library at once.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import sdf3d_tpu as s
from sdf3d_tpu.camera import camera_rays_for_rows as jax_camera_rays_for_rows
from sdf3d_tpu.fit import FitConfig as JaxFitConfig
from sdf3d_tpu.fit import fit_scene as jax_fit_scene
from sdf3d_tpu.parallel import launch as jax_launch
from sdf3d_tpu.parallel import make_mesh as jax_make_mesh
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch import convert
from sdf3d_tpu_torch.camera import camera_rays, camera_rays_for_rows
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops import KernelConfig, cuda_scene_source, pack_uniforms, render_kernel_forward_plain
from sdf3d_tpu_torch.ops.render_kernel import library_job
from sdf3d_tpu_torch.ops import _build
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from sdf3d_tpu_torch.parallel import launch, make_mesh
from sdf3d_tpu_torch.utils.parity import check_planes

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(tt.REFERENCE_CONFIG, width=128, height=64)
KC = KernelConfig(tile_h=8, tile_w=128)  # the JAX tests' tile
PLANE_FROZEN = (False, False, True, True)
STEPS, CHUNK = 3, 1  # the chunk length differs from the world size (2)
LAYOUTS = {
    "tiles": dict(shard_layout="tiles"),
    "tiles_balanced": dict(shard_layout="tiles", shard_policy="balanced", replan_every=1),
    "interleaved": dict(shard_layout="interleaved"),
    "contiguous": dict(shard_layout="contiguous"),
    # The ring all-reduces: a CPU rank runs their plain versions, JAX its
    # interpret-mode kernels.
    "tiles_ring": dict(shard_layout="tiles", allreduce="pallas_ring"),
    "interleaved_rs_ag": dict(shard_layout="interleaved", allreduce="pallas_rs_ag"),
}


def _jax_layout(name):
    """``LAYOUTS[name]`` as JAX's CPU mesh runs it (a ring kernel in
    interpret mode)."""
    fields = dict(LAYOUTS[name])
    if "allreduce" in fields:
        fields["allreduce"] += "_interpret"
    return fields


@pytest.mark.parametrize("n,th", [(4, 4), (2, 8), (8, 2)])
def test_abs_rows_for_block_matches_jax(n, th):
    H = 64
    for lo, hi in [(0, H), (H // 4, H // 2), (H - 5, H)]:
        for interleaved in (False, True):
            np.testing.assert_array_equal(
                launch.abs_rows_for_block(lo, hi, H, n, interleaved, th),
                jax_launch.abs_rows_for_block(lo, hi, H, n, interleaved, th))
    with pytest.raises(ValueError, match="tile_h"):
        launch.abs_rows_for_block(0, 8, 48, 4, interleaved=True)


def test_rays_for_rows_match_jax_and_full_bundle():
    rows = np.asarray([0, 7, 13, 63, 30])
    o, d = camera_rays_for_rows(tt.Camera.reference(), CFG.width, CFG.height, rows, CFG.ray_mode)
    o_full, d_full = camera_rays(tt.Camera.reference(), CFG.width, CFG.height, CFG.ray_mode)
    torch.testing.assert_close(d, d_full[torch.from_numpy(rows)], rtol=0, atol=0)
    torch.testing.assert_close(o, o_full[torch.from_numpy(rows)], rtol=0, atol=0)
    _, jd = jax_camera_rays_for_rows(s.Camera.reference(), CFG.width, CFG.height, rows, CFG.ray_mode)
    # JAX's CPU rsqrt is not 1/sqrt: a few ulps apart.
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_single_process_defaults():
    """Without a process group: one rank, which is the primary writer."""
    assert launch.is_primary()
    mesh = make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None) and mesh.shape == {"tiles": 1}
    rows = launch.rank_rows(mesh, CFG.height, interleaved=True, tile_h=8)
    np.testing.assert_array_equal(rows, np.arange(CFG.height))
    target = np.random.default_rng(3).uniform(size=(CFG.height, CFG.width, 3)).astype(np.float32)
    o, d, t = launch.fit_arrays(mesh, tt.Camera.reference(), CFG, target)
    assert o.shape == d.shape == t.shape == (CFG.height, CFG.width, 3)
    np.testing.assert_array_equal(t.numpy(), target)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


WORKER = r"""
import dataclasses, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops import KernelConfig, pack_uniforms, render_kernel_forward_plain, scene_param_vector
from sdf3d_tpu_torch.parallel import launch, make_mesh, render_sharded_kernel
from sdf3d_tpu_torch.utils.logging import MetricsLogger

launch.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank, device="cpu")
mesh = make_mesh("cpu")
spec = json.load(open(os.path.join(outdir, "spec.json")))
cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=spec["width"], height=spec["height"])
kc = KernelConfig(tile_h=8, tile_w=128)
cam, light, mat = tt.Camera.reference(), tt.reference_light(), tt.reference_material()
target = np.load(os.path.join(outdir, "target.npy"))
out = {"rank": mesh.rank, "size": mesh.size, "fits": {}, "renders": {}}
for name, extra in spec["layouts"].items():
    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    fc = dict(learning_rate=1e-2, log_every=1, chunk_steps=spec["chunk"], checkpoint_every=2,
              checkpoint_dir=os.path.join(outdir, f"ckpt_{name}_r{rank}"), **extra)
    logger = MetricsLogger(os.path.join(outdir, f"metrics_{name}_r{rank}.jsonl"), echo=False)
    first = fit_scene(target, scene0, cam, light, mat, cfg, FitConfig(steps=spec["steps"], **fc), mesh=mesh,
                      logger=logger, trainable=tuple(spec["trainable"]), kernel_config=kc)
    logger.close()
    # Rank 1 has no checkpoint of its own: it resumes from rank 0's, broadcast.
    resumed = fit_scene(target, scene0, cam, light, mat, cfg, FitConfig(steps=spec["steps"] + 2, **fc),
                        mesh=mesh, trainable=tuple(spec["trainable"]), kernel_config=kc)
    out["fits"][name] = {"losses": first.losses, "radius": float(first.scene.b.radius),
                         "resumed_losses": resumed.losses, "resumed_steps": resumed.steps_run,
                         "resumed_radius": float(resumed.scene.b.radius)}
prm = scene_param_vector(tt.reference_scene())
uni = pack_uniforms(cam, light, mat, cfg.ray_mode)
uni[27] = cfg.shadow.k
ref = render_kernel_forward_plain(tt.reference_scene(), prm, uni, cfg, kc)[0]
for layout in ("tiles", "interleaved", "contiguous"):
    img = render_sharded_kernel(tt.reference_scene(), cam, light, mat, cfg, mesh, kc, layout=layout, planar=True)
    out["renders"][layout] = {"shape": list(img.shape), "bit_equal": bool((img == ref).all())}
json.dump(out, open(os.path.join(outdir, f"out_r{rank}.json"), "w"))
launch.shutdown()
"""


def _jax_setup():
    jcfg = dataclasses.replace(s.REFERENCE_CONFIG, width=CFG.width, height=CFG.height)
    jcam, jlight, jmat = s.Camera.reference(), s.reference_light(), s.reference_material()
    target = np.asarray(s.render(s.reference_scene(), jcam, jlight, jmat, jcfg))
    jscene0 = s.sdf.union(s.sdf.ground_plane(), s.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25))
    flags = iter(PLANE_FROZEN)
    jmask = jax.tree_util.tree_map(lambda _: next(flags), jscene0)
    return jcfg, (jcam, jlight, jmat), target, jscene0, jmask


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results of the worker above, run once for the module."""
    outdir = tmp_path_factory.mktemp("ranks")
    _, _, target, _, _ = _jax_setup()
    np.save(outdir / "target.npy", target)
    spec = dict(width=CFG.width, height=CFG.height, steps=STEPS, chunk=CHUNK, layouts=LAYOUTS,
                trainable=list(PLANE_FROZEN))
    (outdir / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(port), str(r), str(outdir), str(REPO)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return outdir, [json.loads((outdir / f"out_r{r}.json").read_text()) for r in range(2)]


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded fit of the same setup (CPU, plain fused step)."""
    _, _, target, _, _ = _jax_setup()
    scene0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    fc = FitConfig(steps=STEPS, learning_rate=1e-2, log_every=1, chunk_steps=CHUNK)
    return fit_scene(target, scene0, tt.Camera.reference(), tt.reference_light(), tt.reference_material(), CFG, fc,
                     trainable=PLANE_FROZEN, device="cpu", kernel_config=KC)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_two_process_fit_matches_unsharded_and_jax(name, two_ranks, unsharded, cpu_devices):
    outdir, outs = two_ranks
    assert [o["rank"] for o in outs] == [0, 1] and all(o["size"] == 2 for o in outs)
    r0, r1 = (o["fits"][name] for o in outs)
    # Replicated: both ranks hold the same trajectory.
    assert r0 == r1
    assert len(r0["losses"]) == STEPS
    # The all-reduce sums in another order than one whole-image kernel.
    np.testing.assert_allclose(r0["losses"], unsharded.losses, rtol=1e-5)
    assert abs(r0["radius"] - unsharded.scene.b.radius.item()) <= 1e-5

    jcfg, view, target, jscene0, jmask = _jax_setup()
    jfc = JaxFitConfig(steps=STEPS, learning_rate=1e-2, log_every=1, chunk_steps=CHUNK, engine="pallas",
                       pallas_interpret=True, pallas_tile=(8, 128), **_jax_layout(name))
    assert {k: getattr(convert.from_jax(jfc), k) for k in LAYOUTS[name]} == _jax_layout(name)
    want = jax_fit_scene(target, jscene0, *view, jcfg, jfc, mesh=jax_make_mesh(cpu_devices, n_devices=8),
                         trainable=jmask)
    np.testing.assert_allclose(r0["losses"], want.losses, rtol=1e-5)
    assert abs(r0["radius"] - float(want.scene.b.radius)) <= 1e-5

    # One writer: rank 0's checkpoint and metrics, nothing from rank 1.
    assert (outdir / f"ckpt_{name}_r0" / "state.pt").exists()
    assert not (outdir / f"ckpt_{name}_r1").exists()
    lines = (outdir / f"metrics_{name}_r0.jsonl").read_text().splitlines()
    assert [json.loads(ln)["step"] for ln in lines] == list(range(STEPS))
    assert (outdir / f"metrics_{name}_r1.jsonl").read_text() == ""
    # The resume started both ranks at rank 0's last checkpoint (step 2).
    assert r0["resumed_steps"] == STEPS + 2 - 2
    assert r0["resumed_losses"][:2] == r0["losses"][:2] and len(r0["resumed_losses"]) == STEPS + 2


@pytest.mark.parametrize("layout", ["tiles", "interleaved", "contiguous"])
def test_two_process_render_matches_unsharded(layout, two_ranks):
    """Two ranks' sharded render, gathered, equals the plain K1 image bit for
    bit on both ranks (the same per-pixel arithmetic; the gather moves
    values)."""
    _, outs = two_ranks
    for o in outs:
        assert o["renders"][layout] == {"shape": [3, CFG.height, CFG.width], "bit_equal": True}


BUILD_WORKER = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, sys.argv[3])
from sdf3d_tpu_torch.ops import _build
libs = _build.KernelLibraries(sys.argv[1], host=True)
header = open(sys.argv[2]).read()
while time.time() < float(sys.argv[4]):
    time.sleep(0.01)
lib = libs.load(header)
H, W = 24, 32
uni, prm = np.load(sys.argv[5]), np.load(sys.argv[6])
out = [np.empty((3, H, W), np.float32)] + [np.empty((H, W), np.float32) for _ in range(3)]
assert lib.sdf3d_render_fwd_host(uni.ctypes.data, prm.ctypes.data, *(o.ctypes.data for o in out), H, W) == 0
np.save(sys.argv[7], np.concatenate([o.reshape(-1) for o in out]))
print(json.dumps({"builds": libs.builds}))
"""


def test_two_processes_build_one_key(tmp_path):
    """Two processes build the same library at the same moment (the C++
    compiler's host forms, the same build path as nvcc's): each compiles in
    a private directory and renames it into place, so both load a complete
    library, and the build directory holds one key and no leftovers."""
    import shutil
    import time

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    cfg = dataclasses.replace(CFG, width=32, height=24)
    scene = tt.reference_scene()
    header = tmp_path / "scene.cuh"
    header.write_text(cuda_scene_source(scene, cfg, KernelConfig()))
    uni = pack_uniforms(tt.Camera.reference(), tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    prm = scene_param_vector(scene)
    np.save(tmp_path / "uni.npy", uni.numpy())
    np.save(tmp_path / "prm.npy", prm.numpy())
    build_dir = tmp_path / "build"
    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_WORKER, str(build_dir), str(header), str(REPO), str(start),
                               str(tmp_path / "uni.npy"), str(tmp_path / "prm.npy"), str(tmp_path / f"out{i}.npy")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    key = _build.KernelLibraries(build_dir, host=True).key(header.read_text())
    assert sorted(x.name for x in build_dir.iterdir()) == [key]
    assert (build_dir / key / _build.KINDS["render"].lib_name).exists()
    assert "-c" in (build_dir / key / "build.log").read_text()
    a, b = np.load(tmp_path / "out0.npy"), np.load(tmp_path / "out1.npy")
    np.testing.assert_array_equal(a, b)
    want = render_kernel_forward_plain(scene, prm, uni, cfg)
    got = np.split(a, [3 * 24 * 32, 4 * 24 * 32, 5 * 24 * 32])
    check_planes([got[0].reshape(3, 24, 32)] + [g.reshape(24, 32) for g in got[1:]], want, cfg.march.max_distance)


def test_prefetch_builds_ahead_and_a_load_waits_for_it(tmp_path):
    """``KernelLibraries.prefetch`` builds a queue of libraries on background
    threads (the host forms here): a ``load`` of a key still in the queue
    waits for that build instead of starting its own, so this process's
    ``builds`` stays 0 and the queue's builds count in ``prefetched``; the
    loaded library renders the plain version's planes."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    cfg = dataclasses.replace(CFG, width=32, height=24)
    libs = _build.KernelLibraries(tmp_path / "build", host=True)
    scenes = [tt.reference_scene(), tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.box(half_extents=(0.2, 0.3, 0.2)))]
    jobs = [library_job(sc, cfg, KernelConfig()) for sc in scenes]
    queue = libs.prefetch(jobs + jobs[:1], workers=2)
    lib = libs.load_for(*jobs[1])  # most likely still building: waits for it
    assert queue.result(timeout=600) == 2
    assert (libs.builds, libs.prefetched, libs.loaded) == (0, 2, 1) and libs.prefetch_seconds > 0
    assert libs.load_for(*jobs[0]) is not lib and (libs.builds, libs.loaded) == (0, 2)
    # A key still waiting its turn (one worker, busy with the first) is
    # taken out of the queue and built by the load that needs it.
    later = [library_job(tt.sdf.union(tt.sdf.ground_plane(), shape), cfg, KernelConfig())
             for shape in (tt.sdf.torus(), tt.sdf.capsule((-0.2, 0.3, 0.0), (0.2, 0.3, 0.0), 0.1),
                           tt.sdf.cylinder(radius=0.2, half_height=0.3))]
    queue = libs.prefetch(later, workers=1)
    libs.load_for(*later[2])
    assert queue.result(timeout=600) + libs.builds == 3 and libs.builds >= 1
    scene = scenes[1]
    uni = pack_uniforms(tt.Camera.reference(), tt.reference_light(), tt.reference_material(), cfg.ray_mode)
    uni[27] = cfg.shadow.k
    prm = scene_param_vector(scene)
    out = [np.empty((3, 24, 32), np.float32)] + [np.empty((24, 32), np.float32) for _ in range(3)]
    uni_np, prm_np = uni.numpy(), prm.numpy()
    assert lib.sdf3d_render_fwd_host(uni_np.ctypes.data, prm_np.ctypes.data, *(o.ctypes.data for o in out), 24,
                                     32) == 0
    check_planes([torch.from_numpy(o) for o in out], render_kernel_forward_plain(scene, prm, uni, cfg),
                 cfg.march.max_distance)
