#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sdf3d_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's forward render through the entry points a user calls, at
1920×1080 on the reference scene, with the CUDA render kernel built from the
sources in this checkout.  Phases, one line each:

1. device: the card's name and power limit (``nvidia-smi``) and the host's
   speed (:func:`host_witness`);
2. build: the reference scene's kernel library is built once; a second frame
   with another sphere radius reuses it (parameters are run-time inputs);
3. kernel vs its plain PyTorch version on the card at 256×192, two cameras,
   ray form and point form, all four output planes, within the pixel budget
   of ``sdf3d_tpu_torch/utils/parity.py``;
4. main path: ``render_batch(engine="kernel")`` over 4 golden-angle orbit
   cameras (one launch each), output checks, frame 0 against the plain
   version at 1080p;
5. CLI: ``python -m sdf3d_tpu_torch.cli render`` at 1080p writes a PNG;
6. times at 1080p with CUDA events (3 warm-up frames, 20 timed; plain,
   kernel, kernel, plain; the kernel by its entry point alone,
   :func:`render_alone`); K1's bound (its union skips counted: the plain
   version's ``WarpSkips``), and its issue floor: the warp instructions of
   its SASS (``cuobjdump -sass``: the primary march's and the shadow's loop
   per step, a skip block at the share of warp-steps that run it, the rest
   once a warp) on this run's marches over the card's issue rate
   (:func:`issue_floor`); its SASS by opcode class (:func:`sass_split`), the
   skip shares and the slow-path operands of the marches.

Then the training path, ``fit_scene`` on the reference scene at 1920×1080
(the JAX CLI's fit demo: a perturbed sphere, the plane frozen, Adam):

7. build: the fit step (K3) and render backward (K5) libraries, with the
   ``ptxas`` registers, spills and resident blocks an SM of every kernel,
   both forms of K5 included (with and without the uniforms' gradient);
8. fit step vs its plain version at 256×192 (two cameras, ``wrt_uniforms``
   and ``frozen_slots`` both ways) and at a ragged 250×190;
9. render backward vs its plain version at 256×192 and a ragged 250×190
   (same planes, a seeded cotangent), with and without the uniforms'
   gradient;
10. main path: ``fit_scene`` for 20 Adam steps launches the fit step once a
    step and nothing else; so does ``fit_scene(loss="multiscale")`` for 5
    steps (the pyramid inside the fit step); with ``pyramid_levels=4`` (a
    group the kernel's block cannot hold) it launches the forward and
    backward kernels once a step each, the backward without the uniforms'
    gradient (the uniforms are not trained); step 0 of the fit step against
    its plain version at 1080p;
11. CLI: ``python -m sdf3d_tpu_torch.cli fit`` at 1080p writes a metrics file;
12. times at 1080p (fit step, render backward in both forms: its entry
    point with its total, then its wrapper; each beside its plain version;
    ``fit_scene`` ms/step and fwd_bwd rays/s).

From phase 3 on, every later library known up front (:func:`prefetch_jobs`;
all but the neural phase 13's) builds in the background, two at a time, in
the order the phases load them (``_build.LIBRARIES.prefetch``); a phase
that loads one still building waits for it, so a phase's ``builds`` count
only what it built itself.  Phase 1 logs the host's speed
(:func:`host_witness`); every line ``phase_seconds``, the time since the
line before it; the line before the last (``[summary]``) the total
``wall_s``, the witness and the ten longest phases.

In the times of phases 6 and 12 the plain version runs 1 warm-up frame and
3 timed on each side of the kernel's runs, in those of phases 33, 43 and 47
one frame without a warm-up (it builds nothing; its frames take 0.01-0.6 s
at 1080p, and its time is there to compare, not to tune).

Gradient comparisons use the bars of ``utils/parity.py::check_grads`` with
the cotangent (or residual) zero on grazing rays (``conditioned``): 1e-5 of
the gradient mass where both sides differentiate the same primal planes,
1e-3 where the plain version marches its own.

Then the NeuralSDF family on the neural kernel (K6), at the widths of the
JAX package's crossover sweep (``benchmarks/neural_crossover.py``: hidden 64,
128 and 256, depth 3, 64-step march, 32-step shadow) and the demo of
``examples/neural_sdf.py``:

13. build: the library of ``ground_plane() | neural_sdf(hidden=64)`` (the
    first frame's time, ``ptxas`` registers and spills per width); other
    weights reuse it, a bare NeuralSDF and hidden 256 build their own; the
    other libraries of phases 14 and 16 build together; the library of
    hidden 64 holds tensor-core (HMMA) instructions (``cuobjdump -sass``;
    their share of the SASS logged);
14. K6 vs its plain version at 256×192: two cameras, both scene shapes,
    hidden 64 and 256, the 64/32 and the reference 100/100 steps,
    tetrahedron normals with AO and a background, all four planes within
    ``utils/parity.py::NEURAL_BAR``;
15. main path: ``distill`` (seed 0, hidden 64, 400 steps, batch 4096) onto
    the example's two spheres (``smooth_union(..., k=0.08)``), then
    ``render_batch(engine="kernel")`` of ``ground_plane() | model`` over 12
    orbit cameras at 1080p (12 K6 launches, no K1), frame 0 against the plain
    version, and ``render_kernel_diff`` at 256×192 (one K6 launch, finite
    gradients for every weight tensor and the plane);
16. times at hidden 64 at 1080p with 64/32 steps and with 100/100
    (plain, kernel, kernel, plain on the kernels line's cell, 64/32 steps;
    kernel, kernel, plain with 100/100, the plain version's one frame
    without a warm-up); one frame of the banded reference path
    (``render_banded``);
    K6's bound on the hidden 64 1080p cell as the largest of four pipes
    (tensor cores, FP32 cores, special-function units, bytes), with the
    FP32-only count of a per-thread MLP beside it.

Then the sharded path (``parallel/``) on its tile-queue kernels, K2
(``sdf3d_render_tiles``) and K4 (``sdf3d_fit_step_tiles``), on the fit demo:

17. build: the libraries of phases 18-21 together, with the ``ptxas``
    registers and spills of K2 and K4 (the kernel functions of K1 and K3,
    which they share);
18. K2 vs its plain version per rank of a 4-rank round-robin and a balanced
    plan, at 256×192 (tile 8×128) and a ragged 248×184 (tile 8×8, dummy
    tiles); the ranks' stacks reassembled against K1's whole image, and the
    pixels that differ in any bit;
19. K4 on the same plans: against the plain reverse pass on K2's planes
    (1e-5 of the gradient mass) and against its plain version, which marches
    its own primal (1e-3); the sum over the work-lists against K3 on the
    whole image (1e-4); a work-list of dummy tiles gives exactly 0;
20. main path at 1920×1080: ``fit_scene(mesh=make_mesh())`` at world size 1
    (NCCL), 20 Adam steps, in the layouts ``tiles`` (round robin), ``tiles``
    (balanced, re-planned every 5 steps) and ``interleaved``, against the
    unsharded ``fit_scene``; two processes on the one card over gloo in the
    ``tiles`` layout against world size 1, one checkpoint writer (started
    after phase 17, they run while phases 18-20 run in this process);
    ``render_sharded_kernel(layout="tiles")`` (one K2 launch) against K1;
21. times at 1080p with CUDA events (plain, kernel, kernel, plain): K2 over
    the 135-tile plan beside K1, K4 beside K3, and ``fit_scene(mesh)`` ms/step
    beside the unsharded fit.

Then (run after phase 29) the ring all-reduces K7 (``sdf3d_ring_allreduce``,
the latency ring) and K8 (``sdf3d_rs_ag``, reduce-scatter + all-gather)
between processes on the one card, over device memory shared by CUDA IPC
and flags in shared host memory (a call is a few segment kernels, each
launched once the host has seen the flags it needs):

22. build: ``libsdf3d_collectives.so`` in this process, before any rank
    starts, with the segment kernels' ``ptxas`` registers and spills;
23. four processes, with sub-groups of 2 and 3 ranks: K7 and K8 against
    their plain versions at N = 2, 3, 4, float64 and float32, payloads 1, 9
    (the fit demo's ``[loss, g_prm]``), 130, the parameter count of
    ``neural_sdf(hidden=64, depth=3)``, 70001 and ``_rs_ag_threshold(N) + 5``
    under ``"auto"``: bit for bit, the same bits on every rank, float64
    within 1e-12 of numpy's sum; two collective ids back to back; 50 calls
    in a row; a wait without a peer raises within seconds;
24. main path at 1920×1080: ``fit_scene(mesh=make_mesh())`` with two ranks
    on the card in ``tiles``, 20 Adam steps each with ``allreduce="psum"``,
    ``"pallas_ring"`` (K7 20 launches a rank) and ``"pallas_rs_ag"`` (K8
    20), each after a 3-step warm-up, no ``dist.all_reduce`` call in the
    ring fits, the ranks' losses equal and within 1e-5 of the psum run's
    (the exact difference and each fit's ms per step beside psum's logged;
    the ranks start after phase 25 and run while phases 30-31, which time
    nothing, run in this process);
25. times with CUDA events at N = 2 and 4 for 9 and 70001 float64 values
    (plain, kernel, kernel, plain), beside gloo's ``dist.all_reduce`` and an
    empty payload, each kernel's ratio to gloo logged: processes sharing one
    card, not scaling figures; and both ranks of N = 2 in this process, a
    host thread and a stream each (:func:`one_process_pair`), the segments'
    cost without the switch between processes.

Then K9, the fit step's benchmark variants (K3's kernel function compiled
with ``Fit::variant``: ``ops.fit_kernel.fit_step_variant``), and the bench:

26. build: the variants' libraries under the one-step config (the lab's
    cell) in one ``load_many``; ``full`` is K3's header and library;
    ``ptxas`` registers and spills of each, and the SASS
    instruction count of ``noscatter`` against ``full``'s and ``primal``'s;
27. every variant against its plain version at 1080p, 256×192 and a
    ragged 250×190: ``full`` and ``tgt3`` equal K3 bit for bit,
    ``noscatter``'s loss ``full``'s, ``nopow`` ``full`` within the gradient
    bar, ``empty`` the target's sum and ``empty_noin`` H·W exactly;
28. main path: ``python -m sdf3d_tpu_torch.benchmarks.exp_ad short`` at 1080p;
    CUDA-event times of eight variants (plain, kernel,
    kernel, plain), the wrapper's kernels on the card (the fit kernel, the
    second kernel its C call launches, ``sdf3d_column_total_kernel``, which
    sums the partial rows in float64 one block a live column in an order
    fixed by row and thread index, and the cast); K9's bounds;
29. the bench at 1080p: ``bench.run_benchmark`` in ``fwd`` and ``fwd_bwd``
    (a reduced protocol), the CLI's ``bench`` and ``info`` (``cli.main``,
    in this process), ``bench.run_extras``; beside each cell the kernel's
    CUDA-event time per frame and the device's idle share.

Then the flagship scene (``flagship_scene``: a sphere and a rounded box
smooth-blended, a torus, the ground plane; 21 parameters) and an every-node
CSG sampler (``utils/parity.py::csg_sampler``) on K1-K5 (:func:`flagship_phases`):

30. build: the flagship's libraries (K3 with and without the uniforms'
    gradient and frozen slots, the point form) and the sampler's, together,
    with the ``ptxas`` registers, spills and blocks an SM of K1, K3 and both
    forms of K5 beside the reference scene's and the fit demo's;
31. at 256x192 (the reference camera) and a ragged 250x190 (orbit 30/15):
    K1 in ray and point form (all four planes), K3 (one case a camera,
    ``wrt_uniforms`` and frozen slots both ways; on the
    fit's perturbed start) and K5 in both forms against their
    plain versions on both scenes, and K2 and K4 on a 4-rank balanced plan
    on the flagship; gradients at the flagship's bars (1e-4 of the mass on the same
    planes, 1e-3 where the plain version marches its own: ROADMAP Queue 3);
32. main path at 1920x1080: ``render_batch(engine="kernel")`` over 4 orbit
    cameras (K1 = 4, nothing else; frame 0 against the plain version),
    ``cli render --scene flagship`` (a PNG), a 20-step Adam fit (step 3e-4)
    of the perturbed flagship to its render with the plane frozen (K3 = 20,
    step 0 against the plain version), ``fit_scene(loss="multiscale")`` for 5
    steps (K3 = 5) and with ``pyramid_levels=4`` (K1 = K5 = 5, K5 in its P
    form), ``fit_scene(mesh=make_mesh())``
    in ``tiles`` for 20 steps (K4 = 20, the unsharded fit's losses),
    ``render_sharded_kernel(layout="tiles")`` (K2 = 1, K1's image) and
    ``bench.run_benchmark(scene_name="flagship")`` in ``fwd`` and
    ``fwd_bwd``;
33. CUDA-event times at 1080p (plain, kernel, kernel, plain) of K1, K2,
    K3, K4 and both forms of K5 on the flagship, each beside its bound on
    this run's marches, and ``fit_scene``'s ms a step; both forms of K5
    against their plain version there (the multiscale fit launches it at
    1080p), at the flagship's bar on the same planes.

The kernels line gives each of ``render_fwd``, ``render_tiles``,
``fit_step``, ``fit_step_tiles`` and ``render_bwd`` a ``flagship`` entry with
the flagship's launches, times, bound and error.

Then the scenes of ROADMAP item 13b (the capsule, cylinder, ellipsoid and
the transforms): the JAX package's ``csg_showcase``, ``lattice_scene``,
``capsule_chain`` and ``random_blobs(n=8)`` under their gallery cameras,
and the transform sampler (``utils/parity.py::transform_sampler``: every
13b node) under the reference camera (:func:`scenes_13b_phases`):

34. build: the five scenes' libraries (K1 ray and point form, K3 with the
    plane frozen; K5 in each) and ``random_blobs(2/4/16)``'s K1, together,
    with each scene's ``Scene::bwd_values``, ``ptxas`` registers, spills
    and blocks an SM, K1's registers for n = 2, 4, 8, 16; a changed
    rotation vector and period reuse the library;
35. at 256x192 under the scene's camera (K5 also orbit 30/15 at a ragged
    250x190): K1 in both forms on each scene (``csg_showcase`` at
    ``utils/parity.py::SCENE_BARS``); K3 (the plane frozen) and both K5 forms on the sampler
    and the capsule chain's fit start at the flagship's bars; on
    ``csg_showcase`` K3's and K5's totals non-finite exactly where the plain
    versions' are; K2 over the 135-tile plan at 1080p on the capsule chain
    equal to K1 in every value;
36. main path at 1920x1080: ``render_batch(engine="kernel")`` of each of
    the four scenes over its gallery camera and 3 orbit cameras (K1 = 4 a
    scene, frame 0 against the plain version), a 20-step Adam fit (step
    3e-4) of the capsule chain's perturbed start to its render with the
    plane frozen (K3 = 20; step 0 against the plain version), 5 multiscale
    steps (K3 = 5) and 5 with ``pyramid_levels=4`` (K1 = K5 = 5, K5's P
    form), ``suite --scene-cost`` (K1 = 24);
    then CUDA-event times (kernel, kernel, then one frame of the plain
    version) of K1, K3 and both K5 forms per scene with their bounds and the
    marches' mean steps, and
    both K5 forms at 1080p against their plain version on the capsule
    chain (its multiscale fit launches K5 at that size).

In phases 35 and 36 an image of a 13b scene may pass the hard limit only on
a razor-edge ray or a pixel rounding decides
(``utils/parity.py::rounding_decided``).  The register line's sweep runs
apart (``--register-line``, below).

The kernels line gives ``render_fwd``, ``fit_step`` and ``render_bwd`` a
``scenes_13b`` entry: per scene its launches on the main path, ms, plain
ms, bound, registers and spills.

Then the fractal (ROADMAP item 13c: ``fractal_scene()``, a power-8
Mandelbulb of six iterations on the ground plane) and the over-relaxed march
(``march.relaxation`` = 1.6, the branch of ``render_kernel.cuh::march_primary``
that K1-K4 share) (:func:`fractal_phases`):

37. build: the fractal's libraries (K1 in both forms, K3 with the plane
    frozen, K5) and the relaxed march's on the reference scene and the
    fractal (the ray form: one template serves both), together, with ``Scene::bwd_values``, the header's
    size and ``ptxas`` registers, spills and blocks an SM; a moved
    Mandelbulb reuses the library;
38. at 256x192 (the reference camera; K1 relaxed on the reference scene
    also orbit 30/15 at a ragged 250x190, K3 on the fractal also that size):
    K1 on the fractal in both forms, and relaxed, and on the reference
    scene relaxed (the fractal's images past the hard limit only on
    razor-edge rays or pixels rounding decides); K3 on the fractal's fit
    start (center and scale moved) and relaxed on the fit demo's start, at
    the flagship's bars; both K5 forms on the fractal; K2 and K4 relaxed on
    a 4-rank plan against their plain tile versions;
39. main path at 1920x1080: ``render_batch`` over 4 orbit cameras (K1 =
    4), ``cli render --scene fractal`` (K1 = 1), a 20-step Adam fit (step
    1e-3) of the fractal's fit start to its render with the plane frozen (K3
    = 20; step 0 against the plain version; K3's and the plain version's
    gradients at the start finite), 5 multiscale steps (K3 = 5) and 5 with
    ``pyramid_levels=4`` (K1 = K5 = 5);
    ``render_batch`` relaxed on the reference scene and the fractal (K1
    = 8), a 20-step relaxed fit of the fit demo (K3 = 20) and the same fit
    as ``fit_scene(mesh)`` in ``tiles`` at world size 1 (K4 = 20, the
    unsharded losses), ``render_sharded_kernel(layout="tiles")`` relaxed (K2
    = 1), the bench's ``fractal`` cells in both modes; then CUDA-event times
    of the fractal's K1, K3 and both K5 forms with their bounds (both K5
    forms at 1080p against their plain version), and K1 relaxed beside K1
    exact on both scenes and K2 relaxed beside exact on the reference scene
    (135 tiles), in turns.

The kernels line gives ``render_fwd``, ``fit_step`` and ``render_bwd`` a
``fractal`` entry, and ``render_fwd``, ``render_tiles``, ``fit_step`` and
``fit_step_tiles`` a ``relaxed`` entry.

Then the fit kernel's loss branches (ROADMAP item 12a: the multiscale
pyramid and the silhouette coverage term inside K3 and K4, the same kernel
function compiled with ``Fit::levels`` and ``Fit::silhouette``)
(:func:`loss_phases`):

40. build: the branches' libraries together (the fit demo's K3 with each
    branch, with and without the uniforms' gradient, ``fit_view``'s form,
    K4's at 8×128 tiles), with the ``ptxas`` registers, spills and blocks
    an SM of each beside the plain-L2 K3's;
41. at 256x192 (two cameras) and a ragged 250x190: K3 with the pyramid
    and with the coverage term (``background=(0, 0, 0)``, ``sil_w = 0.5``),
    ``wrt_uniforms`` and frozen slots both ways (three cases a branch),
    against the plain step on
    K1's planes and the plain version; K4 with each on a balanced 4-rank
    plan against its plain version, its sum against K3;
42. main path at 1920x1080: ``fit_scene(loss="multiscale")`` and the
    silhouette fit for 20 steps (K3 = 20 each), the same in ``tiles`` at
    world size 1 (K4 = 20 each, the unsharded losses), ``fit_view``
    recovering ``cli fit-view``'s perturbed camera (``pert 0.06``) for 200
    steps (K3 = 200 with the uniforms' gradient and the coverage term; the
    loss and the position error fall) and ``cli fit-view`` (K1 = 1 for its
    target, K3 = 200); step 0 of each form against its plain versions;
43. CUDA-event times at 1080p of K3 plain L2, multiscale, silhouette and
    ``fit_view``'s form in turns, each beside its plain version and bound;
    K4 with each branch over the 135-tile plan beside K3; ``fit_scene``'s
    ms a step; the multiscale K3 beside the L2 K3 on the flagship's and the
    fractal's fit starts (and the silhouette K3 on the flagship's), each
    first held to its plain versions at 256x192.

The kernels line gives ``fit_step`` ``multiscale``, ``silhouette`` and
``view`` entries and ``fit_step_tiles`` ``multiscale`` and ``silhouette``
entries.

Then K3's view axis (ROADMAP 12b) and per-object materials (12c)
(:func:`slice_phases`, runnable alone):

44. build: ``materials_scene``'s libraries together (with and without the
    uniforms' gradient, its geometry frozen, the point form), their
    registers, spills and blocks an SM, and its ``Scene::bwd_values``;
45. the view axis at 1280x720 with four golden-angle orbit views (the bench
    extra's setting): the multi-view K3 (one launch) against the plain
    reverse pass on K1's planes and against its plain version (each view's
    own march), each view's partial rows and float64 totals equal to K3
    launched on that view alone, bit for bit, with and without the
    uniforms' gradient; the main path: ``multiview_loss_and_grads`` (K3 =
    1), a 20-step ``fit_scene_multiview`` of the fit demo's start over the
    four views (K3 = 20, the loss falling) and the bench extra
    ``fit_multiview_720p_v4`` (a number);
46. ``materials_scene``: K1 in both forms at 256x192 (orbit 30/15) and
    250x190 (the reference camera), K3 (three settings, the sizes in turn)
    and both K5 forms against their plain
    versions at the flagship's bars (the material slots' gradients not
    zero), K2's stacks equal to K1's planes and K4's plan summing to K3 at
    1280x720; the main path at 1920x1080: ``render_batch`` (K1 = 4), a
    20-step fit of its perturbed material leaves with the geometry frozen
    (K3 = 20), 5 steps with ``pyramid_levels=4`` (K1 = K5 = 5), the same
    20 steps in ``tiles`` (K4 = 20, the unsharded losses) and
    ``render_sharded_kernel`` (K2 = 1, K1's image); step 0 of K3 at 1080p
    against its plain versions;
47. CUDA-event times: the multi-view K3 at 720p beside the single view's,
    and ``materials_scene``'s K1, K2, K3, K4 and both K5 forms at 1080p,
    each beside its plain version and bound.

The kernels line gives ``fit_step`` a ``multiview`` entry and
``render_fwd``, ``render_tiles``, ``fit_step``, ``fit_step_tiles`` and
``render_bwd`` a ``materials`` entry.

Then ``diff.py`` (ROADMAP item 5: the implicit-function gradients through the
torch march) and the fits that wait for it (:func:`diff_phases`, runnable
alone):

48. at 1920x1080 on the reference scene: ``render_diff``'s image equal to
    ``render_batch(engine="torch")``'s bit for bit, it and ``depth_implicit``
    against K1's image and t plane at the pixel budget (razor-edge rays
    exempt past the hard limit); the gradient of a seeded cotangent through
    ``render_diff`` for the scene, camera, light and material against
    ``render_kernel_diff``'s (K1, K5 in its P + 30 form), each on its own
    march, at 1e-3 of the mass on the pixels where the primals agree and the
    gradient is conditioned; the torch engine's loss with ``diff.coverage``
    against K3's fused silhouette loss at the fit demo's start (1e-5);
49. main path at 1920x1080: ``fit_scene(engine="torch")`` (5 steps, step 0
    within 1e-4 of the kernel engine's, no kernel launched), ``fit_view`` on
    the torch engine (5), ``fit_view`` outside the fused step (a 4-level
    pyramid and the silhouette term: K1 = K5 = 5, K5 in its P + 30 form),
    ``fit_scene`` with the silhouette term and a 4-level pyramid (K1 = K5 = 5,
    the P form), ``fit_scene_multiview(engine="torch")`` over two 720p views
    (3); each fit's ms a step (:class:`StepClock`: the first step left out);
50. item 17a at 1920x1080: ``ground_plane() | neural_sdf(hidden=64)``
    distilled as in phase 15, fitted 5 Adam steps (lr 1e-4) to the blobs'
    render: K6 = 5 and nothing else, the planar backward once a step, a finite
    non-zero MLP gradient, step 0 within 1e-3 of the torch engine's; ms a step,
    K6's share and both engines' peak memory;
51. item 17b: two processes on the card (gloo) fit the same scene 3 steps
    with ``allreduce`` ``"psum"``, ``"pallas_ring"`` (K8 by size: 4483
    values) and ``"pallas_rs_ag"``, each rank's rows through
    ``render_rays_banded(..., inner=render_rays_diff)``: the launches counted,
    the losses within 1e-5 and the MLP within 1e-4 plus 1e-6 of the unsharded
    torch-engine fit, step 0 within 1e-3 of the K6 fit's; then
    ``fit_scene(mesh, engine="torch")`` on the fit demo against the unsharded
    torch-engine fit.

The kernels line gives ``render_fwd`` and ``render_bwd`` a
``fit_view_nonfused`` entry, ``neural_fwd`` a ``fit`` entry and
``ring_allreduce`` and ``rs_ag_allreduce`` a ``neural_fit`` entry.

Then the rest of the differentiable render (ROADMAP items 12, 15b, 14 and
part of 16; :func:`slice17_phases`, runnable alone):

52. ``shadow.grad == "ad"`` at 1920x1080 on the reference scene:
    ``render_kernel_diff`` forward and backward (K1 = 1, K5 = 0, one
    ``planar_vjp``; the primal K1's image bit for bit), its gradient against
    the torch engine's ``render_diff`` under "ad", each on its own march, at
    1e-3 of the mass (the re-march's terms counted) where the primals agree,
    the light's gradient off the detached one; the fit demo (5 steps, K1 = 5,
    step 0 the fused step's loss within 1e-5) and the pose fit (5, K1 = 5)
    under "ad": ms a step and peak memory;
53. the neural render under "ad" at 960x540 (the re-march records the MLP at
    each of 32 shadow steps, 107-112 kB a pixel measured at 320x180, so
    about 54 GiB here and 215 GiB at 1080p): K6 = 1, the primal K6's
    image bit for bit, the gradient against the same re-trace on the CPU
    from K6's planes (1e-4 of its largest component), a 3-step fit (K6 = 3);
54. the row route: two processes on the card fit the fit demo at 1080p under
    "ad" in the contiguous layout (the default tiles: 540-row slabs, a partial
    last tile row) and the interleaved one (tile rows of 12), each rank's slab
    on K1 + K5 (3 each a rank), the losses and parameters within 1e-5 of the
    unsharded fused fit under "detach" (K3; the row route's semantics, as
    JAX's); ``render_sharded`` plain and differentiable: the unsharded
    ``render`` bit for bit, the ranks' summed gradients within 1e-5 of the
    mass of ``render_diff``'s;
55. a ``VoxelGrid`` baked at 128³ from a sphere beside the analytic ground
    plane: ``render_batch(engine="torch")`` and ``render_kernel_diff`` (the
    banded route) bit for bit, within JAX's bar of the analytic scene's K1
    render (under 2% of the pixels off by 0.05), ``render_batch(engine=
    "kernel")`` raising, a 3-step fit of the samples (no kernel launched);
    the grid tagged with a material of its own (``shaded``, not the
    reference material): one forward and backward of ``render_kernel_diff``
    (no kernel launched, every gradient finite, each of the tag's material
    channels' gradient nonzero), its image within the same bar of K1's
    material branch on ``ground_plane() | shaded(sphere, material)``, and
    the grid tagged with the global material bit for bit the untagged
    grid's image;
56. ``render_stereo(engine="kernel")`` (K1 = 2, ``"sbs"`` two K1 renders bit
    for bit, each eye within the pixel budget of the plain version at its
    toed-in camera, razor-edge rays past the hard limit), ``cli render
    --depth`` at 1080p (no kernel), and
    ``debug.checked_render`` and ``validate_scene`` on the flagship.

The kernels line gives ``render_fwd`` a ``shadow_ad``, a ``rows`` and a
``stereo`` entry, ``render_bwd`` a ``rows`` entry and ``neural_fwd`` a
``shadow_ad`` entry.

Then the interactive runtime (ROADMAP item 16: ``sdf3d_tpu_torch/interact``
and ``examples/``), the last four labs and ``suite --scaling`` (15b)
(:func:`slice18_phases`, runnable alone):

57. at 1920x1080 on the reference scene: the native navigation controller
    (``interact/native_src/navigation.cpp``, built by the C++ compiler,
    ``is_native``), an ``InteractiveSession`` replaying 24 frames of drags,
    a pan, a scroll, gamepad sticks and keys (``apply_key``): one K1 launch
    a frame and nothing else, every gesture moves the frame, the frames
    after the orbit and after the pan against the plain version at their
    cameras at the pixel budget (razor-edge rays past the hard limit); a
    frame's time split into K1 (CUDA events), the device window of the
    render call, the copy back (into reused and into fresh host memory) and
    the pose math; a ``LiveViewer`` on a free local port (``GET /``, two
    ``POST /event`` drags that move the pose, ``GET /frame.png`` equal to the
    frame ``step()`` rendered, ``GET /stats``, the first part of ``/stream``
    a PNG; ms a frame with the PNG encode); ``render_turntable`` (12 frames,
    K1 = 12);
58. subprocesses of this checkout, all started together (in the whole smoke
    when phase 62's scripts start, which they run beside) once the fit step
    of the scaling model is measured and their libraries are built at once:
    ``examples.live_view --frames 3`` (3 K1 frames served), ``perf_lab``'s
    stages and full cases (K1 = 128, K3 = 32, K5 = 32), ``fast_profile
    --quick`` (both scenes' deltas, four throughput rows), ``scaling_report``
    at 1080p (75 records, the card in each basis, written to ``--out``
    only), ``collectives_lab --run --num 2`` (K7 and K8 bit for bit against
    their plain versions, 18 launches each);
59. ``suite --scaling --quick --world-sizes 1 2`` (256×192): ``render_sharded``'s
    rays/s at world size 1 and two ranks sharing the card over gloo
    (``shared_card``).

The kernels line gives ``render_fwd`` an ``interact`` entry and
``ring_allreduce`` and ``rs_ag_allreduce`` a ``collectives_lab`` entry.
Phases 57-59 took 49 s of the whole smoke's 981 s on an NVIDIA H100 80GB
HBM3 at 700.00 W before the labs ran beside phase 62 (the host's speed
moves the whole by about 15%).

Then the last six example scripts (ROADMAP item 16b:
``sdf3d_tpu_torch/examples/``; :func:`slice19_phases`, runnable alone):

60. their libraries (:func:`slice19_jobs`: K1 with AO on the gallery's seven
    scenes, K3 with the pyramid and the silhouette term together and its
    one-branch forms, K2 on (8, 128) tiles, ``grid_fit``'s target,
    ``neural_sdf``'s K6), built by the queue of phase 3; the
    ``ptxas`` registers, spills and blocks an SM of each K3 form and K1 with
    AO;
61. K3 with the pyramid and the silhouette term in one launch
    (``inverse_fit``'s loss, ``sil_w = 1``) against its plain versions at
    256x192 (two cameras), a ragged 250x190, ``inverse_fit``'s 96x64 start
    and 1080p step 0 (``check_grads``: 1e-4 of the mass on K1's planes, 1e-3
    on its own march), ``fit_view``'s form at ``pose_fit``'s 128x96 start;
    its CUDA-event ms at 1080p in turns beside the multiscale-only,
    silhouette-only and L2 forms, its bound (:func:`branch_work`); a 20-step
    ``fit_scene(loss="multiscale", silhouette_weight=1.0)`` at 1080p: K3 = 20
    and nothing else, the loss falling;
62. the scripts at the JAX scripts' defaults: ``inverse_fit`` (K1 = 3, K3 =
    200; checkpoints at 50, 100, 150 and 200, a metrics line every 10 steps,
    the radius toward 0.2), ``pose_fit`` (K1 = 3, K3 = 300, the position
    error falling), ``render_gallery`` (K1 = 7 with AO, each frame against
    K1's plain version at its ``SCENE_BARS`` bar, razor-edge and
    rounding-decided pixels past the hard limit), ``neural_sdf`` (K6 = 12 on
    the freshly distilled model, frame 0 against K6's plain version at
    ``NEURAL_BAR``), ``grid_fit`` (cut to 60 of its 300 steps; K1 = 1 for the
    analytic target, the grid on the torch paths, the image error falling) in
    this process, and
    ``sharded_render`` as a subprocess over two ranks sharing the card over
    gloo (K1 = K2 = 1 a rank, ``render_sharded`` equal to ``render`` and K2's
    image K1's, bit for bit); then K1 with AO at 1080p on each gallery scene
    beside K1 without it, in turns.

The kernels line gives ``render_fwd``, ``render_tiles``, ``fit_step`` and
``neural_fwd`` an ``examples`` entry and ``fit_step`` a
``multiscale_silhouette`` entry.

Every kernel's bound is the larger of its bytes over the card's memory rate
and its operations over the FP32 and special-function rates (and, for K6,
the tensor cores' TF32 rate), counted from
this run's data (:func:`march_counts`: the marches' steps at 1080p) and the
generated code (:func:`scene_costs`).

Then one JSON line describing the kernels, and last the JSON result line.
Any failed check raises, so the script exits non-zero and prints no result.
It imports nothing of JAX and exits non-zero without a CUDA device.

    python3 chip_smoke.py --time-kernels ROOT [ROOT ...]

times K1, K2, K3 and both forms of K5 at 1080p for each checkout in turn
and prints SHA-256 digests of K1's planes, K2's stacks, K3's partial rows
and float64 totals and K5's parameter columns, the registers of K1, K3 and
K5, K1's issue floor, then times K6 at hidden 64, 128 and 256 on phase
16's 1080p cell, and, for a checkout that has the flagship, K1, K3 and K5
(its P form) on the flagship with the digests of K1's planes and K3's and
K5's totals and their registers, and last compares the checkouts (:func:`time_kernels`: give
the parent and the change in turns to compare them on one card).

    python3 chip_smoke.py --register-line

times K3 and both forms of K5 at 1080p on the register line's scenes at
every cap of :data:`SWEEP_CAPS`, all in one process, the caps interleaved,
with their registers and spills (:func:`register_line`); scene names after
the flag (``--register-line fractal_scene``) time those scenes alone.
"""

from __future__ import annotations

import ast
import atexit
import concurrent.futures
import dataclasses
import functools
import hashlib
import json
import math
import multiprocessing
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
_T0 = time.perf_counter()


#: Seconds of the foreground thread between one log line and the next, summed
#: by the phase that logged the later line; ``[_T0]`` when the last line was.
PHASE_SECONDS: dict = {}
_LAST_LINE = [_T0]
_LOG_LOCK = threading.Lock()


def log(phase: str, **fields) -> None:
    """One phase's line; ``wall_s``: seconds since the script started;
    ``phase_seconds``: since the line before it (added to
    :data:`PHASE_SECONDS` under ``phase``)."""
    with _LOG_LOCK:
        now = time.perf_counter()
        spent, _LAST_LINE[0] = now - _LAST_LINE[0], now
        PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + spent
    print(f"[{phase}] " + json.dumps({**fields, "phase_seconds": spent, "wall_s": now - _T0}, sort_keys=True),
          flush=True)


def longest_phases(n: int = 10) -> list:
    """The ``n`` phases of :data:`PHASE_SECONDS` that took longest, as
    ``[name, seconds]``, longest first."""
    return [[k, v] for k, v in sorted(PHASE_SECONDS.items(), key=lambda kv: -kv[1])[:n]]


def host_witness(torch) -> dict:
    """The host's speed on fixed work, each part timed on its own: a
    pure-Python loop (``python_s``), numpy (``numpy_s``: a sort of 2^21
    seeded floats and 20 products of 256×256 matrices), and 2000 launches of
    an empty kernel (``torch.cuda._sleep(0)``) with one synchronize
    (``launch_us``, µs a launch).  A run's phase times read against another
    run's through these: the smoke's plain versions are launch-bound host
    loops."""
    import numpy as np

    t0 = time.perf_counter()
    acc = 0
    for i in range(3_000_000):
        acc += i * i % 7
    python_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    x, m = rng.random(1 << 21), rng.random((256, 256))
    t0 = time.perf_counter()
    np.sort(x)
    for _ in range(20):
        m = m @ m
        m /= np.abs(m).max()
    numpy_s = time.perf_counter() - t0
    n = 2000
    torch.cuda.synchronize()
    torch.cuda._sleep(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t0) / n * 1e6
    return {"python_s": python_s, "numpy_s": numpy_s, "launch_us": launch_us, "launches": n,
            "python_check": acc}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def project(cam, point, width, height):
    """Pixel (row, col) of a world point under the reference ray mode."""
    import numpy as np

    v = cam.c2w.cpu().numpy().T @ (np.asarray(point) - cam.position.cpu().numpy())
    fz = 2.0 / np.tan(np.radians(float(cam.fov_deg)) / 2.0)
    qx = v[0] / -v[2] * fz / (width / height)
    qy = v[1] / -v[2] * fz
    return int(round((1.0 - qy) / 2.0 * height - 0.5)), int(round((qx + 1.0) / 2.0 * width - 0.5))


# The card's peaks (the H100 SXM at its 700 W limit): 67 TFLOP/s of FP32
# outside the tensor cores, an FMA counting two operations, and 3.35 TB/s of
# device memory (NVIDIA's data sheet); the special-function units (sqrt and
# reciprocal steps, exp, log) give 16 results per clock per SM (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0) on 132 SMs
# at the 1.98 GHz boost clock.
FP32_PEAK = 67e12
SFU_PEAK = 132 * 16 * 1.98e9
# The tensor cores' dense TF32 rate (NVIDIA's H100 SXM data sheet, without
# sparsity): the neural kernel's split-TF32 products.
TC_TF32_PEAK = 495e12
HBM_BYTES_PER_S = 3.35e12
# Warp instructions the card issues a second: one a clock on each of an
# SM's four schedulers, 132 SMs at the 1.98 GHz boost clock.
ISSUE_RATE = 132 * 4 * 1.98e9
# Operations of one step of the kernels' loops around the distance
# evaluation (render_kernel.cuh): the primary march adds the step and makes
# two compares; a soft-shadow step (march_shadow) makes 19 FP32 operations,
# two of them divisions.  The neural kernel's shadow step (neural_kernel.cuh)
# makes 15, with a division and a square root.
PRIMARY_STEP = (3, 0)
SHADOW_STEP = (19, 2)
NEURAL_SHADOW_STEP = (15, 2)
#: Phase 55's material of the shaded grid and its analytic twin (not the
#: reference material).
SHADED_MATERIAL = {"ambient": (0.3, 0.1, 0.05), "diffuse": (0.9, 0.3, 0.1), "specular": (0.2, 0.6, 0.4),
                   "shininess": 20.0}


def expr_ops(expr: str) -> tuple:
    """``(FP32 operations, special-function operations)`` of one C
    expression of a generated header, each distinct subexpression once (the
    compiler evaluates a repeated one once): arithmetic, compares, selects
    and min/max count one, a division or ``sqrtf`` one of each."""
    py = re.sub(r"(?<![\w.])(\d+\.?\d*(?:e[-+]?\d+)?)f\b", r"\1", expr.replace("sdf3d::", ""))
    seen, fp, sfu = set(), 0, 0
    for node in ast.walk(ast.parse(py, mode="eval")):
        if not isinstance(node, (ast.BinOp, ast.Call, ast.Compare, ast.IfExp)):
            continue
        key = ast.dump(node)
        if key in seen:
            continue
        seen.add(key)
        fp += 1
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)) or (
                isinstance(node, ast.Call) and getattr(node.func, "id", "") == "sqrtf"):
            sfu += 1
    return fp, sfu


def function_body(header: str, signature: str) -> str:
    """The text between the braces of the function ``signature`` of a
    generated header."""
    i = header.index(signature)
    j = k = header.index("{", i)
    depth = 0
    while True:
        depth += {"{": 1, "}": -1}.get(header[k], 0)
        if depth == 0:
            return header[j + 1:k]
        k += 1


def body_ops(header: str, signature: str) -> tuple:
    """The operations of the body of the function ``signature`` of a
    generated header: the sum over its statements' expressions."""
    fp = sfu = 0
    for stmt in function_body(header, signature).split(";"):
        m = re.search(r"(?:return|[+\-*]?=)\s*(.+)$", stmt.strip(), re.S)
        if m and m.group(1).strip():
            a, b = expr_ops(m.group(1).strip())
            fp, sfu = fp + a, sfu + b
    return fp, sfu


def ray_block_ops(header: str) -> tuple:
    """``(base, blocks)``: the operations of the ray form's step
    (``Scene::Ray::eval``) outside its guarded blocks, the skip tests
    included, and each guarded block's own (a union's skipped operand,
    ``ops/scene_program.py::_ray_union``), in the order of the text, each
    ``(FP32, special-function)`` summed over statements (:func:`expr_ops`)."""
    base, blocks, stack = [0, 0], [], []
    for line in function_body(header, "float eval(float t)").splitlines():
        line = line.strip().rstrip(";")
        level = blocks[stack[-1]] if stack else base
        if line.startswith("if (") and line.endswith(") {"):
            fp, sfu = expr_ops(line[len("if ("):-len(") {")].lstrip("!"))
            level[0], level[1] = level[0] + fp, level[1] + sfu
            blocks.append([0, 0])
            stack.append(len(blocks) - 1)
        elif line == "}":
            stack.pop()
        else:
            m = re.search(r"(?:return|[+\-*]?=)\s*(.+)$", line)
            if m and m.group(1).strip():
                fp, sfu = expr_ops(m.group(1).strip())
                level[0], level[1] = level[0] + fp, level[1] + sfu
    return tuple(base), [tuple(b) for b in blocks]


def scene_costs(header: str) -> dict:
    """Operations per call of the generated scene code: the ray form's
    evaluation (``ray``: every block evaluated; ``ray_base`` and
    ``ray_blocks``: :func:`ray_block_ops`) and setup, the point form, its
    reverse (``sdf_bwd``) and its gradient (``sdf_grad_p``); for a scene
    with Shaded tags the material program (``material``) and its reverse
    (``material_bwd``) too."""
    sigs = [("setup", "void setup("), ("point", "float sdf(float px"), ("bwd", "void sdf_bwd("),
            ("grad", "void sdf_grad_p(")]
    if "has_materials" in header:
        sigs += [("material", "float material(float px"), ("material_bwd", "void material_bwd(")]
    base, blocks = ray_block_ops(header)
    ray = (base[0] + sum(b[0] for b in blocks), base[1] + sum(b[1] for b in blocks))
    return {"ray": ray, "ray_base": base, "ray_blocks": blocks, **{k: body_ops(header, sig) for k, sig in sigs}}


def bound(fp: float, sfu: float, nbytes: float) -> tuple:
    """``(bound_ms, bound_by)``: the least time of the work on the card,
    the larger of its bytes over the memory rate and its operations over
    the FP32 and special-function rates."""
    ops_s = max(fp / FP32_PEAK, sfu / SFU_PEAK)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def warp_steps(torch, plane) -> float:
    """The warp-steps of a march from its per-pixel evaluation counts: the
    sum over the kernels' warps (32 pixels of a row of a 32×8 block, the
    default ``KernelConfig``) of their rays' most, since a warp steps while
    one of its rays does."""
    H, W = plane.shape
    padded = torch.nn.functional.pad(plane, (0, -W % 32))
    return float(padded.reshape(H, -1, 32).amax(dim=2).sum())


def march_counts(torch, scene, cam, cfg, prm, uni, plain) -> dict:
    """Distance evaluations of the kernels' marches on this run's data (the
    camera ``cam`` that ``uni`` packs): both marches' steps summed over the
    image from the plain version's counters (``plain(..., steps=)``, the
    kernel's loops; ``primary`` and ``plain_primary`` the same count), the
    rays that march a shadow, each march's warp-steps (:func:`warp_steps`)
    and, where the plain version counts them
    (``ops/render_kernel.py::WarpSkips``), its union skips by ray and by
    warp (``primary_skips``, ``shadow_skips``)."""
    with torch.no_grad():
        steps = {}
        plain(scene, prm, uni, cfg, steps=steps)
    primary = float(steps["primary"].sum())
    return {"pixels": cfg.width * cfg.height, "primary": primary, "shadow": float(steps["shadow"].sum()),
            "shadow_rays": float((steps["shadow"] > 0).sum()), "plain_primary": primary,
            "primary_warp_steps": warp_steps(torch, steps["primary"]),
            "shadow_warp_steps": warp_steps(torch, steps["shadow"]),
            **{k: steps[k].as_dict() for k in ("primary_skips", "shadow_skips") if k in steps}}


def ray_step_ops(costs: dict, counts: dict, march: str) -> tuple:
    """``(FP32, special-function)`` operations of one step of ``march``
    (``primary`` or ``shadow``) of the ray form on ``counts``' data: its
    guarded blocks at the share of the march's ray-steps that run them
    (``counts[march + "_skips"]``); every block where the count has none."""
    skips = counts.get(f"{march}_skips") or {}
    runs, lane = skips.get("lane_runs", []), skips.get("lane_steps")
    if not lane or len(runs) != len(costs.get("ray_blocks", ())):
        return costs["ray"]
    fp, sfu = costs["ray_base"]
    for (bf, bs), r in zip(costs["ray_blocks"], runs):
        fp, sfu = fp + bf * r / lane, sfu + bs * r / lane
    return fp, sfu


def analytic_work(costs: dict, counts: dict, cfg, primal: bool = True, reverse: bool = False,
                  retrace: bool = False) -> tuple:
    """``(FP32, special-function)`` operations of the analytic kernels on
    ``counts``' data: the primal's marches (each step an evaluation of the
    ray form and the loop's operations, a setup per marched ray) and normal
    taps (the point form); the reverse pass's implicit-function gradient and
    reverse taps, and with ``retrace`` the normal taps again (K5 rebuilds
    the primal from the forward's planes; the fused fit step reverses its
    own).  Ray generation and shading are left out, so this is a floor."""
    taps = 6 if cfg.normals == "central" else 4
    n = counts["pixels"]
    fp = sfu = 0.0
    mat = [costs["material"]] if "material" in costs else []  # once a pixel at its hit
    if primal:
        terms = [(counts["primary"], ray_step_ops(costs, counts, "primary"), PRIMARY_STEP),
                 (counts["shadow"], ray_step_ops(costs, counts, "shadow"), SHADOW_STEP),
                 (n + counts["shadow_rays"], costs["setup"], (0, 0)), (n * taps, costs["point"], (0, 0))]
        terms += [(n, m, (0, 0)) for m in mat]
        for calls, (f, s_), (lf, ls) in terms:
            fp, sfu = fp + calls * (f + lf), sfu + calls * (s_ + ls)
    if reverse:
        terms = [(n, costs["grad"]), (n * (taps + 1), costs["bwd"])] + [(n * taps, costs["point"])] * retrace
        if mat:
            terms += [(n, costs["material_bwd"])] + [(n, mat[0])] * retrace
        for calls, (f, s_) in terms:
            fp, sfu = fp + calls * f, sfu + calls * s_
    return fp, sfu


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@functools.cache
def _profiling():
    """This checkout's ``sdf3d_tpu_torch/utils/profiling.py`` (torch and the
    standard library only), loaded by path: ``--time-kernels`` times another
    checkout's package with it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_profiling", os.path.join(REPO, "sdf3d_tpu_torch", "utils", "profiling.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_ms(fn, warmup=3, frames=20) -> float:
    """ms per call of ``fn`` by CUDA events: the bench's timer
    (``utils/profiling.py::cuda_event_ms``)."""
    return _profiling().cuda_event_ms(fn, warmup, frames)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ----
    card = card_name_and_power()
    witness = host_witness(torch)
    log("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), witness=witness)
    print(card, flush=True)

    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch import cli
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_forward_plain,
        render_kernel_launch,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.utils.parity import check_planes

    dev = torch.device("cuda", 0)
    light, mat = tt.reference_light(), tt.reference_material()
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    scene = tt.reference_scene()

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    # ---- 2. build, and no rebuild on a parameter change ----
    libs, launches0 = _build.LIBRARIES, render_kernel_forward.launches
    t0 = time.perf_counter()
    a = render_kernel_forward(scene, tt.Camera.reference(), light, mat, cfg, device=dev)[0]
    torch.cuda.synchronize()
    first_frame_s = time.perf_counter() - t0
    bigger = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.0, 0.4, 0.0), 0.25))
    b = render_kernel_forward(bigger, tt.Camera.reference(), light, mat, cfg, device=dev)[0]
    torch.cuda.synchronize()
    check(libs.loaded == 1 and libs.builds <= 1,
          f"expected one library, got {libs.loaded} loaded and {libs.builds} built")
    check(render_kernel_forward.launches - launches0 == 2, "expected two launches")
    check(bool((a != b).any()), "changing the sphere radius did not change the image")
    key = libs.key(cuda_scene_source(scene, cfg, KernelConfig()))
    ptxas = [ln.strip() for ln in libs.log(key).splitlines() if "registers" in ln or "spill" in ln]
    log("build", builds=libs.builds, libraries=libs.loaded, build_seconds=libs.build_seconds,
        first_frame_seconds=first_frame_s, launches=render_kernel_forward.launches - launches0, ptxas=ptxas)

    # ---- 3. kernel vs plain at 256x192 ----
    small = dataclasses.replace(cfg, width=256, height=192)
    for cam_name, cam in (("reference", tt.Camera.reference()),
                          ("orbit30_15", tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0))):
        for ray_sdf in (True, False):
            kc = KernelConfig(ray_sdf=ray_sdf)
            prm, uni = inputs(scene, cam, small)
            got = render_kernel_launch(scene, prm, uni, small, kc)
            want = render_kernel_forward_plain(scene, prm, uni, small, kc)
            torch.cuda.synchronize()
            stats = check_planes(got, want, small.march.max_distance, f"{cam_name} ray_sdf={ray_sdf}")
            log("parity_256x192", camera=cam_name, ray_sdf=ray_sdf,
                **{n: {k: st[k] for k in ("over_atol", "max_abs_err")} for n, st in stats.items()})
    check(libs.loaded == 2, f"expected two libraries (ray and point form), got {libs.loaded}")
    # Every later library known now builds from here on in the background,
    # two at a time, in the order the phases load them; a phase that loads
    # one still building waits for it.
    queue = libs.prefetch(prefetch_jobs(tt, dev), workers=2)

    # ---- 4. main path: render_batch over 4 orbit cameras ----
    cams = [tt.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0) for i in range(4)]
    render_kernel_forward.launches = 0
    frames = tt.render_batch(scene, cams, light, mat, cfg, engine="kernel")
    torch.cuda.synchronize()
    batch_launches = render_kernel_forward.launches
    check(batch_launches == 4, f"render_batch launched {batch_launches} kernels for 4 frames")
    check(tuple(frames.shape) == (4, H, W, 3) and frames.device.type == "cuda", f"bad frames {frames.shape}")
    check(bool(torch.isfinite(frames).all()), "non-finite pixels in the main path")

    # ---- 5. CLI through the kernel ----
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "render.png")
        check(cli.main(["render", "--width", str(W), "--height", str(H), "--out", png]) == 0, "cli failed")
        with open(png, "rb") as f:
            head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == W.to_bytes(4, "big") + H.to_bytes(4, "big"),
              "the CLI did not write a 1920x1080 PNG")
        png_bytes = os.path.getsize(png)
    main_launches = render_kernel_forward.launches
    check(main_launches == 5, f"main path launched {main_launches} kernels, expected 5")

    # Output checks on frame 0 (outside the counted window).
    prm0, uni0 = inputs(scene, cams[0], cfg)
    k_rgb, k_t, k_sh, k_ao = render_kernel_launch(scene, prm0, uni0, cfg)
    torch.testing.assert_close(k_rgb.permute(1, 2, 0), frames[0], rtol=0, atol=0)
    row, col = project(cams[0], (0.0, 0.4, 0.0), W, H)
    ambient = torch.tensor([0.0, 0.02, 0.08], device=dev)
    centre = frames[0, row, col]
    check(1.7 < float(k_t[row, col]) < 1.9, f"sphere centre pixel t={float(k_t[row, col])}, expected about 1.81")
    check(bool((centre - ambient > 1e-3).all()), f"sphere centre pixel {centre.tolist()} is not lit")
    sky = frames[0, 0, 0]
    check(float(k_t[0, 0]) > cfg.march.max_distance, "top-left pixel is not a miss")
    torch.testing.assert_close(sky, ambient, rtol=0, atol=1e-6)
    p_rgb, p_t, p_sh, p_ao = render_kernel_forward_plain(scene, prm0, uni0, cfg)
    parity = check_planes((k_rgb, k_t, k_sh, k_ao), (p_rgb, p_t, p_sh, p_ao), cfg.march.max_distance,
                          "1080p frame 0")
    log("main_path", frames=list(frames.shape), launches=main_launches, render_batch_launches=batch_launches,
        cli_png_bytes=png_bytes, sphere_centre_px=[row, col], sphere_centre_rgb=centre.tolist(),
        sky_rgb=sky.tolist(), parity_1080p={n: {k: st[k] for k in ("over_atol", "max_abs_err")}
                                            for n, st in parity.items()})

    # ---- 6. times at 1080p (plain, kernel, kernel, plain) ----
    # The kernel's time is its entry point's alone (render_alone): at about
    # 0.12 ms a frame, back-to-back render_kernel_launch calls can time the
    # host's lookup and allocations instead (launch_ms beside it).
    prm, uni = inputs(scene, tt.Camera.reference(), cfg)
    kern = render_alone(torch, scene, prm, uni, cfg)
    launch = lambda: render_kernel_launch(scene, prm, uni, cfg)  # noqa: E731
    plain = lambda: render_kernel_forward_plain(scene, prm, uni, cfg)  # noqa: E731
    wrapper = lambda: render_kernel_forward(scene, tt.Camera.reference(), light, mat, cfg, device=dev)  # noqa: E731
    p1 = time_ms(plain, 1, 3)
    k1 = time_ms(kern)
    k2 = time_ms(kern)
    p2 = time_ms(plain, 1, 3)
    w1 = time_ms(wrapper)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    log("times_1080p", card=card, kernel_ms=kernel_ms, kernel_ms_runs=[k1, k2], launch_ms=time_ms(launch),
        kernel_rays_per_s=W * H / (kernel_ms / 1e3), wrapper_ms=w1, plain_ms=plain_ms, plain_ms_runs=[p1, p2],
        plain_rays_per_s=W * H / (plain_ms / 1e3), build_seconds=libs.build_seconds)

    # K1's bound on this cell: its marches and taps on the reference scene.
    counts = march_counts(torch, scene, tt.Camera.reference(), cfg, prm, uni, render_kernel_forward_plain)
    fp, sfu = analytic_work(scene_costs(cuda_scene_source(scene, cfg, KernelConfig())), counts, cfg)
    bound_ms, bound_by = bound(fp, sfu, 24 * W * H)
    # K1's issue floor on the same data: its SASS's warp instructions.
    lib_path = str(libs.build_dir / libs.key(cuda_scene_source(scene, cfg, KernelConfig()))
                   / _build.KINDS["render"].lib_name)
    k1_sass = next(v for k, v in sass_listing(lib_path).items() if "sdf3d_render_fwd_kernel" in k)
    floor = issue_floor(k1_sass, counts)
    # The split of its SASS by opcode class, and the union skips' shares.
    log("bound_render_fwd", counts=counts, fp32_ops=fp, sfu_ops=sfu, bound_ms=bound_ms, bound_by=bound_by,
        issue_floor=floor, kernel_ms_over_issue_floor=kernel_ms / floor["issue_floor_ms"],
        sass_split=sass_split(k1_sass), skip_share={k: counts[f"{k}_skips"]["warp_skip_share"]
                                                    for k in ("primary", "shadow")})

    fit_kernels = fit_phases(torch, tt, card, dev)
    neural_kernel = neural_phases(torch, tt, card, dev)
    tiles_kernels = tiles_phases(torch, tt, card, dev, {"render_fwd": kernel_ms})
    variant_kernel = variant_phases(torch, tt, card, dev)
    bench_phases(torch, tt, card, dev)
    # Phase 24's two ranks run while phases 30-31 (which time nothing) run
    # here; the flagship's phases call ring_finish there.
    ring_finish, ring_out = ring_phases(torch, tt, card), {}
    flagship = flagship_phases(torch, tt, card, dev, then=lambda: ring_out.update(kernels=ring_finish()))
    ring_kernels = ring_out["kernels"]
    scenes = scenes_13b_phases(torch, tt, card, dev)
    fractal = fractal_phases(torch, tt, card, dev)
    losses = loss_phases(torch, tt, card, dev)
    sliced = slice_phases(torch, tt, card, dev)
    diffed = diff_phases(torch, tt, card, dev)
    rest = slice17_phases(torch, tt, card, dev)
    # Phases 58-59's labs run beside phase 62's scripts (neither times
    # anything); phase 62 waits for them before K1 with AO is timed.
    runtime, labs = slice18_phases(torch, tt, card, dev, defer_labs=True)
    examples = slice19_phases(torch, tt, card, dev, alongside=labs)
    runtime.update(labs.entries)
    kernels = [{
        "name": "render_fwd",
        "route": "cuda",
        "source": "sdf3d_tpu_torch/ops/csrc/render_kernel.cu",
        "replaces": "sdf3d_tpu/ops/render_kernel.py:614",
        "launches": main_launches,
        "max_abs_err": parity["rgb"]["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }] + fit_kernels + [neural_kernel] + tiles_kernels + ring_kernels + [variant_kernel]
    for entry in kernels:
        if entry["name"] in flagship:
            entry["flagship"] = flagship[entry["name"]]
    check(all("flagship" in e for e in kernels if e["name"] in flagship) and len(flagship) == 5,
          "a flagship entry of the kernels line is missing")
    for entry in kernels:
        if entry["name"] in scenes:
            entry["scenes_13b"] = scenes[entry["name"]]
    check(sum("scenes_13b" in e for e in kernels) == 3 and all(
        "scenes_13b" in e for e in kernels if e["name"] in ("render_fwd", "fit_step", "render_bwd")),
        "a scenes_13b entry of the kernels line is missing")
    for key in ("fractal", "relaxed"):
        for entry in kernels:
            if entry["name"] in fractal[key]:
                entry[key] = fractal[key][entry["name"]]
    check(sum("fractal" in e for e in kernels) == 3 and all(
        "fractal" in e for e in kernels if e["name"] in ("render_fwd", "fit_step", "render_bwd")),
        "a fractal entry of the kernels line is missing")
    check(sum("relaxed" in e for e in kernels) == 4 and all(
        "relaxed" in e for e in kernels if e["name"] in ("render_fwd", "render_tiles", "fit_step", "fit_step_tiles")),
        "a relaxed entry of the kernels line is missing")
    for entry in kernels:
        entry.update(losses.get(entry["name"], {}))
    check(all(k in e for e in kernels if e["name"] == "fit_step" for k in ("multiscale", "silhouette", "view")) and all(
        k in e for e in kernels if e["name"] == "fit_step_tiles" for k in ("multiscale", "silhouette")),
        "a loss branch's entry of the kernels line is missing")
    for entry in kernels:
        entry.update(sliced.get(entry["name"], {}))
    check(all("multiview" in e for e in kernels if e["name"] == "fit_step") and sum(
        "materials" in e for e in kernels) == 5, "a multiview or materials entry of the kernels line is missing")
    for entry in kernels:
        entry.update(diffed.get(entry["name"], {}))
    check(sum(k in e for e in kernels for k in ("fit_view_nonfused", "fit", "neural_fit")) == 5,
          "a diff.py entry (fit_view_nonfused, fit, neural_fit) of the kernels line is missing")
    for entry in kernels:
        entry.update(rest.get(entry["name"], {}))
    want17 = {"render_fwd": ("shadow_ad", "rows", "stereo"), "render_bwd": ("rows",), "neural_fwd": ("shadow_ad",)}
    check(all(k in e for e in kernels for k in want17.get(e["name"], ())) and
          sum(k in e for e in kernels for k in ("shadow_ad", "rows", "stereo")) == 5,
          "a shadow_ad, rows or stereo entry of the kernels line is missing")
    for entry in kernels:
        entry.update(runtime.get(entry["name"], {}))
    check(sum("interact" in e for e in kernels) == 1 and all("interact" in e for e in kernels
                                                             if e["name"] == "render_fwd") and
          sum("collectives_lab" in e for e in kernels) == 2, "an interact or collectives_lab entry is missing")
    for entry in kernels:
        entry.update(examples.get(entry["name"], {}))
    check(all("examples" in e for e in kernels if e["name"] in ("render_fwd", "render_tiles", "fit_step", "neural_fwd"))
          and sum("examples" in e for e in kernels) == 4 and all(
              "multiscale_silhouette" in e for e in kernels if e["name"] == "fit_step") and
          sum("multiscale_silhouette" in e for e in kernels) == 1,
          "an examples or multiscale_silhouette entry of the kernels line is missing")
    print(json.dumps({"kernels": kernels}), flush=True)
    log("summary", card=card, witness=witness, longest_phases=longest_phases(), prefetched=queue.result(),
        prefetch_seconds=libs.prefetch_seconds, foreground_builds=libs.builds, foreground_build_seconds=libs.build_seconds)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def worst_pixels(torch, got, want, razor, max_distance: float, n: int = 6) -> dict:
    """The ``n`` pixels of each plane that differ most between two renders
    ``(rgb, t, shadow, ao)``: position, both values and the razor-edge flag
    (a failed comparison's log)."""
    out = {}
    for name, g, w in zip(("rgb", "t", "shadow", "ao"), got, want):
        if name == "t":
            g, w = g.clamp(max=max_distance), w.clamp(max=max_distance)
        d = (g - w).abs()
        d = d.amax(0) if name == "rgb" else d
        top = torch.topk(d.reshape(-1), n).indices.tolist()
        W_ = d.shape[-1]
        out[name] = [{"px": [i // W_, i % W_], "diff": float(d.reshape(-1)[i]), "razor": bool(razor.reshape(-1)[i]),
                      "got": (g[:, i // W_, i % W_] if name == "rgb" else g[i // W_, i % W_]).tolist(),
                      "want": (w[:, i // W_, i % W_] if name == "rgb" else w[i // W_, i % W_]).tolist()}
                     for i in top]
    return out


def kernel_key(mangled: str) -> str:
    """A kernel function's short name: ``render_fwd`` (K1, K2),
    ``fit_step`` (K3, K4), ``render_bwd`` (K5 with the uniforms' gradient,
    and a library's only K5 where it has one form) and ``render_bwd_params``
    (K5 without it, ``WRT_U = false``); other kernels keep their mangled
    names."""
    if "render_bwd" in mangled:
        return "render_bwd_params" if "ILb0E" in mangled else "render_bwd"
    return next((k for k in ("render_fwd", "fit_step") if k in mangled), mangled)


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes per kernel (:func:`kernel_key`) from an
    ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_key(m.group(1))
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


class PlainCalls:
    """Counts calls of the kernels' plain versions while active (wrapping
    every module-level reference to them in the package), and of
    ``planar_vjp``, the planar re-trace's VJP: K5's plain version runs it,
    and so do the backwards that have no kernel (the neural family's, and
    any under ``shadow.grad == "ad"``)."""

    NAMES = ("render_kernel_forward_plain", "fit_step_kernel_plain", "render_kernel_backward_plain",
             "render_kernel_tiles_forward_plain", "fit_step_kernel_tiles_plain", "fit_step_variant_plain",
             "fit_step_views_plain", "planar_vjp")

    def __enter__(self):
        self.calls, self._saved = {n: 0 for n in self.NAMES}, []
        for mod in [m for k, m in sys.modules.items() if k.startswith("sdf3d_tpu_torch")]:
            for n in self.NAMES:
                fn = getattr(mod, n, None)
                if fn is not None:
                    self._saved.append((mod, n, fn))
                    setattr(mod, n, self._wrap(n, fn))
        return self

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        for mod, n, fn in self._saved:
            setattr(mod, n, fn)
        return False


class BackwardModes:
    """Records, while active, the ``wrt_uniforms`` of every call the
    differentiable render's backward makes of the render backward
    (``ops/render_autograd.py``): True where it asked for the uniforms'
    gradient."""

    def __enter__(self):
        from sdf3d_tpu_torch.ops import render_autograd

        self.calls, self._module = [], render_autograd
        self._saved = fn = render_autograd.render_kernel_backward

        def recording(*args, wrt_uniforms=True, **kwargs):
            self.calls.append(wrt_uniforms)
            return fn(*args, wrt_uniforms=wrt_uniforms, **kwargs)
        render_autograd.render_kernel_backward = recording
        return self

    def __exit__(self, *exc):
        self._module.render_kernel_backward = self._saved
        return False


def fit_phases(torch, tt, card: str, dev) -> list:
    """Phases 7-12: the training path.  Returns the fit step's and the
    render backward's entries of the kernels line."""
    from sdf3d_tpu_torch import cli
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel, fit_step_kernel_launch, fit_step_kernel_plain
    from sdf3d_tpu_torch.ops.render_bwd_kernel import (
        render_bwd_launcher,
        render_kernel_backward,
        render_kernel_backward_launch,
        render_kernel_backward_plain,
    )
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_forward_plain,
        render_kernel_launch,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.utils.parity import check_grads, conditioned, gradient_mass

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    frozen = (0, 1, 2, 3)  # the plane of the fit demo
    trainable = (False, False, True, True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)

    def scene0():
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def k3_vs_plain(sc, cam, c, wrt_uniforms, frozen_slots, label, target=None, same_tol=1e-5):
        """The fit step against (1) the plain reverse pass on the kernel's own
        primal planes (K1's: the same arithmetic), at the K5 bar, and (2) the
        plain version, which marches its own primal: a ray that ends a step
        apart moves its pixel's term, so the bar is looser.  With no target,
        the kernel render plus seeded noise, none on grazing rays; a given
        target keeps its grazing rays, hence ``same_tol``."""
        prm, uni = inputs(sc, cam, c)
        rgb, t, sh, ao = render_kernel_launch(sc, prm, uni, c)
        if target is None:
            keep = conditioned(sc, prm, uni, t, c)
            noise = torch.rand((3, c.height, c.width), generator=gen, device=dev) * 0.2 - 0.1
            target = (rgb + noise * keep).contiguous()
        got = fit_step_kernel_launch(sc, prm, uni, target, c, KernelConfig(), wrt_uniforms, frozen_slots)
        want = fit_step_kernel_plain(sc, prm, uni, target, c, KernelConfig(), wrt_uniforms, frozen_slots)
        g_p, g_u = render_kernel_backward_plain(sc, prm, uni, 2.0 * (rgb - target), t, sh, ao, c)
        g_p[list(frozen_slots)] = 0.0
        same = torch.cat([g_p, g_u if wrt_uniforms else torch.zeros_like(g_u)])
        torch.cuda.synchronize()
        mass = gradient_mass(sc, prm, uni, 2.0 * (rgb - target), t, sh, ao, c)
        loss_rel = abs(float(got[0]) / float(want[0]) - 1.0)
        check(loss_rel <= 1e-5, f"{label}: loss off by {loss_rel:.3g} relative")
        check(all(float(got[1][k]) == 0.0 for k in frozen_slots), f"{label}: a frozen slot's gradient is not 0")
        check(wrt_uniforms or float(got[2].abs().max()) == 0.0, f"{label}: uniform gradients without wrt_uniforms")
        g = torch.cat(got[1:])
        return {"loss_rel_err": loss_rel,
                "same_planes": check_grads(g, same, mass, rtol=1e-4, mass_tol=same_tol, label=f"{label} (same planes)"),
                "own_march": check_grads(g, torch.cat(want[1:]), mass, rtol=1e-4, mass_tol=1e-3, label=label)}

    # ---- 7. build: the fit step and backward libraries ----
    libs = _build.LIBRARIES
    builds0, seconds0 = libs.builds, libs.build_seconds
    sc = scene0()
    prm, uni = inputs(sc, tt.Camera.reference(device=dev), cfg)
    small = dataclasses.replace(cfg, width=256, height=192)
    target = torch.zeros((3, 192, 256), device=dev)
    fit_step_kernel_launch(sc, prm, uni, target, small, KernelConfig(), False, frozen)
    render_kernel_backward_launch(sc, prm, uni, target, target[0], target[1], target[2], small)
    torch.cuda.synchronize()
    ptxas = {}
    for wrt, fr in ((False, frozen), (True, ())):
        key = libs.key(cuda_scene_source(sc, cfg, KernelConfig(), wrt, fr))
        ptxas[f"wrt_uniforms={wrt} frozen={list(fr)}"] = ptxas_summary(libs.log(key))
    for kernels in ptxas.values():
        check(set(kernels) >= {"render_fwd", "fit_step", "render_bwd", "render_bwd_params"},
              f"ptxas reported {sorted(kernels)}")
        for v in kernels.values():
            v["blocks_per_sm"] = blocks_per_sm(v["registers"])
    log("build_fit", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        libraries=libs.loaded, ptxas=ptxas)

    # ---- 8. fit step vs plain at 256x192, and ragged 250x190 ----
    cams = (("reference", tt.Camera.reference(device=dev)),
            ("orbit30_15", tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)))
    # Each (wrt_uniforms, frozen slots) combination once, the cameras in turn.
    for (cam_name, cam), wrt, fr in ((cams[0], False, ()), (cams[0], True, frozen), (cams[1], False, frozen),
                                     (cams[1], True, ())):
        st = k3_vs_plain(sc, cam, small, wrt, fr, f"fit step {cam_name} wrt_uniforms={wrt} frozen={fr}")
        log("fit_step_256x192", camera=cam_name, wrt_uniforms=wrt, frozen=list(fr), **st)
    ragged = dataclasses.replace(cfg, width=250, height=190)
    for cam_name, cam in cams:
        st = k3_vs_plain(sc, cam, ragged, True, frozen, f"fit step 250x190 {cam_name}")
        log("fit_step_250x190", camera=cam_name, **st)

    # ---- 9. render backward vs plain at 256x192, and ragged 250x190, with
    # and without the uniforms' gradient ----
    for c, (cam_name, cam) in ((small, cams[0]), (small, cams[1]), (ragged, cams[1])):
        prm, uni = inputs(sc, cam, c)
        _, t, sh, ao = render_kernel_launch(sc, prm, uni, c)
        keep = conditioned(sc, prm, uni, t, c)
        g_rgb = (torch.randn((3, c.height, c.width), generator=gen, device=dev) * keep).contiguous()
        mass = gradient_mass(sc, prm, uni, g_rgb, t, sh, ao, c)
        for wrt in (True, False):
            label = f"render backward {c.width}x{c.height} {cam_name} wrt_uniforms={wrt}"
            got = render_kernel_backward_launch(sc, prm, uni, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
            want = render_kernel_backward_plain(sc, prm, uni, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
            torch.cuda.synchronize()
            check(wrt or (got[1] is None and want[1] is None), f"{label}: a uniforms' gradient")
            st = check_grads(torch.cat(got) if wrt else got[0], torch.cat(want) if wrt else want[0],
                             mass if wrt else mass[:prm.numel()], rtol=1e-4, mass_tol=1e-5, label=label)
            log(f"render_bwd_{c.width}x{c.height}", camera=cam_name, wrt_uniforms=wrt, **st)

    # ---- 10. main path: fit_scene at 1920x1080 ----
    cam = tt.Camera.reference(device=dev)
    target = render_kernel_forward(tt.reference_scene().to(dev), cam, light, mat, cfg, device=dev)[0]
    with PlainCalls() as plain, BackwardModes() as modes:
        render_kernel_forward.launches = fit_step_kernel.launches = render_kernel_backward.launches = 0
        t0 = time.perf_counter()
        l2 = fit_scene(target, scene0(), cam, light, mat, cfg, FitConfig(steps=20, learning_rate=1e-2, log_every=1),
                       trainable=trainable, device=dev)
        l2_seconds = time.perf_counter() - t0
        l2_counts = (fit_step_kernel.launches, render_kernel_forward.launches, render_kernel_backward.launches)
        render_kernel_forward.launches = fit_step_kernel.launches = render_kernel_backward.launches = 0
        t0 = time.perf_counter()
        ms = fit_scene(target, scene0(), cam, light, mat, cfg,
                       FitConfig(steps=5, learning_rate=1e-2, log_every=1, loss="multiscale"),
                       trainable=trainable, device=dev)
        ms_counts = (fit_step_kernel.launches, render_kernel_forward.launches, render_kernel_backward.launches)
        ms_seconds = time.perf_counter() - t0
        # A pyramid the kernel's block cannot hold (4 levels: 16-pixel
        # groups, 8-row blocks) takes the differentiable render, K1 + K5.
        render_kernel_forward.launches = fit_step_kernel.launches = render_kernel_backward.launches = 0
        ms4 = fit_scene(target, scene0(), cam, light, mat, cfg,
                        FitConfig(steps=5, learning_rate=1e-2, log_every=1, loss="multiscale", pyramid_levels=4),
                        trainable=trainable, device=dev)
        ms4_counts = (fit_step_kernel.launches, render_kernel_forward.launches, render_kernel_backward.launches)
        ms_modes = modes.calls[len(modes.calls) - ms4_counts[2]:]
    check(l2_counts == (20, 0, 0), f"fit_scene launched (fit step, forward, backward) = {l2_counts}, expected (20, 0, 0)")
    check(ms_counts == (5, 0, 0), f"multiscale fit launched (fit step, forward, backward) = {ms_counts}, expected (5, 0, 0)")
    check(ms4_counts == (0, 5, 5),
          f"4-level multiscale fit launched (fit step, forward, backward) = {ms4_counts}, expected (0, 5, 5)")
    check(sum(plain.calls.values()) == 0, f"the main path called plain versions: {plain.calls}")
    check(ms_modes == [False] * 5, f"the 4-level multiscale fit's backward asked for wrt_uniforms {ms_modes}, "
                                   "expected False on every step (the uniforms are not trained)")
    for name, res in (("l2", l2), ("multiscale", ms), ("multiscale_4_levels", ms4)):
        check(all(math.isfinite(v) for v in res.losses), f"{name} fit: non-finite loss")
        check(res.losses[-1] < res.losses[0], f"{name} fit: the loss did not fall ({res.losses[0]} -> {res.losses[-1]})")
    # Step 0 of the fit step against its plain version at 1080p (the real
    # target, grazing rays included).
    fit_st = k3_vs_plain(scene0(), cam, cfg, False, frozen, "fit step 1080p step 0",
                         target.permute(2, 0, 1).contiguous(), same_tol=1e-4)
    log("fit_main_path", steps=20, l2_launches=dict(zip(("fit_step", "render_fwd", "render_bwd"), l2_counts)),
        multiscale_launches=dict(zip(("fit_step", "render_fwd", "render_bwd"), ms_counts)),
        multiscale_4_levels_launches=dict(zip(("fit_step", "render_fwd", "render_bwd"), ms4_counts)),
        multiscale_render_bwd_wrt_uniforms=ms_modes, plain_calls=plain.calls,
        l2_losses=l2.losses, multiscale_losses=ms.losses, multiscale_4_levels_losses=ms4.losses,
        radius=l2.scene.b.radius.item(),
        l2_seconds=l2_seconds, multiscale_seconds=ms_seconds, step0=fit_st)

    # ---- 11. CLI ----
    fit_step_kernel.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "fit.jsonl")
        check(cli.main(["fit", "--width", str(W), "--height", str(H), "--steps", "10", "--metrics", metrics]) == 0,
              "cli fit failed")
        with open(metrics) as f:
            lines = [json.loads(ln) for ln in f]
    check(len(lines) >= 2 and all(math.isfinite(ln["loss"]) for ln in lines), f"bad metrics {lines}")
    check(fit_step_kernel.launches == 10, f"cli fit launched the fit step {fit_step_kernel.launches} times")
    log("cli_fit", metrics_lines=len(lines), losses=[ln["loss"] for ln in lines], launches=fit_step_kernel.launches)

    # ---- 12. times at 1080p (plain, kernel, kernel, plain) ----
    sc = scene0()
    prm, uni = inputs(sc, cam, cfg)
    tgt = target.permute(2, 0, 1).contiguous()
    _, t, sh, ao = render_kernel_launch(sc, prm, uni, cfg)
    g_rgb = torch.randn((3, H, W), generator=gen, device=dev)
    fit_k = lambda: fit_step_kernel_launch(sc, prm, uni, tgt, cfg, KernelConfig(), False, frozen)  # noqa: E731
    fit_p = lambda: fit_step_kernel_plain(sc, prm, uni, tgt, cfg, KernelConfig(), False, frozen)  # noqa: E731
    # K5 in the multiscale fit's form (the parameters' gradient alone:
    # "render_bwd") and with the uniforms' ("render_bwd_uniforms"): its entry
    # point, the kernel and its float64 total in one C call, beside its
    # plain version, then its wrapper (host-bound: its checks and library
    # lookup take longer than the kernel).
    timed = [("fit_step", fit_k, fit_p)]
    bwd_forms = {"render_bwd": False, "render_bwd_uniforms": True}
    for name, wrt in bwd_forms.items():
        timed.append((name, render_bwd_launcher(sc, prm, uni, g_rgb, t, sh, ao, cfg, KernelConfig(), wrt)[0],
                      functools.partial(render_kernel_backward_plain, sc, prm, uni, g_rgb, t, sh, ao, cfg,
                                        wrt_uniforms=wrt)))
    runs = {}
    for name, kern, plain_fn in timed:
        p1, k1, k2, p2 = time_ms(plain_fn, 1, 3), time_ms(kern), time_ms(kern), time_ms(plain_fn, 1, 3)
        runs[name] = {"ms": (k1 + k2) / 2, "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2]}
    bwd_mass = gradient_mass(sc, prm, uni, g_rgb, t, sh, ao, cfg)
    bwd_st = {}
    for name, wrt in bwd_forms.items():
        wrapper = functools.partial(render_kernel_backward_launch, sc, prm, uni, g_rgb, t, sh, ao, cfg,
                                    wrt_uniforms=wrt)
        runs[name]["wrapper_ms"] = time_ms(wrapper)
        got = wrapper()
        want = render_kernel_backward_plain(sc, prm, uni, g_rgb, t, sh, ao, cfg, wrt_uniforms=wrt)
        bwd_st[name] = check_grads(torch.cat(got) if wrt else got[0], torch.cat(want) if wrt else want[0],
                                   bwd_mass if wrt else bwd_mass[:prm.numel()], rtol=1e-4, mass_tol=1e-3,
                                   label=f"render backward 1080p wrt_uniforms={wrt}")
    fit_scene(target, scene0(), cam, light, mat, cfg, FitConfig(steps=5, log_every=5), trainable=trainable, device=dev)
    res = fit_scene(target, scene0(), cam, light, mat, cfg, FitConfig(steps=50, log_every=50),
                    trainable=trainable, device=dev)
    fit_ms = W * H / res.rays_per_second * 1e3
    # Bounds on this cell (step 0 of the fit demo): K3's primal and reverse
    # pass, its target read and P + 31 float64 totals written; K5's reverse
    # pass with its re-trace, six planes read, a partial row of its live
    # columns (P, or P + 30 with the uniforms) per block written and read
    # again by its total, and the float64 totals written.
    counts = march_counts(torch, sc, cam, cfg, prm, uni, render_kernel_forward_plain)
    costs = scene_costs(cuda_scene_source(sc, cfg, KernelConfig(), False, frozen))
    blocks = -(-W // 32) * -(-H // 8)
    k3 = bound(*analytic_work(costs, counts, cfg, primal=True, reverse=True), 12 * W * H + 8 * (prm.numel() + 31))
    k5 = {name: bound(*analytic_work(costs, counts, cfg, primal=False, reverse=True, retrace=True),
                      24 * W * H + (8 * blocks + 8) * (prm.numel() + (30 if "uniforms" in name else 0)))
          for name in ("render_bwd", "render_bwd_uniforms")}
    k5_st = bwd_st["render_bwd"]
    log("times_fit_1080p", card=card, fit_scene_ms_per_step=fit_ms, fwd_bwd_rays_per_s=res.rays_per_second,
        render_bwd_1080p=bwd_st, counts=counts, costs=costs, bound_fit_step=k3, bound_render_bwd=k5, **runs)
    return [
        {"name": "fit_step", "route": "cuda", "source": "sdf3d_tpu_torch/ops/csrc/fit_kernel.cu",
         "replaces": "sdf3d_tpu/ops/fit_kernel.py:93", "launches": l2_counts[0],
         "max_abs_err": fit_st["own_march"]["max_abs_err"], "ms": runs["fit_step"]["ms"],
         "plain_ms": runs["fit_step"]["plain_ms"], "bound_ms": k3[0], "bound_by": k3[1], "library_ms": None},
        {"name": "render_bwd", "route": "cuda", "source": "sdf3d_tpu_torch/ops/csrc/render_bwd_kernel.cu",
         "replaces": "sdf3d_tpu/ops/render_bwd_kernel.py:194", "launches": ms4_counts[2],
         "max_abs_err": k5_st["max_abs_err"], "ms": runs["render_bwd"]["ms"],
         "plain_ms": runs["render_bwd"]["plain_ms"], "bound_ms": k5["render_bwd"][0],
         "bound_by": k5["render_bwd"][1], "library_ms": None},
    ]


def neural_phases(torch, tt, card: str, dev) -> dict:
    """Phases 13-16: the NeuralSDF family on the neural kernel.  Returns its
    entry of the kernels line."""
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.neural_kernel import (
        NeuralRenderConfig,
        neural_structure,
        render_neural_forward,
        render_neural_forward_plain,
        render_neural_launch,
    )
    from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, pack_uniforms, render_kernel_forward
    from sdf3d_tpu_torch.ops.scene_program import cuda_neural_source, scene_param_vector
    from sdf3d_tpu_torch.utils.parity import NEURAL_BAR, check_planes, pixel_budget

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    nc = NeuralRenderConfig()
    ref = tt.REFERENCE_CONFIG

    def config(w, h, steps=64, shadow_steps=32, **kw):
        return dataclasses.replace(ref, width=w, height=h, march=dataclasses.replace(ref.march, max_steps=steps),
                                   shadow=dataclasses.replace(ref.shadow, max_steps=shadow_steps), **kw)

    def scene(hidden, bare=False, seed=0):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        m = tt.sdf.neural_sdf(gen, hidden=hidden, depth=3, radius=0.3)
        return m if bare else tt.sdf.ground_plane().to(dev) | m

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def compare(sc, cam, c, label):
        prm, uni = inputs(sc, cam, c)
        got = render_neural_launch(sc, prm, uni, c, nc)
        want = render_neural_forward_plain(sc, prm, uni, c)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x).all()) for x in got), f"{label}: non-finite kernel output")
        st = check_planes(got, want, c.march.max_distance, label, **NEURAL_BAR)
        # Pixels off by more than the analytic kernels' 1e-4, for the record.
        fine = {n: pixel_budget(g, w, 0 if n == "rgb" else None)["over_atol"]
                for n, g, w in zip(("rgb", "t", "shadow", "ao"), got, want) if n != "t"}
        return {n: {k: v[k] for k in ("over_atol", "max_abs_err")} for n, v in st.items()} | {"over_1e-4": fine}

    def ptxas(c, sc):
        log_text = _build.LIBRARIES.log(_build.LIBRARIES.key(cuda_neural_source(sc, c, nc), "neural"))
        return [ln.split(":", 1)[-1].strip() for ln in log_text.splitlines()
                if re.search(r"Used \d+ registers|spill stores", ln)]

    crossover = config(W, H)
    small = config(256, 192)
    cams = (("reference", tt.Camera.reference(device=dev)),
            ("orbit30_15", tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)))
    u64, b64, u128, u256 = scene(64), scene(64, bare=True), scene(128), scene(256)
    steps100 = config(256, 192, 100, 100)
    options = config(256, 192, normals="tetrahedron", ao=dataclasses.replace(ref.ao, enabled=True),
                     background=(0.05, 0.05, 0.1))

    # ---- 13. build ----
    libs = _build.LIBRARIES
    builds0, seconds0, loaded0 = libs.builds, libs.build_seconds, libs.loaded
    t0 = time.perf_counter()
    render_neural_forward(u64, cams[0][1], light, mat, crossover, nc, device=dev)
    torch.cuda.synchronize()
    first_frame_s = time.perf_counter() - t0
    render_neural_forward(scene(64, seed=1), cams[0][1], light, mat, crossover, nc, device=dev)
    check(libs.loaded == loaded0 + 1, "a frame with other weights built another library")
    render_neural_forward(b64, cams[0][1], light, mat, small, nc, device=dev)
    check(libs.loaded == loaded0 + 2, "a bare NeuralSDF did not build its own library")
    t0 = time.perf_counter()
    libs.load_many([(neural_structure(sc, c, nc), (lambda sc=sc, c=c: cuda_neural_source(sc, c, nc)), "neural")
                    for sc, c in ((u256, small), (u128, small), (u64, steps100), (u64, options))])
    parallel_s = time.perf_counter() - t0
    check(libs.loaded == loaded0 + 6, f"expected six neural libraries, got {libs.loaded - loaded0}")
    check(libs.builds - builds0 <= 6, f"{libs.builds - builds0} neural builds")
    # The MLP runs on the tensor cores: hidden 64's library holds HMMA
    # instructions (cuobjdump -sass), their share of the kernel's SASS logged.
    sass = {}
    for name, sc in (("hidden64_union", u64),):
        key = libs.key(cuda_neural_source(sc, small, nc), "neural")
        ops = {}
        for fn_ops in sass_opcodes(str(libs.build_dir / key / _build.KINDS["neural"].lib_name)).values():
            for k, v in fn_ops.items():
                ops[k] = ops.get(k, 0) + v
        hmma = sum(v for k, v in ops.items() if k.startswith("HMMA"))
        check(hmma > 0, f"{name}: no tensor-core (HMMA) instruction in K6's library")
        sass[name] = {"hmma": hmma, "instructions": sum(ops.values()), "hmma_share": hmma / sum(ops.values()),
                      "hmma_kinds": sorted(k for k in ops if k.startswith("HMMA"))}
    log("neural_build", first_frame_seconds=first_frame_s, builds=libs.builds - builds0,
        build_seconds=libs.build_seconds - seconds0, parallel_build_wall_seconds=parallel_s,
        libraries=libs.loaded - loaded0, sass=sass,
        ptxas={"hidden64_union": ptxas(small, u64), "hidden64_bare": ptxas(small, b64),
               "hidden128_union": ptxas(small, u128), "hidden256_union": ptxas(small, u256)})

    # ---- 14. kernel vs plain at 256x192 ----
    cases = [(f"hidden64 union {n}", u64, cam, small) for n, cam in cams] + [
        ("hidden64 bare orbit30_15", b64, cams[1][1], small),
        ("hidden256 union orbit30_15", u256, cams[1][1], small),
        ("hidden256 union reference", u256, cams[0][1], small),
        ("hidden64 union 100/100 orbit30_15", u64, cams[1][1], steps100),
        ("hidden64 union tetrahedron+ao+background orbit30_15", u64, cams[1][1], options),
    ]
    for label, sc, cam, c in cases:
        log("neural_parity_256x192", case=label, **compare(sc, cam, c, label))

    # ---- 15. main path: distill, then a 12-frame turntable at 1080p ----
    target = tt.sdf.smooth_union(tt.sdf.sphere((-0.12, 0.4, 0.0), 0.18), tt.sdf.sphere((0.15, 0.48, 0.0), 0.14),
                                 k=0.08).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model, losses = tt.sdf.distill(tt.sdf.neural_sdf(gen, hidden=64, depth=3, radius=0.3), target, 1, steps=400,
                                   batch=4096, lo=(-0.6, -0.2, -0.6), hi=(0.6, 1.0, 0.6))
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    pts = torch.rand((512, 3), generator=gen, device=dev) * 0.8 - 0.4 + torch.tensor([0.0, 0.4, 0.0], device=dev)
    with torch.no_grad():
        field_err = float((model.distance(pts) - target.distance(pts)).abs().mean())
    check(len(losses) == 400 and all(math.isfinite(x) for x in losses), "distill: bad losses")
    check(losses[-1] < 0.2 * losses[0], f"distill: the loss fell from {losses[0]} to {losses[-1]} only")
    check(field_err < 0.02, f"distill: mean field error {field_err} near the target")
    neural = tt.sdf.ground_plane().to(dev) | model
    orbit = [tt.Camera.orbit(azimuth_deg=360.0 * k / 12, elevation_deg=18.0, device=dev) for k in range(12)]
    render_neural_forward.launches = render_kernel_forward.launches = 0
    t0 = time.perf_counter()
    frames = tt.render_batch(neural, orbit, light, mat, crossover, engine="kernel")
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    counts = (render_neural_forward.launches, render_kernel_forward.launches)
    check(counts == (12, 0), f"render_batch launched (neural, render) = {counts}, expected (12, 0)")
    check(tuple(frames.shape) == (12, H, W, 3) and bool(torch.isfinite(frames).all()), "bad turntable frames")
    prm0, uni0 = inputs(neural, orbit[0], crossover)
    k0 = render_neural_launch(neural, prm0, uni0, crossover, nc)
    torch.testing.assert_close(k0[0].permute(1, 2, 0), frames[0], rtol=0, atol=0)
    p0 = render_neural_forward_plain(neural, prm0, uni0, crossover)
    parity = check_planes(k0, p0, crossover.march.max_distance, "neural 1080p frame 0", **NEURAL_BAR)
    fine = pixel_budget(k0[0], p0[0], 0)
    row, col = project(orbit[0], (0.0, 0.44, 0.0), W, H)
    check(float(k0[1][row, col]) < 3.0, f"blob centre pixel t={float(k0[1][row, col])} is not a hit")
    centre = frames[0, row, col]
    check(bool((centre - torch.tensor([0.0, 0.02, 0.08], device=dev) > 1e-3).any()), "the blob is not lit")

    diff_scene = tt.sdf.ground_plane().to(dev) | model
    cam0 = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=18.0, device=dev)
    render_neural_forward.launches = render_kernel_forward.launches = 0
    img = render_kernel_diff(small, KernelConfig(), diff_scene, cam0, light, mat)
    (img * img).sum().backward()
    diff_counts = (render_neural_forward.launches, render_kernel_forward.launches)
    check(diff_counts == (1, 0), f"render_kernel_diff launched (neural, render) = {diff_counts}")
    grads = [diff_scene.a.normal.grad, diff_scene.a.offset.grad, *[w.grad for w in diff_scene.b.weights],
             *[b.grad for b in diff_scene.b.biases], diff_scene.b.beta.grad]
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads), "non-finite or missing gradients")
    check(all(float(w.grad.abs().max()) > 0 for w in diff_scene.b.weights) and
          float(diff_scene.a.normal.grad.abs().max()) > 0, "a weight tensor or the plane got no gradient")
    log("neural_main_path", distill_seconds=distill_s, distill_loss_first=losses[0], distill_loss_last=losses[-1],
        field_err=field_err, frames=list(frames.shape), launches=counts[0], render_launches=counts[1],
        render_batch_seconds=batch_s, blob_centre_px=[row, col], blob_centre_rgb=centre.tolist(),
        parity_1080p={n: {k: st[k] for k in ("over_atol", "max_abs_err")} for n, st in parity.items()},
        rgb_over_1e4_1080p=fine["over_atol"], diff_launches=diff_counts[0],
        grad_abs_max={"plane_normal": float(grads[0].abs().max()),
                      "weights": [float(w.grad.abs().max()) for w in diff_scene.b.weights]})

    # ---- 16. times (plain, kernel, kernel, plain) ----
    def timed(sc, c, frames_k, frames_p, warmup, headline=False):
        """K6 twice by CUDA events; its plain version on each side of them
        for the kernels line's cell (``headline``), else once after them
        without a warm-up (the plain version builds nothing; one frame of
        it at hidden 256 and 1080p takes about 4 s)."""
        prm, uni = inputs(sc, tt.Camera.reference(device=dev), c)
        kern = lambda: render_neural_launch(sc, prm, uni, c, nc)  # noqa: E731
        plain = lambda: render_neural_forward_plain(sc, prm, uni, c)  # noqa: E731
        p_runs = [time_ms(plain, warmup, frames_p)] if headline else []
        k1, k2 = time_ms(kern, warmup, frames_k), time_ms(kern, warmup, frames_k)
        p_runs.append(time_ms(plain, warmup if headline else 0, frames_p))
        return {"ms": (k1 + k2) / 2, "ms_runs": [k1, k2], "plain_ms": sum(p_runs) / len(p_runs),
                "plain_ms_runs": p_runs, "frames": frames_k, "plain_frames": frames_p, "warmup": warmup}

    runs = {}
    runs[f"hidden64_{W}x{H}"] = timed(u64, config(W, H), 10, 1, 1, headline=True)
    runs[f"hidden64_{W}x{H}_100_100"] = timed(u64, config(W, H, 100, 100), 5, 1, 1)
    # The banded reference path (render_banded, one frame): the engine the
    # JAX package serves neural scenes with on the TPU.
    for hidden, sc in ((64, u64),):
        cam, c = tt.Camera.reference(device=dev), config(W, H)
        runs[f"hidden{hidden}_{W}x{H}"]["banded_ms"] = time_ms(
            lambda: tt.render_banded(sc, cam, light, mat, c), 0, 1)
    # K6's bound on the timed cell (hidden 64, 1080p, 64/32 steps), the
    # largest of four pipes on this run's data (the marches' steps and six
    # normal taps an evaluated point each):
    # - the tensor cores: the H x H layers' split products, three TF32 passes
    #   of 2 * hp^2 operations a point (hp: H padded to the mma shape);
    # - the FP32 cores: the first layer and the output layer (two operations
    #   a multiply-add), the biases, a softplus per hidden unit (about six
    #   operations), the plane, the marches' loop arithmetic;
    # - the special-function units: exp and log1p per softplus, the shadow
    #   step's division and square root;
    # - the bytes: the six planes written, the parameters read.
    # The count with the whole MLP on the FP32 cores is logged beside it.
    cam0, c = tt.Camera.reference(device=dev), config(W, H)
    prm, uni = inputs(u64, cam0, c)
    work = march_counts(torch, u64, cam0, c, prm, uni, render_neural_forward_plain)
    mlp = u64.b
    hidden_units = sum(w.shape[1] for w in mlp.weights[:-1])  # weights (in, out)
    square = [w for w in mlp.weights[1:-1]]  # the H x H layers
    per_eval = (sum(2 * w.numel() + w.shape[1] for w in mlp.weights) + 6 * hidden_units + 8, 2 * hidden_units)
    evals = work["primary"] + work["shadow"] + 6 * work["pixels"]
    fp = evals * per_eval[0] + work["shadow"] * NEURAL_SHADOW_STEP[0] + work["primary"] * PRIMARY_STEP[0]
    sfu = evals * per_eval[1] + work["shadow"] * NEURAL_SHADOW_STEP[1]
    nbytes = 24 * W * H + 4 * prm.numel()
    fp32_only = bound(fp, sfu, nbytes)
    hp = [-(-w.shape[0] // 8) * 8 for w in square]
    pipes = {"tensor_ms": evals * sum(6 * n * n for n in hp) / TC_TF32_PEAK * 1e3,
             "fp32_ms": (fp - evals * sum(2 * w.numel() for w in square)) / FP32_PEAK * 1e3,
             "sfu_ms": sfu / SFU_PEAK * 1e3, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    k6 = (max(pipes.values()), "bytes" if pipes["bytes_ms"] >= max(pipes.values()) else "operations")
    log("neural_times", card=card, counts=work, evaluations=evals, ops_per_eval_fp32_only=per_eval, pipes=pipes,
        bound=k6, bound_fp32_only=fp32_only, **runs)
    return {"name": "neural_fwd", "route": "cuda", "source": "sdf3d_tpu_torch/ops/csrc/neural_kernel.cu",
            "replaces": "sdf3d_tpu/ops/neural_kernel.py:104", "launches": counts[0],
            "max_abs_err": parity["rgb"]["max_abs_err"], "ms": runs[f"hidden64_{W}x{H}"]["ms"],
            "plain_ms": runs[f"hidden64_{W}x{H}"]["plain_ms"], "bound_ms": k6[0], "bound_by": k6[1],
            "library_ms": None}


TWO_RANKS = r"""
import json, os, sys, time
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import dataclasses
import torch
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel_tiles
from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward
from sdf3d_tpu_torch.parallel import launch, make_mesh
import torch.distributed as dist

launch.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)  # two ranks, one card: gloo
mesh = make_mesh()
dev = mesh.device
W, H = 1920, 1080
cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
target = render_kernel_forward(tt.reference_scene().to(dev), cam, light, mat, cfg, device=dev)[0]

def scene0():
    return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

trainable = (False, False, True, True)
fit_step_kernel_tiles.launches = 0
res = fit_scene(target, scene0(), cam, light, mat, cfg,
                FitConfig(steps=20, learning_rate=1e-2, log_every=1, shard_layout="tiles", checkpoint_every=10,
                          checkpoint_dir=os.path.join(outdir, f"ckpt_r{rank}")), mesh=mesh, trainable=trainable)
launches = fit_step_kernel_tiles.launches
timed = fit_scene(target, scene0(), cam, light, mat, cfg,
                  FitConfig(steps=50, log_every=50, shard_layout="tiles"), mesh=mesh, trainable=trainable)
out = {"rank": mesh.rank, "size": mesh.size, "backend": dist.get_backend(), "device": str(dev),
       "losses": res.losses, "radius": res.scene.b.radius.item(), "launches": launches,
       "ms_per_step": W * H / timed.rays_per_second * 1e3}
with open(os.path.join(outdir, f"out_r{rank}.json"), "w") as f:
    json.dump(out, f)
launch.shutdown()
"""


def tiles_phases(torch, tt, card: str, dev, times: dict) -> list:
    """Phases 17-21: the sharded path on the tile-queue kernels (K2, K4).
    Returns their entries of the kernels line."""
    import numpy as np
    import torch.distributed as dist

    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import (
        fit_step_kernel,
        fit_step_kernel_launch,
        fit_step_kernel_tiles,
        fit_step_kernel_tiles_launch,
        fit_step_kernel_tiles_plain,
    )
    from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward, render_kernel_backward_plain
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_forward_plain,
        render_kernel_launch,
        render_kernel_tiles_forward,
        render_kernel_tiles_forward_plain,
        render_kernel_tiles_launch,
        tile_pixel_planes,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.parallel import launch, make_mesh, render_sharded_kernel
    from sdf3d_tpu_torch.parallel.tile_queue import estimate_tile_work, gather_target_tiles, plan_tiles, pool_work_to_tiles
    from sdf3d_tpu_torch.utils.parity import check_grads, check_planes, conditioned, gradient_mass

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    cam = tt.Camera.reference(device=dev)
    orbit = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)
    frozen = (0, 1, 2, 3)
    trainable = (False, False, True, True)
    kc = KernelConfig()  # the (24, 640) tile: 135 tiles at 1080p
    small = {"256x192": (dataclasses.replace(full, width=256, height=192), KernelConfig(tile_h=8, tile_w=128)),
             "248x184": (dataclasses.replace(full, width=248, height=184),
                         KernelConfig(block_w=8, block_h=8, tile_h=8, tile_w=8))}
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    counters = (render_kernel_forward, fit_step_kernel, render_kernel_backward, render_kernel_tiles_forward,
                fit_step_kernel_tiles)

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters}

    def scene0():
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

    def inputs(sc, c, camera=cam):
        uni = pack_uniforms(camera, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def reassemble(stacks, plan):
        index = torch.from_numpy(plan.gather_index.astype(np.int64)).to(dev)
        out = []
        for k in range(4):
            x = torch.cat([st[k] for st in stacks], dim=-2)
            lead = tuple(x.shape[:-2])
            x = x.reshape(lead + (plan.n * plan.tiles_per_device, plan.tile_h, plan.tile_w))
            out.append(x[..., index, :, :].transpose(-3, -2).reshape(lead + (plan.height, plan.width)))
        return out

    ref_scene = tt.reference_scene().to(dev)

    # ---- 17. build: the libraries of phases 18-21, together ----
    libs = _build.LIBRARIES
    builds0, seconds0 = libs.builds, libs.build_seconds
    t0 = time.perf_counter()
    libs.load_many(tiles_jobs(tt, dev))
    build_wall = time.perf_counter() - t0
    header = cuda_scene_source(scene0(), full, kc, False, frozen)
    ptxas = ptxas_summary(libs.log(libs.key(header)))
    # K2 and K4 are entry points of K1's and K3's kernel functions.
    check({"render_fwd", "fit_step"} <= set(ptxas), f"ptxas reported {sorted(ptxas)}")
    log("tiles_build", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        build_wall_seconds=build_wall, libraries=libs.loaded, ptxas=ptxas)
    # Phase 20's two ranks (the libraries they load built above) start here
    # and run while phases 18-20 run in this process.
    two_started = start_ranks(TWO_RANKS, 2)

    # ---- 18. K2 vs its plain version, 4-rank plans, reassembled vs K1 ----
    plans, k2_errs = {}, []
    for name, (c, k) in small.items():
        prm, uni = inputs(ref_scene, c, orbit)
        work = pool_work_to_tiles(estimate_tile_work(ref_scene, orbit, c, light), c.height, c.width, k.tile_h, k.tile_w)
        whole = render_kernel_launch(ref_scene, prm, uni, c, k)
        for policy in ("round_robin", "balanced"):
            plan = plan_tiles(c.height, c.width, k.tile_h, k.tile_w, 4, policy, work)
            plans[(name, policy)] = plan
            stacks, ranks = [], []
            for r in range(4):
                trow, tcol = plan.tables(r, dev)
                got = render_kernel_tiles_launch(ref_scene, prm, uni, trow, tcol, c, k)
                want = render_kernel_tiles_forward_plain(ref_scene, prm, uni, trow, tcol, c, k)
                torch.cuda.synchronize()
                st = check_planes(got, want, c.march.max_distance, f"K2 {name} {policy} rank {r}")
                ranks.append({n: {q: v[q] for q in ("over_atol", "max_abs_err")} for n, v in st.items()})
                k2_errs.append(st["rgb"]["max_abs_err"])
                stacks.append(got)
            image = reassemble(stacks, plan)
            st = check_planes(image, whole, c.march.max_distance, f"K2 {name} {policy} reassembled")
            differ = torch.zeros((c.height, c.width), dtype=torch.bool, device=dev)
            for a, b in zip(image, whole):
                differ |= (a != b).reshape(-1, c.height, c.width).any(0)
            differ = int(differ.sum())
            log("tiles_fwd_parity", case=name, policy=policy, tiles_per_rank=plan.tiles_per_device,
                dummies=int((plan.rows == c.height).sum()), ranks=ranks, pixels_differing_bits_vs_k1=differ,
                vs_k1={n: {q: v[q] for q in ("over_atol", "max_abs_err")} for n, v in st.items()})

    # ---- 19. K4 vs plain on the same plans; the sum vs K3 ----
    for name, (c, k) in small.items():
        sc = scene0()
        prm, uni = inputs(sc, c, orbit)
        wrt, fr = (False, frozen) if name == "256x192" else (True, ())
        rgb, t, sh, ao = render_kernel_launch(sc, prm, uni, c, k)
        keep = conditioned(sc, prm, uni, t, c)
        target = (rgb + (torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1) * keep).contiguous()
        mass = gradient_mass(sc, prm, uni, 2.0 * (rgb - target), t, sh, ao, c)
        w_loss, w_prm, w_uni = fit_step_kernel_launch(sc, prm, uni, target, c, k, wrt, fr)
        for policy in ("round_robin", "balanced"):
            plan = plans[(name, policy)]
            stacks = gather_target_tiles(target, plan)
            total, ranks = None, []
            for r in range(4):
                trow, tcol = plan.tables(r, dev)
                stack = stacks[r].contiguous()
                got = fit_step_kernel_tiles_launch(sc, prm, uni, stack, trow, tcol, c, k, wrt, fr)
                want = fit_step_kernel_tiles_plain(sc, prm, uni, stack, trow, tcol, c, k, wrt, fr)
                pixels = tile_pixel_planes(trow, tcol, k.tile_h, k.tile_w)
                k_rgb, k_t, k_sh, k_ao = render_kernel_tiles_launch(sc, prm, uni, trow, tcol, c, k)
                inside = ((pixels[0] < c.height) & (pixels[1] < c.width)).to(torch.float32)
                s_prm, s_uni = render_kernel_backward_plain(sc, prm, uni, 2.0 * (k_rgb - stack) * inside, k_t, k_sh,
                                                            k_ao, c, pixels)
                s_prm[list(fr)] = 0.0
                torch.cuda.synchronize()
                loss_rel = abs(float(got[0]) / float(want[0]) - 1.0)
                check(loss_rel <= 1e-5, f"K4 {name} {policy} rank {r}: loss off by {loss_rel:.3g}")
                g = torch.cat(got[1:])
                same = torch.cat([s_prm, s_uni if wrt else torch.zeros_like(s_uni)])
                ranks.append({"loss_rel_err": loss_rel,
                              "same_planes": check_grads(g, same, mass, rtol=1e-4, mass_tol=1e-5,
                                                         label=f"K4 {name} {policy} rank {r} (same planes)"),
                              "own_march": check_grads(g, torch.cat(want[1:]), mass, rtol=1e-4, mass_tol=1e-3,
                                                       label=f"K4 {name} {policy} rank {r}")})
                check(all(float(got[1][q]) == 0.0 for q in fr), "a frozen slot's gradient is not 0")
                total = got if total is None else tuple(a + b for a, b in zip(total, got))
            loss_rel = abs(float(total[0]) / float(w_loss) - 1.0)
            check(loss_rel <= 1e-5, f"K4 {name} {policy}: the plan's loss is off K3's by {loss_rel:.3g}")
            vs_k3 = check_grads(torch.cat(total[1:]), torch.cat([w_prm, w_uni]), mass, rtol=1e-4, mass_tol=1e-4,
                                label=f"K4 {name} {policy} sum vs K3")
            log("tiles_fit_parity", case=name, policy=policy, wrt_uniforms=wrt, frozen=list(fr), ranks=ranks,
                sum_vs_k3={"loss_rel_err": loss_rel, **vs_k3})
        dummy = (torch.full((3,), c.height, dtype=torch.int32, device=dev), torch.zeros(3, dtype=torch.int32, device=dev))
        ones = torch.ones((3, 3 * k.tile_h, k.tile_w), device=dev)
        d_loss, d_prm, d_uni = fit_step_kernel_tiles_launch(sc, prm, uni, ones, *dummy, c, k, True, ())
        check(float(d_loss) == 0.0 and not bool(d_prm.any()) and not bool(d_uni.any()), "dummy tiles added non-zeros")

    # ---- 20. main path at 1080p: fit_scene(mesh) at world size 1 (NCCL) ----
    target = render_kernel_forward(ref_scene, cam, light, mat, full, device=dev)[0]
    launch.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and mesh.size == 1 and mesh.device == dev, f"mesh {mesh}")
    common = dict(steps=20, learning_rate=1e-2, log_every=1)
    ref = fit_scene(target, scene0(), cam, light, mat, full, FitConfig(**common), trainable=trainable, device=dev)
    runs, main_counts = {}, {}
    with PlainCalls() as plain:
        for name, extra, want in (("tiles", dict(shard_layout="tiles"), (0, 20)),
                                  ("tiles_balanced", dict(shard_layout="tiles", shard_policy="balanced",
                                                          replan_every=5), (0, 20)),
                                  ("interleaved", dict(shard_layout="interleaved"), (20, 0))):
            reset()
            t0 = time.perf_counter()
            res = fit_scene(target, scene0(), cam, light, mat, full, FitConfig(**common, **extra), mesh=mesh,
                            trainable=trainable)
            seconds = time.perf_counter() - t0
            got = launches()
            check((got["fit_step_kernel"], got["fit_step_kernel_tiles"]) == want and
                  got["render_kernel_forward"] == got["render_kernel_backward"] == got["render_kernel_tiles_forward"] == 0,
                  f"fit_scene(mesh, {name}) launched {got}")
            rel = max(abs(a / b - 1.0) for a, b in zip(res.losses, ref.losses))
            check(rel <= 1e-5, f"fit_scene(mesh, {name}): losses off the unsharded fit's by {rel:.3g}")
            check(res.losses[-1] < res.losses[0], f"{name}: the loss did not fall")
            runs[name] = {"launches": got, "loss_rel_err": rel, "losses": res.losses,
                          "radius": res.scene.b.radius.item(), "seconds": seconds}
            main_counts[name] = got
        reset()
        img = render_sharded_kernel(ref_scene, cam, light, mat, full, mesh, kc, layout="tiles", planar=True)
        torch.cuda.synchronize()
        render_counts = launches()
    check(sum(plain.calls.values()) == 0, f"the main path called plain versions: {plain.calls}")
    check(render_counts["render_kernel_tiles_forward"] == 1 and sum(render_counts.values()) == 1,
          f"render_sharded_kernel(tiles) launched {render_counts}")
    prm, uni = inputs(ref_scene, full)
    render_st = check_planes((img,), render_kernel_launch(ref_scene, prm, uni, full, kc)[:1], full.march.max_distance,
                             "render_sharded_kernel(tiles) vs K1")

    # Two ranks on the one card over gloo, in the tiles layout.
    writers = []
    ranks = finish_ranks(two_started, inspect=lambda outdir: writers.extend([
        os.path.exists(os.path.join(outdir, "ckpt_r0", "state.pt")), os.path.exists(os.path.join(outdir, "ckpt_r1"))]))
    one_writer = tuple(writers)
    check(one_writer == (True, False), f"checkpoint writers (rank 0, rank 1) = {one_writer}")
    check(all(r["backend"] == "gloo" and r["size"] == 2 and r["launches"] == 20 for r in ranks), f"ranks {ranks}")
    check(ranks[0]["losses"] == ranks[1]["losses"], "the two ranks' losses differ")
    two_rel = max(abs(a / b - 1.0) for a, b in zip(ranks[0]["losses"], runs["tiles"]["losses"]))
    check(two_rel <= 1e-5, f"two ranks: losses off world size 1's by {two_rel:.3g}")
    log("tiles_main_path", card=card, world_size_1=runs, unsharded_losses=ref.losses,
        unsharded_radius=ref.scene.b.radius.item(), render_tiles_launches=render_counts,
        render_vs_k1={q: render_st["rgb"][q] for q in ("over_atol", "max_abs_err")},
        two_ranks_one_card={"loss_rel_err_vs_world_size_1": two_rel, "losses": ranks[0]["losses"],
                            "launches_per_rank": [r["launches"] for r in ranks], "backend": ranks[0]["backend"],
                            "checkpoint_writers": one_writer})

    # ---- 21. times at 1080p (plain, kernel, kernel, plain) ----
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1)
    trow, tcol = plan.tables(0, dev)
    prm, uni = inputs(ref_scene, full)
    k2 = lambda: render_kernel_tiles_launch(ref_scene, prm, uni, trow, tcol, full, kc)  # noqa: E731
    k2_plain = lambda: render_kernel_tiles_forward_plain(ref_scene, prm, uni, trow, tcol, full, kc)  # noqa: E731
    k1 = lambda: render_kernel_launch(ref_scene, prm, uni, full, kc)  # noqa: E731
    k2_st = check_planes(k2(), k2_plain(), full.march.max_distance, "K2 1080p")
    sc = scene0()
    f_prm, f_uni = inputs(sc, full)
    stack = gather_target_tiles(target.permute(2, 0, 1).contiguous(), plan)[0].contiguous()
    tgt = target.permute(2, 0, 1).contiguous()
    k4 = lambda: fit_step_kernel_tiles_launch(sc, f_prm, f_uni, stack, trow, tcol, full, kc, False, frozen)  # noqa: E731
    k4_plain = lambda: fit_step_kernel_tiles_plain(sc, f_prm, f_uni, stack, trow, tcol, full, kc, False, frozen)  # noqa: E731
    k3 = lambda: fit_step_kernel_launch(sc, f_prm, f_uni, tgt, full, kc, False, frozen)  # noqa: E731
    _, t3, sh3, ao3 = render_kernel_launch(sc, f_prm, f_uni, full, kc)
    f_mass = gradient_mass(sc, f_prm, f_uni, 2.0 * (render_kernel_launch(sc, f_prm, f_uni, full, kc)[0] - tgt),
                           t3, sh3, ao3, full)
    got4, want4, got3 = k4(), k4_plain(), k3()
    k4_st = {"own_march": check_grads(torch.cat(got4[1:]), torch.cat(want4[1:]), f_mass, rtol=1e-4, mass_tol=1e-3,
                                      label="K4 1080p vs plain"),
             "vs_k3": check_grads(torch.cat(got4[1:]), torch.cat(got3[1:]), f_mass, rtol=1e-4, mass_tol=1e-4,
                                  label="K4 1080p vs K3"),
             "loss_rel_err_vs_k3": abs(float(got4[0]) / float(got3[0]) - 1.0)}
    check(k4_st["loss_rel_err_vs_k3"] <= 1e-5, f"K4 1080p loss off K3's by {k4_st['loss_rel_err_vs_k3']:.3g}")
    timing = {}
    for name, kern, plain_fn, beside in (("render_tiles", k2, k2_plain, k1), ("fit_step_tiles", k4, k4_plain, k3)):
        p1 = time_ms(plain_fn, 1, 3)
        a1, b1 = time_ms(kern), time_ms(beside)
        a2, b2 = time_ms(kern), time_ms(beside)
        p2 = time_ms(plain_fn, 1, 3)
        timing[name] = {"ms": (a1 + a2) / 2, "ms_runs": [a1, a2], "whole_image_kernel_ms_runs": [b1, b2],
                        "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2]}
    fit_ms = {}
    for name, kwargs in (("unsharded", dict(device=dev)), ("mesh_tiles", dict(mesh=mesh)), ("mesh_tiles_2", dict(mesh=mesh)),
                         ("unsharded_2", dict(device=dev))):
        layout = dict(shard_layout="tiles") if "mesh" in name else {}
        res = fit_scene(target, scene0(), cam, light, mat, full, FitConfig(steps=50, log_every=50, **layout),
                        trainable=trainable, **kwargs)
        fit_ms[name] = W * H / res.rays_per_second * 1e3
    launch.shutdown()

    # Bounds: K2 does K1's work on the same pixels, K4 K3's.
    counts = march_counts(torch, ref_scene, cam, full, prm, uni, render_kernel_forward_plain)
    k2_bound = bound(*analytic_work(scene_costs(cuda_scene_source(ref_scene, full, kc)), counts, full),
                     24 * W * H + 8 * plan.tiles_per_device)
    f_counts = march_counts(torch, sc, cam, full, f_prm, f_uni, render_kernel_forward_plain)
    k4_bound = bound(*analytic_work(scene_costs(cuda_scene_source(sc, full, kc, False, frozen)), f_counts, full,
                                    primal=True, reverse=True),
                     12 * W * H + 8 * plan.tiles_per_device + 8 * (f_prm.numel() + 1))
    log("tiles_times_1080p", card=card, tiles=plan.tiles_per_device, k2_vs_plain=k2_st["rgb"], k4=k4_st,
        fit_scene_ms_per_step=fit_ms, render_fwd_ms_phase6=times["render_fwd"],
        two_ranks_one_card_ms_per_step={"note": "a correctness run of two ranks sharing one card over gloo, "
                                                "not a scaling figure",
                                        "ms": [r["ms_per_step"] for r in ranks]},
        bound_render_tiles=k2_bound, bound_fit_step_tiles=k4_bound, **timing)
    return [
        {"name": "render_tiles", "route": "cuda", "source": "sdf3d_tpu_torch/ops/csrc/render_kernel.cu",
         "replaces": "sdf3d_tpu/ops/render_kernel.py:639", "launches": render_counts["render_kernel_tiles_forward"],
         "max_abs_err": k2_st["rgb"]["max_abs_err"], "ms": timing["render_tiles"]["ms"],
         "plain_ms": timing["render_tiles"]["plain_ms"], "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
        {"name": "fit_step_tiles", "route": "cuda", "source": "sdf3d_tpu_torch/ops/csrc/fit_kernel.cu",
         "replaces": "sdf3d_tpu/ops/fit_kernel.py:398", "launches": main_counts["tiles"]["fit_step_kernel_tiles"],
         "max_abs_err": k4_st["own_march"]["max_abs_err"], "ms": timing["fit_step_tiles"]["ms"],
         "plain_ms": timing["fit_step_tiles"]["plain_ms"], "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": None},
    ]


RING_RANKS = r"""
import hashlib, json, os, sys, time
import numpy as np
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import torch
import torch.distributed as dist
from sdf3d_tpu_torch.parallel import launch, make_mesh, pallas_psum, ring_kernel
from sdf3d_tpu_torch.parallel.collectives import _rs_ag_threshold, resolve_algorithm

spec = json.load(open(os.path.join(outdir, "spec.json")))
launch.initialize(f"tcp://127.0.0.1:{port}", world_size=4, rank=rank)  # four ranks, one card: gloo
groups = {2: dist.new_group([0, 1]), 3: dist.new_group([0, 1, 2]), 4: None}
dev = torch.device("cuda", 0)

def vectors(n, size, dtype, seed):
    return np.random.default_rng(seed).standard_normal((size, n)).astype(dtype)

from sdf3d_tpu_torch.utils.profiling import cuda_event_ms as time_ms

out = {"rank": rank, "cases": [], "checks": {}}
# ---- 23: K7 and K8 against their plain versions at N = 2, 3, 4 ----
for size in (2, 3, 4):
    if rank >= size:
        continue
    mesh = make_mesh(group=groups[size])
    cases = [(n, alg) for n in spec["payloads"] for alg in ("ring", "rs_ag")] + [(_rs_ag_threshold(size) + 5, "auto")]
    for n, alg in cases:
        for dtype in ("float64", "float32"):
            xs = vectors(n, size, dtype, 17 * n + size)
            x = torch.from_numpy(xs[rank]).to(dev)
            got = pallas_psum(x, mesh, alg)
            want = pallas_psum(x, mesh, alg, interpret=True)
            g = got.cpu().numpy()
            case = {"N": size, "n": n, "algorithm": alg, "ran": resolve_algorithm(alg, n, size), "dtype": dtype,
                    "bit_equal_plain": bool(torch.equal(got, want)),
                    "max_abs_err": float((got - want).abs().max()), "digest": hashlib.sha256(g.tobytes()).hexdigest()}
            if dtype == "float64":
                ref = xs.sum(0)
                case["rel_err_vs_numpy"] = float(np.abs(g - ref).max() / np.abs(ref).max())
            out["cases"].append(case)
    # Two ids reduced back to back in one step.
    a, b = (torch.from_numpy(vectors(9, size, "float64", 5 + i)[rank]).to(dev) for i in range(2))
    ga, gb = pallas_psum(a, mesh, "ring", collective_id=2), pallas_psum(b, mesh, "ring", collective_id=3)
    out["checks"][f"two_ids_N{size}"] = (torch.equal(ga, pallas_psum(a, mesh, "ring", interpret=True)) and
                                         torch.equal(gb, pallas_psum(b, mesh, "ring", interpret=True)))
    # 50 calls in a row: both parity sets, rising epochs.
    x = torch.from_numpy(vectors(130, size, "float64", 99)[rank]).to(dev)
    wr, wg = ring_kernel.ring_allreduce_plain(x, mesh), ring_kernel.rs_ag_plain(x, mesh)
    row = [torch.equal(ring_kernel.ring_allreduce_launch(x, mesh, 7), wr) and
           torch.equal(ring_kernel.rs_ag_launch(x, mesh, 8), wg) for _ in range(50)]
    out["checks"][f"fifty_calls_N{size}"] = all(row)
# A wait that never completes: both ranks set the buffers up, rank 0 alone calls.
dist.barrier()
if rank < 2:
    mesh = make_mesh(group=groups[2])
    ring_kernel.ring_buffers(mesh, 9, "ring", torch.float64).ensure(8)
    if rank == 0:
        t0 = time.perf_counter()
        try:
            ring_kernel.ring_allreduce_launch(torch.ones(16, dtype=torch.float64, device=dev), mesh, 9, spin_s=1.0)
            out["timeout"] = None
        except RuntimeError as e:
            out["timeout"] = str(e)
        out["timeout_seconds"] = time.perf_counter() - t0
# ---- 25: times (plain, kernel, kernel, plain), ranks sharing the card ----
timing = {}
for size in (2, 4):
    dist.barrier()
    if rank >= size:
        continue
    mesh = make_mesh(group=groups[size])
    for n in (9, 70001):
        x = torch.from_numpy(vectors(n, size, "float64", 3)[rank]).to(dev)
        row = {}
        for alg, kern, plain in (("ring", ring_kernel.ring_allreduce_launch, ring_kernel.ring_allreduce_plain),
                                 ("rs_ag", ring_kernel.rs_ag_launch, ring_kernel.rs_ag_plain)):
            p1 = time_ms(lambda: plain(x, mesh))
            k1, k2 = time_ms(lambda: kern(x, mesh)), time_ms(lambda: kern(x, mesh))
            p2 = time_ms(lambda: plain(x, mesh))
            row[alg] = {"ms": (k1 + k2) / 2, "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2]}

        def gloo():
            v = x.cpu()
            dist.all_reduce(v, group=mesh.group)
            return v.to(dev)

        row["gloo_all_reduce_ms"] = time_ms(gloo)
        timing[f"N{size}_n{n}"] = row
    empty = torch.empty(0, dtype=torch.float64, device=dev)
    timing[f"N{size}_empty"] = {"ring_ms": time_ms(lambda: ring_kernel.ring_allreduce_launch(empty, mesh)),
                                "rs_ag_ms": time_ms(lambda: ring_kernel.rs_ag_launch(empty, mesh))}
dist.barrier()
out["timing"] = timing
with open(os.path.join(outdir, f"out_r{rank}.json"), "w") as f:
    json.dump(out, f)
launch.shutdown()
"""


RING_FIT = r"""
import json, os, sys, time
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import dataclasses
import torch
import torch.distributed as dist
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel_tiles
from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward
from sdf3d_tpu_torch.parallel import launch, make_mesh, ring_kernel

launch.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)  # two ranks, one card: gloo
mesh = make_mesh()
dev = mesh.device
W, H = 1920, 1080
cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
target = render_kernel_forward(tt.reference_scene().to(dev), cam, light, mat, cfg, device=dev)[0]
trainable = (False, False, True, True)

def scene0():
    return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

calls = {"all_reduce": 0, "plain": 0}

def counted(fn, key):
    def wrapper(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return wrapper

dist.all_reduce = counted(dist.all_reduce, "all_reduce")
for name in ("ring_allreduce_plain", "rs_ag_plain"):
    setattr(ring_kernel, name, counted(getattr(ring_kernel, name), "plain"))
runs = {}
for allreduce in ("psum", "pallas_ring", "pallas_rs_ag"):
    # A 3-step warm-up first (the buffer sets' set-up, the first fit's cost),
    # then the counted and timed 20 steps.
    fit_scene(target, scene0(), cam, light, mat, cfg,
              FitConfig(steps=3, learning_rate=1e-2, log_every=1, shard_layout="tiles", allreduce=allreduce),
              mesh=mesh, trainable=trainable)
    ring_kernel.ring_allreduce.launches = ring_kernel.rs_ag_allreduce.launches = fit_step_kernel_tiles.launches = 0
    calls.update(all_reduce=0, plain=0)
    t0 = time.perf_counter()
    res = fit_scene(target, scene0(), cam, light, mat, cfg,
                    FitConfig(steps=20, learning_rate=1e-2, log_every=1, shard_layout="tiles", allreduce=allreduce),
                    mesh=mesh, trainable=trainable)
    runs[allreduce] = {"seconds": time.perf_counter() - t0, "ms_per_step": W * H / res.rays_per_second * 1e3,
                       "losses": res.losses, "radius": res.scene.b.radius.item(),
                       "launches": {"ring_allreduce": ring_kernel.ring_allreduce.launches,
                                    "rs_ag_allreduce": ring_kernel.rs_ag_allreduce.launches,
                                    "fit_step_tiles": fit_step_kernel_tiles.launches},
                       "all_reduce_calls": calls["all_reduce"], "plain_calls": calls["plain"]}
with open(os.path.join(outdir, f"out_r{rank}.json"), "w") as f:
    json.dump({"rank": mesh.rank, "size": mesh.size, "backend": dist.get_backend(), "runs": runs}, f)
launch.shutdown()
"""


def kill_running(procs) -> None:
    """Kill each process of ``procs`` that still runs."""
    for p in procs:
        if p.poll() is None:
            p.kill()


def start_ranks(script: str, world: int, spec: dict | None = None) -> tuple:
    """Start ``script`` in ``world`` processes on the card (their rendezvous
    on a free local port), each writing its output to a file; :func:`finish_ranks`
    waits for them, and any still running when this script exits is killed."""
    tmp = tempfile.TemporaryDirectory()
    outdir = tmp.name
    if spec is not None:
        with open(os.path.join(outdir, "spec.json"), "w") as f:
            json.dump(spec, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    logs = [open(os.path.join(outdir, f"log_r{r}.txt"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(port), str(r), outdir, REPO], env=env,
                              stdout=f, stderr=subprocess.STDOUT, text=True) for r, f in enumerate(logs)]
    atexit.register(kill_running, procs)
    return tmp, procs, logs


def finish_ranks(started: tuple, timeout: int = 400, inspect=None) -> list:
    """Wait for the ranks of :func:`start_ranks` (killed past ``timeout``
    seconds) and return each rank's JSON output; ``inspect(outdir)``, where
    given, is called on their directory before it is removed."""
    tmp, procs, logs = started
    with tmp as outdir:
        deadline = time.perf_counter() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.perf_counter(), 0.0))
        finally:
            kill_running(procs)
            for p in procs:
                p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            with open(os.path.join(outdir, f"log_r{r}.txt")) as f:
                out = f.read()
            check(p.returncode == 0, f"a rank failed:\n{out[-4000:]}")
        if inspect is not None:
            inspect(outdir)
        return [json.load(open(os.path.join(outdir, f"out_r{r}.json"))) for r in range(len(procs))]


def spawn_ranks(script: str, world: int, spec: dict | None = None, timeout: int = 400) -> list:
    """Run ``script`` in ``world`` processes on the card and return each
    rank's JSON output."""
    return finish_ranks(start_ranks(script, world, spec), timeout)


def one_process_pair(torch, kind: str, n: int, calls: int = 200, reps: int = 5) -> dict:
    """Both ranks of a ring of two in this process (``LocalRing``: a stream,
    a region and a host thread each, no IPC): a call costs the segments'
    launches and the host's polls, not a switch between processes.  The
    first call is held to the rank-order sum; after 20 calls of warm-up,
    returns the ms per call of ``reps`` runs of ``calls`` calls (host clock
    from the threads' start to the card's end) and their median."""
    from sdf3d_tpu_torch.parallel import ring_kernel

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    xs = [torch.randn(n, generator=gen, dtype=torch.float64, device=dev) for _ in range(2)]
    ring = ring_kernel.LocalRing(kind, 2, n, torch.float64, dev)
    try:
        outs = ring.run(xs)
        torch.cuda.synchronize()
        check(all(torch.equal(o, xs[0] + xs[1]) for o in outs), f"one-process {kind}: not the rank-order sum")
        ring.run(xs, 20)
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ring.run(xs, calls)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / calls * 1e3)
    finally:
        ring.close()
    return {"ms": statistics.median(runs), "ms_runs": runs, "calls": calls}


def ring_phases(torch, tt, card: str):
    """Phases 22-25: the ring all-reduces K7 and K8, phase 24's two ranks
    last.  Returns ``finish``, which waits for those ranks and returns K7's
    and K8's entries of the kernels line."""
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.scene_program import count_params
    from sdf3d_tpu_torch.parallel import ring_kernel

    # ---- 22. build (in this process, before the ranks start) ----
    libs = _build.LIBRARIES
    builds0, seconds0 = libs.builds, libs.build_seconds
    t0 = time.perf_counter()
    ring_kernel.collectives_library()
    build_wall = time.perf_counter() - t0
    ptxas = [ln.split(":", 1)[-1].strip() for ln in libs.log(libs.key("", "collectives")).splitlines()
             if re.search(r"Compiling entry function|Used \d+ registers|spill stores", ln)]
    check(any("registers" in ln for ln in ptxas) and any("sdf3d_segment_kernel" in ln for ln in ptxas),
          f"no ptxas report of the segment kernels: {ptxas}")
    log("ring_build", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        build_wall_seconds=build_wall, ptxas=ptxas)

    # ---- 23. K7 and K8 against their plain versions (4 processes) ----
    neural = count_params(tt.sdf.neural_sdf(0, hidden=64, depth=3))
    t0 = time.perf_counter()
    ranks = spawn_ranks(RING_RANKS, 4, {"payloads": [1, 9, 130, neural, 70001]})
    four_s = time.perf_counter() - t0
    by_case = {}
    for r in ranks:
        for c in r["cases"]:
            by_case.setdefault((c["N"], c["n"], c["algorithm"], c["dtype"]), []).append(c)
    for key, cases in by_case.items():
        check(len(cases) == key[0], f"{key}: {len(cases)} ranks reported")
        check(all(c["bit_equal_plain"] for c in cases), f"{key}: a kernel differs from its plain version")
        check(len({c["digest"] for c in cases}) == 1, f"{key}: the ranks hold different bits")
        check(all(c.get("rel_err_vs_numpy", 0.0) <= 1e-12 for c in cases), f"{key}: off the numpy sum")
        check(key[2] != "auto" or cases[0]["ran"] == "rs_ag", f"{key}: auto ran {cases[0]['ran']}")
    checks = {k: [r["checks"][k] for r in ranks if k in r["checks"]] for k in ranks[0]["checks"]}
    check(all(all(v) for v in checks.values()), f"two ids / fifty calls: {checks}")
    timeout = ranks[0]["timeout"] or ""
    check("rank 0 of 2" in timeout and "step 0" in timeout and "stream" in timeout
          and ranks[0]["timeout_seconds"] < 5.0, f"the wait without a peer gave {timeout!r}")
    max_err = max(c["max_abs_err"] for r in ranks for c in r["cases"])
    rel = max(c["rel_err_vs_numpy"] for r in ranks for c in r["cases"] if "rel_err_vs_numpy" in c)
    log("ring_parity", cases=len(by_case), payloads=[1, 9, 130, neural, 70001], max_abs_err_vs_plain=max_err,
        float64_rel_err_vs_numpy=rel, checks=checks, timeout_message=timeout,
        timeout_seconds=ranks[0]["timeout_seconds"], four_process_seconds=four_s)

    # ---- 25. times, ranks sharing one card ----
    timing = [r["timing"] for r in ranks]
    # The bound: every rank reads its vector once and writes its sum once,
    # all through the one card's memory.
    bounds = {f"N{n}_n{k}": bound(0, 0, 2 * n * k * 8) for n in (2, 4) for k in (9, 70001)}
    one_process = {f"{kind}_n{k}": one_process_pair(torch, kind, k) for kind in ("ring", "rs_ag") for k in (9, 70001)}
    vs_gloo = {case: {alg: {"ms": row[alg]["ms"], "gloo_ms": row["gloo_all_reduce_ms"],
                            "ratio": row[alg]["ms"] / row["gloo_all_reduce_ms"]} for alg in ("ring", "rs_ag")}
               for case, row in timing[0].items() if "gloo_all_reduce_ms" in row}
    log("ring_times", card=card, note="two or four processes sharing one card over CUDA IPC and shared host flags, "
        "not scaling figures; float64", vs_gloo_rank0=vs_gloo, rank0=timing[0], ranks=timing, bounds=bounds,
        one_process_two_threads_n2=one_process)
    main = timing[0]["N2_n9"]
    check(all(main[alg]["ms"] < main["gloo_all_reduce_ms"] for alg in ("ring", "rs_ag")),
          f"two processes, N = 2, 9 values: a ring kernel is not faster than gloo's dist.all_reduce: {vs_gloo}")

    # ---- 24. main path: fit_scene(mesh) with two ranks on the card, 1080p.
    # The ranks start here, after this process's times; the caller runs
    # phases that time nothing meanwhile, then ``finish()`` waits for them,
    # checks them and returns K7's and K8's entries of the kernels line.
    t0 = time.perf_counter()
    started = start_ranks(RING_FIT, 2)

    def finish() -> list:
        pair = finish_ranks(started)
        pair_s = time.perf_counter() - t0
        want = {"psum": {"ring_allreduce": 0, "rs_ag_allreduce": 0, "fit_step_tiles": 20},
                "pallas_ring": {"ring_allreduce": 20, "rs_ag_allreduce": 0, "fit_step_tiles": 20},
                "pallas_rs_ag": {"ring_allreduce": 0, "rs_ag_allreduce": 20, "fit_step_tiles": 20}}
        for r in pair:
            check(r["backend"] == "gloo" and r["size"] == 2, f"rank {r['rank']}: {r['backend']}, size {r['size']}")
            for name, run in r["runs"].items():
                check(run["launches"] == want[name], f"rank {r['rank']} {name}: launches {run['launches']}")
                check(run["all_reduce_calls"] == (20 if name == "psum" else 0),
                      f"rank {r['rank']} {name}: {run['all_reduce_calls']} dist.all_reduce calls")
                check(run["plain_calls"] == 0, f"rank {r['rank']} {name}: the plain versions ran")
                check(run["losses"][-1] < run["losses"][0], f"{name}: the loss did not fall")
        diffs = {}
        for name in ("pallas_ring", "pallas_rs_ag"):
            a, b = (r["runs"][name]["losses"] for r in pair)
            check(a == b, f"{name}: the two ranks' losses differ")
            psum = pair[0]["runs"]["psum"]["losses"]
            diffs[name] = max(abs(x / y - 1.0) for x, y in zip(a, psum))
            check(diffs[name] <= 1e-5, f"{name}: losses off the psum run's by {diffs[name]:.3g}")
        abs_diffs = {name: max(abs(x - y) for x, y in zip(pair[0]["runs"][name]["losses"],
                                                          pair[0]["runs"]["psum"]["losses"]))
                     for name in ("pallas_ring", "pallas_rs_ag")}
        ms_step = {n: [r["runs"][n]["ms_per_step"] for r in pair] for n in want}
        log("ring_main_path", card=card, launches_per_rank={n: [r["runs"][n]["launches"] for r in pair] for n in want},
            all_reduce_calls={n: [r["runs"][n]["all_reduce_calls"] for r in pair] for n in want},
            max_rel_loss_diff_vs_psum=diffs, max_abs_loss_diff_vs_psum=abs_diffs,
            ms_per_step=ms_step, ms_per_step_vs_psum={n: [a / b for a, b in zip(ms_step[n], ms_step["psum"])]
                                                      for n in want},
            losses={n: pair[0]["runs"][n]["losses"] for n in want},
            radius={n: pair[0]["runs"][n]["radius"] for n in want},
            fit_seconds={n: [r["runs"][n]["seconds"] for r in pair] for n in want}, pair_seconds=pair_s)

        return [
            {"name": name, "route": "cuda", "source": "sdf3d_tpu_torch/ops/csrc/collectives.cu",
             "replaces": f"sdf3d_tpu/parallel/collectives.py:{line}",
             "launches": pair[0]["runs"][fit]["launches"][name], "max_abs_err": max_err, "ms": main[alg]["ms"],
             "plain_ms": main[alg]["plain_ms"], "bound_ms": bounds["N2_n9"][0], "bound_by": bounds["N2_n9"][1],
             "library_ms": main["gloo_all_reduce_ms"]}
            for name, alg, fit, line in (("ring_allreduce", "ring", "pallas_ring", 93),
                                         ("rs_ag_allreduce", "rs_ag", "pallas_rs_ag", 215))]

    return finish


def sass_listing(path: str) -> dict:
    """The SASS of each kernel function of a built library, from the
    toolkit's ``cuobjdump -sass`` (:func:`parse_sass`)."""
    from sdf3d_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return parse_sass(subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=120,
                                     check=True).stdout)


def parse_sass(out: str) -> dict:
    """``cuobjdump -sass`` text by kernel function: ``[(address, opcode with
    its modifiers, branch or call target address or None), ...]`` in address
    order, NOPs left out."""
    funcs, labels, name, pending = {}, {}, None, []
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name, pending = m.group(1), []
            funcs[name], labels[name] = [], {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)(.*)", ln)
        if not (name and m):
            continue
        addr = int(m.group(1), 16)
        for label in pending:
            labels[name][label] = addr
        pending = []
        if m.group(2) == "NOP":
            continue
        target = (re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", m.group(3)) if m.group(2).startswith(("BRA", "CALL"))
                  else None)
        funcs[name].append((addr, m.group(2), target.group(1) if target else None))
    return {f: [(a, op, None if t is None else int(t, 16) if t.startswith("0x") else labels[f].get(t))
                for a, op, t in ins] for f, ins in funcs.items()}


def sass_opcodes(path: str) -> dict:
    """SASS instructions per kernel function of a built library, by opcode
    with its modifiers (NOPs left out)."""
    ops = {}
    for name, ins in sass_listing(path).items():
        ops[name] = {}
        for _, op, _ in ins:
            ops[name][op] = ops[name].get(op, 0) + 1
    return ops


def sass_loops(listing: list) -> list:
    """The loops of one kernel function's SASS (:func:`sass_listing`): each
    backward branch's span, merged by start, with its instructions, its
    exits (forward branches out of the span and ``BREAK``s), its copies of
    the step and its skip blocks (:func:`sass_blocks`).  nvcc's loop leaves
    by a forward branch from each copy of its step but the last, whose exit
    test the back branch takes (``@P0 BRA P1, start``): copies = exits + 1."""
    spans = {}
    for addr, op, target in listing:
        if op.startswith("BRA") and target is not None and target <= addr:
            spans[target] = max(spans.get(target, addr), addr)
    loops = []
    for start, end in sorted(spans.items()):
        body = [(a, op, t) for a, op, t in listing if start <= a <= end]
        exits = sum(1 for a, op, t in body
                    if (op.startswith("BRA") and t is not None and t > end) or op.startswith("BREAK"))
        loops.append({"start": hex(start), "end": hex(end), "instructions": len(body), "exits": exits,
                      "copies": exits + 1, "blocks": sass_blocks(body)})
    return loops


def sass_blocks(body: list) -> list:
    """The skip blocks of a loop's body (:func:`sass_listing` entries): the
    spans that a forward branch inside the loop jumps over and that hold a
    square root's ``MUFU.RSQ`` (every bounded union operand takes one; the
    slow-path branches of an IEEE square root or division jump over a
    ``CALL`` and a few moves, the shadow's ``valid`` select over a
    division's ``MUFU.RCP``, and the exit tests leave the loop), in address
    order: the branch's and target's addresses, the instructions between
    them, those of the blocks directly inside left out (``own``), and the
    depth (0 outermost).  A block that the compiler moved out of line ends
    the loop's span at the branch back into it, so such a layout shows no
    block."""
    end = body[-1][0] if body else -1
    spans = []
    for addr, op, target in body:
        if op.startswith("BRA") and target is not None and addr < target <= end:
            inside = [o for a, o, _ in body if addr < a < target]
            if any(o.startswith("MUFU.RSQ") for o in inside):
                spans.append((addr, target, len(inside)))

    def within(a, b, c, d):  # (a, b) strictly inside (c, d)
        return c <= a and b <= d and (a, b) != (c, d)

    blocks = []
    for lo, hi, n in spans:
        inner = [(a, b, k) for a, b, k in spans if within(a, b, lo, hi)]
        direct = [(a, b, k) for a, b, k in inner if not any(within(a, b, c, d) for c, d, _ in inner)]
        blocks.append({"start": hex(lo), "end": hex(hi), "instructions": n,
                       "own": n - sum(1 + k for _, _, k in direct),
                       "depth": sum(1 for a, b, _ in spans if within(lo, hi, a, b))})
    return blocks


#: SASS opcode classes of the split that phase 6 and ``--time-kernels`` log.
SASS_CLASSES = (
    ("MUFU", ("MUFU",)),
    ("FFMA/FMUL/FADD", ("FFMA", "FMUL", "FADD", "FFMA32I", "FMUL32I", "FADD32I")),
    ("FSETP/FSEL/FMNMX", ("FSETP", "FSEL", "FMNMX", "FSET")),
    ("FCHK", ("FCHK",)),
    ("BSSY/BSYNC", ("BSSY", "BSYNC")),
    ("branch", ("BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BREAK", "WARPSYNC", "BMOV", "YIELD",
                "NANOSLEEP")),
    ("load/store", ("LD", "LDG", "LDS", "LDC", "LDL", "ULDC", "ST", "STG", "STS", "STL", "ATOM", "ATOMG", "ATOMS",
                    "RED")),
    ("fp64", ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX")),
    ("convert", ("F2F", "F2I", "I2F", "FRND", "I2FP", "F2IP")),
)


def sass_class(op: str) -> str:
    """The class of a SASS opcode (:data:`SASS_CLASSES`); ``integer`` for
    the rest of the integer and predicate datapath (``IADD3``, ``IMAD``,
    ``ISETP``, ``LOP3``, ``SHF``, ``LEA``, ``SEL``, ``MOV``, ``PLOP3``,
    ``S2R``, the uniform ``U…`` forms), ``other`` else."""
    base = op.split(".")[0]
    for name, ops in SASS_CLASSES:
        if base in ops:
            return name
    if base.startswith(("I", "U", "LOP", "SHF", "LEA", "SEL", "MOV", "PRMT", "S2R", "CS2R", "S2UR", "P2R", "R2P",
                        "PLOP", "VOTE", "POPC", "FLO", "BMSK", "SGXT", "R2UR")):
        return "integer"
    return "other"


def march_loops(listing: list) -> tuple:
    """``(loops, march, body_end)``: :func:`sass_loops` of a K1 listing, its
    two march loops (the first two that hold a ``MUFU``: the primary
    march's square root, the shadow's divisions) and the address where its
    subroutines (the IEEE slow paths) start."""
    loops = sass_loops(listing)
    march = [lp for lp in loops if any(op.startswith("MUFU") for a, op, _ in listing
                                       if int(lp["start"], 16) <= a <= int(lp["end"], 16))][:2]
    calls = [t for _, op, t in listing if op.startswith("CALL") and t is not None]
    return loops, march, min(calls, default=listing[-1][0] + 1)


def sass_split(listing: list) -> dict:
    """K1's SASS by opcode class (:func:`sass_class`): each march loop's
    instructions outside its skip blocks, each skip block's own, and the
    rest of the function before its subroutines outside every loop (the
    body run once a pixel)."""
    loops, march, body_end = march_loops(listing)

    def split(lo, hi, holes=()):
        counts = {}
        for a, op, _ in listing:
            if lo <= a <= hi and not any(x < a < y for x, y in holes):
                counts[sass_class(op)] = counts.get(sass_class(op), 0) + 1
        return counts

    out = {}
    for name, lp in zip(("primary", "shadow"), march):
        spans = [(int(b["start"], 16), int(b["end"], 16), b["depth"]) for b in lp["blocks"]]
        out[name] = {"instructions": lp["instructions"], "copies": lp["copies"],
                     "outside_blocks": split(int(lp["start"], 16), int(lp["end"], 16),
                                             [(x, y) for x, y, dp in spans if dp == 0]),
                     "blocks": [{**b, "split": split(x + 1, y - 1, [(c, d) for c, d, e in spans
                                                                    if e == dp + 1 and x < c and d <= y])}
                                for b, (x, y, dp) in zip(lp["blocks"], spans)]}
    out["body"] = split(0, body_end - 1, [(int(lp["start"], 16) - 1, int(lp["end"], 16) + 1) for lp in loops])
    return out


def issue_floor(listing: list, counts: dict) -> dict:
    """K1's issue floor on ``counts``' data (:func:`march_counts`): the warp
    instructions it issues over the card's issue rate, one warp instruction
    a clock on each of an SM's four schedulers.  From its SASS
    (:func:`march_loops`): a march step is its loop's instructions over the
    loop's copies of the step (:func:`sass_loops`), with each skip block (a union operand that a warp can skip,
    :func:`sass_blocks`) counted at the share of the march's warp-steps in
    which some ray of the warp runs it (the plain version's count,
    ``counts["<march>_skips"]["warp_runs"]``: the loop's block k for the
    generated step's block k mod J, where the loop holds J a copy; their
    mean otherwise); the rest of the function before its subroutines (the
    slow paths of the IEEE square roots and divisions, which the rays of
    these scenes do not take) runs once a warp, other loops left out; a
    ``CALL`` of a slow path and the branch past it are not counted.  A
    march issues a step per warp-step (a warp steps while one of its rays
    does; its ray-steps over 32 where the count has no warps): an estimate
    of the least issue, not a measurement."""
    loops, march, body_end = march_loops(listing)
    check(len(march) == 2, f"expected the two march loops in K1's SASS, found {loops}")

    def issued(lo, hi):  # instructions less two for each slow-path CALL
        span = [op for a, op, _ in listing if lo <= a <= hi]
        return len(span) - 2 * sum(op.startswith("CALL") for op in span)

    per_step, marches = {}, {}
    for name, lp in zip(("primary", "shadow"), march):
        copies = lp["copies"]
        skips = counts.get(f"{name}_skips") or {}
        warp_steps = skips.get("warp_steps") or counts.get(f"{name}_warp_steps") or counts[name] / 32
        runs = [r / warp_steps for r in skips.get("warp_runs", [])] if warp_steps else []
        blocks = [(int(b["start"], 16), int(b["end"], 16), b["depth"]) for b in lp["blocks"]]
        inside = [issued(x + 1, y - 1) for x, y, _ in blocks]
        own = [n - sum(inside[j] + 1 for j, (c, d, e) in enumerate(blocks) if e == dp + 1 and x < c and d <= y)
               for n, (x, y, dp) in zip(inside, blocks)]
        J = len(runs)
        share = ([runs[k % J] for k in range(len(blocks))] if J and len(blocks) == copies * J
                 else [sum(runs) / J if J else 1.0] * len(blocks))
        outside = issued(int(lp["start"], 16), int(lp["end"], 16)) - sum(
            n for n, (_, _, dp) in zip(inside, blocks) if dp == 0)
        per_step[name] = (outside + sum(o * f for o, f in zip(own, share))) / copies
        marches[name] = {"warp_steps": warp_steps, "copies": copies, "outside_blocks": outside, "block_own": own,
                         "block_run_share": share,
                         "step_unskipped": issued(int(lp["start"], 16), int(lp["end"], 16)) / copies}
    in_loops = sum(issued(int(lp["start"], 16), int(lp["end"], 16)) for lp in loops
                   if int(lp["start"], 16) < body_end)
    rest = issued(0, body_end - 1) - in_loops
    warp_instructions = (marches["primary"]["warp_steps"] * per_step["primary"]
                         + marches["shadow"]["warp_steps"] * per_step["shadow"] + counts["pixels"] / 32 * rest)
    return {"loops": loops, "primary_step_instructions": per_step["primary"],
            "shadow_step_instructions": per_step["shadow"], "rest_instructions": rest, "marches": marches,
            "warp_instructions": warp_instructions, "counts": counts,
            "issue_floor_ms": warp_instructions / ISSUE_RATE * 1e3}


def sass_instructions(path: str) -> dict:
    """SASS instructions (NOPs left out) per kernel function of a built
    library."""
    return {name: sum(ops.values()) for name, ops in sass_opcodes(path).items()}


def fit_kernel_alone(scene, prm, uni, target, cfg, kc, variant="full", wrt_uniforms=True):
    """``(launch, partials, totals)``: the fit kernel's entry point alone (K3,
    or a K9 variant) on preallocated partial rows and totals, no wrapper
    (``ops/fit_kernel.py::fit_launcher``, the wrappers' launch)."""
    from sdf3d_tpu_torch.ops.fit_kernel import _header_variant, fit_launcher

    return fit_launcher(scene, prm, uni, target, cfg, kc, wrt_uniforms, (), _header_variant(variant))


def render_alone(torch, scene, prm, uni, cfg, kc=None):
    """K1's entry point alone (``sdf3d_render_fwd``) on preallocated planes,
    no wrapper: a launch costs the host one ctypes call, so back-to-back
    launches time the kernel where the wrapper's lookup and allocations
    (``render_kernel_launch``) would time the host.  Returns ``launch``."""
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, kernel_library

    kc = kc or KernelConfig()
    lib = kernel_library(scene, prm, uni, cfg, kc)
    H, W = cfg.height, cfg.width
    out = [torch.empty((3, H, W), device=prm.device)] + [torch.empty((H, W), device=prm.device) for _ in range(3)]
    args = [uni.data_ptr(), prm.data_ptr()] + [x.data_ptr() for x in out]
    stream = torch.cuda.current_stream(prm.device).cuda_stream

    def launch():
        check(lib.sdf3d_render_fwd(*args, H, W, stream) == 0, "sdf3d_render_fwd failed")
    return launch


def device_us(torch, fn, calls: int = 20) -> dict:
    """The device time per call of ``fn`` by kernel name, in µs
    (``torch.profiler``'s CUDA activity), and its total."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / calls for e in prof.key_averages() if e.self_device_time_total > 0}
    return {"total_us": sum(kernels.values()), "kernels_us": kernels}


def variant_phases(torch, tt, card: str, dev) -> dict:
    """Phases 26-28: K9, the fit step's benchmark variants.  Returns its
    entry of the kernels line."""
    from sdf3d_tpu_torch.benchmarks import exp_ad
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import (
        VARIANTS,
        _uniforms,
        fit_step_kernel_launch,
        fit_step_variant_launch,
        fit_step_variant_plain,
    )
    from sdf3d_tpu_torch.ops.render_bwd_kernel import shade_planes
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        kernel_library,
        pixel_planes,
        render_kernel_forward_plain,
        render_kernel_launch,
    )
    from sdf3d_tpu_torch.ops.scene_program import FIT_VARIANTS, cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.utils.parity import check_grads, conditioned, gradient_mass

    kc = KernelConfig()
    ref = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    configs = {"short": exp_ad.short_config(ref)}  # the lab's cell
    scene = tt.reference_scene().to(dev)
    cam = tt.Camera.reference(device=dev)
    orbit = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)
    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    P = scene_param_vector(scene).numel()
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)

    # ---- 26. build: every variant under the one-step config, in one load_many ----
    libs = _build.LIBRARIES
    prm = scene_param_vector(scene, dev)
    short = configs["short"]
    builds0, seconds0 = libs.builds, libs.build_seconds
    jobs, extra = variant_jobs(tt)
    t0 = time.perf_counter()
    loaded = libs.load_many(jobs + extra)[:len(jobs)]
    build_wall = time.perf_counter() - t0
    check(libs.builds - builds0 <= len(jobs) + len(extra),
          f"{libs.builds - builds0} builds for {len(jobs) + len(extra)} libraries")
    before = libs.builds
    k3_lib = kernel_library(scene, prm, _uniforms(cam, light, mat, short, dev), short, kc, True, ())
    k3_header = cuda_scene_source(scene, short, kc, True, ())
    check(cuda_scene_source(scene, short, kc, True, (), "full") == k3_header, "full's header is not K3's")
    check(libs.builds == before and loaded[FIT_VARIANTS.index("full")] is k3_lib, "full did not load K3's library")
    report, keys = {}, {f"{cname} {v}": libs.key(cuda_scene_source(scene, c, kc, True, (), v))
                        for cname, c in configs.items() for v in FIT_VARIANTS}
    # The SASS of the three variants the check below compares, counted in
    # parallel processes (``cuobjdump`` and the parse of its listing, a few
    # seconds a library); the others' ptxas report.
    counted_names = [n for n in keys if n.split()[1] in ("noscatter", "full", "primal")]
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                                mp_context=multiprocessing.get_context("spawn")) as pool:
        counted = dict(zip(counted_names, pool.map(
            sass_instructions, [str(libs.build_dir / keys[n] / _build.KINDS["render"].lib_name)
                                for n in counted_names])))
    for name, key in keys.items():
        report[name] = {"ptxas": ptxas_summary(libs.log(key))}
        if name in counted:
            report[name]["sass_fit_step"] = next(n for k, n in counted[name].items() if "fit_step" in k)
    sass_wall = time.perf_counter() - t0
    # That the variant plumbing left K1's and K3's registers alone is shown
    # by ``--time-kernels`` on the parent and the change (ptxas and digests).
    for cname in configs:
        ns, fu, pr = (report[f"{cname} {v}"]["sass_fit_step"] for v in ("noscatter", "full", "primal"))
        check(abs(ns - fu) < abs(ns - pr), f"{cname}: noscatter's {ns} instructions are nearer primal's {pr} than "
                                           f"full's {fu}: its reverse pass was deleted")
    log("variants_build", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        build_wall_seconds=build_wall, sass_wall_seconds=sass_wall, libraries=len(jobs), variants=report)

    # ---- 27. every variant against its plain version: at 1080p, the lab's
    # shape (the kernels line's max_abs_err), then 256x192 and 250x190 ----
    def grad(out):
        return torch.cat([x for x in out[1:] if x is not None])

    max_err, rows = 0.0, []
    for cname, base in configs.items():
        for w, h in ((W, H), (256, 192), (250, 190)):
            c = dataclasses.replace(base, width=w, height=h)
            uni = _uniforms(orbit, light, mat, c, dev)
            rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, c, kc)
            keep = conditioned(scene, prm, uni, t, c)
            target = (rgb + (torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1) * keep).contiguous()
            p_rgb, p_t, p_sh, p_ao = render_kernel_forward_plain(scene, prm, uni, c, kc)
            mass = gradient_mass(scene, prm, uni, 2.0 * (p_rgb - target), p_t, p_sh, p_ao, c)
            ones = torch.ones((h, w), device=dev)
            s_rgb = shade_planes(prm, uni, 2.0 * ones, ones, ones, scene, c, pixel_planes(uni, h, w, kc.tile_h))
            s_mass = gradient_mass(scene, prm, uni, 2.0 * (s_rgb - target), 2.0 * ones, ones, ones, c)
            k3 = fit_step_kernel_launch(scene, prm, uni, target, c, kc, True, ())
            got = {v: fit_step_variant_launch(v, scene, prm, uni, target, c, kc) for v in VARIANTS}
            want = {v: fit_step_variant_plain(v, scene, prm, uni, target, c, kc) for v in VARIANTS}
            # shade_only shades t = 2, off the surface, where a few pixels are
            # ill-conditioned in float32: at 1080p either float32 side lies
            # up to about 2e-5 of the mass from the float64 plain version, so
            # both are held to that at 1e-4.
            s64 = fit_step_variant_plain("shade_only", scene, prm.double(), uni.double(), target.double(), c, kc)
            s32_err = check_grads(grad(want["shade_only"]), grad(s64), s_mass, rtol=1e-4, mass_tol=1e-4,
                                  label=f"{cname} {w}x{h} shade_only float32 plain")["err_over_mass"]
            want["shade_only"] = s64
            quantized = (torch.round(target * 256.0) / 256.0).contiguous()
            empty = [(fit_step_variant_launch(v, scene, prm, uni, quantized, c, kc)[0],
                      fit_step_variant_plain(v, scene, prm, uni, quantized, c, kc)[0]) for v in ("empty", "empty_noin")]
            torch.cuda.synchronize()
            label = f"{cname} {w}x{h}"
            check(all(torch.equal(a, b) for a, b in zip(got["full"], k3)), f"{label}: full is not K3 bit for bit")
            check(all(torch.equal(a, b) for a, b in zip(got["tgt3"], got["full"])), f"{label}: tgt3 is not full")
            check(torch.equal(got["noscatter"][0], got["full"][0]), f"{label}: noscatter's loss is not full's")
            check(all(float(a) == float(b) for a, b in empty), f"{label}: empty/empty_noin {empty} not exact")
            check(float(empty[1][0]) == float(w * h), f"{label}: empty_noin {float(empty[1][0])} is not H·W")
            row = {"case": label}
            for v in VARIANTS:
                # The loss on the same primal: the plain version shades K1's
                # planes (where the two marches part, the pixels the image
                # budget allows move the loss: 2.1e-5 at 1080p under the
                # reference config).  Its own march's loss is logged.
                same = want[v] if v in ("shade_only", "empty", "empty_noin") else fit_step_variant_plain(
                    v, scene, prm, uni, target, c, kc, planes=(t, sh, ao))
                rel = abs(float(got[v][0]) / float(same[0]) - 1.0)
                check(rel <= 1e-5, f"{label} {v}: loss off its plain version's on the same planes by {rel:.3g}")
                row[v] = {"loss_rel_err": rel, "own_march_loss_rel_err": abs(float(got[v][0]) / float(want[v][0]) - 1)}
                if got[v][1] is None:
                    continue
                # shade_only shades the same fixed planes on both sides (its
                # float64 plain version, above); the others march their own
                # primal (the fit step's bar).
                m = s_mass if v == "shade_only" else mass
                st = check_grads(grad(got[v]), grad(want[v]), m[:grad(got[v]).numel()], rtol=1e-4,
                                 mass_tol=1e-4 if v == "shade_only" else 1e-3, label=f"{label} {v}")
                row[v].update(st)
                if v == "shade_only":
                    row[v]["float32_plain_err_over_mass"] = s32_err
                if (w, h) == (W, H):
                    max_err = max(max_err, st["max_abs_err"])
            # nopow against full: the same primal planes, x^12 by a chain
            # (shininess 12); the shininess gradient, 0 in nopow, left out.
            keep_slots = [k for k in range(P + 30) if k != P + 26]
            row["nopow_vs_full"] = check_grads(grad(got["nopow"])[keep_slots], grad(got["full"])[keep_slots],
                                               mass[keep_slots], rtol=1e-4, mass_tol=1e-5,
                                               label=f"{label} nopow vs full")
            row["wrt_p_bits_equal_k3_scene_grad"] = bool(torch.equal(
                got["wrt_p"][1], fit_step_kernel_launch(scene, prm, uni, target, c, kc, False, ())[1]))
            row["primal_loss_bits_equal_full"] = bool(torch.equal(got["primal"][0], got["full"][0]))
            rows.append(row)
    log("variants_parity", cases=rows, max_abs_err_1080p=max_err)

    # ---- 28. main path: the exp_ad lab at 1080p, then times ----
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_variant

    lab = {}
    env = dict(os.environ, PYTHONPATH=REPO)
    for arg in ("short",):
        fit_step_variant.launches = 0
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "sdf3d_tpu_torch.benchmarks.exp_ad", arg], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"exp_ad {arg} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        fields = dict(ln.split(None, 1) for ln in proc.stdout.splitlines() if ln.strip())
        lab[arg] = {v: float(fields[v].split()[0]) for v in ("full", "wrt_p", "nopow", "primal")}
        lab[arg]["launches"] = int(fields["launches"])
        lab[arg]["seconds"] = time.perf_counter() - t0
        check(lab[arg]["launches"] == 4 * (2 + 4 * 10) * exp_ad.FRAMES, f"exp_ad {arg}: launches {lab[arg]}")
    check(fit_step_variant.launches == 0, "the lab's launches were counted in this process")

    zero = torch.zeros((3, H, W), device=dev)
    times = {}
    for cname, c in configs.items():
        uni = _uniforms(cam, light, mat, c, dev)
        timed = ("full", "wrt_p", "nopow", "primal", "empty", "empty_noin", "noscatter", "shade_only")
        for v in timed if cname == "short" else ("full", "wrt_p", "nopow", "primal"):
            kern = fit_kernel_alone(scene, prm, uni, zero, c, kc, v)[0]
            wrap = lambda v=v, c=c, uni=uni: fit_step_variant_launch(v, scene, prm, uni, zero, c, kc)  # noqa: E731
            plain = lambda v=v, c=c, uni=uni: fit_step_variant_plain(v, scene, prm, uni, zero, c, kc)  # noqa: E731
            row = {}
            if cname == "short":
                row["plain_ms_runs"] = [time_ms(plain, 1, 3)]
            row["ms_runs"] = [time_ms(kern, 5, 50), time_ms(kern, 5, 50)]
            if cname == "short":
                row["plain_ms_runs"].append(time_ms(plain, 1, 3))
                row["plain_ms"] = sum(row["plain_ms_runs"]) / 2
            row["ms"] = sum(row["ms_runs"]) / 2
            row["wrapper_ms"] = time_ms(wrap, 5, 50)
            times[f"{cname} {v}"] = row
    # The float64 total is a second kernel of the same C call
    # (sdf3d_column_total_kernel): the wrapper's kernels on the card (the
    # profiler: the fit kernel, its total and the cast of the totals), and
    # the wrapper's time less the entry point's, what it adds to a step.
    uni = _uniforms(cam, light, mat, configs["short"], dev)
    full_partials = fit_kernel_alone(scene, prm, uni, zero, configs["short"], kc)[1]
    sums = {"rows": list(full_partials.shape),
            "wrapper_device": device_us(torch, lambda: fit_step_variant_launch("full", scene, prm, uni, zero,
                                                                               configs["short"], kc)),
            "wrapper_minus_kernel_ms": {k: times[k]["wrapper_ms"] - times[k]["ms"] for k in ("short full",)}}

    # K9's bounds at 1080p under the one-step config (the lab's cell): the
    # marches' steps of this run's data, the normal taps and, for the
    # gradient variants, the reverse pass; the target read and the float64
    # totals written.
    c = configs["short"]
    uni = _uniforms(cam, light, mat, c, dev)
    counts = march_counts(torch, scene, cam, c, prm, uni, render_kernel_forward_plain)
    costs = scene_costs(cuda_scene_source(scene, c, kc, True, ()))
    n = W * H
    fwd_ops = analytic_work(costs, counts, c)
    both = analytic_work(costs, counts, c, primal=True, reverse=True)
    n_taps = n * (6 if c.normals == "central" else 4)  # shade_only's primal: the normal taps alone
    rev = analytic_work(costs, counts, c, primal=False, reverse=True)
    bounds = {v: bound(*ops, nb) for v, ops, nb in (
        ("full", both, 12 * n + 8 * (P + 31)), ("wrt_p", both, 12 * n + 8 * (P + 31)),
        ("nopow", both, 12 * n + 8 * (P + 31)), ("noscatter", both, 12 * n + 8),
        ("primal", fwd_ops, 12 * n + 8),
        ("shade_only", (n_taps * costs["point"][0] + rev[0], n_taps * costs["point"][1] + rev[1]),
         12 * n + 8 * (P + 31)),
        ("empty", (3 * n, 0), 12 * n + 8), ("empty_noin", (n, 0), 8))}
    log("variants_times_1080p", card=card, exp_ad=lab, times=times, partial_sum=sums, counts=counts, bounds=bounds)
    short = {v: times[f"short {v}"] for v in ("full", "wrt_p", "nopow", "primal", "empty", "empty_noin", "noscatter",
                                             "shade_only")}
    return {"name": "fit_variants", "route": "cuda", "source": "sdf3d_tpu_torch/ops/csrc/fit_kernel.cu",
            "replaces": "benchmarks/exp_ad.py:53", "launches": lab["short"]["launches"], "max_abs_err": max_err,
            "ms": short["full"]["ms"], "ms_per_variant": {v: r["ms"] for v, r in short.items()},
            "plain_ms": short["full"]["plain_ms"], "plain_ms_per_variant": {v: r["plain_ms"] for v, r in short.items()},
            "bound_ms": bounds["full"][0], "bound_by": bounds["full"][1],
            "bound_ms_per_variant": {v: b[0] for v, b in bounds.items()}, "library_ms": None}


def bench_phases(torch, tt, card: str, dev) -> None:
    """Phase 29: the bench (``sdf3d_tpu_torch/bench.py``) at 1080p, its CLI,
    and the extras, each cell beside its kernel's CUDA-event time."""
    import contextlib
    import io

    from sdf3d_tpu_torch import bench, cli
    from sdf3d_tpu_torch.ops.fit_kernel import _uniforms, fit_step_kernel
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, render_kernel_forward, render_kernel_launch
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector

    kc = KernelConfig()
    cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
    scene = tt.reference_scene().to(dev)
    prm = scene_param_vector(scene, dev)

    def kernel_launch(mode, c):
        """The cell's kernel: K1, or K3's entry point alone on the zero
        target (the chunk's step adds the gradient split and the update)."""
        uni = _uniforms(cam, light, mat, c, dev)
        if mode == "fwd":
            return lambda: render_kernel_launch(scene, prm, uni, c, kc)
        zero = torch.zeros((3, c.height, c.width), device=dev)
        return fit_kernel_alone(scene, prm, uni, zero, c, kc, wrt_uniforms=False)[0]

    def kernel_ms(mode, c):
        return time_ms(kernel_launch(mode, c))

    def beside(r, ms):
        return {"kernel_ms": ms, "idle_share": 1.0 - ms / (r["seconds_per_frame"] * 1e3)}

    keys = {"metric", "value", "unit", "vs_baseline", "seconds_per_frame", "backend"}
    ref = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    cells = {}
    with PlainCalls() as plain:
        for mode, counter, other, name in (("fwd", render_kernel_forward, fit_step_kernel, "sdf3d_render_fwd"),
                                           ("fwd_bwd", fit_step_kernel, render_kernel_forward, "sdf3d_fit_step")):
            kern = kernel_launch(mode, ref)
            kernel_runs = [time_ms(kern, 20, 50) for _ in range(2)]
            # The chunk's device time per frame by kernel (the profiler): the
            # cell's kernel as it runs inside the bench, and every kernel.
            make_fn, args = bench.make_workload(mode=mode)
            chunk = make_fn(16)
            prof = device_us(torch, lambda: chunk(*args), calls=3)
            in_bench_ms = sum(us for k, us in prof["kernels_us"].items() if name in k) / 16e3
            busy_ms = prof["total_us"] / 16e3
            kernel_runs += [time_ms(kern, 20, 50) for _ in range(2)]
            # A frame cannot take less than its kernel: the slope must reach
            # the kernel's least time less the spread of its readings.  The
            # slope is an estimate (JAX's rules: a round that pairs a slowed
            # K window with a fast 4K one reads low; `run_extras`' reduced
            # protocol has read 13% below K3), so a cell below that runs
            # again, three times at most; every reading is logged.
            readings = kernel_runs + [in_bench_ms]
            floor_ms = 2 * min(readings) - max(readings)
            frames_ms = []
            while len(frames_ms) < 3 and (not frames_ms or frames_ms[-1] < floor_ms):
                counter.launches = other.launches = 0
                t0 = time.perf_counter()
                r = bench.run_benchmark(mode=mode)  # the protocol of `cli bench`
                seconds = time.perf_counter() - t0
                launches = (counter.launches, other.launches)
                check(set(r) == keys and r["metric"] == f"rays_per_second_1080p_{mode}_kernel"
                      and r["backend"] == "cuda" and math.isfinite(r["value"]) and r["value"] > 0, f"bench {mode}: {r}")
                check(launches[0] > 0 and launches[1] == 0, f"bench {mode} launched (its kernel, the other) = {launches}")
                frames_ms.append(r["seconds_per_frame"] * 1e3)
            check(frames_ms[-1] >= floor_ms, f"bench {mode}: {frames_ms} ms a frame, below its kernel's "
                                             f"{readings} less their spread")
            cells[mode] = {**r, **beside(r, sum(kernel_runs) / len(kernel_runs)), "kernel_ms_runs": kernel_runs,
                           "kernel_in_bench_ms": in_bench_ms, "device_busy_ms": busy_ms,
                           "device_idle_share": 1.0 - busy_ms / frames_ms[-1], "floor_ms": floor_ms,
                           "frame_ms_readings": frames_ms, "launches": launches[0], "seconds": seconds}
    check(sum(plain.calls.values()) == 0, f"the bench called plain versions: {plain.calls}")

    # The CLI's bench and info in this process (``cli.main``, what
    # ``python -m sdf3d_tpu_torch.cli`` runs), their standard output read.
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli.main(["bench"])
    cli_seconds = time.perf_counter() - t0
    check(rc == 0, f"cli bench returned {rc}")
    lines = out.getvalue().strip().splitlines()
    cli_bench = json.loads(lines[-1])
    check(len(lines) == 1 and set(cli_bench) == keys and cli_bench["metric"] == "rays_per_second_1080p_fwd_bwd_kernel",
          f"cli bench printed {out.getvalue()!r}")
    with contextlib.redirect_stdout(io.StringIO()) as info_out:
        rc = cli.main(["info"])
    info_text = info_out.getvalue()
    check(rc == 0 and torch.cuda.get_device_name(0) in info_text, f"cli info printed {info_text!r}")

    t0 = time.perf_counter()
    extras = bench.run_extras(budget_s=300.0)
    extras_seconds = time.perf_counter() - t0
    for name in ("fwd_4k", "fit_4k", "fit_fast_1080p", "fit_fractal_1080p", "fit_multiview_720p_v4"):
        check(isinstance(extras[name], dict) and extras[name]["rays_per_second"] > 0, f"{name}: {extras[name]}")
    uhd = dataclasses.replace(ref, width=3840, height=2160)
    for name, mode, c in (("fwd_4k", "fwd", uhd), ("fit_4k", "fwd_bwd", uhd),
                          ("fit_fast_1080p", "fwd_bwd", tt.fast_config(ref))):
        extras[name].update(beside(extras[name], kernel_ms(mode, c)))
    log("bench", card=card, cells=cells, cli_bench=cli_bench, cli_bench_seconds=cli_seconds,
        cli_info=info_text.strip().splitlines(), extras=extras, extras_seconds=extras_seconds)


class Witness:
    """The 13b scenes' hard-limit mask for ``check_planes(..., razor=)``:
    razor-edge rays or pixels rounding decides (``utils/parity.py``), built
    at the first call (``check_planes`` calls it only when a pixel passes the
    hard limit); ``counts``: each mask's pixels, once built."""

    def __init__(self, razor_edge, rounding_decided, *args):
        self.fns, self.args, self.mask, self.counts = (razor_edge, rounding_decided), args, None, {}

    def __call__(self):
        if self.mask is None:
            edge, rounding = (fn(*self.args) for fn in self.fns)
            self.counts = {"razor_edge_pixels": int(edge.sum()), "rounding_decided_pixels": int(rounding.sum())}
            self.mask = edge | rounding
        return self.mask


def k3_against_plain(torch, sc, prm, uni, c, kc, wrt, fr, label, gen, target=None, bar=None,
                     rounding: bool = False) -> dict:
    """K3 against the plain reverse pass on K1's planes (the same primal)
    and against its plain version (its own march), at the flagship's bars
    (``FLAGSHIP_SAME``, ``FLAGSHIP_OWN``).  K1's planes are
    held to the plain version's past the hard limit off razor-edge rays,
    and with ``rounding`` also off the pixels rounding decides
    (``rounding_decided``: the 13b scenes).  The target: K1's render plus
    noise from ``gen``, or the one given, on the pixels where the gradient
    is well conditioned (``conditioned``) and the two primals agree
    (``primals_agree``; the pixel budget holds the others); elsewhere each
    side's own render, so that no residual there reaches either side's
    gradient."""
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel_launch, fit_step_kernel_plain
    from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward_plain
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward_plain, render_kernel_launch
    from sdf3d_tpu_torch.utils.parity import (
        FLAGSHIP_OWN,
        FLAGSHIP_SAME,
        check_grads,
        check_planes,
        conditioned,
        gradient_mass,
        primals_agree,
        razor_edge,
        rounding_decided,
    )

    dev = prm.device

    def planes_stats(st):
        return {n: {q: v[q] for q in ("over_atol", "max_abs_err", "over_hard")} for n, v in st.items()}

    rgb, t, sh, ao = render_kernel_launch(sc, prm, uni, c)
    own = render_kernel_forward_plain(sc, prm, uni, c)
    razor = (Witness(razor_edge, rounding_decided, sc, prm, uni, c) if rounding
             else functools.partial(razor_edge, sc, prm, uni, c))  # built only if a pixel passes the hard limit
    try:
        primal = check_planes((rgb, t, sh, ao), own, c.march.max_distance, f"{label} primal", razor=razor,
                              **(bar or {}))
    except AssertionError:
        log("k3_primal_failed", label=label, worst=worst_pixels(torch, (rgb, t, sh, ao), own, razor(),
                                                                c.march.max_distance))
        raise
    keep = conditioned(sc, prm, uni, t, c) & primals_agree((rgb, t, sh, ao), own, c.march.max_distance)
    if target is None:
        target = rgb + torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1
    target, p_target = (torch.where(keep, target, x).contiguous() for x in (rgb, own[0]))
    got = fit_step_kernel_launch(sc, prm, uni, target, c, kc, wrt, fr)
    want = fit_step_kernel_plain(sc, prm, uni, p_target, c, kc, wrt, fr)
    g_p, g_u = render_kernel_backward_plain(sc, prm, uni, 2.0 * (rgb - target), t, sh, ao, c)
    g_p[list(fr)] = 0.0
    torch.cuda.synchronize()
    mass = gradient_mass(sc, prm, uni, 2.0 * (rgb - target), t, sh, ao, c)
    g = torch.cat(got[1:])
    check(bool(torch.isfinite(g).all()) and math.isfinite(float(got[0])), f"{label}: a non-finite total")
    # The loss against K1's planes (the same primal) and the plain
    # version's (its own primal; no residual where the two disagree).
    same_loss = float(((rgb - target).double() ** 2).sum())
    loss_rel = abs(float(got[0]) / same_loss - 1.0)
    check(loss_rel <= 1e-5, f"{label}: loss off K1's planes' by {loss_rel:.3g} relative")
    own_rel = abs(float(got[0]) / float(want[0]) - 1.0)
    check(own_rel <= 1e-5, f"{label}: loss off the plain version's by {own_rel:.3g} relative")
    check(all(float(got[1][q]) == 0.0 for q in fr), f"{label}: a frozen slot's gradient is not 0")
    check(wrt or float(got[2].abs().max()) == 0.0, f"{label}: uniform gradients without wrt_uniforms")
    same = torch.cat([g_p, g_u if wrt else torch.zeros_like(g_u)])
    return {"loss_rel_err": loss_rel, "own_march_loss_rel_err": own_rel,
            "primal": planes_stats(primal), "pixels_left_out": int((~keep).sum()),
            "same_planes": check_grads(g, same, mass, rtol=1e-4, mass_tol=FLAGSHIP_SAME, label=f"{label} (same)"),
            "own_march": check_grads(g, torch.cat(want[1:]), mass, rtol=1e-4, mass_tol=FLAGSHIP_OWN,
                                     label=label)}


def flagship_phases(torch, tt, card: str, dev, then=None) -> dict:
    """Phases 30-33: the flagship scene (``flagship_scene``: a sphere and a
    rounded box smooth-blended, a torus, the ground plane; 21 parameters)
    and an every-node CSG sampler on K1-K5.  Returns, per kernel entry of
    the kernels line (``render_fwd``, ``render_tiles``, ``fit_step``,
    ``fit_step_tiles``, ``render_bwd``), the flagship's launches, times,
    bound and error.  ``then``, where given, is called after phase 31's
    checks, which time nothing (the ring's two ranks, started before phase
    30, waited for)."""
    import torch.distributed as dist

    from sdf3d_tpu_torch import bench, cli
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import (
        fit_launcher,
        fit_step_kernel,
        fit_step_kernel_launch,
        fit_step_kernel_plain,
        fit_step_kernel_tiles,
        fit_step_kernel_tiles_launch,
        fit_step_kernel_tiles_plain,
    )
    from sdf3d_tpu_torch.ops.neural_kernel import render_neural_forward
    from sdf3d_tpu_torch.ops.render_bwd_kernel import (
        render_bwd_launcher,
        render_kernel_backward,
        render_kernel_backward_launch,
        render_kernel_backward_plain,
    )
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_forward_plain,
        render_kernel_launch,
        render_kernel_tiles_forward,
        render_kernel_tiles_forward_plain,
        render_kernel_tiles_launch,
        tile_pixel_planes,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.parallel import launch, make_mesh, render_sharded_kernel
    from sdf3d_tpu_torch.parallel.tile_queue import (
        estimate_tile_work,
        gather_target_tiles,
        plan_tiles,
        pool_work_to_tiles,
    )
    from sdf3d_tpu_torch.utils.parity import (
        CREASE_BAR,
        FLAGSHIP_OWN,
        FLAGSHIP_SAME,
        check_grads,
        check_planes,
        conditioned,
        csg_sampler,
        flagship_fit_start,
        gradient_mass,
        primals_agree,
        razor_edge,
    )

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    small = dataclasses.replace(full, width=256, height=192)
    ragged = dataclasses.replace(full, width=250, height=190)
    kc, kc_point = KernelConfig(), KernelConfig(ray_sdf=False)
    kc_tiles = KernelConfig(tile_h=8, tile_w=128)  # phase 18's tile at 256x192
    frozen = (0, 1, 2, 3)  # the ground plane
    ref_cam = tt.Camera.reference(device=dev)
    orbit = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)
    cams = (("reference", ref_cam), ("orbit30_15", orbit))
    flagship, sampler = tt.flagship_scene().to(dev), csg_sampler(dev)
    scenes = {"flagship": flagship, "sampler": sampler}
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    counters = (render_kernel_forward, fit_step_kernel, render_kernel_backward, render_kernel_tiles_forward,
                fit_step_kernel_tiles, render_neural_forward)

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters}

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def planes_stats(st):
        return {n: {q: v[q] for q in ("over_atol", "max_abs_err", "over_hard")} for n, v in st.items()}

    def k3_vs_plain(sc, cam, c, wrt, fr, label, target=None, bar=None):
        prm, uni = inputs(sc, cam, c)
        return k3_against_plain(torch, sc, prm, uni, c, kc, wrt, fr, label, gen, target, bar)

    # ---- 30. build: the flagship's and the sampler's libraries ----
    libs = _build.LIBRARIES
    builds0, seconds0 = libs.builds, libs.build_seconds
    jobs = flagship_jobs(tt, dev)
    t0 = time.perf_counter()
    libs.load_many(jobs)
    build_wall = time.perf_counter() - t0
    ptxas = {}
    fit_demo = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    for name, sc in (("reference", tt.reference_scene()), ("fit_demo_start", fit_demo), ("flagship", flagship),
                     ("sampler", sampler)):
        for wrt, fr in ((True, ()), (False, frozen)):
            if name == "reference" and not wrt:
                continue
            kernels = ptxas_summary(libs.log(libs.key(cuda_scene_source(sc, full, kc, wrt, fr))))
            check(name in ("reference", "fit_demo_start") or
                  set(kernels) >= {"render_fwd", "fit_step", "render_bwd", "render_bwd_params"},
                  f"{name}: ptxas reported {sorted(kernels)}")
            for v in kernels.values():
                v["blocks_per_sm"] = blocks_per_sm(v["registers"])
            ptxas[f"{name} wrt_uniforms={wrt}"] = kernels
    header = cuda_scene_source(flagship, full, kc)
    log("flagship_build", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        build_wall_seconds=build_wall, libraries=len(jobs), header_bytes=len(header),
        sampler_header_bytes=len(cuda_scene_source(sampler, full, kc)), costs=scene_costs(header), ptxas=ptxas)

    # ---- 31. K1-K5 vs their plain versions, flagship and sampler ----
    errs = {"render_fwd": [], "fit_step": [], "render_bwd": [], "render_tiles": [], "fit_step_tiles": []}
    # Each camera at one size: the reference camera at 256x192, orbit 30/15
    # at the ragged 250x190.
    cam_sizes = ((cams[0], small), (cams[1], ragged))
    for sname, sc in scenes.items():
        bar = CREASE_BAR if sname == "sampler" else {}
        for (cam_name, cam), c in cam_sizes:
            for ray_sdf in (True, False):
                prm, uni = inputs(sc, cam, c)
                k = kc if ray_sdf else kc_point
                got, want = render_kernel_launch(sc, prm, uni, c, k), render_kernel_forward_plain(sc, prm, uni, c, k)
                torch.cuda.synchronize()
                # Past the hard limit only razor-edge rays (utils/parity.py).
                st = check_planes(got, want, c.march.max_distance, f"{sname} K1 {cam_name} {c.width}x{c.height}",
                                  razor=functools.partial(razor_edge, sc, prm, uni, c, k), **bar)
                errs["render_fwd"].append(st["rgb"]["max_abs_err"])
                log("flagship_k1_parity", scene=sname, camera=cam_name, size=[c.width, c.height], ray_sdf=ray_sdf,
                    **planes_stats(st))
        # Each camera at one size, wrt_uniforms and frozen slots both ways
        # (every combination on the reference scene in phase 8).
        fit_cases = [(cams[0], small, False, frozen), (cams[1], ragged, True, ())]
        if sname == "sampler":
            fit_cases = [(cams[1], small, False, frozen)]
        for (cam_name, cam), c, wrt, fr in fit_cases:
            label = f"{sname} K3 {cam_name} {c.width}x{c.height} wrt_uniforms={wrt} frozen={list(fr)}"
            st = k3_vs_plain(flagship_fit_start(dev) if sname == "flagship" else sc, cam, c, wrt, fr, label, bar=bar)
            errs["fit_step"].append(st["own_march"]["max_abs_err"])
            log("flagship_k3_parity", scene=sname, camera=cam_name, size=[c.width, c.height], wrt_uniforms=wrt,
                frozen=list(fr), **st)
        for (cam_name, cam), c in cam_sizes:
            prm, uni = inputs(sc, cam, c)
            _, t, sh, ao = render_kernel_launch(sc, prm, uni, c)
            g_rgb = (torch.randn((3, c.height, c.width), generator=gen, device=dev)
                     * conditioned(sc, prm, uni, t, c)).contiguous()
            mass = gradient_mass(sc, prm, uni, g_rgb, t, sh, ao, c)
            for wrt in (True, False):
                label = f"{sname} K5 {cam_name} {c.width}x{c.height} wrt_uniforms={wrt}"
                got = render_kernel_backward_launch(sc, prm, uni, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
                want = render_kernel_backward_plain(sc, prm, uni, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
                torch.cuda.synchronize()
                st = check_grads(torch.cat(got) if wrt else got[0], torch.cat(want) if wrt else want[0],
                                 mass if wrt else mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME, label=label)
                errs["render_bwd"].append(st["max_abs_err"])
                log("flagship_k5_parity", scene=sname, camera=cam_name, size=[c.width, c.height], wrt_uniforms=wrt,
                    **st)
        # K2 and K4 on a 4-rank balanced plan at 256x192 (phase 18's tile),
        # on the flagship (the sampler's nodes are K1's and K3's above).
        if sname != "flagship":
            continue
        sc4 = flagship_fit_start(dev)
        prm, uni = inputs(sc4, orbit, small)
        work = pool_work_to_tiles(estimate_tile_work(sc4, orbit, small, light), small.height, small.width,
                                  kc_tiles.tile_h, kc_tiles.tile_w)
        plan = plan_tiles(small.height, small.width, kc_tiles.tile_h, kc_tiles.tile_w, 4, "balanced", work)
        rgb, t, sh, ao = render_kernel_launch(sc4, prm, uni, small)
        own = render_kernel_forward_plain(sc4, prm, uni, small)
        keep = conditioned(sc4, prm, uni, t, small) & primals_agree((rgb, t, sh, ao), own, small.march.max_distance)
        noisy = rgb + torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1
        # Each side's own render where the gradient is ill-conditioned or the
        # primals disagree (as in k3_vs_plain).
        target, p_target = (torch.where(keep, noisy, x).contiguous() for x in (rgb, own[0]))
        mass = gradient_mass(sc4, prm, uni, 2.0 * (rgb - target), t, sh, ao, small)
        stacks, total, ranks = gather_target_tiles(target, plan), None, []
        p_stacks = gather_target_tiles(p_target, plan)
        k2_stacks = []  # (K2's, the plain version's, the razor-edge rays) a rank
        for r in range(4):
            trow, tcol = plan.tables(r, dev)
            got2 = render_kernel_tiles_launch(sc4, prm, uni, trow, tcol, small, kc_tiles)
            want2 = render_kernel_tiles_forward_plain(sc4, prm, uni, trow, tcol, small, kc_tiles)
            stack = stacks[r].contiguous()
            got4 = fit_step_kernel_tiles_launch(sc4, prm, uni, stack, trow, tcol, small, kc_tiles, False, frozen)
            want4 = fit_step_kernel_tiles_plain(sc4, prm, uni, p_stacks[r].contiguous(), trow, tcol, small, kc_tiles,
                                                False, frozen)
            pixels = tile_pixel_planes(trow, tcol, kc_tiles.tile_h, kc_tiles.tile_w)
            inside = ((pixels[0] < small.height) & (pixels[1] < small.width)).to(torch.float32)
            s_prm, _ = render_kernel_backward_plain(sc4, prm, uni, 2.0 * (got2[0] - stack) * inside, *got2[1:],
                                                    small, pixels)
            s_prm[list(frozen)] = 0.0
            torch.cuda.synchronize()
            k2_stacks.append((got2, want2, functools.partial(razor_edge, sc4, prm, uni, small, kc_tiles, pixels)))
            label = f"{sname} K4 rank {r}"
            same_loss = float((((got2[0] - stack) * inside).double() ** 2).sum())
            loss_rel = abs(float(got4[0]) / same_loss - 1.0)
            check(loss_rel <= 1e-5, f"{label}: loss off K2's planes' by {loss_rel:.3g}")
            own_rel = abs(float(got4[0]) / float(want4[0]) - 1.0)
            check(own_rel <= 1e-5, f"{label}: loss off the plain version's by {own_rel:.3g}")
            st4 = {"loss_rel_err": loss_rel, "own_march_loss_rel_err": own_rel,
                   "same_planes": check_grads(got4[1], s_prm, mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME,
                                              label=f"{label} (same)"),
                   "own_march": check_grads(got4[1], want4[1], mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_OWN,
                                            label=label)}
            errs["fit_step_tiles"].append(st4["own_march"]["max_abs_err"])
            ranks.append(st4)
            total = got4 if total is None else tuple(a + b for a, b in zip(total, got4))
        # K2 over the plan's four stacks together (the whole image and its
        # dummy tiles), at the image budget.
        got2s = [torch.cat([k[0][q] for k in k2_stacks], dim=-2) for q in range(4)]
        want2s = [torch.cat([k[1][q] for k in k2_stacks], dim=-2) for q in range(4)]
        st2 = check_planes(got2s, want2s, small.march.max_distance, f"{sname} K2, 4 ranks",
                           razor=lambda: torch.cat([k[2]() for k in k2_stacks], dim=-2), **bar)
        errs["render_tiles"].append(st2["rgb"]["max_abs_err"])
        whole = fit_step_kernel_launch(sc4, prm, uni, target, small, kc_tiles, False, frozen)
        vs_k3 = check_grads(total[1], whole[1], mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME,
                            label=f"{sname} K4 sum vs K3")
        log("flagship_tiles_parity", scene=sname, tiles_per_rank=plan.tiles_per_device, k2=planes_stats(st2), k4=ranks,
            sum_vs_k3={"loss_rel_err": abs(float(total[0]) / float(whole[0]) - 1.0), **vs_k3})

    if then is not None:
        then()

    # ---- 32. main path at 1920x1080 ----
    trainable = (False, False) + (True,) * 9  # the plane's normal and offset frozen
    # Adam moves each of the 17 trained parameters by about the step whatever
    # its gradient's size: at 1e-2 (a third of the corner radius, a sixth of
    # the torus's tube) the flagship's loss rises, in the JAX package's fit
    # as in this one; 3e-4 fits (tests/test_torch_fit.py::
    # test_adam_fit_matches_jax_flagship).
    lr = 3e-4
    target = render_kernel_forward(flagship, ref_cam, light, mat, full, device=dev)[0]
    tgt = target.permute(2, 0, 1).contiguous()
    orbit4 = [tt.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0, device=dev) for i in range(4)]
    main = {}
    with PlainCalls() as plain, BackwardModes() as modes:
        reset()
        frames = tt.render_batch(flagship, orbit4, light, mat, full, engine="kernel")
        torch.cuda.synchronize()
        main["render_batch"] = launches()
        with tempfile.TemporaryDirectory() as tmp:
            png = os.path.join(tmp, "flagship.png")
            check(cli.main(["render", "--scene", "flagship", "--width", str(W), "--height", str(H), "--out", png]) == 0,
                  "cli render --scene flagship failed")
            with open(png, "rb") as f:
                head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == W.to_bytes(4, "big") + H.to_bytes(4, "big"),
              "cli render --scene flagship did not write a 1920x1080 PNG")
        main["render_with_cli"] = launches()
        reset()
        l2 = fit_scene(target, flagship_fit_start(dev), ref_cam, light, mat, full,
                       FitConfig(steps=20, learning_rate=lr, log_every=1), trainable=trainable, device=dev)
        main["fit_l2"] = launches()
        reset()
        ms = fit_scene(target, flagship_fit_start(dev), ref_cam, light, mat, full,
                       FitConfig(steps=5, learning_rate=lr, log_every=1, loss="multiscale"), trainable=trainable,
                       device=dev)
        main["fit_multiscale"] = launches()
        reset()
        ms4 = fit_scene(target, flagship_fit_start(dev), ref_cam, light, mat, full,
                        FitConfig(steps=5, learning_rate=lr, log_every=1, loss="multiscale", pyramid_levels=4),
                        trainable=trainable, device=dev)
        main["fit_multiscale_4_levels"] = launches()
        ms_modes = list(modes.calls[-5:])
        launch.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
        try:
            mesh = make_mesh()
            check(dist.get_backend() == "nccl" and mesh.size == 1, f"mesh {mesh}")
            reset()
            tiles = fit_scene(target, flagship_fit_start(dev), ref_cam, light, mat, full,
                              FitConfig(steps=20, learning_rate=lr, log_every=1, shard_layout="tiles"), mesh=mesh,
                              trainable=trainable)
            main["fit_mesh_tiles"] = launches()
            reset()
            sharded = render_sharded_kernel(flagship, ref_cam, light, mat, full, mesh, kc, layout="tiles", planar=True)
            torch.cuda.synchronize()
            main["render_sharded_tiles"] = launches()
        finally:
            launch.shutdown()
        cells = {}
        for mode in ("fwd", "fwd_bwd"):
            reset()
            r = bench.run_benchmark(scene_name="flagship", mode=mode, iters=2, frames_per_dispatch=4)
            cells[mode] = {**r, "launches": launches()}
    check(sum(plain.calls.values()) == 0, f"the flagship's main path called plain versions: {plain.calls}")
    zero = {fn.__name__: 0 for fn in counters}
    want_counts = {
        "render_batch": {**zero, "render_kernel_forward": 4},
        "render_with_cli": {**zero, "render_kernel_forward": 5},
        "fit_l2": {**zero, "fit_step_kernel": 20},
        "fit_multiscale": {**zero, "fit_step_kernel": 5},
        "fit_multiscale_4_levels": {**zero, "render_kernel_forward": 5, "render_kernel_backward": 5},
        "fit_mesh_tiles": {**zero, "fit_step_kernel_tiles": 20},
        "render_sharded_tiles": {**zero, "render_kernel_tiles_forward": 1},
    }
    for name, want in want_counts.items():
        check(main[name] == want, f"flagship {name} launched {main[name]}, expected {want}")
    check(ms_modes == [False] * 5, f"the 4-level multiscale fit's K5 asked for wrt_uniforms {ms_modes}")
    for mode, counter in (("fwd", "render_kernel_forward"), ("fwd_bwd", "fit_step_kernel")):
        got = cells[mode]["launches"]
        check(got[counter] > 0 and sum(got.values()) == got[counter] and cells[mode]["value"] > 0,
              f"bench flagship {mode}: {cells[mode]}")
    check(tuple(frames.shape) == (4, H, W, 3) and bool(torch.isfinite(frames).all()), "bad flagship frames")
    for name, res in (("l2", l2), ("multiscale", ms), ("multiscale_4_levels", ms4), ("mesh_tiles", tiles)):
        check(all(math.isfinite(v) for v in res.losses), f"flagship {name} fit: non-finite loss")
        check(res.losses[-1] < res.losses[0], f"flagship {name} fit: the loss did not fall "
                                              f"({res.losses[0]} -> {res.losses[-1]})")
        check(bool(torch.isfinite(scene_param_vector(res.scene)).all()), f"flagship {name} fit: non-finite parameters")
    tiles_rel = max(abs(a / b - 1.0) for a, b in zip(tiles.losses, l2.losses))
    check(tiles_rel <= 1e-5, f"flagship fit_scene(mesh, tiles): losses off the unsharded fit's by {tiles_rel:.3g}")
    prm0, uni0 = inputs(flagship, orbit4[0], full)
    k0 = render_kernel_launch(flagship, prm0, uni0, full)
    torch.testing.assert_close(k0[0].permute(1, 2, 0), frames[0], rtol=0, atol=0)
    frame0 = check_planes(k0, render_kernel_forward_plain(flagship, prm0, uni0, full), full.march.max_distance,
                          "flagship 1080p frame 0", razor=functools.partial(razor_edge, flagship, prm0, uni0, full))
    # K2's image (the 135-tile plan) against K1's.
    ref_prm, ref_uni = inputs(flagship, ref_cam, full)
    k1_ref = render_kernel_launch(flagship, ref_prm, ref_uni, full)
    sharded_st = check_planes((sharded,), k1_ref[:1], full.march.max_distance, "flagship render_sharded_kernel vs K1",
                              razor=functools.partial(razor_edge, flagship, ref_prm, ref_uni, full))
    sharded_st["rgb"]["pixels_differing_bits"] = int((sharded != k1_ref[0]).any(0).sum())
    step0 = k3_vs_plain(flagship_fit_start(dev), ref_cam, full, False, frozen, "flagship K3 1080p step 0", tgt)
    log("flagship_main_path", launches=main, multiscale_render_bwd_wrt_uniforms=ms_modes,
        frame0=planes_stats(frame0), l2_losses=l2.losses, multiscale_losses=ms.losses,
        multiscale_4_levels_losses=ms4.losses, mesh_tiles_losses=tiles.losses,
        mesh_tiles_loss_rel_err=tiles_rel, mesh_tiles_losses_equal=tiles.losses == l2.losses,
        mesh_tiles_loss_max_abs_diff=max(abs(a - b) for a, b in zip(tiles.losses, l2.losses)),
        fitted=scene_param_vector(l2.scene).tolist(), target=scene_param_vector(flagship).tolist(),
        render_sharded_vs_k1=sharded_st["rgb"], step0=step0, bench=cells)

    # ---- 33. times at 1080p (plain, kernel, kernel, plain) and bounds ----
    sc = flagship_fit_start(dev)
    prm, uni = inputs(flagship, ref_cam, full)
    s_prm, s_uni = inputs(sc, ref_cam, full)
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1)
    trow, tcol = plan.tables(0, dev)
    stack = gather_target_tiles(tgt, plan)[0].contiguous()
    rgb, t, sh, ao = render_kernel_launch(sc, s_prm, s_uni, full)
    g_rgb = (2.0 * (rgb - tgt)).contiguous()
    k3_launch, _, k3_totals = fit_launcher(sc, s_prm, s_uni, tgt, full, kc, False, frozen)
    k3_launch()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k3_totals).all()), "flagship K3's totals at 1080p are not finite")
    timed = {
        "render_fwd": (lambda: render_kernel_launch(flagship, prm, uni, full),
                       lambda: render_kernel_forward_plain(flagship, prm, uni, full)),
        "render_tiles": (lambda: render_kernel_tiles_launch(flagship, prm, uni, trow, tcol, full, kc),
                         lambda: render_kernel_tiles_forward_plain(flagship, prm, uni, trow, tcol, full, kc)),
        "fit_step": (k3_launch, lambda: fit_step_kernel_plain(sc, s_prm, s_uni, tgt, full, kc, False, frozen)),
        "fit_step_tiles": (lambda: fit_step_kernel_tiles_launch(sc, s_prm, s_uni, stack, trow, tcol, full, kc, False,
                                                                frozen),
                           lambda: fit_step_kernel_tiles_plain(sc, s_prm, s_uni, stack, trow, tcol, full, kc, False,
                                                               frozen)),
    }
    for name, wrt in (("render_bwd", False), ("render_bwd_uniforms", True)):
        k5_launch, _, k5_totals = render_bwd_launcher(sc, s_prm, s_uni, g_rgb, t, sh, ao, full, kc, wrt)
        k5_launch()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k5_totals).all()), f"flagship {name}'s totals at 1080p are not finite")
        timed[name] = (k5_launch, functools.partial(render_kernel_backward_plain, sc, s_prm, s_uni, g_rgb, t, sh, ao,
                                                    full, wrt_uniforms=wrt))
    runs = {}
    for name, (kern, plain_fn) in timed.items():
        p1, k1, k2, p2 = time_ms(plain_fn, 0, 1), time_ms(kern), time_ms(kern), time_ms(plain_fn, 0, 1)
        runs[name] = {"ms": (k1 + k2) / 2, "ms_runs": [k1, k2], "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2]}
    runs["fit_step"]["wrapper_ms"] = time_ms(lambda: fit_step_kernel_launch(sc, s_prm, s_uni, tgt, full, kc, False,
                                                                            frozen))
    # K5 at the size the multiscale fit launches it (1920x1080), both forms,
    # against its plain version on the timed cotangent, zeroed where the
    # gradient is ill-conditioned.
    g_cond = (g_rgb * conditioned(sc, s_prm, s_uni, t, full)).contiguous()
    mass = gradient_mass(sc, s_prm, s_uni, g_cond, t, sh, ao, full)
    for name, wrt in (("render_bwd", False), ("render_bwd_uniforms", True)):
        got = render_kernel_backward_launch(sc, s_prm, s_uni, g_cond, t, sh, ao, full, wrt_uniforms=wrt)
        want = render_kernel_backward_plain(sc, s_prm, s_uni, g_cond, t, sh, ao, full, wrt_uniforms=wrt)
        torch.cuda.synchronize()
        st = check_grads(torch.cat(got) if wrt else got[0], torch.cat(want) if wrt else want[0],
                         mass if wrt else mass[:s_prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME,
                         label=f"flagship K5 1080p wrt_uniforms={wrt}")
        runs[name]["vs_plain_1080p"] = st
        errs["render_bwd"].append(st["max_abs_err"])
    fit_scene(target, flagship_fit_start(dev), ref_cam, light, mat, full,
              FitConfig(steps=5, learning_rate=lr, log_every=5), trainable=trainable, device=dev)
    res = fit_scene(target, flagship_fit_start(dev), ref_cam, light, mat, full,
                    FitConfig(steps=50, learning_rate=lr, log_every=50), trainable=trainable, device=dev)
    fit_ms = W * H / res.rays_per_second * 1e3
    # Bounds on this run's data: K1 and K2 the flagship's marches and taps
    # (its planes written); K3 and K4 the fit's start, its primal and reverse
    # pass (the target read, the totals written); K5 the reverse pass with its
    # re-trace (six planes read, a partial row of its columns per block
    # written and read, the totals written).
    counts = march_counts(torch, flagship, ref_cam, full, prm, uni, render_kernel_forward_plain)
    s_counts = march_counts(torch, sc, ref_cam, full, s_prm, s_uni, render_kernel_forward_plain)
    costs = scene_costs(cuda_scene_source(flagship, full, kc))
    s_costs = scene_costs(cuda_scene_source(sc, full, kc, False, frozen))
    P = s_prm.numel()
    blocks = -(-W // kc.block_w) * -(-H // kc.block_h)
    bounds = {
        "render_fwd": bound(*analytic_work(costs, counts, full), 24 * W * H),
        "render_tiles": bound(*analytic_work(costs, counts, full), 24 * W * H + 8 * plan.tiles_per_device),
        "fit_step": bound(*analytic_work(s_costs, s_counts, full, reverse=True), 12 * W * H + 8 * (P + 31)),
        "fit_step_tiles": bound(*analytic_work(s_costs, s_counts, full, reverse=True),
                                12 * W * H + 8 * plan.tiles_per_device + 8 * (P + 31)),
        "render_bwd": bound(*analytic_work(s_costs, s_counts, full, primal=False, reverse=True, retrace=True),
                            24 * W * H + (8 * blocks + 8) * P),
        "render_bwd_uniforms": bound(*analytic_work(s_costs, s_counts, full, primal=False, reverse=True, retrace=True),
                                     24 * W * H + (8 * blocks + 8) * (P + 30)),
    }
    for name, b in bounds.items():
        runs[name].update(bound_ms=b[0], bound_by=b[1])
    log("flagship_times_1080p", card=card, counts=counts, fit_start_counts=s_counts, costs=costs,
        fit_start_costs=s_costs, fit_scene_ms_per_step=fit_ms, fwd_bwd_rays_per_s=res.rays_per_second, **runs)
    main_launches = {"render_fwd": main["render_batch"]["render_kernel_forward"],
                     "render_tiles": main["render_sharded_tiles"]["render_kernel_tiles_forward"],
                     "fit_step": main["fit_l2"]["fit_step_kernel"],
                     "fit_step_tiles": main["fit_mesh_tiles"]["fit_step_kernel_tiles"],
                     "render_bwd": main["fit_multiscale_4_levels"]["render_kernel_backward"]}
    out = {}
    for name in main_launches:
        out[name] = {"launches": main_launches[name], "max_abs_err": max(errs[name]), "ms": runs[name]["ms"],
                     "plain_ms": runs[name]["plain_ms"], "bound_ms": runs[name]["bound_ms"],
                     "bound_by": runs[name]["bound_by"]}
    out["render_bwd"]["uniforms"] = {k: runs["render_bwd_uniforms"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                                                  "bound_by")}
    out["render_bwd"]["max_abs_err_1080p"] = max(runs[n]["vs_plain_1080p"]["max_abs_err"]
                                                 for n in ("render_bwd", "render_bwd_uniforms"))
    out["fit_step"]["fit_scene_ms_per_step"] = fit_ms
    return out


#: The register-line sweep's caps (``--register-line``): each a copy of
#: ``ops/csrc`` whose ``kMinBlocks`` lines ask these blocks an SM of K3, of
#: K5's parameters' form and of its P + 30 form, whatever the scene.  K5's
#: P + 30 form at 1 block is one program in the last two: their difference
#: is the sweep's own spread.
SWEEP_CAPS = {"4/4/2": (4, 4, 2), "2/2/1": (2, 2, 1), "1/1/1": (1, 1, 1)}
#: The sweep's scenes, by ``Scene::bwd_values``: lattice_scene 48,
#: random_blobs(2) 57, random_blobs(3) 87, csg_showcase 159,
#: random_blobs(8) 237, capsule_chain 277, transform_sampler 398,
#: fractal_scene 409 (392 kept by its Mandelbulb alone).
SWEEP_SCENES = ("lattice_scene", "random_blobs_2", "random_blobs_3", "csg_showcase", "random_blobs_8",
                "capsule_chain", "transform_sampler", "fractal_scene")


def caps_csrc(root: str, caps) -> str:
    """A copy of this checkout's ``ops/csrc`` under ``root`` whose K3 asks
    ``caps[0]`` blocks an SM and whose K5 asks ``caps[1]`` (its parameters'
    form) and ``caps[2]`` (with the uniforms)."""
    import shutil

    src = os.path.join(REPO, "sdf3d_tpu_torch", "ops", "csrc")
    dst = os.path.join(root, "csrc_" + "_".join(map(str, caps)))
    shutil.copytree(src, dst)
    line = r"constexpr int kMinBlocks = [^;]*;"
    for name, repl in (("fit_kernel.cu", f"constexpr int kMinBlocks = {caps[0]};"),
                       ("render_bwd_kernel.cu", f"constexpr int kMinBlocks = WRT_U ? {caps[2]} : {caps[1]};")):
        path = os.path.join(dst, name)
        with open(path) as f:
            text = f.read()
        check(len(re.findall(line, text)) == 1, f"{name}: not one kMinBlocks line")
        with open(path, "w") as f:
            f.write(re.sub(line, repl, text))
    return dst


def _sweep_scene(tt, name: str, dev):
    """A scene of the register-line sweep: ``random_blobs_<n>`` (seed 0),
    ``transform_sampler`` (``utils/parity.py``) or a scene of ``scenes.py``
    by name."""
    if name.startswith("random_blobs_"):
        return tt.random_blobs(n=int(name.rsplit("_", 1)[1])).to(dev)
    if name == "transform_sampler":
        from sdf3d_tpu_torch.utils.parity import transform_sampler

        return transform_sampler(dev)
    return getattr(tt, name)().to(dev)


class _OneLibrary:
    """Stands for ``ops._build.LIBRARIES`` while :func:`register_line`
    makes one cap's launchers: every load is that cap's library."""

    def __init__(self, lib):
        self.lib = lib

    def load_for(self, *job):
        return self.lib


def register_line(rounds: int = 5, names=SWEEP_SCENES) -> dict:
    """``--register-line``: K3 (the plane frozen) and both forms of K5 at
    1080p on each scene of :data:`SWEEP_SCENES` under the reference camera,
    at every cap of :data:`SWEEP_CAPS`, all in this process: one library per
    scene and cap (:func:`caps_csrc`, built together), then ``rounds``
    rounds of CUDA-event times (10 calls after one), the caps in a rotating
    order within each round.  The inputs: the plain version's planes, the
    target its image dimmed by 5%.  Per scene, kernel and cap: the times and
    their median, ``ptxas`` registers, spills and blocks an SM, and whether
    the totals are finite."""
    import concurrent.futures

    import torch

    sys.path.insert(0, REPO)
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import fit_launcher
    from sdf3d_tpu_torch.ops.render_bwd_kernel import render_bwd_launcher
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        library_job,
        pack_uniforms,
        render_kernel_forward_plain,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    kc, frozen = KernelConfig(), (0, 1, 2, 3)
    uni = pack_uniforms(tt.Camera.reference(device=dev), tt.reference_light(device=dev),
                        tt.reference_material(device=dev), cfg.ray_mode, dev)
    uni[27] = float(cfg.shadow.k)
    scenes = {n: _sweep_scene(tt, n, dev) for n in names}
    out = {"card": card_name_and_power(), "caps": SWEEP_CAPS, "rounds": rounds, "scenes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {label: _build.KernelLibraries(csrc=caps_csrc(tmp, caps)) for label, caps in SWEEP_CAPS.items()}
        jobs = [(label, name, library_job(sc, cfg, kc, False, frozen)) for label in libs for name, sc in scenes.items()]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            loaded = dict(zip([(label, name) for label, name, _ in jobs],
                              pool.map(lambda job: libs[job[0]].load_for(*job[2]), jobs)))
        out["build_wall_seconds"] = time.perf_counter() - t0
        for name, sc in scenes.items():
            prm = scene_param_vector(sc, dev)
            with torch.no_grad():
                rgb, t, sh, ao = render_kernel_forward_plain(sc, prm, uni, cfg, kc)
            target = (rgb * 0.95).contiguous()
            g_rgb = (2.0 * (rgb - target)).contiguous()
            t, sh, ao = (x.contiguous() for x in (t, sh, ao))
            header = cuda_scene_source(sc, cfg, kc, False, frozen)
            entry = {"bwd_values": int(header.split("bwd_values = ")[1].split(";")[0])}
            runs = {}
            saved = _build.LIBRARIES
            try:
                for label in libs:
                    # K5 reads nothing of the header's fit settings, so the
                    # fit step's library serves both.
                    _build.LIBRARIES = _OneLibrary(loaded[(label, name)])
                    runs[label] = {"fit_step": fit_launcher(sc, prm, uni, target, cfg, kc, False, frozen)[0]}
                    for form, wrt in (("render_bwd", False), ("render_bwd_uniforms", True)):
                        runs[label][form] = render_bwd_launcher(sc, prm, uni, g_rgb, t, sh, ao, cfg, kc, wrt)[0]
            finally:
                _build.LIBRARIES = saved
            for label, lib in libs.items():
                ptxas = ptxas_summary(lib.log(lib.key(header)))
                entry[label] = {}
                for kname, launch in runs[label].items():
                    totals = launch()
                    torch.cuda.synchronize()
                    px = ptxas[{"fit_step": "fit_step", "render_bwd": "render_bwd_params",
                                "render_bwd_uniforms": "render_bwd"}[kname]]
                    entry[label][kname] = {"ms": [], "registers": px["registers"],
                                           "spill_stores": px.get("spill_stores"), "spill_loads": px.get("spill_loads"),
                                           "blocks_per_sm": blocks_per_sm(px["registers"], kc.block_w * kc.block_h),
                                           "finite": bool(torch.isfinite(totals).all())}
            labels = list(libs)
            for r in range(rounds):
                for label in labels[r % len(labels):] + labels[:r % len(labels)]:
                    for kname, launch in runs[label].items():
                        entry[label][kname]["ms"].append(time_ms(launch, 1, 10))
            for label in labels:
                for v in entry[label].values():
                    v["median_ms"] = statistics.median(v["ms"])
            out["scenes"][name] = entry
            log("register_line_scene", scene=name, **entry)
    return out


def fit_jobs(tt) -> list:
    """The library jobs of phase 7: the fit demo's K3 with the plane frozen
    and K5 with the uniforms' gradient."""
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    start = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25))
    return [library_job(start, full, KernelConfig(), wrt, fr) for wrt, fr in ((False, (0, 1, 2, 3)), (True, ()))]


def tiles_jobs(tt, dev) -> list:
    """The library jobs of phase 17: K1-K4 on the reference scene at phase
    18's tiles and the 1080p tile, in both fit forms, and the interleaved
    rank's row slab."""
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job
    from sdf3d_tpu_torch.parallel import make_mesh
    from sdf3d_tpu_torch.parallel.shard_render import row_layout

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    kc, frozen, ref_scene = KernelConfig(), (0, 1, 2, 3), tt.reference_scene()
    small = [(dataclasses.replace(full, width=256, height=192), KernelConfig(tile_h=8, tile_w=128)),
             (dataclasses.replace(full, width=248, height=184), KernelConfig(block_w=8, block_h=8, tile_h=8, tile_w=8))]
    slab_cfg = row_layout(full, make_mesh(dev), True, kc.tile_h)[0]  # the interleaved rank's config
    return [library_job(ref_scene, c, k, wrt, fr) for c, k in small + [(full, kc)]
            for wrt, fr in ((True, ()), (False, frozen))] + [library_job(ref_scene, slab_cfg, kc, False, frozen)]


def variant_jobs(tt) -> tuple:
    """``(jobs, extra)`` of phase 26: every K9 variant under the one-step
    config, and two libraries of phase 29's extras built with them (the fit
    step of the fast profile and of the fractal, the bench's fwd_bwd
    cells)."""
    from sdf3d_tpu_torch.benchmarks import exp_ad
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job
    from sdf3d_tpu_torch.ops.scene_program import FIT_VARIANTS

    kc, scene = KernelConfig(), tt.reference_scene()
    ref = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    jobs = [library_job(scene, exp_ad.short_config(ref), kc, True, (), v) for v in FIT_VARIANTS]
    return jobs, [library_job(scene, tt.fast_config(ref), kc, False, ()),
                  library_job(tt.fractal_scene(), ref, kc, False, ())]


def flagship_jobs(tt, dev) -> list:
    """The library jobs of phase 30: the flagship's and the CSG sampler's
    K1-K5 forms, the flagship's multiscale and silhouette K3."""
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job
    from sdf3d_tpu_torch.utils.parity import csg_sampler

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    kc, kc_point, kc_tiles, frozen = KernelConfig(), KernelConfig(ray_sdf=False), KernelConfig(tile_h=8, tile_w=128), \
        (0, 1, 2, 3)
    flagship, sampler = tt.flagship_scene(), csg_sampler(dev)
    combos = [(kc, True, ()), (kc, False, frozen), (kc, False, ()), (kc, True, frozen), (kc_point, True, ()),
              (kc_tiles, True, ()), (kc_tiles, False, frozen)]
    jobs = [library_job(flagship, full, k, wrt, fr) for k, wrt, fr in combos]
    jobs += [library_job(sampler, full, k, wrt, fr) for k, wrt, fr in [combos[i] for i in (0, 1, 4)]]
    return jobs + [library_job(flagship, full, kc, False, frozen, "full", 3),  # the multiscale fit's K3
                   library_job(flagship, dataclasses.replace(full, background=(0.0, 0.0, 0.0)), kc, False, frozen,
                               "full", 0, True)]  # the silhouette K3 (phase 43)


def rows_jobs(tt) -> list:
    """The library jobs of phase 54: K1 + K5 on the two ranks' row slabs
    (contiguous: the default tiles; interleaved: tile rows of 12)."""
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    slab = dataclasses.replace(full, height=H // 2, ndc_height=H)
    return [library_job(tt.reference_scene(), slab, KernelConfig(tile_h=th))
            for th in sorted({KernelConfig().tile_h, 12})]


def shaded_jobs(tt) -> list:
    """The library job of phase 55's analytic twin of the shaded grid: K1's
    material branch on ``ground_plane() | shaded(sphere, material)``."""
    from sdf3d_tpu_torch.ops.render_kernel import library_job

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    return [library_job(tt.sdf.ground_plane() | tt.sdf.shaded(tt.sdf.sphere((0.0, 0.4, 0.0), 0.2), **SHADED_MATERIAL),
                        full)]


def labs_jobs(tt) -> list:
    """The library jobs of phases 58-59: every library the labs load (the
    labs would each build their own, on the host's cores the others need)."""
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    ref, flag = tt.reference_scene(), tt.flagship_scene()
    fast, kc = tt.fast_config(full), KernelConfig()
    return [library_job(ref, fast, kc), library_job(flag, fast, kc), library_job(flag, full, kc),
            library_job(ref, dataclasses.replace(full, shadow=dataclasses.replace(full.shadow, enabled=False)), kc),
            library_job(ref, fast, kc, wrt_uniforms=False)]


def prefetch_jobs(tt, dev) -> list:
    """Every library that the phases after phase 3 load and that is known
    before they run, in the order they load them: the queue that
    ``_build.LIBRARIES.prefetch`` builds in the background from phase 3 on.
    The neural phase 13 builds its own (its first frame's time includes its
    build)."""
    variants, extra = variant_jobs(tt)
    return (fit_jobs(tt) + tiles_jobs(tt, dev) + variants + extra + [((), lambda: "", "collectives")] +
            flagship_jobs(tt, dev) + scenes_13b_jobs(tt, dev) + fractal_jobs(tt) + loss_slice_jobs(tt) +
            rows_jobs(tt) + shaded_jobs(tt) + labs_jobs(tt) + slice19_jobs(tt))


def scenes_13b_jobs(tt, dev) -> list:
    """The library jobs of phase 34: each 13b scene's K1 in both forms and
    K3 with the plane frozen, ``random_blobs``' K1 for the scene-cost sweep,
    the capsule chain's multiscale K3."""
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job
    from sdf3d_tpu_torch.utils.parity import capsule_chain_fit_start, scenes_13b

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    kc, kc_point, frozen = KernelConfig(), KernelConfig(ray_sdf=False), (0, 1, 2, 3)
    jobs = []
    for sc, _ in scenes_13b(dev).values():
        jobs += [library_job(sc, full, kc), library_job(sc, full, kc_point), library_job(sc, full, kc, False, frozen)]
    jobs += [library_job(tt.random_blobs(n=n), full, kc) for n in (2, 4, 16)]
    jobs += [library_job(capsule_chain_fit_start(dev), full, kc, False, frozen, "full", 3)]  # the multiscale fit's K3
    return jobs


def scenes_13b_phases(torch, tt, card: str, dev) -> dict:
    """Phases 34-36: the scenes of ROADMAP item 13b (``csg_showcase``,
    ``lattice_scene``, ``capsule_chain``, ``random_blobs``) and the transform
    sampler (``utils/parity.py::transform_sampler``: every 13b node) on
    K1-K5.  Returns, per kernel entry of the kernels line (``render_fwd``,
    ``fit_step``, ``render_bwd``), each scene's launches, times, plain
    times, bound, registers and spills."""
    import contextlib
    import io

    from sdf3d_tpu_torch.benchmarks import suite
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import fit_launcher, fit_step_kernel, fit_step_kernel_launch, fit_step_kernel_plain
    from sdf3d_tpu_torch.ops.neural_kernel import render_neural_forward
    from sdf3d_tpu_torch.ops.render_bwd_kernel import (
        render_bwd_launcher,
        render_kernel_backward,
        render_kernel_backward_launch,
        render_kernel_backward_plain,
    )
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        library_job,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_forward_plain,
        render_kernel_launch,
        render_kernel_tiles_forward,
        render_kernel_tiles_launch,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.parallel.tile_queue import gather_target_tiles, plan_tiles
    from sdf3d_tpu_torch.utils.parity import (
        FLAGSHIP_SAME,
        SCENE_BARS,
        capsule_chain_fit_start,
        check_grads,
        check_planes,
        conditioned,
        gradient_mass,
        razor_edge,
        rounding_decided,
        scenes_13b,
    )

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    small = dataclasses.replace(full, width=256, height=192)
    ragged = dataclasses.replace(full, width=250, height=190)
    kc, kc_point = KernelConfig(), KernelConfig(ray_sdf=False)
    frozen = (0, 1, 2, 3)  # the ground plane
    orbit = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)
    shared = scenes_13b(dev)
    blobs = {n: tt.random_blobs(n=n).to(dev) for n in (2, 3, 4, 16)}
    blobs[8] = shared["random_blobs"][0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    counters = (render_kernel_forward, fit_step_kernel, render_kernel_backward, render_kernel_tiles_forward,
                render_neural_forward)

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters}

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def planes_stats(st):
        return {n: {q: v.get(q) for q in ("over_atol", "max_abs_err", "over_hard")} for n, v in st.items()}

    def bwd_values(header):
        return int(header.split("bwd_values = ")[1].split(";")[0])

    # ---- 34. build: the 13b scenes' libraries together (in the whole smoke
    # built already by the queue of phase 3) ----
    libs = _build.LIBRARIES
    builds0, seconds0 = libs.builds, libs.build_seconds
    jobs = scenes_13b_jobs(tt, dev)
    t0 = time.perf_counter()
    libs.load_many(jobs)
    build_wall = time.perf_counter() - t0
    built = {}
    for name, (sc, _) in shared.items():
        header = cuda_scene_source(sc, full, kc, False, frozen)
        kernels = ptxas_summary(libs.log(libs.key(header)))
        check(set(kernels) >= {"render_fwd", "fit_step", "render_bwd", "render_bwd_params"},
              f"{name}: ptxas reported {sorted(kernels)}")
        for v in kernels.values():
            v["blocks_per_sm"] = blocks_per_sm(v["registers"])
        built[name] = {"bwd_values": bwd_values(header), "n_params": int(scene_param_vector(sc).numel()),
                       "header_bytes": len(header), "ptxas": kernels}
    scene_cost_k1 = {n: ptxas_summary(libs.log(libs.key(cuda_scene_source(blobs[n], full, kc))))["render_fwd"]
                     for n in (2, 4, 8, 16)}
    sampler = shared["transform_sampler"][0]
    # A changed rotation (across the series' threshold) and period reuse the
    # library: the selects are run-time.
    before = libs.builds
    moved = scenes_13b(dev)["transform_sampler"][0]
    with torch.no_grad():
        for m in moved.modules():
            if type(m).__name__ == "Rotate":
                m.rotvec.add_(0.3)
            if type(m).__name__ == "RepeatInfinite":
                m.period.mul_(1.2)
    a = render_kernel_forward(sampler, shared["transform_sampler"][1], light, mat, small, device=dev)[0]
    b = render_kernel_forward(moved, shared["transform_sampler"][1], light, mat, small, device=dev)[0]
    torch.cuda.synchronize()
    check(libs.builds == before, f"a changed rotation or period rebuilt a library ({libs.builds - before})")
    check(bool((a != b).any()), "moving the rotations and the period did not change the image")
    log("scenes_13b_build", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        build_wall_seconds=build_wall, libraries=len(jobs), scenes=built, scene_cost_render_fwd_ptxas=scene_cost_k1)

    # ---- 35. K1-K5 vs their plain versions on the 13b scenes ----
    errs = {"render_fwd": [], "fit_step": [], "render_bwd": []}
    for name, (sc, cam) in shared.items():
        bar = SCENE_BARS.get(name, {})
        cams = (("scene", cam), ("orbit30_15", orbit))
        # Both forms under the scene's camera at 256x192 (the ragged size and
        # orbit 30/15 on the reference scene, the flagship and the sampler).
        for (cam_name, cm), c, ray_sdf in ((cams[0], small, True), (cams[0], small, False)):
            k = kc if ray_sdf else kc_point
            prm, uni = inputs(sc, cm, c)
            got, want = render_kernel_launch(sc, prm, uni, c, k), render_kernel_forward_plain(sc, prm, uni, c, k)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(g).all()) for g in got), f"{name} K1: non-finite planes")
            # Past the hard limit only razor-edge rays and pixels rounding
            # decides (utils/parity.py), found when a pixel is past it.
            witness = Witness(razor_edge, rounding_decided, sc, prm, uni, c, k)
            try:
                st = check_planes(got, want, c.march.max_distance, f"{name} K1 {cam_name} {c.width}x{c.height}",
                                  razor=witness, **bar)
            except AssertionError:
                log("scenes_13b_k1_failed", scene=name, camera=cam_name, size=[c.width, c.height], ray_sdf=ray_sdf,
                    worst=worst_pixels(torch, got, want, witness(), c.march.max_distance))
                raise
            errs["render_fwd"].append(st["rgb"]["max_abs_err"])
            log("scenes_13b_k1_parity", scene=name, camera=cam_name, size=[c.width, c.height], ray_sdf=ray_sdf,
                **witness.counts, **planes_stats(st))
    for name in ("transform_sampler", "capsule_chain"):
        sc = capsule_chain_fit_start(dev) if name == "capsule_chain" else shared[name][0]
        # The sampler under orbit 30/15 (under the reference camera its
        # rounded cylinder's edge is seen from below at grazing:
        # tests/test_torch_fit_kernel.py), the chain under its camera too.
        k3_cams = [("orbit30_15", orbit)] + ([("scene", shared[name][1])] if name == "capsule_chain" else [])
        for (cam_name, cm), c, wrt, fr in [(k3_cams[-1], small, False, frozen)]:
            label = f"{name} K3 {cam_name} {c.width}x{c.height} wrt_uniforms={wrt}"
            prm, uni = inputs(sc, cm, c)
            st = k3_against_plain(torch, sc, prm, uni, c, kc, wrt, fr, label, gen, rounding=True)
            errs["fit_step"].append(st["own_march"]["max_abs_err"])
            log("scenes_13b_k3_parity", scene=name, camera=cam_name, size=[c.width, c.height], wrt_uniforms=wrt,
                frozen=list(fr), **st)
        for (cam_name, cm), c in ((("scene", shared[name][1]), small), (("orbit30_15", orbit), ragged)):
            prm, uni = inputs(sc, cm, c)
            _, t, sh, ao = render_kernel_launch(sc, prm, uni, c)
            g_rgb = (torch.randn((3, c.height, c.width), generator=gen, device=dev)
                     * conditioned(sc, prm, uni, t, c)).contiguous()
            mass = gradient_mass(sc, prm, uni, g_rgb, t, sh, ao, c)
            for wrt in (True, False):
                label = f"{name} K5 {cam_name} {c.width}x{c.height} wrt_uniforms={wrt}"
                got = render_kernel_backward_launch(sc, prm, uni, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
                want = render_kernel_backward_plain(sc, prm, uni, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
                torch.cuda.synchronize()
                st = check_grads(torch.cat(got) if wrt else got[0], torch.cat(want) if wrt else want[0],
                                 mass if wrt else mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME, label=label)
                errs["render_bwd"].append(st["max_abs_err"])
                log("scenes_13b_k5_parity", scene=name, camera=cam_name, size=[c.width, c.height], wrt_uniforms=wrt,
                    **st)
    # csg_showcase: its bare box's and cylinder's cores give K3 and K5
    # non-finite totals exactly where the plain versions' are (JAX's too:
    # ROADMAP Queue 3).
    sc, cam = shared["csg_showcase"]
    prm, uni = inputs(sc, cam, small)
    rgb, t, sh, ao = render_kernel_launch(sc, prm, uni, small)
    target = (rgb + torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1).contiguous()
    got3 = fit_step_kernel_launch(sc, prm, uni, target, small, kc, True, ())
    want3 = fit_step_kernel_plain(sc, prm, uni, target, small, kc, True, ())
    g_rgb = (2.0 * (rgb - target)).contiguous()
    nonfinite = {"fit_step": (torch.cat(got3[1:]), torch.cat(want3[1:]))}
    for wrt in (True, False):
        got5 = render_kernel_backward_launch(sc, prm, uni, g_rgb, t, sh, ao, small, wrt_uniforms=wrt)
        want5 = render_kernel_backward_plain(sc, prm, uni, g_rgb, t, sh, ao, small, wrt_uniforms=wrt)
        nonfinite["render_bwd" if not wrt else "render_bwd_uniforms"] = (
            torch.cat(got5) if wrt else got5[0], torch.cat(want5) if wrt else want5[0])
    torch.cuda.synchronize()
    showcase_nan, showcase_params = {}, prm.numel()
    for kname, (g, w) in nonfinite.items():
        check(torch.equal(torch.isfinite(g), torch.isfinite(w)),
              f"csg_showcase {kname}: non-finite slots {(~torch.isfinite(g)).nonzero().ravel().tolist()} against the "
              f"plain version's {(~torch.isfinite(w)).nonzero().ravel().tolist()}")
        showcase_nan[kname] = int((~torch.isfinite(g[:prm.numel()])).sum())
    check(showcase_nan["fit_step"] > 0, "csg_showcase: K3's totals are all finite (JAX's are not)")
    # K2 over the 135-tile plan at 1080p on capsule_chain, against K1.
    sc, cam = shared["capsule_chain"]
    prm, uni = inputs(sc, cam, full)
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1)
    trow, tcol = plan.tables(0, dev)
    k2 = render_kernel_tiles_launch(sc, prm, uni, trow, tcol, full, kc)
    k1 = render_kernel_launch(sc, prm, uni, full)
    torch.cuda.synchronize()
    k1_stacks = [gather_target_tiles(x, plan)[0] for x in k1]
    k2_st = check_planes(k2, k1_stacks, full.march.max_distance, "capsule_chain K2 vs K1")
    k2_vs_k1 = {n: int((a != b).sum()) for n, a, b in zip(("rgb", "t", "shadow", "ao"), k2, k1_stacks)}
    log("scenes_13b_special", csg_showcase_nonfinite_param_slots=showcase_nan, csg_showcase_params=showcase_params,
        capsule_chain_k2_tiles=plan.tiles_per_device, capsule_chain_k2_vs_k1=planes_stats(k2_st),
        capsule_chain_k2_vs_k1_differing_values=k2_vs_k1)

    # ---- 36. main path at 1920x1080 ----
    gallery = {n: v for n, v in shared.items() if n != "transform_sampler"}
    orbit3 = [tt.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0, elevation_deg=20.0, device=dev) for i in range(1, 4)]
    chain, chain_cam = shared["capsule_chain"]
    lr = 3e-4  # the step both packages' fits descend at (tests/test_torch_fit.py)
    trainable = (False, False) + (True,) * (len(list(capsule_chain_fit_start().parameters())) - 2)
    target = render_kernel_forward(chain, chain_cam, light, mat, full, device=dev)[0]
    main, frames0 = {}, {}
    with PlainCalls() as plain, BackwardModes() as modes:
        for name, (sc, cam) in gallery.items():
            reset()
            frames = tt.render_batch(sc, [cam] + orbit3, light, mat, full, engine="kernel")
            torch.cuda.synchronize()
            main[f"render_batch {name}"] = launches()
            check(tuple(frames.shape) == (4, H, W, 3) and bool(torch.isfinite(frames).all()), f"bad {name} frames")
            frames0[name] = frames[0]
        reset()
        l2 = fit_scene(target, capsule_chain_fit_start(dev), chain_cam, light, mat, full,
                       FitConfig(steps=20, learning_rate=lr, log_every=1), trainable=trainable, device=dev)
        main["fit_l2"] = launches()
        reset()
        ms = fit_scene(target, capsule_chain_fit_start(dev), chain_cam, light, mat, full,
                       FitConfig(steps=5, learning_rate=lr, log_every=1, loss="multiscale"), trainable=trainable,
                       device=dev)
        main["fit_multiscale"] = launches()
        reset()
        ms4 = fit_scene(target, capsule_chain_fit_start(dev), chain_cam, light, mat, full,
                        FitConfig(steps=5, learning_rate=lr, log_every=1, loss="multiscale", pyramid_levels=4),
                        trainable=trainable, device=dev)
        main["fit_multiscale_4_levels"] = launches()
        ms_modes = list(modes.calls[-5:])
        reset()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            check(suite.main(["--scene-cost"]) == 0, "suite --scene-cost failed")
        main["suite_scene_cost"] = launches()
        scene_cost = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
    check(sum(plain.calls.values()) == 0, f"the 13b main path called plain versions: {plain.calls}")
    zero = {fn.__name__: 0 for fn in counters}
    want_counts = {f"render_batch {n}": {**zero, "render_kernel_forward": 4} for n in gallery}
    want_counts.update({"fit_l2": {**zero, "fit_step_kernel": 20},
                        "fit_multiscale": {**zero, "fit_step_kernel": 5},
                        "fit_multiscale_4_levels": {**zero, "render_kernel_forward": 5, "render_kernel_backward": 5},
                        "suite_scene_cost": {**zero, "render_kernel_forward": 4 * 6}})
    for name, want in want_counts.items():
        check(main[name] == want, f"13b {name} launched {main[name]}, expected {want}")
    check(ms_modes == [False] * 5, f"the 4-level multiscale fit's K5 asked for wrt_uniforms {ms_modes}")
    check([r["n_primitives"] for r in scene_cost] == [3, 5, 9, 17] and
          all(r["metric"] == "scene_cost_rays_per_second" and r["value"] > 0 for r in scene_cost),
          f"suite --scene-cost printed {scene_cost}")
    for name, res in (("l2", l2), ("multiscale", ms), ("multiscale_4_levels", ms4)):
        check(all(math.isfinite(v) for v in res.losses), f"capsule_chain {name} fit: non-finite loss")
        check(res.losses[-1] < res.losses[0], f"capsule_chain {name} fit: the loss did not fall "
                                              f"({res.losses[0]} -> {res.losses[-1]})")
    frame0 = {}
    for name, (sc, cam) in gallery.items():
        prm0, uni0 = inputs(sc, cam, full)
        k0 = render_kernel_launch(sc, prm0, uni0, full)
        torch.testing.assert_close(k0[0].permute(1, 2, 0), frames0[name], rtol=0, atol=0)
        p0 = render_kernel_forward_plain(sc, prm0, uni0, full)
        witness = Witness(razor_edge, rounding_decided, sc, prm0, uni0, full)
        try:
            frame0[name] = planes_stats(check_planes(k0, p0, full.march.max_distance, f"{name} 1080p frame 0",
                                                     razor=witness, **SCENE_BARS.get(name, {})))
            frame0[name].update(witness.counts)
        except AssertionError:
            log("scenes_13b_frame0_failed", scene=name,
                worst=worst_pixels(torch, k0, p0, witness(), full.march.max_distance))
            raise
    prm0, uni0 = inputs(chain, chain_cam, full)
    step0 = k3_against_plain(torch, capsule_chain_fit_start(dev), scene_param_vector(capsule_chain_fit_start(dev), dev),
                             uni0, full, kc, False, frozen, "capsule_chain K3 1080p step 0", gen,
                             target.permute(2, 0, 1).contiguous(), rounding=True)
    errs["fit_step"].append(step0["own_march"]["max_abs_err"])
    log("scenes_13b_main_path", launches=main, multiscale_render_bwd_wrt_uniforms=ms_modes, frame0=frame0,
        l2_losses=l2.losses, multiscale_losses=ms.losses, fitted=scene_param_vector(l2.scene).tolist(),
        target=scene_param_vector(chain).tolist(), step0=step0, suite_scene_cost=scene_cost)

    # Times at 1080p (plain, kernel, kernel, plain) per scene, its camera:
    # K1; K3 (the plane frozen) and both K5 forms against the scene's render
    # dimmed by 5% (a residual at every pixel); bounds on this run's marches.
    times = {"render_fwd": {}, "fit_step": {}, "render_bwd": {}}
    errs_1080p = []
    blocks = -(-W // kc.block_w) * -(-H // kc.block_h)
    for name, (sc, cam) in shared.items():
        prm, uni = inputs(sc, cam, full)
        rgb, t, sh, ao = render_kernel_launch(sc, prm, uni, full)
        tgt = (rgb * 0.95).contiguous()
        g_rgb = (2.0 * (rgb - tgt)).contiguous()
        k3 = fit_launcher(sc, prm, uni, tgt, full, kc, False, frozen)[0]
        timed = {"render_fwd": (lambda: render_kernel_launch(sc, prm, uni, full),
                                lambda: render_kernel_forward_plain(sc, prm, uni, full)),
                 "fit_step": (k3, lambda: fit_step_kernel_plain(sc, prm, uni, tgt, full, kc, False, frozen))}
        for form, wrt in (("render_bwd", False), ("render_bwd_uniforms", True)):
            timed[form] = (render_bwd_launcher(sc, prm, uni, g_rgb, t, sh, ao, full, kc, wrt)[0],
                           functools.partial(render_kernel_backward_plain, sc, prm, uni, g_rgb, t, sh, ao, full,
                                             wrt_uniforms=wrt))
        counts = march_counts(torch, sc, cam, full, prm, uni, render_kernel_forward_plain)
        costs = scene_costs(cuda_scene_source(sc, full, kc, False, frozen))
        P = prm.numel()
        bounds = {
            "render_fwd": bound(*analytic_work(costs, counts, full), 24 * W * H),
            "fit_step": bound(*analytic_work(costs, counts, full, reverse=True), 12 * W * H + 8 * (P + 31)),
            "render_bwd": bound(*analytic_work(costs, counts, full, primal=False, reverse=True, retrace=True),
                                24 * W * H + (8 * blocks + 8) * P),
            "render_bwd_uniforms": bound(*analytic_work(costs, counts, full, primal=False, reverse=True,
                                                        retrace=True), 24 * W * H + (8 * blocks + 8) * (P + 30)),
        }
        ptxas = built[name]["ptxas"]
        render_ptxas = ptxas_summary(libs.log(libs.key(cuda_scene_source(sc, full, kc))))["render_fwd"]
        for kname, (kern, plain_fn) in timed.items():
            kern()
            torch.cuda.synchronize()
            # Kernel, kernel, then one frame of the plain version without a
            # warm-up (0.05-1.1 s a frame at 1080p; it builds nothing).
            k1_, k2_, p1 = time_ms(kern), time_ms(kern), time_ms(plain_fn, 0, 1)
            px = {"render_fwd": render_ptxas, "fit_step": ptxas["fit_step"], "render_bwd": ptxas["render_bwd_params"],
                  "render_bwd_uniforms": ptxas["render_bwd"]}[kname]
            row = {"ms": (k1_ + k2_) / 2, "ms_runs": [k1_, k2_], "plain_ms": p1, "plain_ms_runs": [p1],
                   "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1], "registers": px["registers"],
                   "spill_stores": px.get("spill_stores"), "spill_loads": px.get("spill_loads"),
                   "blocks_per_sm": blocks_per_sm(px["registers"])}
            if kname == "render_bwd_uniforms":
                times["render_bwd"][name]["uniforms"] = row
            else:
                times[kname][name] = row
        # K5 at the size the capsule chain's multiscale fit launches it
        # (1920x1080), both forms, against its plain version on the timed
        # cotangent, zeroed where the gradient is ill-conditioned.
        if name == "capsule_chain":
            g_cond = (g_rgb * conditioned(sc, prm, uni, t, full)).contiguous()
            mass = gradient_mass(sc, prm, uni, g_cond, t, sh, ao, full)
            for wrt in (False, True):
                got = render_kernel_backward_launch(sc, prm, uni, g_cond, t, sh, ao, full, wrt_uniforms=wrt)
                want = render_kernel_backward_plain(sc, prm, uni, g_cond, t, sh, ao, full, wrt_uniforms=wrt)
                torch.cuda.synchronize()
                st = check_grads(torch.cat(got) if wrt else got[0], torch.cat(want) if wrt else want[0],
                                 mass if wrt else mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME,
                                 label=f"{name} K5 1080p wrt_uniforms={wrt}")
                row = times["render_bwd"][name]
                (row["uniforms"] if wrt else row)["vs_plain_1080p"] = st
                errs_1080p.append(st["max_abs_err"])
        times["render_fwd"][name]["march_counts"] = {
            "mean_primary_steps": counts["primary"] / counts["pixels"], "mean_shadow_steps":
            counts["shadow"] / max(counts["shadow_rays"], 1.0), "shadow_rays": counts["shadow_rays"]}
        times["fit_step"][name]["bwd_values"] = built[name]["bwd_values"]
        log("scenes_13b_times_1080p", card=card, scene=name, costs=costs, counts=counts,
            **{k: v[name] for k, v in times.items()})
    main_launches = {"render_fwd": {n: main[f"render_batch {n}"]["render_kernel_forward"] for n in gallery},
                     "fit_step": {"capsule_chain": main["fit_l2"]["fit_step_kernel"]},
                     "render_bwd": {"capsule_chain": main["fit_multiscale_4_levels"]["render_kernel_backward"]}}
    out = {}
    for kname, per_scene in times.items():
        out[kname] = {"max_abs_err": max(errs[kname]), "scenes": per_scene}
        for n, launched in main_launches[kname].items():
            per_scene[n]["launches"] = launched
    out["render_bwd"]["max_abs_err_1080p"] = max(errs_1080p)
    return out


#: The over-relaxed march's factor in phases 37-39 (JAX's measured range is
#: 1.2-1.9; sdf3d_tpu/config.py).
OMEGA = 1.6
#: FP32 operations of one relaxed primary step around the distance
#: evaluation (render_kernel.cuh::march_primary): the failure test (a
#: compare, an abs, an add, a compare), the hit test, the step's two
#: products and selects, omega's select, t's add and the stop compare.
RELAXED_STEP = (12, 0)


def fractal_jobs(tt) -> list:
    """The library jobs of phase 37: the fractal's K1 in both forms, K3 with
    the plane frozen and its multiscale K3, and the relaxed march's K1-K4 on
    the reference scene and K1 on the fractal."""
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    relaxed = dataclasses.replace(full, march=dataclasses.replace(full.march, relaxation=OMEGA))
    kc, kc_point, kc_tiles, frozen = KernelConfig(), KernelConfig(ray_sdf=False), KernelConfig(tile_h=8, tile_w=128), \
        (0, 1, 2, 3)
    fractal, reference = tt.fractal_scene(), tt.reference_scene()
    return [library_job(fractal, full, kc), library_job(fractal, full, kc_point),
            library_job(fractal, full, kc, False, frozen), library_job(reference, relaxed, kc),
            library_job(reference, relaxed, kc_tiles), library_job(reference, relaxed, kc, False, frozen),
            library_job(reference, relaxed, kc_tiles, False, ()), library_job(fractal, relaxed, kc),
            library_job(fractal, full, kc, False, frozen, "full", 3)]  # the multiscale fit's K3


def loss_slice_jobs(tt) -> list:
    """The library jobs of phases 40-46: the fit demo's K3 with each loss
    branch and K4 at 8×128 tiles (phase 40's), its K1 under the black
    background and at those tiles (phase 41's), ``materials_scene``'s four
    (phase 44's)."""
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
    from sdf3d_tpu_torch.utils.parity import shaded_slots

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    black = dataclasses.replace(full, background=(0.0, 0.0, 0.0))
    kc, kc_point, kc_tiles = KernelConfig(), KernelConfig(ray_sdf=False), KernelConfig(tile_h=8, tile_w=128)
    frozen = (0, 1, 2, 3)
    sc0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25))
    jobs = [library_job(sc0, c, k, w, f, "full", lv, sil) for c, k, w, f, lv, sil in (
        (full, kc, False, frozen, 3, False), (full, kc, True, (), 3, False), (black, kc, False, frozen, 0, True),
        (black, kc, True, (), 0, True), (full, kc, True, (), 0, True), (full, kc_tiles, True, frozen, 3, False),
        (black, kc_tiles, True, frozen, 0, True))]
    jobs += [library_job(sc0, black, kc), library_job(sc0, full, kc_tiles), library_job(sc0, black, kc_tiles)]
    msc = tt.materials_scene()
    mslots = shaded_slots(msc)
    geometry = tuple(k for k in range(scene_param_vector(msc).numel()) if k not in mslots)
    return jobs + [library_job(msc, full, kc, True, ()), library_job(msc, full, kc, False, ()),
                   library_job(msc, full, kc, False, geometry), library_job(msc, full, kc_point, True, ())]


def fractal_phases(torch, tt, card: str, dev) -> dict:
    """Phases 37-39: the fractal (ROADMAP 13c: ``fractal_scene()``, a power-8
    Mandelbulb of six iterations on the ground plane) on K1, K3 and K5, and
    the over-relaxed march (ω = 1.6) on K1-K4, on the reference scene and
    the fractal.  Returns, per kernel entry of the kernels line
    (``render_fwd``, ``render_tiles``, ``fit_step``, ``fit_step_tiles``,
    ``render_bwd``), the fractal's and the relaxed march's launches, times,
    bound and error.  ``background``: library jobs of later phases, built in
    another thread during phases 38 and 39's checks and fits, finished
    before phase 39's times."""
    import torch.distributed as dist

    from sdf3d_tpu_torch import bench, cli
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import (
        fit_launcher,
        fit_step_kernel,
        fit_step_kernel_launch,
        fit_step_kernel_plain,
        fit_step_kernel_tiles,
        fit_step_kernel_tiles_launch,
        fit_step_kernel_tiles_plain,
    )
    from sdf3d_tpu_torch.ops.neural_kernel import render_neural_forward
    from sdf3d_tpu_torch.ops.render_bwd_kernel import (
        render_bwd_launcher,
        render_kernel_backward,
        render_kernel_backward_launch,
        render_kernel_backward_plain,
    )
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        library_job,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_forward_plain,
        render_kernel_launch,
        render_kernel_tiles_forward,
        render_kernel_tiles_forward_plain,
        render_kernel_tiles_launch,
        tile_pixel_planes,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.parallel import launch, make_mesh, render_sharded_kernel
    from sdf3d_tpu_torch.parallel.tile_queue import gather_target_tiles, plan_tiles
    from sdf3d_tpu_torch.utils.parity import (
        FLAGSHIP_SAME,
        SCENE_BARS,
        check_grads,
        check_planes,
        conditioned,
        fractal_fit_start,
        gradient_mass,
        primals_agree,
        razor_edge,
        rounding_decided,
    )

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)

    def relaxed(c):
        return dataclasses.replace(c, march=dataclasses.replace(c.march, relaxation=OMEGA))

    small = dataclasses.replace(full, width=256, height=192)
    ragged = dataclasses.replace(full, width=250, height=190)
    kc, kc_point = KernelConfig(), KernelConfig(ray_sdf=False)
    kc_tiles = KernelConfig(tile_h=8, tile_w=128)  # phase 18's tile at 256x192
    frozen = (0, 1, 2, 3)  # the ground plane
    ref_cam = tt.Camera.reference(device=dev)
    orbit = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)
    fractal, reference = tt.fractal_scene().to(dev), tt.reference_scene().to(dev)

    def start():  # the fit demo's start (phase 10)
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

    bar = SCENE_BARS.get("fractal", {})
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    counters = (render_kernel_forward, fit_step_kernel, render_kernel_backward, render_kernel_tiles_forward,
                fit_step_kernel_tiles, render_neural_forward)

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters}

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def planes_stats(st):
        return {n: {q: v.get(q) for q in ("over_atol", "max_abs_err", "over_hard")} for n, v in st.items()}

    def k1_check(sc, prm, uni, c, k, label, rounding=True):
        got, want = render_kernel_launch(sc, prm, uni, c, k), render_kernel_forward_plain(sc, prm, uni, c, k)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got), f"{label}: non-finite planes")
        witness = Witness(razor_edge, rounding_decided, sc, prm, uni, c, k) if rounding else (
            lambda: razor_edge(sc, prm, uni, c, k))
        try:
            st = check_planes(got, want, c.march.max_distance, label, razor=witness, **(bar if sc is fractal else {}))
        except AssertionError:
            log("fractal_k1_failed", label=label, worst=worst_pixels(torch, got, want, witness(), c.march.max_distance))
            raise
        return {**planes_stats(st), **getattr(witness, "counts", {})}

    # ---- 37. build: the fractal's and the relaxed march's libraries together
    # (in the whole smoke built already by the queue of phase 3) ----
    libs = _build.LIBRARIES
    builds0, seconds0 = libs.builds, libs.build_seconds
    jobs = fractal_jobs(tt)
    t0 = time.perf_counter()
    libs.load_many(jobs)
    build_wall = time.perf_counter() - t0
    header = cuda_scene_source(fractal, full, kc, False, frozen)
    ptxas = ptxas_summary(libs.log(libs.key(header)))
    check(set(ptxas) >= {"render_fwd", "fit_step", "render_bwd", "render_bwd_params"},
          f"fractal: ptxas reported {sorted(ptxas)}")
    for v in ptxas.values():
        v["blocks_per_sm"] = blocks_per_sm(v["registers"])
    render_ptxas = ptxas_summary(libs.log(libs.key(cuda_scene_source(fractal, full, kc))))["render_fwd"]
    relaxed_ptxas = {n: ptxas_summary(libs.log(libs.key(cuda_scene_source(sc, relaxed(full), kc))))["render_fwd"]
                     for n, sc in (("reference", reference), ("fractal", fractal))}
    bwd_values = int(header.split("bwd_values = ")[1].split(";")[0])
    # Another center and scale reuse the library: they are run-time parameters.
    before = libs.builds
    a = render_kernel_forward(fractal, ref_cam, light, mat, small, device=dev)[0]
    b = render_kernel_forward(fractal_fit_start(dev), ref_cam, light, mat, small, device=dev)[0]
    torch.cuda.synchronize()
    check(libs.builds == before, f"a moved Mandelbulb rebuilt a library ({libs.builds - before})")
    check(bool((a != b).any()), "moving the Mandelbulb did not change the image")
    log("fractal_build", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        build_wall_seconds=build_wall, libraries=len(jobs), bwd_values=bwd_values, header_bytes=len(header),
        ptxas=ptxas, render_fwd_ptxas=render_ptxas, relaxed_render_fwd_ptxas=relaxed_ptxas)

    # ---- 38. K1-K5 on the fractal, K1-K4 relaxed, against their plain versions ----
    errs = {"render_fwd": [], "fit_step": [], "render_bwd": [], "relaxed": [], "render_tiles": [],
            "fit_step_tiles": []}
    # The relaxed branch is one template for both forms: the ray form alone.
    # The fractal in both forms under the reference camera at 256x192 and
    # relaxed; the reference scene relaxed (exact: phase 3) under each
    # camera, at 256x192 and the ragged 250x190.
    cases = {"fractal": [(("reference", ref_cam), small, kc), (("reference", ref_cam), small, kc_point),
                         (("reference", ref_cam), relaxed(small), kc)],
             "reference": [(("reference", ref_cam), relaxed(small), kc), (("orbit30_15", orbit), relaxed(ragged), kc)]}
    for sc_name, sc in (("fractal", fractal), ("reference", reference)):
        for (cam_name, cm), c, k in cases[sc_name]:
            prm, uni = inputs(sc, cm, c)
            label = f"{sc_name} K1 {cam_name} {c.width}x{c.height} ray_sdf={k.ray_sdf} relaxation={c.march.relaxation}"
            st = k1_check(sc, prm, uni, c, k, label, rounding=sc is fractal)
            errs["relaxed" if c.march.relaxation != 1.0 else "render_fwd"].append(st["rgb"]["max_abs_err"])
            log("fractal_k1_parity", scene=sc_name, camera=cam_name, size=[c.width, c.height], ray_sdf=k.ray_sdf,
                relaxation=c.march.relaxation, **st)
    # K3 on the fractal's fit start (its own march against the plain version's,
    # and the plain reverse pass on K1's planes), K3 relaxed on the reference.
    for sc_name, sc, c, cm, wrt, fr in (("fractal", fractal_fit_start(dev), small, ref_cam, False, frozen),
                                       ("fractal", fractal_fit_start(dev), ragged, orbit, False, frozen),
                                       ("reference", start(), relaxed(small), orbit, False, frozen)):
        prm, uni = inputs(sc, cm, c)
        label = f"{sc_name} K3 {c.width}x{c.height} wrt_uniforms={wrt} relaxation={c.march.relaxation}"
        st = k3_against_plain(torch, sc, prm, uni, c, kc, wrt, fr, label, gen, rounding=True,
                              bar=bar if sc_name == "fractal" else None)
        errs["fit_step"].append(st["own_march"]["max_abs_err"])
        log("fractal_k3_parity", scene=sc_name, size=[c.width, c.height], wrt_uniforms=wrt, frozen=list(fr),
            relaxation=c.march.relaxation, **st)
    for c, cm in ((small, ref_cam), (ragged, orbit)):
        sc = fractal_fit_start(dev)
        prm, uni = inputs(sc, cm, c)
        _, t, sh, ao = render_kernel_launch(sc, prm, uni, c)
        g_rgb = (torch.randn((3, c.height, c.width), generator=gen, device=dev)
                 * conditioned(sc, prm, uni, t, c)).contiguous()
        mass = gradient_mass(sc, prm, uni, g_rgb, t, sh, ao, c)
        for wrt in (True, False):
            label = f"fractal K5 {c.width}x{c.height} wrt_uniforms={wrt}"
            got = render_kernel_backward_launch(sc, prm, uni, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
            want = render_kernel_backward_plain(sc, prm, uni, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
            torch.cuda.synchronize()
            st = check_grads(torch.cat(got) if wrt else got[0], torch.cat(want) if wrt else want[0],
                             mass if wrt else mass[:prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME, label=label)
            errs["render_bwd"].append(st["max_abs_err"])
            log("fractal_k5_parity", size=[c.width, c.height], wrt_uniforms=wrt, **st)
    # K2 and K4 relaxed on a 4-rank plan at 256x192 (phase 18's tile) against
    # the plain tile versions, each side's own render as the target where the
    # gradient is ill-conditioned or the primals disagree (k3_against_plain).
    sc, c = start(), relaxed(small)
    prm, uni = inputs(sc, orbit, c)
    plan = plan_tiles(c.height, c.width, kc_tiles.tile_h, kc_tiles.tile_w, 4)
    rgb, t, sh, ao = render_kernel_launch(sc, prm, uni, c)
    own = render_kernel_forward_plain(sc, prm, uni, c)
    keep = conditioned(sc, prm, uni, t, c) & primals_agree((rgb, t, sh, ao), own, c.march.max_distance)
    noisy = rgb + torch.rand(rgb.shape, generator=gen, device=dev) * 0.2 - 0.1
    target, p_target = (torch.where(keep, noisy, x).contiguous() for x in (rgb, own[0]))
    stacks, p_stacks = gather_target_tiles(target, plan), gather_target_tiles(p_target, plan)
    tiles_st = []
    for rank in range(4):
        trow, tcol = plan.tables(rank, dev)
        k2 = render_kernel_tiles_launch(sc, prm, uni, trow, tcol, c, kc_tiles)
        p2 = render_kernel_tiles_forward_plain(sc, prm, uni, trow, tcol, c, kc_tiles)
        k4 = fit_step_kernel_tiles_launch(sc, prm, uni, stacks[rank].contiguous(), trow, tcol, c, kc_tiles, False,
                                          frozen)
        p4 = fit_step_kernel_tiles_plain(sc, prm, uni, p_stacks[rank].contiguous(), trow, tcol, c, kc_tiles, False,
                                         frozen)
        torch.cuda.synchronize()
        pixels = tile_pixel_planes(trow, tcol, kc_tiles.tile_h, kc_tiles.tile_w)
        st2 = check_planes(k2, p2, c.march.max_distance, f"relaxed K2 rank {rank}",
                           razor=functools.partial(razor_edge, sc, prm, uni, c, kc_tiles, pixels))
        rel = abs(float(k4[0]) / float(p4[0]) - 1.0)
        check(rel <= 1e-5, f"relaxed K4 rank {rank}: loss off the plain version's by {rel:.3g}")
        g_err = float((k4[1] - p4[1]).abs().max())
        errs["render_tiles"].append(st2["rgb"]["max_abs_err"])
        errs["fit_step_tiles"].append(g_err)
        tiles_st.append({"k2": planes_stats(st2), "k4_loss_rel_err": rel, "k4_grad_max_abs_err": g_err})
    log("fractal_tiles_relaxed_parity", ranks=4, tiles=plan.tiles_per_device, stats=tiles_st)

    # ---- 39. main path at 1920x1080 ----
    orbit4 = [tt.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0, device=dev) for i in range(4)]
    target = render_kernel_forward(fractal, ref_cam, light, mat, full, device=dev)[0]
    ref_target = render_kernel_forward(reference, ref_cam, light, mat, relaxed(full), device=dev)[0]
    lr, trainable = 1e-3, (False, False, True, True)
    main = {}
    with PlainCalls() as plain, BackwardModes() as modes:
        reset()
        frames = tt.render_batch(fractal, orbit4, light, mat, full, engine="kernel")
        torch.cuda.synchronize()
        main["render_batch"] = launches()
        with tempfile.TemporaryDirectory() as tmp:
            png = os.path.join(tmp, "fractal.png")
            check(cli.main(["render", "--scene", "fractal", "--width", str(W), "--height", str(H), "--out", png]) == 0,
                  "cli render --scene fractal failed")
            with open(png, "rb") as f:
                head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == W.to_bytes(4, "big") + H.to_bytes(4, "big"),
              "cli render --scene fractal did not write a 1920x1080 PNG")
        main["render_with_cli"] = launches()
        reset()
        l2 = fit_scene(target, fractal_fit_start(dev), ref_cam, light, mat, full,
                       FitConfig(steps=20, learning_rate=lr, log_every=1), trainable=trainable, device=dev)
        main["fit_l2"] = launches()
        reset()
        ms = fit_scene(target, fractal_fit_start(dev), ref_cam, light, mat, full,
                       FitConfig(steps=5, learning_rate=lr, log_every=1, loss="multiscale"), trainable=trainable,
                       device=dev)
        main["fit_multiscale"] = launches()
        reset()
        ms4 = fit_scene(target, fractal_fit_start(dev), ref_cam, light, mat, full,
                        FitConfig(steps=5, learning_rate=lr, log_every=1, loss="multiscale", pyramid_levels=4),
                        trainable=trainable, device=dev)
        main["fit_multiscale_4_levels"] = launches()
        ms_modes = list(modes.calls[-5:])
        reset()
        frames_relaxed = {n: tt.render_batch(sc, orbit4, light, mat, relaxed(full), engine="kernel")
                          for n, sc in (("reference", reference), ("fractal", fractal))}
        torch.cuda.synchronize()
        main["render_batch_relaxed"] = launches()
        reset()
        rl2 = fit_scene(ref_target, start(), ref_cam, light, mat, relaxed(full),
                        FitConfig(steps=20, learning_rate=1e-2, log_every=1), trainable=(False, False, True, True),
                        device=dev)
        main["fit_l2_relaxed"] = launches()
        launch.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
        try:
            mesh = make_mesh()
            check(dist.get_backend() == "nccl" and mesh.size == 1, f"mesh {mesh}")
            reset()
            tiles = fit_scene(ref_target, start(), ref_cam, light, mat, relaxed(full),
                              FitConfig(steps=20, learning_rate=1e-2, log_every=1, shard_layout="tiles"), mesh=mesh,
                              trainable=(False, False, True, True))
            main["fit_mesh_tiles_relaxed"] = launches()
            reset()
            sharded = render_sharded_kernel(reference, ref_cam, light, mat, relaxed(full), mesh, kc, layout="tiles",
                                            planar=True)
            torch.cuda.synchronize()
            main["render_sharded_tiles_relaxed"] = launches()
        finally:
            launch.shutdown()
        cells = {}
        for mode in ("fwd", "fwd_bwd"):
            reset()
            r = bench.run_benchmark(scene_name="fractal", mode=mode, iters=2, frames_per_dispatch=4)
            cells[mode] = {**r, "launches": launches()}
    check(sum(plain.calls.values()) == 0, f"the fractal's main path called plain versions: {plain.calls}")
    zero = {fn.__name__: 0 for fn in counters}
    want_counts = {
        "render_batch": {**zero, "render_kernel_forward": 4},
        "render_with_cli": {**zero, "render_kernel_forward": 5},
        "fit_l2": {**zero, "fit_step_kernel": 20},
        "fit_multiscale": {**zero, "fit_step_kernel": 5},
        "fit_multiscale_4_levels": {**zero, "render_kernel_forward": 5, "render_kernel_backward": 5},
        "render_batch_relaxed": {**zero, "render_kernel_forward": 8},
        "fit_l2_relaxed": {**zero, "fit_step_kernel": 20},
        "fit_mesh_tiles_relaxed": {**zero, "fit_step_kernel_tiles": 20},
        "render_sharded_tiles_relaxed": {**zero, "render_kernel_tiles_forward": 1},
    }
    for name, want in want_counts.items():
        check(main[name] == want, f"fractal {name} launched {main[name]}, expected {want}")
    check(ms_modes == [False] * 5, f"the 4-level multiscale fit's K5 asked for wrt_uniforms {ms_modes}")
    for mode, counter in (("fwd", "render_kernel_forward"), ("fwd_bwd", "fit_step_kernel")):
        got = cells[mode]["launches"]
        check(got[counter] > 0 and sum(got.values()) == got[counter] and cells[mode]["value"] > 0,
              f"bench fractal {mode}: {cells[mode]}")
    check(tuple(frames.shape) == (4, H, W, 3) and bool(torch.isfinite(frames).all()), "bad fractal frames")
    for name, res in (("l2", l2), ("multiscale", ms), ("multiscale_4_levels", ms4), ("l2_relaxed", rl2),
                      ("mesh_tiles_relaxed", tiles)):
        check(all(math.isfinite(v) for v in res.losses), f"fractal {name} fit: non-finite loss")
        check(res.losses[-1] < res.losses[0], f"fractal {name} fit: the loss did not fall "
                                              f"({res.losses[0]} -> {res.losses[-1]})")
    tiles_rel = max(abs(a / b - 1.0) for a, b in zip(tiles.losses, rl2.losses))
    check(tiles_rel <= 1e-5, f"relaxed fit_scene(mesh, tiles): losses off the unsharded fit's by {tiles_rel:.3g}")
    frame0 = {}
    # Frame 0 of the fractal's batch and of the relaxed reference scene's,
    # each K1's launch bit for bit; the relaxed reference frame against its
    # plain version (the fractal's K1 at 1080p is held to its plain version
    # in step 0's primal below, the relaxed fractal in phase 38).
    for name, sc, c, fr in (("fractal", fractal, full, frames[0]),
                            ("reference_relaxed", reference, relaxed(full), frames_relaxed["reference"][0])):
        prm0, uni0 = inputs(sc, orbit4[0], c)
        if sc is not fractal:
            frame0[name] = k1_check(sc, prm0, uni0, c, kc, f"{name} 1080p frame 0", rounding=False)
        torch.testing.assert_close(render_kernel_launch(sc, prm0, uni0, c)[0].permute(1, 2, 0), fr, rtol=0, atol=0)
    ref_prm, ref_uni = inputs(reference, ref_cam, relaxed(full))
    k1_ref = render_kernel_launch(reference, ref_prm, ref_uni, relaxed(full))
    sharded_st = check_planes((sharded,), k1_ref[:1], full.march.max_distance, "relaxed render_sharded_kernel vs K1",
                              razor=functools.partial(razor_edge, reference, ref_prm, ref_uni, relaxed(full)))
    # JAX's reverse pass of the Mandelbulb is NaN near its escape boundaries,
    # where the escape selects' untaken branch overflows; the port's clamp
    # (sdf/primitives.py::mandelbulb_de) keeps the fit start's gradient
    # finite at 1080p (ROADMAP Queue 3).
    prm0, uni0 = inputs(fractal_fit_start(dev), ref_cam, full)
    nonfinite_start = int((~torch.isfinite(torch.cat(fit_step_kernel_launch(
        fractal_fit_start(dev), prm0, uni0, target.permute(2, 0, 1).contiguous(), full, kc, False, frozen)[1:]))).sum())
    check(nonfinite_start == 0, f"fractal fit start: {nonfinite_start} non-finite gradient slots")
    step0 = k3_against_plain(torch, fractal_fit_start(dev), scene_param_vector(fractal_fit_start(dev), dev), uni0,
                             full, kc, False, frozen, "fractal K3 1080p step 0", gen,
                             target.permute(2, 0, 1).contiguous(), rounding=True, bar=bar)
    errs["fit_step"].append(step0["own_march"]["max_abs_err"])
    log("fractal_main_path", launches=main, multiscale_render_bwd_wrt_uniforms=ms_modes, frame0=frame0,
        l2_losses=l2.losses, multiscale_losses=ms.losses, fitted=scene_param_vector(l2.scene).tolist(),
        target=scene_param_vector(fractal).tolist(), start_nonfinite_gradient_slots=nonfinite_start,
        relaxed_l2_losses=rl2.losses,
        relaxed_mesh_tiles_losses_equal=tiles.losses == rl2.losses, relaxed_mesh_tiles_loss_rel_err=tiles_rel,
        relaxed_render_sharded_vs_k1=sharded_st["rgb"], step0=step0, bench=cells)

    # Times at 1080p, the reference camera (plain, kernel, kernel, plain): the
    # fractal's K1, K3 (the plane frozen) and both K5 forms against its
    # render dimmed by 5%; K1 relaxed beside K1 exact on both scenes, in
    # turns (exact, relaxed, relaxed, exact); bounds on this run's marches.
    blocks = -(-W // kc.block_w) * -(-H // kc.block_h)
    prm, uni = inputs(fractal, ref_cam, full)
    rgb, t, sh, ao = render_kernel_launch(fractal, prm, uni, full)
    tgt = (rgb * 0.95).contiguous()
    g_rgb = (2.0 * (rgb - tgt)).contiguous()
    timed = {"render_fwd": (lambda: render_kernel_launch(fractal, prm, uni, full),
                            lambda: render_kernel_forward_plain(fractal, prm, uni, full)),
             "fit_step": (fit_launcher(fractal, prm, uni, tgt, full, kc, False, frozen)[0],
                          lambda: fit_step_kernel_plain(fractal, prm, uni, tgt, full, kc, False, frozen))}
    for form, wrt in (("render_bwd", False), ("render_bwd_uniforms", True)):
        timed[form] = (render_bwd_launcher(fractal, prm, uni, g_rgb, t, sh, ao, full, kc, wrt)[0],
                       functools.partial(render_kernel_backward_plain, fractal, prm, uni, g_rgb, t, sh, ao, full,
                                         wrt_uniforms=wrt))
    counts = march_counts(torch, fractal, ref_cam, full, prm, uni, render_kernel_forward_plain)
    costs = scene_costs(header)
    P = prm.numel()
    bounds = {
        "render_fwd": bound(*analytic_work(costs, counts, full), 24 * W * H),
        "fit_step": bound(*analytic_work(costs, counts, full, reverse=True), 12 * W * H + 8 * (P + 31)),
        "render_bwd": bound(*analytic_work(costs, counts, full, primal=False, reverse=True, retrace=True),
                            24 * W * H + (8 * blocks + 8) * P),
        "render_bwd_uniforms": bound(*analytic_work(costs, counts, full, primal=False, reverse=True, retrace=True),
                                     24 * W * H + (8 * blocks + 8) * (P + 30)),
    }
    times = {}
    for kname, (kern, plain_fn) in timed.items():
        kern()
        torch.cuda.synchronize()
        # The plain version once: seconds a call at 1080p on the fractal.
        p1, k1_, k2_ = time_ms(plain_fn, 0, 1), time_ms(kern), time_ms(kern)
        px = {"render_fwd": render_ptxas, "fit_step": ptxas["fit_step"], "render_bwd": ptxas["render_bwd_params"],
              "render_bwd_uniforms": ptxas["render_bwd"]}[kname]
        times[kname] = {"ms": (k1_ + k2_) / 2, "ms_runs": [k1_, k2_], "plain_ms": p1,
                        "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
                        "registers": px["registers"], "spill_stores": px.get("spill_stores"),
                        "spill_loads": px.get("spill_loads"), "blocks_per_sm": blocks_per_sm(px["registers"])}
    # K5 at the size the multiscale fit launches it, both forms, against its
    # plain version on the timed cotangent, zeroed where ill-conditioned.
    g_cond = (g_rgb * conditioned(fractal, prm, uni, t, full)).contiguous()
    mass = gradient_mass(fractal, prm, uni, g_cond, t, sh, ao, full)
    for wrt, key in ((False, "render_bwd"), (True, "render_bwd_uniforms")):
        got = render_kernel_backward_launch(fractal, prm, uni, g_cond, t, sh, ao, full, wrt_uniforms=wrt)
        want = render_kernel_backward_plain(fractal, prm, uni, g_cond, t, sh, ao, full, wrt_uniforms=wrt)
        torch.cuda.synchronize()
        times[key]["vs_plain_1080p"] = check_grads(torch.cat(got) if wrt else got[0],
                                                   torch.cat(want) if wrt else want[0],
                                                   mass if wrt else mass[:P], rtol=1e-4, mass_tol=FLAGSHIP_SAME,
                                                   label=f"fractal K5 1080p wrt_uniforms={wrt}")
    times["render_fwd"]["march_counts"] = {
        "mean_primary_steps": counts["primary"] / counts["pixels"],
        "mean_shadow_steps": counts["shadow"] / max(counts["shadow_rays"], 1.0), "shadow_rays": counts["shadow_rays"]}
    times["fit_step"]["bwd_values"] = bwd_values
    relaxed_times = {}
    for name, sc in (("reference", reference), ("fractal", fractal)):
        prm_r, uni_r = inputs(sc, ref_cam, full)
        exact = lambda: render_kernel_launch(sc, prm_r, uni_r, full)  # noqa: E731
        relax = lambda: render_kernel_launch(sc, prm_r, uni_r, relaxed(full))  # noqa: E731
        relax()
        torch.cuda.synchronize()
        e1, r1, r2, e2 = time_ms(exact), time_ms(relax), time_ms(relax), time_ms(exact)
        # The fractal's exact marches are the bounds' above (the same inputs).
        ec = counts if sc is fractal else march_counts(torch, sc, ref_cam, full, prm_r, uni_r,
                                                       render_kernel_forward_plain)
        rc = march_counts(torch, sc, ref_cam, relaxed(full), prm_r, uni_r, render_kernel_forward_plain)
        fp, sfu = analytic_work(scene_costs(cuda_scene_source(sc, relaxed(full), kc)), rc, full)
        rbound = bound(fp + rc["primary"] * (RELAXED_STEP[0] - PRIMARY_STEP[0]), sfu, 24 * W * H)
        pr = time_ms(lambda: render_kernel_forward_plain(sc, prm_r, uni_r, relaxed(full)), 0, 1)
        relaxed_times[name] = {"ms": (r1 + r2) / 2, "ms_runs": [r1, r2], "exact_ms": (e1 + e2) / 2,
                               "exact_ms_runs": [e1, e2], "plain_ms": pr, "bound_ms": rbound[0],
                               "bound_by": rbound[1], "registers": relaxed_ptxas[name]["registers"],
                               "mean_primary_steps": rc["primary"] / rc["pixels"],
                               "mean_primary_steps_exact": ec["primary"] / ec["pixels"]}
    # K2 over the 135-tile plan of phase 21 on the reference scene, relaxed
    # beside exact, in turns.
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1)
    trow, tcol = plan.tables(0, dev)
    prm_r, uni_r = inputs(reference, ref_cam, full)
    exact2 = lambda: render_kernel_tiles_launch(reference, prm_r, uni_r, trow, tcol, full, kc)  # noqa: E731
    relax2 = lambda: render_kernel_tiles_launch(reference, prm_r, uni_r, trow, tcol, relaxed(full), kc)  # noqa: E731
    relax2()
    torch.cuda.synchronize()
    e1, r1, r2, e2 = time_ms(exact2), time_ms(relax2), time_ms(relax2), time_ms(exact2)
    relaxed_times["reference_tiles"] = {"ms": (r1 + r2) / 2, "ms_runs": [r1, r2], "exact_ms": (e1 + e2) / 2,
                                        "exact_ms_runs": [e1, e2], "tiles": plan.tiles_per_device}
    log("fractal_times_1080p", card=card, costs=costs, counts=counts, times=times, relaxed=relaxed_times)

    out = {
        "render_fwd": {**times["render_fwd"], "launches": main["render_batch"]["render_kernel_forward"],
                       "max_abs_err": max(errs["render_fwd"])},
        "fit_step": {**times["fit_step"], "launches": main["fit_l2"]["fit_step_kernel"],
                     "max_abs_err": max(errs["fit_step"])},
        "render_bwd": {**times["render_bwd"], "uniforms": times["render_bwd_uniforms"],
                       "launches": main["fit_multiscale_4_levels"]["render_kernel_backward"],
                       "max_abs_err": max(errs["render_bwd"])},
    }
    relaxed_out = {
        "render_fwd": {"omega": OMEGA, "scenes": relaxed_times,
                       "launches": main["render_batch_relaxed"]["render_kernel_forward"],
                       "max_abs_err": max(errs["relaxed"])},
        "render_tiles": {"omega": OMEGA, "launches": main["render_sharded_tiles_relaxed"]["render_kernel_tiles_forward"],
                         "max_abs_err": max(errs["render_tiles"]), **relaxed_times.pop("reference_tiles")},
        "fit_step": {"omega": OMEGA, "launches": main["fit_l2_relaxed"]["fit_step_kernel"]},
        "fit_step_tiles": {"omega": OMEGA, "launches": main["fit_mesh_tiles_relaxed"]["fit_step_kernel_tiles"],
                           "max_abs_err": max(errs["fit_step_tiles"])},
    }
    return {"fractal": out, "relaxed": relaxed_out}


#: The fit step's loss branches (ROADMAP 12a) as ``fit_step_kernel``'s options.
LOSS_BRANCHES = {"multiscale": dict(loss_kind="multiscale", levels=3), "silhouette": dict(sil_w=0.5)}


def branch_work(costs: dict, counts: dict, levels: int, silhouette: bool) -> tuple:
    """``(FP32, special-function)`` operations the loss branches add to the
    fit step's floor (:func:`analytic_work`): the min-SDF tracker's compare
    and two selects a primary step, and a pixel's reverse evaluation
    (``sdf_bwd``) at its argmin and its sigmoid (an exp and two divisions);
    the pyramid's three cotangent adds a pixel and level."""
    n = counts["pixels"]
    fp = 9.0 * n * levels
    sfu = 0.0
    if silhouette:
        f, s_ = costs["bwd"]
        fp += 3.0 * counts["primary"] + n * (f + 12.0)
        sfu += n * (s_ + 3.0)
    return fp, sfu


def branch_plain_opts(opts: dict, cov) -> dict:
    """``_fit_step_plain``'s loss options of ``fit_step_kernel``'s ``opts``."""
    sil_w = opts.get("sil_w", 0.0)
    return dict(levels=opts.get("levels", 0), coverage=cov if sil_w else None, sil_w=sil_w)


def k3_branch_vs_plain(torch, opts, sc, prm, uni, c, kc, wrt, fr, label, base, cov, same_tol=None,
                       own_tol=1e-3) -> dict:
    """K3 with the loss options ``opts`` against the plain step on K1's
    planes (1e-5 of the whole loss's gradient mass; 1e-4 with the coverage
    term, whose plain version tracks its own march) and the plain version
    marching its own primal (1e-3); the losses 1e-5 relative.  The target:
    ``base`` where the gradient is well conditioned (whole pyramid groups of
    such pixels; ``utils/parity.py::fit_targets``), each side's own render
    elsewhere."""
    from sdf3d_tpu_torch.ops.fit_kernel import _fit_step_plain, fit_step_kernel_launch, fit_step_kernel_plain
    from sdf3d_tpu_torch.ops.render_kernel import pixel_planes, render_kernel_forward_plain, render_kernel_launch
    from sdf3d_tpu_torch.utils.parity import check_grads, fit_targets, loss_mass

    rgb, t, sh, ao = planes = render_kernel_launch(sc, prm, uni, c)
    own_planes = render_kernel_forward_plain(sc, prm, uni, c)
    target, p_target = fit_targets(base, planes, own_planes, sc, prm, uni, c, opts.get("levels", 0))
    got = fit_step_kernel_launch(sc, prm, uni, target, c, kc, wrt, fr, target_coverage=cov, **opts)
    po = branch_plain_opts(opts, cov)
    same = _fit_step_plain(sc, prm, uni, target, c, kc, wrt, fr, pixel_planes(uni, c.height, c.width),
                           planes=(t, sh, ao), **po)
    own = fit_step_kernel_plain(sc, prm, uni, p_target, c, kc, wrt, fr, target_coverage=cov, **opts)
    torch.cuda.synchronize()
    mass = loss_mass(sc, prm, uni, rgb, target, t, sh, ao, c, po["levels"], po["coverage"], po["sil_w"])
    g = torch.cat(got[1:])
    check(bool(torch.isfinite(g).all()) and math.isfinite(float(got[0])), f"{label}: a non-finite total")
    rel = abs(float(got[0]) / float(same[0]) - 1.0)
    own_rel = abs(float(got[0]) / float(own[0]) - 1.0)
    check(rel <= 1e-5 and own_rel <= 1e-5, f"{label}: loss off the plain step's by {rel:.3g} / {own_rel:.3g}")
    check(all(float(got[1][q]) == 0.0 for q in fr), f"{label}: a frozen slot's gradient is not 0")
    check(wrt or float(got[2].abs().max()) == 0.0, f"{label}: uniform gradients without wrt_uniforms")
    return {"loss_rel_err": rel, "own_march_loss_rel_err": own_rel,
            "pixels_left_out": int((target != p_target).any(0).sum()),
            "same_planes": check_grads(g, torch.cat(same[1:]), mass, rtol=1e-4,
                                       mass_tol=same_tol or (1e-4 if po["sil_w"] else 1e-5), label=f"{label} (same)"),
            "own_march": check_grads(g, torch.cat(own[1:]), mass, rtol=1e-4, mass_tol=own_tol, label=label)}


def loss_phases(torch, tt, card: str, dev) -> dict:
    """Phases 40-43: the fit kernel's loss branches (ROADMAP 12a) in K3 and
    K4, the multiscale pyramid and the silhouette coverage term, and the
    entry points that take them: ``fit_scene`` unsharded and sharded,
    ``fit_view``, ``cli fit-view``.  Returns the ``multiscale``,
    ``silhouette`` and ``view`` entries of the kernels line's ``fit_step``
    and the first two of its ``fit_step_tiles``."""
    import contextlib
    import io

    import torch.distributed as dist

    from sdf3d_tpu_torch import cli
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene, fit_view
    from sdf3d_tpu_torch.march import ray_min_sdf
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import (
        fit_launcher,
        fit_step_kernel,
        fit_step_kernel_launch,
        fit_step_kernel_plain,
        fit_step_kernel_tiles,
        fit_step_kernel_tiles_launch,
        fit_step_kernel_tiles_plain,
    )
    from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        library_job,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_forward_plain,
        render_kernel_launch,
        render_kernel_tiles_forward,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.parallel import launch, make_mesh
    from sdf3d_tpu_torch.parallel.tile_queue import gather_target_tiles, plan_tiles
    from sdf3d_tpu_torch.sdf.transforms import rotvec_to_matrix
    from sdf3d_tpu_torch.utils.parity import (
        FLAGSHIP_OWN,
        FLAGSHIP_SAME,
        check_grads,
        fit_targets,
        flagship_fit_start,
        fractal_fit_start,
        loss_mass,
    )

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    black = dataclasses.replace(full, background=(0.0, 0.0, 0.0))
    kc, kc_tiles = KernelConfig(), KernelConfig(tile_h=8, tile_w=128)
    frozen, trainable = (0, 1, 2, 3), (False, False, True, True)
    eps = full.march.epsilon
    beta = eps / 2.5
    ref_cam = tt.Camera.reference(device=dev)
    orbit = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)
    reference = tt.reference_scene().to(dev)
    counters = (render_kernel_forward, fit_step_kernel, render_kernel_backward, render_kernel_tiles_forward,
                fit_step_kernel_tiles)

    def start():  # the fit demo's start (phase 10)
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters if fn.launches}

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def cfg_of(branch, c):
        return dataclasses.replace(c, background=(0.0, 0.0, 0.0)) if branch == "silhouette" else c

    def reference_target(cam, c, scene_true=None):
        """The reference scene's render (or ``scene_true``'s; planar, on the
        card) and its object mask off the black background."""
        scene_true = reference if scene_true is None else scene_true
        prm, uni = inputs(scene_true, cam, c)
        rgb = render_kernel_launch(scene_true, prm, uni, c)[0].contiguous()
        return rgb, (rgb.abs().amax(0) > 1e-3).to(torch.float32).contiguous()

    def k3_vs_plain(opts, sc, cam, c, wrt, fr, label, base, cov, same_tol=None, own_tol=1e-3):
        prm, uni = inputs(sc, cam, c)
        return k3_branch_vs_plain(torch, opts, sc, prm, uni, c, kc, wrt, fr, label, base, cov, same_tol, own_tol)

    # ---- 40. build: the loss branches' libraries together ----
    libs = _build.LIBRARIES
    builds0, seconds0 = libs.builds, libs.build_seconds
    sc0 = start()
    settings = {  # name: (config, kernel config, wrt_uniforms, frozen, levels, silhouette)
        "multiscale": (full, kc, False, frozen, 3, False), "multiscale_uniforms": (full, kc, True, (), 3, False),
        "silhouette": (black, kc, False, frozen, 0, True), "silhouette_uniforms": (black, kc, True, (), 0, True),
        "view": (full, kc, True, (), 0, True), "multiscale_tiles": (full, kc_tiles, True, frozen, 3, False),
        "silhouette_tiles": (black, kc_tiles, True, frozen, 0, True),
    }
    t0 = time.perf_counter()
    libs.load_many([library_job(sc0, c, k, w, f, "full", lv, sil) for c, k, w, f, lv, sil in settings.values()] +
                   [library_job(sc0, full, kc, False, frozen)])  # the plain-L2 K3 (phase 7's), beside them
    build_wall = time.perf_counter() - t0
    ptxas = {}
    for name, (c, k, w, f, lv, sil) in settings.items():
        p = ptxas_summary(libs.log(libs.key(cuda_scene_source(sc0, c, k, w, f, "full", lv, sil))))["fit_step"]
        ptxas[name] = {**p, "blocks_per_sm": blocks_per_sm(p["registers"])}
    l2_ptxas = ptxas_summary(libs.log(libs.key(cuda_scene_source(sc0, full, kc, False, frozen))))["fit_step"]
    ptxas["l2"] = {**l2_ptxas, "blocks_per_sm": blocks_per_sm(l2_ptxas["registers"])}
    log("loss_build", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        build_wall_seconds=build_wall, libraries=len(settings), ptxas=ptxas)

    # ---- 41. K3 and K4 with each branch against their plain versions ----
    small = dataclasses.replace(full, width=256, height=192)
    ragged = dataclasses.replace(full, width=250, height=190)
    errs = {"multiscale": [], "silhouette": [], "view": [], "multiscale_tiles": [], "silhouette_tiles": []}
    for branch in LOSS_BRANCHES:
        for c0, cam_name, cam, wrt, fr in ((small, "orbit30_15", orbit, False, frozen),
                                           (small, "reference", ref_cam, True, ()),
                                           (ragged, "orbit30_15", orbit, True, ())):
            c = cfg_of(branch, c0)
            target, cov = reference_target(cam, c)
            label = f"K3 {branch} {c.width}x{c.height} {cam_name} wrt_uniforms={wrt}"
            st = k3_vs_plain(LOSS_BRANCHES[branch], start(), cam, c, wrt, fr, label, target, cov)
            errs[branch].append(st["own_march"]["max_abs_err"])
            log("loss_k3_small", branch=branch, size=[c.width, c.height], camera=cam_name, wrt_uniforms=wrt, **st)
        # K4 over a balanced 4-rank plan of 8x128 tiles: each work-list
        # against its plain version, the sum against K3.
        c = cfg_of(branch, small)
        base, cov = reference_target(orbit, c)
        work = torch.rand((c.height // 8, c.width // 128), generator=torch.Generator().manual_seed(1)).numpy()
        plan = plan_tiles(c.height, c.width, 8, 128, 4, "balanced", work)
        sc = start()
        prm, uni = inputs(sc, orbit, c)
        opts = LOSS_BRANCHES[branch]
        rgb, t, sh, ao = planes = render_kernel_launch(sc, prm, uni, c, kc_tiles)
        target, p_target = fit_targets(base, planes, render_kernel_forward_plain(sc, prm, uni, c, kc_tiles), sc, prm,
                                       uni, c, opts.get("levels", 0))
        stacks, p_stacks = (gather_target_tiles(torch.cat([x, cov[None]]), plan) for x in (target, p_target))
        po = branch_plain_opts(opts, cov)
        mass = loss_mass(sc, prm, uni, rgb, target, t, sh, ao, c, po["levels"], po["coverage"], po["sil_w"])
        total, ranks = None, []
        for r in range(4):
            trow, tcol = plan.tables(r, dev)
            s_, p_s = stacks[r], p_stacks[r]
            got = fit_step_kernel_tiles_launch(sc, prm, uni, s_[:3].contiguous(), trow, tcol, c, kc_tiles, True, frozen,
                                               coverage_tiles=s_[3].contiguous(), **opts)
            want = fit_step_kernel_tiles_plain(sc, prm, uni, p_s[:3].contiguous(), trow, tcol, c, kc_tiles, True,
                                               frozen, coverage_tiles=p_s[3].contiguous(), **opts)
            torch.cuda.synchronize()
            rel = abs(float(got[0]) / float(want[0]) - 1.0) if float(want[0]) else abs(float(got[0]))
            check(rel <= 1e-5, f"K4 {branch} rank {r}: loss off the plain version's by {rel:.3g}")
            ranks.append(check_grads(torch.cat(got[1:]), torch.cat(want[1:]), mass, rtol=1e-4, mass_tol=1e-3,
                                     label=f"K4 {branch} rank {r}"))
            errs[f"{branch}_tiles"].append(ranks[-1]["max_abs_err"])
            total = got if total is None else tuple(a + b for a, b in zip(total, got))
        whole = fit_step_kernel_launch(sc, prm, uni, target, c, kc_tiles, True, frozen, target_coverage=cov, **opts)
        k3_rel = abs(float(total[0]) / float(whole[0]) - 1.0)
        check(k3_rel <= 1e-5, f"K4 {branch}: the plan's loss off K3's by {k3_rel:.3g}")
        vs_k3 = check_grads(torch.cat(total[1:]), torch.cat(whole[1:]), mass, rtol=1e-4, mass_tol=1e-4,
                            label=f"K4 {branch} summed vs K3")
        log("loss_k4_small", branch=branch, ranks=ranks, loss_rel_err_vs_k3=k3_rel, vs_k3=vs_k3)

    # ---- 42. main path at 1920x1080 ----
    target_full = render_kernel_forward(reference, ref_cam, light, mat, full, device=dev)[0]
    target_black = render_kernel_forward(reference, ref_cam, light, mat, black, device=dev)[0]
    pert = 0.06
    rot = rotvec_to_matrix(pert * torch.tensor([0.3, 0.8, -0.3], device=dev))
    cam0 = tt.Camera(position=ref_cam.position + pert * torch.tensor([1.0, -0.7, 1.3], device=dev),
                     c2w=(rot[:, :, None] * ref_cam.c2w[None, :, :]).sum(1), fov_deg=ref_cam.fov_deg)
    o, d = tt.camera_rays(ref_cam, W, H, full.ray_mode)
    cov_true = torch.sigmoid((2.0 * eps - ray_min_sdf(reference.distance, o, d, full.march)[0]) / beta).contiguous()
    main, fits = {}, {}
    with PlainCalls() as plain:
        for name, tgt, c, extra in (("multiscale", target_full, full, dict(loss="multiscale")),
                                    ("silhouette", target_black, black, dict(silhouette_weight=0.5))):
            reset()
            t0 = time.perf_counter()
            fits[name] = fit_scene(tgt, start(), ref_cam, light, mat, c,
                                   FitConfig(steps=20, learning_rate=1e-2, log_every=1, **extra), trainable=trainable,
                                   device=dev)
            fits[name].seconds = time.perf_counter() - t0
            main[name] = launches()
        launch.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
        try:
            mesh = make_mesh()
            check(dist.get_backend() == "nccl" and mesh.size == 1, f"mesh {mesh}")
            for name, tgt, c, extra in (("multiscale", target_full, full, dict(loss="multiscale")),
                                        ("silhouette", target_black, black, dict(silhouette_weight=0.5))):
                reset()
                fits[f"{name}_tiles"] = fit_scene(tgt, start(), ref_cam, light, mat, c,
                                                  FitConfig(steps=20, learning_rate=1e-2, log_every=1,
                                                            shard_layout="tiles", **extra),
                                                  mesh=mesh, trainable=trainable)
                main[f"{name}_tiles"] = launches()
        finally:
            launch.shutdown()
        reset()
        t0 = time.perf_counter()
        # 200 steps, as cli fit-view: over the first 20 the loss falls while the
        # position error still rises (0.107 -> 0.134 at 192x108 on the CPU).
        view = fit_view(target_full, reference, cam0, light, mat, full,
                        FitConfig(steps=200, learning_rate=2e-3, log_every=10, silhouette_weight=1.0),
                        target_coverage=cov_true, device=dev)
        view_seconds = time.perf_counter() - t0
        main["view"] = launches()
        reset()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            check(cli.main(["fit-view"]) == 0, "cli fit-view failed")
        main["cli_fit_view"] = launches()
    check(sum(plain.calls.values()) == 0, f"the loss branches' main path called plain versions: {plain.calls}")
    want_counts = {"multiscale": {"fit_step_kernel": 20}, "silhouette": {"fit_step_kernel": 20},
                   "multiscale_tiles": {"fit_step_kernel_tiles": 20}, "silhouette_tiles": {"fit_step_kernel_tiles": 20},
                   "view": {"fit_step_kernel": 200},
                   "cli_fit_view": {"render_kernel_forward": 1, "fit_step_kernel": 200}}  # its target's render
    for name, want in want_counts.items():
        check(main[name] == want, f"{name} launched {main[name]}, expected {want}")
    for name, res in fits.items():
        check(all(math.isfinite(v) for v in res.losses), f"{name} fit: non-finite loss")
        check(res.losses[-1] < res.losses[0], f"{name} fit: the loss did not fall ({res.losses[0]} -> {res.losses[-1]})")
    tiles_rel = {b: max(abs(a / w - 1.0) for a, w in zip(fits[f"{b}_tiles"].losses, fits[b].losses))
                 for b in LOSS_BRANCHES}
    check(max(tiles_rel.values()) <= 1e-5, f"fit_scene(mesh, tiles): losses off the unsharded fit's by {tiles_rel}")
    e0 = float(torch.linalg.vector_norm(cam0.position - ref_cam.position))
    e1 = float(torch.linalg.vector_norm(view.camera.position - ref_cam.position))
    check(all(math.isfinite(v) for v in view.losses) and view.losses[-1] < view.losses[0] and e1 < e0,
          f"fit_view: loss {view.losses[0]} -> {view.losses[-1]}, position error {e0} -> {e1}")
    cli_line = out.getvalue().strip().splitlines()[-1]
    cli_err = [float(x) for x in cli_line.split("position error")[1].split("->")]
    check(cli_err[1] < cli_err[0], f"cli fit-view did not reduce the position error: {cli_line}")
    # Step 0 of each at 1080p against the plain versions.
    step0 = {"multiscale": k3_vs_plain(LOSS_BRANCHES["multiscale"], start(), ref_cam, full, False, frozen,
                                       "K3 multiscale 1080p step 0", target_full.permute(2, 0, 1).contiguous(), None),
             "silhouette": k3_vs_plain(LOSS_BRANCHES["silhouette"], start(), ref_cam, black, False, frozen,
                                       "K3 silhouette 1080p step 0", target_black.permute(2, 0, 1).contiguous(),
                                       (target_black.abs().amax(-1) > 1e-3).to(torch.float32).contiguous()),
             "view": k3_vs_plain(dict(sil_w=1.0), reference, cam0, full, True, (), "K3 fit_view 1080p step 0",
                                 target_full.permute(2, 0, 1).contiguous(), cov_true)}
    for name in step0:
        errs[name].append(step0[name]["own_march"]["max_abs_err"])
    log("loss_main_path", launches=main, plain_calls=plain.calls,
        losses={n: r.losses for n, r in fits.items()}, seconds={n: r.seconds for n, r in fits.items()
                                                                 if hasattr(r, "seconds")},
        tiles_loss_rel_err=tiles_rel, tiles_losses_equal={b: fits[f"{b}_tiles"].losses == fits[b].losses
                                                          for b in LOSS_BRANCHES},
        view_losses=view.losses, view_position_error=[e0, e1], view_seconds=view_seconds, cli_fit_view=cli_line,
        step0=step0)

    # ---- 43. times at 1080p (plain, kernel, kernel, plain) and bounds ----
    sc = start()
    prm, uni = inputs(sc, ref_cam, full)
    _, uni_black = inputs(sc, ref_cam, black)
    v_prm, v_uni = inputs(reference, cam0, full)
    tgt = target_full.permute(2, 0, 1).contiguous()
    tgt_black = target_black.permute(2, 0, 1).contiguous()
    cov_black = (tgt_black.abs().amax(0) > 1e-3).to(torch.float32).contiguous()
    forms = {  # name: (scene, prm, uni, target, config, wrt_uniforms, frozen, launcher loss options, plain options)
        "l2": (sc, prm, uni, tgt, full, False, frozen, {}, {}),
        "multiscale": (sc, prm, uni, tgt, full, False, frozen, dict(levels=3), dict(loss_kind="multiscale")),
        "silhouette": (sc, prm, uni_black, tgt_black, black, False, frozen,
                       dict(coverage=cov_black, sil_w=0.5, sil_beta=beta), dict(sil_w=0.5, target_coverage=cov_black)),
        "view": (reference, v_prm, v_uni, tgt, full, True, (), dict(coverage=cov_true, sil_w=1.0, sil_beta=beta),
                 dict(sil_w=1.0, target_coverage=cov_true)),
    }
    kern = {n: fit_launcher(f[0], f[1], f[2], f[3], f[4], kc, f[5], f[6], "full", **f[7])[0] for n, f in forms.items()}
    runs = {n: {"ms_runs": [], "plain_ms_runs": []} for n in forms}
    for n, f in forms.items():
        runs[n]["plain_ms_runs"].append(time_ms(functools.partial(fit_step_kernel_plain, *f[:5], kc, f[5], f[6], **f[8]),
                                                0, 1))
    for order in (list(forms), list(reversed(forms))):
        for n in order:
            runs[n]["ms_runs"].append(time_ms(kern[n]))
    for n in forms:
        runs[n].update(ms=sum(runs[n]["ms_runs"]) / 2, plain_ms=runs[n]["plain_ms_runs"][0])
    # K4 with each branch over the 135-tile plan beside K3 (both through
    # their wrappers, as phase 21), in turns.
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1)
    trow, tcol = plan.tables(0, dev)
    tiles_runs = {}
    for n in ("l2", "multiscale", "silhouette"):
        f = forms[n]
        cov = f[7].get("coverage")
        stack = gather_target_tiles(f[3] if cov is None else torch.cat([f[3], cov[None]]), plan)[0]
        tile_opts = {k: v for k, v in f[8].items() if k != "target_coverage"}
        args4 = (f[0], f[1], f[2], stack[:3].contiguous(), trow, tcol, f[4], kc, False, frozen)
        cov4 = None if cov is None else stack[3].contiguous()
        k4 = functools.partial(fit_step_kernel_tiles_launch, *args4, coverage_tiles=cov4, **tile_opts)
        k4_plain = functools.partial(fit_step_kernel_tiles_plain, *args4, coverage_tiles=cov4, **tile_opts)
        k3 = functools.partial(fit_step_kernel_launch, *f[:5], kc, False, frozen, **f[8])
        got4, got3 = k4(), k3()
        rel = abs(float(got4[0]) / float(got3[0]) - 1.0)
        check(rel <= 1e-5, f"K4 {n} 1080p: loss off K3's by {rel:.3g}")
        p1 = time_ms(k4_plain, 0, 1)
        a1, b1 = time_ms(k4), time_ms(k3)
        a2, b2 = time_ms(k4), time_ms(k3)
        tiles_runs[n] = {"ms": (a1 + a2) / 2, "ms_runs": [a1, a2], "k3_wrapper_ms_runs": [b1, b2],
                         "plain_ms": p1, "plain_ms_runs": [p1], "loss_rel_err_vs_k3": rel}
    # fit_scene's ms a step with the pyramid (phase 12's L2 beside it).
    fit_ms = {}
    for n, tg, c, extra in (("l2", target_full, full, {}), ("multiscale", target_full, full, dict(loss="multiscale")),
                            ("silhouette", target_black, black, dict(silhouette_weight=0.5))):
        fit_scene(tg, start(), ref_cam, light, mat, c, FitConfig(steps=5, log_every=5, **extra), trainable=trainable,
                  device=dev)
        res = fit_scene(tg, start(), ref_cam, light, mat, c, FitConfig(steps=50, log_every=50, **extra),
                        trainable=trainable, device=dev)
        fit_ms[n] = W * H / res.rays_per_second * 1e3
    # Bounds on this run's data: K3's floor (analytic_work) plus what each
    # branch adds (branch_work); bytes: the target (and the coverage plane)
    # read, the float64 totals written.
    costs = scene_costs(cuda_scene_source(sc, full, kc, False, frozen))
    bounds = {}
    for n, f in forms.items():
        counts = march_counts(torch, f[0], ref_cam if n != "view" else cam0, f[4], f[1], f[2],
                              render_kernel_forward_plain)
        fp, sfu = analytic_work(costs, counts, f[4], primal=True, reverse=True)
        bf, bs = branch_work(costs, counts, 3 if n == "multiscale" else 0, n in ("silhouette", "view"))
        P = f[1].numel()
        bounds[n] = bound(fp + bf, sfu + bs, (16 if n in ("silhouette", "view") else 12) * W * H + 8 * (P + 31))
        runs[n].update(bound_ms=bounds[n][0], bound_by=bounds[n][1], counts=counts)
    # The multiscale K3 on the flagship's and the fractal's fit starts (their
    # libraries built in phases 30 and 37): against its plain versions at
    # 256x192 at the flagship's bars, then at 1080p beside their L2 K3, in
    # turns.
    scenes_ms = {}
    fr = (0, 1, 2, 3)  # the ground plane
    for name, sc_ in (("flagship", flagship_fit_start(dev)), ("fractal", fractal_fit_start(dev))):
        scene_true = tt.flagship_scene().to(dev) if name == "flagship" else tt.fractal_scene().to(dev)
        _, s_uni = inputs(sc_, ref_cam, small)
        base = render_kernel_launch(scene_true, scene_param_vector(scene_true, dev), s_uni, small)[0].contiguous()
        parity = {"multiscale": k3_vs_plain(LOSS_BRANCHES["multiscale"], sc_, ref_cam, small, False, fr,
                                            f"K3 multiscale {name} 256x192", base, None, FLAGSHIP_SAME, FLAGSHIP_OWN)}
        p_, u_ = inputs(sc_, ref_cam, full)
        tg_ = render_kernel_launch(scene_true, scene_param_vector(scene_true, dev), u_, full)[0].contiguous()
        kern_ = {"l2": fit_launcher(sc_, p_, u_, tg_, full, kc, False, fr)[0],
                 "multiscale": fit_launcher(sc_, p_, u_, tg_, full, kc, False, fr, "full", levels=3)[0]}
        headers = {"l2": cuda_scene_source(sc_, full, kc, False, fr), "multiscale": cuda_scene_source(
            sc_, full, kc, False, fr, "full", 3)}
        if name == "flagship":  # the silhouette K3 on the flagship too (its registers)
            b_base, b_cov = reference_target(ref_cam, cfg_of("silhouette", small), scene_true)
            parity["silhouette"] = k3_vs_plain(LOSS_BRANCHES["silhouette"], sc_, ref_cam, cfg_of("silhouette", small),
                                               False, fr, "K3 silhouette flagship 256x192", b_base, b_cov,
                                               FLAGSHIP_SAME, FLAGSHIP_OWN)
            tg_b, cov_b = reference_target(ref_cam, black, scene_true)
            kern_["silhouette"] = fit_launcher(sc_, p_, inputs(sc_, ref_cam, black)[1], tg_b, black, kc, False, fr,
                                               "full", coverage=cov_b, sil_w=0.5, sil_beta=beta)[0]
            headers["silhouette"] = cuda_scene_source(sc_, black, kc, False, fr, "full", 0, True)
        runs_ = {f: [] for f in kern_}
        for _ in range(2):
            for f, k_ in kern_.items():
                runs_[f].append(time_ms(k_, 2, 10))
        scenes_ms[name] = {"parity_256x192": parity}
        for form, header in headers.items():
            p = ptxas_summary(libs.log(libs.key(header)))["fit_step"]
            scenes_ms[name][form] = {"ms": sum(runs_[form]) / 2, "ms_runs": runs_[form],
                                     "ptxas": {**p, "blocks_per_sm": blocks_per_sm(p["registers"])}}
    log("loss_times_1080p", card=card, k3=runs, k4=tiles_runs, fit_scene_ms_per_step=fit_ms, scenes=scenes_ms,
        ptxas=ptxas)
    entry = {}
    for n, count in (("multiscale", main["multiscale"]["fit_step_kernel"]),
                     ("silhouette", main["silhouette"]["fit_step_kernel"]),
                     ("view", main["view"]["fit_step_kernel"])):
        entry[n] = {"launches": count, "max_abs_err": max(errs[n]), "ms": runs[n]["ms"],
                    "plain_ms": runs[n]["plain_ms"], "bound_ms": runs[n]["bound_ms"], "bound_by": runs[n]["bound_by"]}
    tiles_entry = {}
    for n in LOSS_BRANCHES:
        tiles_entry[n] = {"launches": main[f"{n}_tiles"]["fit_step_kernel_tiles"],
                          "max_abs_err": max(errs[f"{n}_tiles"]), "ms": tiles_runs[n]["ms"],
                          "plain_ms": tiles_runs[n]["plain_ms"], "bound_ms": runs[n]["bound_ms"],
                          "bound_by": runs[n]["bound_by"]}
    return {"fit_step": entry, "fit_step_tiles": tiles_entry}


def materials_fit_start(tt, dev):
    """``materials_scene`` with its material channels moved off the target's:
    each colour 30% darker and 0.05 bluer, each shininess 20% lower."""
    sc = tt.materials_scene().to(dev)
    with __import__("torch").no_grad():
        for n in sc.modules():
            if isinstance(n, tt.sdf.Shaded):
                for f in (n.ambient, n.diffuse, n.specular):
                    f.mul_(0.7)
                    f[2] += 0.05
                n.shininess.mul_(0.8)
    return sc


def slice_phases(torch, tt, card: str, dev) -> dict:
    """Phases 44-47: K3's view axis (ROADMAP 12b: ``multiview_loss_and_grads``,
    ``fit_scene_multiview``, the bench extra ``fit_multiview_720p_v4``) and
    per-object materials (12c: ``materials_scene`` through K1/K2, K3/K4 and
    K5).  Returns the kernels line's ``multiview`` entry of ``fit_step`` and
    the ``materials`` entries of ``render_fwd``, ``render_tiles``,
    ``fit_step``, ``fit_step_tiles`` and ``render_bwd``."""
    import torch.distributed as dist

    from sdf3d_tpu_torch import bench
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene, fit_scene_multiview
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import (
        fit_launcher,
        fit_step_kernel,
        fit_step_kernel_launch,
        fit_step_kernel_plain,
        fit_step_kernel_tiles,
        fit_step_kernel_tiles_launch,
        fit_step_kernel_tiles_plain,
        fit_step_views_plain,
        multiview_loss_and_grads,
        sum_views,
    )
    from sdf3d_tpu_torch.ops.render_bwd_kernel import (
        render_bwd_launcher,
        render_kernel_backward,
        render_kernel_backward_launch,
        render_kernel_backward_plain,
    )
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        library_job,
        pack_uniforms,
        render_kernel_forward,
        render_kernel_forward_plain,
        render_kernel_launch,
        render_kernel_tiles_forward,
        render_kernel_tiles_forward_plain,
        render_kernel_tiles_launch,
        tile_pixel_planes,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, leaves, scene_param_vector
    from sdf3d_tpu_torch.parallel import launch, make_mesh, render_sharded_kernel
    from sdf3d_tpu_torch.parallel.tile_queue import gather_target_tiles, plan_tiles
    from sdf3d_tpu_torch.utils.parity import (
        FLAGSHIP_OWN,
        FLAGSHIP_SAME,
        check_grads,
        check_planes,
        conditioned,
        fit_targets,
        gradient_mass,
        razor_edge,
        shaded_slots,
    )

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    W7, H7, V = 1280, 720, 4
    c720 = dataclasses.replace(full, width=W7, height=H7)
    small = dataclasses.replace(full, width=256, height=192)
    ragged = dataclasses.replace(full, width=250, height=190)
    kc, kc_point = KernelConfig(), KernelConfig(ray_sdf=False)
    frozen, trainable = (0, 1, 2, 3), (False, False, True, True)
    ref_cam = tt.Camera.reference(device=dev)
    orbit = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)
    cams4 = [tt.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0, device=dev) for i in range(V)]
    reference = tt.reference_scene().to(dev)
    counters = (render_kernel_forward, fit_step_kernel, render_kernel_backward, render_kernel_tiles_forward,
                fit_step_kernel_tiles)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)

    def start():  # the fit demo's start (phase 10)
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters if fn.launches}

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def planes_stats(st):
        return {n: {q: v[q] for q in ("over_atol", "max_abs_err", "over_hard")} for n, v in st.items()}

    # ---- 44. build: materials_scene's libraries together ----
    libs = _build.LIBRARIES
    builds0, seconds0 = libs.builds, libs.build_seconds
    msc = tt.materials_scene().to(dev)
    mslots = shaded_slots(msc)
    geometry = tuple(k for k in range(scene_param_vector(msc).numel()) if k not in mslots)
    # The fits train the material leaves alone (one flag a leaf).
    m_leaves = {id(getattr(n, f)) for n in msc.modules() if isinstance(n, tt.sdf.Shaded)
                for f in ("ambient", "diffuse", "specular", "shininess")}
    m_trainable = tuple(id(leaf) in m_leaves for leaf in leaves(msc))
    settings = {"uniforms": (full, kc, True, ()), "scene": (full, kc, False, ()),
                "geometry_frozen": (full, kc, False, geometry), "point": (full, kc_point, True, ())}
    t0 = time.perf_counter()
    libs.load_many([library_job(msc, c, k, w, f) for c, k, w, f in settings.values()])
    build_wall = time.perf_counter() - t0
    ptxas = {}
    for name, (c, k, w, f) in settings.items():
        header = cuda_scene_source(msc, c, k, w, f)
        ptxas[name] = {kn: {**v, "blocks_per_sm": blocks_per_sm(v["registers"])}
                       for kn, v in ptxas_summary(libs.log(libs.key(header))).items() if "registers" in v}
    header = cuda_scene_source(msc, full, kc, True, ())
    values = {k: int(re.search(rf"{k} = (\d+)", header).group(1)) for k in ("bwd_values", "bwd_node_values")}
    log("slice_build", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        build_wall_seconds=build_wall, libraries=len(settings), ptxas=ptxas, materials_scene=values,
        material_slots=len(mslots))

    # ---- 45. the view axis: K3 over four views at 1280x720 ----
    errs = {k: [] for k in ("multiview", "render_fwd", "render_tiles", "fit_step", "fit_step_tiles", "render_bwd")}
    sc = start()
    prm = scene_param_vector(sc, dev)
    unis = torch.stack([inputs(sc, cam, c720)[1] for cam in cams4])
    bases = [render_kernel_launch(reference, scene_param_vector(reference, dev), u, c720)[0] for u in unis]
    planes = [render_kernel_launch(sc, prm, u, c720) for u in unis]
    owns = [render_kernel_forward_plain(sc, prm, u, c720) for u in unis]
    pairs = [fit_targets(b, p, o, sc, prm, u, c720) for b, p, o, u in zip(bases, planes, owns, unis)]
    target = torch.stack([t for t, _ in pairs], 1).contiguous().transpose(0, 1)   # (V, 3, H, W) of (3, V, H, W)
    p_target = torch.stack([p for _, p in pairs])
    reset()
    got = fit_step_kernel(sc, prm, unis, target, c720, kc, False, frozen, sum_dtype=torch.float64)
    mv_launches = launches()
    check(mv_launches == {"fit_step_kernel": 1}, f"the multi-view step launched {mv_launches}")
    own = sum_views(*fit_step_views_plain(sc, prm, unis, p_target, c720, kc, False, frozen), torch.float64)
    same_prm = torch.zeros_like(prm)
    masses = []
    for v in range(V):
        rgb, t, sh, ao = planes[v]
        g_rgb = 2.0 * (rgb - target[v])
        same_prm += render_kernel_backward_plain(sc, prm, unis[v], g_rgb, t, sh, ao, c720, wrt_uniforms=False)[0]
        masses.append(gradient_mass(sc, prm, unis[v], g_rgb, t, sh, ao, c720))
    same_prm[list(frozen)] = 0.0
    torch.cuda.synchronize()
    P = prm.numel()
    mass = sum(m[:P] for m in masses)
    same_loss = sum(float(((planes[v][0] - target[v]).double() ** 2).sum()) for v in range(V))
    loss_rel = abs(float(got[0]) / same_loss - 1.0)
    own_rel = abs(float(got[0]) / float(own[0]) - 1.0)
    check(loss_rel <= 1e-5 and own_rel <= 1e-5, f"multi-view K3: loss off by {loss_rel:.3g} / {own_rel:.3g}")
    check(bool(torch.isfinite(got[1]).all()) and all(float(got[1][q]) == 0.0 for q in frozen),
          "multi-view K3: a non-finite or unfrozen gradient")
    mv_parity = {"loss_rel_err": loss_rel, "own_march_loss_rel_err": own_rel,
                 "same_planes": check_grads(got[1].float(), same_prm, mass, rtol=1e-4, mass_tol=1e-5,
                                            label="multi-view K3 (same planes)"),
                 "own_march": check_grads(got[1].float(), own[1].float(), mass, rtol=1e-4, mass_tol=FLAGSHIP_OWN,
                                          label="multi-view K3 (own march)")}
    errs["multiview"].append(mv_parity["own_march"]["max_abs_err"])
    # Each view's float64 totals and partial rows against K3 on that view alone, bit for bit.
    bits = {}
    for wrt, fr in ((False, frozen), (True, ())):
        lm, rows_m, tot_m = fit_launcher(sc, prm, unis, target, c720, kc, wrt, fr)
        lm()
        same = []
        for v in range(V):
            l1, rows1, tot1 = fit_launcher(sc, prm, unis[v].contiguous(), target[v].contiguous(), c720, kc, wrt, fr)
            l1()
            torch.cuda.synchronize()
            same.append(bool(torch.equal(tot_m[v], tot1)) and bool(torch.equal(rows_m[v], rows1)))
        check(all(same), f"multi-view totals differ from single-view K3's (wrt_uniforms={wrt}): {same}")
        bits[f"wrt_uniforms={wrt}"] = {"views_bit_equal": same,
                                       "totals_sha256": hashlib.sha256(tot_m.cpu().numpy().tobytes()).hexdigest()}
    log("multiview_parity", size=[W7, H7], views=V, launches=mv_launches, **mv_parity, per_view_bits=bits)

    # Main path: multiview_loss_and_grads, a 20-step fit_scene_multiview and the bench extra.
    targets = [b.permute(1, 2, 0).contiguous() for b in bases]
    step = fit_step_kernel(sc, prm, unis, torch.stack(bases, 1).contiguous().transpose(0, 1), c720, kc, False, frozen)
    main = {}
    with PlainCalls() as plain:
        reset()
        loss_mv, grads_mv = multiview_loss_and_grads(c720, kc, sc, cams4, light, mat, targets, False, frozen)
        torch.cuda.synchronize()
        main["multiview_loss_and_grads"] = launches()
        reset()
        t0 = time.perf_counter()
        mfit = fit_scene_multiview(targets, start(), cams4, light, mat, c720,
                                   FitConfig(steps=20, learning_rate=1e-2, log_every=1), trainable=trainable,
                                   device=dev)
        mfit_seconds = time.perf_counter() - t0
        main["fit_scene_multiview"] = launches()
        reset()
        extra = bench._multiview_extra(dev)
        main["bench_extra"] = launches()
    check(sum(plain.calls.values()) == 0, f"the multi-view main path called plain versions: {plain.calls}")
    check(main["multiview_loss_and_grads"] == {"fit_step_kernel": 1} and
          main["fit_scene_multiview"] == {"fit_step_kernel": 20},
          f"multi-view launches {main}, expected one K3 launch a step")
    check(set(main["bench_extra"]) == {"fit_step_kernel"} and extra["rays_per_second"] > 0,
          f"bench extra fit_multiview_720p_v4: {extra}, {main['bench_extra']}")
    check(all(math.isfinite(x) for x in mfit.losses) and mfit.losses[-1] < mfit.losses[0],
          f"fit_scene_multiview: loss {mfit.losses[0]} -> {mfit.losses[-1]}")
    check(float(loss_mv) == float(step[0]) and torch.equal(torch.cat([g.reshape(-1) for g in grads_mv[0]]),
                                                           step[1]), "multiview_loss_and_grads is not the step's")
    log("multiview_main_path", launches=main, losses=mfit.losses, seconds=mfit_seconds,
        rays_per_second=mfit.rays_per_second, fitted=scene_param_vector(mfit.scene).tolist(), bench_extra=extra)

    # ---- 46. materials_scene: K1/K2, K3/K4, K5 against their plain versions, and its main path ----
    # Each camera at one size (orbit 30/15 at 256x192, the reference camera
    # at the ragged 250x190), both forms.
    cam_sizes = ((("orbit30_15", orbit), small), (("reference", ref_cam), ragged))
    for (cam_name, cam), c, k in [(cm, c, k) for cm, c in cam_sizes for k in (kc, kc_point)]:
        p_, u_ = inputs(msc, cam, c)
        g_ = render_kernel_launch(msc, p_, u_, c, k)
        w_ = render_kernel_forward_plain(msc, p_, u_, c, k)
        torch.cuda.synchronize()
        st = check_planes(g_, w_, c.march.max_distance, f"materials K1 {cam_name} {c.width}x{c.height}",
                          razor=functools.partial(razor_edge, msc, p_, u_, c, k))
        errs["render_fwd"].append(st["rgb"]["max_abs_err"])
        log("materials_k1_parity", camera=cam_name, size=[c.width, c.height], ray_sdf=k.ray_sdf, **planes_stats(st))
    # K3's three forms, the sizes in turn.
    for c, wrt, fr in ((small, False, ()), (ragged, True, ()), (small, False, geometry)):
        label = f"materials K3 {c.width}x{c.height} wrt_uniforms={wrt} geometry_frozen={bool(fr)}"
        p_, u_ = inputs(msc, orbit, c)
        st = k3_against_plain(torch, msc, p_, u_, c, kc, wrt, fr, label, gen)
        errs["fit_step"].append(st["own_march"]["max_abs_err"])
        log("materials_k3_parity", size=[c.width, c.height], wrt_uniforms=wrt, geometry_frozen=bool(fr), **st)
    for c in (small, ragged):
        p_, u_ = inputs(msc, orbit, c)
        _, t, sh, ao = render_kernel_launch(msc, p_, u_, c)
        g_rgb = (torch.randn((3, c.height, c.width), generator=gen, device=dev)
                 * conditioned(msc, p_, u_, t, c)).contiguous()
        mass = gradient_mass(msc, p_, u_, g_rgb, t, sh, ao, c)
        for wrt in (True, False):
            g5 = render_kernel_backward_launch(msc, p_, u_, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
            w5 = render_kernel_backward_plain(msc, p_, u_, g_rgb, t, sh, ao, c, wrt_uniforms=wrt)
            torch.cuda.synchronize()
            st = check_grads(torch.cat(g5) if wrt else g5[0], torch.cat(w5) if wrt else w5[0],
                             mass if wrt else mass[:p_.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME,
                             label=f"materials K5 {c.width}x{c.height} wrt_uniforms={wrt}")
            check(float(g5[0][mslots].abs().max()) > 0.0, "materials K5: the material slots' gradients are all 0")
            errs["render_bwd"].append(st["max_abs_err"])
            log("materials_k5_parity", size=[c.width, c.height], wrt_uniforms=wrt, **st)
    # K2 and K4 over a balanced 4-rank plan of the default 24x640 tiles at 1280x720.
    p_, u_ = inputs(msc, orbit, c720)
    rgb, t, sh, ao = k1 = render_kernel_launch(msc, p_, u_, c720)
    tgt = (rgb * 0.95).contiguous()
    work = torch.rand((H7 // kc.tile_h, W7 // kc.tile_w), generator=torch.Generator().manual_seed(1)).numpy()
    plan = plan_tiles(H7, W7, kc.tile_h, kc.tile_w, 4, "balanced", work)
    whole = gather_target_tiles(torch.cat([rgb, t[None], sh[None], ao[None]]), plan)
    stacks, total, k2_equal = gather_target_tiles(tgt, plan), None, []
    for r in range(4):
        trow, tcol = plan.tables(r, dev)
        g2 = render_kernel_tiles_launch(msc, p_, u_, trow, tcol, c720, kc)
        g4 = fit_step_kernel_tiles_launch(msc, p_, u_, stacks[r].contiguous(), trow, tcol, c720, kc, True, ())
        torch.cuda.synchronize()
        k2_equal.append(bool(torch.equal(torch.cat([g2[0], *(q[None] for q in g2[1:])]), whole[r])))
        total = g4 if total is None else tuple(a + b for a, b in zip(total, g4))
    check(all(k2_equal), f"materials K2's stacks differ from K1's planes: {k2_equal}")
    w3 = fit_step_kernel_launch(msc, p_, u_, tgt, c720, kc, True, ())
    torch.cuda.synchronize()
    mass = gradient_mass(msc, p_, u_, 2.0 * (rgb - tgt), t, sh, ao, c720)
    k4_rel = abs(float(total[0]) / float(w3[0]) - 1.0)
    check(k4_rel <= 1e-5, f"materials K4: the plan's loss off K3's by {k4_rel:.3g}")
    k4_vs_k3 = check_grads(torch.cat(total[1:]), torch.cat(w3[1:]), mass, rtol=1e-4, mass_tol=1e-4,
                           label="materials K4 sum vs K3")
    errs["fit_step_tiles"].append(k4_vs_k3["max_abs_err"])
    log("materials_tiles_parity", k2_stacks_equal_k1=k2_equal, k4_loss_rel_err_vs_k3=k4_rel, k4_vs_k3=k4_vs_k3)

    # Main path at 1920x1080.
    target_img = render_kernel_forward(msc, ref_cam, light, mat, full, device=dev)[0]
    m_main = {}
    with PlainCalls() as plain, BackwardModes() as modes:
        reset()
        frames = tt.render_batch(msc, cams4, light, mat, full, engine="kernel")
        torch.cuda.synchronize()
        m_main["render_batch"] = launches()
        reset()
        mfit_l2 = fit_scene(target_img, materials_fit_start(tt, dev), ref_cam, light, mat, full,
                            FitConfig(steps=20, learning_rate=1e-2, log_every=1), trainable=m_trainable, device=dev)
        m_main["fit_l2"] = launches()
        reset()
        mfit_ms4 = fit_scene(target_img, materials_fit_start(tt, dev), ref_cam, light, mat, full,
                             FitConfig(steps=5, learning_rate=1e-2, log_every=1, loss="multiscale", pyramid_levels=4),
                             trainable=m_trainable, device=dev)
        m_main["fit_multiscale_4_levels"] = launches()
        ms_modes = list(modes.calls[-5:])
        launch.initialize(f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
        try:
            mesh = make_mesh()
            check(dist.get_backend() == "nccl" and mesh.size == 1, f"mesh {mesh}")
            reset()
            mfit_tiles = fit_scene(target_img, materials_fit_start(tt, dev), ref_cam, light, mat, full,
                                   FitConfig(steps=20, learning_rate=1e-2, log_every=1, shard_layout="tiles"),
                                   mesh=mesh, trainable=m_trainable)
            m_main["fit_mesh_tiles"] = launches()
            reset()
            sharded = render_sharded_kernel(msc, ref_cam, light, mat, full, mesh, kc, layout="tiles", planar=True)
            torch.cuda.synchronize()
            m_main["render_sharded_tiles"] = launches()
        finally:
            launch.shutdown()
    check(sum(plain.calls.values()) == 0, f"the materials main path called plain versions: {plain.calls}")
    zero = {fn.__name__: 0 for fn in counters}
    want_counts = {"render_batch": {"render_kernel_forward": 4}, "fit_l2": {"fit_step_kernel": 20},
                   "fit_multiscale_4_levels": {"render_kernel_forward": 5, "render_kernel_backward": 5},
                   "fit_mesh_tiles": {"fit_step_kernel_tiles": 20},
                   "render_sharded_tiles": {"render_kernel_tiles_forward": 1}}
    for name, want in want_counts.items():
        check({**zero, **m_main[name]} == {**zero, **want}, f"materials {name} launched {m_main[name]}, expected {want}")
    check(ms_modes == [False] * 5, f"the materials 4-level fit's K5 asked for wrt_uniforms {ms_modes}")
    check(tuple(frames.shape) == (4, H, W, 3) and bool(torch.isfinite(frames).all()), "bad materials frames")
    for name, res in (("l2", mfit_l2), ("multiscale_4_levels", mfit_ms4), ("mesh_tiles", mfit_tiles)):
        check(all(math.isfinite(x) for x in res.losses) and res.losses[-1] < res.losses[0],
              f"materials {name} fit: loss {res.losses[0]} -> {res.losses[-1]}")
        fitted = scene_param_vector(res.scene)
        check(bool(torch.isfinite(fitted).all()) and torch.equal(fitted[list(geometry)],
                                                                 scene_param_vector(msc)[list(geometry)]),
              f"materials {name} fit: the geometry moved or a parameter is not finite")
    tiles_rel = max(abs(a / b - 1.0) for a, b in zip(mfit_tiles.losses, mfit_l2.losses))
    check(tiles_rel <= 1e-5, f"materials fit_scene(mesh, tiles): losses off the unsharded fit's by {tiles_rel:.3g}")
    p0, u0 = inputs(msc, cams4[0], full)
    k0 = render_kernel_launch(msc, p0, u0, full)
    torch.testing.assert_close(k0[0].permute(1, 2, 0), frames[0], rtol=0, atol=0)
    frame0 = check_planes(k0, render_kernel_forward_plain(msc, p0, u0, full), full.march.max_distance,
                          "materials 1080p frame 0", razor=functools.partial(razor_edge, msc, p0, u0, full))
    errs["render_fwd"].append(frame0["rgb"]["max_abs_err"])
    pr, ur = inputs(msc, ref_cam, full)
    k1_ref = render_kernel_launch(msc, pr, ur, full)[0]
    torch.cuda.synchronize()
    sharded_equal = bool(torch.equal(sharded, k1_ref))
    check(sharded_equal, "materials render_sharded_kernel(tiles) differs from K1's image")
    ms0 = materials_fit_start(tt, dev)
    step0 = k3_against_plain(torch, ms0, *inputs(ms0, ref_cam, full), full, kc, False, geometry,
                             "materials K3 1080p step 0", gen, target=target_img.permute(2, 0, 1).contiguous())
    errs["fit_step"].append(step0["own_march"]["max_abs_err"])
    log("materials_main_path", launches=m_main, multiscale_render_bwd_wrt_uniforms=ms_modes,
        frame0=planes_stats(frame0), l2_losses=mfit_l2.losses, multiscale_4_levels_losses=mfit_ms4.losses,
        mesh_tiles_losses=mfit_tiles.losses, mesh_tiles_loss_rel_err=tiles_rel,
        mesh_tiles_losses_equal=mfit_tiles.losses == mfit_l2.losses, render_sharded_equals_k1=sharded_equal,
        fitted_materials=scene_param_vector(mfit_l2.scene)[mslots].tolist(),
        target_materials=scene_param_vector(msc)[mslots].tolist(), step0=step0)

    # ---- 47. times (plain, kernel, kernel, plain) and bounds ----
    runs = {}
    # The multi-view K3 at 720p (four views, one launch, its total) beside the
    # single view's K3 on view 0.
    lm = fit_launcher(sc, prm, unis, target, c720, kc, False, frozen)[0]
    l1 = fit_launcher(sc, prm, unis[0].contiguous(), target[0].contiguous(), c720, kc, False, frozen)[0]
    mv_plain = functools.partial(fit_step_views_plain, sc, prm, unis, target, c720, kc, False, frozen)
    p1, a1, b1, a2, b2, p2 = (time_ms(mv_plain, 0, 1), time_ms(lm), time_ms(l1), time_ms(lm), time_ms(l1),
                              time_ms(mv_plain, 0, 1))
    costs = scene_costs(cuda_scene_source(sc, c720, kc, False, frozen))
    fp = sfu = 0.0
    view_counts = []
    for v in range(V):
        cnt = march_counts(torch, sc, cams4[v], c720, prm, unis[v], render_kernel_forward_plain)
        view_counts.append(cnt)
        f_, s_ = analytic_work(costs, cnt, c720, reverse=True)
        fp, sfu = fp + f_, sfu + s_
    b_ms, b_by = bound(fp, sfu, 12 * W7 * H7 * V + 8 * (P + 31) * V)
    runs["multiview"] = {"ms": (a1 + a2) / 2, "ms_runs": [a1, a2], "single_view_ms_runs": [b1, b2],
                         "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2], "bound_ms": b_ms, "bound_by": b_by,
                         "counts": view_counts}
    # materials_scene at 1080p: K1, K2, K3, K4 and both K5 forms (the fit's start, the geometry frozen).
    ms_ = materials_fit_start(tt, dev)
    s_prm, s_uni = inputs(ms_, ref_cam, full)
    tgt = target_img.permute(2, 0, 1).contiguous()
    plan1 = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1)
    trow, tcol = plan1.tables(0, dev)
    stack = gather_target_tiles(tgt, plan1)[0].contiguous()
    # K2 against its plain version at the size and on the plan the main
    # path's render_sharded_kernel(tiles) launches it (1080p, one rank).
    got2 = render_kernel_tiles_launch(msc, pr, ur, trow, tcol, full, kc)
    want2 = render_kernel_tiles_forward_plain(msc, pr, ur, trow, tcol, full, kc)
    torch.cuda.synchronize()
    k2_pixels = tile_pixel_planes(trow, tcol, kc.tile_h, kc.tile_w)
    k2_1080p = check_planes(got2, want2, full.march.max_distance, "materials K2 1080p",
                            razor=lambda: razor_edge(msc, pr, ur, full, kc, k2_pixels))
    errs["render_tiles"].append(k2_1080p["rgb"]["max_abs_err"])
    rgb, t, sh, ao = render_kernel_launch(ms_, s_prm, s_uni, full)
    g_rgb = (2.0 * (rgb - tgt)).contiguous()
    k3_launch, _, k3_totals = fit_launcher(ms_, s_prm, s_uni, tgt, full, kc, False, geometry)
    k3_launch()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k3_totals).all()), "materials K3's totals at 1080p are not finite")
    timed = {
        "render_fwd": (lambda: render_kernel_launch(msc, pr, ur, full),
                       lambda: render_kernel_forward_plain(msc, pr, ur, full)),
        "render_tiles": (lambda: render_kernel_tiles_launch(msc, pr, ur, trow, tcol, full, kc),
                         lambda: render_kernel_tiles_forward_plain(msc, pr, ur, trow, tcol, full, kc)),
        "fit_step": (k3_launch, lambda: fit_step_kernel_plain(ms_, s_prm, s_uni, tgt, full, kc, False, geometry)),
        "fit_step_tiles": (lambda: fit_step_kernel_tiles_launch(ms_, s_prm, s_uni, stack, trow, tcol, full, kc, False,
                                                                geometry),
                           lambda: fit_step_kernel_tiles_plain(ms_, s_prm, s_uni, stack, trow, tcol, full, kc, False,
                                                               geometry)),
    }
    for name, wrt in (("render_bwd", False), ("render_bwd_uniforms", True)):
        k5_launch, _, k5_totals = render_bwd_launcher(ms_, s_prm, s_uni, g_rgb, t, sh, ao, full, kc, wrt)
        k5_launch()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k5_totals).all()), f"materials {name}'s totals at 1080p are not finite")
        timed[name] = (k5_launch, functools.partial(render_kernel_backward_plain, ms_, s_prm, s_uni, g_rgb, t, sh, ao,
                                                    full, wrt_uniforms=wrt))
    # K5 at the size the main path's 4-level fit launches it (1920x1080),
    # both forms, against its plain version on the timed cotangent, zeroed
    # where the gradient is ill-conditioned (as the flagship's phase 32).
    g_cond = (g_rgb * conditioned(ms_, s_prm, s_uni, t, full)).contiguous()
    mass = gradient_mass(ms_, s_prm, s_uni, g_cond, t, sh, ao, full)
    k5_1080p = {}
    for name, wrt in (("render_bwd", False), ("render_bwd_uniforms", True)):
        got = render_kernel_backward_launch(ms_, s_prm, s_uni, g_cond, t, sh, ao, full, wrt_uniforms=wrt)
        want = render_kernel_backward_plain(ms_, s_prm, s_uni, g_cond, t, sh, ao, full, wrt_uniforms=wrt)
        torch.cuda.synchronize()
        k5_1080p[name] = check_grads(torch.cat(got) if wrt else got[0], torch.cat(want) if wrt else want[0],
                                     mass if wrt else mass[:s_prm.numel()], rtol=1e-4, mass_tol=FLAGSHIP_SAME,
                                     label=f"materials K5 1080p wrt_uniforms={wrt}")
        check(float(got[0][mslots].abs().max()) > 0.0, "materials K5 1080p: the material slots' gradients are all 0")
        errs["render_bwd"].append(k5_1080p[name]["max_abs_err"])
    log("materials_1080p_parity", k2=planes_stats(k2_1080p), k5=k5_1080p)
    for name, (kern, plain_fn) in timed.items():
        p1, k1_, k2_, p2 = time_ms(plain_fn, 0, 1), time_ms(kern), time_ms(kern), time_ms(plain_fn, 0, 1)
        runs[name] = {"ms": (k1_ + k2_) / 2, "ms_runs": [k1_, k2_], "plain_ms": (p1 + p2) / 2,
                      "plain_ms_runs": [p1, p2]}
    fit_scene(target_img, materials_fit_start(tt, dev), ref_cam, light, mat, full,
              FitConfig(steps=5, log_every=5), trainable=m_trainable, device=dev)
    res = fit_scene(target_img, materials_fit_start(tt, dev), ref_cam, light, mat, full,
                    FitConfig(steps=50, log_every=50), trainable=m_trainable, device=dev)
    fit_ms = W * H / res.rays_per_second * 1e3
    counts = march_counts(torch, msc, ref_cam, full, pr, ur, render_kernel_forward_plain)
    s_counts = march_counts(torch, ms_, ref_cam, full, s_prm, s_uni, render_kernel_forward_plain)
    m_costs = scene_costs(cuda_scene_source(msc, full, kc))
    s_costs = scene_costs(cuda_scene_source(ms_, full, kc, False, geometry))
    Pm = s_prm.numel()
    blocks = -(-W // kc.block_w) * -(-H // kc.block_h)
    bounds = {
        "render_fwd": bound(*analytic_work(m_costs, counts, full), 24 * W * H),
        "render_tiles": bound(*analytic_work(m_costs, counts, full), 24 * W * H + 8 * plan1.tiles_per_device),
        "fit_step": bound(*analytic_work(s_costs, s_counts, full, reverse=True), 12 * W * H + 8 * (Pm + 31)),
        "fit_step_tiles": bound(*analytic_work(s_costs, s_counts, full, reverse=True),
                                12 * W * H + 8 * plan1.tiles_per_device + 8 * (Pm + 31)),
        "render_bwd": bound(*analytic_work(s_costs, s_counts, full, primal=False, reverse=True, retrace=True),
                            24 * W * H + (8 * blocks + 8) * Pm),
        "render_bwd_uniforms": bound(*analytic_work(s_costs, s_counts, full, primal=False, reverse=True, retrace=True),
                                     24 * W * H + (8 * blocks + 8) * (Pm + 30)),
    }
    for name, b in bounds.items():
        runs[name].update(bound_ms=b[0], bound_by=b[1])
    log("slice_times", card=card, materials_counts=counts, materials_fit_start_counts=s_counts,
        materials_costs=m_costs, fit_scene_ms_per_step=fit_ms, ptxas=ptxas, **runs)
    m_launches = {"render_fwd": m_main["render_batch"]["render_kernel_forward"],
                  "render_tiles": m_main["render_sharded_tiles"]["render_kernel_tiles_forward"],
                  "fit_step": m_main["fit_l2"]["fit_step_kernel"],
                  "fit_step_tiles": m_main["fit_mesh_tiles"]["fit_step_kernel_tiles"],
                  "render_bwd": m_main["fit_multiscale_4_levels"]["render_kernel_backward"]}
    out = {}
    for name, n in m_launches.items():
        out[name] = {"materials": {"launches": n, "max_abs_err": max(errs[name]), "ms": runs[name]["ms"],
                                   "plain_ms": runs[name]["plain_ms"], "bound_ms": runs[name]["bound_ms"],
                                   "bound_by": runs[name]["bound_by"]}}
    out["render_bwd"]["materials"]["uniforms"] = {k: runs["render_bwd_uniforms"][k]
                                                  for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    out["render_bwd"]["materials"]["max_abs_err_1080p"] = max(st["max_abs_err"] for st in k5_1080p.values())
    out["fit_step"]["materials"]["fit_scene_ms_per_step"] = fit_ms
    out["fit_step"]["multiview"] = {"launches": main["fit_scene_multiview"]["fit_step_kernel"],
                                    "max_abs_err": max(errs["multiview"]), "views": V, "size": [W7, H7],
                                    **{k: runs["multiview"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
    return out


class StepClock:
    """A fit's logger that keeps the host time of each logged step.  With
    ``log_every=1`` a chunk is one step whose loss is read at its end, so
    the steps after the first give the steady ms a step, the first call's
    set-up (lazy module loads, allocations, a build) left out."""

    def __init__(self):
        self.times = []

    def log(self, **fields) -> None:
        self.times.append(time.perf_counter())

    def ms_per_step(self) -> float:
        return (self.times[-1] - self.times[0]) / (len(self.times) - 1) * 1e3


NEURAL_FIT = r"""
import json, os, sys, time
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import dataclasses
import torch
import torch.distributed as dist
torch.backends.cuda.matmul.allow_tf32 = False
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel
from sdf3d_tpu_torch.ops.neural_kernel import render_neural_forward
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward
from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward
from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
from sdf3d_tpu_torch.parallel import launch, make_mesh, ring_kernel
from chip_smoke import StepClock

spec = json.load(open(os.path.join(outdir, "spec.json")))
launch.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)  # two ranks, one card: gloo
mesh = make_mesh()
dev = mesh.device
ref = tt.REFERENCE_CONFIG
W, H = spec["size"]
ncfg = dataclasses.replace(ref, width=W, height=H, march=dataclasses.replace(ref.march, max_steps=64),
                           shadow=dataclasses.replace(ref.shadow, max_steps=32))
rcfg = dataclasses.replace(ref, width=W, height=H)
cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
nscene = torch.load(spec["scene"], map_location=dev, weights_only=False)
ntarget, rtarget = (torch.load(spec[k], map_location=dev) for k in ("neural_target", "reference_target"))
calls = {"all_reduce": 0, "plain": 0}

def counted(fn, key):
    def wrapper(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return wrapper

dist.all_reduce = counted(dist.all_reduce, "all_reduce")
for name in ("ring_allreduce_plain", "rs_ag_plain"):
    setattr(ring_kernel, name, counted(getattr(ring_kernel, name), "plain"))
counters = (ring_kernel.ring_allreduce, ring_kernel.rs_ag_allreduce, render_neural_forward, render_kernel_forward,
            fit_step_kernel, render_kernel_backward)
runs = {}
for allreduce in spec["allreduces"]:
    for fn in counters:
        fn.launches = 0
    calls.update(all_reduce=0, plain=0)
    t0, clock = time.perf_counter(), StepClock()
    res = fit_scene(ntarget, nscene, cam, light, mat, ncfg,
                    FitConfig(steps=spec["steps"], learning_rate=spec["lr"], log_every=1, allreduce=allreduce),
                    mesh=mesh, trainable=tuple(spec["trainable"]), logger=clock)
    runs[allreduce] = {"seconds": time.perf_counter() - t0, "ms_per_step": clock.ms_per_step() if rank == 0 else None,
                       "losses": res.losses, "params": scene_param_vector(res.scene).tolist(),
                       "launches": {fn.__name__: fn.launches for fn in counters},
                       "all_reduce_calls": calls["all_reduce"], "plain_calls": calls["plain"]}
start = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)
for fn in counters:
    fn.launches = 0
t0, clock = time.perf_counter(), StepClock()
res = fit_scene(rtarget, start, cam, light, mat, rcfg,
                FitConfig(steps=spec["steps"], learning_rate=1e-2, log_every=1, engine="torch"), mesh=mesh,
                trainable=(False, False, True, True), logger=clock)
runs["torch_engine"] = {"seconds": time.perf_counter() - t0, "ms_per_step": clock.ms_per_step() if rank == 0 else None,
                        "losses": res.losses, "params": scene_param_vector(res.scene).tolist(),
                        "launches": {fn.__name__: fn.launches for fn in counters}}
with open(os.path.join(outdir, f"out_r{rank}.json"), "w") as f:
    json.dump({"rank": mesh.rank, "size": mesh.size, "backend": dist.get_backend(),
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "runs": runs}, f)
launch.shutdown()
"""


def diff_phases(torch, tt, card: str, dev) -> dict:
    """Phases 48-51: ``diff.py`` (ROADMAP item 5: the implicit-function
    gradients through the torch march) and the fits that wait for it: the
    torch engine of ``fit_scene``, ``fit_view`` and ``fit_scene_multiview``,
    the silhouette term outside the fused step on K1 + K5, the NeuralSDF fit
    on K6 (17a) and the sharded NeuralSDF fit on the ring all-reduces (17b).
    Returns the kernels line's ``fit_view_nonfused`` entries of
    ``render_fwd`` and ``render_bwd``, the ``fit`` entry of ``neural_fwd``
    and the ``neural_fit`` entries of ``ring_allreduce`` and
    ``rs_ag_allreduce``."""
    import copy

    from sdf3d_tpu_torch.diff import coverage, depth_implicit, render_diff
    from sdf3d_tpu_torch.camera import focal_z
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene, fit_scene_multiview, fit_view
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel
    from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig, render_neural_forward, render_neural_launch
    from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff
    from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, pack_uniforms, render_kernel_forward, render_kernel_launch
    from sdf3d_tpu_torch.ops.scene_program import leaves, scene_param_vector
    from sdf3d_tpu_torch.parallel import ring_kernel
    from sdf3d_tpu_torch.sdf.transforms import rotvec_to_matrix
    from sdf3d_tpu_torch.utils.parity import check_grads, check_planes, conditioned, gradient_mass, primals_agree, \
        razor_edge

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    black = dataclasses.replace(full, background=(0.0, 0.0, 0.0))
    kc = KernelConfig()
    ref_cam = tt.Camera.reference(device=dev)
    reference = tt.reference_scene().to(dev)
    frozen, trainable = (0, 1, 2, 3), (False, False, True, True)
    counters = (render_kernel_forward, fit_step_kernel, render_kernel_backward, render_neural_forward,
                ring_kernel.ring_allreduce, ring_kernel.rs_ag_allreduce)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)

    def start():  # the fit demo's start (phase 10)
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters if fn.launches}

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def view_leaves():
        """The reference camera, light and material, every tensor a leaf
        that takes a gradient."""
        objs = (tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev))
        for obj in objs:
            for f in dataclasses.fields(obj):
                getattr(obj, f.name).requires_grad_(True)
        return objs

    def object_grads(sc, cam_, light_, mat_):
        """The gradients in the uniforms' order: the scene's leaves, then the
        camera's position, rotation and field of view, the light's position
        and ambient, the material's four fields (the light's colour reaches
        no pixel)."""
        tensors = [*leaves(sc), cam_.position, cam_.c2w, cam_.fov_deg, light_.position, light_.ambient,
                   *(getattr(mat_, f.name) for f in dataclasses.fields(mat_))]
        return torch.cat([(x.grad if x.grad is not None else torch.zeros_like(x)).reshape(-1) for x in tensors])

    def ms_step(res, n_px=W * H):
        return n_px / res.rays_per_second * 1e3

    # ---- 48. diff.py on the card at 1920x1080 ----
    prm, uni = inputs(reference, ref_cam, full)
    k1 = render_kernel_launch(reference, prm, uni, full)
    with torch.no_grad():
        img = render_diff(reference, ref_cam, light, mat, full)
        depth = depth_implicit(reference, ref_cam, full)
    frame = tt.render_batch(reference, [ref_cam], light, mat, full, engine="torch", device=dev)[0]
    torch.cuda.synchronize()
    check(torch.equal(img, frame), "render_diff's image is not render_batch(engine='torch')'s bit for bit")
    # The image and the t plane against K1's; K1 marches no shadow where
    # N·I ≤ 0 (its plane reads 1 there), so its shadow and AO planes stand in
    # for the torch path's: the image holds the shadow's effect.
    torch_planes = (img.permute(2, 0, 1), depth, k1[2], k1[3])
    vs_k1 = check_planes(torch_planes, k1, full.march.max_distance, "render_diff and depth_implicit vs K1 1080p",
                         razor=lambda: razor_edge(reference, prm, uni, full))
    # The gradient of a seeded cotangent through render_diff against the
    # differentiable kernel render (K1, K5 in its P + 30 form), each on its
    # own march: on the pixels where the primals agree and the gradient is
    # conditioned.
    keep = primals_agree(k1, torch_planes, full.march.max_distance) & conditioned(reference, prm, uni, k1[1], full)
    g_rgb = (torch.randn((3, H, W), generator=gen, device=dev) * keep).contiguous()
    sc_k, view_k = copy.deepcopy(reference), view_leaves()
    reset()
    with BackwardModes() as modes:
        (render_kernel_diff(full, kc, sc_k, *view_k) * g_rgb.permute(1, 2, 0)).sum().backward()
    torch.cuda.synchronize()
    grad_launches, grad_modes = launches(), list(modes.calls)
    check(grad_launches == {"render_kernel_forward": 1, "render_kernel_backward": 1} and grad_modes == [True],
          f"render_kernel_diff launched {grad_launches}, K5 forms {grad_modes}")
    sc_d, view_d = copy.deepcopy(reference), view_leaves()
    reset()
    (render_diff(sc_d, *view_d, full) * g_rgb.permute(1, 2, 0)).sum().backward()
    torch.cuda.synchronize()
    check(launches() == {}, f"render_diff launched {launches()}")
    P = prm.numel()
    mass = gradient_mass(reference, prm, uni, g_rgb, k1[1], k1[2], k1[3], full)
    fov = torch.tensor(60.0, device=dev, requires_grad=True)
    focal_z(fov, full.ray_mode).backward()
    mass_obj = mass[:P + 27].clone()
    mass_obj[P + 12] *= fov.grad.abs()  # the field of view's chain factor into the focal slot
    got_d, want_k = object_grads(sc_d, *view_d), object_grads(sc_k, *view_k)
    grads48 = check_grads(got_d, want_k, mass_obj, rtol=1e-4, mass_tol=1e-3, label="render_diff vs K1 + K5 1080p")
    check(float(got_d[:P].abs().max()) > 0.0 and float(got_d[P:].abs().max()) > 0.0, "render_diff: zero gradients")
    # Coverage against K3's silhouette term at the fit demo's start: the
    # fused step's loss (L2 + 0.5·Σ(coverage − mask)²) against the same sum
    # through render_diff and diff.coverage.
    target_black = render_kernel_forward(reference, ref_cam, light, mat, black, device=dev)[0]
    cov_t = (target_black.abs().amax(-1) > 1e-3).to(torch.float32).contiguous()
    sc = start()
    prm_s, uni_s = inputs(sc, ref_cam, black)
    tb_planar = target_black.permute(2, 0, 1).contiguous()
    k3 = fit_step_kernel(sc, prm_s, uni_s, tb_planar, black, kc, False, frozen, sum_dtype=torch.float64, sil_w=0.5,
                         target_coverage=cov_t)
    k3_l2 = fit_step_kernel(sc, prm_s, uni_s, tb_planar, black, kc, False, frozen, sum_dtype=torch.float64)
    o, d = tt.camera_rays(ref_cam, W, H, black.ray_mode)
    with torch.no_grad():
        cov = coverage(black.march, sc, o, d)
        sil = 0.5 * ((cov - cov_t).double() ** 2).sum()
        torch_loss = ((render_diff(sc, ref_cam, light, mat, black) - target_black).double() ** 2).sum() + sil
    loss_rel = abs(float(torch_loss) / float(k3[0]) - 1.0)
    sil_rel = abs(float(sil) / float(k3[0] - k3_l2[0]) - 1.0)
    check(loss_rel <= 1e-5, f"coverage: the torch engine's loss off K3's silhouette loss by {loss_rel:.3g}")
    log("diff_parity_1080p", card=card, render_batch_equal=True, vs_k1={n: {q: v[q] for q in ("over_atol",
        "max_abs_err", "over_hard")} for n, v in vs_k1.items()}, grad_launches=grad_launches,
        grad_pixels=int(keep.sum()), grads=grads48, coverage_loss_rel_err=loss_rel,
        coverage_term_rel_err=sil_rel, coverage_term=float(sil))

    # ---- 49. main path at 1920x1080: the fit demo on the torch engine, and
    # the silhouette term outside the fused step on K1 + K5 ----
    target_full = render_kernel_forward(reference, ref_cam, light, mat, full, device=dev)[0]
    pert = 0.06
    rot = rotvec_to_matrix(pert * torch.tensor([0.3, 0.8, -0.3], device=dev))
    cam0 = tt.Camera(position=ref_cam.position + pert * torch.tensor([1.0, -0.7, 1.3], device=dev),
                     c2w=(rot[:, :, None] * ref_cam.c2w[None, :, :]).sum(1), fov_deg=ref_cam.fov_deg)
    with torch.no_grad():
        cov_true = coverage(full.march, reference, o, d)
    cams2 = [tt.Camera.orbit(azimuth_deg=(137.508 * i) % 360.0, device=dev) for i in range(2)]
    c720 = dataclasses.replace(full, width=1280, height=720)
    targets2 = [render_kernel_forward(reference, c, light, mat, c720, device=dev)[0] for c in cams2]
    fc = dict(learning_rate=1e-2, log_every=1)
    view_fc = dict(learning_rate=2e-3, log_every=1, silhouette_weight=1.0)
    main, fits, secs = {}, {}, {}
    # Each run logs every step to a StepClock: its ms a step leaves the first
    # step (set-up) out.
    runs = {
        "fit_scene_torch": lambda lg: fit_scene(target_full, start(), ref_cam, light, mat, full,
                                                FitConfig(steps=5, engine="torch", **fc), trainable=trainable,
                                                device=dev, logger=lg),
        "fit_scene_kernel_step0": lambda lg: fit_scene(target_full, start(), ref_cam, light, mat, full,
                                                       FitConfig(steps=1, **fc), trainable=trainable, device=dev),
        "fit_view_torch": lambda lg: fit_view(target_full, reference, cam0, light, mat, full,
                                              FitConfig(steps=5, engine="torch", **view_fc), target_coverage=cov_true,
                                              device=dev, logger=lg),
        "fit_view_nonfused": lambda lg: fit_view(target_full, reference, cam0, light, mat, full,
                                                 FitConfig(steps=5, loss="multiscale", pyramid_levels=4, **view_fc),
                                                 target_coverage=cov_true, device=dev, logger=lg),
        "fit_scene_silhouette_nonfused": lambda lg: fit_scene(
            target_black, start(), ref_cam, light, mat, black,
            FitConfig(steps=5, loss="multiscale", pyramid_levels=4, silhouette_weight=0.5, **fc), trainable=trainable,
            device=dev, logger=lg),
        "fit_scene_multiview_torch": lambda lg: fit_scene_multiview(
            targets2, start(), cams2, light, mat, c720, FitConfig(steps=3, engine="torch", **fc), trainable=trainable,
            device=dev, logger=lg),
    }
    clocks = {}
    with PlainCalls() as plain, BackwardModes() as modes:
        for name, run in runs.items():
            mark = len(modes.calls)
            reset()
            clocks[name] = StepClock()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fits[name] = run(clocks[name])
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            main[name] = {"launches": launches(), "render_bwd_wrt_uniforms": modes.calls[mark:]}
    check(sum(plain.calls.values()) == 0, f"the torch engine's main path called plain versions: {plain.calls}")
    want_counts = {"fit_scene_torch": {}, "fit_scene_kernel_step0": {"fit_step_kernel": 1}, "fit_view_torch": {},
                   "fit_view_nonfused": {"render_kernel_forward": 5, "render_kernel_backward": 5},
                   "fit_scene_silhouette_nonfused": {"render_kernel_forward": 5, "render_kernel_backward": 5},
                   "fit_scene_multiview_torch": {}}
    for name, want in want_counts.items():
        check(main[name]["launches"] == want, f"{name} launched {main[name]['launches']}, expected {want}")
    check(main["fit_view_nonfused"]["render_bwd_wrt_uniforms"] == [True] * 5 and
          main["fit_scene_silhouette_nonfused"]["render_bwd_wrt_uniforms"] == [False] * 5,
          f"K5's forms: {main}")
    for name, res in fits.items():
        check(all(math.isfinite(v) for v in res.losses), f"{name}: a non-finite loss")
        check(len(res.losses) < 2 or res.losses[-1] < res.losses[0],
              f"{name}: the loss did not fall ({res.losses[0]} -> {res.losses[-1]})")
    step0_rel = abs(fits["fit_scene_torch"].losses[0] / fits["fit_scene_kernel_step0"].losses[0] - 1.0)
    check(step0_rel <= 1e-4, f"fit_scene(engine='torch') step 0 off the kernel engine's by {step0_rel:.3g}")
    ms49 = {n: c.ms_per_step() for n, c in clocks.items() if len(c.times) > 1}
    # The device's time in a torch-engine step (torch.profiler: the render's
    # forward and backward); the rest of the step's host-clock ms is the
    # host's (the marches read their active masks once a march step).
    sc_t = start()
    params_t = [q for q in sc_t.parameters() if q.requires_grad]

    def torch_step():
        loss = ((render_diff(sc_t, ref_cam, light, mat, full) - target_full) ** 2).sum()
        torch.autograd.grad(loss, params_t)

    prof = device_us(torch, torch_step, calls=2)
    busy_ms = prof["total_us"] / 1e3
    top = sorted(prof["kernels_us"].items(), key=lambda kv: -kv[1])[:5]
    log("diff_main_path", card=card, launches=main, losses={n: r.losses for n, r in fits.items()},
        ms_per_step=ms49, seconds=secs, step0_rel_err_vs_kernel=step0_rel,
        torch_engine_device_busy_ms=busy_ms, torch_engine_idle_share=1.0 - busy_ms / ms49["fit_scene_torch"],
        torch_engine_top_kernels_us=top)

    # ---- 50. item 17a: the NeuralSDF fit at 1920x1080 on K6 ----
    ref = tt.REFERENCE_CONFIG
    ncfg = dataclasses.replace(ref, width=W, height=H, march=dataclasses.replace(ref.march, max_steps=64),
                               shadow=dataclasses.replace(ref.shadow, max_steps=32))
    blobs = tt.sdf.smooth_union(tt.sdf.sphere((-0.12, 0.4, 0.0), 0.18), tt.sdf.sphere((0.15, 0.48, 0.0), 0.14), k=0.08)
    ngen = torch.Generator(device=dev)
    ngen.manual_seed(0)
    model, _ = tt.sdf.distill(tt.sdf.neural_sdf(ngen, hidden=64, depth=3, radius=0.3), blobs.to(dev), 1, steps=400,
                              batch=4096, lo=(-0.6, -0.2, -0.6), hi=(0.6, 1.0, 0.6))
    nscene = tt.sdf.ground_plane().to(dev) | model
    ntarget = tt.render((tt.sdf.ground_plane() | blobs).to(dev), ref_cam, light, mat, ncfg)
    n_trainable = (False, False) + (True,) * (len(list(leaves(nscene))) - 2)
    nfc = dict(learning_rate=1e-4, log_every=1)
    # One step's gradient (and the library's build) first: finite, every
    # weight tensor's non-zero.
    sc = copy.deepcopy(nscene)
    reset()
    img = render_kernel_diff(ncfg, kc, sc, ref_cam, light, mat)
    ((img - ntarget) ** 2).sum().backward()
    grad_launches = launches()
    mlp_grads = [w.grad for w in sc.b.weights] + [b.grad for b in sc.b.biases] + [sc.b.beta.grad]
    check(grad_launches == {"render_neural_forward": 1}, f"render_kernel_diff (neural) launched {grad_launches}")
    check(all(g is not None and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in mlp_grads[:3]),
          "the neural fit's MLP gradient is missing, non-finite or zero")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with PlainCalls() as plain:
        reset()
        k_clock = StepClock()
        kfit = fit_scene(ntarget, nscene, ref_cam, light, mat, ncfg, FitConfig(steps=5, **nfc), trainable=n_trainable,
                         device=dev, logger=k_clock)
        k_launches = launches()
    k_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(k_launches == {"render_neural_forward": 5}, f"the neural fit launched {k_launches}, expected K6 = 5")
    # The neural family's backward is the planar shade re-traced (no backward
    # kernel, as JAX's): one plain reverse pass a step, nothing else plain.
    check(plain.calls["planar_vjp"] == 5 and sum(plain.calls.values()) == 5,
          f"the neural fit called plain versions {plain.calls}")
    fitted = scene_param_vector(kfit.scene)
    check(bool(torch.isfinite(fitted).all()) and not torch.equal(fitted, scene_param_vector(nscene)) and
          kfit.losses[-1] < kfit.losses[0], f"the neural fit: losses {kfit.losses}")
    torch.cuda.reset_peak_memory_stats(dev)
    reset()
    t_clock = StepClock()
    tfit = fit_scene(ntarget, nscene, ref_cam, light, mat, ncfg, FitConfig(steps=2, engine="torch", **nfc),
                     trainable=n_trainable, device=dev, logger=t_clock)
    t_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(launches() == {}, f"the torch engine's neural step launched {launches()}")
    n_rel = abs(kfit.losses[0] / tfit.losses[0] - 1.0)
    check(n_rel <= 1e-3, f"the neural fit's step 0 off the torch engine's by {n_rel:.3g} (NEURAL_BAR class: 1e-3)")
    nprm, nuni = inputs(nscene, ref_cam, ncfg)
    k6_ms = time_ms(lambda: render_neural_launch(nscene, nprm, nuni, ncfg, NeuralRenderConfig()), 1, 5)
    n_ms = k_clock.ms_per_step()
    log("neural_fit_main_path", card=card, launches=k_launches, losses=kfit.losses, torch_engine_losses=tfit.losses,
        step0_rel_err_vs_torch_engine=n_rel, ms_per_step=n_ms, k6_ms=k6_ms, k6_share=k6_ms / n_ms,
        torch_engine_ms_per_step=t_clock.ms_per_step(), peak_gib={"kernel_engine": k_peak, "torch_engine": t_peak},
        grad_abs_max=[float(g.abs().max()) for g in mlp_grads])

    # ---- 51. item 17b: two processes on the card, the sharded NeuralSDF fit
    # and the torch engine's sharded fit ----
    ring_kernel.collectives_library()  # built here, before the ranks start
    steps, allreduces = 3, ("psum", "pallas_ring", "pallas_rs_ag")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        files = {k: os.path.join(tmp, f"{k}.pt") for k in ("scene", "neural_target", "reference_target")}
        torch.save(copy.deepcopy(nscene).cpu(), files["scene"])
        torch.save(ntarget.cpu(), files["neural_target"])
        torch.save(target_full.cpu(), files["reference_target"])
        pair = spawn_ranks(NEURAL_FIT, 2, {**files, "size": [W, H], "allreduces": list(allreduces), "steps": steps,
                                           "lr": nfc["learning_rate"], "trainable": list(n_trainable)})
    # The unsharded references: the torch engine, whose march the ranks' bands run.
    reset()
    nref = fit_scene(ntarget, nscene, ref_cam, light, mat, ncfg, FitConfig(steps=steps, engine="torch", **nfc),
                     trainable=n_trainable, device=dev)
    rref = fit_scene(target_full, start(), ref_cam, light, mat, full, FitConfig(steps=steps, engine="torch", **fc),
                     trainable=trainable, device=dev)
    check(launches() == {}, f"the torch engine's references launched {launches()}")
    nref_p, rref_p = scene_param_vector(nref.scene).cpu(), scene_param_vector(rref.scene).cpu()
    want_launches = {"psum": (0, 0), "pallas_ring": (0, steps), "pallas_rs_ag": (0, steps)}
    diffs = {}
    for r in pair:
        check(r["backend"] == "gloo" and r["size"] == 2, f"rank {r['rank']}: {r['backend']}, size {r['size']}")
        for name in allreduces:
            run = r["runs"][name]
            ring_n, rs_ag_n = run["launches"]["ring_allreduce"], run["launches"]["rs_ag_allreduce"]
            check((ring_n, rs_ag_n) == want_launches[name] and run["launches"]["render_neural_forward"] == 0,
                  f"rank {r['rank']} {name}: launches {run['launches']}")
            check(run["all_reduce_calls"] == (steps if name == "psum" else 0) and run["plain_calls"] == 0,
                  f"rank {r['rank']} {name}: {run['all_reduce_calls']} dist.all_reduce, {run['plain_calls']} plain")
        check(sum(r["runs"]["torch_engine"]["launches"].values()) == 0, "the sharded torch engine launched a kernel")
    for name in (*allreduces, "torch_engine"):
        a, b = (r["runs"][name] for r in pair)
        check(a["losses"] == b["losses"] and a["params"] == b["params"], f"{name}: the two ranks differ")
        want_l, want_p = (nref.losses, nref_p) if name != "torch_engine" else (rref.losses, rref_p)
        got_p = torch.tensor(a["params"])
        loss_rel = max(abs(x / y - 1.0) for x, y in zip(a["losses"], want_l))
        p_over = float(((got_p - want_p).abs() - 1e-4 * want_p.abs()).max())
        diffs[name] = {"loss_rel_err": loss_rel, "params_max_abs_err": float((got_p - want_p).abs().max()),
                       "params_over_rtol": p_over}
        check(loss_rel <= 1e-5 and p_over <= 1e-6, f"{name}: off the unsharded fit by {diffs[name]}")
    k6_rel = abs(pair[0]["runs"]["pallas_ring"]["losses"][0] / kfit.losses[0] - 1.0)
    check(k6_rel <= 1e-3, f"the sharded neural fit's step 0 off the K6 fit's by {k6_rel:.3g}")
    log("neural_fit_sharded", card=card, note="two processes sharing one card over gloo; times claim nothing",
        launches={n: [r["runs"][n]["launches"] for r in pair] for n in (*allreduces, "torch_engine")},
        vs_unsharded=diffs, step0_rel_err_vs_k6_fit=k6_rel,
        ms_per_step={n: pair[0]["runs"][n]["ms_per_step"] for n in (*allreduces, "torch_engine")},
        peak_gib=[r["peak_gib"] for r in pair], losses={n: pair[0]["runs"][n]["losses"] for n in pair[0]["runs"]})
    return {
        "render_fwd": {"fit_view_nonfused": {"launches": main["fit_view_nonfused"]["launches"]["render_kernel_forward"],
                                             "ms_per_step": ms49["fit_view_nonfused"]}},
        "render_bwd": {"fit_view_nonfused": {"launches": main["fit_view_nonfused"]["launches"]["render_kernel_backward"],
                                             "wrt_uniforms": True, "max_abs_err": grads48["max_abs_err"],
                                             "ms_per_step": ms49["fit_view_nonfused"]}},
        "neural_fwd": {"fit": {"launches": k_launches["render_neural_forward"], "ms_per_step": n_ms, "ms": k6_ms,
                               "k6_share": k6_ms / n_ms, "step0_rel_err_vs_torch_engine": n_rel}},
        "ring_allreduce": {"neural_fit": {"launches": pair[0]["runs"]["pallas_ring"]["launches"]["ring_allreduce"]}},
        "rs_ag_allreduce": {"neural_fit": {
            "launches": pair[0]["runs"]["pallas_ring"]["launches"]["rs_ag_allreduce"],
            "launches_forced": pair[0]["runs"]["pallas_rs_ag"]["launches"]["rs_ag_allreduce"],
            "ms_per_step": pair[0]["runs"]["pallas_ring"]["ms_per_step"]}},
    }


ROWS_FIT = r"""
import json, os, sys, time
port, rank, outdir, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import dataclasses
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import sdf3d_tpu_torch as tt
from sdf3d_tpu_torch.fit import FitConfig, fit_scene
from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel
from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward
from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, render_kernel_forward
from sdf3d_tpu_torch.ops.scene_program import leaves, scene_param_vector
from sdf3d_tpu_torch.parallel import allreduce_tree, launch, make_mesh, render_sharded
from chip_smoke import StepClock

spec = json.load(open(os.path.join(outdir, "spec.json")))
launch.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)  # two ranks, one card: gloo
mesh = make_mesh()
dev = mesh.device
W, H = spec["size"]
full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
ad = dataclasses.replace(full, shadow=dataclasses.replace(full.shadow, grad="ad"))
cam, light, mat = tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev)
target = torch.load(spec["target"], map_location=dev)
counters = (render_kernel_forward, render_kernel_backward, fit_step_kernel)
runs = {}
for layout in spec["layouts"]:
    for fn in counters:
        fn.launches = 0
    start = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)
    clock = StepClock()
    torch.cuda.reset_peak_memory_stats(dev)
    res = fit_scene(target, start, cam, light, mat, ad, FitConfig(steps=spec["steps"], learning_rate=1e-2, log_every=1,
                    shard_layout=layout), mesh=mesh, trainable=(False, False, True, True), logger=clock,
                    kernel_config=KernelConfig(tile_h=spec["tile_h"][layout]))
    runs[layout] = {"losses": res.losses, "params": scene_param_vector(res.scene).tolist(),
                    "launches": {fn.__name__: fn.launches for fn in counters},
                    "ms_per_step": clock.ms_per_step() if rank == 0 else None,
                    "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
for fn in counters:
    fn.launches = 0
scene = tt.reference_scene().to(dev)
t0 = time.perf_counter()
img = render_sharded(scene, cam, light, mat, full, mesh)
torch.cuda.synchronize()
plain_s = time.perf_counter() - t0
g = torch.load(spec["cotangent"], map_location=dev)
t0 = time.perf_counter()
img_d = render_sharded(scene, cam, light, mat, full, mesh, differentiable=True)
(img_d * g).sum().backward()
grads = allreduce_tree([x.grad.reshape(-1) for x in leaves(scene)], "psum", mesh)
torch.cuda.synchronize()
diff_s = time.perf_counter() - t0
if rank == 0:
    torch.save({"plain": img.cpu(), "differentiable": img_d.detach().cpu()}, spec["images"])
with open(os.path.join(outdir, f"out_r{rank}.json"), "w") as f:
    json.dump({"rank": mesh.rank, "size": mesh.size, "backend": torch.distributed.get_backend(), "runs": runs,
               "render_sharded_launches": {fn.__name__: fn.launches for fn in counters},
               "render_sharded_seconds": {"plain": plain_s, "differentiable": diff_s},
               "render_sharded_grad": torch.cat(grads).tolist()}, f)
launch.shutdown()
"""


def slice17_phases(torch, tt, card: str, dev) -> dict:
    """Phases 52-56: the rest of the differentiable render (ROADMAP 12, 15b,
    14, part of 16), on the kernels K1, K5 and K6 and on torch: the
    ``shadow.grad == "ad"`` route (K1 forward, the planar re-trace with the
    shadow re-marched as backward), the neural render under it (K6), the
    row-slab render of sharded fits outside the fused step (K1 + K5 per
    rank) and ``render_sharded``, a ``VoxelGrid``, stereo, depth and the
    debug checks.  Returns the kernels line's ``shadow_ad``, ``rows`` and
    ``stereo`` entries of ``render_fwd``, ``rows`` of ``render_bwd`` and
    ``shadow_ad`` of ``neural_fwd``.  Runnable alone (after
    ``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    import copy

    from sdf3d_tpu_torch import cli, debug
    from sdf3d_tpu_torch.camera import focal_z
    from sdf3d_tpu_torch.diff import depth_implicit, render_diff
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene, fit_view
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel
    from sdf3d_tpu_torch.ops.neural_kernel import (
        NeuralRenderConfig,
        neural_distance,
        render_neural,
        render_neural_forward,
        render_neural_launch,
    )
    from sdf3d_tpu_torch.ops.render_autograd import render_kernel_diff
    from sdf3d_tpu_torch.ops.render_bwd_kernel import planar_vjp, render_kernel_backward
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, pack_uniforms, pixel_planes, \
        render_kernel_forward, render_kernel_forward_plain, render_kernel_launch
    from sdf3d_tpu_torch.ops.scene_program import leaves, scene_param_vector
    from sdf3d_tpu_torch.utils.parity import check_grads, check_planes, conditioned, gradient_mass, primals_agree, \
        razor_edge

    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    ad = dataclasses.replace(full, shadow=dataclasses.replace(full.shadow, grad="ad"))
    kc = KernelConfig()
    ref_cam = tt.Camera.reference(device=dev)
    reference = tt.reference_scene().to(dev)
    trainable = (False, False, True, True)
    counters = (render_kernel_forward, render_kernel_backward, fit_step_kernel, render_neural_forward)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)

    def start():  # the fit demo's start (phase 10)
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=(0.05, 0.45, 0.0), radius=0.25)).to(dev)

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters if fn.launches}

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def view_leaves():
        objs = (tt.Camera.reference(device=dev), tt.reference_light(device=dev), tt.reference_material(device=dev))
        for obj in objs:
            for f in dataclasses.fields(obj):
                getattr(obj, f.name).requires_grad_(True)
        return objs

    def object_grads(sc, cam_, light_, mat_):
        tensors = [*leaves(sc), cam_.position, cam_.c2w, cam_.fov_deg, light_.position, light_.ambient,
                   *(getattr(mat_, f.name) for f in dataclasses.fields(mat_))]
        return torch.cat([(x.grad if x.grad is not None else torch.zeros_like(x)).reshape(-1) for x in tensors])

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30

    def fresh_peak():
        # The peak of allocated memory from here; the cache is kept (a timed
        # call after an emptied cache would time cudaMalloc's).
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- 52. shadow.grad == "ad" at 1920x1080 on the reference scene ----
    prm, uni = inputs(reference, ref_cam, full)
    k1 = render_kernel_launch(reference, prm, uni, full)
    with torch.no_grad():
        torch_planes = (render_diff(reference, ref_cam, light, mat, ad).permute(2, 0, 1),
                        depth_implicit(reference, ref_cam, ad), k1[2], k1[3])
    keep = primals_agree(k1, torch_planes, full.march.max_distance) & conditioned(reference, prm, uni, k1[1], full)
    g_rgb = (torch.randn((3, H, W), generator=gen, device=dev) * keep).contiguous()
    sc_k, view_k = copy.deepcopy(reference), view_leaves()
    # One call first (the lazy set-up of the re-march's elementwise kernels),
    # then the counted and timed one.
    (render_kernel_diff(ad, kc, copy.deepcopy(reference), *view_leaves()) * g_rgb.permute(1, 2, 0)).sum().backward()
    fresh_peak()
    reset()
    with PlainCalls() as plain, BackwardModes() as modes:
        t0 = time.perf_counter()
        img_k = render_kernel_diff(ad, kc, sc_k, *view_k)
        (img_k * g_rgb.permute(1, 2, 0)).sum().backward()
        torch.cuda.synchronize()
        ad_ms = (time.perf_counter() - t0) * 1e3
    ad_peak, ad_launches, ad_plain = peak_gib(), launches(), dict(plain.calls)
    check(ad_launches == {"render_kernel_forward": 1} and modes.calls == [],
          f"render_kernel_diff under 'ad' launched {ad_launches}, K5 forms {modes.calls}")
    check(ad_plain["planar_vjp"] == 1 and sum(ad_plain.values()) == 1, f"the 'ad' route's plain calls {ad_plain}")
    check(torch.equal(img_k.detach().permute(2, 0, 1), k1[0]), "the 'ad' primal is not K1's image bit for bit")
    got_k = object_grads(sc_k, *view_k)
    del img_k
    # The torch engine under "ad" (diff.py records the shadow's march), each
    # on its own march, at the own-march bar where the primals agree.
    sc_d, view_d = copy.deepcopy(reference), view_leaves()
    fresh_peak()
    (render_diff(sc_d, *view_d, ad) * g_rgb.permute(1, 2, 0)).sum().backward()
    torch_peak = peak_gib()
    got_d = object_grads(sc_d, *view_d)
    fresh_peak()
    P = prm.numel()
    mass = gradient_mass(reference, prm, uni, g_rgb, k1[1], k1[2], k1[3], full, remarch_shadow=True)
    mass_peak = peak_gib()
    fov = torch.tensor(60.0, device=dev, requires_grad=True)
    focal_z(fov, full.ray_mode).backward()
    mass_obj = mass[:P + 27].clone()
    mass_obj[P + 12] *= fov.grad.abs()
    grads52 = check_grads(got_k, got_d, mass_obj, rtol=1e-4, mass_tol=1e-3, label="'ad' route vs the torch engine 1080p")
    # The re-march's share: the light's gradient under "detach" (K1 + K5) differs.
    sc_0, view_0 = copy.deepcopy(reference), view_leaves()
    (render_kernel_diff(full, kc, sc_0, *view_0) * g_rgb.permute(1, 2, 0)).sum().backward()
    share = float((view_0[1].position.grad - view_k[1].position.grad).abs().max()
                  / view_k[1].position.grad.abs().max())
    check(share > 1e-3, f"the 'ad' light gradient equals the detached one within {share:.3g}")
    # Main path: the fit demo and the pose fit under "ad".
    target_full = render_kernel_forward(reference, ref_cam, light, mat, full, device=dev)[0]
    cam0 = tt.Camera(position=ref_cam.position + 0.06 * torch.tensor([1.0, -0.7, 1.3], device=dev), c2w=ref_cam.c2w,
                     fov_deg=ref_cam.fov_deg)
    fits, main52, clocks, peaks = {}, {}, {}, {}
    runs = {
        "fit_scene_ad": lambda lg: fit_scene(target_full, start(), ref_cam, light, mat, ad,
                                             FitConfig(steps=5, learning_rate=1e-2, log_every=1), trainable=trainable,
                                             device=dev, logger=lg),
        "fit_scene_detach_step0": lambda lg: fit_scene(target_full, start(), ref_cam, light, mat, full,
                                                       FitConfig(steps=1, learning_rate=1e-2), trainable=trainable,
                                                       device=dev),
        "fit_view_ad": lambda lg: fit_view(target_full, reference, cam0, light, mat, ad,
                                           FitConfig(steps=5, learning_rate=2e-3, log_every=1), device=dev,
                                           logger=lg),
    }
    with PlainCalls() as plain:
        for name, run in runs.items():
            mark = dict(plain.calls)
            fresh_peak()
            reset()
            clocks[name] = StepClock()
            fits[name] = run(clocks[name])
            torch.cuda.synchronize()
            peaks[name] = peak_gib()
            main52[name] = {"launches": launches(), "planar_vjp": plain.calls["planar_vjp"] - mark["planar_vjp"]}
    want52 = {"fit_scene_ad": {"render_kernel_forward": 5}, "fit_scene_detach_step0": {"fit_step_kernel": 1},
              "fit_view_ad": {"render_kernel_forward": 5}}
    for name, want in want52.items():
        check(main52[name]["launches"] == want, f"{name} launched {main52[name]['launches']}, expected {want}")
    check(main52["fit_scene_ad"]["planar_vjp"] == 5 and main52["fit_view_ad"]["planar_vjp"] == 5,
          f"the 'ad' fits' backwards: {main52}")
    for name in ("fit_scene_ad", "fit_view_ad"):
        res = fits[name]
        check(all(math.isfinite(v) for v in res.losses) and res.losses[-1] < res.losses[0],
              f"{name}: losses {res.losses}")
    step0_rel = abs(fits["fit_scene_ad"].losses[0] / fits["fit_scene_detach_step0"].losses[0] - 1.0)
    check(step0_rel <= 1e-5, f"the 'ad' fit's step 0 off the fused step's loss by {step0_rel:.3g}")
    ms52 = {n: c.ms_per_step() for n, c in clocks.items() if len(c.times) > 1}
    log("shadow_ad_1080p", card=card, launches=ad_launches, plain_calls=ad_plain, grad_pixels=int(keep.sum()),
        grads_vs_torch_engine=grads52, light_share_vs_detach=share, fwd_bwd_ms=ad_ms,
        peak_gib={"kernel_route": ad_peak, "torch_engine": torch_peak, "gradient_mass": mass_peak, **peaks},
        fits={n: {"launches": main52[n]["launches"], "losses": fits[n].losses} for n in fits},
        ms_per_step=ms52, step0_rel_err_vs_fused=step0_rel)
    del mass, got_d, got_k, sc_k, sc_d, sc_0

    # ---- 53. the neural render under "ad" at 960x540 (the re-march records
    # the MLP at every shadow step: 107-112 kB a pixel, about 54 GiB here) ----
    nw, nh = 960, 540
    ref = tt.REFERENCE_CONFIG
    ncfg = dataclasses.replace(ref, width=nw, height=nh, march=dataclasses.replace(ref.march, max_steps=64),
                               shadow=dataclasses.replace(ref.shadow, max_steps=32, grad="ad"))
    ngen = torch.Generator(device=dev)
    ngen.manual_seed(0)
    nscene = tt.sdf.ground_plane().to(dev) | tt.sdf.neural_sdf(ngen, hidden=64, depth=3, radius=0.3)
    nprm, nuni = inputs(nscene, ref_cam, ncfg)
    k6 = render_neural_launch(nscene, nprm, nuni, ncfg, NeuralRenderConfig())
    ng = torch.randn((3, nh, nw), generator=gen, device=dev)
    sc_n = copy.deepcopy(nscene)
    (render_neural(ncfg, NeuralRenderConfig(), copy.deepcopy(nscene), ref_cam, light, mat) * ng.permute(1, 2, 0))\
        .sum().backward()  # the first call's set-up, untimed
    fresh_peak()
    reset()
    t0 = time.perf_counter()
    img_n = render_neural(ncfg, NeuralRenderConfig(), sc_n, ref_cam, light, mat)
    (img_n * ng.permute(1, 2, 0)).sum().backward()
    torch.cuda.synchronize()
    n_ms, n_peak, n_launches = (time.perf_counter() - t0) * 1e3, peak_gib(), launches()
    check(n_launches == {"render_neural_forward": 1}, f"render_neural under 'ad' launched {n_launches}")
    check(torch.equal(img_n.detach().permute(2, 0, 1), k6[0]), "the neural 'ad' primal is not K6's image")
    got_n = torch.cat([x.grad.reshape(-1) for x in leaves(sc_n)])
    check(bool(torch.isfinite(got_n).all()) and float(got_n.abs().max()) > 0, "the neural 'ad' gradient")
    # The same re-trace on the CPU from K6's planes, on a 45x80 crop around
    # the median pixel of the penumbra's hits (same function, same planes, the MLP's
    # products in float32 on both).
    pen = ((k6[2] > 0.05) & (k6[2] < 0.8) & (k6[1] < ncfg.march.max_distance)).nonzero().float().median(0)\
        .values.long().tolist()
    r0, c0 = min(max(pen[0] - 22, 0), nh - 45), min(max(pen[1] - 40, 0), nw - 80)
    r1, c1 = r0 + 45, c0 + 80
    rows, cols = pixel_planes(nuni, nh, nw)
    crop = [x[..., r0:r1, c0:c1].contiguous() for x in (ng, *k6[1:], rows, cols)]

    def crop_vjp(scene_, dev_, remarch):
        args = [x.to(dev_) for x in crop]
        return planar_vjp(neural_distance(scene_), nprm.to(dev_), nuni.to(dev_), *args[:4], ncfg, pixels=args[4:],
                          wrt_uniforms=False, remarch_shadow=remarch)[0].cpu()

    cpu_scene = copy.deepcopy(nscene).to("cpu")
    got_c, want_c = crop_vjp(nscene, dev, True), crop_vjp(cpu_scene, "cpu", True)
    n_err = float((got_c - want_c).abs().max())
    n_rel = n_err / float(want_c.abs().max())
    check(n_rel <= 1e-4, f"the neural 'ad' gradient off the CPU re-trace by {n_rel:.3g} of its largest component")
    n_share = float((crop_vjp(nscene, dev, False) - want_c).abs().max() / want_c.abs().max())
    check(n_share > 1e-3, f"the neural 'ad' gradient equals the detached one within {n_share:.3g}")
    del img_n, sc_n
    blobs = tt.sdf.smooth_union(tt.sdf.sphere((-0.12, 0.4, 0.0), 0.18), tt.sdf.sphere((0.15, 0.48, 0.0), 0.14),
                                k=0.08)
    ntarget = tt.render((tt.sdf.ground_plane() | blobs).to(dev), ref_cam, light, mat, ncfg)
    n_trainable = (False, False) + (True,) * (len(list(leaves(nscene))) - 2)
    fresh_peak()
    reset()
    n_clock = StepClock()
    nfit = fit_scene(ntarget, nscene, ref_cam, light, mat, ncfg, FitConfig(steps=3, learning_rate=1e-4, log_every=1),
                     trainable=n_trainable, device=dev, logger=n_clock)
    nfit_launches, nfit_peak = launches(), peak_gib()
    check(nfit_launches == {"render_neural_forward": 3}, f"the neural 'ad' fit launched {nfit_launches}")
    check(all(math.isfinite(v) for v in nfit.losses), f"the neural 'ad' fit: losses {nfit.losses}")
    k6_ms = time_ms(lambda: render_neural_launch(nscene, nprm, nuni, ncfg, NeuralRenderConfig()), 1, 5)
    log(f"neural_shadow_ad_{nw}x{nh}", card=card, launches=n_launches, fwd_bwd_ms=n_ms, peak_gib=n_peak,
        crop=[r0, r1, c0, c1], grad_max_abs_err_vs_cpu=n_err, grad_rel_err_vs_cpu=n_rel, share_vs_detach=n_share,
        fit_launches=nfit_launches, fit_losses=nfit.losses, fit_ms_per_step=n_clock.ms_per_step(),
        fit_peak_gib=nfit_peak, k6_ms=k6_ms)

    # ---- 54. the row route: two processes on the card fit the fit demo at
    # 1080p under "ad" outside the fused step (K1 + K5 per rank's slab), and
    # render_sharded ----
    # Contiguous slabs take the default tiles (540 rows: a partial last tile
    # row, fit_scene(mesh)'s own choice at 1080p); two ranks interleave tile
    # rows of 12 (1080 = 2·12·45; the default 24 would need 1080 divisible by 48).
    steps, tile_h = 3, {"contiguous": kc.tile_h, "interleaved": 12}
    # The slabs' libraries, built together before the ranks start.
    _build.LIBRARIES.load_many(rows_jobs(tt))
    torch.cuda.empty_cache()
    g_img = torch.randn((H, W, 3), generator=gen, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        files = {k: os.path.join(tmp, f"{k}.pt") for k in ("target", "cotangent", "images")}
        torch.save(target_full.cpu(), files["target"])
        torch.save(g_img.cpu(), files["cotangent"])
        started = start_ranks(ROWS_FIT, 2, {**files, "size": [W, H], "steps": steps, "tile_h": tile_h,
                                            "layouts": ["contiguous", "interleaved"]})
        # The unsharded references, in this process while the ranks run.
        reset()
        ref_fit = fit_scene(target_full, start(), ref_cam, light, mat, full,
                            FitConfig(steps=steps, learning_rate=1e-2, log_every=1), trainable=trainable, device=dev)
        check(launches() == {"fit_step_kernel": steps}, f"the unsharded 'detach' fit launched {launches()}")
        frame = tt.render(reference, ref_cam, light, mat, full).cpu()
        sc_r = copy.deepcopy(reference)
        (render_diff(sc_r, ref_cam, light, mat, full) * g_img).sum().backward()
        want_g = torch.cat([x.grad.reshape(-1) for x in leaves(sc_r)])
        mass_r = gradient_mass(reference, prm, uni, g_img.permute(2, 0, 1).contiguous(), *k1[1:], full)[:P]
        pair = finish_ranks(started)
        images = torch.load(files["images"])
    ref_p = scene_param_vector(ref_fit.scene).cpu()
    rows54 = {}
    for r in pair:
        check(r["backend"] == "gloo" and r["size"] == 2, f"rank {r['rank']}: {r['backend']}, size {r['size']}")
        for layout, run in r["runs"].items():
            want = {"render_kernel_forward": steps, "render_kernel_backward": steps, "fit_step_kernel": 0}
            check(run["launches"] == want, f"rank {r['rank']} {layout}: launches {run['launches']}")
        check(sum(r["render_sharded_launches"].values()) == 0, "render_sharded launched a kernel")
    for layout in pair[0]["runs"]:
        a, b = (r["runs"][layout] for r in pair)
        check(a["losses"] == b["losses"] and a["params"] == b["params"], f"{layout}: the two ranks differ")
        loss_rel = max(abs(x / y - 1.0) for x, y in zip(a["losses"], ref_fit.losses))
        p_err = float((torch.tensor(a["params"]) - ref_p).abs().max())
        check(loss_rel <= 1e-5 and p_err <= 1e-5, f"{layout}: off the unsharded 'detach' fit by {loss_rel:.3g}, "
              f"params {p_err:.3g}")
        rows54[layout] = {"tile_h": tile_h[layout], "loss_rel_err": loss_rel, "params_max_abs_err": p_err, "ms_per_step": a["ms_per_step"],
                          "peak_gib": [r["runs"][layout]["peak_gib"] for r in pair]}
    check(torch.equal(images["plain"], frame) and torch.equal(images["differentiable"], frame),
          "render_sharded's image is not render's bit for bit")
    grads54 = check_grads(torch.tensor(pair[0]["render_sharded_grad"]), want_g.cpu(), mass_r.cpu(), rtol=1e-5,
                          mass_tol=1e-5, label="render_sharded's summed gradients vs render_diff 1080p")
    log("rows_1080p", card=card, note="two processes sharing one card over gloo; times claim nothing",
        launches={layout: pair[0]["runs"][layout]["launches"] for layout in pair[0]["runs"]}, vs_unsharded=rows54,
        render_sharded_seconds=pair[0]["render_sharded_seconds"], render_sharded_grads=grads54)

    # ---- 55. a VoxelGrid: a 128³ bake of a bounded scene beside the analytic
    # ground plane, rendered and fitted at 1080p on the banded route ----
    sphere = tt.sdf.sphere((0.0, 0.4, 0.0), 0.2).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = tt.sdf.voxelize(sphere, 128, lo=(-0.5, -0.1, -0.5), hi=(0.5, 0.9, 0.5))
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    gscene = tt.sdf.ground_plane().to(dev) | grid
    reset()
    t0 = time.perf_counter()
    img_t = tt.render_batch(gscene, [ref_cam], light, mat, full, engine="torch", device=dev)[0]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    with torch.no_grad():
        img_b = render_kernel_diff(full, kc, gscene, ref_cam, light, mat)
    check(launches() == {}, f"the grid's renders launched {launches()}")
    check(torch.equal(img_t, img_b), "the grid's banded image is not render_batch(engine='torch')'s bit for bit")
    analytic = render_kernel_forward(tt.sdf.ground_plane().to(dev) | sphere, ref_cam, light, mat, full, device=dev)[0]
    off = float(((img_t - analytic).abs().amax(-1) > 0.05).float().mean())
    check(off < 0.02, f"the grid's image is off the analytic scene's K1 render on {off:.3%} of pixels")
    try:
        tt.render_batch(gscene, [ref_cam], light, mat, full, engine="kernel", device=dev)
        raised = False
    except NotImplementedError as exc:
        raised = "VoxelGrid has no kernel" in str(exc)
    check(raised, "render_batch(engine='kernel') did not raise for the grid")
    gtarget = render_kernel_forward(tt.sdf.ground_plane().to(dev) | tt.sdf.sphere((0.0, 0.42, 0.0), 0.21).to(dev),
                                    ref_cam, light, mat, full, device=dev)[0]
    fresh_peak()
    reset()
    g_clock = StepClock()
    gfit = fit_scene(gtarget, gscene, ref_cam, light, mat, full, FitConfig(steps=3, learning_rate=1e-3, log_every=1),
                     trainable=(False, False, True, False, False), device=dev, logger=g_clock)
    gfit_peak, gfit_launches = peak_gib(), launches()
    check(gfit_launches == {}, f"the grid fit launched {gfit_launches}")
    check(all(math.isfinite(v) for v in gfit.losses) and not torch.equal(gfit.scene.b.values, grid.values),
          f"the grid fit: losses {gfit.losses}")
    log("voxel_grid_1080p", card=card, samples=list(grid.values.shape), bake_seconds=bake_s,
        render_batch_torch_seconds=render_s, pixels_off_analytic_over_0_05=off, fit_losses=gfit.losses,
        fit_ms_per_step=g_clock.ms_per_step(), fit_peak_gib=gfit_peak)

    # The grid tagged with a material of its own (ROADMAP 30): one forward
    # and backward of the differentiable render on the banded route, no
    # kernel; its image against K1's material branch on the analytic twin;
    # tagged with the global material, the untagged grid's image bit for bit.
    smat = tt.material(**SHADED_MATERIAL, device=dev)
    sscene = tt.sdf.ground_plane().to(dev) | tt.sdf.shaded(grid, smat)
    g_rgb = torch.randn((H, W, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset()
    img_s = render_kernel_diff(full, kc, sscene, ref_cam, light, mat)
    (img_s * g_rgb).sum().backward()
    torch.cuda.synchronize()
    shaded_s, shaded_launches = time.perf_counter() - t0, launches()
    check(shaded_launches == {}, f"the shaded grid's render and backward launched {shaded_launches}")
    check(all(bool(torch.isfinite(x.grad).all()) for x in leaves(sscene)), "the shaded grid's gradients are not finite")
    tag = sscene.b
    tag_grad = {f.name: getattr(tag, f.name).grad.reshape(-1).tolist() for f in dataclasses.fields(smat)}
    check(all(any(v != 0.0 for v in g) for g in tag_grad.values()), f"a Shaded material's gradient is 0: {tag_grad}")
    reset()
    analytic_s = render_kernel_forward(tt.sdf.ground_plane().to(dev) | tt.sdf.shaded(sphere, smat), ref_cam, light,
                                       mat, full, device=dev)[0]
    check(launches() == {"render_kernel_forward": 1}, f"K1's material branch launched {launches()}")
    off_s = float(((img_s.detach() - analytic_s).abs().amax(-1) > 0.05).float().mean())
    check(off_s < 0.02, f"the shaded grid's image is off K1's material branch on {off_s:.3%} of pixels")
    with torch.no_grad():
        img_g = render_kernel_diff(full, kc, tt.sdf.ground_plane().to(dev) | tt.sdf.shaded(grid, mat), ref_cam,
                                   light, mat)
    check(torch.equal(img_g, img_b), "a grid tagged with the global material is not the untagged grid's image")
    log("shaded_grid_1080p", card=card, forward_backward_seconds=shaded_s, launches=shaded_launches,
        shaded_material_grad=tag_grad, pixels_off_k1_material_over_0_05=off_s, global_tag_bit_equal=True)

    # ---- 56. stereo, depth and the debug checks at 1080p ----
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sbs = tt.render_stereo(reference, ref_cam, light, mat, full, mode="sbs", baseline=0.065, convergence=2.0,
                           device=dev)
    torch.cuda.synchronize()
    stereo_ms = (time.perf_counter() - t0) * 1e3
    stereo_launches = launches()
    check(stereo_launches == {"render_kernel_forward": 2}, f"render_stereo launched {stereo_launches}")
    eyes = tt.stereo_cameras(ref_cam, 0.065, 2.0)
    frames = [render_kernel_forward(reference, cam, light, mat, full, device=dev)[0] for cam in eyes]
    check(tuple(sbs.shape) == (H, 2 * W, 3) and torch.equal(sbs, torch.cat(frames, dim=1)),
          "render_stereo's sbs is not two K1 renders bit for bit")
    # Each eye of sbs against the plain version at that eye's toed-in camera,
    # at the pixel budget (razor-edge rays past the hard limit, as phase 47).
    stereo_st = []
    for half, cam in zip(sbs.split(W, dim=1), eyes):
        p_e, u_e = inputs(reference, cam, full)
        want_e = render_kernel_forward_plain(reference, p_e, u_e, full)
        stereo_st.append(check_planes((half.permute(2, 0, 1),), want_e[:1], full.march.max_distance,
                                      f"render_stereo sbs {len(stereo_st)} vs plain",
                                      razor=lambda p_e=p_e, u_e=u_e: razor_edge(reference, p_e, u_e, full))["rgb"])
    stereo_err = max(st["max_abs_err"] for st in stereo_st)
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "depth.png")
        t0 = time.perf_counter()
        check(cli.main(["render", "--depth", "--width", str(W), "--height", str(H), "--out", png]) == 0,
              "cli render --depth failed")
        depth_s = time.perf_counter() - t0
        with open(png, "rb") as f:
            head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[16:24] == W.to_bytes(4, "big") + H.to_bytes(4, "big"),
          "cli render --depth did not write a 1920x1080 PNG")
    check(launches() == {}, f"cli render --depth launched {launches()}")
    flagship = tt.flagship_scene().to(dev)
    t0 = time.perf_counter()
    err, img_f = debug.checked_render(flagship, ref_cam, light, mat, full)
    checked_s = time.perf_counter() - t0
    problems = debug.validate_scene(flagship)
    check(err.get() is None and problems == [] and bool(torch.isfinite(img_f).all()),
          f"the flagship's debug checks: {err.get()}, {problems}")
    log("stereo_depth_debug_1080p", card=card, stereo_launches=stereo_launches, stereo_ms=stereo_ms,
        stereo_vs_plain=[{q: st[q] for q in ("over_atol", "max_abs_err")} for st in stereo_st],
        cli_depth_seconds=depth_s, checked_render_seconds=checked_s, validate_scene=problems)

    return {
        "render_fwd": {
            "shadow_ad": {"launches": main52["fit_scene_ad"]["launches"]["render_kernel_forward"],
                          "fit_view_launches": main52["fit_view_ad"]["launches"]["render_kernel_forward"],
                          "ms_per_step": ms52["fit_scene_ad"], "fwd_bwd_ms": ad_ms, "peak_gib": ad_peak,
                          "grad_err_over_mass": grads52["err_over_mass"]},
            "rows": {"launches": pair[0]["runs"]["contiguous"]["launches"]["render_kernel_forward"],
                     "ms_per_step": rows54["contiguous"]["ms_per_step"],
                     "loss_rel_err": max(v["loss_rel_err"] for v in rows54.values())},
            "stereo": {"launches": stereo_launches["render_kernel_forward"], "ms": stereo_ms, "max_abs_err": stereo_err},
        },
        "render_bwd": {
            "rows": {"launches": pair[0]["runs"]["contiguous"]["launches"]["render_kernel_backward"],
                     "ms_per_step": rows54["contiguous"]["ms_per_step"],
                     "params_max_abs_err": max(v["params_max_abs_err"] for v in rows54.values())},
        },
        "neural_fwd": {
            "shadow_ad": {"launches": nfit_launches["render_neural_forward"], "size": [nw, nh], "ms": k6_ms,
                          "fwd_bwd_ms": n_ms, "ms_per_step": n_clock.ms_per_step(), "peak_gib": n_peak,
                          "grad_rel_err_vs_cpu": n_rel},
        },
    }


def decode_png(png: bytes):
    """An 8-bit RGB PNG of ``utils/image_io.encode_png`` (filter 0 rows) as
    an (H, W, 3) uint8 array."""
    import struct
    import zlib

    import numpy as np

    check(png[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(png):
        n, tag = struct.unpack(">I4s", png[pos:pos + 8])
        body = png[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not raw[:, 0].any(), "a PNG row with a filter")
    return raw[:, 1:].reshape(h, w, 3)


def http(url: str, data: bytes | None = None) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def first_stream_part(url: str, out: dict) -> None:
    """The first part of a ``multipart/x-mixed-replace`` stream: its
    content type and the part's bytes, into ``out``."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        out["content_type"] = r.headers.get("Content-Type", "")
        head = b""
        while b"\r\n\r\n" not in head:
            head += r.read(1)
        out["head"] = head
        out["body"] = r.read(int(re.search(rb"Content-Length: (\d+)", head).group(1)))


def start_lab(args: list, log_path: str):
    """A lab as a subprocess of this checkout, its output into ``log_path``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    f = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", *map(str, args)], cwd=REPO, env=env, stdout=f,
                            stderr=subprocess.STDOUT, text=True)
    atexit.register(kill_running, [proc])
    return proc, f


def wait_labs(running: dict, timeout: float = 600) -> dict:
    """Wait for every lab of ``running`` (name -> (process, log file, log
    path, start time)), then fail naming each one that exited non-zero.
    Returns name -> (its output, its seconds from its start)."""
    t0 = time.perf_counter()
    ends = {}
    try:
        while len(ends) < len(running) and time.perf_counter() - t0 < timeout:
            for name, (proc, _, _, start) in running.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - start
            time.sleep(0.05)
    finally:
        for proc, f, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    out = {name: (open(path).read(), ends.get(name)) for name, (_, _, path, _) in running.items()}
    failed = [f"{name} (exit {running[name][0].returncode}):\n{text[-3000:]}" for name, (text, _) in out.items()
              if running[name][0].returncode != 0]
    check(not failed, "labs failed: " + "\n".join(failed))
    return out


def last_json(text: str):
    return json.loads(text.strip().splitlines()[-1])


def finite_leaves(obj) -> bool:
    """True when every number in a JSON value is finite."""
    if isinstance(obj, dict):
        return all(finite_leaves(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_leaves(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


class Labs:
    """Phases 58-59's subprocesses: :meth:`start` launches them together,
    :meth:`finish` waits for them, checks their outputs and returns (and
    keeps, ``entries``) the kernels line's ``collectives_lab`` entries.
    Between the two, this process may run work that times nothing."""

    def __init__(self, start, wait):
        self._start, self._wait, self.entries = start, wait, None

    def start(self) -> None:
        self._start()

    def finish(self) -> dict:
        self.entries = self._wait()
        return self.entries


def slice18_phases(torch, tt, card: str, dev, defer_labs: bool = False):
    """Phases 57-59: the interactive runtime (ROADMAP 16: the native
    navigation controller, ``InteractiveSession``, ``LiveViewer``,
    ``render_turntable`` and ``examples/live_view.py`` on K1 at 1080p), the
    last four labs and ``suite --scaling`` (15b), the labs and the suite as
    subprocesses started together.  Returns the kernels line's ``interact``
    entry of ``render_fwd`` and the ``collectives_lab`` entries of
    ``ring_allreduce`` and ``rs_ag_allreduce``; with ``defer_labs`` it
    returns ``(the interact entry, Labs)`` before the labs start.  Runnable
    alone."""
    import numpy as np

    from sdf3d_tpu_torch.benchmarks import scaling_report
    from sdf3d_tpu_torch.interact import InteractiveSession, NavigationController, apply_key, navigation_available, \
        render_turntable
    from sdf3d_tpu_torch.interact.controller import navigation_error
    from sdf3d_tpu_torch.interact.viewer import LiveViewer
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import fit_step_kernel, fit_step_kernel_tiles, fit_step_variant
    from sdf3d_tpu_torch.ops.neural_kernel import render_neural_forward
    from sdf3d_tpu_torch.ops.render_bwd_kernel import render_kernel_backward
    from sdf3d_tpu_torch.ops.render_kernel import pack_uniforms, render_kernel_forward, \
        render_kernel_forward_plain, render_kernel_launch, render_kernel_tiles_forward
    from sdf3d_tpu_torch.ops.scene_program import scene_param_vector
    from sdf3d_tpu_torch.parallel.ring_kernel import ring_allreduce, rs_ag_allreduce
    from sdf3d_tpu_torch.utils.image_io import encode_png, to_uint8
    from sdf3d_tpu_torch.utils.parity import check_planes, razor_edge

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    reference = tt.reference_scene().to(dev)
    counters = (render_kernel_forward, render_kernel_tiles_forward, fit_step_kernel, fit_step_kernel_tiles,
                render_kernel_backward, render_neural_forward, ring_allreduce, rs_ag_allreduce, fit_step_variant)

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters if fn.launches}

    # ---- 57. the interactive path at 1920x1080 on K1 ----
    t_phase = time.perf_counter()
    check(navigation_available(), f"the native navigation controller did not build: {navigation_error()}")
    nav = NavigationController().configure()
    check(nav.is_native, "the session's controller is not the native one")
    render_kernel_forward(reference, tt.Camera.reference(device=dev), light, mat, full, device=dev)  # library
    torch.cuda.synchronize()
    windows, cams = [], []

    def render(cam):  # the session's renderer: K1, with CUDA events around the call
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        img = render_kernel_forward(reference, cam, light, mat, full, device=dev)[0]
        end.record()
        windows.append((start, end))
        cams.append(cam)
        return img

    session = InteractiveSession(render, full, nav=nav, device=dev)
    drag, pan = (lambda n: n.mouse_drag(0.05, 0.01)), (lambda n: n.mouse_drag(0.02, -0.01, pan=True))
    script = ([drag] * 4 + [None] * 2                                   # frames 0-5: orbit
              + [pan] * 3 + [None]                                      # 6-9: pan
              + [lambda n: n.scroll(0.5), None, None]                   # 10-12: zoom
              + [lambda n: n.gamepad(0.8, 0.0, 0.0, 0.6, 0.4)] * 3      # 13-15: gamepad sticks
              + [lambda n: n.gamepad(), None]                           # 16-17: sticks released
              + [lambda n, k=k: apply_key(n, k) for k in ("d", "w", "arrowleft", "+")] + [None, None])  # 18-23
    poses = []
    reset()
    frames = session.run([(lambda n, e=e: (e(n) if e else None, poses.append(n.pose()))) for e in script])
    torch.cuda.synchronize()
    session_launches = launches()
    check(session_launches == {"render_kernel_forward": len(script)},
          f"the session's {len(script)} frames launched {session_launches}")
    check(all(f.shape == (H, W, 3) and f.dtype == np.float32 and np.isfinite(f).all() for f in frames),
          "a session frame is not a finite (H, W, 3) float32 image")
    moved = {name: float(np.abs(frames[a] - frames[b]).max())
             for name, a, b in (("orbit", 0, 5), ("pan", 5, 9), ("zoom", 9, 12), ("gamepad", 12, 17), ("keys", 17, 23))}
    check(all(v > 1e-3 for v in moved.values()), f"a gesture did not move the frame: {moved}")
    # Two frames against the plain version at their cameras: after the orbit
    # and after the pan (razor-edge rays past the hard limit, as phase 47).
    parity = {}
    for k in (5, 9):
        uni = pack_uniforms(cams[k], light, mat, full.ray_mode, dev)
        uni[27] = float(full.shadow.k)
        prm = scene_param_vector(reference, dev)
        want = render_kernel_forward_plain(reference, prm, uni, full)
        got = torch.from_numpy(frames[k]).to(dev).permute(2, 0, 1)
        parity[k] = check_planes((got,), want[:1], full.march.max_distance, f"session frame {k} vs plain",
                                 razor=lambda prm=prm, uni=uni: razor_edge(reference, prm, uni, full))["rgb"]
    interact_err = max(st["max_abs_err"] for st in parity.values())
    # Where a frame's time goes: FrameStats (pose math to image on the host),
    # the device's window around the render call, K1 alone by CUDA events,
    # the copy back and the host's pose math alone.
    frame_ms = statistics.median(s.seconds for s in session.stats[1:]) * 1e3
    window_ms = statistics.median(a.elapsed_time(b) for a, b in windows[1:])
    prm0 = scene_param_vector(reference, dev)
    uni0 = pack_uniforms(cams[-1], light, mat, full.ray_mode, dev)
    uni0[27] = float(full.shadow.k)
    k1_ms = time_ms(lambda: render_kernel_launch(reference, prm0, uni0, full))
    img_dev = render_kernel_forward(reference, cams[-1], light, mat, full, device=dev)[0]
    copies = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_dev.detach().cpu().numpy()
        copies.append(time.perf_counter() - t0)
    copy_ms = statistics.median(copies) * 1e3
    kept = []  # each copy kept, as the session's frames are: fresh host pages every time
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept.append(img_dev.detach().cpu().numpy())
        copies.append(time.perf_counter() - t0)
    copy_fresh_ms = statistics.median(copies[10:]) * 1e3
    del kept
    t0 = time.perf_counter()
    for _ in range(50):
        session.nav.step(1 / 60)
        session.camera()
    pose_ms = (time.perf_counter() - t0) / 50 * 1e3
    # The copy's cost depends on whether the image lands on pages the
    # process has used before (the allocator's state), so both are logged
    # and no remainder is derived from either.
    split = {"frame_ms": frame_ms, "k1_ms": k1_ms, "render_window_ms": window_ms, "copy_back_ms": copy_ms,
             "copy_back_fresh_ms": copy_fresh_ms, "pose_ms": pose_ms,
             "rays_per_s": W * H / (frame_ms / 1e3),
             "k1_share": k1_ms / frame_ms, "rays_per_s_stats": statistics.median(s.rays_per_second
                                                                              for s in session.stats[1:])}
    log("interact_session_1080p", card=card, native=nav.is_native, frames=len(frames), launches=session_launches,
        moved_max_abs=moved, vs_plain={k: {q: st[q] for q in ("over_atol", "max_abs_err", "over_hard")}
                                       for k, st in parity.items()}, pose_first=poses[0], pose_last=poses[-1], **split)

    # The live viewer on a free local port: the page, two drags by POST, the
    # served frame, the stats, the stream's first part; ms a frame with the
    # PNG encode.
    view_session = InteractiveSession(
        lambda cam: render_kernel_forward(reference, cam, light, mat, full, device=dev)[0], full, device=dev)
    port = free_port()
    viewer = LiveViewer(view_session, host="127.0.0.1", port=port)
    viewer.start()
    base = f"http://127.0.0.1:{port}"
    try:
        page = http(base + "/").decode()
        check("/stream" in page and "mousedown" in page, "GET / did not return the viewer's page")
        viewer.step()
        pose0 = view_session.nav.pose()
        for ev in ({"type": "drag", "dx": 0.3, "dy": 0.05}, {"type": "drag", "dx": 0.1, "dy": -0.02}):
            http(base + "/event", json.dumps(ev).encode())
        img = viewer.step()
        check(view_session.nav.pose() != pose0, "the POSTed drags did not move the controller's pose")
        served = decode_png(http(base + "/frame.png"))
        check(np.array_equal(served, to_uint8(img)), "GET /frame.png is not the frame step() rendered")
        stats = json.loads(http(base + "/stats"))
        check(stats["frame"] == view_session.frame_count - 1 == 1, f"GET /stats counted {stats['frame']}")
        part = {}
        reader = threading.Thread(target=first_stream_part, args=(base + "/stream", part), daemon=True)
        reader.start()
        for _ in range(20):
            viewer.step()
            reader.join(timeout=0.2)
            if not reader.is_alive():
                break
        check("multipart/x-mixed-replace" in part.get("content_type", "") and b"image/png" in part.get("head", b"")
              and part.get("body", b"")[:8] == b"\x89PNG\r\n\x1a\n", "/stream's first part is not a PNG")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            viewer.step()
        viewer_ms = (time.perf_counter() - t0) / 4 * 1e3
        t0 = time.perf_counter()
        png_bytes = len(encode_png(img, compress_level=viewer.compress_level))
        encode_ms = (time.perf_counter() - t0) * 1e3
    finally:
        viewer.stop()
    log("interact_viewer_1080p", card=card, port=port, frames=view_session.frame_count, viewer_ms=viewer_ms,
        encode_png_ms=encode_ms, png_bytes=png_bytes, stream_part_bytes=len(part["body"]),
        served_frame_equal=True)

    # render_turntable at 1080p: 12 orbit frames, 12 K1 launches.
    reset()
    t0 = time.perf_counter()
    turn = render_turntable(lambda cam: render_kernel_forward(reference, cam, light, mat, full, device=dev)[0],
                            full, n_frames=12, device=dev)
    turn_ms = (time.perf_counter() - t0) / 12 * 1e3
    turn_launches = launches()
    check(turn_launches == {"render_kernel_forward": 12}, f"the turntable launched {turn_launches}")
    check(len(turn) == 12 and all(np.isfinite(f).all() for f in turn) and
          float(np.abs(turn[0] - turn[6]).max()) > 1e-3, "the turntable's frames")
    log("interact_turntable_1080p", card=card, frames=len(turn), launches=turn_launches, ms_per_frame=turn_ms)

    # ---- 58-59. the labs, suite --scaling and the live_view entry point, as
    # subprocesses that run together (their times share the card and the
    # host: they check the paths, and claim nothing) ----
    # The fit step of scaling_report's communication model, measured first
    # by the lab's own function, while this process has the card alone.
    t0 = time.perf_counter()
    step_s = scaling_report.measure_step_seconds(W, H, dev)
    step_measure_s = time.perf_counter() - t0
    from sdf3d_tpu_torch.parallel.ring_kernel import collectives_library

    collectives_library()  # built before collectives_lab's ranks start
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    scaling_out = os.path.join(out_dir, "scaling_report.jsonl")
    if os.path.exists(scaling_out):
        os.unlink(scaling_out)
    pkg = "sdf3d_tpu_torch"
    running = {}

    def launch(name, *args):
        path = os.path.join(out_dir, f"{name}.log")
        running[name] = (*start_lab(args, path), path, time.perf_counter())

    # Every library the labs load, built here at once (the labs would each
    # build their own, on the host's cores the others need), then every lab
    # starts.
    builds0 = _build.LIBRARIES.builds
    t0 = time.perf_counter()
    _build.LIBRARIES.load_many(labs_jobs(tt))
    build_s, builds = time.perf_counter() - t0, _build.LIBRARIES.builds - builds0
    t_labs = []

    def start_labs():
        t_labs.append(time.perf_counter())
        launch("suite_scaling", f"{pkg}.benchmarks.suite", "--scaling", "--quick", "--world-sizes", 1, 2, "--iters",
               3)
        launch("collectives_lab", f"{pkg}.benchmarks.collectives_lab", "--run", "--num", 2)
        launch("scaling_report", f"{pkg}.benchmarks.scaling_report", "--step-ms", step_s * 1e3, "--step-card", card,
               "--out", scaling_out)
        launch("fast_profile", f"{pkg}.benchmarks.fast_profile", "--quick")
        launch("perf_lab", f"{pkg}.benchmarks.perf_lab", "stages", "fit_stages", "--cases", "fwd", "fwd_noshadow",
               "fwd_bwd", "fit_full", "fwd_full", "--rounds", 1, "--iters", 2)
        launch("live_view", f"{pkg}.examples.live_view", "--frames", 3, "--port", free_port())

    def finish_labs(done):
        labs_s = time.perf_counter() - t_labs[0]
        log("labs_seconds", builds=builds, build_seconds=build_s, step_seconds=step_measure_s, labs_seconds=labs_s,
            lab_seconds={name: end for name, (_, end) in done.items()})
        # live_view: three frames on K1, served on its port.
        text = done["live_view"][0]
        m = re.search(r"frames (\d+), last ([\d.]+) ms, launches (\d+)", text)
        check("live viewer: http://127.0.0.1:" in text and m is not None and m.group(1) == "3" and m.group(3) == "3",
              f"live_view did not render 3 frames on K1:\n{text[-2000:]}")
        # perf_lab: stages (K1; K1 + K5) and fit_stages' full cases (K3; K1 in
        # series), 32 frames a case.
        pl = last_json(done["perf_lab"][0])
        want_pl = {"stages": {"fwd", "fwd_noshadow", "fwd_bwd"}, "fit_stages": {"fit_full", "fwd_full"}}
        check({k: set(v) for k, v in pl["suites"].items()} == want_pl and finite_leaves(pl) and all(
            c["ms"] > 0 for v in pl["suites"].values() for c in v.values()), f"perf_lab's JSON: {pl}")
        check(pl["launches"] == {"render_kernel_forward": 4 * 32, "fit_step_kernel": 32, "render_kernel_backward": 32},
              f"perf_lab launched {pl['launches']}")
        # fast_profile: the deltas on both scenes, four throughput rows.
        fp = last_json(done["fast_profile"][0])
        check([d["scene"] for d in fp["deltas"]] == ["reference", "flagship"] and finite_leaves(fp) and
              all(d["psnr_db"] > 20 and 0 <= d["pixels_changed_gt_1pct"] < 1 for d in fp["deltas"]) and
              [(r["profile"], r["mode"]) for r in fp["throughput"]] == [(p, m_) for p in ("parity", "fast")
                                                                      for m_ in ("fwd", "fwd_bwd")] and
              all(r["rays_per_s"] > 0 and r["backend"] == "cuda" for r in fp["throughput"]),
              f"fast_profile's JSON: {fp}")
        # scaling_report: 3 scenes x 5 sizes x 5 layouts (interleaved at tile
        # heights 24 and 8), the card in the basis, written only to --out.
        sc_text = done["scaling_report"][0]
        records = [json.loads(ln) for ln in sc_text.splitlines() if ln.startswith("{")]
        check(len(records) == 75 and finite_leaves(records) and all(
            0 < r["value"] <= 1 and 0 < r["comm_factor"] <= 1 and card.split(",")[0] in r["basis"] and
            torch.cuda.get_device_name(0) in r["basis"] for r in records), f"scaling_report's records: {records[:2]}")
        check(open(scaling_out).read() == "".join(json.dumps(r) + "\n" for r in records),
              "scaling_report's --out is not its stdout")
        # collectives_lab --run --num 2: K7 and K8 bit for bit against their plain
        # versions, 18 launches each (3 sizes, one checked and 5 timed calls).
        cl = last_json(done["collectives_lab"][0])
        run = cl["run"]
        check(run["device"] == "cuda" and all(c["bit_equal"] and c["same_as_last_call"] for c in run["cases"]) and
              len(run["cases"]) == 6 and finite_leaves(cl) and
              run["launches"] == {"ring_allreduce": 18, "rs_ag_allreduce": 18}, f"collectives_lab's run: {run}")
        # suite --scaling: world sizes 1 and 2, the second sharing the card.
        sv = [json.loads(ln) for ln in done["suite_scaling"][0].splitlines() if ln.startswith("{")]
        check([r["n_devices"] for r in sv] == [1, 2] and [r["shared_card"] for r in sv] == [False, True] and
              finite_leaves(sv) and all(r["value"] > 0 for r in sv) and sv[1]["backend"] == "gloo",
              f"suite --scaling's records: {sv}")
        log("labs", card=card, fit_step_ms=step_s * 1e3,
            live_view_last_frame_ms=float(m.group(2)), perf_lab={k: {c: v["ms"] for c, v in s_.items()}
                                                                for k, s_ in pl["suites"].items()},
            perf_lab_launches=pl["launches"], fast_profile=fp, scaling_examples=[
                {k: r[k] for k in ("scene", "n_devices", "layout", "value", "value_with_comm")}
                for r in records if r["n_devices"] == 32], scaling_basis=records[0]["basis"],
            collectives=run["cases"], collectives_launches=run["launches"])
        log("suite_scaling", card=card, records=sv,
            note="two ranks sharing one card over gloo: the plumbing, not a speed")
        return {
            "ring_allreduce": {"collectives_lab": {"launches": run["launches"]["ring_allreduce"], "bit_equal": True}},
            "rs_ag_allreduce": {"collectives_lab": {"launches": run["launches"]["rs_ag_allreduce"], "bit_equal": True}},
        }

    labs = Labs(start_labs, lambda: finish_labs(wait_labs(running)))
    interact = {"interact": {"launches": session_launches["render_kernel_forward"],
                             "turntable_launches": turn_launches["render_kernel_forward"],
                             "max_abs_err": interact_err, "ms": k1_ms, "frame_ms": frame_ms,
                             "viewer_ms": viewer_ms, "turntable_ms": turn_ms}}
    if defer_labs:
        return {"render_fwd": interact}, labs
    labs.start()
    return {"render_fwd": interact, **labs.finish()}


#: ``examples/inverse_fit.py``'s loss: the pyramid and the silhouette term in
#: one K3 launch (``fit_step_kernel``'s options).
INVERSE_FIT_LOSS = dict(loss_kind="multiscale", levels=3, sil_w=1.0)


def slice19_jobs(tt) -> list:
    """The library jobs of phase 60: K1 with ambient occlusion on the
    gallery's seven scenes; K3 with the pyramid and the silhouette term
    together, with and without the uniforms' gradient, and its one-branch
    and L2 forms, on the black background (the fit demo's start and
    ``inverse_fit``'s share a structure); K2 on (8, 128) tiles on the
    flagship; and the examples' other libraries (K1 on the black background,
    ``grid_fit``'s target with the shadow off, ``pose_fit``'s K3,
    ``neural_sdf``'s K6, K1 without AO on the gallery's scenes)."""
    from sdf3d_tpu_torch.config import AOConfig
    from sdf3d_tpu_torch.examples.neural_sdf import render_config
    from sdf3d_tpu_torch.examples.render_gallery import gallery_scenes
    from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig, neural_structure
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, library_job
    from sdf3d_tpu_torch.ops.scene_program import cuda_neural_source

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    gallery = dataclasses.replace(full, ao=AOConfig(enabled=True))
    black = dataclasses.replace(full, background=(0.0, 0.0, 0.0))
    no_shadow = dataclasses.replace(full, shadow=dataclasses.replace(full.shadow, enabled=False))
    kc, frozen = KernelConfig(), (0, 1, 2, 3)
    start = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25))
    peanut = tt.sdf.ground_plane() | tt.sdf.smooth_union(tt.sdf.sphere((-0.12, 0.4, 0.0), 0.18),
                                                         tt.sdf.sphere((0.15, 0.48, 0.0), 0.14), k=0.08)
    jobs = [library_job(sc, gallery, kc) for sc, _ in gallery_scenes().values()]
    jobs += [library_job(start, black, kc, wrt, fr, "full", 3, True) for wrt, fr in ((False, frozen), (True, ()))]
    jobs += [library_job(start, black, kc, False, frozen, "full", lv, sil) for lv, sil in ((3, False), (0, True),
                                                                                          (0, False))]
    jobs += [library_job(tt.flagship_scene(), full, KernelConfig(tile_h=8, tile_w=128)), library_job(start, black, kc),
             library_job(peanut, no_shadow, kc), library_job(start, full, kc, True, (), "full", 0, True)]
    # K1 without AO on the gallery's scenes (the AO timing's baseline; the
    # flagship's also sharded_render's single image): built by phases 2, 30,
    # 34 and 37 in the whole smoke.
    jobs += [library_job(sc, full, kc) for sc, _ in gallery_scenes().values()]
    neural = tt.sdf.ground_plane() | tt.sdf.neural_sdf(0, hidden=64, depth=3, radius=0.3)
    ncfg, nc = render_config(256), NeuralRenderConfig()
    jobs.append((neural_structure(neural, ncfg, nc), lambda: cuda_neural_source(neural, ncfg, nc), "neural"))
    return jobs


def slice19_phases(torch, tt, card: str, dev, alongside: Labs | None = None) -> dict:
    """Phases 60-62: the last six example scripts (ROADMAP 16b) on the card.
    60 loads their libraries (:func:`slice19_jobs`; in the whole smoke
    built already by the queue of phase 3, run alone built here); 61 holds K3 with the pyramid and the
    silhouette term in one launch (``inverse_fit``'s fit) to its plain
    versions, times it beside its one-branch forms at 1080p and runs a
    20-step fit with it; 62 runs the six scripts at the JAX scripts'
    defaults (``sharded_render`` as a subprocess over two ranks on the card,
    the others in this process), their launches counted, their outputs
    checked and held to the kernels' plain versions.  Returns the kernels
    line's ``examples`` entries of ``render_fwd``, ``render_tiles``,
    ``fit_step`` and ``neural_fwd`` and ``fit_step``'s
    ``multiscale_silhouette`` entry.  ``alongside``: phases 58-59's labs
    (:class:`Labs`), started before phase 62's scripts and finished after
    them (the scripts' seconds then share the card and the host with them),
    before the times of K1 with AO.  Runnable alone."""
    import shutil

    from sdf3d_tpu_torch.config import AOConfig
    from sdf3d_tpu_torch.examples import render_gallery
    from sdf3d_tpu_torch.fit import FitConfig, fit_scene
    from sdf3d_tpu_torch.march import ray_min_sdf
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import fit_launcher, fit_step_kernel, fit_step_kernel_plain
    from sdf3d_tpu_torch.ops.neural_kernel import render_neural_forward
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, pack_uniforms, render_kernel_forward, \
        render_kernel_forward_plain, render_kernel_launch, render_kernel_tiles_forward
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.sdf.transforms import rotvec_to_matrix

    full = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    black = dataclasses.replace(full, background=(0.0, 0.0, 0.0))
    light, mat = tt.reference_light(device=dev), tt.reference_material(device=dev)
    kc, frozen = KernelConfig(), (0, 1, 2, 3)
    beta = full.march.epsilon / 2.5
    ref_cam = tt.Camera.reference(device=dev)
    orbit = tt.Camera.orbit(azimuth_deg=30.0, elevation_deg=15.0, device=dev)
    reference = tt.reference_scene().to(dev)
    counters = (render_kernel_forward, render_kernel_tiles_forward, fit_step_kernel, render_neural_forward)
    libs = _build.LIBRARIES

    def reset():
        for fn in counters:
            fn.launches = 0

    def launches():
        return {fn.__name__: fn.launches for fn in counters if fn.launches}

    def inputs(sc, cam, c):
        uni = pack_uniforms(cam, light, mat, c.ray_mode, dev)
        uni[27] = float(c.shadow.k)
        return scene_param_vector(sc, dev), uni

    def start(center=(0.05, 0.45, 0.0), radius=0.25):  # the fit demo's start (inverse_fit's: (0.08, 0.45, 0), 0.27)
        return tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere(center=center, radius=radius)).to(dev)

    def reference_target(cam, c):
        """The reference scene's render (planar, on the card) and its object
        mask off the black background."""
        prm, uni = inputs(reference, cam, c)
        rgb = render_kernel_launch(reference, prm, uni, c)[0].contiguous()
        return rgb, (rgb.abs().amax(0) > 1e-3).to(torch.float32).contiguous()

    # ---- 60. the libraries (in the whole smoke built already by the queue of
    # phase 3) ----
    t_phase = time.perf_counter()
    builds0, seconds0 = libs.builds, libs.build_seconds
    jobs = slice19_jobs(tt)
    libs.load_many(jobs)
    waited_s = time.perf_counter() - t_phase
    sc0 = start()
    forms = {  # name: (wrt_uniforms, frozen, levels, silhouette)
        "multiscale_silhouette": (False, frozen, 3, True), "multiscale_silhouette_uniforms": (True, (), 3, True),
        "multiscale": (False, frozen, 3, False), "silhouette": (False, frozen, 0, True), "l2": (False, frozen, 0, False)}
    ptxas = {}
    for name, (wrt, fr, lv, sil) in forms.items():
        p = ptxas_summary(libs.log(libs.key(cuda_scene_source(sc0, black, kc, wrt, fr, "full", lv, sil))))["fit_step"]
        ptxas[name] = {**p, "blocks_per_sm": blocks_per_sm(p["registers"])}
    gallery_full = dataclasses.replace(full, ao=AOConfig(enabled=True))
    ao_ptxas = {}
    for name, (sc, _) in render_gallery.gallery_scenes().items():
        p = ptxas_summary(libs.log(libs.key(cuda_scene_source(sc, gallery_full, kc))))["render_fwd"]
        ao_ptxas[name] = {**p, "blocks_per_sm": blocks_per_sm(p["registers"])}
    log("examples_build", builds=libs.builds - builds0, build_seconds=libs.build_seconds - seconds0,
        libraries=len(jobs), waited_seconds=waited_s, fit_step_ptxas=ptxas, render_fwd_ao_ptxas=ao_ptxas)

    # ---- 61. K3 with the pyramid and the silhouette term in one launch ----
    t_phase = time.perf_counter()
    small = dataclasses.replace(black, width=256, height=192)
    ragged = dataclasses.replace(black, width=250, height=190)
    at96 = dataclasses.replace(black, width=96, height=64)
    errs, parity = [], []
    cases = [(small, "orbit30_15", orbit, start()), (small, "reference", ref_cam, start()),
             (ragged, "orbit30_15", orbit, start()), (at96, "inverse_fit", ref_cam, start((0.08, 0.45, 0.0), 0.27))]
    for c, cam_name, cam, sc in cases:
        base, cov = reference_target(cam, c)
        for wrt, fr in ((False, frozen), (True, ())):
            label = f"K3 multiscale+silhouette {c.width}x{c.height} {cam_name} wrt_uniforms={wrt}"
            prm, uni = inputs(sc, cam, c)
            st = k3_branch_vs_plain(torch, INVERSE_FIT_LOSS, sc, prm, uni, c, kc, wrt, fr, label, base, cov)
            errs.append(st["own_march"]["max_abs_err"])
            parity.append({"size": [c.width, c.height], "camera": cam_name, "wrt_uniforms": wrt, **st})
    # pose_fit's form (the uniforms' gradient and the coverage term) at its
    # 128x96 on its perturbed start.
    pose = dataclasses.replace(full, width=128, height=96)
    rot = rotvec_to_matrix(0.06 * torch.tensor([0.3, 0.8, -0.3], device=dev))
    cam0 = tt.Camera(position=ref_cam.position + 0.06 * torch.tensor([1.0, -0.7, 1.3], device=dev),
                     c2w=(rot[:, :, None] * ref_cam.c2w[None, :, :]).sum(1), fov_deg=ref_cam.fov_deg)
    o, d = tt.camera_rays(ref_cam, pose.width, pose.height, pose.ray_mode)
    cov_pose = torch.sigmoid((2.0 * pose.march.epsilon - ray_min_sdf(reference.distance, o, d, pose.march)[0])
                             / beta).contiguous()
    prm, uni = inputs(reference, cam0, pose)
    view_st = k3_branch_vs_plain(torch, dict(sil_w=1.0), reference, prm, uni, pose, kc, True, (), "K3 pose_fit 128x96",
                                 reference_target(ref_cam, pose)[0], cov_pose)
    view_errs = [view_st["own_march"]["max_abs_err"]]
    # Step 0 at 1080p on the fit demo's start (the silhouette phase's black
    # background), the main path's size.
    target_black, cov_black = reference_target(ref_cam, black)
    prm, uni = inputs(sc0, ref_cam, black)
    step0 = k3_branch_vs_plain(torch, INVERSE_FIT_LOSS, sc0, prm, uni, black, kc, False, frozen,
                               "K3 multiscale+silhouette 1080p step 0", target_black, cov_black)
    errs.append(step0["own_march"]["max_abs_err"])
    log("examples_k3_parity", cases=parity, pose_fit=view_st, step0_1080p=step0)
    # Times at 1080p, in turns: the combined form beside each branch alone
    # and the L2 form (kernel and total, fit_launcher), the plain version one
    # frame without a warm-up.
    opts = {"multiscale_silhouette": dict(levels=3, coverage=cov_black, sil_w=1.0, sil_beta=beta),
            "multiscale": dict(levels=3), "silhouette": dict(coverage=cov_black, sil_w=1.0, sil_beta=beta), "l2": {}}
    kern = {n: fit_launcher(sc0, prm, uni, target_black, black, kc, False, frozen, "full", **o)[0]
            for n, o in opts.items()}
    runs = {n: [] for n in kern}
    for order in (list(kern), list(reversed(kern))):
        for n in order:
            runs[n].append(time_ms(kern[n]))
    plain_ms = time_ms(functools.partial(fit_step_kernel_plain, sc0, prm, uni, target_black, black, kc, False, frozen,
                                         target_coverage=cov_black, **INVERSE_FIT_LOSS), 0, 1)
    costs = scene_costs(cuda_scene_source(sc0, black, kc, False, frozen))
    counts = march_counts(torch, sc0, ref_cam, black, prm, uni, render_kernel_forward_plain)
    fp, sfu = analytic_work(costs, counts, black, primal=True, reverse=True)
    bf, bs = branch_work(costs, counts, 3, True)
    bound_ms, bound_by = bound(fp + bf, sfu + bs, 16 * W * H + 8 * (prm.numel() + 31))
    # The main path: a 20-step fit with both terms at 1080p, one K3 a step.
    with PlainCalls() as plain:
        reset()
        t0 = time.perf_counter()
        fit = fit_scene(target_black.permute(1, 2, 0), start(), ref_cam, light, mat, black,
                        FitConfig(steps=20, learning_rate=1e-2, log_every=1, loss="multiscale", silhouette_weight=1.0),
                        trainable=(False, False, True, True), device=dev)
        fit_seconds = time.perf_counter() - t0
        fit_launches = launches()
    check(fit_launches == {"fit_step_kernel": 20} and sum(plain.calls.values()) == 0,
          f"the 20-step fit launched {fit_launches}, plain versions {plain.calls}")
    check(all(math.isfinite(v) for v in fit.losses) and fit.losses[-1] < fit.losses[0],
          f"the multiscale+silhouette fit's loss did not fall: {fit.losses}")
    times = {n: {"ms": sum(r) / 2, "ms_runs": r} for n, r in runs.items()}
    log("examples_k3_1080p", card=card, times=times, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        counts=counts, fit_losses=fit.losses, fit_seconds=fit_seconds, fit_ms_per_step=W * H / fit.rays_per_second * 1e3,
        fit_launches=fit_launches, ptxas=ptxas)

    # ---- 62. the six scripts at the JAX scripts' defaults (beside the labs,
    # where given) ----
    if alongside is not None:
        alongside.start()
    t_phase = time.perf_counter()
    out_root = os.path.join(REPO, "build", "chip_smoke", "examples")
    shutil.rmtree(out_root, ignore_errors=True)  # no stale checkpoint to resume
    os.makedirs(out_root)
    # sharded_render starts first, in a session of its own, so that a failed
    # check here stops it and its ranks together.
    sharded_log = os.path.join(out_root, "sharded_render.log")
    log_file = open(sharded_log, "w")
    proc = subprocess.Popen([sys.executable, "-m", "sdf3d_tpu_torch.examples.sharded_render", "--out",
                             os.path.join(out_root, "sharded_render")], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=log_file, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    running = {"sharded_render": (proc, log_file, sharded_log, time.perf_counter())}
    try:
        out = _slice19_scripts(torch, tt, dev, out_root, reset, launches, inputs)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        log_file.close()
        raise
    (seconds, ex_launches, plain_calls, lines, saved, center, radius, e0, e1, gallery, gallery_err, neural_st) = out
    # sharded_render: two ranks sharing the card over gloo, K1 and K2 once
    # a rank, both of the JAX script's asserts, K2's image K1's bit for bit.
    done = wait_labs(running)
    sh_text = done["sharded_render"][0]
    ranks = last_json(sh_text)["ranks"]
    check(len(ranks) == 2 and all(
        r["backend"] == "gloo" and r["sharded_equal"] and r["tiles_over_1e-3"] == 0 and r["tiles_mean_abs_err"] < 1e-5
        and r["tiles_equal_kernel"] and r["launches"] == {"render_kernel_forward": 1, "render_kernel_tiles_forward": 1}
        for r in ranks) and {"mesh: {'tiles': 2}", "sharded == single-device: True", "output shape: (192, 256, 3)"}
        <= set(sh_text.splitlines()), f"sharded_render: {sh_text[-3000:]}")
    seconds["sharded_render"] = done["sharded_render"][1]
    log("examples", card=card, seconds=seconds, launches=ex_launches, plain_calls=plain_calls, printed=lines,
        inverse_fit={"checkpoints": saved, "center": center, "radius": radius},
        pose_fit_position_error=[e0, e1], gallery_vs_plain=gallery, neural_vs_plain={
            k: neural_st[k] for k in ("over_atol", "max_abs_err")}, sharded_render=ranks)
    if alongside is not None:
        alongside.finish()
    # K1 with AO on the gallery's scenes at 1080p under their cameras, beside
    # the same render without AO (phases 30, 34 and 37 built those), in turns.
    ao_ms = {}
    for name, (sc, cam) in render_gallery.gallery_scenes().items():
        sc, cam = sc.to(dev), cam.to(dev)
        prm, uni = inputs(sc, cam, full)
        ao = functools.partial(render_kernel_launch, sc, prm, uni, gallery_full)
        no_ao = functools.partial(render_kernel_launch, sc, prm, uni, full)
        r = {"ao": [], "no_ao": []}
        for f in (ao, no_ao, no_ao, ao):
            r["ao" if f is ao else "no_ao"].append(time_ms(f, 2, 10))
        ao_ms[name] = {"ms": sum(r["ao"]) / 2, "no_ao_ms": sum(r["no_ao"]) / 2, "ms_runs": r["ao"],
                       "no_ao_ms_runs": r["no_ao"], "ptxas": ao_ptxas[name]}
    log("examples_gallery_ao_1080p", card=card, render_fwd=ao_ms)
    k1_total = sum(ex_launches[n].get("render_kernel_forward", 0) for n in ex_launches)
    return {
        "render_fwd": {"examples": {"launches": k1_total, "sharded_render_launches_a_rank": 1,
                                    "max_abs_err": max(gallery_err), "gallery_ao_1080p_ms": {
                                        n: v["ms"] for n, v in ao_ms.items()}}},
        "render_tiles": {"examples": {"launches": sum(r["launches"]["render_kernel_tiles_forward"] for r in ranks),
                                      "max_abs_err": max(r["tiles_max_abs_err"] for r in ranks), "tile": [8, 128]}},
        "fit_step": {
            "examples": {"launches": ex_launches["inverse_fit"]["fit_step_kernel"]
                         + ex_launches["pose_fit"]["fit_step_kernel"], "max_abs_err": max(errs + view_errs)},
            "multiscale_silhouette": {"launches": fit_launches["fit_step_kernel"], "max_abs_err": max(errs),
                                      "ms": times["multiscale_silhouette"]["ms"], "plain_ms": plain_ms,
                                      "bound_ms": bound_ms, "bound_by": bound_by,
                                      "registers": ptxas["multiscale_silhouette"]["registers"],
                                      "spill_stores": ptxas["multiscale_silhouette"].get("spill_stores"),
                                      "blocks_per_sm": ptxas["multiscale_silhouette"]["blocks_per_sm"]}},
        "neural_fwd": {"examples": {"launches": ex_launches["neural_sdf"]["render_neural_forward"],
                                    "max_abs_err": neural_st["max_abs_err"]}},
    }


def _slice19_scripts(torch, tt, dev, out_root: str, reset, launches, inputs) -> tuple:
    """Phase 62's scripts run in this process (all but ``sharded_render``)
    at the JAX scripts' defaults, their launches counted and their outputs
    checked (:func:`slice19_phases`)."""
    import contextlib
    import io

    import numpy as np

    import sdf3d_tpu_torch.fit as fit_module
    import sdf3d_tpu_torch.utils as utils_module
    from sdf3d_tpu_torch.config import AOConfig
    from sdf3d_tpu_torch.examples import grid_fit, inverse_fit, neural_sdf, pose_fit, render_gallery
    from sdf3d_tpu_torch.ops.neural_kernel import _inputs as neural_inputs
    from sdf3d_tpu_torch.ops.neural_kernel import render_neural_forward_plain
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward_plain
    from sdf3d_tpu_torch.utils.parity import NEURAL_BAR, SCENE_BARS, check_planes, razor_edge, rounding_decided

    shots, saved, models, current = {}, [], [], {}
    orig_png, orig_ckpt, orig_distill = utils_module.write_png, fit_module.save_checkpoint, neural_sdf.distill_blob

    def png(path, img):
        shots[(current["name"], os.path.basename(str(path)))] = np.array(img, np.float32)
        orig_png(path, img)

    def ckpt(path, state, step, meta=None):
        saved.append(step)
        orig_ckpt(path, state, step, meta)

    def distill(*args, **kwargs):
        models.append(orig_distill(*args, **kwargs))
        return models[-1]

    # grid_fit cut to 60 of its 300 steps: the banded route's torch march is
    # host-bound, 0.2-0.3 s a step (300 steps took 94 s beside
    # sharded_render's ranks; PERF.md).
    scripts = {"inverse_fit": (inverse_fit, []), "pose_fit": (pose_fit, []), "render_gallery": (render_gallery, []),
               "neural_sdf": (neural_sdf, []), "grid_fit": (grid_fit, ["--steps", "60"])}
    texts, ex_launches, seconds = {}, {}, {}
    utils_module.write_png, fit_module.save_checkpoint, neural_sdf.distill_blob = png, ckpt, distill
    try:
        with PlainCalls() as plain:
            for name, (module, argv) in scripts.items():
                current["name"] = name
                reset()
                buf = io.StringIO()
                t0 = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(buf):
                        check(module.main([*argv, "--out", os.path.join(out_root, name)]) == 0, f"{name} failed")
                except BaseException:
                    print(buf.getvalue()[-3000:], file=sys.stderr)
                    raise
                torch.cuda.synchronize()
                seconds[name], texts[name], ex_launches[name] = time.perf_counter() - t0, buf.getvalue(), launches()
    finally:
        utils_module.write_png, fit_module.save_checkpoint, neural_sdf.distill_blob = orig_png, orig_ckpt, orig_distill
    kernel_plain = {k: v for k, v in plain.calls.items() if k != "planar_vjp"}
    check(sum(kernel_plain.values()) == 0, f"the examples called a kernel's plain version: {plain.calls}")
    want = {"inverse_fit": {"render_kernel_forward": 3, "fit_step_kernel": 200},
            "pose_fit": {"render_kernel_forward": 3, "fit_step_kernel": 300},
            "render_gallery": {"render_kernel_forward": 7}, "neural_sdf": {"render_neural_forward": 12},
            "grid_fit": {"render_kernel_forward": 1}}
    for name, w in want.items():
        check(ex_launches[name] == w, f"{name} launched {ex_launches[name]}, expected {w}")
    lines = {n: [ln for ln in t.splitlines() if not ln.startswith("{")] for n, t in texts.items()}
    # inverse_fit: the checkpoints every 50 steps, a metrics line every 10
    # steps and the last, the radius toward 0.2, the loss down.
    metrics = [json.loads(ln) for ln in open(os.path.join(out_root, "inverse_fit", "metrics.jsonl"))]
    check(saved == [50, 100, 150, 200] and [m["step"] for m in metrics] == list(range(0, 200, 10)) + [199] and
          all(math.isfinite(m["loss"]) for m in metrics), f"inverse_fit: checkpoints {saved}, metrics {metrics[:3]}")
    m = re.match(r"fitted : center \[(.+)\]  radius ([\d.]+)$", lines["inverse_fit"][1])
    center, radius = [float(x) for x in m.group(1).split(",")], float(m.group(2))
    m2 = re.match(r"loss ([\d.]+) -> ([\d.]+)  \(", lines["inverse_fit"][2])
    check(lines["inverse_fit"][0] == "true   : center (0, 0.4, 0)  radius 0.2" and abs(radius - 0.2) < 0.07 and
          float(m2.group(2)) < float(m2.group(1)), f"inverse_fit: {lines['inverse_fit']}")
    # pose_fit: the position error falls.
    e0, e1 = (float(x) for x in re.search(r"position error ([\d.]+) -> ([\d.]+)", lines["pose_fit"][1]).groups())
    check(e1 < e0, f"pose_fit: {lines['pose_fit']}")
    # render_gallery: each frame against K1's plain version at its bar; past
    # the hard limit only razor-edge rays and pixels rounding decides.
    gcfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=320, height=240, ao=AOConfig(enabled=True))
    names = list(render_gallery.gallery_scenes())
    check(lines["render_gallery"] == [f"{n}.png" for n in names] + ["aov_{depth,normals,shadow,ao}.png",
                                                                     f"gallery -> {os.path.join(out_root, 'render_gallery')}"]
          and all(np.isfinite(v).all() for (s_, _), v in shots.items() if s_ == "render_gallery"),
          f"render_gallery: {lines['render_gallery']}")
    gallery, gallery_err = {}, []
    for name, (sc, cam) in render_gallery.gallery_scenes().items():
        sc, cam = sc.to(dev), cam.to(dev)
        prm, uni = inputs(sc, cam, gcfg)
        want_planes = render_kernel_forward_plain(sc, prm, uni, gcfg)
        got = torch.from_numpy(shots[("render_gallery", f"{name}.png")]).to(dev).permute(2, 0, 1)
        witness = Witness(razor_edge, rounding_decided, sc, prm, uni, gcfg)
        st = check_planes((got,), want_planes[:1], gcfg.march.max_distance, f"gallery {name} vs plain", razor=witness,
                          **SCENE_BARS.get("lattice_scene" if name == "lattice" else name, {}))["rgb"]
        gallery[name] = {"over_atol": st["over_atol"], "max_abs_err": st["max_abs_err"],
                         "over_hard": st.get("over_hard", 0), **witness.counts}
        gallery_err.append(st["max_abs_err"])
    # neural_sdf: the distillation's loss falls; frame 0 against K6's plain
    # version at NEURAL_BAR.
    d0, d1 = (float(x) for x in re.search(r"distill loss ([\d.]+) -> ([\d.]+)", lines["neural_sdf"][0]).groups())
    check(d1 < d0 and len(models) == 1, f"neural_sdf: {lines['neural_sdf']}")
    ncfg = neural_sdf.render_config(256)
    nscene = tt.sdf.ground_plane().to(dev) | models[0][0]
    nprm, nuni = neural_inputs(nscene, tt.Camera.orbit(azimuth_deg=0.0, elevation_deg=18.0), tt.reference_light(),
                               tt.reference_material(), ncfg, dev)
    n_want = render_neural_forward_plain(nscene, nprm, nuni, ncfg)[0]
    n_got = torch.from_numpy(shots[("neural_sdf", "frame_00000.png")]).to(dev).permute(2, 0, 1)
    neural_st = check_planes((n_got,), (n_want,), ncfg.march.max_distance, "neural_sdf frame 0 vs plain",
                             **NEURAL_BAR)["rgb"]
    # grid_fit: the image error falls (the script asserts it too).
    g0, g1 = (float(x) for x in re.search(r"initial ([\d.]+) -> fitted ([\d.]+)", lines["grid_fit"][1]).groups())
    check(g1 < g0, f"grid_fit: {lines['grid_fit']}")
    return (seconds, ex_launches, plain.calls, lines, saved, center, radius, e0, e1, gallery, gallery_err, neural_st)


def blocks_per_sm(registers: int, threads: int = 256) -> int:
    """Resident blocks of ``threads`` threads an SM holds at ``registers`` a
    thread (Hopper: 65536 registers an SM, allotted per warp in units of 256,
    that is 8 a thread; at most 2048 threads an SM); shared memory, a few KB
    a block here, is not the limit."""
    per_block = -(-registers // 8) * 8 * threads
    return min(65536 // per_block, 2048 // threads)


def _time_root(root: str) -> dict:
    """One checkout's measurements for ``--time-kernels`` (module docstring)."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import fit_launcher, fit_step_kernel_launch
    from sdf3d_tpu_torch.ops.render_kernel import (
        KernelConfig,
        pack_uniforms,
        render_kernel_forward_plain,
        render_kernel_launch,
        render_kernel_tiles_launch,
    )
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.parallel.tile_queue import plan_tiles

    check(tt.__file__.startswith(root), f"imported {tt.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    cam = tt.Camera.reference(device=dev)
    uni = pack_uniforms(cam, tt.reference_light(device=dev), tt.reference_material(device=dev), cfg.ray_mode, dev)
    uni[27] = float(cfg.shadow.k)
    ref = tt.reference_scene().to(dev)
    sc0 = tt.sdf.union(tt.sdf.ground_plane(), tt.sdf.sphere((0.05, 0.45, 0.0), 0.25)).to(dev)
    prm, prm0 = scene_param_vector(ref, dev), scene_param_vector(sc0, dev)
    P, frozen, kc = prm0.numel(), (0, 1, 2, 3), KernelConfig()
    target = render_kernel_launch(ref, prm, uni, cfg)[0].contiguous()
    k1 = lambda: render_kernel_launch(ref, prm, uni, cfg)  # noqa: E731
    # K3 on the fit demo's main path, through the checkout's own launcher and
    # wrapper.  A launcher that returns partial rows (before the in-launch
    # total) has them summed as its wrapper sums them.
    k3 = lambda: fit_step_kernel_launch(sc0, prm0, uni, target, cfg, kc, False, frozen)  # noqa: E731
    launcher = fit_launcher(sc0, prm0, uni, target, cfg, kc, False, frozen)
    out = launcher[0]()
    totals = out if out.dtype == torch.float64 else out.sum(0, dtype=torch.float64)
    partial_rows = launcher[1] if out.dtype == torch.float64 else out
    torch.cuda.synchronize()
    fit_totals = torch.cat([totals[:P], totals[-1:]]).cpu().numpy()
    # The partial rows' live columns (the unfrozen slots, then the loss) as
    # (blocks, live) on every checkout: a launcher that stores all P + 31
    # columns has the others dropped, so the digests compare each block's
    # sums bit for bit across checkouts.
    rows = partial_rows.cpu()
    live = [k for k in range(P) if k not in frozen] + [rows.shape[1] - 1]
    live_rows = (rows if rows.shape[1] == len(live) else rows[:, live]).contiguous().numpy()
    planes = b"".join(x.contiguous().cpu().numpy().tobytes() for x in k1())
    libs = _build.LIBRARIES
    ref_key = libs.key(cuda_scene_source(ref, cfg, kc))
    ptxas = {k: v for k, v in ptxas_summary(libs.log(ref_key)).items()
             if k in ("render_fwd", "render_bwd", "render_bwd_params")}
    ptxas["fit_step"] = ptxas_summary(libs.log(libs.key(cuda_scene_source(sc0, cfg, kc, False, frozen))))["fit_step"]
    for v in ptxas.values():
        v["blocks_per_sm"] = blocks_per_sm(v["registers"], kc.block_w * kc.block_h)
    # K1's issue floor (its SASS on this run's marches).
    counts = march_counts(torch, ref, cam, cfg, prm, uni, render_kernel_forward_plain)
    k1_sass = next(v for k, v in sass_listing(str(libs.build_dir / ref_key / _build.KINDS["render"].lib_name)).items()
                   if "sdf3d_render_fwd_kernel" in k)
    # K2 over the 135-tile plan of phase 21 (world size 1, round robin).
    plan = plan_tiles(H, W, kc.tile_h, kc.tile_w, 1)
    trow, tcol = plan.tables(0, dev)
    k2 = lambda: render_kernel_tiles_launch(ref, prm, uni, trow, tcol, cfg, kc)  # noqa: E731
    stacks = b"".join(x.contiguous().cpu().numpy().tobytes() for x in k2())
    result = {"root": root, "card": card_name_and_power(), "ptxas": ptxas,
              "render_fwd_issue_floor": issue_floor(k1_sass, counts), "render_fwd_sass_split": sass_split(k1_sass),
              "render_fwd_sha256": hashlib.sha256(planes).hexdigest(),
              "render_tiles_sha256": hashlib.sha256(stacks).hexdigest(),
              "render_tiles": plan.tiles_per_device,
              "fit_step_partials_sha256": hashlib.sha256(partial_rows.cpu().numpy().tobytes()).hexdigest(),
              "fit_step_partials_shape": list(partial_rows.shape),
              "fit_step_live_rows_sha256": hashlib.sha256(live_rows.tobytes()).hexdigest(),
              "fit_totals": fit_totals.tolist(),
              "fit_totals_sha256": hashlib.sha256(fit_totals.tobytes()).hexdigest(),
              "render_fwd_ms": [time_ms(k1, 5, 50) for _ in range(3)],
              "render_fwd_alone_ms": [time_ms(render_alone(torch, ref, prm, uni, cfg), 5, 50) for _ in range(3)],
              "fit_step_ms": [time_ms(launcher[0], 5, 50) for _ in range(3)],
              "fit_step_wrapper_ms": [time_ms(k3, 5, 50) for _ in range(3)],
              "fit_step_wrapper_device_us": device_us(torch, k3),
              "render_tiles_ms": [time_ms(k2, 5, 50) for _ in range(3)],
              "render_bwd": _time_render_bwd(torch, sc0, prm0, uni, target, cfg, kc)}
    # K6 on phase 16's cell: ground_plane() | neural_sdf(seed 0, hidden, depth 3)
    # at 1080p with 64/32 steps, the reference camera; three runs each.
    from sdf3d_tpu_torch.ops.neural_kernel import NeuralRenderConfig, render_neural_launch

    ncfg = dataclasses.replace(cfg, march=dataclasses.replace(cfg.march, max_steps=64),
                               shadow=dataclasses.replace(cfg.shadow, max_steps=32))
    for hidden, frames in ((64, 10), (128, 4), (256, 1)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        sc = tt.sdf.ground_plane().to(dev) | tt.sdf.neural_sdf(gen, hidden=hidden, depth=3, radius=0.3)
        nprm = scene_param_vector(sc, dev)
        k6 = lambda: render_neural_launch(sc, nprm, uni, ncfg, NeuralRenderConfig())  # noqa: E731
        result[f"neural_fwd_hidden{hidden}_ms"] = [time_ms(k6, 1, frames) for _ in range(3)]
    if hasattr(tt, "flagship_scene"):
        result["flagship"] = _time_flagship(torch, tt, uni, cfg, kc)
        result["flagship"].update(_time_k1(torch, tt.flagship_scene().to(dev), cam, uni, cfg, kc))
    result["random_blobs8"] = _time_k1(torch, tt.random_blobs(n=8).to(dev), cam, uni, cfg, kc)
    result["fractal"] = _time_k1(torch, tt.fractal_scene().to(dev), cam, uni, cfg, kc, floor=False)
    return result


def _time_k1(torch, scene, cam, uni, cfg, kc, floor: bool = True) -> dict:
    """K1 on ``scene`` at 1080p for ``--time-kernels``, on the checkout
    imported: three runs of its entry point alone (:func:`render_alone`),
    the SHA-256 of its four planes,
    its registers and, with ``floor``, its issue floor and SASS split
    (:func:`issue_floor`, :func:`sass_split`)."""
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_forward_plain, render_kernel_launch
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector

    prm = scene_param_vector(scene, uni.device)
    k1 = lambda: render_kernel_launch(scene, prm, uni, cfg, kc)  # noqa: E731
    planes = b"".join(x.contiguous().cpu().numpy().tobytes() for x in k1())
    libs = _build.LIBRARIES
    key = libs.key(cuda_scene_source(scene, cfg, kc))
    alone = render_alone(torch, scene, prm, uni, cfg, kc)
    out = {"k1_sha256": hashlib.sha256(planes).hexdigest(), "k1_ms": [time_ms(alone, 5, 50) for _ in range(3)],
           "k1_registers": ptxas_summary(libs.log(key))["render_fwd"]["registers"]}
    if floor:
        listing = next(v for k, v in sass_listing(str(libs.build_dir / key / _build.KINDS["render"].lib_name)).items()
                       if "sdf3d_render_fwd_kernel" in k)
        counts = march_counts(torch, scene, cam, cfg, prm, uni, render_kernel_forward_plain)
        out["k1_issue_floor"] = issue_floor(listing, counts)
        out["k1_sass_split"] = sass_split(listing)
    return out


def _time_flagship(torch, tt, uni, cfg, kc) -> dict:
    """The flagship for ``--time-kernels``, on the checkout imported: K1 on
    its render at 1080p, K3 on the flagship fit's start (the plane frozen)
    against that render, K5 without the uniforms' gradient (the multiscale
    fit's form) on the start's planes; three runs each of the entry point,
    SHA-256 of K1's four planes and of K3's float64 totals (the gradient
    and the loss) and K5's, and the ptxas registers, spills and blocks an
    SM of K1, K3 and both forms of K5; K5 with the uniforms' gradient is
    timed too."""
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.fit_kernel import fit_launcher
    from sdf3d_tpu_torch.ops.render_bwd_kernel import render_bwd_launcher
    from sdf3d_tpu_torch.ops.render_kernel import render_kernel_launch
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.utils.parity import flagship_fit_start

    dev, frozen = uni.device, (0, 1, 2, 3)
    flag, start = tt.flagship_scene().to(dev), flagship_fit_start(dev)
    prm, s_prm = scene_param_vector(flag, dev), scene_param_vector(start, dev)
    P = s_prm.numel()
    k1 = lambda: render_kernel_launch(flag, prm, uni, cfg, kc)  # noqa: E731
    planes = k1()
    target = planes[0].contiguous()
    k3 = fit_launcher(start, s_prm, uni, target, cfg, kc, False, frozen)[0]
    rgb, t, sh, ao = render_kernel_launch(start, s_prm, uni, cfg, kc)
    g_rgb = (2.0 * (rgb - target)).contiguous()
    k5 = render_bwd_launcher(start, s_prm, uni, g_rgb, t, sh, ao, cfg, kc, False)[0]
    k5u = render_bwd_launcher(start, s_prm, uni, g_rgb, t, sh, ao, cfg, kc, True)[0]
    fit_totals, bwd_totals = k3().clone(), k5().clone()
    torch.cuda.synchronize()
    fit_totals = torch.cat([fit_totals[:P], fit_totals[-1:]]).cpu().numpy()
    libs = _build.LIBRARIES
    ptxas = {k: v for k, v in ptxas_summary(libs.log(libs.key(cuda_scene_source(flag, cfg, kc)))).items()
             if k in ("render_fwd", "render_bwd", "render_bwd_params")}
    ptxas["fit_step"] = ptxas_summary(libs.log(libs.key(cuda_scene_source(start, cfg, kc, False, frozen))))["fit_step"]
    for v in ptxas.values():
        v["blocks_per_sm"] = blocks_per_sm(v["registers"], kc.block_w * kc.block_h)
    return {"ptxas": ptxas,
            "render_fwd_sha256": hashlib.sha256(b"".join(x.contiguous().cpu().numpy().tobytes()
                                                         for x in planes)).hexdigest(),
            "fit_totals": fit_totals.tolist(),
            "fit_totals_sha256": hashlib.sha256(fit_totals.tobytes()).hexdigest(),
            "render_bwd_totals_sha256": hashlib.sha256(bwd_totals.cpu().numpy().tobytes()).hexdigest(),
            "finite": all(math.isfinite(x) for x in fit_totals.tolist()) and bool(torch.isfinite(bwd_totals).all()),
            "render_fwd_ms": [time_ms(k1, 5, 50) for _ in range(3)],
            "fit_step_ms": [time_ms(k3, 5, 50) for _ in range(3)],
            "render_bwd_ms": [time_ms(k5, 5, 50) for _ in range(3)],
            "render_bwd_uniforms_ms": [time_ms(k5u, 5, 50) for _ in range(3)]}



def _time_render_bwd(torch, scene, prm, uni, target, cfg, kc) -> dict:
    """K5 for ``--time-kernels``, on the checkout imported: at 1080p on the
    planes of ``scene`` with the cotangent of an L2 loss against ``target``,
    in each form the checkout has (``params``: the parameters' gradient
    alone, the multiscale fit's; ``uniforms``: with the uniforms'), the
    entry point alone (``ms``: with its float64 total where the checkout's C
    call launches one) and through its wrapper, three runs each, the
    wrapper's kernels on the card (the profiler), and the SHA-256 of the
    partial rows' P parameter columns (blocks, P)."""
    from sdf3d_tpu_torch.ops import render_bwd_kernel as k5
    from sdf3d_tpu_torch.ops.render_kernel import kernel_library, render_kernel_launch

    dev = prm.device
    rgb, t, sh, ao = render_kernel_launch(scene, prm, uni, cfg, kc)
    g_rgb = (2.0 * (rgb - target)).contiguous()
    P = prm.numel()
    forms = {}
    if hasattr(k5, "render_bwd_launcher"):
        for form, wrt in (("params", False), ("uniforms", True)):
            launch, rows, _ = k5.render_bwd_launcher(scene, prm, uni, g_rgb, t, sh, ao, cfg, kc, wrt)
            forms[form] = (launch, rows, functools.partial(k5.render_kernel_backward_launch, scene, prm, uni, g_rgb,
                                                           t, sh, ao, cfg, kc, wrt_uniforms=wrt))
    else:
        # One form (the uniforms'), partial rows (blocks, P + 30), summed by
        # the wrapper.
        lib = kernel_library(scene, prm, uni, cfg, kc)
        rows = torch.empty((-(-cfg.width // kc.block_w) * -(-cfg.height // kc.block_h), P + 30), device=dev)
        args = [x.data_ptr() for x in (uni, prm, g_rgb[0], g_rgb[1], g_rgb[2], t, sh, ao, rows)]
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch():
            check(lib.sdf3d_render_bwd(*args, cfg.height, cfg.width, stream) == 0, "sdf3d_render_bwd failed")
        forms["uniforms"] = (launch, rows, functools.partial(k5.render_kernel_backward_launch, scene, prm, uni, g_rgb,
                                                             t, sh, ao, cfg, kc))
    out = {}
    for form, (launch, rows, wrapper) in forms.items():
        launch()
        torch.cuda.synchronize()
        dp_rows = rows[:, :P].contiguous().cpu().numpy()
        out[form] = {"ms": [time_ms(launch, 5, 50) for _ in range(3)],
                     "wrapper_ms": [time_ms(wrapper, 5, 50) for _ in range(3)],
                     "wrapper_device_us": device_us(torch, wrapper),
                     "with_total": hasattr(k5, "render_bwd_launcher"),
                     "dp_rows_sha256": hashlib.sha256(dp_rows.tobytes()).hexdigest()}
    return out


def max_rel_diff(a, b) -> float:
    """The largest |a - b| / max(|a|, |b|) over two vectors (0 where both
    are 0)."""
    return max((abs(x - y) / max(abs(x), abs(y)) for x, y in zip(a, b) if x != y), default=0.0)


def time_kernels(roots: list) -> int:
    """``--time-kernels ROOT [ROOT ...]``: for each checkout in turn, in a
    process of its own (the packages share a name), K1 (through its launch
    and by its entry point alone, :func:`render_alone`), K2 over the 135-tile
    plan and K3 at 1080p (the reference scene, the fit demo's main path),
    K5 on the fit demo's start in each form (:func:`_time_render_bwd`) and
    K6 on phase 16's cell, three runs each by CUDA events; SHA-256 digests
    of K1's four planes, K2's stacks, K3's partial rows (all, and their
    live columns in one layout for every checkout), its float64 totals (the
    gradient and the loss) and K5's parameter columns of its partial rows;
    ptxas registers, spills and resident blocks per SM of K1, K3 and both
    forms of K5; K1's issue floor (:func:`issue_floor`) and its SASS by
    opcode class (:func:`sass_split`); K1 on the flagship, ``random_blobs(8)``
    and the fractal under the reference camera (:func:`_time_k1`: times,
    digests, registers, and on the first two the issue floor and the split).
    One JSON line per checkout, then one comparing them: whether the digests
    agree bit for bit, the registers, the totals' largest relative
    difference from the first checkout's, and the times.  Give the parent
    and the change in turns (parent, change, change, parent) to compare them
    on one card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-root", root], capture_output=True,
                              text=True, timeout=900)
        check(proc.returncode == 0, f"--time-kernels {root} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    first = results[0]
    print(json.dumps({
        "roots": [r["root"] for r in results],
        "render_fwd_sha256_equal": len({r["render_fwd_sha256"] for r in results}) == 1,
        "render_tiles_sha256_equal": len({r["render_tiles_sha256"] for r in results}) == 1,
        "fit_step_live_rows_sha256_equal": len({r["fit_step_live_rows_sha256"] for r in results}) == 1,
        "fit_totals_sha256_equal": len({r["fit_totals_sha256"] for r in results}) == 1,
        "render_bwd_dp_rows_sha256_equal": len({f["dp_rows_sha256"] for r in results
                                                for f in r["render_bwd"].values()}) == 1,
        "registers": {k: [r["ptxas"].get(k, {}).get("registers") for r in results]
                      for k in ("render_fwd", "fit_step", "render_bwd", "render_bwd_params")},
        "fit_totals_max_rel_diff": [max_rel_diff(r["fit_totals"], first["fit_totals"]) for r in results],
        "render_fwd_ms": [r["render_fwd_ms"] for r in results],
        "render_fwd_alone_ms": [r["render_fwd_alone_ms"] for r in results],
        "render_fwd_issue_floor_ms": [r["render_fwd_issue_floor"]["issue_floor_ms"] for r in results],
        "render_tiles_ms": [r["render_tiles_ms"] for r in results],
        "fit_step_ms": [r["fit_step_ms"] for r in results],
        "fit_step_wrapper_ms": [r["fit_step_wrapper_ms"] for r in results],
        "render_bwd_ms": [{f: v["ms"] for f, v in r["render_bwd"].items()} for r in results],
        "render_bwd_wrapper_ms": [{f: v["wrapper_ms"] for f, v in r["render_bwd"].items()} for r in results],
        "neural_fwd_hidden64_ms": [r["neural_fwd_hidden64_ms"] for r in results],
        **{name: {"k1_sha256_equal": len({r[name]["k1_sha256"] for r in results if name in r}) == 1,
                  "k1_ms": [r.get(name, {}).get("k1_ms") for r in results],
                  "k1_registers": [r.get(name, {}).get("k1_registers") for r in results],
                  "k1_issue_floor_ms": [r.get(name, {}).get("k1_issue_floor", {}).get("issue_floor_ms")
                                        for r in results]}
           for name in ("random_blobs8", "fractal")},
        "flagship": {
            "render_fwd_sha256_equal": len({r["flagship"]["render_fwd_sha256"] for r in results if "flagship" in r}) == 1,
            "fit_totals_sha256_equal": len({r["flagship"]["fit_totals_sha256"] for r in results if "flagship" in r}) == 1,
            "render_bwd_totals_sha256_equal": len({r["flagship"]["render_bwd_totals_sha256"] for r in results
                                                   if "flagship" in r}) == 1,
            "registers": {k: [r["flagship"]["ptxas"].get(k, {}).get("registers") if "flagship" in r else None
                              for r in results] for k in ("render_fwd", "fit_step", "render_bwd", "render_bwd_params")},
            "finite": [r["flagship"]["finite"] if "flagship" in r else None for r in results],
            "render_fwd_ms": [r.get("flagship", {}).get("render_fwd_ms") for r in results],
            "k1_issue_floor_ms": [r.get("flagship", {}).get("k1_issue_floor", {}).get("issue_floor_ms")
                                  for r in results],
            "fit_step_ms": [r.get("flagship", {}).get("fit_step_ms") for r in results],
            "render_bwd_ms": [r.get("flagship", {}).get("render_bwd_ms") for r in results],
            "render_bwd_uniforms_ms": [r.get("flagship", {}).get("render_bwd_uniforms_ms") for r in results]}}),
          flush=True)
    return 0


def _time_scenes_root(root: str) -> dict:
    """K1 at 1080p on the 13b scenes (their gallery cameras), the flagship and
    ``materials_scene`` (the reference camera) for ``--time-scenes``, on the
    checkout at ``root``: three runs of its entry point alone
    (:func:`render_alone`), its registers and the SHA-256 of its planes."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import sdf3d_tpu_torch as tt
    from sdf3d_tpu_torch.ops import _build
    from sdf3d_tpu_torch.ops.render_kernel import KernelConfig, pack_uniforms, render_kernel_launch
    from sdf3d_tpu_torch.ops.scene_program import cuda_scene_source, scene_param_vector
    from sdf3d_tpu_torch.utils.parity import scenes_13b

    check(tt.__file__.startswith(root), f"imported {tt.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(tt.REFERENCE_CONFIG, width=W, height=H)
    scenes = dict(scenes_13b(dev))
    scenes["flagship"] = (tt.flagship_scene().to(dev), tt.Camera.reference(device=dev))
    scenes["materials"] = (tt.materials_scene().to(dev), tt.Camera.reference(device=dev))
    out = {"root": root, "card": card_name_and_power()}
    for name, (sc, cam) in scenes.items():
        uni = pack_uniforms(cam, tt.reference_light(device=dev), tt.reference_material(device=dev), cfg.ray_mode, dev)
        uni[27] = float(cfg.shadow.k)
        prm = scene_param_vector(sc, dev)
        planes = b"".join(x.contiguous().cpu().numpy().tobytes() for x in render_kernel_launch(sc, prm, uni, cfg))
        key = _build.LIBRARIES.key(cuda_scene_source(sc, cfg, KernelConfig()))
        out[name] = {"ms": [time_ms(render_alone(torch, sc, prm, uni, cfg), 5, 30) for _ in range(3)],
                     "registers": ptxas_summary(_build.LIBRARIES.log(key))["render_fwd"]["registers"],
                     "sha256": hashlib.sha256(planes).hexdigest()}
    return out


def time_scenes(roots: list) -> int:
    """``--time-scenes ROOT [ROOT ...]``: :func:`_time_scenes_root` for each
    checkout in turn, in a process of its own; one JSON line per checkout,
    then one comparing them per scene: whether the planes agree bit for
    bit, the median ms and the registers.  Give the parent and the change
    (in turns) to compare them on one card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-scenes-root", root],
                              capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"--time-scenes {root} failed:\n{proc.stderr[-4000:]}")
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    names = [k for k in results[0] if k not in ("root", "card")]
    print(json.dumps({n: {"sha256_equal": len({r[n]["sha256"] for r in results}) == 1,
                          "ms": [statistics.median(r[n]["ms"]) for r in results],
                          "registers": [r[n]["registers"] for r in results]} for n in names}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time-kernels"]:
        sys.exit(time_kernels(sys.argv[2:]))
    if sys.argv[1:2] == ["--time-scenes"]:
        sys.exit(time_scenes(sys.argv[2:]))
    if sys.argv[1:2] == ["--time-scenes-root"]:
        print(json.dumps(_time_scenes_root(sys.argv[2])), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == ["--time-root"]:
        print(json.dumps(_time_root(sys.argv[2])), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == ["--register-line"]:
        print(json.dumps(register_line(names=tuple(sys.argv[2:]) or SWEEP_SCENES)), flush=True)
        sys.exit(0)
    sys.exit(main())
