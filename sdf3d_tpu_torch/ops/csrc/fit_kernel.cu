// Fused fit steps for Hopper (sm_90a): the loss sum(rgb - target)^2 (with
// the multiscale pyramid and the silhouette term where the header asks) and
// its gradient with respect to the scene parameters (and, with
// Fit::wrt_uniforms, the 30 uniforms) in one launch, totals included.  K3
// runs over an image (or a row slab of one), K4 over a work-list of tiles.
//
// K3 replaces sdf3d_tpu/ops/fit_kernel.py::_fit_tile_kernel (the Pallas
// kernel launched by fit_step_kernel) with its two loss branches, static
// settings of the generated header: Fit::levels, the multiscale pyramid
// (loss_kind == "multiscale"; 0 is the plain L2), pooled over each block's
// aligned 2^levels groups in shared memory between a pixel's forward part
// and its reverse part (Pyramid below), and Fit::silhouette, the coverage
// term sil_w·(σ((2ε − min_s)/β) − tc)² (sil_w > 0), whose march tracks the
// ray's minimum distance (render_kernel.cuh::march_primary's TRACK form) and
// whose gradient re-attaches at the argmin point (fit_reverse).  The
// silhouette's weight and softness are launch arguments.  One thread per
// pixel, Cfg::block_w x Cfg::block_h blocks as in the render kernel.  A
// thread traces its pixel's primal once (trace_pixel: the marches and the
// Primal of render_kernel.cuh), shades it, and runs the reverse pass
// (shade_vjp.cuh) over that same Primal seeded with 2*(rgb - target): the
// ray, hit point, normal taps and unit vectors are not traced again.
// Launch row r is the absolute image row abs_row(r) (render_kernel.cuh), so
// a rank of a sharded fit runs its contiguous or interleaved rows.
//
// K3 takes V views in one launch (JAX's _fit_tile_kernel with multiview=True,
// fit_scene_multiview's step): the grid's z axis is the view, V a launch
// argument (no header setting, so the libraries of one view serve it).  A
// block of view v reads its uniforms at uni + v·30 and its target (and
// coverage) planes at v·H·W; its partial row lies in view v's run of rows,
// and the column total sums each view's rows alone in K3's order, so each
// view's totals are those of K3 launched on that view alone, bit for bit
// (V x (P + 31) float64; the caller sums the scene and loss columns over the
// views in view order, as JAX's per_view reduction).
//
// The totals are dP, dU and the loss (the loss alone for K9's loss-only
// variants).  A block reduces only the live ones: dU only with
// Fit::wrt_uniforms, and never a frozen parameter slot (Fit::is_frozen).
// Each block sums its threads' live values in a fixed order
// (block_sum_store: shuffles within a warp, then the warps in order) into
// one partial row, stored by column.  The same entry point then launches a
// second kernel, sdf3d_column_total_kernel (column_total.cuh, shared with
// K5), one 256-thread block a live column, which sums the partial rows in
// float64 in an order fixed by row and thread index, never by arrival, and
// writes the totals; its block 0 writes the columns no block sums (frozen
// slots, dU without the uniforms' gradient) as exact zeros.  No atomics, no
// Python between the two launches, no sum on the host.  Threads outside the
// image add zeros (the padding mask of the Pallas kernel).
//
// K4 (sdf3d_fit_step_tiles) replaces the same Pallas body with
// tile_queue=True (fit_step_kernel_tiles), the per-device fit program of
// the tile-queue layout; one kernel function serves K3 and K4 (below).
// The grid is K2's, (TW/block_w, TH/block_h, T); block z reads its tile's
// origin (trow[z], tcol[z]) and the target stack (3, T·TH, TW) at row
// z·TH + r.  The mask is taken in absolute pixels, row < H and col < W of
// the full image, so the dummy tiles of a plan (row0 == H) add exact zeros.
// A block covers the same pixels in K3 and K4 when the tile splits into
// whole blocks, so the two give the same partial rows for them.
//
// What bounds them: FP32 and special-function issue (the marches' distance
// evaluations, then the reverse pass's sqrt/divide/pow and its seven
// reverse taps) and the latency of the marches' dependent steps, which
// only more resident warps hide; one register count serves the whole
// kernel, so the reverse pass's peak sets the marches' occupancy.  The
// design: trace the primal once (the re-trace's six distance evaluations,
// six IEEE square roots and divisions and a powf per pixel are gone), cap
// the registers for 4 blocks an SM (kMinBlocks below: 32 warps instead of
// 16, a few values spilled), reduce only live columns (5 of K3's
// 39 on the fit demo) and total them on the card.  Memory traffic is the
// target (12 B per pixel) and one partial row per block.
//
// K9, the fit step's benchmark variants, replaces
// benchmarks/exp_ad.py::make_variant(...).kernel: K3's tile program cut down
// to time its fixed cost.  Each variant is K3's kernel function compiled with
// Fit::variant (the generated header), the cuts taken by if constexpr; FULL
// is K3 itself, header and library included.  WRT_P: the parameters'
// gradient only; PRIMAL: the loss only; NOSCATTER: K3's reverse pass with
// the loss alone written; NOPOW: the specular power as the chain
// x³·x³·x³·x³ (spec_pow<false>); SHADE_ONLY: no marches, the shading and its
// reverse at t = 2, shadow 1, AO 1; EMPTY: sum of the target; EMPTY_NOIN:
// the pixel count, no input read.  JAX's one-hot (8, 128) scatter is not
// ported: a variant writes one partial row of its live columns a block, the
// loss last.
#include <type_traits>
#include <utility>

#include "column_total.cuh"
#include "sdf3d_scene.cuh"

namespace {
constexpr int kP = Scene::n_params;
constexpr int kNT = Cfg::block_w * Cfg::block_h;  // threads a block

// Fit::variant (ops/scene_program.py::FIT_VARIANTS, in this order).
enum : int { FULL = 0, WRT_P, PRIMAL, NOSCATTER, NOPOW, SHADE_ONLY, EMPTY, EMPTY_NOIN };
constexpr int kV = Fit::variant;
constexpr bool kLossOnly = kV == PRIMAL || kV == NOSCATTER || kV == EMPTY || kV == EMPTY_NOIN;
// The uniforms' gradient: taken with Fit::wrt_uniforms, except by WRT_P.
constexpr bool kGradU = Fit::wrt_uniforms && kV != WRT_P;
// K3's values of a pixel: dP, dU where taken, the loss last.
constexpr int kG = kP + (kGradU ? sdf3d::N_UNIFORMS : 0) + 1;
// The values a thread's result holds, and those it sums: NOSCATTER keeps
// K3's whole gradient in registers and writes its loss alone.
constexpr int kCols = kLossOnly ? 1 : kG;
constexpr int kAcc = kV == NOSCATTER ? kG : kCols;
// The totals: dP, dU and the loss whatever Fit::wrt_uniforms, the loss
// alone for the loss-only variants.
constexpr int kTotals = kLossOnly ? 1 : kP + sdf3d::N_UNIFORMS + 1;

// A frozen parameter slot is not reduced: its total reads exactly 0.
SDF3D_HD constexpr bool frozen_col(int k) { return kCols > 1 && k < kP && Fit::is_frozen(k); }

SDF3D_HD constexpr int count_live() {
  int n = 0;
  for (int k = 0; k < kCols; ++k) n += frozen_col(k) ? 0 : 1;
  return n;
}

// The columns of a partial row: the result's live columns, in order.
constexpr int kLive = count_live();

// The result's column of live column j.
SDF3D_HD constexpr int live_col(int j) {
  for (int k = 0; k < kCols; ++k) {
    if (!frozen_col(k) && j-- == 0) return k;
  }
  return kCols;
}

// The totals' column of the result's column k (the loss is the last of both).
SDF3D_HD constexpr int total_col(int k) { return k == kCols - 1 ? kTotals - 1 : k; }

// Whether no block sums total k: a frozen slot, or dU without kGradU.
SDF3D_HD constexpr bool zero_total(int k) {
  return k < kP ? frozen_col(k) : k < kTotals - 1 && !kGradU;
}

// The loss's branches (Fit::levels, Fit::silhouette; JAX's loss_kind ==
// "multiscale" and sil_w > 0), taken by the full fit step alone.
constexpr int kLevels = Fit::levels;
// Per-object materials (the scene's material program; JAX's mat_soa).
constexpr bool kMat = sdf3d::HasMaterials<Scene>::value;
constexpr bool kSil = Fit::silhouette;
static_assert((kLevels == 0 && !kSil) || kV == FULL, "the loss branches take the full fit step");
// A pyramid group of 2^levels x 2^levels pixels lies inside one block and
// one tile (ops/fit_kernel.py::fused_l2_eligible checks it before a build).
static_assert(Cfg::block_w % (1 << kLevels) == 0 && Cfg::block_h % (1 << kLevels) == 0 &&
                  Cfg::tile_w % (1 << kLevels) == 0 && Cfg::tile_h % (1 << kLevels) == 0,
              "the block and the tile must be multiples of 2^levels");

// What one pixel's forward part hands its reverse part: the primal, the
// residual and the cotangent of its rgb (2·residual; the pyramid adds its
// levels' terms), and under kSil the ray's minimum distance and the adjoint
// of it that the coverage term gives.
struct PixelState {
  sdf3d::Primal pr;
  float res[3], g[3];
  sdf3d::MinSdf ms;
  float g_min;
};

// The target planes (tc: the coverage target, read under kSil) and the
// silhouette's weight and softness.
struct Targets {
  const float *r, *g, *b, *c;
  float sil_w, sil_beta;
};

// The primal of one pixel: trace_pixel (tracking the minimum distance into
// st.ms under kSil), or SHADE_ONLY's fixed planes.
SDF3D_HD sdf3d::Primal primal(const float* u, const float* p, float rows, float cols, int H, int W,
                              PixelState& st) {
  if constexpr (kV == SHADE_ONLY) {
    return sdf3d::make_primal<Cfg, Scene>(u, p, rows, cols, H, W, 2.0f, 1.0f, 1.0f);
  } else if constexpr (kSil) {
    st.ms = sdf3d::MinSdf{INFINITY, 0.0f};
    return sdf3d::trace_pixel<Cfg, Scene, true, true>(u, p, rows, cols, H, W, &st.ms);
  } else {
    return sdf3d::trace_pixel<Cfg, Scene, kV != NOPOW>(u, p, rows, cols, H, W);
  }
}

// The residual of pixel px against its target at position i, res, and its
// loss.
SDF3D_HD float residual(const sdf3d::Pixel& px, const float* tr, const float* tg, const float* tb, size_t i,
                        float (&res)[3]) {
  const float rr = px.r - tr[i], rg = px.g - tg[i], rb = px.b - tb[i];
  res[0] = rr; res[1] = rg; res[2] = rb;
  return ((rr * rr) + (rg * rg)) + (rb * rb);
}

// The coverage term of one pixel (JAX's sil_w·(σ((2ε − min_s)/β) − tc)²):
// its loss, and in st.g_min the adjoint of min_s, −2·sil_w·(cov − tc)·
// cov·(1 − cov)/β (lax's logistic rule).
SDF3D_HD float coverage(const Targets& tgt, size_t i, PixelState& st) {
  const float cov = 1.0f / (1.0f + expf(-(((2.0f * Cfg::epsilon) - st.ms.s) / tgt.sil_beta)));
  const float d = cov - tgt.c[i];
  st.g_min = -((((2.0f * tgt.sil_w) * d) * cov) * (1.0f - cov)) / tgt.sil_beta;
  return tgt.sil_w * (d * d);
}

// The forward part of one pixel at absolute (rows, cols) of an H x W image,
// its targets at position i: adds its loss to acc[kAcc - 1] (acc[0] for the
// EMPTY variants) and keeps in st what fit_reverse reads.
SDF3D_HD void fit_forward(const float* u, const float* p, const Targets& tgt, size_t i, float rows, float cols,
                          int H, int W, PixelState& st, float* acc) {
  if constexpr (kV == EMPTY_NOIN) {
    acc[0] += 1.0f;
  } else if constexpr (kV == EMPTY) {
    acc[0] += (tgt.r[i] + tgt.g[i]) + tgt.b[i];
  } else {
    st.pr = primal(u, p, rows, cols, H, W, st);
    acc[kAcc - 1] += residual(sdf3d::shade<Cfg, kMat>(u, st.pr), tgt.r, tgt.g, tgt.b, i, st.res);
    st.g[0] = 2.0f * st.res[0]; st.g[1] = 2.0f * st.res[1]; st.g[2] = 2.0f * st.res[2];
    if constexpr (kSil) acc[kAcc - 1] += coverage(tgt, i, st);
  }
}

// The reverse part of one pixel (after fit_forward, and the pyramid's terms
// in st.g): adds its gradient to acc.  Under kSil the coverage term's
// gradient re-attaches by the envelope theorem (JAX's diff.ray_min_sdf_diff):
// g_min times the distance's derivative at o + t_min·d with t_min data,
// into dP and, with the uniforms' gradient, into the ray's origin (p̄) and
// direction (t_min·p̄) before the ray generation's reverse.
SDF3D_HD void fit_reverse(const float* u, const float* p, const PixelState& st, float* acc) {
  if constexpr (kV != PRIMAL && kV != EMPTY && kV != EMPTY_NOIN) {
    float* dU = kGradU ? acc + kP : nullptr;
    if constexpr (!kSil) {
      sdf3d::shade_vjp<Cfg, Scene, kGradU, kV != NOPOW>(u, p, st.pr, st.g[0], st.g[1], st.g[2], acc, dU);
    } else {
      sdf3d::RayAdjoint ray{};
      sdf3d::shade_vjp_surface<Cfg, Scene, kGradU>(u, p, st.pr, st.g[0], st.g[1], st.g[2], acc, dU, ray);
      const float tm = st.ms.t;
      const sdf3d::Unit3& d = st.pr.d;
      float px = 0.0f, py = 0.0f, pz = 0.0f;
      sdf3d::sdf_bwd_add<Scene>(u[sdf3d::U_CAM] + (tm * d.ux), u[sdf3d::U_CAM + 1] + (tm * d.uy),
                                u[sdf3d::U_CAM + 2] + (tm * d.uz), p, st.g_min, acc, px, py, pz);
      if constexpr (kGradU) {
        ray.ox += px; ray.oy += py; ray.oz += pz;
        ray.dx += tm * px; ray.dy += tm * py; ray.dz += tm * pz;
        sdf3d::ray_vjp(u, st.pr, ray, dU);
      }
    }
  }
}

// One pixel's loss and gradient, added to acc[kAcc] (the loss last): the
// forward part, then the reverse part (the plain-L2 and silhouette steps;
// the pyramid runs its levels between the two over the block).
SDF3D_HD void fit_pixel(const float* u, const float* p, const Targets& tgt, size_t i, float rows, float cols,
                        int H, int W, float* acc) {
  PixelState st;
  fit_forward(u, p, tgt, i, rows, cols, H, W, st, acc);
  fit_reverse(u, p, st, acc);
}

// The pixel of thread (tx, ty) of block (bx, by, z): its absolute (rows,
// cols) and its targets' position i, or false outside the image.  trow ==
// nullptr is K3 (pixel (y, x) of view z's grid, absolute row abs_row(y), its
// targets in view z's planes), else K4 (pixel (trow[z] + y, tcol[z] + x) of
// tile z, masked in absolute pixels).
// Both meet in the same fit_forward and fit_reverse, so a pixel's terms have
// the same bits whichever layout launched them.
SDF3D_HD bool block_pixel(const float* u, const int* trow, const int* tcol, int bx, int by, int z, int tx, int ty,
                          int H, int W, size_t& i, float& rows, float& cols) {
  const int x = bx * Cfg::block_w + tx, y = by * Cfg::block_h + ty;
  const bool tiles = trow != nullptr;
  const int row = tiles ? trow[z] + y : y;
  const int col = tiles ? tcol[z] + x : x;
  if (!(row < H && col < W && (!tiles || (y < Cfg::tile_h && x < Cfg::tile_w)))) return false;
  i = tiles ? (static_cast<size_t>(z) * Cfg::tile_h + y) * Cfg::tile_w + x : (static_cast<size_t>(z) * H + y) * W + x;
  rows = tiles ? static_cast<float>(row) : sdf3d::abs_row<Cfg>(u, y);
  cols = static_cast<float>(col);
  return true;
}

// Thread (tx, ty) of block (bx, by, z): adds its pixel's terms to acc, or
// nothing outside the image (the padding mask of the Pallas kernel).
SDF3D_HD void block_thread(const float* u, const float* p, const int* trow, const int* tcol, const Targets& tgt,
                           int bx, int by, int z, int tx, int ty, int H, int W, float* acc) {
  size_t i;
  float rows, cols;
  if (block_pixel(u, trow, tcol, bx, by, z, tx, ty, H, W, i, rows, cols)) {
    fit_pixel(u, p, tgt, i, rows, cols, H, W, acc);
  }
}

// The multiscale pyramid of a block (JAX's _fit_tile_kernel with loss_kind
// == "multiscale": fit.py::pixel_loss's average-pool pyramid).  Level 0
// holds the threads' residuals (0 outside the image) and whether their pixel
// is real; level l the means of the block's aligned 2^l x 2^l groups, each
// 0.25·((a00 + a10) + (a01 + a11)) of its four level-(l − 1) means (rows
// first, then columns: the order of JAX's pooling products), and whether
// all 4^l of its pixels are real.  A real group adds 4^l·|mean|² to the
// loss, and 2·mean to the cotangent of each of its pixels' rgb (the
// derivative of 4^l·mean² by a pixel's residual).  Groups that reach
// outside the image or into a tile's padding are not real, as JAX's
// recursive cropping drops them.
SDF3D_HD constexpr int level_w(int l) { return Cfg::block_w >> l; }
SDF3D_HD constexpr int level_h(int l) { return Cfg::block_h >> l; }
SDF3D_HD constexpr int level_off(int l) { return l == 0 ? 0 : level_off(l - 1) + level_w(l - 1) * level_h(l - 1); }

struct Pyramid {
  float m[3][level_off(kLevels + 1)];
  float real[level_off(kLevels + 1)];
};

// Thread tid's pixel at level 0: its residual, or 0 outside the image.
SDF3D_HD void pyramid_store(Pyramid& py, int tid, bool live, const PixelState& st) {
  for (int c = 0; c < 3; ++c) py.m[c][tid] = live ? st.res[c] : 0.0f;
  py.real[tid] = live ? 1.0f : 0.0f;
}

// Thread tid's group at level l (if it has one): its means from level l − 1,
// and its loss term added to acc[kAcc - 1].  Every thread of the block calls
// it for l = 1, 2, ... in turn, level l − 1 complete.
SDF3D_HD void pyramid_pool(Pyramid& py, int l, int tid, float* acc) {
  if (tid >= level_w(l) * level_h(l)) return;
  const int cw = level_w(l - 1);
  const int a00 = level_off(l - 1) + (2 * (tid / level_w(l))) * cw + 2 * (tid % level_w(l));
  const int a10 = a00 + cw, a01 = a00 + 1, a11 = a10 + 1;
  const int out = level_off(l) + tid;
  const bool real = py.real[a00] > 0.0f && py.real[a10] > 0.0f && py.real[a01] > 0.0f && py.real[a11] > 0.0f;
  float m[3];
  for (int c = 0; c < 3; ++c) {
    m[c] = 0.25f * ((py.m[c][a00] + py.m[c][a10]) + (py.m[c][a01] + py.m[c][a11]));
    py.m[c][out] = m[c];
  }
  py.real[out] = real ? 1.0f : 0.0f;
  if (real) acc[kAcc - 1] += static_cast<float>(1 << (2 * l)) * (((m[0] * m[0]) + (m[1] * m[1])) + (m[2] * m[2]));
}

// The pyramid's terms of the cotangent of thread (tx, ty)'s rgb: 2·mean of
// each of its real groups, after every level is complete.
SDF3D_HD void pyramid_cotangent(const Pyramid& py, int tx, int ty, PixelState& st) {
  for (int l = 1; l <= kLevels; ++l) {
    const int k = level_off(l) + (ty >> l) * level_w(l) + (tx >> l);
    if (py.real[k] > 0.0f) {
      for (int c = 0; c < 3; ++c) st.g[c] += 2.0f * py.m[c][k];
    }
  }
}

// NOSCATTER's one value: the loss, plus the gradient where the loss is NaN
// (then still NaN, so the loss's bits always), which keeps the reverse pass
// live: with the loss alone stored the compiler deletes it.
SDF3D_HD float loss_keeping_gradient(const float (&acc)[kAcc]) {
  float keep = acc[kAcc - 1];
  if (isnan(keep)) {
    for (int k = 0; k < kAcc - 1; ++k) keep += acc[k];
  }
  return keep;
}

template <int... J>
SDF3D_HD void gather_live(const float (&acc)[kAcc], float (&v)[kLive], std::integer_sequence<int, J...>) {
  ((v[J] = acc[std::integral_constant<int, live_col(J)>::value]), ...);
}

// A thread's partial-row values: its sums' live columns (NOSCATTER: its loss).
SDF3D_HD void row_values(const float (&acc)[kAcc], float (&v)[kLive]) {
  if constexpr (kV == NOSCATTER) {
    v[0] = loss_keeping_gradient(acc);
  } else {
    gather_live(acc, v, std::make_integer_sequence<int, kLive>{});
  }
}

// The totals' layout of the live columns (column_total.cuh).
struct FitColumns {
  static constexpr int n_totals = kTotals;
  SDF3D_HD static constexpr int total(int c) { return total_col(live_col(c)); }
  SDF3D_HD static constexpr bool zero(int k) { return zero_total(k); }
};
}  // namespace

// out[0]: the totals' columns (kTotals), out[1]: a partial row's (kLive).
extern "C" int sdf3d_fit_columns(int* out) {
  out[0] = kTotals;
  out[1] = kLive;
  return 0;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {
// The blocks of kNT threads an SM must hold (__launch_bounds__' second
// argument; ptxas caps the registers to fit, spilling what does not: 64 a
// thread for 4 blocks of 256, 80 for 3).  The reverse pass peaks near 90
// registers (128 with the uniforms' 30 gradients), which would allow only
// 2 blocks, and the marches before it need the warps to hide their latency.
// 4 blocks, and 3 where a thread also sums the uniforms' gradients (whose
// spills then cost more than a fourth block gains; PERF.md).  A large
// reverse pass spills several kB at those caps: 2 blocks (128 registers)
// took the flagship's fit step from 1.21 to 0.79 ms at 1080p on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md); sdf3d::reverse_blocks gives the cap
// from Scene::bwd_values and Scene::bwd_node_values.
constexpr int kMinBlocks = sdf3d::reverse_blocks(kAcc > kP + 1 ? 3 : 4, Scene::bwd_values, Scene::bwd_node_values,
                                                 sdf3d::kLargeReverseValues);
}  // namespace

// K3 and K4 are one kernel (block_thread; with the pyramid, fit_forward,
// the block's levels and fit_reverse).
__global__ void __launch_bounds__(kNT, kMinBlocks)
sdf3d_fit_step_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                      const int* __restrict__ trow, const int* __restrict__ tcol,
                      const float* __restrict__ tr, const float* __restrict__ tg,
                      const float* __restrict__ tb, const float* __restrict__ tc, float sil_w, float sil_beta,
                      float* __restrict__ partials, int H, int W) {
  // The uniforms and parameters from shared memory, loaded once a block
  // (faster than registers or global memory at each use; PERF.md).
  // K3's z is the view, whose uniforms are row z of (V, 30).
  __shared__ float inputs[sdf3d::N_UNIFORMS + kP];
  const bool views = trow == nullptr;
  if (views) uni += static_cast<size_t>(blockIdx.z) * sdf3d::N_UNIFORMS;
  for (int k = threadIdx.y * blockDim.x + threadIdx.x; k < sdf3d::N_UNIFORMS + kP; k += kNT)
    inputs[k] = k < sdf3d::N_UNIFORMS ? __ldg(uni + k) : __ldg(prm + (k - sdf3d::N_UNIFORMS));
  __syncthreads();
  const float* u = inputs;
  const float* p = inputs + sdf3d::N_UNIFORMS;
  const Targets tgt{tr, tg, tb, tc, sil_w, sil_beta};
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  if constexpr (kLevels == 0) {
    block_thread(u, p, trow, tcol, tgt, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, threadIdx.y, H, W, acc);
  } else {
    // Every thread reaches each __syncthreads(): one outside the image
    // stores zeros and skips its reverse part alone.
    __shared__ Pyramid py;
    const int tid = threadIdx.y * Cfg::block_w + threadIdx.x;
    PixelState st;
    size_t i;
    float rows, cols;
    const bool live = block_pixel(u, trow, tcol, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, threadIdx.y, H, W,
                                  i, rows, cols);
    if (live) fit_forward(u, p, tgt, i, rows, cols, H, W, st, acc);
    pyramid_store(py, tid, live, st);
    for (int l = 1; l <= kLevels; ++l) {
      __syncthreads();
      pyramid_pool(py, l, tid, acc);
    }
    __syncthreads();
    if (live) {
      pyramid_cotangent(py, threadIdx.x, threadIdx.y, st);
      fit_reverse(u, p, st, acc);
    }
  }
  float v[kLive];
  row_values(acc, v);
  // The partial rows: K3's views each a run of padded_rows(gx·gy) rows, K4's
  // tiles one run.
  const int plane = gridDim.x * gridDim.y, in_plane = blockIdx.y * gridDim.x + blockIdx.x;
  const int block = views ? blockIdx.z * sdf3d::padded_rows(plane) + in_plane : blockIdx.z * plane + in_plane;
  sdf3d::block_sum_store<kLive, kNT>(v, partials + block,
                                     views ? gridDim.z * sdf3d::padded_rows(plane)
                                           : sdf3d::padded_rows(plane * gridDim.z));
}

// V views: uni (V, 30); tr, tg, tb: the target planes (V, H, W) each; tc:
// the coverage target planes (V, H, W) (read with Fit::silhouette alone,
// else may be null), sil_w and sil_beta the silhouette term's weight and
// softness.  partials: each view's n_blocks partial rows by column, (kLive,
// V · padded_rows(n_blocks)) float32, n_blocks = ceil(W/block_w) ·
// ceil(H/block_h); totals: (V, kTotals) float64 (P + 31; the loss alone for
// the loss-only variants), each view's own.  Launches the fit kernel and its
// total on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sdf3d_fit_step(const float* uni, const float* prm, const float* tr, const float* tg,
                              const float* tb, const float* tc, float sil_w, float sil_beta, float* partials,
                              double* totals, int H, int W, int V, void* stream) {
  if (H <= 0 || W <= 0 || V <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((W + Cfg::block_w - 1) / Cfg::block_w, (H + Cfg::block_h - 1) / Cfg::block_h, V);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sdf3d_fit_step_kernel<<<grid, block, 0, s>>>(uni, prm, nullptr, nullptr, tr, tg, tb, tc, sil_w, sil_beta, partials,
                                               H, W);
  return sdf3d::launch_column_total<kLive, FitColumns>(partials, grid.x * grid.y, totals, s, V);
}

// K4 over T tiles (int32 origin tables) of an H x W image; target planes
// (and the coverage plane) of T·TH x TW.  partials: (kLive,
// padded_rows(n_blocks)), n_blocks = T · ceil(TH/block_h) · ceil(TW/block_w);
// totals as sdf3d_fit_step.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int sdf3d_fit_step_tiles(const float* uni, const float* prm, const int* trow, const int* tcol,
                                    const float* tr, const float* tg, const float* tb, const float* tc, float sil_w,
                                    float sil_beta, float* partials, double* totals, int T, int H, int W,
                                    void* stream) {
  if (T <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((Cfg::tile_w + Cfg::block_w - 1) / Cfg::block_w, (Cfg::tile_h + Cfg::block_h - 1) / Cfg::block_h,
                  T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sdf3d_fit_step_kernel<<<grid, block, 0, s>>>(uni, prm, trow, tcol, tr, tg, tb, tc, sil_w, sil_beta, partials, H,
                                               W);
  return sdf3d::launch_column_total<kLive, FitColumns>(partials, grid.x * grid.y * grid.z, totals, s);
}

#else  // A C++ compiler: the same blocks, rows and total, one after another.

#include <vector>

namespace {
// The kernel's grid of gx x gy x gz blocks on the host: each block's
// threads one after another through fit_forward, then the pyramid's levels
// (every thread's group at a level before the next level), then
// fit_reverse; each block's partial row in the card's order
// (block_sum_host), then fixed_order_total (of each view alone for K3,
// whose z is the view).
void run_grid(const float* uni, const float* prm, const int* trow, const int* tcol, const Targets& tgt, int gx,
              int gy, int gz, int H, int W, float* partials, double* totals) {
  const bool views = trow == nullptr;
  struct Sums {
    float a[kAcc];
  };
  std::vector<PixelState> st(kNT);
  std::vector<Sums> acc(kNT);
  std::vector<char> live(kNT);
  Pyramid py;
  float v[kNT][kLive];
  for (int z = 0; z < gz; ++z)
    for (int by = 0; by < gy; ++by)
      for (int bx = 0; bx < gx; ++bx) {
        const float* u = views ? uni + static_cast<size_t>(z) * sdf3d::N_UNIFORMS : uni;
        for (int t = 0; t < kNT; ++t) {
          float* a = acc[t].a;
          for (int k = 0; k < kAcc; ++k) a[k] = 0.0f;
          size_t i;
          float rows, cols;
          live[t] = block_pixel(u, trow, tcol, bx, by, z, t % Cfg::block_w, t / Cfg::block_w, H, W, i, rows, cols);
          if (live[t]) fit_forward(u, prm, tgt, i, rows, cols, H, W, st[t], a);
          if constexpr (kLevels > 0) pyramid_store(py, t, live[t], st[t]);
        }
        for (int l = 1; l <= kLevels; ++l)
          for (int t = 0; t < kNT; ++t) pyramid_pool(py, l, t, acc[t].a);
        for (int t = 0; t < kNT; ++t) {
          if (live[t]) {
            if constexpr (kLevels > 0) pyramid_cotangent(py, t % Cfg::block_w, t / Cfg::block_w, st[t]);
            fit_reverse(u, prm, st[t], acc[t].a);
          }
          row_values(acc[t].a, v[t]);
        }
        const size_t block = (static_cast<size_t>(z) * gy + by) * gx + bx;
        sdf3d::block_sum_host<kLive, kNT>(v, partials + block * kLive);
      }
  if (views) {
    for (int z = 0; z < gz; ++z)
      sdf3d::column_total_host<kLive, FitColumns>(partials + static_cast<size_t>(z) * gx * gy * kLive, gx * gy,
                                                  totals + static_cast<size_t>(z) * kTotals);
  } else {
    sdf3d::column_total_host<kLive, FitColumns>(partials, gx * gy * gz, totals);
  }
}
}  // namespace

// partials: each view's n_blocks partial rows row by row, (V · n_blocks,
// kLive) (the card stores them by column); the other arguments and totals
// as sdf3d_fit_step.
extern "C" int sdf3d_fit_step_host(const float* uni, const float* prm, const float* tr, const float* tg,
                                   const float* tb, const float* tc, float sil_w, float sil_beta, float* partials,
                                   double* totals, int H, int W, int V) {
  if (H <= 0 || W <= 0 || V <= 0) return 0;
  run_grid(uni, prm, nullptr, nullptr, Targets{tr, tg, tb, tc, sil_w, sil_beta}, (W + Cfg::block_w - 1) / Cfg::block_w,
           (H + Cfg::block_h - 1) / Cfg::block_h, V, H, W, partials, totals);
  return 0;
}

// K4 over the T tiles: partials and totals as sdf3d_fit_step_tiles.
extern "C" int sdf3d_fit_step_tiles_host(const float* uni, const float* prm, const int* trow, const int* tcol,
                                         const float* tr, const float* tg, const float* tb, const float* tc,
                                         float sil_w, float sil_beta, float* partials, double* totals, int T, int H,
                                         int W) {
  if (T <= 0) return 0;
  run_grid(uni, prm, trow, tcol, Targets{tr, tg, tb, tc, sil_w, sil_beta},
           (Cfg::tile_w + Cfg::block_w - 1) / Cfg::block_w, (Cfg::tile_h + Cfg::block_h - 1) / Cfg::block_h, T, H, W,
           partials, totals);
  return 0;
}

// Each pixel's kAcc values twice, (H·W, kAcc) row-major each: `own` from the
// reverse pass over the Primal of the pixel's own forward (K3), `retraced`
// over the Primal rebuilt from that forward's (t, shadow, ao) by make_primal
// (K5's route, shade_vjp_planes).  The plain-L2 step alone (returns 1 for a
// library with a loss branch).
extern "C" int sdf3d_fit_retrace_host(const float* uni, const float* prm, const float* tr, const float* tg,
                                      const float* tb, float* own, float* retraced, int H, int W) {
  if constexpr (kLevels > 0 || kSil) {
    return 1;
  } else {
    const Targets tgt{tr, tg, tb, nullptr, 0.0f, 0.0f};
    for (int row = 0; row < H; ++row)
      for (int col = 0; col < W; ++col) {
        const size_t i = static_cast<size_t>(row) * W + col;
        const float rows = sdf3d::abs_row<Cfg>(uni, row), cols = static_cast<float>(col);
        float* a = own + i * kAcc;
        float* b = retraced + i * kAcc;
        for (int k = 0; k < kAcc; ++k) a[k] = b[k] = 0.0f;
        fit_pixel(uni, prm, tgt, i, rows, cols, H, W, a);
        if constexpr (!kLossOnly && kV != SHADE_ONLY) {
          PixelState st;
          const sdf3d::Primal pr = primal(uni, prm, rows, cols, H, W, st);
          float res[3];
          b[kAcc - 1] += residual(sdf3d::shade<Cfg, kMat>(uni, pr), tr, tg, tb, i, res);
          sdf3d::shade_vjp_planes<Cfg, Scene, kGradU, kV != NOPOW>(uni, prm, rows, cols, H, W, pr.t, pr.shadow,
                                                                   pr.ao, 2.0f * res[0], 2.0f * res[1],
                                                                   2.0f * res[2], b, kGradU ? b + kP : nullptr);
        }
      }
    return 0;
  }
}

#endif
