// Fused L2 fit steps for Hopper (sm_90a): the loss sum(rgb - target)^2 and
// its gradient with respect to the scene parameters (and, with
// Fit::wrt_uniforms, the 30 uniforms) in one launch, totals included.  K3
// runs over an image (or a row slab of one), K4 over a work-list of tiles.
//
// K3 replaces sdf3d_tpu/ops/fit_kernel.py::_fit_tile_kernel (the Pallas
// kernel launched by fit_step_kernel) in its plain-L2 form.  One thread per
// pixel, Cfg::block_w x Cfg::block_h blocks as in the render kernel.  A
// thread traces its pixel's primal once (trace_pixel: the marches and the
// Primal of render_kernel.cuh), shades it, and runs the reverse pass
// (shade_vjp.cuh) over that same Primal seeded with 2*(rgb - target): the
// ray, hit point, normal taps and unit vectors are not traced again.
// Launch row r is the absolute image row abs_row(r) (render_kernel.cuh), so
// a rank of a sharded fit runs its contiguous or interleaved rows.
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

// The primal of one pixel: trace_pixel, or SHADE_ONLY's fixed planes.
SDF3D_HD sdf3d::Primal primal(const float* u, const float* p, float rows, float cols, int H, int W) {
  if constexpr (kV == SHADE_ONLY) {
    return sdf3d::make_primal<Cfg, Scene>(u, p, rows, cols, H, W, 2.0f, 1.0f, 1.0f);
  } else {
    return sdf3d::trace_pixel<Cfg, Scene, kV != NOPOW>(u, p, rows, cols, H, W);
  }
}

// The residual of pixel px against its target at position i, times 2 (the
// loss's cotangent), and its loss.
SDF3D_HD float residual(const sdf3d::Pixel& px, const float* tr, const float* tg, const float* tb, size_t i,
                        float (&g)[3]) {
  const float rr = px.r - tr[i], rg = px.g - tg[i], rb = px.b - tb[i];
  g[0] = 2.0f * rr; g[1] = 2.0f * rg; g[2] = 2.0f * rb;
  return ((rr * rr) + (rg * rg)) + (rb * rb);
}

// One pixel at absolute (rows, cols) of an H x W image, its target at
// position i of the target planes: adds its loss and gradient to acc[kAcc]
// (the loss last).
SDF3D_HD void fit_pixel(const float* u, const float* p, const float* tr, const float* tg, const float* tb,
                        size_t i, float rows, float cols, int H, int W, float* acc) {
  if constexpr (kV == EMPTY_NOIN) {
    acc[0] += 1.0f;
  } else if constexpr (kV == EMPTY) {
    acc[0] += (tr[i] + tg[i]) + tb[i];
  } else {
    const sdf3d::Primal pr = primal(u, p, rows, cols, H, W);
    float g[3];
    acc[kAcc - 1] += residual(sdf3d::shade<Cfg>(u, pr), tr, tg, tb, i, g);
    if constexpr (kV != PRIMAL) {
      sdf3d::shade_vjp<Cfg, Scene, kGradU, kV != NOPOW>(u, p, pr, g[0], g[1], g[2], acc,
                                                        kGradU ? acc + kP : nullptr);
    }
  }
}

// Thread (tx, ty) of block (bx, by, z): adds its pixel's terms to acc, or
// nothing outside the image.  trow == nullptr is K3 (pixel (y, x) of the
// grid, absolute row abs_row(y)), else K4 (pixel (trow[z] + y, tcol[z] + x)
// of tile z, masked in absolute pixels).  Both meet in one call of
// fit_pixel, so a pixel's terms have the same bits whichever layout
// launched them.
SDF3D_HD void block_thread(const float* u, const float* p, const int* trow, const int* tcol, const float* tr,
                           const float* tg, const float* tb, int bx, int by, int z, int tx, int ty, int H, int W,
                           float* acc) {
  const int x = bx * Cfg::block_w + tx, y = by * Cfg::block_h + ty;
  const bool tiles = trow != nullptr;
  const int row = tiles ? trow[z] + y : y;
  const int col = tiles ? tcol[z] + x : x;
  if (row < H && col < W && (!tiles || (y < Cfg::tile_h && x < Cfg::tile_w))) {
    const size_t i = tiles ? (static_cast<size_t>(z) * Cfg::tile_h + y) * Cfg::tile_w + x
                           : static_cast<size_t>(y) * W + x;
    fit_pixel(u, p, tr, tg, tb, i, tiles ? static_cast<float>(row) : sdf3d::abs_row<Cfg>(u, y),
              static_cast<float>(col), H, W, acc);
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

// K3 and K4 are one kernel (block_thread).
__global__ void __launch_bounds__(kNT, kMinBlocks)
sdf3d_fit_step_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                      const int* __restrict__ trow, const int* __restrict__ tcol,
                      const float* __restrict__ tr, const float* __restrict__ tg,
                      const float* __restrict__ tb, float* __restrict__ partials, int H, int W) {
  // The uniforms and parameters from shared memory, loaded once a block
  // (faster than registers or global memory at each use; PERF.md).
  __shared__ float inputs[sdf3d::N_UNIFORMS + kP];
  for (int k = threadIdx.y * blockDim.x + threadIdx.x; k < sdf3d::N_UNIFORMS + kP; k += kNT)
    inputs[k] = k < sdf3d::N_UNIFORMS ? __ldg(uni + k) : __ldg(prm + (k - sdf3d::N_UNIFORMS));
  __syncthreads();
  const float* u = inputs;
  const float* p = inputs + sdf3d::N_UNIFORMS;
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  block_thread(u, p, trow, tcol, tr, tg, tb, blockIdx.x, blockIdx.y, blockIdx.z, threadIdx.x, threadIdx.y, H, W,
               acc);
  float v[kLive];
  row_values(acc, v);
  const int block = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  sdf3d::block_sum_store<kLive, kNT>(v, partials + block,
                                     sdf3d::padded_rows(gridDim.x * gridDim.y * gridDim.z));
}

// partials: the n_blocks partial rows by column, (kLive, padded_rows(n_blocks))
// float32, n_blocks = ceil(W/block_w) * ceil(H/block_h); totals: (kTotals,)
// float64 (P + 31; the loss alone for the loss-only variants).  Launches
// the fit kernel and its total on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int sdf3d_fit_step(const float* uni, const float* prm, const float* tr, const float* tg,
                              const float* tb, float* partials, double* totals, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((W + Cfg::block_w - 1) / Cfg::block_w, (H + Cfg::block_h - 1) / Cfg::block_h);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sdf3d_fit_step_kernel<<<grid, block, 0, s>>>(uni, prm, nullptr, nullptr, tr, tg, tb, partials, H, W);
  return sdf3d::launch_column_total<kLive, FitColumns>(partials, grid.x * grid.y, totals, s);
}

// K4 over T tiles (int32 origin tables) of an H x W image; target planes of
// T·TH x TW.  partials: (kLive, padded_rows(n_blocks)), n_blocks = T ·
// ceil(TH/block_h) · ceil(TW/block_w); totals as sdf3d_fit_step.  Launches
// on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sdf3d_fit_step_tiles(const float* uni, const float* prm, const int* trow, const int* tcol,
                                    const float* tr, const float* tg, const float* tb, float* partials,
                                    double* totals, int T, int H, int W, void* stream) {
  if (T <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((Cfg::tile_w + Cfg::block_w - 1) / Cfg::block_w, (Cfg::tile_h + Cfg::block_h - 1) / Cfg::block_h,
                  T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sdf3d_fit_step_kernel<<<grid, block, 0, s>>>(uni, prm, trow, tcol, tr, tg, tb, partials, H, W);
  return sdf3d::launch_column_total<kLive, FitColumns>(partials, grid.x * grid.y * grid.z, totals, s);
}

#else  // A C++ compiler: the same blocks, rows and total, one after another.

namespace {
// The kernel's grid of gx x gy x gz blocks on the host: each block's
// partial row in the card's order (block_sum_host), then
// fixed_order_total.
void run_grid(const float* uni, const float* prm, const int* trow, const int* tcol, const float* tr,
              const float* tg, const float* tb, int gx, int gy, int gz, int H, int W, float* partials,
              double* totals) {
  float v[kNT][kLive];
  for (int z = 0; z < gz; ++z)
    for (int by = 0; by < gy; ++by)
      for (int bx = 0; bx < gx; ++bx) {
        for (int ty = 0; ty < Cfg::block_h; ++ty)
          for (int tx = 0; tx < Cfg::block_w; ++tx) {
            float acc[kAcc] = {};
            block_thread(uni, prm, trow, tcol, tr, tg, tb, bx, by, z, tx, ty, H, W, acc);
            row_values(acc, v[ty * Cfg::block_w + tx]);
          }
        const size_t block = (static_cast<size_t>(z) * gy + by) * gx + bx;
        sdf3d::block_sum_host<kLive, kNT>(v, partials + block * kLive);
      }
  sdf3d::column_total_host<kLive, FitColumns>(partials, gx * gy * gz, totals);
}
}  // namespace

// partials: the n_blocks partial rows row by row, (n_blocks, kLive) (the
// card stores them by column); totals as sdf3d_fit_step.
extern "C" int sdf3d_fit_step_host(const float* uni, const float* prm, const float* tr, const float* tg,
                                   const float* tb, float* partials, double* totals, int H, int W) {
  if (H <= 0 || W <= 0) return 0;
  run_grid(uni, prm, nullptr, nullptr, tr, tg, tb, (W + Cfg::block_w - 1) / Cfg::block_w,
           (H + Cfg::block_h - 1) / Cfg::block_h, 1, H, W, partials, totals);
  return 0;
}

// K4 over the T tiles: partials and totals as sdf3d_fit_step_tiles.
extern "C" int sdf3d_fit_step_tiles_host(const float* uni, const float* prm, const int* trow, const int* tcol,
                                         const float* tr, const float* tg, const float* tb, float* partials,
                                         double* totals, int T, int H, int W) {
  if (T <= 0) return 0;
  run_grid(uni, prm, trow, tcol, tr, tg, tb, (Cfg::tile_w + Cfg::block_w - 1) / Cfg::block_w,
           (Cfg::tile_h + Cfg::block_h - 1) / Cfg::block_h, T, H, W, partials, totals);
  return 0;
}

// Each pixel's kAcc values twice, (H·W, kAcc) row-major each: `own` from the
// reverse pass over the Primal of the pixel's own forward (K3), `retraced`
// over the Primal rebuilt from that forward's (t, shadow, ao) by make_primal
// (K5's route, shade_vjp_planes).
extern "C" int sdf3d_fit_retrace_host(const float* uni, const float* prm, const float* tr, const float* tg,
                                      const float* tb, float* own, float* retraced, int H, int W) {
  for (int row = 0; row < H; ++row)
    for (int col = 0; col < W; ++col) {
      const size_t i = static_cast<size_t>(row) * W + col;
      const float rows = sdf3d::abs_row<Cfg>(uni, row), cols = static_cast<float>(col);
      float* a = own + i * kAcc;
      float* b = retraced + i * kAcc;
      for (int k = 0; k < kAcc; ++k) a[k] = b[k] = 0.0f;
      fit_pixel(uni, prm, tr, tg, tb, i, rows, cols, H, W, a);
      if constexpr (!kLossOnly && kV != SHADE_ONLY) {
        const sdf3d::Primal pr = primal(uni, prm, rows, cols, H, W);
        float g[3];
        b[kAcc - 1] += residual(sdf3d::shade<Cfg>(uni, pr), tr, tg, tb, i, g);
        sdf3d::shade_vjp_planes<Cfg, Scene, kGradU, kV != NOPOW>(uni, prm, rows, cols, H, W, pr.t, pr.shadow, pr.ao,
                                                                 g[0], g[1], g[2], b, kGradU ? b + kP : nullptr);
      }
    }
  return 0;
}

#endif
