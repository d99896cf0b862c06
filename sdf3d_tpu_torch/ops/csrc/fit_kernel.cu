// Fused L2 fit steps for Hopper (sm_90a): the loss sum(rgb - target)^2 and
// its gradient with respect to the scene parameters (and, with
// Fit::wrt_uniforms, the 30 uniforms) in one launch.  K3 runs over an image
// (or a row slab of one), K4 over a work-list of tiles.
//
// K3 replaces sdf3d_tpu/ops/fit_kernel.py::_fit_tile_kernel (the Pallas
// kernel launched by fit_step_kernel) in its plain-L2 form.  One thread per
// pixel, Cfg::block_w x Cfg::block_h blocks as in the render kernel:
// render_pixel (the render kernel's primal: march, normals, shadow, AO,
// shading) gives rgb and the t/shadow/ao values in registers, then
// shade_vjp seeded with 2*(rgb - target) accumulates the pixel's
// gradient.  Each block sums its threads' (P + 30 + 1) values in a fixed
// order and writes one partial row; the caller sums the rows (torch.sum),
// as the JAX package sums its per-tile partials outside its kernel.  No
// atomics: the result is deterministic.  Threads outside the image take
// part in the block sum with zeros (the padding mask of the Pallas kernel).
// Frozen parameter slots (Fit::zero_frozen) read exactly 0.  Launch row r
// is the absolute image row abs_row(r) (render_kernel.cuh), so a rank of a
// sharded fit runs its contiguous or interleaved rows.
//
// K4 (sdf3d_fit_step_tiles) replaces the same Pallas body with
// tile_queue=True (fit_step_kernel_tiles), the per-device fit program of
// the tile-queue layout; one kernel function serves K3 and K4 (below).
// The grid is K2's, (TW/block_w, TH/block_h, T);
// block z reads its tile's origin (trow[z], tcol[z]) and the target stack
// (3, T·TH, TW) at row z·TH + r.  The mask is taken in absolute pixels,
// row < H and col < W of the full image, so the dummy tiles of a plan
// (row0 == H) add exact zeros.  One partial row per block, as K3.
//
// What bounds them: the render kernel's marches (FP32/SFU issue and warp
// divergence), plus the reverse pass, which is straight-line code with
// about ten distance evaluations per pixel and P + 31 values in registers.
// Memory traffic is the target (12 B per pixel) and one partial row per
// block.
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
// ported: a variant writes one partial row of kCols values, the loss last.
#include "shade_vjp.cuh"
#include "sdf3d_scene.cuh"

namespace {
constexpr int kP = Scene::n_params;
constexpr int kG = kP + sdf3d::N_UNIFORMS + 1;  // dP, dU, loss

// Fit::variant (ops/scene_program.py::FIT_VARIANTS, in this order).
enum : int { FULL = 0, WRT_P, PRIMAL, NOSCATTER, NOPOW, SHADE_ONLY, EMPTY, EMPTY_NOIN };
constexpr int kV = Fit::variant;
constexpr bool kLossOnly = kV == PRIMAL || kV == NOSCATTER || kV == EMPTY || kV == EMPTY_NOIN;
// The columns of a partial row, and the values a thread sums: NOSCATTER
// keeps K3's whole gradient in registers and writes its loss alone.
constexpr int kCols = kLossOnly ? 1 : (kV == WRT_P ? kP + 1 : kG);
constexpr int kAcc = kV == NOSCATTER ? kG : kCols;

// SHADE_ONLY's primal: render_pixel's shading at t = 2 with the shadow and
// AO factors 1, no march.
SDF3D_HD sdf3d::Pixel shade_fixed(const float* u, const float* p, float rows, float cols, int H, int W) {
  constexpr float t = 2.0f;
  float dx, dy, dz;
  sdf3d::ray_direction<Cfg>(u, rows, cols, H, W, dx, dy, dz);
  const float ox = u[sdf3d::U_CAM], oy = u[sdf3d::U_CAM + 1], oz = u[sdf3d::U_CAM + 2];
  const float hx = ox + (t * dx), hy = oy + (t * dy), hz = oz + (t * dz);
  float nx, ny, nz, ix, iy, iz;
  sdf3d::estimate_normal<Cfg>(sdf3d::ScenePoint<Scene>{p}, hx, hy, hz, nx, ny, nz);
  sdf3d::light_direction(u, hx, hy, hz, ix, iy, iz);
  return sdf3d::shade_pixel<Cfg>(u, ox, oy, oz, t, hx, hy, hz, nx, ny, nz, ix, iy, iz, 1.0f, 1.0f);
}

// The primal of one pixel: render_pixel, or SHADE_ONLY's fixed planes.
SDF3D_HD sdf3d::Pixel primal_pixel(const float* u, const float* p, float rows, float cols, int H, int W) {
  if constexpr (kV == SHADE_ONLY) {
    return shade_fixed(u, p, rows, cols, H, W);
  } else {
    return sdf3d::render_pixel<Cfg, Scene, kV != NOPOW>(u, p, rows, cols, H, W);
  }
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
    const sdf3d::Pixel px = primal_pixel(u, p, rows, cols, H, W);
    const float rr = px.r - tr[i], rg = px.g - tg[i], rb = px.b - tb[i];
    acc[kAcc - 1] += ((rr * rr) + (rg * rg)) + (rb * rb);
    if constexpr (kV == WRT_P) {
      sdf3d::shade_vjp<Cfg, Scene, false>(u, p, rows, cols, H, W, px.t, px.shadow, px.ao,
                                          2.0f * rr, 2.0f * rg, 2.0f * rb, acc, nullptr);
    } else if constexpr (kV != PRIMAL) {
      sdf3d::shade_vjp<Cfg, Scene, Fit::wrt_uniforms, kV != NOPOW>(u, p, rows, cols, H, W, px.t, px.shadow, px.ao,
                                                                   2.0f * rr, 2.0f * rg, 2.0f * rb, acc, acc + kP);
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
}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {
// Uniforms and parameters into registers, the accumulator to zero.
__device__ __forceinline__ void load_inputs(const float* __restrict__ uni, const float* __restrict__ prm,
                                            float (&u)[sdf3d::N_UNIFORMS], float (&p)[kP > 0 ? kP : 1],
                                            float (&acc)[kAcc]) {
#pragma unroll
  for (int k = 0; k < sdf3d::N_UNIFORMS; ++k) u[k] = __ldg(uni + k);
#pragma unroll
  for (int k = 0; k < kP; ++k) p[k] = __ldg(prm + k);
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
}
}  // namespace

// K3 and K4 are one kernel: trow == nullptr launches K3 (pixel (y, x) of
// the grid, absolute row abs_row(y)), else K4 (pixel (trow[z] + y,
// tcol[z] + x) of tile z, masked in absolute pixels).  Both meet in one
// call of fit_pixel, so a pixel's terms, and a block's partial row over the
// same pixels, have the same bits whichever layout launched them.
__global__ void __launch_bounds__(Cfg::block_w * Cfg::block_h)
sdf3d_fit_step_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                      const int* __restrict__ trow, const int* __restrict__ tcol,
                      const float* __restrict__ tr, const float* __restrict__ tg,
                      const float* __restrict__ tb, float* __restrict__ partials, int H, int W) {
  const int x = blockIdx.x * Cfg::block_w + threadIdx.x;
  const int y = blockIdx.y * Cfg::block_h + threadIdx.y;
  const int z = blockIdx.z;
  const bool tiles = trow != nullptr;
  const int row = tiles ? __ldg(trow + z) + y : y;
  const int col = tiles ? __ldg(tcol + z) + x : x;
  const bool inside = row < H && col < W && (!tiles || (y < Cfg::tile_h && x < Cfg::tile_w));
  float u[sdf3d::N_UNIFORMS], p[kP > 0 ? kP : 1], acc[kAcc];
  load_inputs(uni, prm, u, p, acc);
  if (inside) {
    const size_t i = tiles ? (static_cast<size_t>(z) * Cfg::tile_h + y) * Cfg::tile_w + x
                           : static_cast<size_t>(y) * W + x;
    fit_pixel(u, p, tr, tg, tb, i, tiles ? static_cast<float>(row) : sdf3d::abs_row<Cfg>(u, y),
              static_cast<float>(col), H, W, acc);
  }
  Fit::zero_frozen(acc);
  const size_t block = (static_cast<size_t>(z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if constexpr (kV == NOSCATTER) {
    const float keep[1] = {loss_keeping_gradient(acc)};
    sdf3d::block_sum_store<1, Cfg::block_w * Cfg::block_h>(keep, partials + block);
  } else {
    sdf3d::block_sum_store<kAcc, Cfg::block_w * Cfg::block_h>(acc, partials + block * kAcc);  // kAcc == kCols
  }
}

// partials: (n_blocks, kCols), n_blocks = ceil(W/block_w) * ceil(H/block_h);
// kCols is K3's P + 31 for FULL.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sdf3d_fit_step(const float* uni, const float* prm, const float* tr, const float* tg,
                              const float* tb, float* partials, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((W + Cfg::block_w - 1) / Cfg::block_w, (H + Cfg::block_h - 1) / Cfg::block_h);
  sdf3d_fit_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      uni, prm, nullptr, nullptr, tr, tg, tb, partials, H, W);
  return static_cast<int>(cudaGetLastError());
}

// K4 over T tiles (int32 origin tables) of an H x W image; target planes of
// T·TH x TW.  partials: (T · ceil(TH/block_h) · ceil(TW/block_w), kCols).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sdf3d_fit_step_tiles(const float* uni, const float* prm, const int* trow, const int* tcol,
                                    const float* tr, const float* tg, const float* tb, float* partials, int T,
                                    int H, int W, void* stream) {
  if (T <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((Cfg::tile_w + Cfg::block_w - 1) / Cfg::block_w, (Cfg::tile_h + Cfg::block_h - 1) / Cfg::block_h,
                  T);
  sdf3d_fit_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      uni, prm, trow, tcol, tr, tg, tb, partials, H, W);
  return static_cast<int>(cudaGetLastError());
}

#else  // A C++ compiler: the same per-pixel body, summed over the image or the work-list.

namespace {
// The kCols totals from a thread's kAcc sums (NOSCATTER: its loss value).
void store_totals(const float (&acc)[kAcc], float* out) {
  if constexpr (kV == NOSCATTER) {
    out[0] = loss_keeping_gradient(acc);
  } else {
    for (int k = 0; k < kCols; ++k) out[k] = acc[k];
  }
}
}  // namespace

// out: the kCols totals (K3's P + 31 for FULL).
extern "C" int sdf3d_fit_step_host(const float* uni, const float* prm, const float* tr, const float* tg,
                                   const float* tb, float* out, int H, int W) {
  float acc[kAcc] = {};
  for (int row = 0; row < H; ++row)
    for (int col = 0; col < W; ++col)
      fit_pixel(uni, prm, tr, tg, tb, static_cast<size_t>(row) * W + col, sdf3d::abs_row<Cfg>(uni, row),
                static_cast<float>(col), H, W, acc);
  Fit::zero_frozen(acc);
  store_totals(acc, out);
  return 0;
}

// out: the kCols totals over the T tiles.
extern "C" int sdf3d_fit_step_tiles_host(const float* uni, const float* prm, const int* trow, const int* tcol,
                                         const float* tr, const float* tg, const float* tb, float* out, int T,
                                         int H, int W) {
  float acc[kAcc] = {};
  for (int z = 0; z < T; ++z)
    for (int r = 0; r < Cfg::tile_h; ++r)
      for (int c = 0; c < Cfg::tile_w; ++c) {
        const int row = trow[z] + r, col = tcol[z] + c;
        if (row < H && col < W)
          fit_pixel(uni, prm, tr, tg, tb, (static_cast<size_t>(z) * Cfg::tile_h + r) * Cfg::tile_w + c,
                    static_cast<float>(row), static_cast<float>(col), H, W, acc);
      }
  Fit::zero_frozen(acc);
  store_totals(acc, out);
  return 0;
}

#endif
