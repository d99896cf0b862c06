// Fused L2 fit step for Hopper (sm_90a): the loss sum(rgb - target)^2 and
// its gradient with respect to the scene parameters (and, with
// Fit::wrt_uniforms, the 30 uniforms) in one launch.
//
// Replaces sdf3d_tpu/ops/fit_kernel.py::_fit_tile_kernel (the Pallas
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
// Frozen parameter slots (Fit::zero_frozen) read exactly 0.
//
// What bounds it: the render kernel's marches (FP32/SFU issue and warp
// divergence), plus the reverse pass, which is straight-line code with
// about ten distance evaluations per pixel and P + 31 values in registers.
// Memory traffic is the target (12 B per pixel) and one partial row per
// block.
#include "shade_vjp.cuh"
#include "sdf3d_scene.cuh"

namespace {
constexpr int kP = Scene::n_params;
constexpr int kG = kP + sdf3d::N_UNIFORMS + 1;  // dP, dU, loss

// One pixel: adds its loss and gradient to acc[kG] (acc untouched when the
// pixel is outside the image).
SDF3D_HD void fit_pixel(const float* u, const float* p, const float* tr, const float* tg,
                        const float* tb, int row, int col, int H, int W, float* acc) {
  const sdf3d::Pixel px = sdf3d::render_pixel<Cfg, Scene>(u, p, row, col, H, W);
  const size_t i = static_cast<size_t>(row) * W + col;
  const float rr = px.r - tr[i], rg = px.g - tg[i], rb = px.b - tb[i];
  acc[kG - 1] += ((rr * rr) + (rg * rg)) + (rb * rb);
  sdf3d::shade_vjp<Cfg, Scene, Fit::wrt_uniforms>(u, p, row, col, H, W, px.t, px.shadow, px.ao,
                                                  2.0f * rr, 2.0f * rg, 2.0f * rb, acc, acc + kP);
}
}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(Cfg::block_w * Cfg::block_h)
sdf3d_fit_step_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                      const float* __restrict__ tr, const float* __restrict__ tg,
                      const float* __restrict__ tb, float* __restrict__ partials, int H, int W) {
  const int col = blockIdx.x * Cfg::block_w + threadIdx.x;
  const int row = blockIdx.y * Cfg::block_h + threadIdx.y;
  float u[sdf3d::N_UNIFORMS];
#pragma unroll
  for (int k = 0; k < sdf3d::N_UNIFORMS; ++k) u[k] = __ldg(uni + k);
  float p[kP > 0 ? kP : 1];
#pragma unroll
  for (int k = 0; k < kP; ++k) p[k] = __ldg(prm + k);

  float acc[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) acc[k] = 0.0f;
  if (row < H && col < W) fit_pixel(u, p, tr, tg, tb, row, col, H, W, acc);
  Fit::zero_frozen(acc);
  sdf3d::block_sum_store<kG, Cfg::block_w * Cfg::block_h>(
      acc, partials + static_cast<size_t>(blockIdx.y * gridDim.x + blockIdx.x) * kG);
}

// partials: (n_blocks, P + 31), n_blocks = ceil(W/block_w) * ceil(H/block_h).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sdf3d_fit_step(const float* uni, const float* prm, const float* tr, const float* tg,
                              const float* tb, float* partials, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((W + Cfg::block_w - 1) / Cfg::block_w, (H + Cfg::block_h - 1) / Cfg::block_h);
  sdf3d_fit_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      uni, prm, tr, tg, tb, partials, H, W);
  return static_cast<int>(cudaGetLastError());
}

#else  // A C++ compiler: the same per-pixel body, summed over the image.

// out: the (P + 31) totals.
extern "C" int sdf3d_fit_step_host(const float* uni, const float* prm, const float* tr, const float* tg,
                                   const float* tb, float* out, int H, int W) {
  for (int k = 0; k < kG; ++k) out[k] = 0.0f;
  for (int row = 0; row < H; ++row)
    for (int col = 0; col < W; ++col) fit_pixel(uni, prm, tr, tg, tb, row, col, H, W, out);
  Fit::zero_frozen(out);
  return 0;
}

#endif
