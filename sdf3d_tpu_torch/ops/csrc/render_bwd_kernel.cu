// Render backward for Hopper (sm_90a): the gradient of any loss of the
// rendered image with respect to the scene parameters and the 30
// uniforms, from the forward's t/shadow/ao planes and the planar RGB
// cotangent.
//
// Replaces sdf3d_tpu/ops/render_bwd_kernel.py::_bwd_tile_kernel (the
// Pallas kernel launched by render_kernel_backward).  One thread per pixel
// in Cfg::block_w x Cfg::block_h blocks: shade_vjp_planes (the pixel's
// primal rebuilt from the planes, then its reverse pass) seeded with the
// pixel's cotangent, then a fixed-order block sum into one (P + 30)
// partial row per block, summed by the caller.  No atomics: deterministic.  Threads outside
// the image add zeros.
//
// What bounds it: the reverse pass (about ten distance evaluations and the
// shading algebra per pixel, FP32/SFU issue) and the reads of six planes,
// 24 B per pixel (50 MB at 1920x1080, 15 us at 3.35 TB/s).
#include "shade_vjp.cuh"
#include "sdf3d_scene.cuh"

namespace {
constexpr int kP = Scene::n_params;
constexpr int kG = kP + sdf3d::N_UNIFORMS;  // dP, dU

SDF3D_HD void bwd_pixel(const float* u, const float* p, const float* gr, const float* gg, const float* gb,
                        const float* t, const float* sh, const float* ao, int row, int col, int H, int W,
                        float* acc) {
  const size_t i = static_cast<size_t>(row) * W + col;
  sdf3d::shade_vjp_planes<Cfg, Scene, true>(u, p, sdf3d::abs_row<Cfg>(u, row), static_cast<float>(col), H, W, t[i],
                                            sh[i], ao[i], gr[i], gg[i], gb[i], acc, acc + kP);
}
}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(Cfg::block_w * Cfg::block_h)
sdf3d_render_bwd_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                        const float* __restrict__ gr, const float* __restrict__ gg,
                        const float* __restrict__ gb, const float* __restrict__ t,
                        const float* __restrict__ sh, const float* __restrict__ ao,
                        float* __restrict__ partials, int H, int W) {
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
  if (row < H && col < W) bwd_pixel(u, p, gr, gg, gb, t, sh, ao, row, col, H, W, acc);
  sdf3d::block_sum_store<kG, Cfg::block_w * Cfg::block_h>(
      acc, partials + static_cast<size_t>(blockIdx.y * gridDim.x + blockIdx.x) * kG);
}

// partials: (n_blocks, P + 30), n_blocks = ceil(W/block_w) * ceil(H/block_h).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sdf3d_render_bwd(const float* uni, const float* prm, const float* gr, const float* gg,
                                const float* gb, const float* t, const float* sh, const float* ao,
                                float* partials, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((W + Cfg::block_w - 1) / Cfg::block_w, (H + Cfg::block_h - 1) / Cfg::block_h);
  sdf3d_render_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      uni, prm, gr, gg, gb, t, sh, ao, partials, H, W);
  return static_cast<int>(cudaGetLastError());
}

#else  // A C++ compiler: the same per-pixel body, summed over the image.

// out: the (P + 30) totals.
extern "C" int sdf3d_render_bwd_host(const float* uni, const float* prm, const float* gr, const float* gg,
                                     const float* gb, const float* t, const float* sh, const float* ao,
                                     float* out, int H, int W) {
  for (int k = 0; k < kG; ++k) out[k] = 0.0f;
  for (int row = 0; row < H; ++row)
    for (int col = 0; col < W; ++col) bwd_pixel(uni, prm, gr, gg, gb, t, sh, ao, row, col, H, W, out);
  return 0;
}

#endif
