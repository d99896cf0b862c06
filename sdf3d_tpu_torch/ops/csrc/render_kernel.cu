// Fused forward render kernel for Hopper (sm_90a).
//
// Replaces sdf3d_tpu/ops/render_kernel.py::_render_tile_kernel (the Pallas
// kernel launched by _render_kernel_call).  One thread renders one pixel;
// 2-D blocks of Cfg::block_w x Cfg::block_h threads cover a pixel tile, so
// a warp holds neighbouring, coherent rays.  The kernel masks the ragged
// image edge itself and writes exactly rgb (3,H,W) plus the t, shadow and
// ao planes (H,W), float32.
//
// What bounds it: FP32 and SFU issue (sqrt, divide, pow per march step and
// shading) and warp divergence -- the slowest ray of a warp sets its pace,
// the SIMT form of the TPU kernel's whole-tile exit.  Not memory: it reads
// 30 uniforms and the scene parameters once per thread (broadcast, cached)
// and writes 24 B per pixel (about 50 MB at 1920x1080).  This is a simple
// first version: wgmma and TMA have no role in it.
//
// Built per scene structure: the generated header sdf3d_scene.cuh
// (ops/scene_program.py) supplies struct Scene (distance code) and struct
// Cfg (static settings as constexpr).  Scene parameters and uniforms are
// run-time device pointers, so a parameter change never rebuilds.
#include "render_kernel.cuh"
#include "sdf3d_scene.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(Cfg::block_w * Cfg::block_h)
sdf3d_render_fwd_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                        float* __restrict__ rgb, float* __restrict__ t_out,
                        float* __restrict__ sh_out, float* __restrict__ ao_out, int H, int W) {
  const int col = blockIdx.x * Cfg::block_w + threadIdx.x;
  const int row = blockIdx.y * Cfg::block_h + threadIdx.y;
  if (row >= H || col >= W) return;

  // Uniforms and parameters into registers once (the SMEM reads of the
  // TPU kernel); every index below is a compile-time constant.
  float u[sdf3d::N_UNIFORMS];
#pragma unroll
  for (int k = 0; k < sdf3d::N_UNIFORMS; ++k) u[k] = __ldg(uni + k);
  float p[Scene::n_params > 0 ? Scene::n_params : 1];
#pragma unroll
  for (int k = 0; k < Scene::n_params; ++k) p[k] = __ldg(prm + k);

  const sdf3d::Pixel px = sdf3d::render_pixel<Cfg, Scene>(u, p, row, col, H, W);
  const size_t i = static_cast<size_t>(row) * W + col;
  const size_t plane = static_cast<size_t>(H) * W;
  rgb[i] = px.r;
  rgb[plane + i] = px.g;
  rgb[2 * plane + i] = px.b;
  t_out[i] = px.t;
  sh_out[i] = px.shadow;
  ao_out[i] = px.ao;
}

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sdf3d_render_fwd(const float* uni, const float* prm, float* rgb, float* t,
                                float* sh, float* ao, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((W + Cfg::block_w - 1) / Cfg::block_w, (H + Cfg::block_h - 1) / Cfg::block_h);
  sdf3d_render_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      uni, prm, rgb, t, sh, ao, H, W);
  return static_cast<int>(cudaGetLastError());
}

#else  // A C++ compiler: the same per-pixel body over the image on the CPU.

extern "C" int sdf3d_render_fwd_host(const float* uni, const float* prm, float* rgb, float* t,
                                     float* sh, float* ao, int H, int W) {
  const size_t plane = static_cast<size_t>(H) * W;
  for (int row = 0; row < H; ++row) {
    for (int col = 0; col < W; ++col) {
      const sdf3d::Pixel px = sdf3d::render_pixel<Cfg, Scene>(uni, prm, row, col, H, W);
      const size_t i = static_cast<size_t>(row) * W + col;
      rgb[i] = px.r;
      rgb[plane + i] = px.g;
      rgb[2 * plane + i] = px.b;
      t[i] = px.t;
      sh[i] = px.shadow;
      ao[i] = px.ao;
    }
  }
  return 0;
}

#endif
