// Forward render kernel of neural-SDF scenes for Hopper (sm_90a).
//
// Replaces sdf3d_tpu/ops/neural_kernel.py::_neural_tile_kernel (the Pallas
// kernel launched by _neural_kernel_call).  That kernel keeps a block of
// 1024 rays as (N, 8) matrices so each MLP evaluation is a chain of matmuls
// on the TPU's matrix unit.  Here one thread marches one ray and evaluates
// the MLP in its own body (neural_kernel.cuh): 1-D blocks of
// Cfg::block_rays threads over the pixels in row-major order, so a warp
// holds 32 neighbouring rays of one row.  The kernel masks the image's end
// itself and writes exactly rgb (3,H,W) and the t, shadow and ao planes
// (H,W), float32.
//
// What bounds it: FP32 instructions.  One evaluation at hidden H and depth
// 3 is about H*H + 5*H fused multiply-adds and 2*H softplus (expf and
// log1pf), and a ray takes tens of evaluations (the march, the normal taps,
// the shadow march, the AO taps); the slowest ray of a warp sets its pace.
// Every thread of a warp reads the same weight at the same time, so the
// weights are broadcast reads: from shared memory when the MLP's block fits
// a CUDA block's 227 KB (copied once per block; hidden 64 at depth 3 is
// 18 KB, hidden 128 69 KB), else from global memory through the read-only
// cache (hidden 256 is 268 KB).  A layer takes four outputs at a time, so
// one 16-byte load feeds four multiply-adds.  The activation vector lives
// in registers up to hidden 128; wider depth-3 MLPs recompute the first
// layer per chunk of outputs instead (neural_kernel.cuh, mlp_chunked).
// This is a simple first version: it does not use the tensor cores
// (ROADMAP: a tensor-core neural kernel).
//
// Built per scene structure: the generated header sdf3d_scene.cuh
// (ops/scene_program.py::cuda_neural_source) supplies struct Cfg (static
// settings), struct Scene (the analytic subtree's point form, the AO taps)
// and struct Mlp (hidden width, layer count and parameter offsets).  All
// parameter values, weights included, are one run-time device vector, so
// new weights never rebuild.
#include "neural_kernel.cuh"
#include "sdf3d_scene.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(Cfg::block_rays)
sdf3d_neural_fwd_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                        float* __restrict__ rgb, float* __restrict__ t_out,
                        float* __restrict__ sh_out, float* __restrict__ ao_out, int H, int W) {
  extern __shared__ float4 smem4[];  // the MLP's block when Mlp::smem, 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const float* mlp = prm + Mlp::offset;
  if constexpr (Mlp::smem) {
    for (int k = threadIdx.x; k < Mlp::size; k += Cfg::block_rays) smem[k] = __ldg(mlp + k);
    __syncthreads();
  }
  const int i = blockIdx.x * Cfg::block_rays + threadIdx.x;
  if (i >= H * W) return;
  const int row = i / W, col = i - row * W;

  float u[sdf3d::N_UNIFORMS];
#pragma unroll
  for (int k = 0; k < sdf3d::N_UNIFORMS; ++k) u[k] = __ldg(uni + k);
  float pa[Scene::n_analytic > 0 ? Scene::n_analytic : 1];
#pragma unroll
  for (int k = 0; k < Scene::n_analytic; ++k) pa[k] = __ldg(prm + Scene::analytic_offset + k);

  sdf3d::Pixel px;
  if constexpr (Mlp::smem) {
    px = sdf3d::render_neural_pixel<Cfg, Scene, Mlp>(u, pa, sdf3d::SharedWeights{smem}, row, col, H, W);
  } else {
    px = sdf3d::render_neural_pixel<Cfg, Scene, Mlp>(u, pa, sdf3d::GlobalWeights<Mlp::aligned>{mlp}, row, col, H, W);
  }
  const size_t plane = static_cast<size_t>(H) * W;
  rgb[i] = px.r;
  rgb[plane + i] = px.g;
  rgb[2 * plane + i] = px.b;
  t_out[i] = px.t;
  sh_out[i] = px.shadow;
  ao_out[i] = px.ao;
}

// Launches on `stream`, allocates nothing, returns the first CUDA error.
extern "C" int sdf3d_neural_fwd(const float* uni, const float* prm, float* rgb, float* t,
                                float* sh, float* ao, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  constexpr int smem_bytes = Mlp::smem ? Mlp::size * static_cast<int>(sizeof(float)) : 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(sdf3d_neural_fwd_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n = H * W;
  const int grid = (n + Cfg::block_rays - 1) / Cfg::block_rays;
  sdf3d_neural_fwd_kernel<<<grid, Cfg::block_rays, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      uni, prm, rgb, t, sh, ao, H, W);
  return static_cast<int>(cudaGetLastError());
}

#else  // A C++ compiler: the same per-ray body over the image on the CPU.

extern "C" int sdf3d_neural_fwd_host(const float* uni, const float* prm, float* rgb, float* t,
                                     float* sh, float* ao, int H, int W) {
  const size_t plane = static_cast<size_t>(H) * W;
  const sdf3d::SharedWeights w{prm + Mlp::offset};
  for (int row = 0; row < H; ++row) {
    for (int col = 0; col < W; ++col) {
      const sdf3d::Pixel px = sdf3d::render_neural_pixel<Cfg, Scene, Mlp>(
          uni, prm + Scene::analytic_offset, w, row, col, H, W);
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
