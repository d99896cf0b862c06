// Render backward for Hopper (sm_90a): the gradient of any loss of the
// rendered image with respect to the scene parameters and, where the caller
// asks for it, the 30 uniforms, from the forward's t/shadow/ao planes and
// the planar RGB cotangent.
//
// Replaces sdf3d_tpu/ops/render_bwd_kernel.py::_bwd_tile_kernel (the
// Pallas kernel launched by render_kernel_backward).  One thread per pixel
// in Cfg::block_w x Cfg::block_h blocks: shade_vjp_planes (the pixel's
// primal rebuilt from the planes, then its reverse pass) seeded with the
// pixel's cotangent.  Two instantiations of one kernel function, chosen at
// launch: WRT_U takes dP and dU (P + 30 columns), !WRT_U dP alone (P
// columns; ray generation's reverse and the dU updates compile away), the
// path of a caller whose uniforms need no gradient (autograd's
// needs_input_grad, the multiscale fit).  A pixel's dP has the same
// arithmetic in both.  Each block sums its threads' columns in a fixed
// order (block_sum_store) into one partial row, stored by column; the same
// C call then launches sdf3d_column_total_kernel (column_total.cuh), which
// sums the rows in float64 in an order fixed by row and thread index.  No
// atomics, no sum on the host: deterministic.  Threads outside the image
// add zeros.
//
// What bounds it: the reverse pass (about ten distance evaluations and the
// shading algebra per pixel, FP32/SFU issue) and the latency of its
// dependent chains, which only resident warps hide.  The uniforms and
// parameters are read from shared memory, loaded once a block, so a thread
// holds only its accumulators and the pass's values; with the register cap
// below (kMinBlocks) more blocks fit an SM.  Memory: six planes read, 24 B
// per pixel (50 MB at 1920x1080, 15 us at 3.35 TB/s), and one partial row
// a block.
#include "column_total.cuh"
#include "sdf3d_scene.cuh"

namespace {
constexpr int kP = Scene::n_params;
constexpr int kNT = Cfg::block_w * Cfg::block_h;  // threads a block

// A pixel's columns: dP, then dU with the uniforms' gradient.
template <bool WRT_U>
constexpr int kCols = kP + (WRT_U ? sdf3d::N_UNIFORMS : 0);

// Adds pixel (row, col)'s dP (and dU) to acc.
template <bool WRT_U>
SDF3D_HD void bwd_pixel(const float* u, const float* p, const float* gr, const float* gg, const float* gb,
                        const float* t, const float* sh, const float* ao, int row, int col, int H, int W,
                        float* acc) {
  const size_t i = static_cast<size_t>(row) * W + col;
  sdf3d::shade_vjp_planes<Cfg, Scene, WRT_U>(u, p, sdf3d::abs_row<Cfg>(u, row), static_cast<float>(col), H, W,
                                             t[i], sh[i], ao[i], gr[i], gg[i], gb[i], acc,
                                             WRT_U ? acc + kP : nullptr);
}
}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {
// The blocks of kNT threads an SM must hold (__launch_bounds__' second
// argument; ptxas caps the registers to fit, spilling what does not).  The
// parameters' form holds about 93 registers unforced (2 blocks): 4 blocks
// (64 registers, a few values spilled) took it from 0.126 to 0.109 ms at
// 1080p on an NVIDIA H100 80GB HBM3 at 700 W; 3 did as well, 5 worse.  The
// uniforms' form holds its P + 30 accumulators: at 3 or more blocks its
// spills cost more than the warps gain, so it keeps 2 (127 registers, none
// spilled; PERF.md).  A large reverse pass asks fewer (sdf3d::reverse_blocks
// from Scene::bwd_values): on the flagship 2 blocks took the parameters'
// form from 1.17 to 0.50 ms and 1 block the uniforms' from 0.68 to 0.60
// (PERF.md).
template <bool WRT_U>
constexpr int kMinBlocks = WRT_U ? sdf3d::reverse_blocks(2, Scene::bwd_values, sdf3d::kLargeReverseValues)
                                 : sdf3d::reverse_blocks(4, Scene::bwd_values, sdf3d::kLargeReverseValuesK5);

template <bool WRT_U>
__global__ void __launch_bounds__(kNT, kMinBlocks<WRT_U>)
sdf3d_render_bwd_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                        const float* __restrict__ gr, const float* __restrict__ gg,
                        const float* __restrict__ gb, const float* __restrict__ t,
                        const float* __restrict__ sh, const float* __restrict__ ao,
                        float* __restrict__ partials, int H, int W) {
  __shared__ float inputs[sdf3d::N_UNIFORMS + kP];
  for (int k = threadIdx.y * blockDim.x + threadIdx.x; k < sdf3d::N_UNIFORMS + kP; k += kNT)
    inputs[k] = k < sdf3d::N_UNIFORMS ? __ldg(uni + k) : __ldg(prm + (k - sdf3d::N_UNIFORMS));
  __syncthreads();
  constexpr int G = kCols<WRT_U>;
  float acc[G];
#pragma unroll
  for (int k = 0; k < G; ++k) acc[k] = 0.0f;
  const int col = blockIdx.x * Cfg::block_w + threadIdx.x;
  const int row = blockIdx.y * Cfg::block_h + threadIdx.y;
  if (row < H && col < W)
    bwd_pixel<WRT_U>(inputs, inputs + sdf3d::N_UNIFORMS, gr, gg, gb, t, sh, ao, row, col, H, W, acc);
  sdf3d::block_sum_store<G, kNT>(acc, partials + blockIdx.y * gridDim.x + blockIdx.x,
                                 sdf3d::padded_rows(gridDim.x * gridDim.y));
}

template <bool WRT_U>
int launch(const float* uni, const float* prm, const float* gr, const float* gg, const float* gb, const float* t,
           const float* sh, const float* ao, float* partials, double* totals, int H, int W, cudaStream_t s) {
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((W + Cfg::block_w - 1) / Cfg::block_w, (H + Cfg::block_h - 1) / Cfg::block_h);
  sdf3d_render_bwd_kernel<WRT_U><<<grid, block, 0, s>>>(uni, prm, gr, gg, gb, t, sh, ao, partials, H, W);
  return sdf3d::launch_column_total<kCols<WRT_U>>(partials, grid.x * grid.y, totals, s);
}
}  // namespace

// partials: the n_blocks partial rows by column, (G, padded_rows(n_blocks))
// float32, n_blocks = ceil(W/block_w) * ceil(H/block_h); totals: (G,)
// float64; G = P + 30 with wrt_uniforms, else P.  Launches the backward
// and its total on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sdf3d_render_bwd(const float* uni, const float* prm, const float* gr, const float* gg,
                                const float* gb, const float* t, const float* sh, const float* ao,
                                float* partials, double* totals, int H, int W, int wrt_uniforms, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wrt_uniforms ? launch<true>(uni, prm, gr, gg, gb, t, sh, ao, partials, totals, H, W, s)
                      : launch<false>(uni, prm, gr, gg, gb, t, sh, ao, partials, totals, H, W, s);
}

#else  // A C++ compiler: the same blocks, rows and total, one after another.

namespace {
template <bool WRT_U>
void run_grid(const float* uni, const float* prm, const float* gr, const float* gg, const float* gb,
              const float* t, const float* sh, const float* ao, float* partials, double* totals, int H, int W) {
  constexpr int G = kCols<WRT_U>;
  const int gx = (W + Cfg::block_w - 1) / Cfg::block_w, gy = (H + Cfg::block_h - 1) / Cfg::block_h;
  float v[kNT][G];
  for (int by = 0; by < gy; ++by)
    for (int bx = 0; bx < gx; ++bx) {
      for (int ty = 0; ty < Cfg::block_h; ++ty)
        for (int tx = 0; tx < Cfg::block_w; ++tx) {
          float* acc = v[ty * Cfg::block_w + tx];
          for (int k = 0; k < G; ++k) acc[k] = 0.0f;
          const int row = by * Cfg::block_h + ty, col = bx * Cfg::block_w + tx;
          if (row < H && col < W) bwd_pixel<WRT_U>(uni, prm, gr, gg, gb, t, sh, ao, row, col, H, W, acc);
        }
      sdf3d::block_sum_host<G, kNT>(v, partials + (static_cast<size_t>(by) * gx + bx) * G);
    }
  sdf3d::column_total_host<G>(partials, gx * gy, totals);
}
}  // namespace

// partials: the n_blocks partial rows row by row, (n_blocks, G) (the card
// stores them by column); totals as sdf3d_render_bwd.
extern "C" int sdf3d_render_bwd_host(const float* uni, const float* prm, const float* gr, const float* gg,
                                     const float* gb, const float* t, const float* sh, const float* ao,
                                     float* partials, double* totals, int H, int W, int wrt_uniforms) {
  if (H <= 0 || W <= 0) return 0;
  if (wrt_uniforms) {
    run_grid<true>(uni, prm, gr, gg, gb, t, sh, ao, partials, totals, H, W);
  } else {
    run_grid<false>(uni, prm, gr, gg, gb, t, sh, ao, partials, totals, H, W);
  }
  return 0;
}

#endif
