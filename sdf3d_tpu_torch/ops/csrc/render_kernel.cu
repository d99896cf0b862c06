// Fused forward render kernels for Hopper (sm_90a): K1 over an image (or a
// row slab of one), K2 over a work-list of tiles.
//
// K1 replaces sdf3d_tpu/ops/render_kernel.py::_render_tile_kernel (the
// Pallas kernel launched by _render_kernel_call).  One thread renders one
// pixel; 2-D blocks of Cfg::block_w x Cfg::block_h threads cover a pixel
// tile, so a warp holds neighbouring, coherent rays.  The kernel masks the
// ragged image edge itself and writes exactly rgb (3,H,W) plus the t, shadow
// and ao planes (H,W), float32.  Launch row r is the absolute image row
// abs_row(r) (render_kernel.cuh): row0 + (r / TH)·rowstride + r % TH, so a
// rank of a sharded render launches its contiguous or interleaved rows.
//
// K2 (sdf3d_render_tiles) replaces
// sdf3d_tpu/ops/render_kernel.py::_render_tile_queue_kernel (launched by
// _render_kernel_tiles_call), the per-device program of the tile-queue
// layout (parallel/tile_queue.py).  The TPU kernel walks a 1-D grid over
// the work-list and reads tile q's origin from SMEM tables.  Here the grid
// is (TW/block_w, TH/block_h, T): block z reads its tile's origin
// (trow[z], tcol[z]) itself and renders pixel (trow[z] + r, tcol[z] + c)
// through the same code (one kernel function serves K1 and K2, so a pixel
// gets the same bits from both), into row z·TH + r of the stacks rgb
// (3, T·TH, TW) and t/shadow/ao (T·TH, TW).  NDC comes from the full image
// (H x W are its sizes).  Dummy tiles (row0 == H) are rendered like any
// other and never gathered.  The tiles of a work-list are independent, so
// the blocks run in any order on the 132 SMs.
//
// What bounds both: instruction issue (the warp instructions of its SASS on
// the run's marches over four per clock per SM: chip_smoke.py phase 6,
// issue_floor).  Each march step depends on the one before; more resident
// warps (a register cap for 6 or 8 blocks an SM) and the inputs in shared
// memory gained nothing (PERF.md).  So a step issues as few instructions as
// keep every bit: a hard union branches past an operand that cannot win
// (the generated Scene::Ray, ops/scene_program.py::_ray_union: a warp whose
// 32 rays all skip issues none of it), the shadow march past a division
// that cannot lower its factor (render_kernel.cuh::march_shadow), and a
// short step is unrolled into two copies a trip (Scene::Ray::unroll).  On
// the reference scene at 1080p on an NVIDIA H100 80GB HBM3 at 700 W, a
// primary step went from 22 SASS instructions (an IEEE sqrtf) to 13.5 as
// issued (89% of its warp-steps skip the sphere) and a shadow step from 61
// (a sqrtf and two IEEE divisions) to about 58; K1 from 0.146 to 0.122 ms
// (PERF.md §6).  The NDC aspect ratio's double division, per pixel, stays:
// once a launch it gained 1.7% (under the 2% a lever must win).
// Not memory: they read 30 uniforms
// and the scene parameters once per thread (broadcast, cached), K2 two
// table entries per block, and write 24 B per pixel (about 50 MB at
// 1920x1080, 15 us at 3.35 TB/s).  wgmma and TMA have no role in them.
//
// Built per scene structure: the generated header sdf3d_scene.cuh
// (ops/scene_program.py) supplies struct Scene (distance code) and struct
// Cfg (static settings, the tile shape included, as constexpr).  Scene
// parameters, uniforms and tile origins are run-time device pointers, so
// neither a parameter change nor a new plan rebuilds.
#include "render_kernel.cuh"
#include "sdf3d_scene.cuh"

namespace {
// Writes one pixel into plane position i of planes of `plane` values.
SDF3D_HD void store_pixel(const sdf3d::Pixel& px, size_t i, size_t plane, float* rgb, float* t, float* sh,
                          float* ao) {
  rgb[i] = px.r;
  rgb[plane + i] = px.g;
  rgb[2 * plane + i] = px.b;
  t[i] = px.t;
  sh[i] = px.shadow;
  ao[i] = px.ao;
}
}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

// Uniforms and parameters into registers once (the SMEM reads of the TPU
// kernel); every index is a compile-time constant.
constexpr int kParamSlots = Scene::n_params > 0 ? Scene::n_params : 1;

__device__ __forceinline__ void load_inputs(const float* __restrict__ uni, const float* __restrict__ prm,
                                            float (&u)[sdf3d::N_UNIFORMS], float (&p)[kParamSlots]) {
#pragma unroll
  for (int k = 0; k < sdf3d::N_UNIFORMS; ++k) u[k] = __ldg(uni + k);
#pragma unroll
  for (int k = 0; k < Scene::n_params; ++k) p[k] = __ldg(prm + k);
}

// K1 and K2 are one kernel: trow == nullptr launches K1 (pixel (y, x) of
// the grid, absolute row abs_row(y)), else K2 (pixel (trow[z] + y,
// tcol[z] + x) of tile z).  Both paths meet in one call of render_pixel, so
// the compiled per-pixel arithmetic is one instruction sequence: a pixel
// renders to the same bits whichever layout launched it.  Only the thread's
// coordinates stay live across the call; the output offset is worked out
// after it.
__global__ void __launch_bounds__(Cfg::block_w * Cfg::block_h)
sdf3d_render_fwd_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                        const int* __restrict__ trow, const int* __restrict__ tcol,
                        float* __restrict__ rgb, float* __restrict__ t_out,
                        float* __restrict__ sh_out, float* __restrict__ ao_out, int H, int W) {
  const int x = blockIdx.x * Cfg::block_w + threadIdx.x;
  const int y = blockIdx.y * Cfg::block_h + threadIdx.y;
  const int z = blockIdx.z;
  const bool tiles = trow != nullptr;
  if (tiles ? (y >= Cfg::tile_h || x >= Cfg::tile_w) : (y >= H || x >= W)) return;
  const float rows = tiles ? static_cast<float>(__ldg(trow + z) + y) : sdf3d::abs_row<Cfg>(uni, y);
  const float cols = static_cast<float>(tiles ? __ldg(tcol + z) + x : x);
  float u[sdf3d::N_UNIFORMS], p[kParamSlots];
  load_inputs(uni, prm, u, p);
  const sdf3d::Pixel px = sdf3d::render_pixel<Cfg, Scene>(u, p, rows, cols, H, W);
  if (tiles) {
    store_pixel(px, (static_cast<size_t>(z) * Cfg::tile_h + y) * Cfg::tile_w + x,
                static_cast<size_t>(gridDim.z) * Cfg::tile_h * Cfg::tile_w, rgb, t_out, sh_out, ao_out);
  } else {
    store_pixel(px, static_cast<size_t>(y) * W + x, static_cast<size_t>(H) * W, rgb, t_out, sh_out, ao_out);
  }
}

// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sdf3d_render_fwd(const float* uni, const float* prm, float* rgb, float* t,
                                float* sh, float* ao, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((W + Cfg::block_w - 1) / Cfg::block_w, (H + Cfg::block_h - 1) / Cfg::block_h);
  sdf3d_render_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      uni, prm, nullptr, nullptr, rgb, t, sh, ao, H, W);
  return static_cast<int>(cudaGetLastError());
}

// K2 over T tiles (int32 origin tables, device pointers) of an H x W image;
// stacks of T·TH rows.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int sdf3d_render_tiles(const float* uni, const float* prm, const int* trow, const int* tcol,
                                  float* rgb, float* t, float* sh, float* ao, int T, int H, int W, void* stream) {
  if (T <= 0) return 0;
  const dim3 block(Cfg::block_w, Cfg::block_h);
  const dim3 grid((Cfg::tile_w + Cfg::block_w - 1) / Cfg::block_w, (Cfg::tile_h + Cfg::block_h - 1) / Cfg::block_h,
                  T);
  sdf3d_render_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      uni, prm, trow, tcol, rgb, t, sh, ao, H, W);
  return static_cast<int>(cudaGetLastError());
}

#else  // A C++ compiler: the same per-pixel bodies on the CPU.

extern "C" int sdf3d_render_fwd_host(const float* uni, const float* prm, float* rgb, float* t,
                                     float* sh, float* ao, int H, int W) {
  const size_t plane = static_cast<size_t>(H) * W;
  for (int row = 0; row < H; ++row) {
    for (int col = 0; col < W; ++col) {
      const sdf3d::Pixel px = sdf3d::render_pixel<Cfg, Scene>(uni, prm, sdf3d::abs_row<Cfg>(uni, row),
                                                              static_cast<float>(col), H, W);
      store_pixel(px, static_cast<size_t>(row) * W + col, plane, rgb, t, sh, ao);
    }
  }
  return 0;
}

extern "C" int sdf3d_render_tiles_host(const float* uni, const float* prm, const int* trow, const int* tcol,
                                       float* rgb, float* t, float* sh, float* ao, int T, int H, int W) {
  const size_t plane = static_cast<size_t>(T) * Cfg::tile_h * Cfg::tile_w;
  for (int z = 0; z < T; ++z) {
    for (int r = 0; r < Cfg::tile_h; ++r) {
      for (int c = 0; c < Cfg::tile_w; ++c) {
        const sdf3d::Pixel px = sdf3d::render_pixel<Cfg, Scene>(
            uni, prm, static_cast<float>(trow[z] + r), static_cast<float>(tcol[z] + c), H, W);
        store_pixel(px, (static_cast<size_t>(z) * Cfg::tile_h + r) * Cfg::tile_w + c, plane, rgb, t, sh, ao);
      }
    }
  }
  return 0;
}

#endif
