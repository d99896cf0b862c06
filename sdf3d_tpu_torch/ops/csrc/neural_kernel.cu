// Forward render kernel of neural-SDF scenes for Hopper (sm_90a): K6.
//
// Replaces sdf3d_tpu/ops/neural_kernel.py::_neural_tile_kernel (the Pallas
// kernel launched by _neural_kernel_call), which keeps a block of rays as
// (N, 8) matrices so that each MLP evaluation is a chain of matmuls on the
// TPU's matrix unit.  Here too the MLP runs as matrix products, on the
// tensor cores:
//
// - A CUDA block holds Cfg::block_rays ray slots, one thread each.  Every
//   iteration, every slot names the next point its ray needs a distance at
//   (neural_kernel.cuh, slot_point), each warp evaluates the MLP on its 32
//   points as a tile (mlp_warp), and every slot takes its distance
//   (slot_take; the analytic subtree's min per slot, in scalar code).  A
//   slot whose ray has shaded and written its pixel takes the next
//   unstarted ray from a counter the wrapper zeroes (one atomicAdd per
//   warp), so the tiles stay full until the image runs out, whatever the
//   rays' step counts.  Blocks are persistent: as many as fit the card.
// - Each H x H layer is (32 x K) . (K x H) on mma.sync m16n8k8 TF32 in
//   three passes, a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, accumulated in
//   float32 (split TF32: float32's accuracy; one TF32 pass keeps about three
//   digits, too few for a distance field).  The first layer (3 -> H) is
//   computed in scalar float32 straight into the A fragments, the softplus
//   runs on the accumulator fragments in registers, and the output layer
//   (H -> 1) is a dot product on them with a reduction over the four lanes
//   that share a row.  A layer's C fragment becomes the next layer's A
//   fragment in place: the next product takes its K index in the order the
//   fragments hold it (the B rows are read in that order), so no shuffle.
// - The weights are copied once per block into shared memory: the small
//   blocks with cp.async, the H x H matrices split into hi and lo, laid out
//   so that a lane's B fragments are one conflict-free 16-byte load.  When
//   they do not fit (hidden 256: 528 KB split), the float32 rows stream from
//   L2 with cp.async through a double-buffered ring of row panels that the
//   whole block consumes together (the slot loop is then block-wide), split
//   as each fragment is loaded.
// - H is padded to a multiple of 8 with zero weights and zero biases.  A
//   padded unit's softplus is ln 2 / beta, not 0: it is harmless only
//   because the next layer's padded rows (and the output layer's padded
//   weights) are exactly zero.
//
// What bounds it: operations.  At hidden 64 the least time is the
// special-function units' (two per softplus: expf, log1pf), the tensor
// cores' split products close behind; above, the products'.  On the H100
// the softplus (on the FP32 and special-function pipes) and the mma.sync
// products take their times one after the other rather than overlapping.
// No fast-math intrinsics.
//
// A pixel's bits depend only on its own sequence of points, never on its
// slot, its block or the order in which rays are taken: each row of an mma
// product is a function of that row alone.
//
// Built per scene structure: the generated header sdf3d_scene.cuh
// (ops/scene_program.py::cuda_neural_source) supplies struct Cfg (static
// settings), struct Scene (the analytic subtree's point form, the AO taps)
// and struct Mlp (widths, depth, parameter offsets, shared-memory layout,
// resident or streamed weights).  All parameter values, weights included,
// are one run-time device vector, so new weights never rebuild.
#include "neural_kernel.cuh"
#include "sdf3d_scene.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

using namespace sdf3d;

constexpr int HP = Mlp::hp;        // the padded width, a multiple of 8
constexpr int S = Mlp::stride;     // a weight row's stride in shared memory
constexpr int KT = HP / 8;         // k-tiles of a layer (and n-tiles of its output)
constexpr int KC = Mlp::panel_rows;  // rows of a streamed panel
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_round(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_round(x - h));
}

// c += a . b on one m16n8k8 TF32 tile (not volatile: the compiler may
// interleave independent products).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(N)); }

// rows x Mlp::hidden floats of global memory (row stride hidden) into
// shared memory at row stride S, by the whole block; 16-byte copies where
// the rows allow them.
__device__ void copy_rows(float* dst, const float* src, int rows) {
  constexpr int H = Mlp::hidden;
  if constexpr (Mlp::vec4) {
    constexpr int Q = H / 4;
    for (int e = threadIdx.x; e < rows * Q; e += blockDim.x) {
      const int r = e / Q, c = (e - r * Q) * 4;
      cp_async16(dst + r * S + c, src + r * H + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * H; e += blockDim.x) {
      const int r = e / H, c = e - r * H;
      cp_async4(dst + r * S + c, src + r * H + c);
    }
  }
}

// The streamed H x H matrices: a ring of two panels of KC rows in shared
// memory, filled from global memory (L2) in the order the products read
// them, the next panel's copy in flight while the block reads this one.
// Every thread of the block calls next() at the same points.
struct PanelRing {
  float* buf;        // 2 * KC * S floats
  const float* mlp;  // the MLP's block of the parameter vector
  unsigned n;        // panels handed out so far

  static constexpr int CHUNKS = HP / KC;
  static constexpr int PER_CALL = Mlp::layers > 2 ? 2 * (Mlp::layers - 2) * CHUNKS : 1;

  __device__ void issue(unsigned k) {
    const int idx = static_cast<int>(k % PER_CALL);
    const int layer = (idx / CHUNKS) % (Mlp::layers > 2 ? Mlp::layers - 2 : 1), chunk = idx % CHUNKS;
    constexpr int H = Mlp::hidden;
    const int rows = min(KC, H - chunk * KC);
    float* dst = buf + (k & 1) * KC * S;
    copy_rows(dst, mlp + Mlp::w1 + layer * H * H + chunk * KC * H, rows);
    for (int e = threadIdx.x; e < (KC - rows) * S; e += blockDim.x) dst[rows * S + e] = 0.0f;  // padded rows
    cp_async_commit();
  }

  __device__ const float* next() {
    __syncthreads();  // every warp is done with the panel whose buffer the next copy fills
    issue(n + 1);
    cp_async_wait<1>();
    __syncthreads();  // panel n has landed for every thread's copies
    return buf + ((n++) & 1) * KC * S;
  }
};

// acc += A . W for one k-tile: A's hi and lo fragments of a 16-row m-tile,
// W's 8 rows at wk, all KT n-tiles.  Resident weights are stored split, a
// quad {hi(W[2p][n]), hi(W[2p+1][n]), lo(W[2p][n]), lo(W[2p+1][n])} per
// pair of rows p and column n at row stride QS quads: a lane's B fragments
// (rows 2tq and 2tq + 1, column g) are one 16-byte load.  A streamed panel
// holds float32 rows at stride S, split as they are loaded.  The B
// fragments of NG n-tiles at a time are taken first, then the three passes
// each run over those n-tiles, so that products issued back to back go to
// different accumulators.
constexpr int NG = KT < 8 ? KT : 8;
constexpr int QS = Mlp::qstride;

__device__ __forceinline__ void ktile_product(float (&acc)[KT][4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                              const float* wk, int tq, int g) {
#pragma unroll
  for (int n0 = 0; n0 < KT; n0 += NG) {
    uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      if constexpr (Mlp::resident) {
        const float4 q = *reinterpret_cast<const float4*>(wk + (tq * QS + (n0 + j) * 8 + g) * 4);
        bh[j][0] = __float_as_uint(q.x);
        bh[j][1] = __float_as_uint(q.y);
        bl[j][0] = __float_as_uint(q.z);
        bl[j][1] = __float_as_uint(q.w);
      } else {
        split(wk[(2 * tq) * S + (n0 + j) * 8 + g], bh[j][0], bl[j][0]);
        split(wk[(2 * tq + 1) * S + (n0 + j) * 8 + g], bh[j][1], bl[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) mma_tf32(acc[n0 + j], ah, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NG; ++j) mma_tf32(acc[n0 + j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < NG; ++j) mma_tf32(acc[n0 + j], al, bh[j][0], bh[j][1]);
  }
}

// The MLP on the 32 points of a warp (lane r holds row r's point), as two
// 16-row m-tiles one after the other; returns the MLP's value at the
// calling lane's point.  `vec` holds W0, the biases, the output layer and
// beta; `mats` the H x H matrices when resident.
__device__ float mlp_warp(const float* vec, const float* mats, PanelRing& ring, float px, float py, float pz) {
  constexpr int L = Mlp::layers;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const float beta = vec[Mlp::sm_beta];
  const float inv_beta = 1.0f / beta;
  const float* w0 = vec + Mlp::sm_w0;
  const float* wo = vec + Mlp::sm_wo;
  float out[4];  // the output of rows g, g + 8, g + 16, g + 24

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    // This m-tile's rows: 16 * mt + g (h = 0) and 16 * mt + g + 8 (h = 1).
    float qx[2], qy[2], qz[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + 8 * h + g;
      qx[h] = __shfl_sync(FULL, px, r);
      qy[h] = __shfl_sync(FULL, py, r);
      qz[h] = __shfl_sync(FULL, pz, r);
    }
    // The first layer's activation of unit u at row h.
    auto first = [&](int h, int u) {
      return softplus_beta(beta, inv_beta,
                           (((qx[h] * w0[u]) + (qy[h] * w0[HP + u])) + (qz[h] * w0[2 * HP + u])) + vec[Mlp::sm_b + u]);
    };
    float part[2] = {0.0f, 0.0f};  // this lane's share of the output sums

    if constexpr (L == 2) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int u = kt * 8 + 2 * tq + j;
#pragma unroll
          for (int h = 0; h < 2; ++h) part[h] = part[h] + (first(h, u) * wo[u]);
        }
      }
    } else {
      // Fragment t: c0 row g unit 8t + 2tq, c1 row g unit + 1, c2 and c3
      // the same units at row g + 8.  As an A fragment of the next product
      // it is (a0, a2, a1, a3): K position tq is unit 2tq, K position
      // tq + 4 unit 2tq + 1, so B's rows are read in that order.
      float act[KT][4];
#pragma unroll
      for (int l = 1; l <= L - 2; ++l) {
        float acc[KT][4];
#pragma unroll
        for (int t = 0; t < KT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
        const float* panel = nullptr;
        // The rows of k-tile kt of W_l (resident, or the panel that holds them).
        auto rows = [&](int kt) {
          if constexpr (Mlp::resident) {
            return mats + ((l - 1) * (HP / 2) + kt * 4) * QS * 4;
          } else {
            if (kt % (KC / 8) == 0) panel = ring.next();
            return panel + (kt % (KC / 8)) * 8 * S;
          }
        };
        if (l == 1) {
          // The first layer's activations straight into the A fragments, one
          // k-tile at a time (a loop, not unrolled: fewer live registers).
#pragma unroll 1
          for (int kt = 0; kt < KT; ++kt) {
            uint32_t ah[4], al[4];
            const int u = kt * 8 + 2 * tq;
            split(first(0, u), ah[0], al[0]);
            split(first(1, u), ah[1], al[1]);
            split(first(0, u + 1), ah[2], al[2]);
            split(first(1, u + 1), ah[3], al[3]);
            ktile_product(acc, ah, al, rows(kt), tq, g);
          }
        } else {
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) {
            uint32_t ah[4], al[4];
            split(act[kt][0], ah[0], al[0]);
            split(act[kt][2], ah[1], al[1]);
            split(act[kt][1], ah[2], al[2]);
            split(act[kt][3], ah[3], al[3]);
            ktile_product(acc, ah, al, rows(kt), tq, g);
          }
        }
        const float* b = vec + Mlp::sm_b + l * HP;
#pragma unroll
        for (int t = 0; t < KT; ++t) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int u = t * 8 + 2 * tq + (c & 1);
            const float a = softplus_beta(beta, inv_beta, acc[t][c] + b[u]);
            if (l < L - 2) {
              act[t][c] = a;
            } else {
              part[c >> 1] = part[c >> 1] + (a * wo[u]);
            }
          }
        }
      }
    }
    // The four lanes of a row group hold its columns; sum them (each lane
    // gets the same bits), then add the output bias.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p = part[h];
      p = p + __shfl_xor_sync(FULL, p, 1);
      p = p + __shfl_xor_sync(FULL, p, 2);
      out[2 * mt + h] = p + vec[Mlp::sm_bo];
    }
  }
  // Row r's value sits in lane 4 * (r % 8), as out[r / 8].
  const int src = 4 * (lane & 7), which = lane >> 3;
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = __shfl_sync(FULL, out[k], src);
    if (which == k) v = x;
  }
  return v;
}

}  // namespace

__global__ void __launch_bounds__(Cfg::block_rays, Mlp::min_blocks)
sdf3d_neural_fwd_kernel(const float* __restrict__ uni, const float* __restrict__ prm,
                        float* __restrict__ rgb, float* __restrict__ t_out,
                        float* __restrict__ sh_out, float* __restrict__ ao_out, int* __restrict__ counter, int H,
                        int W) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int Hd = Mlp::hidden, L = Mlp::layers;
  const float* mlp = prm + Mlp::offset;

  // ---- the block's shared memory: zeros (the padding), then the copies ----
  for (int e = threadIdx.x; e < Mlp::smem_floats; e += blockDim.x) sm[e] = 0.0f;
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * Hd; e += blockDim.x) {
    const int r = e / Hd, c = e - r * Hd;
    cp_async4(sm + Mlp::sm_w0 + r * HP + c, mlp + Mlp::w0 + e);
  }
  for (int e = threadIdx.x; e < (L - 1) * Hd; e += blockDim.x) {
    const int l = e / Hd, c = e - l * Hd;
    cp_async4(sm + Mlp::sm_b + l * HP + c, mlp + Mlp::b0 + e);
  }
  for (int e = threadIdx.x; e < Hd; e += blockDim.x) cp_async4(sm + Mlp::sm_wo + e, mlp + Mlp::wo + e);
  if (threadIdx.x == 0) {
    cp_async4(sm + Mlp::sm_bo, mlp + Mlp::bo);
    cp_async4(sm + Mlp::sm_beta, mlp + Mlp::beta);
  }
  for (int e = threadIdx.x; e < N_UNIFORMS; e += blockDim.x) cp_async4(sm + Mlp::sm_uni + e, uni + e);
  for (int e = threadIdx.x; e < Scene::n_analytic; e += blockDim.x) {
    cp_async4(sm + Mlp::sm_pa + e, prm + Scene::analytic_offset + e);
  }
  cp_async_commit();
  if constexpr (Mlp::resident && L > 2) {  // the H x H matrices, split, in quads (ktile_product)
    for (int e = threadIdx.x; e < (L - 2) * (Hd / 2 + Hd % 2) * Hd; e += blockDim.x) {
      const int l = e / ((Hd / 2 + Hd % 2) * Hd), r = e - l * (Hd / 2 + Hd % 2) * Hd, p = r / Hd, c = r - p * Hd;
      const float* w = mlp + Mlp::w1 + l * Hd * Hd + 2 * p * Hd + c;
      const float w0 = __ldg(w), w1 = 2 * p + 1 < Hd ? __ldg(w + Hd) : 0.0f;
      uint32_t h0, l0, h1, l1;
      split(w0, h0, l0);
      split(w1, h1, l1);
      *reinterpret_cast<float4*>(sm + Mlp::sm_mats + ((l * (HP / 2) + p) * QS + c) * 4) =
          make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0), __uint_as_float(l1));
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  PanelRing ring{sm + Mlp::sm_mats, mlp, 0u};
  if constexpr (!Mlp::resident) ring.issue(0);

  const float* u = sm + Mlp::sm_uni;
  const float* pa = sm + Mlp::sm_pa;
  const int n = H * W, lane = threadIdx.x & 31;
  const size_t plane = static_cast<size_t>(H) * W;
  Slot s;
  s.stage = IDLE;
  bool done = false;  // the image has run out for this slot
  while (true) {
    // Slots without a ray take the next unstarted ones: one atomicAdd on
    // the launch's counter for the warp's takers.
    const unsigned want = __ballot_sync(FULL, s.stage == IDLE && !done);
    if (want) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counter, __popc(want));
      base = __shfl_sync(FULL, base, leader);
      if (want & (1u << lane)) {
        const int pix = base + __popc(want & ((1u << lane) - 1u));
        if (pix < n) {
          slot_start<Cfg, Scene>(s, u, pix, H, W);
        } else {
          done = true;
        }
      }
    }
    const bool active = s.stage != IDLE;
    // Resident weights: each warp runs its own loop.  Streamed panels: the
    // whole block reads each panel, so it runs one loop.
    if constexpr (Mlp::resident) {
      if (!__any_sync(FULL, active)) break;
    } else {
      if (!__syncthreads_or(active)) break;
    }
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (active) slot_point<Cfg, Scene>(s, u, px, py, pz);
    __syncwarp();
    const float m = mlp_warp(sm, sm + Mlp::sm_mats, ring, px, py, pz);
    if (active && slot_take<Cfg, Scene>(s, u, scene_distance<Scene>(pa, px, py, pz, m))) {
      const Pixel q = slot_shade<Cfg, Scene>(s, u);
      const int i = s.pix;
      rgb[i] = q.r;
      rgb[plane + i] = q.g;
      rgb[2 * plane + i] = q.b;
      t_out[i] = q.t;
      sh_out[i] = q.shadow;
      ao_out[i] = q.ao;
      s.stage = IDLE;
    }
    __syncwarp();
  }
  cp_async_wait<0>();  // the ring's last prefetch
}

// Launches on `stream`, allocates nothing, returns the first CUDA error.
// `counter` is one int, zero before the launch: the rays handed out.
extern "C" int sdf3d_neural_fwd(const float* uni, const float* prm, float* rgb, float* t,
                                float* sh, float* ao, int* counter, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  constexpr int smem_bytes = Mlp::smem_floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaSuccess;
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(sdf3d_neural_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sdf3d_neural_fwd_kernel, Cfg::block_rays, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(H) * W;
  const long long want = (n + Cfg::block_rays - 1) / Cfg::block_rays;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(want < fit ? want : fit);
  sdf3d_neural_fwd_kernel<<<grid, Cfg::block_rays, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      uni, prm, rgb, t, sh, ao, counter, H, W);
  return static_cast<int>(cudaGetLastError());
}

#else  // A C++ compiler: the same slots and steps on the CPU, the MLP's products emulated.

#include <vector>

namespace {

using namespace sdf3d;

// The MLP's H x H matrices split once into TF32 hi and lo parts.
struct SplitWeights {
  std::vector<float> hi, lo;
  explicit SplitWeights(const float* w) {
    constexpr int H = Mlp::hidden, n = (Mlp::layers - 2) * H * H;
    hi.resize(n > 0 ? n : 1);
    lo.resize(n > 0 ? n : 1);
    for (int e = 0; e < n; ++e) {
      hi[e] = tf32_round(w[Mlp::w1 + e]);
      lo[e] = tf32_round(w[Mlp::w1 + e] - hi[e]);
    }
  }
};

// The MLP on one point, its H x H products in split TF32 (tf32_product).
float mlp_host(const float* w, const SplitWeights& sw, float px, float py, float pz) {
  constexpr int H = Mlp::hidden, L = Mlp::layers;
  const float beta = w[Mlp::beta], inv_beta = 1.0f / beta;
  float h[H], hh[H], hl[H], z[H];
  for (int j = 0; j < H; ++j) {
    h[j] = softplus_beta(beta, inv_beta,
                         (((px * w[Mlp::w0 + j]) + (py * w[Mlp::w0 + H + j])) + (pz * w[Mlp::w0 + 2 * H + j])) +
                             w[Mlp::b0 + j]);
  }
  for (int l = 1; l <= L - 2; ++l) {
    for (int j = 0; j < H; ++j) {
      hh[j] = tf32_round(h[j]);
      hl[j] = tf32_round(h[j] - hh[j]);
    }
    const size_t off = static_cast<size_t>(l - 1) * H * H;
    tf32_product(hh, hl, sw.hi.data() + off, sw.lo.data() + off, z, 1, H, H, 3);
    for (int j = 0; j < H; ++j) h[j] = softplus_beta(beta, inv_beta, z[j] + w[Mlp::b0 + l * H + j]);
  }
  float acc = 0.0f;
  for (int j = 0; j < H; ++j) acc = acc + (h[j] * w[Mlp::wo + j]);
  return acc + w[Mlp::bo];
}

}  // namespace

// `blocks` blocks of Cfg::block_rays slots (blocks <= 0: one), each slot
// taking the next unstarted ray from one counter when it has none, in slot
// order, as the card's kernel's slots do in an order of their own.
extern "C" int sdf3d_neural_fwd_blocks_host(const float* uni, const float* prm, float* rgb, float* t, float* sh,
                                            float* ao, int H, int W, int blocks) {
  const int M = Cfg::block_rays * (blocks > 0 ? blocks : 1);
  const int n = H * W;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* pa = prm + Scene::analytic_offset;
  const float* mlp = prm + Mlp::offset;
  const SplitWeights sw(mlp);
  std::vector<Slot> slots(M);
  std::vector<float> px(M), py(M), pz(M);
  int counter = 0;
  for (Slot& s : slots) s.stage = IDLE;
  while (true) {
    bool any = false;
    for (int k = 0; k < M; ++k) {
      Slot& s = slots[k];
      if (s.stage == IDLE && counter < n) slot_start<Cfg, Scene>(s, uni, counter++, H, W);
      px[k] = py[k] = pz[k] = 0.0f;
      if (s.stage != IDLE) {
        any = true;
        slot_point<Cfg, Scene>(s, uni, px[k], py[k], pz[k]);
      }
    }
    if (!any) break;
    for (int k = 0; k < M; ++k) {
      Slot& s = slots[k];
      if (s.stage == IDLE) continue;
      const float m = mlp_host(mlp, sw, px[k], py[k], pz[k]);
      if (!slot_take<Cfg, Scene>(s, uni, scene_distance<Scene>(pa, px[k], py[k], pz[k], m))) continue;
      const Pixel q = slot_shade<Cfg, Scene>(s, uni);
      const int i = s.pix;
      rgb[i] = q.r;
      rgb[plane + i] = q.g;
      rgb[2 * plane + i] = q.b;
      t[i] = q.t;
      sh[i] = q.shadow;
      ao[i] = q.ao;
      s.stage = IDLE;
    }
  }
  return 0;
}

extern "C" int sdf3d_neural_fwd_host(const float* uni, const float* prm, float* rgb, float* t, float* sh, float* ao,
                                     int H, int W) {
  return sdf3d_neural_fwd_blocks_host(uni, prm, rgb, t, sh, ao, H, W, 3);
}

// C (m x n) = A (m x k) B (k x n), row-major, in `passes` TF32 passes (3:
// the split product of the MLP's layers, 1: one TF32 pass), for the tests.
extern "C" void sdf3d_tf32_product_host(const float* A, const float* B, float* C, int m, int k, int n, int passes) {
  std::vector<float> ah(A, A + m * k), al(m * k), bh(B, B + k * n), bl(k * n);
  for (int e = 0; e < m * k; ++e) {
    ah[e] = tf32_round(A[e]);
    al[e] = tf32_round(A[e] - ah[e]);
  }
  for (int e = 0; e < k * n; ++e) {
    bh[e] = tf32_round(B[e]);
    bl[e] = tf32_round(B[e] - bh[e]);
  }
  tf32_product(ah.data(), al.data(), bh.data(), bl.data(), C, m, k, n, passes);
}

#endif
