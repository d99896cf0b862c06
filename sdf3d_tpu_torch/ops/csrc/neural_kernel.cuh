// Per-ray body of the neural-scene forward render: ray generation -> primary
// march -> normals -> soft shadow -> AO -> Blinn-Phong/Lambert shading, with
// the distance min(analytic(p), mlp(p)) (or mlp(p) alone).
//
// It computes what sdf3d_tpu/ops/neural_kernel.py::_neural_tile_kernel
// computes, one ray per call, with real per-ray loops and breaks in place of
// that kernel's f32 lane masks and whole-block convergence checks.  Where
// that kernel differs from the analytic one, this follows it: the shadow is
// marched for every ray (no N.I > 0 gate) in the un-squared Quilez form, and
// the march always uses the point form.  Ray generation, normals and shading
// are the render kernel's helpers (render_kernel.cuh).
//
// The MLP is evaluated in the thread's own body, in full float32: the first
// layer into a register vector h[H], each middle layer through a second
// one, and the last hidden layer fused with the H -> 1 output, so a depth-3
// MLP holds one vector (none above hidden 128: mlp_chunked).  H is a
// compile-time constant, so the loops over the register vector unroll.
// Weights are read through a loader `w` (shared memory or __ldg from global
// memory, neural_kernel.cu).
//
// __host__ __device__ like render_kernel.cuh: a C++ compiler builds the same
// text for the CPU tests.
#pragma once

#include "render_kernel.cuh"

#ifdef __CUDACC__
#define SDF3D_HD_NOINLINE __host__ __device__ __noinline__
#define SDF3D_UNROLL _Pragma("unroll")
#define SDF3D_NO_UNROLL _Pragma("unroll 1")
#else
#define SDF3D_HD_NOINLINE
#define SDF3D_UNROLL
#define SDF3D_NO_UNROLL
#endif

namespace sdf3d {

// softplus(beta*x)/beta with softplus(z) = max(z, 0) + log1p(exp(-|z|)),
// JAX's logaddexp(z, 0); expf and log1pf are the accurate library calls.
// The division by beta is a multiply by inv_beta = 1/beta, each rounded to
// float32: within an ulp of the quotient, where an IEEE division per unit
// took about a third of the kernel's time at hidden 64.
SDF3D_HD float softplus_beta(float beta, float inv_beta, float x) {
  const float z = beta * x;
  return (fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)))) * inv_beta;
}

// Weights in shared memory (or host memory in the CPU build).  The block
// starts 16-byte aligned.
struct SharedWeights {
  const float* w;
  SDF3D_HD float operator[](int i) const { return w[i]; }
  // w[i .. i+3], i a multiple of 4: one 16-byte load.
  SDF3D_HD void quad(int i, float* q) const {
#ifdef __CUDA_ARCH__
    const float4 v = *reinterpret_cast<const float4*>(w + i);
    q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
#else
    for (int t = 0; t < 4; ++t) q[t] = w[i + t];
#endif
  }
};

// Weights read from global memory through the read-only data cache; 16-byte
// loads when the block starts 16-byte aligned.
template <bool Aligned>
struct GlobalWeights {
  const float* w;
  SDF3D_HD float operator[](int i) const {
#ifdef __CUDA_ARCH__
    return __ldg(w + i);
#else
    return w[i];
#endif
  }
  SDF3D_HD void quad(int i, float* q) const {
#ifdef __CUDA_ARCH__
    if constexpr (Aligned) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(w + i));
      q[0] = v.x; q[1] = v.y; q[2] = v.z; q[3] = v.w;
      return;
    }
#endif
    for (int t = 0; t < 4; ++t) q[t] = (*this)[i + t];
  }
};

// The layers take T = 4 neighbouring outputs at a time where H allows: one
// 16-byte load of a weight row serves four sums.  Every output's sum still
// runs over k in order, so T changes no rounding.
template <int H>
constexpr int tile_width() { return H % 4 == 0 ? 4 : 1; }

// w[i .. i+T-1] into q.
template <int T, class Wt>
SDF3D_HD void load_run(const Wt& w, int i, float* q) {
  if constexpr (T == 4) {
    w.quad(i, q);
  } else {
    q[0] = w[i];
  }
}

// Layer 0, 3 -> H: h = sigma(p W0 + b0), W0 row-major (3, H) at w0.
template <int H, class Wt>
SDF3D_HD void mlp_first(const Wt& w, int w0, int b0, float beta, float px, float py, float pz, float* h) {
  constexpr int T = tile_width<H>();
  const float inv_beta = 1.0f / beta;
  SDF3D_UNROLL
  for (int j = 0; j < H; j += T) {
    float a[T], b[T], c[T], d[T];
    load_run<T>(w, w0 + j, a);
    load_run<T>(w, w0 + H + j, b);
    load_run<T>(w, w0 + 2 * H + j, c);
    load_run<T>(w, b0 + j, d);
    SDF3D_UNROLL
    for (int t = 0; t < T; ++t) {
      h[j + t] = softplus_beta(beta, inv_beta, (((px * a[t]) + (py * b[t])) + (pz * c[t])) + d[t]);
    }
  }
}

// z[t] = sum_k h[k] W[k, j+t] for the T outputs from j, W row-major (H, H) at wi.
template <int H, int T, class Wt>
SDF3D_HD void row_sums(const Wt& w, int wi, int j, const float* h, float* z) {
  SDF3D_UNROLL
  for (int t = 0; t < T; ++t) z[t] = 0.0f;
  SDF3D_UNROLL
  for (int k = 0; k < H; ++k) {
    float q[T];
    load_run<T>(w, wi + k * H + j, q);
    SDF3D_UNROLL
    for (int t = 0; t < T; ++t) z[t] = z[t] + (h[k] * q[t]);
  }
}

// A middle layer, H -> H, in place: h = sigma(h W + b).
template <int H, class Wt>
SDF3D_HD void mlp_hidden(const Wt& w, int wi, int bi, float beta, float* h) {
  constexpr int T = tile_width<H>();
  const float inv_beta = 1.0f / beta;
  float g[H];
  SDF3D_UNROLL
  for (int j = 0; j < H; j += T) {
    float z[T], b[T];
    row_sums<H, T>(w, wi, j, h, z);
    load_run<T>(w, bi + j, b);
    SDF3D_UNROLL
    for (int t = 0; t < T; ++t) g[j + t] = softplus_beta(beta, inv_beta, z[t] + b[t]);
  }
  SDF3D_UNROLL
  for (int j = 0; j < H; ++j) h[j] = g[j];
}

// The last hidden layer fused with the output: sum_j sigma((h W)_j + b_j) wo_j + bo.
template <int H, class Wt>
SDF3D_HD float mlp_last(const Wt& w, int wi, int bi, int wo, int bo, float beta, const float* h) {
  constexpr int T = tile_width<H>();
  const float inv_beta = 1.0f / beta;
  float acc = 0.0f;
  SDF3D_NO_UNROLL
  for (int j = 0; j < H; j += T) {
    float z[T], b[T], o[T];
    row_sums<H, T>(w, wi, j, h, z);
    load_run<T>(w, bi + j, b);
    load_run<T>(w, wo + j, o);
    SDF3D_UNROLL
    for (int t = 0; t < T; ++t) acc = acc + (softplus_beta(beta, inv_beta, z[t] + b[t]) * o[t]);
  }
  return acc + w[bo];
}

// Depth 3 at a width whose activation vector does not fit the registers:
// the hidden layer's outputs C at a time, each chunk recomputing the first
// layer's activations one by one (H softplus more per chunk, no vector of
// H).  The same sums as mlp_first + mlp_last, in the same order.
template <int H, int C, class Wt>
SDF3D_HD float mlp_chunked(const Wt& w, int w0, int b0, int w1, int b1, int wo, int bo, float beta, float px,
                           float py, float pz) {
  constexpr int T = tile_width<H>();
  const float inv_beta = 1.0f / beta;
  static_assert(H % C == 0 && C % T == 0, "chunks must tile the width");
  float acc = 0.0f;
  SDF3D_NO_UNROLL
  for (int j = 0; j < H; j += C) {
    float z[C];
    SDF3D_UNROLL
    for (int c = 0; c < C; ++c) z[c] = 0.0f;
    SDF3D_NO_UNROLL
    for (int k = 0; k < H; ++k) {
      const float zk = (((px * w[w0 + k]) + (py * w[w0 + H + k])) + (pz * w[w0 + 2 * H + k])) + w[b0 + k];
      const float hk = softplus_beta(beta, inv_beta, zk);
      SDF3D_UNROLL
      for (int c = 0; c < C; c += T) {
        float q[T];
        load_run<T>(w, w1 + k * H + j + c, q);
        SDF3D_UNROLL
        for (int t = 0; t < T; ++t) z[c + t] = z[c + t] + (hk * q[t]);
      }
    }
    SDF3D_UNROLL
    for (int c = 0; c < C; c += T) {
      float b[T], o[T];
      load_run<T>(w, b1 + j + c, b);
      load_run<T>(w, wo + j + c, o);
      SDF3D_UNROLL
      for (int t = 0; t < T; ++t) acc = acc + (softplus_beta(beta, inv_beta, z[c + t] + b[t]) * o[t]);
    }
  }
  return acc + w[bo];
}

// Two layers, 3 -> H -> 1: the first fused with the output.
template <int H, class Wt>
SDF3D_HD float mlp_single(const Wt& w, int w0, int b0, int wo, int bo, float beta, float px, float py, float pz) {
  constexpr int T = tile_width<H>();
  const float inv_beta = 1.0f / beta;
  float acc = 0.0f;
  SDF3D_NO_UNROLL
  for (int j = 0; j < H; j += T) {
    float a[T], b[T], c[T], d[T], o[T];
    load_run<T>(w, w0 + j, a);
    load_run<T>(w, w0 + H + j, b);
    load_run<T>(w, w0 + 2 * H + j, c);
    load_run<T>(w, b0 + j, d);
    load_run<T>(w, wo + j, o);
    SDF3D_UNROLL
    for (int t = 0; t < T; ++t) {
      acc = acc + (softplus_beta(beta, inv_beta, (((px * a[t]) + (py * b[t])) + (pz * c[t])) + d[t]) * o[t]);
    }
  }
  return acc + w[bo];
}

// The scene's distance: min(analytic(p), mlp(p)), or mlp(p) alone.
template <class Scene, class Mlp, class Wt>
struct NeuralPoint {
  const float* pa;  // the analytic subtree's parameters
  Wt w;             // the MLP's block
  float beta;
  SDF3D_HD float operator()(float x, float y, float z) const {
    const float m = Mlp::eval(w, beta, x, y, z);
    if constexpr (Scene::has_analytic) {
      return fminf(Scene::sdf(x, y, z, pa), m);
    } else {
      return m;
    }
  }
};

// The neural kernel's soft shadow (neural_kernel.py:213-245): the
// un-squared Quilez form sh = min(sh, k*sqrt(d2)/denom), prev = +inf, the
// first step's intersection term 0, stop once sh < epsilon.
template <class Cfg, class Ev>
SDF3D_HD float march_shadow_neural(const Ev& ev, float k) {
  float dist = 0.0f, prev = INFINITY, sh = 1.0f;
  for (int i = 0; i < Cfg::shadow_steps; ++i) {
    const float s = ev.eval(dist);
    const float inter = i == 0 ? 0.0f : (s * s) / (2.0f * (prev == 0.0f ? 1e-30f : prev));
    const float d2 = (s * s) - (inter * inter);
    const float denom = dist - inter;
    const bool valid = (denom > 0.0f) && (d2 >= 0.0f);
    const float atten = valid ? ((k * sqrtf(fmaxf(d2, 0.0f))) / denom) : 1e30f;
    sh = fminf(sh, atten);
    dist = dist + s;
    prev = s;
    if (dist > Cfg::max_distance || sh < Cfg::epsilon) break;
  }
  return fminf(fmaxf(sh, 0.0f), 1.0f);
}

template <class Cfg, class Scene, class Mlp, class Wt>
SDF3D_HD Pixel render_neural_pixel(const float* u, const float* pa, const Wt& w, int row, int col, int H, int W) {
  float dx, dy, dz;
  ray_direction<Cfg>(u, u[U_ROW0] + static_cast<float>(row), static_cast<float>(col), H, W, dx, dy, dz);
  const float ox = u[U_CAM], oy = u[U_CAM + 1], oz = u[U_CAM + 2];
  const NeuralPoint<Scene, Mlp, Wt> f{pa, w, w[Mlp::beta]};

  // ---- primary march (point form) ----
  const float t = march_primary<Cfg>(PointRay<NeuralPoint<Scene, Mlp, Wt>>{f, ox, oy, oz, dx, dy, dz});
  const float hx = ox + (t * dx), hy = oy + (t * dy), hz = oz + (t * dz);

  // ---- normals, light direction ----
  float nx, ny, nz, ix, iy, iz;
  estimate_normal<Cfg>(f, hx, hy, hz, nx, ny, nz);
  light_direction(u, hx, hy, hz, ix, iy, iz);

  // ---- soft shadow, for every ray ----
  float shadow = 1.0f;
  if constexpr (Cfg::shadow_enabled) {
    const float off = 2.0f * Cfg::epsilon;
    const float sox = hx + (off * nx), soy = hy + (off * ny), soz = hz + (off * nz);
    shadow = march_shadow_neural<Cfg>(PointRay<NeuralPoint<Scene, Mlp, Wt>>{f, sox, soy, soz, ix, iy, iz}, u[U_K]);
  }

  // ---- ambient occlusion, shading ----
  float ao = 1.0f;
  if constexpr (Cfg::ao_enabled) ao = Scene::ao(f, hx, hy, hz, nx, ny, nz);
  return shade_pixel<Cfg>(u, ox, oy, oz, t, hx, hy, hz, nx, ny, nz, ix, iy, iz, shadow, ao);
}

}  // namespace sdf3d
