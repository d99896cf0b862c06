// The float64 total of a kernel's partial rows in a fixed order: the second
// kernel of the fit step's C calls (K3, K4, K9; fit_kernel.cu) and of the
// render backward's (K5; render_bwd_kernel.cu).
//
// fixed_order_total: column c of the rows is summed by one block of
// kTotalThreads threads.  Thread j adds rows 4j .. 4j + 3, then
// 4(j + kTotalThreads) .. + 3, and so on, in row order into a float64 sum
// from 0, and the block adds its threads' sums in block_sum_store's order
// (shuffles within a warp, then the warps in order).  The card stores the
// rows by column, each padded to a multiple of 4 rows (16-byte loads); the
// host form reads them row by row.  No atomics: the order is fixed by row
// and thread index, never by arrival (utils/parity.py::fixed_order_total
// gives the same bits in Python).
//
// A launch of several views (the multi-view fit step, K3 with a view axis)
// totals each view's rows alone, in the order above: view v's rows start at
// row v·padded_rows(rows) of each column, and its totals at v·n_totals.
//
// Cols maps the summed columns onto the totals:
//   static constexpr int n_totals;      // the totals' length
//   static int total(int c);            // the total of summed column c
//   static bool zero(int k);            // total k is summed by no column: 0
#pragma once

#include "shade_vjp.cuh"

namespace sdf3d {

constexpr int kTotalThreads = 256;

SDF3D_HD int padded_rows(int rows) { return (rows + 3) & ~3; }

// N summed columns, each its own total.
template <int N>
struct AllColumns {
  static constexpr int n_totals = N;
  SDF3D_HD static constexpr int total(int c) { return c; }
  SDF3D_HD static constexpr bool zero(int) { return false; }
};

#ifdef __CUDACC__
// Block (c, v) sums summed column c of view v's `rows` partial rows (stored
// by column, `ld` floats apart, the views padded_rows(rows) apart) and writes
// its total; block (0, v) writes view v's zeros.
template <class Cols>
__global__ void __launch_bounds__(kTotalThreads)
sdf3d_column_total_kernel(const float* __restrict__ partials, int rows, int ld, double* __restrict__ totals) {
  const int c = blockIdx.x;
  totals += static_cast<size_t>(blockIdx.y) * Cols::n_totals;
  const float4* col = reinterpret_cast<const float4*>(partials + static_cast<size_t>(c) * ld +
                                                      static_cast<size_t>(blockIdx.y) * padded_rows(rows));
  double s[1] = {0.0};
#pragma unroll 4
  for (int m = threadIdx.x; 4 * m < rows; m += kTotalThreads) {
    const float4 x = __ldg(col + m);
    const int r = 4 * m;
    s[0] += static_cast<double>(x.x);
    if (r + 1 < rows) s[0] += static_cast<double>(x.y);
    if (r + 2 < rows) s[0] += static_cast<double>(x.z);
    if (r + 3 < rows) s[0] += static_cast<double>(x.w);
  }
  block_sum_store<1, kTotalThreads, double>(s, totals + Cols::total(c));
  if (c == 0) {
    for (int k = threadIdx.x; k < Cols::n_totals; k += kTotalThreads) {
      if (Cols::zero(k)) totals[k] = 0.0;
    }
  }
}

// The totals of `rows` partial rows of N summed columns (of each of `views`
// views), launched after the kernel that wrote them, on the same stream.
// Returns cudaGetLastError().
template <int N, class Cols = AllColumns<N>>
int launch_column_total(const float* partials, int rows, double* totals, cudaStream_t stream, int views = 1) {
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  sdf3d_column_total_kernel<Cols><<<dim3(N, views), kTotalThreads, 0, stream>>>(partials, rows,
                                                                                views * padded_rows(rows), totals);
  return static_cast<int>(cudaGetLastError());
}
#else
// The same totals on the host, from the rows row by row ((rows, N)).
template <int N, class Cols = AllColumns<N>>
void column_total_host(const float* partials, int rows, double* totals) {
  for (int c = 0; c < N; ++c) {
    double sums[kTotalThreads][1];
    for (int j = 0; j < kTotalThreads; ++j) {
      sums[j][0] = 0.0;
      for (int r = 4 * j; r < rows; r += 4 * kTotalThreads)
        for (int e = r; e < r + 4 && e < rows; ++e)
          sums[j][0] += static_cast<double>(partials[static_cast<size_t>(e) * N + c]);
    }
    block_sum_host<1, kTotalThreads, double>(sums, totals + Cols::total(c));
  }
  for (int k = 0; k < Cols::n_totals; ++k) {
    if (Cols::zero(k)) totals[k] = 0.0;
  }
}
#endif

}  // namespace sdf3d
