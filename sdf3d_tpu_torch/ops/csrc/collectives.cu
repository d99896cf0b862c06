// Ring all-reduces (sum) between processes for Hopper (sm_90a), over device
// memory shared by CUDA IPC.
//
// K7 (sdf3d_ring_allreduce) replaces sdf3d_tpu/parallel/collectives.py::
// _ring_allreduce_kernel, the latency ring: two column-half streams, each
// forwarding its whole half N-1 hops.  K8 (sdf3d_rs_ag) replaces
// _rs_ag_kernel, the bandwidth ring: reduce-scatter N-1 steps, then
// all-gather N-1 steps, two streams, with consumption acks.  The schedule
// walks are in collectives.cuh; here one thread block runs each stream.
//
// The TPU kernels issue remote DMAs and wait on DMA semaphores, and K7 relies
// on the devices running in lockstep.  Here a rank's kernel stores into its
// right neighbour's region (a peer pointer from cudaIpcOpenMemHandle), makes
// its stores visible (__threadfence_system), then stores the flag with
// st.release.sys; the neighbour polls its own flag with ld.acquire.sys and
// reads the slot through L2 (__ldcg).  Ranks need not run in lockstep: two
// processes on one card take turns, and a rank can be descheduled mid-ring.
// Every wait is bounded by a time limit on %globaltimer; at the limit the
// block writes its status words (op and step) and returns, and the wrapper
// raises.
//
// What bounds them: flag latency.  The fit's payload is nine values; the
// bytes (each rank reads its vector once and writes its sum once) take
// nanoseconds.  One block per stream keeps the kernel simple; the copies are
// one element per thread per iteration.
#include "collectives.cuh"

using sdf3d_coll::Args;
using sdf3d_coll::Layout;
using sdf3d_coll::u64;

extern "C" int sdf3d_coll_region_bytes(int kind, int n_ranks, long long cap, int elem, long long* bytes) {
  *bytes = static_cast<long long>(sdf3d_coll::make_layout(kind, n_ranks, cap, elem).bytes());
  return 0;
}

namespace {
Args make_args(int kind, void* self, void* right, void* left, const void* x, void* out, long long n, int elem,
               int n_ranks, int rank, int parity, long long cap, u64 epoch) {
  Args a;
  a.self = static_cast<char*>(self);
  a.right = static_cast<char*>(right);
  a.left = static_cast<char*>(left);
  a.x = x;
  a.out = out;
  a.n = n;
  a.n_ranks = n_ranks;
  a.rank = rank;
  a.parity = parity;
  a.lay = sdf3d_coll::make_layout(kind, n_ranks, cap, elem);
  a.epoch = epoch;
  return a;
}
}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {
constexpr int kThreads = 256;

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ u64 load_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The primitives of the walks for one thread block.
struct DeviceCtx {
  long long spin_ns;
  int* status;  // this rank's status words
  int* ok;      // a word of shared memory
  __device__ int lane() const { return threadIdx.x; }
  __device__ int lanes() const { return blockDim.x; }
  __device__ void barrier() const { __syncthreads(); }
  template <typename T>
  __device__ T load(const T* p) const { return __ldcg(p); }
  // Every thread's stores, then the flag.
  __device__ void signal(u64* flag, u64 v) const {
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0) store_release(flag, v);
  }
  // Thread 0 polls; the barrier passes what it saw to the block.
  __device__ bool wait(const u64* flag, u64 v) const {
    if (threadIdx.x == 0) {
      const u64 t0 = now_ns();
      int seen = 1;
      while (load_acquire(flag) < v) {
        if (static_cast<long long>(now_ns() - t0) > spin_ns) {
          seen = 0;
          break;
        }
        __nanosleep(64);
      }
      *ok = seen;
    }
    __syncthreads();
    const bool arrived = *ok != 0;
    __syncthreads();
    return arrived;
  }
  __device__ bool fail(int s, int op, int step) const {
    if (threadIdx.x == 0) {
      int* w = status + s * sdf3d_coll::kStatusInts;
      w[1] = op;
      w[2] = step;
      w[0] = 1;
    }
    return false;
  }
};

template <typename T, bool kRsAg>
__global__ void __launch_bounds__(kThreads) sdf3d_allreduce_kernel(Args a, long long spin_ns) {
  __shared__ int ok;
  const DeviceCtx c{spin_ns, reinterpret_cast<int*>(a.self), &ok};
  const int s = blockIdx.x;
  if (threadIdx.x == 0)
    for (int i = 0; i < sdf3d_coll::kStatusInts; ++i) c.status[s * sdf3d_coll::kStatusInts + i] = 0;
  if (kRsAg)
    sdf3d_coll::rs_ag_stream<T>(c, a, s);
  else
    sdf3d_coll::ring_stream<T>(c, a, s);
}

template <bool kRsAg>
int launch(int device, const Args& a, int elem, long long spin_ns, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == 4)
    sdf3d_allreduce_kernel<float, kRsAg><<<2, kThreads, 0, st>>>(a, spin_ns);
  else if (elem == 8)
    sdf3d_allreduce_kernel<double, kRsAg><<<2, kThreads, 0, st>>>(a, spin_ns);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// K7: out (n) = the sum over the ring of x (n), float (elem 4) or double
// (elem 8).  self/right: this rank's region and its right neighbour's (a
// region of sdf3d_coll_region_bytes(0, n_ranks, cap, elem) bytes, cap >=
// ceil(n / 2)).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError(); sdf3d_coll_status reads whether a wait timed out.
extern "C" int sdf3d_ring_allreduce(int device, void* self, void* right, const void* x, void* out, long long n,
                                    int elem, int n_ranks, int rank, int parity, long long cap,
                                    unsigned long long epoch, long long spin_ns, void* stream) {
  const Args a = make_args(sdf3d_coll::kRing, self, right, self, x, out, n, elem, n_ranks, rank, parity, cap, epoch);
  return launch<false>(device, a, elem, spin_ns, stream);
}

// K8, in place: out (n = 2·N·m, this rank's zero-padded input) becomes the
// sum over the ring.  Regions of sdf3d_coll_region_bytes(1, n_ranks, cap,
// elem) bytes, cap >= m; left: the left neighbour's (its acks).
extern "C" int sdf3d_rs_ag(int device, void* self, void* right, void* left, void* out, long long n, int elem,
                           int n_ranks, int rank, int parity, long long cap, unsigned long long epoch,
                           long long spin_ns, void* stream) {
  const Args a = make_args(sdf3d_coll::kRsAg, self, right, left, out, out, n, elem, n_ranks, rank, parity, cap, epoch);
  return launch<true>(device, a, elem, spin_ns, stream);
}

// A zeroed region of `bytes` on `device` (cudaMalloc: its IPC handle exports
// this region alone).
extern "C" int sdf3d_coll_alloc(int device, long long bytes, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

extern "C" int sdf3d_coll_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return static_cast<int>(err);
}

// handle: 64 bytes (cudaIpcMemHandle_t).
extern "C" int sdf3d_ipc_get_handle(int device, void* ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr);
  return static_cast<int>(err);
}

extern "C" int sdf3d_ipc_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaIpcOpenMemHandle(ptr, *static_cast<const cudaIpcMemHandle_t*>(handle), cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(err);
}

extern "C" int sdf3d_ipc_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(err);
}

// status (host, 2 x 4 int32): the region's status words after the work on
// `stream` has finished (waits for it).
extern "C" int sdf3d_coll_status(int device, const void* self, int* status, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(status, self, 2 * sdf3d_coll::kStatusInts * sizeof(int), cudaMemcpyDeviceToHost, st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  return static_cast<int>(err);
}

#else  // A C++ compiler: N ranks as threads over regions in host memory.

#include <chrono>
#include <thread>
#include <vector>

namespace {
// The primitives of the walks for one thread (one stream of one rank).
struct HostCtx {
  long long spin_ns;
  int* status;
  int lane() const { return 0; }
  int lanes() const { return 1; }
  void barrier() const {}
  template <typename T>
  T load(const T* p) const { return *p; }
  void signal(u64* flag, u64 v) const { __atomic_store_n(flag, v, __ATOMIC_RELEASE); }
  bool wait(const u64* flag, u64 v) const {
    const auto t0 = std::chrono::steady_clock::now();
    while (__atomic_load_n(flag, __ATOMIC_ACQUIRE) < v) {
      if (std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now() - t0).count() >
          spin_ns)
        return false;
      std::this_thread::yield();
    }
    return true;
  }
  bool fail(int s, int op, int step) const {
    int* w = status + s * sdf3d_coll::kStatusInts;
    w[0] = 1;
    w[1] = op;
    w[2] = step;
    return false;
  }
};

// `calls` calls in a row on every rank but `absent` (-1: none): x and out
// are (n_ranks, n); status (n_ranks, 2, 4).  Each (rank, stream) thread runs
// its calls without waiting for the other threads, as a rank's kernels do.
template <typename T>
void host_ranks(int kind, int n_ranks, const T* x, T* out, long long n, int calls, int absent, long long spin_ns,
                int* status) {
  const long long cap = kind == sdf3d_coll::kRing ? (n + 1) / 2 : n / (2 * n_ranks);
  const Layout lay = sdf3d_coll::make_layout(kind, n_ranks, cap, sizeof(T));
  std::vector<std::vector<u64>> regions(n_ranks, std::vector<u64>((lay.bytes() + 7) / 8, 0));
  auto base = [&](int r) { return reinterpret_cast<char*>(regions[(r + n_ranks) % n_ranks].data()); };
  std::vector<std::thread> threads;
  for (int r = 0; r < n_ranks; ++r) {
    if (r == absent) continue;
    for (int s = 0; s < 2; ++s) {
      threads.emplace_back([=, &base]() {
        const HostCtx c{spin_ns, status + r * 2 * sdf3d_coll::kStatusInts};
        const long long part = n / 2;  // K8: a stream's chunks
        for (int call = 0; call < calls; ++call) {
          const Args a = make_args(kind, base(r), base(r + 1), base(r - 1), x + r * n, out + r * n, n, sizeof(T),
                                   n_ranks, r, call % 2, cap, static_cast<u64>(call / 2 + 1));
          bool ok;
          if (kind == sdf3d_coll::kRing) {
            ok = sdf3d_coll::ring_stream<T>(c, a, s);
          } else {
            for (long long i = s * part; i < (s + 1) * part; ++i) out[r * n + i] = x[r * n + i];
            ok = sdf3d_coll::rs_ag_stream<T>(c, a, s);
          }
          if (!ok) return;
        }
      });
    }
  }
  for (auto& t : threads) t.join();
}

int host_entry(int kind, int n_ranks, const void* x, void* out, long long n, int elem, int calls, int absent,
               long long spin_ns, int* status) {
  for (int i = 0; i < n_ranks * 2 * sdf3d_coll::kStatusInts; ++i) status[i] = 0;
  if (elem == 4)
    host_ranks(kind, n_ranks, static_cast<const float*>(x), static_cast<float*>(out), n, calls, absent, spin_ns,
               status);
  else if (elem == 8)
    host_ranks(kind, n_ranks, static_cast<const double*>(x), static_cast<double*>(out), n, calls, absent, spin_ns,
               status);
  else
    return 1;
  return 0;
}
}  // namespace

// K7 on n_ranks threads: x and out (n_ranks, n).
extern "C" int sdf3d_ring_allreduce_host(int n_ranks, const void* x, void* out, long long n, int elem, int calls,
                                         int absent, long long spin_ns, int* status) {
  return host_entry(sdf3d_coll::kRing, n_ranks, x, out, n, elem, calls, absent, spin_ns, status);
}

// K8 on n_ranks threads: x and out (n_ranks, n), n = 2·n_ranks·m (padded).
extern "C" int sdf3d_rs_ag_host(int n_ranks, const void* x, void* out, long long n, int elem, int calls,
                                int absent, long long spin_ns, int* status) {
  return host_entry(sdf3d_coll::kRsAg, n_ranks, x, out, n, elem, calls, absent, spin_ns, status);
}

#endif
