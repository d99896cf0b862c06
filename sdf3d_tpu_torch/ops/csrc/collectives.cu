// Ring all-reduces (sum) between processes for Hopper (sm_90a): data in
// device memory shared by CUDA IPC, flags in host memory every rank maps.
//
// K7 (sdf3d_ring_allreduce) replaces sdf3d_tpu/parallel/collectives.py::
// _ring_allreduce_kernel, the latency ring: two column-half streams, each
// forwarding its whole half N-1 hops.  K8 (sdf3d_rs_ag) replaces
// _rs_ag_kernel, the bandwidth ring: reduce-scatter N-1 steps, then
// all-gather N-1 steps, two streams, with consumption acks.  The segments
// and the host's walk over them are in collectives.cuh.
//
// The TPU kernels issue remote DMAs and wait on DMA semaphores inside the
// kernel.  Here no kernel waits: a wait on the card would hold an SM, and
// where ranks share a card (processes without MPS take turns by time
// slices) it would hold the card until its slice ran out, against the very
// peer it waits for.  So a call is a sequence of segment kernels, and the
// host launches each one only when the flags it needs have arrived.  A
// segment stores into the right neighbour's region (a peer pointer from
// cudaIpcOpenMemHandle); every block makes its stores and reads visible
// (__threadfence_system) and counts itself done in the region, and the last
// block stores the segment's flags into the shared host segment with
// st.release.sys.  The host polls its own flags with acquire loads, bounded
// by a time limit: at the limit it writes its status words and the wrapper
// raises.  A call ends when its last segment is queued; nothing waits for
// the card.
//
// What bounds them: flag latency, a kernel launch and a host poll per step.
// The fit's payload is nine values; the bytes (each rank reads its vector
// once and writes its sum once) take nanoseconds.  With no wait inside it a
// segment takes as many blocks as its payload needs and copies and adds
// with 16-byte accesses (slots are placed at their vector's 16-byte phase).
#include "collectives.cuh"

#include <errno.h>
#include <fcntl.h>
#include <string.h>
#include <sys/mman.h>
#include <unistd.h>

using sdf3d_coll::Args;
using sdf3d_coll::Layout;
using sdf3d_coll::u64;

extern "C" int sdf3d_coll_region_bytes(int kind, int n_ranks, long long cap, int elem, long long* bytes) {
  *bytes = static_cast<long long>(sdf3d_coll::make_layout(kind, n_ranks, cap, elem).bytes());
  return 0;
}

// The shared host segment of a buffer set: its size (whole pages).
extern "C" int sdf3d_coll_sync_bytes(int kind, int n_ranks, long long* bytes) {
  *bytes = static_cast<long long>(sdf3d_coll::make_layout(kind, n_ranks, 1, 8).sync_bytes());
  return 0;
}

// Maps the POSIX shared-memory object `name` of `bytes` bytes (create: a new
// one, zeroed; it fails if the name exists).  Returns 0 or errno.
extern "C" int sdf3d_coll_shm_open(const char* name, long long bytes, int create, void** host) {
  const int fd = shm_open(name, create ? O_RDWR | O_CREAT | O_EXCL : O_RDWR, 0600);
  if (fd < 0) return errno;
  if (create && ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
    const int err = errno;
    close(fd);
    shm_unlink(name);
    return err;
  }
  void* p = mmap(nullptr, static_cast<size_t>(bytes), PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  const int err = errno;
  close(fd);
  if (p == MAP_FAILED) {
    if (create) shm_unlink(name);
    return err;
  }
  *host = p;
  return 0;
}

extern "C" int sdf3d_coll_shm_close(void* host, long long bytes) {
  return munmap(host, static_cast<size_t>(bytes)) == 0 ? 0 : errno;
}

extern "C" int sdf3d_coll_shm_unlink(const char* name) { return shm_unlink(name) == 0 ? 0 : errno; }

// status (2 x 4 int32): rank's status words in the shared segment (host).
extern "C" int sdf3d_coll_status(int kind, int n_ranks, const void* sync, int rank, int* status) {
  const Layout lay = sdf3d_coll::make_layout(kind, n_ranks, 1, 8);
  memcpy(status, static_cast<const char*>(sync) + lay.status(rank), 2 * sdf3d_coll::kStatusInts * sizeof(int));
  return 0;
}

namespace {
// n: x's elements; K8's out holds 2·N·ceil(n / 2N).
Args make_args(int kind, void* self, void* right, void* sync, const void* x, void* out, long long n,
               int elem, int n_ranks, int rank, int parity, long long cap, u64 epoch) {
  Args a;
  a.self = static_cast<char*>(self);
  a.right = static_cast<char*>(right);
  a.sync = static_cast<char*>(sync);
  a.x = x;
  a.out = out;
  a.n = kind == sdf3d_coll::kRing ? n : 2 * n_ranks * ((n + 2 * n_ranks - 1) / (2 * n_ranks));
  a.valid = n;
  a.kind = kind;
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

#include <thread>
#include <vector>

namespace {
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // per stream: two a streaming multiprocessor

__device__ __forceinline__ void store_release(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The lanes of a segment: every thread of the stream's blocks.
struct DeviceCtx {
  __device__ long long lane() const { return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; }
  __device__ long long lanes() const { return static_cast<long long>(gridDim.x) * blockDim.x; }
  template <typename T>
  __device__ T load(const T* p) const { return __ldcg(p); }
  __device__ sdf3d_coll::Pack<double> load(const sdf3d_coll::Pack<double>* p) const {
    const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
    return {{v.x, v.y}};
  }
  __device__ sdf3d_coll::Pack<float> load(const sdf3d_coll::Pack<float>* p) const {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    return {{v.x, v.y, v.z, v.w}};
  }
};

// Segment g of a call, blockIdx.y the stream.  Every block's stores and
// reads are done before it counts itself in the region; the stream's last
// block resets the count for the next segment and stores the flags.
template <typename T>
__global__ void __launch_bounds__(kThreads) sdf3d_segment_kernel(Args a, int g) {
  const int s = blockIdx.y;
  sdf3d_coll::segment<T>(DeviceCtx{}, a, s, g);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned* done = reinterpret_cast<unsigned*>(a.self) + s;
  if (atomicAdd(done, 1u) != gridDim.x - 1) return;
  atomicExch(done, 0u);
  __threadfence_system();
  sdf3d_coll::Signal sig[2];
  const int n = sdf3d_coll::segment_signals(a, a.sync, s, g, sig);
  for (int i = 0; i < n; ++i) store_release(sig[i].at, sig[i].value);
}

template <typename T>
int launch_segment(const Args& a, int g, cudaStream_t st) {
  const long long items = sdf3d_coll::segment_elems(a, g) / (16 / sizeof(T)) + 16 / sizeof(T);
  long long blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  sdf3d_segment_kernel<T><<<dim3(static_cast<unsigned>(blocks), 2), kThreads, 0, st>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}

// The call: the host's walk over the segments (collectives.cuh::walk).
int run(int device, const Args& a, int elem, void* sync_host, long long spin_ns, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (elem != 4 && elem != 8) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sdf3d_coll::walk(a, static_cast<char*>(sync_host), spin_ns, [&](int g) {
    return elem == 4 ? launch_segment<float>(a, g, st) : launch_segment<double>(a, g, st);
  });
}
}  // namespace

// K7: out (n) = the sum over the ring of x (n), float (elem 4) or double
// (elem 8).  self/right: this rank's region and its right neighbour's (a
// region of sdf3d_coll_region_bytes(0, n_ranks, cap, elem) bytes, cap >=
// ceil(n / 2)); sync_host/sync_dev: the host's and the card's view of the
// buffer set's shared segment.  Launches the segments on `stream`, each once
// the host has seen its flags, allocates nothing and does not wait for the
// card.  Returns 0, -1 when a wait passed spin_ns (the rank's status words
// say which: sdf3d_coll_status) or a CUDA error.
extern "C" int sdf3d_ring_allreduce(int device, void* self, void* right, void* sync_host, void* sync_dev,
                                    const void* x, void* out, long long n, int elem, int n_ranks, int rank,
                                    int parity, long long cap, unsigned long long epoch, long long spin_ns,
                                    void* stream) {
  const Args a = make_args(sdf3d_coll::kRing, self, right, sync_dev, x, out, n, elem, n_ranks, rank, parity,
                           cap, epoch);
  return run(device, a, elem, sync_host, spin_ns, stream);
}

// K8: out (2·N·m, m = ceil(n / 2N)) = the sum over the ring of x (n),
// zero-padded.  Regions of sdf3d_coll_region_bytes(1, n_ranks, cap, elem)
// bytes, cap >= m.  Returns as sdf3d_ring_allreduce.
extern "C" int sdf3d_rs_ag(int device, void* self, void* right, void* sync_host, void* sync_dev, const void* x,
                           void* out, long long n, int elem, int n_ranks, int rank, int parity, long long cap,
                           unsigned long long epoch, long long spin_ns, void* stream) {
  const Args a = make_args(sdf3d_coll::kRsAg, self, right, sync_dev, x, out, n, elem, n_ranks, rank, parity,
                           cap, epoch);
  return run(device, a, elem, sync_host, spin_ns, stream);
}

// The ranks of `rank_mask` of one ring in this process, one std::thread
// each: rank d makes `calls` calls in a row (call numbers first, first + 1,
// ...) over regions[d], regions[d + 1] and the one shared segment, from
// xs[d] into outs[d] on streams[d], as sdf3d_ring_allreduce (kind 0) or
// sdf3d_rs_ag (kind 1).  errors[d]: its first nonzero result.
extern "C" int sdf3d_coll_local_run(int device, int kind, int n_ranks, void* const* regions, void* sync_host,
                                    void* sync_dev, const void* const* xs, void* const* outs, long long n, int elem,
                                    long long cap, long long first, int calls, unsigned long long rank_mask,
                                    long long spin_ns, void* const* streams, int* errors) {
  std::vector<std::thread> threads;
  for (int d = 0; d < n_ranks; ++d) {
    errors[d] = 0;
    if (!((rank_mask >> d) & 1)) continue;
    threads.emplace_back([=]() {
      for (long long c = first; c < first + calls; ++c) {
        const Args a = make_args(kind, regions[d], regions[(d + 1) % n_ranks], sync_dev, xs[d], outs[d], n, elem,
                                 n_ranks, d, static_cast<int>(c % 2), cap, static_cast<u64>(c / 2 + 1));
        const int err = run(device, a, elem, sync_host, spin_ns, streams[d]);
        if (err != 0) {
          errors[d] = err;
          return;
        }
      }
    });
  }
  for (auto& t : threads) t.join();
  return 0;
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

// Registers the mapped shared segment `host` (page-aligned, `bytes`) with
// CUDA, mapped and portable, and gives the card's pointer to it.  Returns -2
// when the card cannot use registered host memory at its host address.
extern "C" int sdf3d_coll_sync_register(int device, void* host, long long bytes, void** dev) {
  cudaError_t err = cudaSetDevice(device);
  int usable = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&usable, cudaDevAttrCanUseHostPointerForRegisteredMem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!usable) return -2;
  err = cudaHostRegister(host, static_cast<size_t>(bytes), cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (err == cudaSuccess) err = cudaHostGetDevicePointer(dev, host, 0);
  return static_cast<int>(err);
}

extern "C" int sdf3d_coll_sync_unregister(int device, void* host) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaHostUnregister(host);
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

#else  // A C++ compiler: N ranks as threads over regions in host memory.

#include <chrono>
#include <thread>
#include <vector>

namespace {
// The lanes of a segment on the host: one.
struct HostCtx {
  long long lane() const { return 0; }
  long long lanes() const { return 1; }
  template <typename U>
  U load(const U* p) const { return *p; }
};

// `calls` calls in a row on every rank but `absent` (-1: none), rank `late`
// starting `late_ns` after the others: x is (n_ranks, n), out (n_ranks, n)
// for K7 and (n_ranks, 2·N·ceil(n / 2N)) for K8; status (n_ranks, 2, 4).  Each rank's thread walks its calls without waiting for
// the others but at the walk's waits, as a rank's host does; a segment runs
// both streams, then stores their flags.
template <typename T>
void host_ranks(int kind, int n_ranks, const T* x, T* out, long long n, int calls, int absent, int late,
                long long late_ns, long long spin_ns, int* status) {
  const long long m = (n + 2 * n_ranks - 1) / (2 * n_ranks), cap = kind == sdf3d_coll::kRing ? (n + 1) / 2 : m;
  const long long n_out = kind == sdf3d_coll::kRing ? n : 2 * n_ranks * m;
  const Layout lay = sdf3d_coll::make_layout(kind, n_ranks, cap, sizeof(T));
  std::vector<std::vector<u64>> regions(n_ranks, std::vector<u64>((lay.bytes() + 7) / 8, 0));
  std::vector<u64> sync_words(lay.sync_bytes() / 8, 0);
  char* sync = reinterpret_cast<char*>(sync_words.data());
  auto base = [&](int r) { return reinterpret_cast<char*>(regions[(r + n_ranks) % n_ranks].data()); };
  std::vector<std::thread> threads;
  for (int r = 0; r < n_ranks; ++r) {
    if (r == absent) continue;
    threads.emplace_back([=, &base]() {
      if (r == late) std::this_thread::sleep_for(std::chrono::nanoseconds(late_ns));
      const HostCtx c;
      for (int call = 0; call < calls; ++call) {
        const Args a = make_args(kind, base(r), base(r + 1), sync, x + r * n, out + r * n_out, n, sizeof(T),
                                 n_ranks, r, call % 2, cap, static_cast<u64>(call / 2 + 1));
        const int rc = sdf3d_coll::walk(a, sync, spin_ns, [&](int g) {
          for (int s = 0; s < 2; ++s) sdf3d_coll::segment<T>(c, a, s, g);
          for (int s = 0; s < 2; ++s) {
            sdf3d_coll::Signal sig[2];
            const int k = sdf3d_coll::segment_signals(a, sync, s, g, sig);
            for (int i = 0; i < k; ++i) __atomic_store_n(sig[i].at, sig[i].value, __ATOMIC_RELEASE);
          }
          return 0;
        });
        if (rc != 0) break;
      }
      int* w = reinterpret_cast<int*>(sync + lay.status(r));
      for (int i = 0; i < 2 * sdf3d_coll::kStatusInts; ++i) status[r * 2 * sdf3d_coll::kStatusInts + i] = w[i];
    });
  }
  for (auto& t : threads) t.join();
}

int host_entry(int kind, int n_ranks, const void* x, void* out, long long n, int elem, int calls, int absent, int late,
               long long late_ns, long long spin_ns, int* status) {
  for (int i = 0; i < n_ranks * 2 * sdf3d_coll::kStatusInts; ++i) status[i] = 0;
  if (elem == 4)
    host_ranks(kind, n_ranks, static_cast<const float*>(x), static_cast<float*>(out), n, calls, absent, late, late_ns,
               spin_ns, status);
  else if (elem == 8)
    host_ranks(kind, n_ranks, static_cast<const double*>(x), static_cast<double*>(out), n, calls, absent, late,
               late_ns, spin_ns, status);
  else
    return 1;
  return 0;
}
}  // namespace

// K7 on n_ranks threads: x and out (n_ranks, n).
extern "C" int sdf3d_ring_allreduce_host(int n_ranks, const void* x, void* out, long long n, int elem, int calls,
                                         int absent, int late, long long late_ns, long long spin_ns, int* status) {
  return host_entry(sdf3d_coll::kRing, n_ranks, x, out, n, elem, calls, absent, late, late_ns, spin_ns, status);
}

// K8 on n_ranks threads: x (n_ranks, n), out (n_ranks, 2·n_ranks·m).
extern "C" int sdf3d_rs_ag_host(int n_ranks, const void* x, void* out, long long n, int elem, int calls, int absent,
                                int late, long long late_ns, long long spin_ns, int* status) {
  return host_entry(sdf3d_coll::kRsAg, n_ranks, x, out, n, elem, calls, absent, late, late_ns, spin_ns, status);
}

#endif
