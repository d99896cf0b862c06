// The ring all-reduces K7 (latency ring) and K8 (reduce-scatter + all-gather)
// as schedule walks over a few primitives, written once for two compilers:
// under nvcc each stream is one thread block of a kernel (collectives.cu),
// under a C++ compiler each stream is one std::thread of a rank in a host
// harness over shared memory (the route of the CPU tests).  A context type
// supplies the primitives: lane()/lanes() (the threads sharing a copy),
// barrier(), load() (a read of memory another rank may have written),
// signal() (release store of a flag after the data), wait() (acquire poll of
// a flag with a time limit) and fail() (an error word naming the op and step).
//
// Each rank owns one region per buffer set; peers write into it (push), a rank
// polls only its own flags.  A region holds two parity sets (a buffer set's
// calls alternate between them, call c uses c % 2), each with per-stream
// receive slots, their arrival flags and, for K8, consumption acks:
//
//   [status: 2 streams x 4 int32][flags][acks][data: parity x stream x slot x cap]
//
// Flags hold tag(epoch, step), epoch = c / 2 + 1: monotonic, never reset, so a
// flag left by an earlier call never satisfies a later wait.
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define SDF3D_COLL_HD __host__ __device__ __forceinline__
#define SDF3D_COLL_OPS __device__ __forceinline__
#else
#define SDF3D_COLL_HD inline
#define SDF3D_COLL_OPS inline
#endif

namespace sdf3d_coll {

typedef unsigned long long u64;

enum Kind { kRing = 0, kRsAg = 1 };
// What a timed-out wait waited for (status word 1).
enum WaitOp { kOpWait = 1, kOpAckWait = 2 };
constexpr int kStatusInts = 4;  // per stream: failed, op, step, unused
constexpr size_t kHeader = 64;  // the status words

SDF3D_COLL_HD size_t round_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

// The flag value of step k in call epoch e: monotonic in (e, k), never 0.
SDF3D_COLL_HD u64 tag(u64 epoch, int k) { return (epoch << 20) + static_cast<u64>(k) + 1; }

struct Layout {
  int slots;      // receive slots per stream: N - 1 (K7), 2 (K8)
  long long cap;  // elements per slot
  int elem;       // bytes per element
  SDF3D_COLL_HD size_t flag(int parity, int stream, int slot) const {
    return kHeader + static_cast<size_t>((parity * 2 + stream) * slots + slot) * 8;
  }
  SDF3D_COLL_HD size_t ack(int parity, int stream, int slot) const {
    return kHeader + static_cast<size_t>(4 * slots + (parity * 2 + stream) * 2 + slot) * 8;
  }
  SDF3D_COLL_HD size_t data(int parity, int stream, int slot) const {
    const size_t base = round_up(kHeader + static_cast<size_t>(4 * slots + 8) * 8, 256);
    return base + (static_cast<size_t>((parity * 2 + stream) * slots + slot) * static_cast<size_t>(cap)) * elem;
  }
  SDF3D_COLL_HD size_t bytes() const { return data(2, 0, 0); }
};

SDF3D_COLL_HD Layout make_layout(int kind, int n_ranks, long long cap, int elem) {
  Layout l;
  l.slots = kind == kRing ? (n_ranks > 1 ? n_ranks - 1 : 1) : 2;
  l.cap = cap;
  l.elem = elem;
  return l;
}

// One call of one rank: its region and its neighbours', its input and output.
struct Args {
  char* self;
  char* right;
  char* left;
  const void* x;
  void* out;
  long long n;  // K7: the vector's elements; K8: the padded vector's, 2·N·m
  int n_ranks, rank, parity;
  Layout lay;
  u64 epoch;
};

template <typename T>
SDF3D_COLL_HD T* slot_ptr(char* base, const Layout& l, int parity, int stream, int slot) {
  return reinterpret_cast<T*>(base + l.data(parity, stream, slot));
}
SDF3D_COLL_HD u64* flag_ptr(char* base, const Layout& l, int parity, int stream, int slot) {
  return reinterpret_cast<u64*>(base + l.flag(parity, stream, slot));
}
SDF3D_COLL_HD u64* ack_ptr(char* base, const Layout& l, int parity, int stream, int slot) {
  return reinterpret_cast<u64*>(base + l.ack(parity, stream, slot));
}

// K8's chunk indices (sdf3d_tpu/parallel/collectives.py::_rs_ag_kernel):
// reduce-scatter step k < N-1 sends (d - k) and accumulates into (d - k - 1);
// all-gather step t = k - (N-1) sends (d + 1 - t) and stores into (d - t).
SDF3D_COLL_HD int send_chunk(int d, int k, int n) {
  return k < n - 1 ? (d - k + 2 * n) % n : (d + 1 - (k - (n - 1)) + 2 * n) % n;
}
SDF3D_COLL_HD int recv_chunk(int d, int k, int n) {
  return k < n - 1 ? (d - k - 1 + 2 * n) % n : (d - (k - (n - 1)) + 2 * n) % n;
}

template <typename T, typename Ctx>
SDF3D_COLL_OPS void copy_in(const Ctx& c, T* dst, const T* src, long long n) {
  for (long long i = c.lane(); i < n; i += c.lanes()) dst[i] = c.load(src + i);
}

template <typename T, typename Ctx>
SDF3D_COLL_OPS void add_in(const Ctx& c, T* dst, const T* src, long long n) {
  for (long long i = c.lane(); i < n; i += c.lanes()) dst[i] = dst[i] + c.load(src + i);
}

// K7, stream s (0: the first ceil(n/2) elements, 1: the rest), the ops of
// ring_schedule in order: start(step) forwards this rank's half (step 0) or
// the arrival of step - 1 into the right neighbour's slot `step`; wait(step)
// polls this rank's flag of slot `step`; accum(step) keeps the arrival in its
// slot.  Slot s holds the contribution of rank (d - s - 1) mod N, so after the
// last wait the N contributions are added in rank order, the same order on
// every rank: every rank holds the same bits.  One slot per step: no slot is
// rewritten within a call, so no acks.
template <typename T, typename Ctx>
SDF3D_COLL_OPS bool ring_stream(const Ctx& c, const Args& a, int s) {
  const int N = a.n_ranks, d = a.rank, p = a.parity;
  const long long h = (a.n + 1) / 2, lo = s == 0 ? 0 : h, len = s == 0 ? h : a.n - h;
  const T* x = static_cast<const T*>(a.x) + lo;
  for (int step = 0; step < N - 1; ++step) {
    const T* src = step == 0 ? x : slot_ptr<T>(a.self, a.lay, p, s, step - 1);
    copy_in(c, slot_ptr<T>(a.right, a.lay, p, s, step), src, len);
    c.signal(flag_ptr(a.right, a.lay, p, s, step), tag(a.epoch, step));
    if (!c.wait(flag_ptr(a.self, a.lay, p, s, step), tag(a.epoch, step))) return c.fail(s, kOpWait, step);
  }
  T* out = static_cast<T*>(a.out) + lo;
  for (long long i = c.lane(); i < len; i += c.lanes()) {
    T acc = c.load(d == 0 ? x + i : slot_ptr<T>(a.self, a.lay, p, s, d - 1) + i);
    for (int r = 1; r < N; ++r)
      acc = acc + c.load(r == d ? x + i : slot_ptr<T>(a.self, a.lay, p, s, (d - r - 1 + N) % N) + i);
    out[i] = acc;
  }
  return true;
}

template <typename T, typename Ctx>
SDF3D_COLL_OPS void rs_ag_start(const Ctx& c, const Args& a, int s, const T* chunks, long long m, int k) {
  copy_in(c, slot_ptr<T>(a.right, a.lay, a.parity, s, k % 2), chunks + send_chunk(a.rank, k, a.n_ranks) * m, m);
  c.signal(flag_ptr(a.right, a.lay, a.parity, s, k % 2), tag(a.epoch, k));
}

// K8, stream s (chunks [s·N, (s+1)·N) of m elements of `out`, which holds this
// rank's padded input), the ops of rs_ag_schedule(backpressure=True) in order.
// Slots alternate by k % 2; bp_signal(k) acks slot k % 2 to the left
// neighbour once consumed, and bp_wait(k + 1) waits for the right
// neighbour's ack of step k - 1 before start(k + 1) rewrites that slot.  Each
// chunk is reduced along one path and then copied around: the same bits on
// every rank.
template <typename T, typename Ctx>
SDF3D_COLL_OPS bool rs_ag_stream(const Ctx& c, const Args& a, int s) {
  const int N = a.n_ranks, d = a.rank, p = a.parity, total = 2 * (N - 1);
  const long long m = a.n / (2 * N);
  T* chunks = static_cast<T*>(a.out) + static_cast<long long>(s) * N * m;
  if (total > 0) rs_ag_start(c, a, s, chunks, m, 0);
  for (int k = 0; k < total; ++k) {
    const int slot = k % 2;
    if (!c.wait(flag_ptr(a.self, a.lay, p, s, slot), tag(a.epoch, k))) return c.fail(s, kOpWait, k);
    T* dst = chunks + recv_chunk(d, k, N) * m;
    const T* src = slot_ptr<T>(a.self, a.lay, p, s, slot);
    if (k < N - 1)
      add_in(c, dst, src, m);
    else
      copy_in(c, dst, src, m);
    c.barrier();  // the chunk is whole before a later start sends it
    if (k + 2 < total) c.signal(ack_ptr(a.left, a.lay, p, s, slot), tag(a.epoch, k));
    if (k + 1 < total) {
      if (k + 1 >= 2 && !c.wait(ack_ptr(a.self, a.lay, p, s, (k + 1) % 2), tag(a.epoch, k - 1)))
        return c.fail(s, kOpAckWait, k + 1);
      rs_ag_start(c, a, s, chunks, m, k + 1);
    }
  }
  return true;
}

}  // namespace sdf3d_coll
