// The ring all-reduces K7 (latency ring) and K8 (reduce-scatter + all-gather)
// cut into segments at their waits, written once for two compilers.  A call
// is a short sequence of segments; a segment does the work between two waits
// for both column streams (A, B), and every wait is the host's, before the
// segment that needs the arrival (walk()).  Under nvcc a segment is one
// kernel launch over as many blocks as the payload needs (collectives.cu);
// under a C++ compiler it is a function call on the rank's host thread, in a
// harness over shared memory (the route of the CPU tests).  Both builds walk
// the same segments with the same waits.  A context type supplies lane() /
// lanes() (the threads sharing a segment's items) and load() (a read of
// memory another rank may have written).
//
// Each rank owns one device region per buffer set; its left neighbour
// writes into it (push).  A region holds the last-block counters and two
// parity sets (a buffer set's calls alternate between them, call c uses
// c % 2), each with per-stream receive slots:
//
//   [counters: 2 x u32][data: parity x stream x slot x stride]
//
// The arrival flags, K8's consumption acks and the status words live in one
// host segment that every rank maps (shared memory registered with CUDA),
// one block per rank:
//
//   [status: 2 streams x 4 int32][flags: parity x stream x slot][acks: parity x stream x 2]
//
// A flag is stored by the segment that makes it true, once all of its work is
// done; the host polls its own rank's flags.  Flags hold tag(epoch, step),
// epoch = c / 2 + 1: monotonic, never reset, so a flag left by an earlier
// call never satisfies a later wait.
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
constexpr int kStatusInts = 4;    // per stream: failed, op, step, unused
constexpr size_t kCounters = 256;  // the region's head: the last-block counters
constexpr size_t kPage = 4096;

SDF3D_COLL_HD size_t round_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

// The flag value of step k in call epoch e: monotonic in (e, k), never 0.
SDF3D_COLL_HD u64 tag(u64 epoch, int k) { return (epoch << 20) + static_cast<u64>(k) + 1; }

// 16-byte items: a slot's data starts at the same offset from a 16-byte
// boundary as the vector it carries, so copies and adds run on 16-byte
// accesses from end to end.
template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};
template <typename T>
SDF3D_COLL_HD Pack<T> operator+(Pack<T> a, const Pack<T>& b) {
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) a.v[j] = a.v[j] + b.v[j];
  return a;
}

struct Layout {
  int n_ranks;
  int slots;         // receive slots per stream: N - 1 (K7), 2 (K8)
  int elem;          // bytes per element
  long long stride;  // elements between slots: a slot's capacity and a 16-byte phase, rounded to 16 bytes
  // The device region.
  SDF3D_COLL_HD size_t data(int parity, int stream, int slot) const {
    return kCounters + static_cast<size_t>((parity * 2 + stream) * slots + slot) * static_cast<size_t>(stride) * elem;
  }
  SDF3D_COLL_HD size_t bytes() const { return data(2, 0, 0); }
  // The shared host segment: one block of rank_bytes() per rank.
  SDF3D_COLL_HD size_t rank_bytes() const { return round_up(64 + static_cast<size_t>(4 * slots + 8) * 8, 128); }
  SDF3D_COLL_HD size_t status(int rank) const { return static_cast<size_t>(rank) * rank_bytes(); }
  SDF3D_COLL_HD size_t flag(int rank, int parity, int stream, int slot) const {
    return status(rank) + 64 + static_cast<size_t>((parity * 2 + stream) * slots + slot) * 8;
  }
  SDF3D_COLL_HD size_t ack(int rank, int parity, int stream, int slot) const {
    return status(rank) + 64 + static_cast<size_t>(4 * slots + (parity * 2 + stream) * 2 + slot) * 8;
  }
  SDF3D_COLL_HD size_t sync_bytes() const { return round_up(static_cast<size_t>(n_ranks) * rank_bytes(), kPage); }
};

SDF3D_COLL_HD Layout make_layout(int kind, int n_ranks, long long cap, int elem) {
  Layout l;
  l.n_ranks = n_ranks;
  l.slots = kind == kRing ? (n_ranks > 1 ? n_ranks - 1 : 1) : 2;
  l.elem = elem;
  const long long vec = 16 / elem;
  l.stride = static_cast<long long>(round_up(static_cast<size_t>(cap + vec - 1), static_cast<size_t>(vec)));
  return l;
}

// One call of one rank: its region and its right neighbour's, the shared host
// segment (the kernel's view of it), its input and output.
struct Args {
  char* self;
  char* right;
  char* sync;
  const void* x;
  void* out;
  long long n;      // K7: the vector's elements; K8: the padded vector's, 2·N·m
  long long valid;  // x's elements (K8: out beyond them is zero padding)
  int kind, n_ranks, rank, parity;
  Layout lay;
  u64 epoch;
};

// Slot `slot` of `base`'s region, holding the part of a vector that starts
// `off` elements into it (at the same 16-byte phase).
template <typename T>
SDF3D_COLL_HD T* slot_ptr(char* base, const Args& a, int stream, int slot, long long off) {
  return reinterpret_cast<T*>(base + a.lay.data(a.parity, stream, slot)) + off % (16 / static_cast<long long>(sizeof(T)));
}
SDF3D_COLL_HD u64* flag_ptr(char* sync, const Args& a, int rank, int stream, int slot) {
  return reinterpret_cast<u64*>(sync + a.lay.flag((rank + a.n_ranks) % a.n_ranks, a.parity, stream, slot));
}
SDF3D_COLL_HD u64* ack_ptr(char* sync, const Args& a, int rank, int stream, int slot) {
  return reinterpret_cast<u64*>(sync + a.lay.ack((rank + a.n_ranks) % a.n_ranks, a.parity, stream, slot));
}

// K8's chunk indices (sdf3d_tpu/parallel/collectives.py::_rs_ag_kernel):
// reduce-scatter step k < N-1 sends (d - k) and accumulates into (d - k - 1);
// all-gather step t = k - (N-1) sends (d + 1 - t) and stores into (d - t).
// The chunk a rank sends at step k + 1 is the one it received at step k.
SDF3D_COLL_HD int send_chunk(int d, int k, int n) {
  return k < n - 1 ? (d - k + 2 * n) % n : (d + 1 - (k - (n - 1)) + 2 * n) % n;
}
SDF3D_COLL_HD int recv_chunk(int d, int k, int n) {
  return k < n - 1 ? (d - k - 1 + 2 * n) % n : (d - (k - (n - 1)) + 2 * n) % n;
}

// Whether two addresses sit at the same offset from a 16-byte boundary.
SDF3D_COLL_HD bool same_phase(const void* a, const void* b) {
  return ((reinterpret_cast<unsigned long long>(a) ^ reinterpret_cast<unsigned long long>(b)) & 15) == 0;
}

// f(i, item) for the items of [0, n), split over the lanes: a T at element i
// of the scalar head and tail, a Pack<T> at element i of the 16-byte-aligned
// middle, where `p` is one of f's pointers and `vec` says that all of them
// share its phase (else every item is a T).  Element i is always handled by
// one lane, whatever f reads and writes there.
template <typename T, typename Ctx, typename F>
SDF3D_COLL_OPS void each_item(const Ctx& c, const T* p, long long n, bool vec, F f) {
  constexpr long long V = 16 / sizeof(T);
  const long long mis = static_cast<long long>((reinterpret_cast<unsigned long long>(p) & 15) / sizeof(T));
  long long head = vec ? (V - mis) % V : n;
  if (head > n) head = n;
  const long long packs = (n - head) / V, tail = head + packs * V;
  for (long long i = c.lane(); i < head; i += c.lanes()) f(i, T());
  for (long long j = c.lane(); j < packs; j += c.lanes()) f(head + j * V, Pack<T>());
  for (long long i = tail + c.lane(); i < n; i += c.lanes()) f(i, T());
}

// The number of segments of a call.
SDF3D_COLL_HD int segments(const Args& a) {
  if (a.kind == kRing) return a.n_ranks;
  const int total = 2 * (a.n_ranks - 1);
  return total > 0 ? total + 1 : 0;
}

// The most elements one stream moves in segment g (the kernel's grid).
SDF3D_COLL_HD long long segment_elems(const Args& a, int g) {
  return a.kind == kRing ? (a.n + 1) / 2 : (g == 0 ? a.n / 2 : a.n / (2 * a.n_ranks));
}

// Item u of x at element i, zero from element `valid` on (x: this rank's
// own input).
template <typename U, typename T>
SDF3D_COLL_OPS U padded(const T* x, long long i, long long valid) {
  constexpr int w = sizeof(U) / sizeof(T);
  if (i + w <= valid) return *reinterpret_cast<const U*>(x + i);
  U u;
  T* e = reinterpret_cast<T*>(&u);
  for (int j = 0; j < w; ++j) e[j] = i + j < valid ? x[i + j] : T(0);
  return u;
}

// K7, stream s (0: the first ceil(n/2) elements, 1: the rest), the ops of
// ring_schedule cut at its waits.  Segment g < N-1 is start(g): it forwards
// this rank's half (g = 0) or the arrival of step g - 1 into the right
// neighbour's slot g.  The last segment, after the last wait, adds the N
// contributions in rank order: slot k holds the contribution of rank
// (d - k - 1) mod N, so every rank adds in the same order and holds the same
// bits.  One slot per step: no slot is rewritten within a call, so no acks.
template <typename T, typename Ctx>
SDF3D_COLL_OPS void ring_segment(const Ctx& c, const Args& a, int s, int g) {
  const int N = a.n_ranks, d = a.rank;
  const long long h = (a.n + 1) / 2, lo = s == 0 ? 0 : h, len = s == 0 ? h : a.n - h;
  const T* x = static_cast<const T*>(a.x) + lo;
  if (g < N - 1) {
    const T* src = g == 0 ? x : slot_ptr<T>(a.self, a, s, g - 1, lo);
    T* dst = slot_ptr<T>(a.right, a, s, g, lo);
    each_item<T>(c, dst, len, same_phase(src, dst), [&](long long i, auto item) {
      using U = decltype(item);
      *reinterpret_cast<U*>(dst + i) = c.load(reinterpret_cast<const U*>(src + i));
    });
    return;
  }
  T* out = static_cast<T*>(a.out) + lo;
  auto part = [&](int r) -> const T* { return r == d ? x : slot_ptr<T>(a.self, a, s, (d - r - 1 + N) % N, lo); };
  bool vec = true;
  for (int r = 0; r < N; ++r) vec = vec && same_phase(out, part(r));
  each_item<T>(c, out, len, vec, [&](long long i, auto item) {
    using U = decltype(item);
    U acc = c.load(reinterpret_cast<const U*>(part(0) + i));
    for (int r = 1; r < N; ++r) acc = acc + c.load(reinterpret_cast<const U*>(part(r) + i));
    *reinterpret_cast<U*>(out + i) = acc;
  });
}

// K8, stream s (chunks [s·N, (s+1)·N) of m elements of `out`, the padded
// vector), the ops of rs_ag_schedule(backpressure=True) cut at its waits.
// Segment 0 writes this rank's input, zero-padded, into `out` and does
// start(0) from the input.  Segment g >= 1 does accum (reduce-scatter) or
// copy (all-gather) of step g - 1, its bp_signal, and start(g) (g <
// 2(N-1)): slots alternate by step % 2.  Each element's accum and its
// forward run on one lane, so the chunk start(g) sends (the one step g - 1
// received) is whole there.  Each chunk is reduced along one path and then
// copied around: the same bits on every rank.
template <typename T, typename Ctx>
SDF3D_COLL_OPS void rs_ag_segment(const Ctx& c, const Args& a, int s, int g) {
  const int N = a.n_ranks, d = a.rank, total = 2 * (N - 1), k = g - 1;
  const long long m = a.n / (2 * N), base = static_cast<long long>(s) * N * m;
  T* chunks = static_cast<T*>(a.out) + base;
  if (g == 0) {
    const T* x = static_cast<const T*>(a.x) + base;
    const long long valid = a.valid - base, off = send_chunk(d, 0, N) * m;
    each_item<T>(c, chunks, N * m, same_phase(chunks, x), [&](long long i, auto item) {
      using U = decltype(item);
      *reinterpret_cast<U*>(chunks + i) = padded<U>(x, i, valid);
    });
    T* to = slot_ptr<T>(a.right, a, s, 0, base + off);
    each_item<T>(c, to, m, same_phase(x + off, to), [&](long long i, auto item) {
      using U = decltype(item);
      *reinterpret_cast<U*>(to + i) = padded<U>(x + off, i, valid - off);
    });
    return;
  }
  const bool add = k < N - 1, start = g < total;
  const long long recv_off = recv_chunk(d, k, N) * m, send_off = start ? send_chunk(d, g, N) * m : 0;
  T* dst = chunks + recv_off;
  const T* src = slot_ptr<T>(a.self, a, s, k % 2, base + recv_off);
  const T* send = chunks + send_off;
  T* to = slot_ptr<T>(a.right, a, s, g % 2, base + send_off);
  const bool vec = same_phase(dst, src) && (!start || (same_phase(send, to) && same_phase(dst, send)));
  each_item<T>(c, dst, m, vec, [&](long long i, auto item) {
    using U = decltype(item);
    U v = c.load(reinterpret_cast<const U*>(src + i));
    if (add) v = *reinterpret_cast<const U*>(dst + i) + v;
    *reinterpret_cast<U*>(dst + i) = v;
    if (start) {
      if (send != dst) v = *reinterpret_cast<const U*>(send + i);
      *reinterpret_cast<U*>(to + i) = v;
    }
  });
}

template <typename T, typename Ctx>
SDF3D_COLL_OPS void segment(const Ctx& c, const Args& a, int s, int g) {
  if (a.kind == kRing)
    ring_segment<T>(c, a, s, g);
  else
    rs_ag_segment<T>(c, a, s, g);
}

// A flag store: where and what.
struct Signal {
  u64* at;
  u64 value;
};

// The flags segment g of stream s stores once all of its work is done (in
// the shared segment `sync`): K7's arrival of step g in the right
// neighbour's slot g; K8's ack of step g - 1 to the left neighbour (while a
// later step reuses the slot) and its arrival of step g.
SDF3D_COLL_HD int segment_signals(const Args& a, char* sync, int s, int g, Signal* out) {
  int n = 0;
  if (a.kind == kRing) {
    if (g < a.n_ranks - 1) out[n++] = {flag_ptr(sync, a, a.rank + 1, s, g), tag(a.epoch, g)};
    return n;
  }
  const int total = 2 * (a.n_ranks - 1);
  if (g >= 1 && g + 1 < total) out[n++] = {ack_ptr(sync, a, a.rank - 1, s, (g - 1) % 2), tag(a.epoch, g - 1)};
  if (g < total) out[n++] = {flag_ptr(sync, a, a.rank + 1, s, g % 2), tag(a.epoch, g)};
  return n;
}

// A host wait: the flag, the value it must reach, and what it is (the
// status words of a timeout).
struct Need {
  const u64* at;
  u64 value;
  int op, step;
};

// What segment g of stream s waits for, in this rank's block of the shared
// segment `sync`: the arrival of step g - 1 (g >= 1) and, for K8 before
// start(g) rewrites slot g % 2 (g >= 2), the right neighbour's ack of step
// g - 2.
SDF3D_COLL_HD int segment_needs(const Args& a, char* sync, int s, int g, Need* out) {
  int n = 0;
  if (g < 1) return n;
  const int slot = a.kind == kRing ? g - 1 : (g - 1) % 2;
  out[n++] = {flag_ptr(sync, a, a.rank, s, slot), tag(a.epoch, g - 1), kOpWait, g - 1};
  if (a.kind == kRsAg && g >= 2 && g < 2 * (a.n_ranks - 1))
    out[n++] = {ack_ptr(sync, a, a.rank, s, g % 2), tag(a.epoch, g - 2), kOpAckWait, g};
  return n;
}

}  // namespace sdf3d_coll

// ---- The host's side of a call: wait, launch, wait, launch. ----
#include <chrono>
#include <thread>

namespace sdf3d_coll {

// Polls until every need of both streams is met (acquire loads): a short
// spin, then yielding the CPU.  At `spin_ns` it writes the status words of
// every stream still waiting (its first unmet need) and returns false.
inline bool host_wait(const Args& a, char* sync, int g, long long spin_ns) {
  Need need[2][2];
  int count[2];
  for (int s = 0; s < 2; ++s) count[s] = segment_needs(a, sync, s, g, need[s]);
  if (count[0] + count[1] == 0) return true;
  auto unmet = [&](int s) -> const Need* {
    for (int i = 0; i < count[s]; ++i)
      if (__atomic_load_n(need[s][i].at, __ATOMIC_ACQUIRE) < need[s][i].value) return &need[s][i];
    return nullptr;
  };
  const auto t0 = std::chrono::steady_clock::now();
  for (long long it = 0;; ++it) {
    if (unmet(0) == nullptr && unmet(1) == nullptr) return true;
    if (it < 256) continue;  // spin about a microsecond before giving the CPU away
    const long long ns =
        std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now() - t0).count();
    if (ns > spin_ns) break;
    std::this_thread::yield();
  }
  int* status = reinterpret_cast<int*>(sync + a.lay.status(a.rank));
  for (int s = 0; s < 2; ++s) {
    const Need* n = unmet(s);
    if (n == nullptr) continue;
    int* w = status + s * kStatusInts;
    w[1] = n->op;
    w[2] = n->step;
    w[0] = 1;
  }
  return false;
}

// One call of one rank: clears its status words, then for each segment waits
// on the host (`sync`: the host's view of the shared segment) and runs
// launch(g).  Returns 0, -1 when a wait timed out (status words written) or
// launch's nonzero result.
template <typename Launch>
inline int walk(const Args& a, char* sync, long long spin_ns, Launch launch) {
  int* status = reinterpret_cast<int*>(sync + a.lay.status(a.rank));
  for (int i = 0; i < 2 * kStatusInts; ++i) status[i] = 0;
  for (int g = 0; g < segments(a); ++g) {
    if (!host_wait(a, sync, g, spin_ns)) return -1;
    const int err = launch(g);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace sdf3d_coll
