// The shift-AND core shared by the Hopper scan kernels (sm_90a):
// bitap.cu (G1, G2), staged.cu (G3, G4) and fingerprint.cu (G5, G6).
//
// Per stream s, per byte b and limb k:
//   cm = lo[k][b & 15] & hi[k][b >> 4]
//   m' = ((m << 1) | (m[k-1] >> 31) | start[k]) & cm
// State is uint32_t, so `>> 31` is a logical shift. For K <= 64 the limbs
// live in registers (template buckets KR over K, fully unrolled limb loop)
// and lo/hi sit in shared memory: 16 consecutive words per limb fall in 16
// distinct banks and equal addresses broadcast, so the per-byte lookups
// are free of bank conflicts. Beyond 64 limbs (G1-G4; G5/G6 hold at most
// 64) a stream's limbs are split over a limb group of G lanes of a warp,
// each holding KR of them in registers (the group helpers below), and
// step_rows takes the carry into a lane's first limb from the lane below.
// No kernel keeps limb state in device memory.
//
// Every kernel runs one thread per (segment, stream) (kSegThreads per
// block; the limb groups one per (segment, stream, lane of the group),
// kGroupThreads per block). Each L-byte stream is cut into P segments of
// Ls bytes (segment_plan and scan_plan in ops/bitap_kernels.py); a
// segment warms up over the H
// bytes before it, which is exact because a state bit at chain offset i
// depends only on the last i + 1 bytes, whatever the state before them,
// and i <= max_len - 1 <= H: the warm-up plus the byte itself cover them.
// The step (step_padded) runs every limb of the bucket with no per-limb
// branch. Words reach the byte loop through a per-thread cp.async ring in
// shared memory, so loads stay in flight while the thread computes. Two
// layouts feed it:
//   - stream-major words, word[w][s], as the JAX package lays them out
//     (G1/G2, G5/G6: walk_rows). A warp's 32 loads of one word row are one
//     coalesced 128-byte transaction.
//   - the uploaded words as they lie, row s = stream s (G3/G4: walk_run,
//     and walk_run_group for their limb groups). A segment's walk, warm-up
//     included, is then one contiguous run of words, copied 32 bytes (one
//     sector) per ring slot, so each sector is fetched once although a
//     warp's 32 runs lie L bytes apart.
// What bounds these kernels is instruction issue (bitap.cu, staged.cu,
// fingerprint.cu).

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace shift_and {

constexpr int kLanes = 1024;   // streams per [8, 128] tile

// Limb state and per-limb constants of one thread, in registers.
template <int KR>
struct Limbs {
  uint32_t m[KR];
  uint32_t sm[KR];
  uint32_t em[KR];
};

// ---------------------------------------------------------------------------
// Segments: each L-byte stream is cut into P segments of Ls = L / P bytes,
// one thread per (segment, stream).
// ---------------------------------------------------------------------------
constexpr int kSegThreads = 128;  // threads per block

// The (segment, stream) of this thread. Warps are 32 consecutive streams of
// one segment, so a warp's load of one stream-major word row is one
// 128-byte transaction and its stores of per-position outputs
// ([.., t, .., lane], lane-fastest) coalesce; the segments of a stream
// group sit in neighbouring warps, so segment j's warm-up words (segment
// j-1's last words) are read close in time.
struct Segment {
  int t;   // thread, 0 .. S*P-1
  int s;   // stream
  int j;   // segment
  int w0;  // first body word of the segment
  int nw;  // body words per segment, Wb / P
};

__device__ __forceinline__ bool segment_of(int S, int P, int Wb,
                                           Segment& g) {
  g.t = blockIdx.x * kSegThreads + threadIdx.x;
  if (g.t >= S * P) return false;
  const int warp = g.t >> 5;
  g.j = warp % P;
  g.s = (warp / P) * 32 + (g.t & 31);
  g.nw = Wb / P;
  g.w0 = g.j * g.nw;
  return true;
}

inline int seg_blocks_for(int S, int P) {
  return (S * P + kSegThreads - 1) / kSegThreads;
}

// ---------------------------------------------------------------------------
// The step: all KR register limbs with no per-limb guard. Limbs K..KR-1
// get zero tables and zero start and end masks, so they stay 0 and report
// nothing. A guard `k < K` compiles to a branch per limb and byte, and
// with it a recomputed table address and a register copy of the new
// state.
// ---------------------------------------------------------------------------

// The nybble tables, copied into the block's shared memory `tab` and
// padded with zeros to KR limbs: lo at tab, hi at tab + 16 * KR. Every
// thread of the block must call this before any of them returns.
template <int KR>
__device__ __forceinline__ void load_tables_padded(const uint32_t* lo,
                                                   const uint32_t* hi, int K,
                                                   uint32_t* tab,
                                                   const uint32_t*& LO,
                                                   const uint32_t*& HI) {
  for (int i = threadIdx.x; i < KR * 16; i += kSegThreads) {
    const bool live = i < K * 16;
    tab[i] = live ? lo[i] : 0u;
    tab[KR * 16 + i] = live ? hi[i] : 0u;
  }
  __syncthreads();
  LO = tab;
  HI = tab + KR * 16;
}

// Zero state and the start/end masks of limbs [k0, k0 + KR) into
// registers, those at or past limb K zero.
template <int KR>
__device__ __forceinline__ void init_padded(Limbs<KR>& st,
                                            const uint32_t* sm,
                                            const uint32_t* em, int K,
                                            int k0 = 0) {
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    st.m[k] = 0u;
    st.sm[k] = k0 + k < K ? sm[k0 + k] : 0u;
    st.em[k] = k0 + k < K ? em[k0 + k] : 0u;
  }
}

template <int KR>
__device__ __forceinline__ void reset(Limbs<KR>& st) {
#pragma unroll
  for (int k = 0; k < KR; ++k) st.m[k] = 0u;
}

// Advance the KR register limbs by one byte, given the rows of the byte's
// two nybbles in the tables (lo = LO + (b & 15), hi = HI + (b >> 4));
// on_limb(k, m') sees each new limb word in limb order. The funnel shift
// forms (m << 1) | (the old m of the limb below >> 31) at once; `below` is
// the old m of the limb below limb 0 (a limb group's lane below, else 0).
template <int KR, typename F>
__device__ __forceinline__ void step_rows(Limbs<KR>& st, const uint32_t* lo,
                                          const uint32_t* hi, F&& on_limb,
                                          uint32_t below = 0u) {
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const uint32_t old = st.m[k];
    const uint32_t nm = (__funnelshift_l(below, old, 1) | st.sm[k]) &
                        lo[16 * k] & hi[16 * k];
    below = old;
    st.m[k] = nm;
    on_limb(k, nm);
  }
}

// Advance limbs [0, KR) by byte b, as step_rows does, the tables at LO/HI.
template <int KR, typename F>
__device__ __forceinline__ void step_padded(Limbs<KR>& st, const uint32_t* LO,
                                            const uint32_t* HI, uint32_t b,
                                            F&& on_limb) {
  step_rows<KR>(st, LO + (b & 15u), HI + (b >> 4), on_limb);
}

// The four bytes of a word, their nybbles split and scaled to byte offsets
// of table rows once per word (two operations). A byte's row is then one
// byte permutation away, and when the tables are a static __shared__
// array the row's offset folds into the shared load's address: two
// instructions per byte where a shift, a mask and an address computation
// per nybble cost about seven.
struct Nybbles {
  uint32_t lo;  // byte jj: 4 * (b_jj & 15)
  uint32_t hi;  // byte jj: 4 * (b_jj >> 4)
  __device__ __forceinline__ explicit Nybbles(uint32_t w)
      : lo((w << 2) & 0x3C3C3C3Cu), hi((w >> 2) & 0x3C3C3C3Cu) {}
  __device__ __forceinline__ static const uint32_t* row(const uint32_t* T,
                                                        uint32_t packed,
                                                        int jj) {
    const uint32_t off = __byte_perm(packed, 0u, 0x4440u + jj);  // byte jj
    return reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const char*>(T) + off);
  }
  __device__ __forceinline__ const uint32_t* lo_row(const uint32_t* LO,
                                                    int jj) const {
    return row(LO, lo, jj);
  }
  __device__ __forceinline__ const uint32_t* hi_row(const uint32_t* HI,
                                                    int jj) const {
    return row(HI, hi, jj);
  }
};

// ---------------------------------------------------------------------------
// The cp.async rings: each thread copies the words ahead of the one it
// scans into its own slots of a ring in shared memory and reads back only
// those, so cp.async.wait_group is the only synchronisation needed.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint4* dst, const uint4* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stream-major words (bitap.cu, fingerprint.cu). Row i of a segment's
// walk, a pointer into `halo` (i < Hw, segment 0) or `body` (everything
// else). The walk is Hw warm-up rows, then the segment's nw body rows:
// segment 0 warms up over the halo (the tail of stream s-1), segment j > 0
// over the Hw body rows before its own.
struct SegmentRows {
  const uint32_t* halo;
  const uint32_t* body;
  size_t S;
  int Hw;
  int w0;
  bool first;  // segment 0
  __device__ __forceinline__ const uint32_t* row(int i, int s) const {
    if (first && i < Hw) return halo + static_cast<size_t>(i) * S + s;
    return body + static_cast<size_t>(w0 + i - Hw) * S + s;
  }
};

// Words in flight: kRing - 1 rows ahead of the one scanned, one word per
// slot ([kRing][kThreads] words, kThreads the block's threads,
// conflict-free).
constexpr int kRing = 4;

// Walk rows [0, count) in order, calling on_word(i, word).
template <int kThreads = kSegThreads, typename F>
__device__ __forceinline__ void walk_rows(const SegmentRows& r, int s,
                                          int count, uint32_t* ring,
                                          F&& on_word) {
  uint32_t* mine = ring + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < count) cp_async4(mine + i * kThreads, r.row(i, s));
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    // Commit group g carries row g. Slot (i + kRing - 1) % kRing was read
    // one word ago and used; after this commit, waiting until at most
    // kRing - 1 groups are pending completes row i.
    const int ahead = i + kRing - 1;
    if (ahead < count) {
      cp_async4(mine + (ahead % kRing) * kThreads, r.row(ahead, s));
    }
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    on_word(i, mine[(i % kRing) * kThreads]);
  }
}

// Dynamic shared memory of a stream-major segmented block: the padded
// tables, then the ring.
inline size_t seg_shmem_bytes(int KR) {
  return static_cast<size_t>(KR) * 32 * sizeof(uint32_t) +
         static_cast<size_t>(kRing) * kSegThreads * sizeof(uint32_t);
}

// Row-major words (staged.cu). A ring slot is 8 words, one 32-byte sector
// of the thread's run, copied by two 16-byte cp.async issued together and
// read back as two 16-byte quads. The ring is [kRunRing][2][kSegThreads]
// quads, so both the copies and the reads of a warp touch 32 consecutive
// quads: no bank conflicts.
constexpr int kRunSlot = 8;   // words per slot
constexpr int kRunRing = 3;   // slots per thread: two in flight

// Walk the words [w0, w1) of x in order, w1 a multiple of kRunSlot. The
// words before the first whole slot (fewer than kRunSlot) are read
// directly, on_word(w, word); then every slot is scanned as two quads,
// on_quad(w, v) with w the index of v.x. x must be 16-byte aligned.
template <typename W, typename Q>
__device__ __forceinline__ void walk_run(const uint32_t* x, long long w0,
                                         long long w1, uint4* ring,
                                         W&& on_word, Q&& on_quad) {
  const long long a = (w0 + kRunSlot - 1) / kRunSlot * kRunSlot;
  const int slots = static_cast<int>((w1 - a) / kRunSlot);
  const uint4* src = reinterpret_cast<const uint4*>(x + a);
  uint4* mine = ring + threadIdx.x;
  auto fetch = [&](int i) {
    uint4* d = mine + (i % kRunRing) * 2 * kSegThreads;
    cp_async16(d, src + 2 * i);
    cp_async16(d + kSegThreads, src + 2 * i + 1);
  };
#pragma unroll
  for (int i = 0; i < kRunRing - 1; ++i) {
    if (i < slots) fetch(i);
    cp_async_commit();
  }
  // The leading words, while the first slots are in flight.
#pragma unroll 1
  for (long long w = w0; w < a; ++w) on_word(w, __ldg(x + w));
  for (int i = 0; i < slots; ++i) {
    // As in walk_rows: commit group g carries slot g, and slot
    // (i + kRunRing - 1) % kRunRing was read and used one slot ago.
    const int ahead = i + kRunRing - 1;
    if (ahead < slots) fetch(ahead);
    cp_async_commit();
    cp_async_wait<kRunRing - 1>();
    const uint4* d = mine + (i % kRunRing) * 2 * kSegThreads;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      on_quad(a + static_cast<long long>(i) * kRunSlot + 4 * h,
              d[h * kSegThreads]);
    }
  }
}

// ---------------------------------------------------------------------------
// Limb groups (K > 64, G1-G4): a stream's K limbs go to G consecutive lanes
// of one warp, G the least power of two with G * KR >= K (limb_group in
// ops/bitap_kernels.py), lane g holding limbs [g*KR, (g+1)*KR) in
// registers. The step reads the OLD state of the limb below, so a lane's
// carry into its first limb is the old top limb of lane g - 1: one
// __shfl_up_sync per byte (group_carry), before the lane's limb loop.
// Lanes whose slice starts at or past limb K get zero start and end masks
// and read slice 0's tables: nothing they compute is reported, and carries
// only flow upward, so they disturb no live limb. Every lane of a warp
// walks the same number of bytes (one segment, the same warm-up), so the
// shuffles run converged.
// ---------------------------------------------------------------------------
constexpr int kGroupThreads = 256;  // threads per block
constexpr unsigned kWarp = 0xFFFFFFFFu;

// Words of one lane's slice of lo (or hi) in shared memory: KR limbs of 16
// words, padded so that the G slices of a group start 32 / G banks apart:
// the G lanes of a stream read the same nybble row of their G slices,
// which then fall in G different banks (an unpadded stride of 16 * KR
// words puts them all in one).
__host__ __device__ constexpr int group_stride(int KR, int G) {
  return 16 * KR + 32 / G;
}

// The (segment, stream, lane of the group) of this thread. A warp holds
// 32 / G consecutive streams of one segment, each on G consecutive lanes;
// the segments of a run of streams sit in neighbouring warps, as in
// segment_of.
struct GroupSegment {
  int s;   // stream
  int j;   // segment
  int g;   // lane in the group: limbs [g*KR, (g+1)*KR)
  int w0;  // first body word of the segment
  int nw;  // body words per segment, Wb / P
};

__device__ __forceinline__ bool group_of(int S, int P, int G, int Wb,
                                         GroupSegment& q) {
  const int t = blockIdx.x * kGroupThreads + threadIdx.x;
  if (t >= S * P * G) return false;  // whole warps: S is a multiple of 1024
  const int warp = t >> 5;
  const int lane = t & 31;
  q.j = warp % P;
  q.s = (warp / P) * (32 / G) + lane / G;
  q.g = lane & (G - 1);
  q.nw = Wb / P;
  q.w0 = q.j * q.nw;
  return true;
}

// Copy the live slices of lo and hi ([K, 16] each) into shared memory:
// lo's slices at tab, `stride` words apart, hi's after them, limbs past
// K - 1 zero. Every thread of the block must call this before any of them
// returns.
template <int KR>
__device__ __forceinline__ void load_group_tables(const uint32_t* lo,
                                                  const uint32_t* hi, int K,
                                                  int stride, uint32_t* tab) {
  const int live = (K + KR - 1) / KR;
  for (int i = threadIdx.x; i < live * 16 * KR; i += kGroupThreads) {
    const int at = i / (16 * KR) * stride + i % (16 * KR);
    const bool on = i < 16 * K;
    tab[at] = on ? lo[i] : 0u;
    tab[live * stride + at] = on ? hi[i] : 0u;
  }
  __syncthreads();
}

// The carry into lane g's first limb: the old top limb of lane g - 1 (0
// for the group's first lane). Call before the lane's limbs change.
template <int KR>
__device__ __forceinline__ uint32_t group_carry(const Limbs<KR>& st, int g,
                                                int G) {
  const uint32_t c = __shfl_up_sync(kWarp, st.m[KR - 1], 1, G);
  return g == 0 ? 0u : c;
}

// The sum of v over the lanes of the group below lane g.
__device__ __forceinline__ int group_sum_below(int v, int g, int G) {
  int incl = v;
  for (int d = 1; d < G; d <<= 1) {
    const int u = __shfl_up_sync(kWarp, incl, d, G);
    incl += g >= d ? u : 0;
  }
  return incl - v;
}

// The sum (OR) of v over the group, in every lane of it.
__device__ __forceinline__ int group_sum(int v, int G) {
  for (int d = G >> 1; d > 0; d >>= 1) v += __shfl_xor_sync(kWarp, v, d, G);
  return v;
}
__device__ __forceinline__ uint32_t group_or(uint32_t v, int G) {
  for (int d = G >> 1; d > 0; d >>= 1) v |= __shfl_xor_sync(kWarp, v, d, G);
  return v;
}

// Beyond the default 48 KiB a block must opt into its dynamic shared
// memory. `opted` (one array per kernel instance, static in its launcher)
// remembers the size opted into per device, so that launches captured
// into a graph after a first launch make no attribute call.
constexpr int kMaxDevices = 64;
template <typename Kernel>
inline cudaError_t opt_in_shared(Kernel kernel, size_t bytes,
                                 int (&opted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (bytes > (48u << 10) &&
      (dev >= kMaxDevices || opted[dev] < static_cast<int>(bytes))) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) opted[dev] = static_cast<int>(bytes);
  }
  return cudaSuccess;
}

// Quads of the ring of a limb-group block reading row-major words:
// kRunRing slots of two quads per column, one column per stream of the
// block, shared by the stream's G lanes.
__host__ __device__ constexpr int group_ring_quads(int G) {
  return kRunRing * 2 * (kGroupThreads / G);
}

// walk_run for a limb group (staged.cu beyond 64 limbs). The G lanes of a
// stream share one ring column (group_ring_quads): lanes 0 and 1 of the
// group each copy one 16-byte half of a slot, and after its own wait every
// lane meets the others at __syncwarp, which makes the copies of slot i
// visible and shows that every lane has read slot i - 1, whose quads the
// next copy overwrites. (A column per lane, every lane copying whole
// slots, measured 0.3-3.6% slower; PERF.md.) Word indices below 0 (the
// wrapped warm-up of stream 0, whose steps the kernels discard) read word
// 0 instead. The number of leading words and of slots depends only on
// w0 % 8 and w1 - w0, which every lane of a warp shares.
template <typename W, typename Q>
__device__ __forceinline__ void walk_run_group(const uint32_t* x,
                                               long long w0, long long w1,
                                               uint4* ring, int G,
                                               W&& on_word, Q&& on_quad) {
  const long long a = w0 + ((-w0) & (kRunSlot - 1));  // w0 rounded up
  const int slots = static_cast<int>((w1 - a) / kRunSlot);
  const int cols = kGroupThreads / G;
  const int g = threadIdx.x & (G - 1);
  uint4* mine = ring + threadIdx.x / G;
  auto at = [&](long long w) { return x + (w < 0 ? 0 : w); };
  auto fetch = [&](int i) {
    if (g < 2) {
      cp_async16(mine + ((i % kRunRing) * 2 + g) * cols,
                 reinterpret_cast<const uint4*>(at(a + kRunSlot * i)) + g);
    }
  };
#pragma unroll
  for (int i = 0; i < kRunRing - 1; ++i) {
    if (i < slots) fetch(i);
    cp_async_commit();
  }
#pragma unroll 1
  for (long long w = w0; w < a; ++w) on_word(w, __ldg(at(w)));
  for (int i = 0; i < slots; ++i) {
    // Commit groups 0 .. i + kRunRing - 2 are issued; waiting until at
    // most kRunRing - 2 are pending completes slot i.
    cp_async_wait<kRunRing - 2>();
    __syncwarp();
    const int ahead = i + kRunRing - 1;
    if (ahead < slots) fetch(ahead);
    cp_async_commit();
    const uint4* d = mine + (i % kRunRing) * 2 * cols;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      on_quad(a + static_cast<long long>(i) * kRunSlot + 4 * h, d[h * cols]);
    }
  }
}

}  // namespace shift_and

// Run the statement(s) after K with `KR` bound to the register bucket for
// K limbs (1, 2, 3, 4, 8, 16, 32, 64); beyond 64 the calling function
// returns cudaErrorInvalidValue (limb groups launch their own kernels).
#define SHIFT_AND_FOR_BUCKET(K, ...)                      \
  do {                                                    \
    if ((K) <= 1) {                                       \
      constexpr int KR = 1;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 2) {                                \
      constexpr int KR = 2;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 3) {                                \
      constexpr int KR = 3;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 4) {                                \
      constexpr int KR = 4;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 8) {                                \
      constexpr int KR = 8;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 16) {                               \
      constexpr int KR = 16;                              \
      __VA_ARGS__;                                        \
    } else if ((K) <= 32) {                               \
      constexpr int KR = 32;                              \
      __VA_ARGS__;                                        \
    } else if ((K) <= 64) {                               \
      constexpr int KR = 64;                              \
      __VA_ARGS__;                                        \
    } else {                                              \
      return cudaErrorInvalidValue;                       \
    }                                                     \
  } while (0)
