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
// are free of bank conflicts. Beyond 64 limbs G1/G2 (bitap.cu) split a
// stream's limbs over a group of lanes, each holding KR of them in
// registers, and step_rows takes the carry into a lane's first limb from
// the lane below. G3/G4 (staged.cu) still keep the state of K > 64 limbs
// in a global scratch (KR == 0), one row per limb coalesced across
// threads, and read the tables through the read-only cache; Limbs<0> and
// the scratch's wrappers (spill_state, segment_state in
// ops/bitap_kernels.py) stay only for them.
//
// Every kernel runs one thread per (segment, stream) (kSegThreads per
// block; the limb groups of bitap.cu one per (segment, stream, lane of the
// group)). Each L-byte stream is cut into P segments of Ls bytes
// (segment_plan in ops/bitap_kernels.py); a segment warms up over the H
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
//   - the uploaded words as they lie, row s = stream s (G3/G4: walk_run).
//     A segment's walk, warm-up included, is then one contiguous run of
//     words, copied 32 bytes (one sector) per ring slot, so each sector
//     is fetched once although a warp's 32 runs lie L bytes apart.
// What bounds these kernels is instruction issue (bitap.cu, staged.cu,
// fingerprint.cu).

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace shift_and {

constexpr int kLanes = 1024;   // streams per [8, 128] tile

// Limb state and per-limb constants: registers for KR > 0 (K <= KR),
// global memory for KR == 0 (staged.cu's K > 64 path).
template <int KR>
struct Limbs {
  uint32_t m[KR > 0 ? KR : 1];
  uint32_t sm[KR > 0 ? KR : 1];
  uint32_t em[KR > 0 ? KR : 1];
  uint32_t* g;
  const uint32_t* gsm;
  const uint32_t* gem;
  int S;

  __device__ __forceinline__ uint32_t& at(int k) {
    if constexpr (KR > 0) {
      return m[k];
    } else {
      return g[static_cast<size_t>(k) * S];
    }
  }
  __device__ __forceinline__ uint32_t start(int k) const {
    if constexpr (KR > 0) {
      return sm[k];
    } else {
      return __ldg(gsm + k);
    }
  }
  __device__ __forceinline__ uint32_t end(int k) const {
    if constexpr (KR > 0) {
      return em[k];
    } else {
      return __ldg(gem + k);
    }
  }
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
// j-1's last words) are read close in time. `t` indexes the thread's limb
// scratch on the spill path.
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

// The nybble tables, for KR > 0 copied into the block's shared memory
// `tab` and padded with zeros to KR limbs: lo at tab, hi at tab + 16 * KR.
// Every thread of the block must call this before any of them returns.
template <int KR>
__device__ __forceinline__ void load_tables_padded(const uint32_t* lo,
                                                   const uint32_t* hi, int K,
                                                   uint32_t* tab,
                                                   const uint32_t*& LO,
                                                   const uint32_t*& HI) {
  LO = lo;
  HI = hi;
  if constexpr (KR > 0) {
    for (int i = threadIdx.x; i < KR * 16; i += kSegThreads) {
      const bool live = i < K * 16;
      tab[i] = live ? lo[i] : 0u;
      tab[KR * 16 + i] = live ? hi[i] : 0u;
    }
    __syncthreads();
    LO = tab;
    HI = tab + KR * 16;
  }
}

// Zero state (thread t's column of the scratch `state`, rows of `row`
// words, for KR == 0); for KR > 0 the start/end masks into registers, those
// of limbs K..KR-1 zero.
template <int KR>
__device__ __forceinline__ void init_padded(Limbs<KR>& st,
                                            const uint32_t* sm,
                                            const uint32_t* em,
                                            uint32_t* state, int t, int row,
                                            int K) {
  st.g = state + t;
  st.gsm = sm;
  st.gem = em;
  st.S = row;
  if constexpr (KR > 0) {
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      st.m[k] = 0u;
      st.sm[k] = k < K ? sm[k] : 0u;
      st.em[k] = k < K ? em[k] : 0u;
    }
  } else {
    for (int k = 0; k < K; ++k) st.at(k) = 0u;
  }
}

template <int KR>
__device__ __forceinline__ void reset(Limbs<KR>& st, int K) {
  if constexpr (KR > 0) {
#pragma unroll
    for (int k = 0; k < KR; ++k) st.m[k] = 0u;
  } else {
    for (int k = 0; k < K; ++k) st.at(k) = 0u;
  }
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
  static_assert(KR > 0, "register limbs only");
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

// Advance limbs [0, KR) (the K limbs of the spill path) by byte b, as
// step_rows does.
template <int KR, typename F>
__device__ __forceinline__ void step_padded(Limbs<KR>& st, const uint32_t* LO,
                                            const uint32_t* HI, int K,
                                            uint32_t b, F&& on_limb) {
  if constexpr (KR == 0) {
    uint32_t below = 0u;
    for (int k = 0; k < K; ++k) {
      const uint32_t old = st.at(k);
      const uint32_t nm = (__funnelshift_l(below, old, 1) | st.start(k)) &
                          __ldg(LO + k * 16 + (b & 15u)) &
                          __ldg(HI + k * 16 + (b >> 4));
      below = old;
      st.at(k) = nm;
      on_limb(k, nm);
    }
  } else {
    step_rows<KR>(st, LO + (b & 15u), HI + (b >> 4), on_limb);
  }
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

}  // namespace shift_and

// Run the statement(s) after K with `KR` bound to the register bucket for
// K limbs (1, 2, 3, 4, 8, 16, 32, 64), or to 0 (staged.cu's spill path)
// beyond 64.
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
      constexpr int KR = 0;                               \
      __VA_ARGS__;                                        \
    }                                                     \
  } while (0)
