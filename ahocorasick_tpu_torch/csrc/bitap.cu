// Exact bit-parallel shift-AND scan for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   G1  ahocorasick_tpu/ops/bitap.py::_make_kernel        -> bitap_generic_scan
//       tables at run time, positions masked to the window [n0, n),
//       extract writes the end word of every limb: [tiles, L, K, 8, 128];
//   G2  ahocorasick_tpu/ops/bitap.py::_make_baked_kernel  -> bitap_baked_scan
//       the haystack is padded with a byte whose charmask is zero in every
//       limb, so no position mask; extract writes only the end-bearing
//       limbs, in limb order: [tiles, L, Ke, 8, 128].
// Both compute, per stream s (an L-byte block at s*L, warmed up over the
// H bytes before it), for every byte b and limb k:
//   cm = lo[k][b & 15] & hi[k][b >> 4]
//   m' = ((m << 1) | (m[k-1] >> 31) | start[k]) & cm
// and count popc(m' & end[k]) (or write it as the end word). G2 differs
// from G1 only by the missing mask and the dense end-limb word axis; the
// TPU version's compile-time constant tables are later work, so both
// take their tables at run time here.
//
// What bounds it on an H100: instruction issue. At the least a byte costs
// two integer operations (the nybble indices) and, per limb, a funnel
// shift, two three-input logic operations, two shared-memory loads of
// lo/hi, and the count's and, popc and half an add: 4.5 logic operations
// per limb at 64 per SM and clock, one popc at 16, two loads at 32
// (step_cycles in chip_smoke.py). So with K >= 1 the SMs, not the
// 3.35 TB/s of memory, set the floor; extraction adds 4K (G1) or 4Ke (G2)
// bytes written per byte scanned, which makes the 8 MiB extraction chunk
// bytes-bound.
//
// Design:
//   - One thread per (segment, stream). The JAX layout has one stream per
//     lane, 1,024 per tile, and only 1,024 streams at 2 MiB; one thread
//     each left the card nearly idle. Each L-byte stream is cut into P
//     segments of Ls = L / P bytes (segment_plan in ops/bitap_kernels.py:
//     the most segments with Ls >= H, Ls a multiple of 4 and S * P
//     within the card's resident thread slots). Segment 0 warms up over
//     the halo, segment j > 0 over the H bytes of the stream before it;
//     only segment 0 of stream 0 resets its state after the warm-up. A
//     state depends only on the last max_len - 1 <= H bytes, so every
//     segment starts in the whole-stream scan's state, bit for bit. The
//     G1 mask tests position s*L + j*Ls + t; the end words of positions
//     [j*Ls, (j+1)*Ls) are written by segment j alone; per-stream counts
//     are sums of integer atomicAdds into counts the caller zeroed.
//   - A warp is 32 consecutive streams of one segment, so its load of a
//     word row is one 128-byte transaction and its end-word stores
//     ([.., t, k, lane], lane-fastest) coalesce too.
//   - Words reach the byte loop through a per-thread cp.async ring in
//     shared memory (walk_rows in shift_and.cuh), three words in flight.
//   - The step runs every limb of the register bucket KR with no per-limb
//     guard (step_padded): limbs K..KR-1 have zero tables and masks. The
//     compiled step issues about 7 instructions per limb and byte step,
//     against 12.6-13.1 with a `k < K` branch per limb.
//   - The register buckets over K and the shared-memory nybble tables are
//     the shared core in shift_and.cuh. Decollided chain packing can
//     spread an eligible set over up to 2048 limbs (256 three-byte
//     patterns give K = 229, 128 words of 4-8 bytes K = 103).
//   - Beyond 64 limbs, limb groups (group_kernel): a stream's K limbs go
//     to G consecutive lanes of one warp, G the least power of two with
//     G * KR >= K, lane g holding limbs [g*KR, (g+1)*KR) in registers
//     (KR = 32 up to K = 1024). The step reads the OLD state of the limb
//     below, so a lane's carry into its first limb is the old top limb of
//     lane g - 1: one __shfl_up_sync per byte, before the lane's limb
//     loop, which then runs step_rows as the register path does. Threads
//     are S * P * G (scan_plan in ops/bitap_kernels.py), 256 per block.
//     Beyond K = 1024 a warp of 32 lanes cannot hold the limbs at KR = 32:
//     of the two ways out (two warps per stream with the carry passed
//     through shared memory, a barrier per byte; or KR = 64 per lane) this
//     takes KR = 64, with ptxas's spill report read in chip_smoke.py.
//     Lanes whose slice starts at or past limb K get zero start and end
//     masks and read slice 0's tables: nothing they compute is reported,
//     and carries only flow upward, so they disturb no live limb.
//   - The group's tables sit in shared memory, one slice of KR limbs per
//     lane, each slice's stride padded by 32 / G words: the G lanes of a
//     stream read the same nybble row of their G slices, which then fall
//     in G different banks (an unpadded stride of 16 * KR words puts them
//     all in one). Where 128 * K bytes do not fit next to the ring
//     (K > 1728, KR = 64), lanes read the tables from device memory
//     through L1; the last live lane then reads rows past limb K-1 up to
//     its slice's end, which the tables' allocation must hold
//     (padded_tables in ops/bitap_kernels.py): those rows feed only limbs
//     with zero masks, so their values do not matter.
//   - Every lane of a group loads the group's word through the cp.async
//     ring: the lanes name one address, which the load broadcasts (lane 0
//     loading alone and a __shfl_sync handing the word on was measured
//     slower; PERF.md). Counts are summed over the group
//     (__shfl_xor_sync) into one atomicAdd per (segment, stream); G1's
//     end words are written by the lane that holds the limb, at
//     [tile, t, k, stream]; G2's end-bearing limbs are numbered across
//     the group once per thread (a popcount prefix over
//     the lanes below, by shuffles), so each lane writes its own in limb
//     order.
//   - Measured (chip_smoke.py, H100 SXM at 700 W): 48-56% of the
//     operations bound on 64 MiB counts (K = 3 and 15), 66% of the bytes
//     bound on an 8 MiB extraction chunk, 6-23% on the 0.6-2 MiB shapes,
//     where a launch of a few microseconds is most of the time. The K > 64
//     rows are in PERF.md.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() so the caller can
// raise on a refused launch.

#include "shift_and.cuh"

namespace {

using namespace shift_and;

struct Params {
  const uint32_t* lo;     // [K, 16] (group tables in device memory: the
  const uint32_t* hi;     //  allocation holds whole slices of KR limbs)
  const uint32_t* sm;     // [K] chain-start bits
  const uint32_t* em;     // [K] chain-end bits
  const uint32_t* halo;   // [Hw, S] words, stream-major
  const uint32_t* body;   // [Wb, S] words, stream-major
  int32_t* counts;        // [S], zeroed by the caller (segments add)
  int32_t* words;         // [tiles, L, kdim, 1024] or null (count only)
  int K;
  int Hw;
  int Wb;
  int S;
  int P;                  // segments per stream, dividing Wb
  int G;                  // lanes per stream: 1, or a limb group's 4..32
  int kdim;
  long long n0;           // count window [n0, n) (G1 only)
  long long n;
};

template <int KR, bool BAKED, bool EXTRACT>
__global__ void __launch_bounds__(kSegThreads) scan_kernel(Params p) {
  extern __shared__ uint32_t smem[];  // lo [K*16], hi [K*16], then the ring
  const int K = p.K;
  const uint32_t* LO;
  const uint32_t* HI;
  load_tables_padded<KR>(p.lo, p.hi, K, smem, LO, HI);
  Segment g;
  if (!segment_of(p.S, p.P, p.Wb, g)) return;
  const int s = g.s;

  Limbs<KR> st;
  init_padded<KR>(st, p.sm, p.em, K);
  const SegmentRows rows{p.halo, p.body, static_cast<size_t>(p.S), p.Hw,
                         g.w0, g.j == 0};
  // Stream 0's halo wraps around to the end of the buffer: no history.
  const bool reset_at_body = s == 0 && g.j == 0;

  const long long L = 4LL * p.Wb;
  const long long pos0 = static_cast<long long>(s) * L;
  const size_t tile = static_cast<size_t>(s / kLanes);
  const int lane = s % kLanes;
  int cnt = 0;
  uint32_t* ring = smem + 32 * KR;  // past the tables
  walk_rows(rows, s, p.Hw + g.nw, ring, [&](int i, uint32_t word) {
    if (i < p.Hw) {  // warm-up: no hits counted
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        step_padded<KR>(st, LO, HI, (word >> (8 * jj)) & 255u,
                        [](int, uint32_t) {});
      }
      return;
    }
    if (reset_at_body && i == p.Hw) reset<KR>(st);
    const long long w = g.w0 + i - p.Hw;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const long long t = 4 * w + jj;
      bool ok = true;
      if constexpr (!BAKED) {
        ok = pos0 + t >= p.n0 && pos0 + t < p.n;
      }
      int32_t* wrow = nullptr;
      if constexpr (EXTRACT) {
        wrow = p.words + ((tile * L + t) * p.kdim) * kLanes + lane;
      }
      int slot = 0;
      step_padded<KR>(st, LO, HI, (word >> (8 * jj)) & 255u,
               [&](int k, uint32_t nm) {
                 uint32_t h = nm & st.em[k];
                 if constexpr (!BAKED) {
                   h = ok ? h : 0u;
                 }
                 cnt += __popc(h);
                 if constexpr (EXTRACT) {
                   if constexpr (BAKED) {
                     if (st.em[k] != 0u) {
                       wrow[static_cast<size_t>(slot) * kLanes] =
                           static_cast<int32_t>(h);
                       ++slot;
                     }
                   } else if (k < K) {
                     wrow[static_cast<size_t>(k) * kLanes] =
                         static_cast<int32_t>(h);
                   }
                 }
               });
    }
  });
  if (cnt != 0) atomicAdd(p.counts + s, cnt);
}

// ---------------------------------------------------------------------------
// Limb groups (K > 64)
// ---------------------------------------------------------------------------
// Dynamic shared memory of a limb-group block: lo and hi, one slice per
// lane that holds a live limb (if the tables are in shared memory), then
// the ring.
inline size_t group_shmem_bytes(int K, int KR, int G, bool shared_tables) {
  const size_t live = (K + KR - 1) / KR;
  const size_t tables =
      shared_tables ? 2 * live * static_cast<size_t>(group_stride(KR, G))
                    : 0;
  return (tables + static_cast<size_t>(kRing) * kGroupThreads) *
         sizeof(uint32_t);
}

template <int KR, bool BAKED, bool EXTRACT, bool SHARED_TABLES>
__global__ void __launch_bounds__(kGroupThreads) group_kernel(Params p) {
  extern __shared__ uint32_t smem[];  // lo, hi slices (or none), the ring
  const int K = p.K;
  const int G = p.G;
  const int live = (K + KR - 1) / KR;
  const int stride = SHARED_TABLES ? group_stride(KR, G) : 16 * KR;
  const uint32_t* LO = p.lo;
  const uint32_t* HI = p.hi;
  uint32_t* ring = smem;
  if constexpr (SHARED_TABLES) {
    load_group_tables<KR>(p.lo, p.hi, K, stride, smem);
    LO = smem;
    HI = smem + live * stride;
    ring = smem + 2 * live * stride;
  }
  GroupSegment q;
  if (!group_of(p.S, p.P, G, p.Wb, q)) return;
  const int s = q.s;
  const int k0 = q.g * KR;
  const int nlive = K - k0;  // live limbs of this lane: <= 0 for none
  LO += (nlive > 0 ? q.g : 0) * stride;
  HI += (nlive > 0 ? q.g : 0) * stride;

  Limbs<KR> st;
  init_padded<KR>(st, p.sm, p.em, K, k0);
  // G2's word slot of this lane's first end-bearing limb: the end-bearing
  // limbs of the lanes below it.
  int slot0 = 0;
  if constexpr (BAKED && EXTRACT) {
    int mine = 0;
#pragma unroll
    for (int k = 0; k < KR; ++k) mine += st.em[k] != 0u ? 1 : 0;
    slot0 = group_sum_below(mine, q.g, G);
  }
  // One shuffle per byte, before this lane's limbs change.
  auto carry = [&]() { return group_carry<KR>(st, q.g, G); };
  const SegmentRows rows{p.halo, p.body, static_cast<size_t>(p.S), p.Hw,
                         q.w0, q.j == 0};
  // Stream 0's halo wraps around to the end of the buffer: no history.
  const bool reset_at_body = s == 0 && q.j == 0;

  const long long L = 4LL * p.Wb;
  const long long pos0 = static_cast<long long>(s) * L;
  const size_t tile = static_cast<size_t>(s / kLanes);
  const int col = s % kLanes;
  int cnt = 0;
  // Every lane of a warp walks the same rows (one segment), so the
  // shuffles run converged.
  walk_rows<kGroupThreads>(rows, s, p.Hw + q.nw, ring,
                           [&](int i, uint32_t word) {
    if (i < p.Hw) {  // warm-up: no hits counted
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint32_t b = (word >> (8 * jj)) & 255u;
        step_rows<KR>(st, LO + (b & 15u), HI + (b >> 4),
                      [](int, uint32_t) {}, carry());
      }
      return;
    }
    if (reset_at_body && i == p.Hw) reset<KR>(st);
    const long long w = q.w0 + i - p.Hw;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const long long t = 4 * w + jj;
      uint32_t ok = ~0u;
      if constexpr (!BAKED) {
        ok = pos0 + t >= p.n0 && pos0 + t < p.n ? ~0u : 0u;
      }
      int32_t* wrow = nullptr;
      if constexpr (EXTRACT) {
        wrow = p.words + ((tile * L + t) * p.kdim) * kLanes + col;
      }
      int slot = slot0;
      const uint32_t b = (word >> (8 * jj)) & 255u;
      step_rows<KR>(
          st, LO + (b & 15u), HI + (b >> 4),
          [&](int k, uint32_t nm) {
            const uint32_t h = nm & st.em[k] & ok;
            cnt += __popc(h);
            if constexpr (EXTRACT) {
              if constexpr (BAKED) {
                if (st.em[k] != 0u) {
                  wrow[static_cast<size_t>(slot) * kLanes] =
                      static_cast<int32_t>(h);
                  ++slot;
                }
              } else if (k < nlive) {
                wrow[static_cast<size_t>(k0 + k) * kLanes] =
                    static_cast<int32_t>(h);
              }
            }
          },
          carry());
    }
  });
  cnt = group_sum(cnt, G);
  if (q.g == 0 && cnt != 0) atomicAdd(p.counts + s, cnt);
}

template <int KR, bool BAKED, bool EXTRACT, bool SHARED_TABLES>
cudaError_t launch_group(const Params& p, cudaStream_t stream) {
  const size_t bytes = group_shmem_bytes(p.K, KR, p.G, SHARED_TABLES);
  auto kernel = group_kernel<KR, BAKED, EXTRACT, SHARED_TABLES>;
  static int opted[kMaxDevices] = {};
  const cudaError_t e = opt_in_shared(kernel, bytes, opted);
  if (e != cudaSuccess) return e;
  const long long threads = static_cast<long long>(p.S) * p.P * p.G;
  kernel<<<static_cast<int>((threads + kGroupThreads - 1) / kGroupThreads),
           kGroupThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// G = 1: one thread per (segment, stream), the register bucket over K
// (K <= 64). G > 1: limb groups of G lanes with KR (32 or 64) limbs each.
template <bool BAKED, bool EXTRACT>
cudaError_t launch(const Params& p, int KR, bool shared_tables,
                   cudaStream_t stream) {
  if (p.G == 1) {
    SHIFT_AND_FOR_BUCKET(
        p.K, scan_kernel<KR, BAKED, EXTRACT>
                 <<<seg_blocks_for(p.S, p.P), kSegThreads,
                    seg_shmem_bytes(KR), stream>>>(p));
    return cudaGetLastError();
  }
  if (p.G > 32 || (p.G & (p.G - 1)) != 0 || p.G * KR < p.K) {
    return cudaErrorInvalidValue;
  }
  // KR = 32 (K <= 1024) always fits its tables in shared memory; only
  // KR = 64 may not (K > 1728).
  if (KR == 32 && shared_tables) {
    return launch_group<32, BAKED, EXTRACT, true>(p, stream);
  }
  if (KR == 64) {
    return shared_tables
               ? launch_group<64, BAKED, EXTRACT, true>(p, stream)
               : launch_group<64, BAKED, EXTRACT, false>(p, stream);
  }
  return cudaErrorInvalidValue;
}

Params make_params(const void* lo, const void* hi, const void* sm,
                   const void* em, int K, const void* halo, int Hw,
                   const void* body, int Wb, int S, int P, int G,
                   void* counts, void* words, int kdim) {
  Params p;
  p.lo = static_cast<const uint32_t*>(lo);
  p.hi = static_cast<const uint32_t*>(hi);
  p.sm = static_cast<const uint32_t*>(sm);
  p.em = static_cast<const uint32_t*>(em);
  p.halo = static_cast<const uint32_t*>(halo);
  p.body = static_cast<const uint32_t*>(body);
  p.counts = static_cast<int32_t*>(counts);
  p.words = static_cast<int32_t*>(words);
  p.K = K;
  p.Hw = Hw;
  p.Wb = Wb;
  p.S = S;
  p.P = P;
  p.G = G;
  p.kdim = kdim;
  p.n0 = 0;
  p.n = 0;
  return p;
}

}  // namespace

extern "C" {

// G1. counts: [S] int32, zeroed; words: [tiles, L, K, 1024] int32 or null
// for a count-only scan; P segments per stream; G lanes per stream (1, or
// a limb group of KR limbs per lane, the tables in shared memory if
// tables_in_shared, else read from an allocation of whole slices).
int bitap_generic_scan(const void* lo, const void* hi, const void* sm,
                       const void* em, int K, const void* halo, int Hw,
                       const void* body, int Wb, int S, int P, int G, int KR,
                       int tables_in_shared, long long n0, long long n,
                       void* counts, void* words, void* stream) {
  Params p = make_params(lo, hi, sm, em, K, halo, Hw, body, Wb, S, P, G,
                         counts, words, K);
  p.n0 = n0;
  p.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = tables_in_shared != 0;
  return static_cast<int>(
      words != nullptr ? launch<false, true>(p, KR, shared, st)
                       : launch<false, false>(p, KR, shared, st));
}

// G2. counts: [S] int32, zeroed; words: [tiles, L, Ke, 1024] int32 or null
// for a count-only scan; P, G, KR and tables_in_shared as for G1.
int bitap_baked_scan(const void* lo, const void* hi, const void* sm,
                     const void* em, int K, int Ke, const void* halo, int Hw,
                     const void* body, int Wb, int S, int P, int G, int KR,
                     int tables_in_shared, void* counts, void* words,
                     void* stream) {
  Params p = make_params(lo, hi, sm, em, K, halo, Hw, body, Wb, S, P, G,
                         counts, words, Ke);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = tables_in_shared != 0;
  return static_cast<int>(
      words != nullptr ? launch<true, true>(p, KR, shared, st)
                       : launch<true, false>(p, KR, shared, st));
}

}  // extern "C"
