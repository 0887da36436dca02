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
//   - The register buckets over K, the shared-memory nybble tables and
//     the spill path beyond 64 limbs are the shared core in shift_and.cuh.
//     Decollided chain packing can spread an eligible set over up to 2048
//     limbs (256 three-byte patterns give K = 229).
//   - Measured (chip_smoke.py, H100 SXM at 700 W): 48-56% of the
//     operations bound on 64 MiB counts (K = 3 and 15), 66% of the bytes
//     bound on an 8 MiB extraction chunk, 6-23% on the 0.6-2 MiB shapes,
//     where a launch of a few microseconds is most of the time, and 4% on
//     the K = 229 spill path, whose limb state lives in L2.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() so the caller can
// raise on a refused launch.

#include "shift_and.cuh"

namespace {

using namespace shift_and;

struct Params {
  const uint32_t* lo;     // [K, 16]
  const uint32_t* hi;     // [K, 16]
  const uint32_t* sm;     // [K] chain-start bits
  const uint32_t* em;     // [K] chain-end bits
  const uint32_t* halo;   // [Hw, S] words, stream-major
  const uint32_t* body;   // [Wb, S] words, stream-major
  int32_t* counts;        // [S], zeroed by the caller (segments add)
  int32_t* words;         // [tiles, L, kdim, 1024] or null (count only)
  uint32_t* state;        // [K, state_row] scratch (K > 64) or null
  int state_row;          // words per limb row of state, >= S*P
  int K;
  int Hw;
  int Wb;
  int S;
  int P;                  // segments per stream, dividing Wb
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
  init_padded<KR>(st, p.sm, p.em, p.state, g.t, p.state_row, K);
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
        step_padded<KR>(st, LO, HI, K, (word >> (8 * jj)) & 255u,
                 [](int, uint32_t) {});
      }
      return;
    }
    if (reset_at_body && i == p.Hw) reset<KR>(st, K);
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
      step_padded<KR>(st, LO, HI, K, (word >> (8 * jj)) & 255u,
               [&](int k, uint32_t nm) {
                 uint32_t h = nm & st.end(k);
                 if constexpr (!BAKED) {
                   h = ok ? h : 0u;
                 }
                 cnt += __popc(h);
                 if constexpr (EXTRACT) {
                   if constexpr (BAKED) {
                     if (st.end(k) != 0u) {
                       wrow[static_cast<size_t>(slot) * kLanes] =
                           static_cast<int32_t>(h);
                       ++slot;
                     }
                   } else if (KR == 0 || k < K) {
                     wrow[static_cast<size_t>(k) * kLanes] =
                         static_cast<int32_t>(h);
                   }
                 }
               });
    }
  });
  if (cnt != 0) atomicAdd(p.counts + s, cnt);
}

template <bool BAKED, bool EXTRACT>
void launch(const Params& p, cudaStream_t stream) {
  SHIFT_AND_FOR_BUCKET(
      p.K, scan_kernel<KR, BAKED, EXTRACT>
               <<<seg_blocks_for(p.S, p.P), kSegThreads,
                  seg_shmem_bytes(KR), stream>>>(p));
}

Params make_params(const void* lo, const void* hi, const void* sm,
                   const void* em, int K, const void* halo, int Hw,
                   const void* body, int Wb, int S, int P, void* counts,
                   void* words, int kdim, void* state, int state_row) {
  Params p;
  p.lo = static_cast<const uint32_t*>(lo);
  p.hi = static_cast<const uint32_t*>(hi);
  p.sm = static_cast<const uint32_t*>(sm);
  p.em = static_cast<const uint32_t*>(em);
  p.halo = static_cast<const uint32_t*>(halo);
  p.body = static_cast<const uint32_t*>(body);
  p.counts = static_cast<int32_t*>(counts);
  p.words = static_cast<int32_t*>(words);
  p.state = static_cast<uint32_t*>(state);
  p.state_row = state_row;
  p.K = K;
  p.Hw = Hw;
  p.Wb = Wb;
  p.S = S;
  p.P = P;
  p.kdim = kdim;
  p.n0 = 0;
  p.n = 0;
  return p;
}

}  // namespace

extern "C" {

// G1. counts: [S] int32, zeroed; words: [tiles, L, K, 1024] int32 or null
// for a count-only scan; P segments per stream; state: [K, state_row] for
// K > 64.
int bitap_generic_scan(const void* lo, const void* hi, const void* sm,
                       const void* em, int K, const void* halo, int Hw,
                       const void* body, int Wb, int S, int P, long long n0,
                       long long n, void* counts, void* words, void* state,
                       int state_row, void* stream) {
  Params p = make_params(lo, hi, sm, em, K, halo, Hw, body, Wb, S, P, counts,
                         words, K, state, state_row);
  p.n0 = n0;
  p.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words != nullptr) {
    launch<false, true>(p, st);
  } else {
    launch<false, false>(p, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// G2. counts: [S] int32, zeroed; words: [tiles, L, Ke, 1024] int32 or null
// for a count-only scan; P segments per stream; state: [K, state_row] for
// K > 64.
int bitap_baked_scan(const void* lo, const void* hi, const void* sm,
                     const void* em, int K, int Ke, const void* halo, int Hw,
                     const void* body, int Wb, int S, int P, void* counts,
                     void* words, void* state, int state_row, void* stream) {
  Params p = make_params(lo, hi, sm, em, K, halo, Hw, body, Wb, S, P, counts,
                         words, Ke, state, state_row);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words != nullptr) {
    launch<true, true>(p, st);
  } else {
    launch<true, false>(p, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
