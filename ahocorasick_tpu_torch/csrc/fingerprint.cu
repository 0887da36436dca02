// The fingerprint engine's candidate-bitmap scans for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   G5  ahocorasick_tpu/ops/fingerprint.py::_make_fp_kernel        -> fp_bitmap
//       (body loop `_bitmap_step_wrapper`, launched by `_fp_pallas`)
//       table-generic, positions masked to [n0, n);
//   G6  ahocorasick_tpu/ops/fingerprint.py::_make_fp_baked_kernel  -> fp_bitmap
//       the haystack padded with `strong_pad_byte` (zero charmask under any
//       bucketing), no mask.
// Both run the shift-AND step over bucket chains (<= 8 bytes each, K <= 64
// limbs) and write, per position t of stream s, whether ANY chain ends
// there, any_k(m'[k] & end[k]) != 0: bit t % 32 of bitmap word t / 32 of
// the stream, [tiles, L/32, 8, 128] int32 (what the Pallas
// `(w % 8) * 4 + jj` shift with a flush every 8 words amounts to, L being
// a multiple of 32), plus per-lane counts of set positions,
// [tiles, 8, 128]. The count is of positions, not a popcount of end words.
//
// G6's TPU version bakes the tables in and elides the carry into a limb
// whose bit 0 no charmask sets or whose start mask already sets it
// (fingerprint.py:445-449). Such a carry is dropped by the AND with cm, or
// overwritten by the start bit, anyway, so always carrying with run-time
// tables computes the same function; G5 and G6 are one kernel here, with
// the mask as a template switch.
//
// What bounds it on an H100: instruction issue. At the least a byte costs
// two integer operations and, per limb, a funnel shift, three three-input
// logic operations (the step's two and any |= m & end) and two
// shared-memory loads (step_cycles in chip_smoke.py); at K = 8 (dict1k)
// that is 34 logic operations per byte at 64 per SM and clock, 0.14 ms for
// 64 MiB, against 0.02 ms of HBM time.
//
// Design: the G1 design (bitap.cu, shift_and.cuh). One thread per
// (segment, stream), each stream cut into P segments of Ls bytes, Ls a
// multiple of 32 (segment_plan in ops/bitap_kernels.py), so each bitmap
// word belongs to one segment and is written by one thread: the 32
// positions accumulate in a register and are stored once, lane-fastest,
// so a warp's bitmap stores coalesce like its word loads. A segment warms
// up over the H bytes before it (the halo for segment 0), only segment 0
// of stream 0 resets, the G5 mask tests position s*L + j*Ls + t, and the
// per-stream counts are atomicAdds into zeroed counts. Words arrive
// through the cp.async ring of walk_rows; the step is step_padded, every
// limb of the bucket with no per-limb guard (6.1 instructions per limb and
// byte step, 11.5 with the guard).
//
// Measured (chip_smoke.py, H100 SXM at 700 W): 57% of the operations
// bound over 64 MiB of dict1k (K = 8, 262,144 threads), 22% over 16 MiB of
// the five names (K = 1, where the few operations per byte leave the word
// loads and the launch in view), 4-16% on the 0.5-0.6 MiB shapes.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

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
  int32_t* bitmap;        // [tiles, L/32, 1024]
  int K;                  // <= 64
  int Hw;
  int Wb;
  int S;
  int P;                  // segments per stream, dividing Wb / 8
  long long n0;           // G5 window [n0, n)
  long long n;
};

template <int KR, bool MASKED>
__global__ void __launch_bounds__(kSegThreads) bitmap_kernel(Params p) {
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
  int32_t* brow = p.bitmap + tile * static_cast<size_t>(p.Wb / 8) * kLanes +
                  lane;
  uint32_t acc = 0u;
  int cnt = 0;
  uint32_t* ring = smem + 32 * KR;  // past the tables
  walk_rows(rows, s, p.Hw + g.nw, ring, [&](int i, uint32_t word) {
    if (i < p.Hw) {  // warm-up: no hits
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        step_padded<KR>(st, LO, HI, (word >> (8 * jj)) & 255u,
                        [](int, uint32_t) {});
      }
      return;
    }
    if (reset_at_body && i == p.Hw) reset<KR>(st);
    // The segment starts on a multiple of 8 words: bitmap words are whole.
    const int w = g.w0 + i - p.Hw;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t any = 0u;
      step_padded<KR>(st, LO, HI, (word >> (8 * jj)) & 255u,
                      [&](int k, uint32_t nm) { any |= nm & st.em[k]; });
      uint32_t hit = any != 0u ? 1u : 0u;
      if constexpr (MASKED) {
        const long long pos = pos0 + 4LL * w + jj;
        hit = (pos >= p.n0 && pos < p.n) ? hit : 0u;
      }
      acc |= hit << ((w & 7) * 4 + jj);
      cnt += static_cast<int>(hit);
    }
    if ((w & 7) == 7) {
      brow[static_cast<size_t>(w >> 3) * kLanes] = static_cast<int32_t>(acc);
      acc = 0u;
    }
  });
  if (cnt != 0) atomicAdd(p.counts + s, cnt);
}

}  // namespace

extern "C" {

// G5 (masked != 0) and G6. counts: [S] int32, zeroed; bitmap:
// [tiles, L/32, 1024] int32, L = 4 * Wb a multiple of 32; P segments per
// stream, each a multiple of 32 bytes; K <= 64 (else cudaErrorInvalidValue).
int fp_bitmap(const void* lo, const void* hi, const void* sm, const void* em,
              int K, const void* halo, int Hw, const void* body, int Wb,
              int S, int P, int masked, long long n0, long long n,
              void* counts, void* bitmap, void* stream) {
  Params p{};
  p.lo = static_cast<const uint32_t*>(lo);
  p.hi = static_cast<const uint32_t*>(hi);
  p.sm = static_cast<const uint32_t*>(sm);
  p.em = static_cast<const uint32_t*>(em);
  p.halo = static_cast<const uint32_t*>(halo);
  p.body = static_cast<const uint32_t*>(body);
  p.counts = static_cast<int32_t*>(counts);
  p.bitmap = static_cast<int32_t*>(bitmap);
  p.K = K;
  p.Hw = Hw;
  p.Wb = Wb;
  p.S = S;
  p.P = P;
  p.n0 = n0;
  p.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (masked) {
    SHIFT_AND_FOR_BUCKET(
        K, bitmap_kernel<KR, true><<<seg_blocks_for(S, P), kSegThreads,
                                     seg_shmem_bytes(KR), st>>>(p));
  } else {
    SHIFT_AND_FOR_BUCKET(
        K, bitmap_kernel<KR, false><<<seg_blocks_for(S, P), kSegThreads,
                                      seg_shmem_bytes(KR), st>>>(p));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
