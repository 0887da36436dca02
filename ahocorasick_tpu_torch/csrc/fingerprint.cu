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
// What bounds it on an H100: integer issue, about 2 + 8K int32 operations
// per byte against one byte read and one bit written; at K = 7 that is
// ~58 operations per byte, ~0.23 ms for 64 MiB at 16.7 Tops/s against
// ~0.02 ms of HBM time.
//
// Design: the G1 design (shift_and.cuh). One thread per stream; the 32
// positions of a bitmap word accumulate in a register and are stored once,
// lane-fastest, so a warp's bitmap stores coalesce like its word loads.
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
  int32_t* counts;        // [S]
  int32_t* bitmap;        // [tiles, L/32, 1024]
  uint32_t* state;        // [K, S] scratch for K > 64, else null
  int K;
  int Hw;
  int Wb;
  int S;
  long long n0;           // G5 window [n0, n)
  long long n;
};

template <int KR, bool MASKED>
__global__ void __launch_bounds__(kThreads) bitmap_kernel(Params p) {
  extern __shared__ uint32_t tab[];
  const int K = p.K;
  const uint32_t* LO;
  const uint32_t* HI;
  load_tables<KR>(p.lo, p.hi, K, tab, LO, HI);
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= p.S) return;

  Limbs<KR> st;
  init<KR>(st, p.sm, p.em, p.state, s, p.S, K);
  walk_halo<KR>(st, LO, HI, K, p.halo, p.Hw, s, p.S, [](int, uint32_t) {});
  if (s == 0) reset<KR>(st, K);

  const long long L = 4LL * p.Wb;
  const long long pos0 = static_cast<long long>(s) * L;
  const size_t tile = static_cast<size_t>(s / kLanes);
  const int lane = s % kLanes;
  int32_t* brow = p.bitmap + tile * static_cast<size_t>(p.Wb / 8) * kLanes +
                  lane;
  uint32_t acc = 0u;
  int cnt = 0;
  for (int w = 0; w < p.Wb; ++w) {
    const uint32_t word = p.body[static_cast<size_t>(w) * p.S + s];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t any = 0u;
      step<KR>(st, LO, HI, K, (word >> (8 * jj)) & 255u,
               [&](int k, uint32_t nm) { any |= nm & st.end(k); });
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
  }
  p.counts[s] = cnt;
}

}  // namespace

extern "C" {

// G5 (masked != 0) and G6. counts: [S] int32; bitmap: [tiles, L/32, 1024]
// int32, L = 4 * Wb a multiple of 32.
int fp_bitmap(const void* lo, const void* hi, const void* sm, const void* em,
              int K, const void* halo, int Hw, const void* body, int Wb,
              int S, int masked, long long n0, long long n, void* counts,
              void* bitmap, void* state, void* stream) {
  Params p{};
  p.lo = static_cast<const uint32_t*>(lo);
  p.hi = static_cast<const uint32_t*>(hi);
  p.sm = static_cast<const uint32_t*>(sm);
  p.em = static_cast<const uint32_t*>(em);
  p.halo = static_cast<const uint32_t*>(halo);
  p.body = static_cast<const uint32_t*>(body);
  p.counts = static_cast<int32_t*>(counts);
  p.bitmap = static_cast<int32_t*>(bitmap);
  p.state = static_cast<uint32_t*>(state);
  p.K = K;
  p.Hw = Hw;
  p.Wb = Wb;
  p.S = S;
  p.n0 = n0;
  p.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (masked) {
    SHIFT_AND_FOR_BUCKET(
        K, bitmap_kernel<KR, true>
               <<<blocks_for(S), kThreads, shmem_bytes(KR, K), st>>>(p));
  } else {
    SHIFT_AND_FOR_BUCKET(
        K, bitmap_kernel<KR, false>
               <<<blocks_for(S), kThreads, shmem_bytes(KR, K), st>>>(p));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
