// The blocked DFA walk, for Hopper (sm_90a).
//
// In the JAX package each walk is one device program, a lax.scan over
// halo + L steps that advances the B blocks' states in lockstep, one
// gather trans_flat[state * A + class] per step:
//   W1  ahocorasick_tpu/ops/block_scan.py::_scan_states_jit  -> walk_states
//       the state after every byte of the unanchored walk, int32 [n];
//   W2  ahocorasick_tpu/ops/block_scan.py::_count_matches_jit and
//       ahocorasick_tpu/parallel/shard.py::count_kernel       -> walk_count
//       the same walk, summing match_count[state] over the positions of a
//       window [n0, n1), with no state array.
//
// The suffix property of the unanchored automaton (the state after a
// byte is fixed by the last max_pattern_len bytes) makes a position's
// state independent of how the buffer is cut into blocks, as long as each
// block first walks a halo of at least max_pattern_len bytes. So the
// kernels cut it finer than the JAX layout: one thread per sub-block of
// `sub` bytes (ops/walk_kernels.py::walk_plan: about 2^18 threads at 64
// MiB, where the JAX layout gives 8,192), each walking from the start
// state over its halo and then its own bytes. Halo steps before the
// buffer's start are skipped (the state stays the start state), also
// where the halo is longer than a block.
//
// What bounds them on an H100: neither bytes nor operations, but the
// latency of a chain of dependent loads per thread (state -> table entry
// -> state). The least work is small: n haystack bytes, the table once,
// 4n state bytes for W1 (about 0.1 ms at 64 MiB), a few integer
// operations per byte. What the design does about the latency: enough
// threads to fill every SM's slots (walk_plan), the class of each byte
// looked up apart from the chain (classes in shared memory), the table in
// shared memory where it fits in SHARED_TABLE_BYTES (a small set), else
// read through the read-only path, where a dictionary's hot states stay
// in L1 and the rest of a ~1 MB table in L2. The haystack is read in
// 16-byte vectors and W1 stores four states as one 16-byte word, both
// with the streaming hint, so that they pass L2 without evicting the
// table. W2 walks only the sub-blocks that hold window positions and
// stops at the window's end; each block sums its threads' counts in
// shared memory and writes one int64 partial, which the wrapper sums.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() (cudaErrorInvalidValue
// for arguments the kernels do not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;         // threads per block, both kernels
constexpr int kAlphabet = 256;        // byte classes, in shared memory
constexpr long long kSharedTableBytes = 40 * 1024;  // SHARED_TABLE_BYTES
constexpr long long kMaxIndex = 0x7fffffffLL;       // s * A + c in int32

template <bool kShared>
__device__ __forceinline__ int next_state(const int* T, int s, int A, int c) {
  const int i = s * A + c;
  return kShared ? T[i] : __ldg(T + i);
}

// The classes into shared memory, and the table too where kShared;
// returns the table to read.
template <bool kShared>
__device__ const int* load_tables(const int* trans, long long sa,
                                  const int* classes, int* smem) {
  for (int i = threadIdx.x; i < kAlphabet; i += kThreads) {
    smem[i] = __ldg(classes + i);
  }
  if (kShared) {
    for (long long i = threadIdx.x; i < sa; i += kThreads) {
      smem[kAlphabet + i] = __ldg(trans + i);
    }
  }
  __syncthreads();
  return kShared ? smem + kAlphabet : trans;
}

// The walk over the halo of the sub-block at lo, from state s; steps
// before the buffer's start are skipped.
template <bool kShared>
__device__ __forceinline__ int walk_halo(const int* T, const int* cls,
                                         const uint8_t* buf, long long lo,
                                         int halo, int A, int s) {
  for (long long i = lo > halo ? lo - halo : 0; i < lo; ++i) {
    s = next_state<kShared>(T, s, A, cls[__ldg(buf + i)]);
  }
  return s;
}

// Four steps over the bytes of w (little-endian), the state after each.
template <bool kShared>
__device__ __forceinline__ int4 step4(const int* T, const int* cls,
                                      uint32_t w, int A, int& s) {
  int4 o;
  s = next_state<kShared>(T, s, A, cls[w & 0xff]);
  o.x = s;
  s = next_state<kShared>(T, s, A, cls[(w >> 8) & 0xff]);
  o.y = s;
  s = next_state<kShared>(T, s, A, cls[(w >> 16) & 0xff]);
  o.z = s;
  s = next_state<kShared>(T, s, A, cls[w >> 24]);
  o.w = s;
  return o;
}

// ---------------------------------------------------------------- W1
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 4)
walk_states_kernel(const int* trans, long long sa, const int* classes,
                   const uint8_t* buf, long long n, int A, int start,
                   long long sub, int halo, int* out) {
  extern __shared__ int smem[];
  const int* T = load_tables<kShared>(trans, sa, classes, smem);
  const int* cls = smem;
  const long long lo =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * sub;
  if (lo >= n) return;
  const long long hi = lo + sub < n ? lo + sub : n;
  int s = walk_halo<kShared>(T, cls, buf, lo, halo, A, start);
  for (long long p = lo; p < hi; p += 16) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(buf + p));
    int4* o = reinterpret_cast<int4*>(out + p);
    __stcs(o, step4<kShared>(T, cls, v.x, A, s));
    __stcs(o + 1, step4<kShared>(T, cls, v.y, A, s));
    __stcs(o + 2, step4<kShared>(T, cls, v.z, A, s));
    __stcs(o + 3, step4<kShared>(T, cls, v.w, A, s));
  }
}

// ---------------------------------------------------------------- W2
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 4)
walk_count_kernel(const int* trans, long long sa, const int* classes,
                  const uint8_t* buf, long long n, int A, int start,
                  long long sub, int halo, const long long* match_count,
                  long long n0, long long n1, long long* partials) {
  extern __shared__ int smem[];
  __shared__ long long red[kThreads];
  const int* T = load_tables<kShared>(trans, sa, classes, smem);
  const int* cls = smem;
  const long long lo =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * sub;
  const long long hi = lo + sub < n ? lo + sub : n;
  const long long c0 = lo > n0 ? lo : n0;
  const long long c1 = hi < n1 ? hi : n1;
  long long acc = 0;
  if (c0 < c1) {
    int s = walk_halo<kShared>(T, cls, buf, lo, halo, A, start);
    for (long long p = lo; p < c1; p += 16) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(buf + p));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        s = next_state<kShared>(T, s, A,
                                cls[(w[k >> 2] >> (8 * (k & 3))) & 0xff]);
        if (p + k >= c0 && p + k < c1) acc += __ldg(match_count + s);
      }
    }
  }
  const int t = threadIdx.x;
  red[t] = acc;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) red[t] += red[t + h];
    __syncthreads();
  }
  if (t == 0) partials[blockIdx.x] = red[0];
}

// Blocks of a launch over n bytes in sub-blocks of sub.
long long blocks_for(long long n, long long sub) {
  const long long threads = (n + sub - 1) / sub;
  return (threads + kThreads - 1) / kThreads;
}

// The arguments both kernels take: a buffer of whole 16-byte words, 16-byte
// aligned sub-blocks, a table whose indices fit int32, a start state of
// the table, and a table small enough where it goes to shared memory.
bool walk_args_ok(long long sa, const void* buf, long long n, int A,
                  int start, long long sub, int halo, int shared) {
  if (sa <= 0 || sa > kMaxIndex || A <= 0 || sa % A || start < 0 ||
      start >= sa / A || n <= 0 || n % 16 || sub <= 0 || sub % 16 ||
      halo < 0 || reinterpret_cast<uintptr_t>(buf) % 16) {
    return false;
  }
  if (shared && sa * 4 > kSharedTableBytes) return false;
  return blocks_for(n, sub) <= kMaxIndex;
}

size_t shared_bytes(long long sa, int shared) {
  return sizeof(int) * (kAlphabet + (shared ? sa : 0));
}

}  // namespace

extern "C" {

// W1. trans: [sa] int32, the S x A table row-major; classes: [256] int32;
// buf: [n] uint8, n a multiple of 16, 16-byte aligned; sub: the sub-block
// length, a multiple of 16 (one thread each); halo: the bytes walked
// before each sub-block; shared: 1 to copy the table into shared memory
// (sa * 4 <= 40 KiB); out: [n] int32, 16-byte aligned.
int walk_states(const void* trans, long long sa, const void* classes,
                const void* buf, long long n, int A, int start,
                long long sub, int halo, int shared, void* out,
                void* stream) {
  if (!walk_args_ok(sa, buf, n, A, start, sub, halo, shared) ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(blocks_for(n, sub));
  const int* t = static_cast<const int*>(trans);
  const int* c = static_cast<const int*>(classes);
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  int* o = static_cast<int*>(out);
  if (shared) {
    walk_states_kernel<true><<<grid, kThreads, shared_bytes(sa, 1), st>>>(
        t, sa, c, b, n, A, start, sub, halo, o);
  } else {
    walk_states_kernel<false><<<grid, kThreads, shared_bytes(sa, 0), st>>>(
        t, sa, c, b, n, A, start, sub, halo, o);
  }
  return cudaGetLastError();
}

// W2. As W1, with match_count: [sa / A] int64, the window 0 <= n0 <= n1
// <= n, and partials: [blocks] int64, one sum per block of 512 threads
// (walk_kernels.py::count_blocks).
int walk_count(const void* trans, long long sa, const void* classes,
               const void* buf, long long n, int A, int start,
               long long sub, int halo, int shared, const void* match_count,
               long long n0, long long n1, void* partials, void* stream) {
  if (!walk_args_ok(sa, buf, n, A, start, sub, halo, shared) || n0 < 0 ||
      n0 > n1 || n1 > n) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(blocks_for(n, sub));
  const int* t = static_cast<const int*>(trans);
  const int* c = static_cast<const int*>(classes);
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  const long long* mc = static_cast<const long long*>(match_count);
  long long* out = static_cast<long long*>(partials);
  if (shared) {
    walk_count_kernel<true><<<grid, kThreads, shared_bytes(sa, 1), st>>>(
        t, sa, c, b, n, A, start, sub, halo, mc, n0, n1, out);
  } else {
    walk_count_kernel<false><<<grid, kThreads, shared_bytes(sa, 0), st>>>(
        t, sa, c, b, n, A, start, sub, halo, mc, n0, n1, out);
  }
  return cudaGetLastError();
}

}  // extern "C"
