// Fused hash probe + row gather (hash-table pull) for Hopper (sm_90a).
//
// Replaces the TPU kernel openembedding_tpu/ops/pallas_hash.py:
// _probe_gather_kernel (reached from probe_gather, pl.pallas_call): for each
// query key, compare the chain * bucket keys of its bucket-aligned probe
// window, take the first matching slot and copy that weight row; a miss or
// an EMPTY query (hi word == EMPTY for pair keys) gives a zero row and
// hit = 0.
//
// What bounds it: memory. Per query it reads at most one window of keys
// (256 slots at the default geometry: 1 KiB of int32 keys, 2 KiB of
// (lo, hi) pairs) and one row, and writes one row and one hit byte; the
// compares are nothing next to that. At serving's shapes a warp waits out
// three dependent memory round trips (query, key step, row), so the
// kernel runs well above its byte bound (PERF.md).
//
// Design: one warp per query, kWarps queries per block. The warp computes
// the window start itself with the same 32-bit mixing as
// hash_table.probe_starts (_mix for int32 keys, _mix_pair for pairs), so a
// lookup is one launch with no start array. It then walks the window 32
// slots at a time, lane l comparing slot base + l (consecutive lanes read
// consecutive keys: 128 or 256 contiguous bytes per step), and a
// __ballot_sync in slot order gives the first match, which is the slot
// find_rows' argmax picks; the walk stops at the first step holding a
// match. The warp then copies the row, lane l taking columns l, l + 32,
// ... Keys and rows are addressed with 64-bit offsets. The TPU kernel's
// double-buffered key DMAs and its 128-lane row constraint have no
// counterpart: resident warps hide the load latency, and any row width
// goes. Weights are copied as 32- or 16-bit words (float32 or bfloat16),
// without float conversion.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t mix32(uint32_t u) {
  u = (u ^ (u >> 16)) * 0x85EBCA6Bu;
  u = (u ^ (u >> 13)) * 0xC2B2AE35u;
  return u ^ (u >> 16);
}

__device__ __forceinline__ uint32_t mix_pair(uint32_t a, uint32_t b) {
  uint32_t h = a ^ (b * 0x9E3779B9u);
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = h ^ b;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

template <typename Word, bool Wide>
__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const int32_t* __restrict__ keys,
                    const Word* __restrict__ weights,
                    const int32_t* __restrict__ query,
                    Word* __restrict__ rows, uint8_t* __restrict__ hit,
                    int64_t n, int64_t dim, uint32_t span, int bucket,
                    int window, int32_t empty) {
  const int lane = threadIdx.x & 31;
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warps only: q is the same on every lane
  int32_t lo, hi;
  uint32_t mixed;
  bool valid;
  if (Wide) {
    lo = query[2 * q];
    hi = query[2 * q + 1];
    mixed = mix_pair(static_cast<uint32_t>(lo), static_cast<uint32_t>(hi));
    valid = hi != empty;
  } else {
    lo = query[q];
    hi = 0;
    mixed = mix32(static_cast<uint32_t>(lo));
    valid = lo != empty;
  }
  const int64_t start = static_cast<int64_t>(mixed % span) * bucket;
  int found = -1;
  if (valid) {
    for (int base = 0; base < window; base += 32) {
      const int s = base + lane;
      bool m = false;
      if (s < window) {
        if (Wide) {
          const int2 k = reinterpret_cast<const int2*>(keys)[start + s];
          m = k.x == lo && k.y == hi;
        } else {
          m = keys[start + s] == lo;
        }
      }
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, m);
      if (ballot) {
        found = base + __ffs(ballot) - 1;
        break;
      }
    }
  }
  Word* dst = rows + q * dim;
  if (found >= 0) {
    const Word* src = weights + (start + found) * dim;
    for (int64_t c = lane; c < dim; c += 32) dst[c] = src[c];
  } else {
    for (int64_t c = lane; c < dim; c += 32) dst[c] = Word(0);
  }
  if (lane == 0) hit[q] = found >= 0 ? 1 : 0;
}

template <typename Word, bool Wide>
int launch(const void* keys, const void* weights, const void* query,
           void* rows, void* hit, int64_t n, int64_t dim, uint32_t span,
           int bucket, int window, int32_t empty, cudaStream_t stream) {
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  probe_gather_kernel<Word, Wide>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const int32_t*>(keys), static_cast<const Word*>(weights),
          static_cast<const int32_t*>(query), static_cast<Word*>(rows),
          static_cast<uint8_t*>(hit), n, dim, span, bucket, window, empty);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry bound through ctypes. keys: [capacity] int32, or [capacity, 2]
// int32 (lo, hi) pairs (8-byte aligned) when wide != 0; query: [n] or
// [n, 2] int32 likewise; weights and rows: [capacity, dim] and [n, dim]
// words of word_bytes (4: float32, 2: bfloat16); hit: [n] bytes (0 or 1).
// Returns cudaGetLastError() after the launch (0 on success); an
// unsupported word size returns -1 and launches nothing. The caller
// guarantees n > 0, capacity % bucket == 0, 1 <= chain <= capacity /
// bucket, and n / 8 below 2^31 blocks.
extern "C" int oe_probe_gather(const void* keys, const void* weights,
                               const void* query, void* rows, void* hit,
                               int64_t n, int64_t capacity, int64_t dim,
                               int bucket, int chain, int empty, int wide,
                               int word_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t span = static_cast<uint32_t>(capacity / bucket - chain + 1);
  const int window = chain * bucket;
  if (word_bytes == 4 && wide)
    return launch<uint32_t, true>(keys, weights, query, rows, hit, n, dim,
                                  span, bucket, window, empty, s);
  if (word_bytes == 4)
    return launch<uint32_t, false>(keys, weights, query, rows, hit, n, dim,
                                   span, bucket, window, empty, s);
  if (word_bytes == 2 && wide)
    return launch<uint16_t, true>(keys, weights, query, rows, hit, n, dim,
                                  span, bucket, window, empty, s);
  if (word_bytes == 2)
    return launch<uint16_t, false>(keys, weights, query, rows, hit, n, dim,
                                   span, bucket, window, empty, s);
  return -1;
}
