// Sparse row gather (embedding pull) for Hopper (sm_90a).
//
// Replaces the TPU kernel openembedding_tpu/ops/pallas_gather.py:_gather_kernel
// (reached from gather_rows, pl.pallas_call): out[i] = table[idx[i]] when
// 0 <= idx[i] < V, else a zero row.
//
// What bounds it: memory latency at serving's shapes, bytes beyond them.
// Each output row is one id read, then one scattered row read that depends
// on it, then a contiguous row write; there is no arithmetic. At 106,496
// dim-9 rows the bytes take under 2 us at 3.35 TB/s, so what costs is how
// many of those dependent reads are in flight at once. A dim-9 float32 row
// is 36 bytes, not 16-byte aligned, and usually spans two 32-byte sectors.
//
// Design:
// - A grid of one wave (blocks per SM from the occupancy API times the SM
//   count, both queried once per device and cached) strides over the rows.
// - Every load and store instruction of a warp still covers consecutive
//   bytes where the layout allows it, and every thread keeps at least 4
//   independent row reads in flight, loaded after its ids and stored
//   after all of them were issued. The widths the serving path uses are
//   template parameters, so nothing divides by a runtime width:
//   - dim 1: a thread takes 4 consecutive rows: one 16-byte id vector (two
//     for int64 ids) when the id array is 16-byte aligned, 4 word loads,
//     one 16-byte store (8 bytes for bfloat16);
//   - dim 9: a warp takes a tile of 32 rows, 288 consecutive output words:
//     lane l loads the id of row l, then words l, l + 32, ... l + 256 of
//     the tile, each from row f / 9 (its id shuffled from that lane), so 9
//     loads are in flight per lane and each instruction reads 32
//     consecutive words of about 4 rows and writes 128 contiguous bytes.
//     (A thread per 4 rows with 16-byte stores, the layout dim 1 uses,
//     issued 9 scalar loads per row to 32 different rows per instruction:
//     1.9x slower on 2^20 uniform ids, PERF.md.)
// - Every other width takes one runtime-width kernel: a row is copied in
//   the widest unit (16, 8, 4 or 2 bytes) that divides it and the table's
//   and output's alignment, by 2^k lanes side by side (the least power of
//   two covering the row's units, at most 32), each lane keeping one unit
//   of each of its 4 rows in flight; rows wider than 32 units loop.
// A copy of bits: float32 and bfloat16 words are copied without conversion.
// Row offsets are 64-bit ((int64)row * D): V * D passes 2^31 for large
// tables. Ids are bounds-checked at their own width, so an int64 id >= 2^32
// is a zero row and never wraps onto a real one.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;            // rows a thread keeps in flight
constexpr int kMaxDevices = 64;

// The widest of 16, 8, 4 and 2 bytes that divides Bytes.
template <int Bytes>
using StoreOf = typename std::conditional<
    Bytes % 16 == 0, uint4,
    typename std::conditional<
        Bytes % 8 == 0, uint2,
        typename std::conditional<Bytes % 4 == 0, uint32_t,
                                  uint16_t>::type>::type>::type;

// The ids of rows r0 .. r0 + kRows - 1 (all < n), widened to int64.
template <typename Index>
__device__ __forceinline__ void load_ids(const Index* __restrict__ idx,
                                         int64_t r0, bool vec,
                                         int64_t (&id)[kRows]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < kRows; k += 16 / static_cast<int>(sizeof(Index))) {
      if constexpr (sizeof(Index) == 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(idx + r0 + k));
        id[k] = v.x;
        id[k + 1] = v.y;
        id[k + 2] = v.z;
        id[k + 3] = v.w;
      } else {
        const longlong2 v =
            __ldg(reinterpret_cast<const longlong2*>(idx + r0 + k));
        id[k] = v.x;
        id[k + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k) id[k] = static_cast<int64_t>(idx[r0 + k]);
  }
}

// kRows consecutive rows of DIM words per thread (the dim-1 path); the
// ragged end (n % kRows rows) is copied row by row.
template <typename Word, typename Index, int DIM>
__global__ void __launch_bounds__(kThreads)
gather_fixed(const Word* __restrict__ table, const Index* __restrict__ idx,
             Word* __restrict__ out, int64_t n, int64_t vocab) {
  constexpr int kWords = kRows * DIM;
  using Store = StoreOf<kWords * static_cast<int>(sizeof(Word))>;
  constexpr int kPer = sizeof(Store) / sizeof(Word);
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t sets = n / kRows;
  for (int64_t t = tid; t < sets; t += stride) {
    int64_t id[kRows];
    load_ids<Index>(idx, t * kRows, vec, id);
    Word w[kWords];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = id[r] >= 0 && id[r] < vocab;
      const Word* src = table + (ok ? id[r] : 0) * DIM;
#pragma unroll
      for (int c = 0; c < DIM; ++c)
        w[r * DIM + c] = ok ? __ldg(src + c) : Word(0);
    }
    Store* dst = reinterpret_cast<Store*>(out + t * kWords);
#pragma unroll
    for (int k = 0; k < kWords / kPer; ++k) {
      Store s;
      memcpy(&s, w + k * kPer, sizeof(Store));
      dst[k] = s;
    }
  }
  const int64_t row = sets * kRows + tid;   // the ragged end
  if (row < n) {
    const int64_t i = static_cast<int64_t>(idx[row]);
    const bool ok = i >= 0 && i < vocab;
    const Word* src = table + (ok ? i : 0) * DIM;
#pragma unroll
    for (int c = 0; c < DIM; ++c)
      out[row * DIM + c] = ok ? __ldg(src + c) : Word(0);
  }
}

// A warp copies a tile of 32 rows of DIM words as 32 * DIM consecutive
// output words: lane l loads the id of row l, then word f = l + 32 k (k <
// DIM) of the tile, from row f / DIM (its id shuffled from lane f / DIM),
// with all DIM loads in flight before the first store. Each load and store
// instruction covers 32 consecutive words of the tile.
template <typename Word, typename Index, int DIM>
__global__ void __launch_bounds__(kThreads)
gather_tile(const Word* __restrict__ table, const Index* __restrict__ idx,
            Word* __restrict__ out, int64_t n, int64_t vocab) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t tile = (static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x) / 32;
       tile * 32 < n; tile += warps) {
    const int64_t r0 = tile * 32;
    const long long id =
        r0 + lane < n ? static_cast<long long>(idx[r0 + lane]) : -1;
    Word w[DIM];
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      const int f = lane + 32 * k;
      const int r = f / DIM;
      const long long rid = __shfl_sync(0xFFFFFFFFu, id, r);
      const bool ok = rid >= 0 && rid < vocab;
      w[k] = ok ? __ldg(table + rid * DIM + (f - r * DIM)) : Word(0);
    }
    const int64_t words = (n - r0) * DIM;      // of this tile, if it is short
    Word* dst = out + r0 * DIM;
#pragma unroll
    for (int k = 0; k < DIM; ++k)
      if (lane + 32 * k < words) dst[lane + 32 * k] = w[k];
  }
}

template <typename Unit, typename Index>
__global__ void __launch_bounds__(kThreads)
gather_units(const Unit* __restrict__ table, const Index* __restrict__ idx,
             Unit* __restrict__ out, int64_t n, int64_t vocab, int64_t units,
             int lane_bits) {
  const int lanes = 1 << lane_bits;
  const int tx = threadIdx.x & (lanes - 1);
  const int sets_per_block = kThreads >> lane_bits;
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * sets_per_block;
  for (int64_t set = static_cast<int64_t>(blockIdx.x) * sets_per_block +
                     (threadIdx.x >> lane_bits);
       set * kRows < n; set += stride) {
    const int64_t r0 = set * kRows;
    int64_t id[kRows];
    if (r0 + kRows <= n) {
      load_ids<Index>(idx, r0, vec, id);
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        id[k] = r0 + k < n ? static_cast<int64_t>(idx[r0 + k]) : -1;
    }
    bool ok[kRows];
    const Unit* src[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      ok[k] = id[k] >= 0 && id[k] < vocab;
      src[k] = table + (ok[k] ? id[k] : 0) * units;
    }
    for (int64_t c = tx; c < units; c += lanes) {
      Unit v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) v[k] = ok[k] ? __ldg(src[k] + c) : Unit{};
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k < n) out[(r0 + k) * units + c] = v[k];
    }
  }
}

// Blocks of one full wave of `kernel` on the current device, queried once
// per device into `cached`; 0 on a CUDA error (left for cudaGetLastError).
template <typename Kernel>
int wave_blocks(Kernel kernel, std::atomic<int>* cached) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) {
    const int w = cached[dev].load(std::memory_order_relaxed);
    if (w > 0) return w;
  }
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int w = per_sm * sms;
  if (dev < kMaxDevices && w > 0)
    cached[dev].store(w, std::memory_order_relaxed);
  return w;
}

int error_or(int fallback) {
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? static_cast<int>(err) : fallback;
}

template <typename Word, typename Index, int DIM>
int launch_fixed(const void* table, const void* idx, void* out, int64_t n,
                 int64_t vocab, cudaStream_t stream) {
  static std::atomic<int> cached[kMaxDevices];
  const int wave = wave_blocks(gather_fixed<Word, Index, DIM>, cached);
  if (wave <= 0) return error_or(-1);
  const int64_t threads = n / kRows > 0 ? n / kRows : 1;
  const int64_t need = (threads + kThreads - 1) / kThreads;
  gather_fixed<Word, Index, DIM>
      <<<static_cast<int>(need < wave ? need : wave), kThreads, 0, stream>>>(
          static_cast<const Word*>(table), static_cast<const Index*>(idx),
          static_cast<Word*>(out), n, vocab);
  return static_cast<int>(cudaGetLastError());
}

template <typename Word, typename Index, int DIM>
int launch_tile(const void* table, const void* idx, void* out, int64_t n,
                int64_t vocab, cudaStream_t stream) {
  static std::atomic<int> cached[kMaxDevices];
  const int wave = wave_blocks(gather_tile<Word, Index, DIM>, cached);
  if (wave <= 0) return error_or(-1);
  const int64_t need = (n + kThreads - 1) / kThreads;   // 32-row tiles
  gather_tile<Word, Index, DIM>
      <<<static_cast<int>(need < wave ? need : wave), kThreads, 0, stream>>>(
          static_cast<const Word*>(table), static_cast<const Index*>(idx),
          static_cast<Word*>(out), n, vocab);
  return static_cast<int>(cudaGetLastError());
}

template <typename Unit, typename Index>
int launch_units(const void* table, const void* idx, void* out, int64_t n,
                 int64_t vocab, int64_t row_bytes, cudaStream_t stream) {
  static std::atomic<int> cached[kMaxDevices];
  const int wave = wave_blocks(gather_units<Unit, Index>, cached);
  if (wave <= 0) return error_or(-1);
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(Unit));
  int lane_bits = 0;
  while (lane_bits < 5 && (int64_t{1} << lane_bits) < units) ++lane_bits;
  const int64_t sets = (n + kRows - 1) / kRows;
  const int64_t per_block = kThreads >> lane_bits;
  const int64_t need = (sets + per_block - 1) / per_block;
  gather_units<Unit, Index>
      <<<static_cast<int>(need < wave ? need : wave), kThreads, 0, stream>>>(
          static_cast<const Unit*>(table), static_cast<const Index*>(idx),
          static_cast<Unit*>(out), n, vocab, units, lane_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename Word, typename Index>
int dispatch(const void* table, const void* idx, void* out, int64_t n,
             int64_t vocab, int64_t dim, cudaStream_t s) {
  if (dim == 1)
    return launch_fixed<Word, Index, 1>(table, idx, out, n, vocab, s);
  if (dim == 9)
    return launch_tile<Word, Index, 9>(table, idx, out, n, vocab, s);
  const int64_t row_bytes = dim * static_cast<int64_t>(sizeof(Word));
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch_units<uint4, Index>(table, idx, out, n, vocab, row_bytes, s);
  if (align % 8 == 0)
    return launch_units<uint2, Index>(table, idx, out, n, vocab, row_bytes, s);
  if (align % 4 == 0)
    return launch_units<uint32_t, Index>(table, idx, out, n, vocab, row_bytes,
                                         s);
  return launch_units<uint16_t, Index>(table, idx, out, n, vocab, row_bytes, s);
}

}  // namespace

// C entry bound through ctypes. word_bytes: 4 (float32) or 2 (bfloat16);
// index_bytes: 4 (int32) or 8 (int64). `out` must be 16-byte aligned (the
// wrapper allocates it). Returns cudaGetLastError() after the launch (0 on
// success); an unsupported combination returns -1 and launches nothing.
// The caller guarantees n > 0 and dim > 0.
extern "C" int oe_gather_rows(const void* table, const void* idx, void* out,
                              int64_t n, int64_t vocab, int64_t dim,
                              int word_bytes, int index_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word_bytes == 4 && index_bytes == 4)
    return dispatch<uint32_t, int32_t>(table, idx, out, n, vocab, dim, s);
  if (word_bytes == 4 && index_bytes == 8)
    return dispatch<uint32_t, int64_t>(table, idx, out, n, vocab, dim, s);
  if (word_bytes == 2 && index_bytes == 4)
    return dispatch<uint16_t, int32_t>(table, idx, out, n, vocab, dim, s);
  if (word_bytes == 2 && index_bytes == 8)
    return dispatch<uint16_t, int64_t>(table, idx, out, n, vocab, dim, s);
  return -1;
}
