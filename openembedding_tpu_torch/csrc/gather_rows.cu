// Sparse row gather (embedding pull) for Hopper (sm_90a).
//
// Replaces the TPU kernel openembedding_tpu/ops/pallas_gather.py:_gather_kernel
// (reached from gather_rows, pl.pallas_call): out[i] = table[idx[i]] when
// 0 <= idx[i] < V, else a zero row.
//
// What bounds it: bytes. Each output row is one scattered row read of the
// table plus one id read and one contiguous row write; there is no
// arithmetic. A dim-9 float32 row is 36 bytes, not 16-byte aligned, and
// usually spans two 32-byte sectors, so 16-byte vector loads do not apply.
//
// Design: a copy of bits, so one template covers float32 (4-byte words) and
// bfloat16 (2-byte words) without any float conversion. A block of 256
// threads covers max(1, 256 / D) whole rows; thread t serves column t % D
// of row t / D, so the threads of a warp read the consecutive words of a
// few consecutive output rows (coalesced writes, and each table row is one
// contiguous run of words). Rows wider than the block loop over columns.
// Row offsets are 64-bit ((int64)row * D): V * D passes 2^31 for large
// tables. Ids are bounds-checked at their own width, so an int64 id >= 2^32
// is a zero row and never wraps onto a real one. The TPU kernel's 8 DMAs in
// flight per grid step and its 128-lane row padding have no counterpart:
// the card hides latency with many resident warps instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Word, typename Index>
__global__ void gather_rows_kernel(const Word* __restrict__ table,
                                   const Index* __restrict__ idx,
                                   Word* __restrict__ out,
                                   int64_t n, int64_t vocab, int64_t dim,
                                   int rows_per_block) {
  const int t = threadIdx.x;
  const int r = t / static_cast<int>(dim < kThreads ? dim : kThreads);
  if (r >= rows_per_block) return;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rows_per_block + r;
  if (row >= n) return;
  const int64_t id = static_cast<int64_t>(idx[row]);
  const bool valid = id >= 0 && id < vocab;
  const Word* src = table + (valid ? id : 0) * dim;
  Word* dst = out + row * dim;
  const int64_t step = dim < kThreads ? dim : kThreads;
  for (int64_t c = t - static_cast<int64_t>(r) * step; c < dim; c += step) {
    dst[c] = valid ? src[c] : Word(0);
  }
}

template <typename Word, typename Index>
int launch(const void* table, const void* idx, void* out, int64_t n,
           int64_t vocab, int64_t dim, cudaStream_t stream) {
  const int per = dim < kThreads ? static_cast<int>(kThreads / dim) : 1;
  const int64_t blocks = (n + per - 1) / per;
  gather_rows_kernel<Word, Index><<<static_cast<unsigned>(blocks), kThreads,
                                    0, stream>>>(
      static_cast<const Word*>(table), static_cast<const Index*>(idx),
      static_cast<Word*>(out), n, vocab, dim, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry bound through ctypes. word_bytes: 4 (float32) or 2 (bfloat16);
// index_bytes: 4 (int32) or 8 (int64). Returns cudaGetLastError() after the
// launch (0 on success); an unsupported combination returns -1 and launches
// nothing. The caller guarantees n > 0, dim > 0 and n / rows_per_block
// below 2^31 blocks.
extern "C" int oe_gather_rows(const void* table, const void* idx, void* out,
                              int64_t n, int64_t vocab, int64_t dim,
                              int word_bytes, int index_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word_bytes == 4 && index_bytes == 4)
    return launch<uint32_t, int32_t>(table, idx, out, n, vocab, dim, s);
  if (word_bytes == 4 && index_bytes == 8)
    return launch<uint32_t, int64_t>(table, idx, out, n, vocab, dim, s);
  if (word_bytes == 2 && index_bytes == 4)
    return launch<uint16_t, int32_t>(table, idx, out, n, vocab, dim, s);
  if (word_bytes == 2 && index_bytes == 8)
    return launch<uint16_t, int64_t>(table, idx, out, n, vocab, dim, s);
  return -1;
}
