// Per-key init rows of a hash table (KI) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes these rows in XLA, in
// openembedding_tpu/hash_table.py:300 (init_rows, a jax.vmap of
// initializer.init over jax.random.fold_in keys). For row i, unless
// skip[i] is set: the key's threefry key is fold_in(fold_in(base, lo), hi)
// for (lo, hi) pair keys, or fold_in(base, key) for int32 keys; element j
// of the row is drawn from the 32 bits x0 ^ x1 of the threefry-2x32 block
// of counter (0, j) under that key (jax.random with
// jax_threefry_partitionable). The draws:
// - uniform: the bits >> 9 under exponent 0, minus 1, then
//   max(lo, fma(u, span, lo)), rounded once, as XLA's CPU code contracts
//   u * (max - min) + min;
// - normal: the uniform draw on (nextafter(-1, 0), 1), then
//   sqrt(2) * erf_inv(u), then * stddev + mean;
// - truncated: the uniform draw between erf(-+2 / sqrt 2), the same
//   erf_inv, clipped to the open interval (-2, 2), then scaled;
// - constant: the value.
// Rows where skip[i] is set are not written: the pull passes the probe
// kernel's rows with skip = hit | EMPTY key, the push the gathered rows
// with skip = not inserted, so one launch fills just the missing rows.
//
// Bit for bit: every float step is an explicit rounding intrinsic
// (__fmaf_rn where JAX rounds once, __fmul_rn and __fadd_rn where it rounds
// twice), so nvcc's default contraction cannot change a result. Uniform
// and constant rows equal JAX's and the plain version's (optim/
// initializers.py keyed_rows) exactly. erf_inv is XLA's ErfInv32 (Giles'
// polynomials) on log1pf and sqrtf, whose last bits may differ from the
// host's; normal rows agree within a few float32 units.
//
// What bounds it: integer operations. A missing key needs 2 + dim threefry
// blocks (1 + dim for int32 keys) of 73 32-bit operations each,
// against 45 bytes written a dim-9 row. Design: one thread per (row,
// element); the thread reads its row's skip byte first and returns, so a
// pull whose keys all hit costs one byte read a thread; otherwise it
// computes its key's fold_ins itself (dim-fold redundant work, bought for
// a launch with no cross-thread step) and its element's block. Elements
// of a row sit on neighbouring threads, so the stores coalesce.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kConstant = 0, kUniform = 1, kTruncated = 3;  // 2: normal
constexpr float kSqrt2 = 1.41421353816986083984375f;        // float32(sqrt(2))

struct Params {
  float p[6];   // see keyed_params in optim/initializers.py
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// One threefry-2x32 block (20 rounds) of counter (x0, x1) under (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.fold_in: the key becomes the block of counter (0, data).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t data) {
  uint32_t x0 = 0, x1 = data;
  threefry(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// XLA's ErfInv32: Giles' single-precision polynomials in w = -log1p(-x^2).
__device__ float erfinv32(float x) {
  constexpr float kLt5[9] = {2.81022636e-08f, 3.43273939e-07f,
                             -3.5233877e-06f, -4.39150654e-06f,
                             0.00021858087f, -0.00125372503f,
                             -0.00417768164f, 0.246640727f, 1.50140941f};
  constexpr float kGe5[9] = {-0.000200214257f, 0.000100950558f,
                             0.00134934322f, -0.00367342844f,
                             0.00573950773f, -0.0076224613f,
                             0.00943887047f, 1.00167406f, 2.83297682f};
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.0f);
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __fadd_rn(lt ? kLt5[i] : kGe5[i], __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? __fmul_rn(x, FLT_MAX) : __fmul_rn(p, x);
}

__device__ __forceinline__ void store(float* out, float v) { *out = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
init_rows_kernel(const int32_t* __restrict__ keys,
                 const uint8_t* __restrict__ skip, T* __restrict__ out,
                 int64_t total, int dim, int wide, uint32_t base0,
                 uint32_t base1, int kind, Params prm) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       e < total; e += stride) {
    const int64_t row = e / dim;
    if (skip[row]) continue;
    const uint32_t j = static_cast<uint32_t>(e - row * dim);
    float v = prm.p[0];
    if (kind != kConstant) {
      uint32_t k0 = base0, k1 = base1;
      if (wide) {
        fold_in(k0, k1, static_cast<uint32_t>(keys[2 * row]));
        fold_in(k0, k1, static_cast<uint32_t>(keys[2 * row + 1]));
      } else {
        fold_in(k0, k1, static_cast<uint32_t>(keys[row]));
      }
      uint32_t x0 = 0, x1 = j;
      threefry(k0, k1, x0, x1);
      const uint32_t bits = x0 ^ x1;
      const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      v = fmaxf(__fmaf_rn(u, prm.p[1], prm.p[0]), prm.p[0]);
      if (kind != kUniform) {
        v = __fmul_rn(erfinv32(v), kSqrt2);
        if (kind == kTruncated) v = fminf(fmaxf(v, prm.p[4]), prm.p[5]);
        v = __fadd_rn(__fmul_rn(v, prm.p[2]), prm.p[3]);
      }
    }
    store(out + e, v);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

}  // namespace

// C entry bound through ctypes. keys: [n] int32, or [n, 2] int32 (lo, hi)
// pairs when wide != 0; skip: [n] bytes (0 or 1); out: [n, dim] words of
// word_bytes (4: float32, 2: bfloat16), contiguous, written where skip is
// 0. (base0, base1): the table's threefry key; kind and p0..p5: the draw
// (optim/initializers.py keyed_params). Returns cudaGetLastError() after
// the launch (0 on success); an unsupported word size or kind returns -1
// and launches nothing. The caller guarantees n > 0 and dim > 0.
extern "C" int oe_init_rows(const void* keys, const void* skip, void* out,
                            int64_t n, int64_t dim, int wide,
                            uint32_t base0, uint32_t base1, int kind,
                            float p0, float p1, float p2, float p3,
                            float p4, float p5, int word_bytes,
                            void* stream) {
  if ((word_bytes != 4 && word_bytes != 2) || kind < kConstant ||
      kind > kTruncated)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params prm = {{p0, p1, p2, p3, p4, p5}};
  const int64_t total = n * dim;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* sk = static_cast<const uint8_t*>(skip);
  if (word_bytes == 4)
    init_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        k, sk, static_cast<float*>(out), total, static_cast<int>(dim), wide,
        base0, base1, kind, prm);
  else
    init_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        k, sk, static_cast<__nv_bfloat16*>(out), total,
        static_cast<int>(dim), wide, base0, base1, kind, prm);
  return static_cast<int>(cudaGetLastError());
}
