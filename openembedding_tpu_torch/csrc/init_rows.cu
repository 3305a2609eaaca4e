// Threefry init rows and arrays (KI) for Hopper (sm_90a), in two modes.
//
// Replaces no TPU kernel: the JAX package draws these values in XLA.
// - Per key (oe_init_rows): openembedding_tpu/hash_table.py:300
//   (init_rows, a jax.vmap of initializer.init over jax.random.fold_in
//   keys). For row i, unless skip[i] is set: the key's threefry key is
//   fold_in(fold_in(base, lo), hi) for (lo, hi) pair keys, or
//   fold_in(base, key) for int32 keys (base passed by value, or read from
//   two words on the device: an offload cache rebuilt in place rewrites
//   them under a captured step); element j of the row is drawn from
//   the 32 bits x0 ^ x1 of the threefry-2x32 block of counter (0, j) under
//   that key.
// - Flat (oe_init_flat): openembedding_tpu/optim/initializers.py:54-74
//   (Uniform/Normal.init) under parallel/sharded_table.py:268-273, and
//   flax's initializers: element i of a whole array takes the bits of the
//   block of counter (c >> 32, c & 0xffffffff), c = offset + i, under one
//   key (jax.random with jax_threefry_partitionable).
// The draws:
// - uniform: the bits >> 9 under exponent 0, minus 1, then
//   max(lo, fma(u, span, lo)), rounded once, as XLA's CPU code contracts
//   u * (max - min) + min;
// - normal: the uniform draw on (nextafter(-1, 0), 1), then
//   sqrt(2) * erf_inv(u), then * stddev + mean;
// - truncated: the uniform draw between erf(-+2 / sqrt 2), the same
//   erf_inv, clipped to the open interval (-2, 2), then scaled;
// - constant: the value.
//
// Bit for bit: every float step is an explicit rounding intrinsic
// (__fmaf_rn where JAX rounds once, __fmul_rn and __fadd_rn where it rounds
// twice), so nvcc's default contraction cannot change a result. Uniform
// and constant values equal JAX's and the plain versions' (optim/
// initializers.py keyed_rows, flat_draw) exactly. erf_inv is XLA's
// ErfInv32 (Giles' polynomials) on log1pf and sqrtf, whose last bits may
// differ from the host's; normal values agree within a few float32 units.
//
// What bounds it: integer operations. A threefry block is 73 32-bit
// operations; a drawn element needs one, a missing key 2 more (1 for int32
// keys), against 4 bytes written an element. Design:
// - Per key: a warp takes 32 consecutive keys. It reads their 32 skip
//   bytes in one coalesced load, and __ballot_sync gives the lanes whose
//   row is missing; a warp with none exits. Each missing lane computes its
//   key's fold_ins once and stages the key and its row in shared memory at
//   its rank among the missing lanes (__popc of the ballot below it).
//   After __syncwarp the warp's m * dim elements are spread over its 32
//   lanes, element e of rank e / dim, so the lanes stay busy however few
//   rows a warp fills. dim is a template constant for 1 and 9 (the main
//   path's widths), so e / dim is a multiply; other widths take the
//   general instance. Indices are 32-bit (the host holds n * dim < 2^31);
//   the grid is ceil(n / 128) blocks of 4 warps, with no grid-stride cap
//   (small blocks spread the last wave's work evenly over the SMs: 9.98
//   against 10.3 us on the main path with blocks of 8 warps, on an H100
//   80GB HBM3 at 700 W). Two other changes measured in the same run did
//   not pay there and are left out: loading the key words beside the
//   skip bytes (no change) and unrolling the element loop by 4 (+12 %; it
//   helps only when every row is missing). A constant draw reads no keys
//   and only writes.
// - Flat: a thread per 4 consecutive elements, one 16-byte store (8 bytes
//   for bfloat16) where the array is aligned so; the counter is 64-bit,
//   the index within a launch 32-bit (the host launches at most 2^30
//   elements at a time).

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // a flat block
constexpr int kKeyThreads = 128;       // a per-key block: 4 warps
constexpr int kWarps = kKeyThreads / 32;
constexpr int kFlatPerThread = 4;
constexpr int kFlatLimit = 1 << 30;
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

// An element's value from the block of counter (x0, x1) under (k0, k1).
__device__ __forceinline__ float draw(uint32_t k0, uint32_t k1, uint32_t x0,
                                      uint32_t x1, int kind,
                                      const Params& prm) {
  if (kind == kConstant) return prm.p[0];
  threefry(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  float v = fmaxf(__fmaf_rn(u, prm.p[1], prm.p[0]), prm.p[0]);
  if (kind != kUniform) {
    v = __fmul_rn(erfinv32(v), kSqrt2);
    if (kind == kTruncated) v = fminf(fmaxf(v, prm.p[4]), prm.p[5]);
    v = __fadd_rn(__fmul_rn(v, prm.p[2]), prm.p[3]);
  }
  return v;
}

__device__ __forceinline__ void store(float* out, float v) { *out = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* out, const float (&v)[4]) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out,
                                       const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&a);
  w.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(out) = w;
}

// Per-key mode: a warp per 32 consecutive keys (see the design above).
// kDim: the row width, or 0 to take it from dim_arg.
template <typename T, int kDim>
__global__ void __launch_bounds__(kKeyThreads)
keyed_rows_kernel(const int32_t* __restrict__ keys,
                  const uint8_t* __restrict__ skip, T* __restrict__ out,
                  int n, int dim_arg, int wide, uint32_t base0,
                  uint32_t base1, const uint32_t* __restrict__ base_key,
                  int kind, Params prm) {
  __shared__ uint32_t s_k0[kWarps][32], s_k1[kWarps][32];
  __shared__ int s_row[kWarps][32];
  const int dim = kDim ? kDim : dim_arg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned row =
      (blockIdx.x * static_cast<unsigned>(kWarps) + warp) * 32u + lane;
  const bool in = row < static_cast<unsigned>(n);
  const bool fill = in && !skip[row];
  const unsigned missing = __ballot_sync(0xffffffffu, fill);
  if (missing == 0) return;
  if (fill) {
    uint32_t k0 = base0, k1 = base1;
    if (base_key != nullptr) {
      k0 = base_key[0];
      k1 = base_key[1];
    }
    if (kind != kConstant) {
      if (wide) {
        fold_in(k0, k1, static_cast<uint32_t>(keys[2 * row]));
        fold_in(k0, k1, static_cast<uint32_t>(keys[2 * row + 1]));
      } else {
        fold_in(k0, k1, static_cast<uint32_t>(keys[row]));
      }
    }
    const int rank = __popc(missing & ((1u << lane) - 1u));
    s_k0[warp][rank] = k0;
    s_k1[warp][rank] = k1;
    s_row[warp][rank] = static_cast<int>(row);
  }
  __syncwarp();
  const int total = __popc(missing) * dim;
  for (int e = lane; e < total; e += 32) {
    const int r = e / dim;
    const int j = e - r * dim;
    const float v = draw(s_k0[warp][r], s_k1[warp][r], 0u,
                         static_cast<uint32_t>(j), kind, prm);
    store(out + s_row[warp][r] * dim + j, v);
  }
}

// Flat mode: a thread per kFlatPerThread consecutive elements; vec != 0
// when out is aligned for one store of them all.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flat_kernel(T* __restrict__ out, int count, uint64_t offset, uint32_t k0,
            uint32_t k1, int kind, Params prm, int vec) {
  const int first =
      (blockIdx.x * kThreads + threadIdx.x) * kFlatPerThread;
  if (first >= count) return;
  float v[kFlatPerThread];
#pragma unroll
  for (int q = 0; q < kFlatPerThread; ++q) {
    const uint64_t c = offset + static_cast<uint64_t>(first + q);
    v[q] = draw(k0, k1, static_cast<uint32_t>(c >> 32),
                static_cast<uint32_t>(c), kind, prm);
  }
  if (vec && first + kFlatPerThread <= count) {
    store4(out + first, v);
  } else {
#pragma unroll
    for (int q = 0; q < kFlatPerThread; ++q)
      if (first + q < count) store(out + first + q, v[q]);
  }
}

template <typename T>
void launch_keyed(const int32_t* keys, const uint8_t* skip, T* out, int n,
                  int dim, int wide, uint32_t base0, uint32_t base1,
                  const uint32_t* base_key, int kind, const Params& prm,
                  cudaStream_t s) {
  const int blocks = (n + kKeyThreads - 1) / kKeyThreads;
  if (dim == 9)
    keyed_rows_kernel<T, 9><<<blocks, kKeyThreads, 0, s>>>(
        keys, skip, out, n, dim, wide, base0, base1, base_key, kind, prm);
  else if (dim == 1)
    keyed_rows_kernel<T, 1><<<blocks, kKeyThreads, 0, s>>>(
        keys, skip, out, n, dim, wide, base0, base1, base_key, kind, prm);
  else
    keyed_rows_kernel<T, 0><<<blocks, kKeyThreads, 0, s>>>(
        keys, skip, out, n, dim, wide, base0, base1, base_key, kind, prm);
}

template <typename T>
void launch_flat(T* out, int count, uint64_t offset, uint32_t k0,
                 uint32_t k1, int kind, const Params& prm, cudaStream_t s) {
  const int per_block = kThreads * kFlatPerThread;
  const int blocks = (count + per_block - 1) / per_block;
  const int vec =
      reinterpret_cast<uintptr_t>(out) % (kFlatPerThread * sizeof(T)) == 0;
  flat_kernel<T><<<blocks, kThreads, 0, s>>>(out, count, offset, k0, k1,
                                             kind, prm, vec);
}

}  // namespace

// C entries bound through ctypes. Each returns cudaGetLastError() after
// its launch (0 on success); arguments it does not take return -1 and
// launch nothing. kind and p0..p5: the draw (optim/initializers.py
// keyed_params); word_bytes: 4 for float32, 2 for bfloat16 values.

// Per key. keys: [n] int32, or [n, 2] int32 (lo, hi) pairs when wide != 0;
// skip: [n] bytes (0 or 1); out: [n, dim] contiguous, written where skip
// is 0; (base0, base1): the table's threefry key, or, when base_key is
// not null, the two words it points to on the device (read at each launch,
// so a captured graph follows a key rewritten in place). Needs n > 0,
// dim > 0 and n * dim < 2^31.
extern "C" int oe_init_rows(const void* keys, const void* skip, void* out,
                            int64_t n, int64_t dim, int wide,
                            uint32_t base0, uint32_t base1,
                            const void* base_key, int kind,
                            float p0, float p1, float p2, float p3,
                            float p4, float p5, int word_bytes,
                            void* stream) {
  if ((word_bytes != 4 && word_bytes != 2) || kind < kConstant ||
      kind > kTruncated || n <= 0 || dim <= 0 ||
      n * dim >= (int64_t{1} << 31))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params prm = {{p0, p1, p2, p3, p4, p5}};
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* sk = static_cast<const uint8_t*>(skip);
  const auto* bk = static_cast<const uint32_t*>(base_key);
  if (word_bytes == 4)
    launch_keyed(k, sk, static_cast<float*>(out), static_cast<int>(n),
                 static_cast<int>(dim), wide, base0, base1, bk, kind, prm,
                 s);
  else
    launch_keyed(k, sk, static_cast<__nv_bfloat16*>(out),
                 static_cast<int>(n), static_cast<int>(dim), wide, base0,
                 base1, bk, kind, prm, s);
  return static_cast<int>(cudaGetLastError());
}

// Flat. out: count contiguous values, element i drawn from the counter
// offset + i under (key0, key1). Needs 0 < count <= 2^30.
extern "C" int oe_init_flat(void* out, int64_t count, uint64_t offset,
                            uint32_t key0, uint32_t key1, int kind,
                            float p0, float p1, float p2, float p3,
                            float p4, float p5, int word_bytes,
                            void* stream) {
  if ((word_bytes != 4 && word_bytes != 2) || kind < kConstant ||
      kind > kTruncated || count <= 0 || count > kFlatLimit)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params prm = {{p0, p1, p2, p3, p4, p5}};
  if (word_bytes == 4)
    launch_flat(static_cast<float*>(out), static_cast<int>(count), offset,
                key0, key1, kind, prm, s);
  else
    launch_flat(static_cast<__nv_bfloat16*>(out), static_cast<int>(count),
                offset, key0, key1, kind, prm, s);
  return static_cast<int>(cudaGetLastError());
}
