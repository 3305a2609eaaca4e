// Fused hash probe + row gather (hash-table pull) for Hopper (sm_90a).
//
// Replaces the TPU kernel openembedding_tpu/ops/pallas_hash.py:
// _probe_gather_kernel (reached from probe_gather, pl.pallas_call): for each
// query key, compare the chain * bucket keys of its bucket-aligned probe
// window, take the first matching slot and copy that weight row; a miss or
// an EMPTY query (hi word == EMPTY for pair keys) gives a zero row and
// hit = 0.
//
// What bounds it: memory latency, not bytes. A query needs three dependent
// round trips to memory (its key, then a step of window keys, then the
// row), and at serving's shapes (106,496 queries, about 260 B of keys and
// one 36 B row each) the bytes are a few microseconds at 3.35 TB/s. A
// design that leaves one query's round trips alone on a warp waits them
// out one after the other, and issue slots spent on per-slot arithmetic
// count as well (PERF.md: the scan alone, without the row copy, takes
// nearly all of this kernel's time).
//
// Design, in order of what it hides:
// - A group of lanes serves one query and the warp steps its groups
//   together. Each lane loads keys 16 bytes at a time (two (lo, hi) pairs
//   or four int32 keys), 4 independent loads per step; lane l's load u
//   holds vector u * (group size) + l of the step, so each load
//   instruction reads consecutive bytes across the group. Two shapes,
//   picked by the launch's size: with more queries than one wave holds at
//   one query a group, 4-lane groups (8 queries a warp, 256-byte steps:
//   32 pair or 64 int32 slots), since there throughput decides; otherwise
//   8-lane groups with 512-byte steps, since there the longest scan
//   decides and a full window takes half the dependent steps.
// - The first slot in slot order that holds the query's key or EMPTY ends
//   the scan: each lane takes the least (position << 1 | is_empty) over
//   its slots, and two xor-shuffles give the group's least, the slot
//   find_rows' argmax picks (or, if EMPTY comes first, a miss). Stopping
//   at EMPTY is exact under a precondition that every table the port or
//   the JAX package builds meets: slots are never freed and a key takes
//   the first free slot of the first bucket of its window that has one
//   (find_or_insert: rank r takes the (r+1)-th free slot, and a key moves
//   to bucket b + 1 only when bucket b filled up). So no stored key lies
//   after an EMPTY slot of its own window, and a miss ends in the step that
//   holds its first EMPTY slot, usually in its start bucket. A table
//   written some other way (keys placed past a free slot of their window)
//   may answer a miss for a stored key.
// - Per-slot work is a few 32-bit compares: positions are 32-bit offsets
//   in the window, the window start is hashed with a multiply-based
//   modulo, and when the key array is 16-byte aligned and a bucket is
//   whole vectors (every table the port allocates) the window is whole
//   vectors inside the table, so a step masks vectors, not slots. Other
//   alignments take a second instantiation that masks each slot and
//   splits a vector across a table end into single-slot loads.
// - A grid of one wave (blocks per SM from the occupancy API times the SM
//   count, both queried once per device and cached) strides over the
//   queries, with a software pipeline in registers: a group's next query
//   is loaded (by its first lane, then shuffled) one iteration ahead, and
//   its first key step is issued before the current query's row stores,
//   so the row copy overlaps the next window's first load, as the TPU
//   kernel's double-buffered key DMAs (pallas_hash.py:63-74) overlap a
//   grid step with the next one's keys.
// - Each group copies its own row in the widest unit (16, 8, 4 or 2 bytes)
//   that divides the row and the weights' and output's alignment, so
//   float32 and bfloat16 words are copied as bits, without conversion.
// The window start is hashed in the kernel with the same 32-bit mixing as
// hash_table.probe_starts (_mix for int32 keys, _mix_pair for pairs), so a
// lookup is one launch. Keys and rows are addressed with 64-bit offsets;
// keys need 4-byte (int32) or 8-byte (pairs) alignment.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

// A group shape: kGroup lanes per query, kLoads 16-byte key loads per lane
// per step (kStepVecs vectors, 16 * kStepVecs bytes a step).
template <int G, int L>
struct Shape {
  static constexpr int kGroup = G;
  static constexpr int kLoads = L;
  static constexpr int kStepVecs = G * L;
  static constexpr int kGroupsPerWarp = 32 / G;
  static constexpr int kGroupsPerBlock = kWarpsPerBlock * kGroupsPerWarp;
};
// Many queries: throughput decides, so 4 lanes a query (8 queries a warp)
// and 256-byte steps. Few queries (one wave holds them all at one query a
// group): the longest scan decides, so 8 lanes and 512-byte steps, half
// the dependent steps through a full window.
using Many = Shape<4, 4>;
using Few = Shape<8, 4>;

template <bool Wide>
constexpr int kVec = Wide ? 2 : 4;   // slots per 16-byte vector
constexpr int kRowRegs = 4;         // row units per lane held in registers
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNone = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

struct Args {
  const int32_t* keys;
  const void* weights;
  const int32_t* query;
  void* rows;
  uint8_t* hit;
  int64_t n;
  int64_t capacity;
  int64_t units;        // row length in copy units
  uint64_t span_magic;  // ~0 / span + 1: x % span by multiplication
  uint32_t span;        // window starts: buckets - chain + 1
  int bucket;
  int window;           // chain * bucket slots
  int32_t empty;
  int mis;              // slots between the 16-byte boundary and keys[0]
  int64_t vlo, vhi;     // vectors [vlo, vhi) lie wholly inside the table
};

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

// x % d for 32-bit x and d, exact, with magic = ~0 / d + 1 (Lemire, Kaser
// and Kurz, "Faster remainder by direct computation", 2019).
__device__ __forceinline__ uint32_t fastmod(uint32_t x, uint64_t magic,
                                            uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(magic * x, d));
}

// One group's query in flight. Vector v of the key array holds slots
// v * V - mis .. v * V - mis + V - 1; the window's vectors are vbase ..
// vbase + nvec - 1, and position p = r * V + e of vector vbase + r is slot
// start + p - off.
template <class S, bool Wide>
struct Probe {
  bool active;          // a valid query whose answer is not known yet
  int32_t lo, hi;
  int64_t start;        // the window's first slot
  int64_t vbase;
  int off;
  int nvec;
  int step;             // the step whose keys are in kv
  int64_t slot;         // the matched slot, or -1
  int4 kv[S::kLoads];
};

template <bool Wide, bool Aligned>
__device__ __forceinline__ int4 load_vec(const Args& a, const int4* kbase,
                                         int64_t v) {
  constexpr int V = kVec<Wide>;
  if (Aligned || (v >= a.vlo && v < a.vhi)) return __ldg(kbase + v);
  int w[4] = {0, 0, 0, 0};              // a vector across a table end
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int64_t s = v * V - a.mis + e;
    if (s >= 0 && s < a.capacity) {
      if (Wide) {
        const int2 k = __ldg(reinterpret_cast<const int2*>(a.keys) + s);
        w[2 * e] = k.x;
        w[2 * e + 1] = k.y;
      } else {
        w[e] = __ldg(a.keys + s);
      }
    }
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// Lane gl's load u of a step reads vector step * kStepVecs + u * kGroup +
// gl of the window: each load instruction reads consecutive bytes.
template <class S, bool Wide, bool Aligned>
__device__ __forceinline__ void issue(Probe<S, Wide>& p, const Args& a,
                                      const int4* kbase, int gl) {
#pragma unroll
  for (int u = 0; u < S::kLoads; ++u) {
    const int r = p.step * S::kStepVecs + u * S::kGroup + gl;
    p.kv[u] = (p.active && r < p.nvec)
                  ? load_vec<Wide, Aligned>(a, kbase, p.vbase + r)
                  : make_int4(0, 0, 0, 0);
  }
}

// The group's first lane loads query q; open() shuffles it to the group.
template <bool Wide>
__device__ __forceinline__ void fetch(const Args& a, int64_t q, int gl,
                                      int32_t& lo, int32_t& hi) {
  lo = 0;
  hi = 0;
  if (gl == 0 && q < a.n) {
    if (Wide) {
      lo = __ldg(a.query + 2 * q);
      hi = __ldg(a.query + 2 * q + 1);
    } else {
      lo = __ldg(a.query + q);
    }
  }
}

template <class S, bool Wide, bool Aligned>
__device__ __forceinline__ void open(Probe<S, Wide>& p, const Args& a,
                                     const int4* kbase, int64_t q, int32_t lo,
                                     int32_t hi, int gshift, int gl) {
  constexpr int V = kVec<Wide>;
  p.lo = __shfl_sync(kFull, lo, gshift);
  p.hi = Wide ? __shfl_sync(kFull, hi, gshift) : 0;
  const uint32_t mixed =
      Wide ? mix_pair(static_cast<uint32_t>(p.lo), static_cast<uint32_t>(p.hi))
           : mix32(static_cast<uint32_t>(p.lo));
  p.start = static_cast<int64_t>(fastmod(mixed, a.span_magic, a.span)) *
            a.bucket;
  const int64_t first = p.start + a.mis;
  p.vbase = first / V;
  p.off = Aligned ? 0 : static_cast<int>(first - p.vbase * V);
  p.nvec = Aligned ? a.window / V : (p.off + a.window + V - 1) / V;
  p.step = 0;
  p.slot = -1;
  p.active = q < a.n && (Wide ? p.hi : p.lo) != a.empty;
  issue<S, Wide, Aligned>(p, a, kbase, gl);
}

// Compare one step; the whole warp calls it. The group's first slot, in
// slot order, holding the key or EMPTY ends the scan. A lane's slots are
// in slot order by (load, slot in vector), so its first stopping slot is
// the lowest set bit of its stop flags; the group's is the least (position
// << 1 | is_empty) over its lanes. Afterwards p.active says whether the
// query needs another step.
template <class S, bool Wide, bool Aligned>
__device__ __forceinline__ void scan(Probe<S, Wide>& p, const Args& a, int gl) {
  constexpr int V = kVec<Wide>;
  unsigned best = kNone;
  if (p.active) {
    unsigned stop = 0, free = 0;
#pragma unroll
    for (int u = 0; u < S::kLoads; ++u) {
      const int r = p.step * S::kStepVecs + u * S::kGroup + gl;
      const int k[4] = {p.kv[u].x, p.kv[u].y, p.kv[u].z, p.kv[u].w};
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int pos = r * V + e;
        const bool in = Aligned ? r < p.nvec
                                : pos >= p.off && pos < p.off + a.window;
        const int32_t klo = Wide ? k[2 * e] : k[e];
        const int32_t khi = Wide ? k[2 * e + 1] : 0;
        const bool match = klo == p.lo && (!Wide || khi == p.hi);
        const bool is_free = (Wide ? khi : klo) == a.empty;
        stop |= static_cast<unsigned>(in && (match || is_free)) << (u * V + e);
        free |= static_cast<unsigned>(is_free) << (u * V + e);
      }
    }
    if (stop) {
      const int i = __ffs(stop) - 1;
      const int pos =
          (p.step * S::kStepVecs + (i / V) * S::kGroup + gl) * V + i % V;
      best = (static_cast<unsigned>(pos) << 1) | ((free >> i) & 1u);
    }
  }
#pragma unroll
  for (int m = 1; m < S::kGroup; m <<= 1) {
    const unsigned other = __shfl_xor_sync(kFull, best, m);
    best = other < best ? other : best;
  }
  if (p.active) {
    if (best != kNone) {
      p.active = false;
      if (!(best & 1)) p.slot = p.start + static_cast<int>(best >> 1) - p.off;
    } else if (++p.step * S::kStepVecs >= p.nvec) {
      p.active = false;
    }
  }
}

template <typename Unit, class S, bool Wide, bool Aligned>
__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int gshift = (lane / S::kGroup) * S::kGroup;
  const int gl = lane % S::kGroup;
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * S::kGroupsPerBlock;
  const int64_t q0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      threadIdx.x / 32) * S::kGroupsPerWarp;
  const int4* kbase = reinterpret_cast<const int4*>(
      reinterpret_cast<uintptr_t>(a.keys) & ~uintptr_t(15));
  const Unit* __restrict__ weights = static_cast<const Unit*>(a.weights);
  Unit* __restrict__ rows = static_cast<Unit*>(a.rows);

  int64_t q = q0 + lane / S::kGroup;
  int32_t lo, hi;
  fetch<Wide>(a, q, gl, lo, hi);
  Probe<S, Wide> cur;
  open<S, Wide, Aligned>(cur, a, kbase, q, lo, hi, gshift, gl);
  fetch<Wide>(a, q + stride, gl, lo, hi);     // one query ahead

  // w0 is the same on every lane of a warp: the warp stays converged
  for (int64_t w0 = q0; w0 < a.n; w0 += stride, q += stride) {
    scan<S, Wide, Aligned>(cur, a, gl);
    while (__any_sync(kFull, cur.active)) {
      issue<S, Wide, Aligned>(cur, a, kbase, gl);
      scan<S, Wide, Aligned>(cur, a, gl);
    }
    const bool found = cur.slot >= 0;
    const Unit* src = weights + (found ? cur.slot : 0) * a.units;
    Unit r[kRowRegs];
#pragma unroll
    for (int i = 0; i < kRowRegs; ++i) {
      const int64_t c = gl + i * S::kGroup;
      r[i] = (found && c < a.units) ? __ldg(src + c) : Unit{};
    }
    // the next query's first key step goes out before this row's stores
    open<S, Wide, Aligned>(cur, a, kbase, q + stride, lo, hi, gshift, gl);
    fetch<Wide>(a, q + 2 * stride, gl, lo, hi);
    if (q < a.n) {
      Unit* dst = rows + q * a.units;
#pragma unroll
      for (int i = 0; i < kRowRegs; ++i) {
        const int64_t c = gl + i * S::kGroup;
        if (c < a.units) dst[c] = r[i];
      }
      for (int64_t c = gl + kRowRegs * S::kGroup; c < a.units; c += S::kGroup)
        dst[c] = found ? __ldg(src + c) : Unit{};
      if (gl == 0) a.hit[q] = found ? 1 : 0;
    }
  }
}

// Blocks of one full wave of kernel on the current device, queried once per
// device and cached; 0 on a CUDA error (left for cudaGetLastError).
template <typename Unit, class S, bool Wide, bool Aligned>
int wave_blocks() {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) {
    const int w = cached[dev].load(std::memory_order_relaxed);
    if (w > 0) return w;
  }
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_gather_kernel<Unit, S, Wide, Aligned>, kThreads,
          0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int w = per_sm * sms;
  if (dev < kMaxDevices && w > 0)
    cached[dev].store(w, std::memory_order_relaxed);
  return w;
}

template <typename Unit, class S, bool Wide, bool Aligned>
int launch(const Args& a, int wave, cudaStream_t stream) {
  if (wave <= 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? static_cast<int>(err) : -1;
  }
  const int64_t need = (a.n + S::kGroupsPerBlock - 1) / S::kGroupsPerBlock;
  const int blocks = static_cast<int>(need < wave ? need : wave);
  probe_gather_kernel<Unit, S, Wide, Aligned>
      <<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The shape: Few when one wave of it holds every query at one query a
// group, else Many.
template <typename Unit, bool Wide, bool Aligned>
int launch_shape(const Args& a, cudaStream_t stream) {
  const int few = wave_blocks<Unit, Few, Wide, Aligned>();
  if (few > 0 && a.n <= static_cast<int64_t>(few) * Few::kGroupsPerBlock)
    return launch<Unit, Few, Wide, Aligned>(a, few, stream);
  return launch<Unit, Many, Wide, Aligned>(
      a, few > 0 ? wave_blocks<Unit, Many, Wide, Aligned>() : few, stream);
}

// Aligned: the key array starts on a 16-byte boundary and a bucket is whole
// vectors, so every window is whole vectors inside the table and a step
// masks vectors, not slots.
template <typename Unit>
int launch_unit(const Args& a, bool wide, cudaStream_t stream) {
  const int vec = wide ? 2 : 4;
  const bool aligned = a.mis == 0 && a.bucket % vec == 0;
  if (wide)
    return aligned ? launch_shape<Unit, true, true>(a, stream)
                   : launch_shape<Unit, true, false>(a, stream);
  return aligned ? launch_shape<Unit, false, true>(a, stream)
                 : launch_shape<Unit, false, false>(a, stream);
}

}  // namespace

// C entry bound through ctypes. keys: [capacity] int32 (4-byte aligned), or
// [capacity, 2] int32 (lo, hi) pairs (8-byte aligned) when wide != 0;
// query: [n] or [n, 2] int32 likewise; weights and rows: [capacity, dim]
// and [n, dim] words of word_bytes (4: float32, 2: bfloat16); hit: [n]
// bytes (0 or 1). Returns cudaGetLastError() after the launch (0 on
// success); an unsupported word size returns -1 and launches nothing. The
// caller guarantees n > 0, capacity % bucket == 0 and 1 <= chain <=
// capacity / bucket, and that no stored key lies after an EMPTY slot of
// its window (the scan stops there; see the note at the top).
extern "C" int oe_probe_gather(const void* keys, const void* weights,
                               const void* query, void* rows, void* hit,
                               int64_t n, int64_t capacity, int64_t dim,
                               int bucket, int chain, int empty, int wide,
                               int word_bytes, void* stream) {
  if (word_bytes != 4 && word_bytes != 2) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = wide ? 2 : 4;                 // slots per 16 bytes
  const int64_t row_bytes = dim * word_bytes;
  Args a;
  a.keys = static_cast<const int32_t*>(keys);
  a.weights = weights;
  a.query = static_cast<const int32_t*>(query);
  a.rows = rows;
  a.hit = static_cast<uint8_t*>(hit);
  a.n = n;
  a.capacity = capacity;
  a.span = static_cast<uint32_t>(capacity / bucket - chain + 1);
  a.span_magic = ~uint64_t{0} / a.span + 1;
  a.bucket = bucket;
  a.window = chain * bucket;
  a.empty = empty;
  a.mis = static_cast<int>((reinterpret_cast<uintptr_t>(keys) & 15) /
                           (16 / vec));
  a.vlo = a.mis ? 1 : 0;
  a.vhi = (capacity + a.mis) / vec;
  const uintptr_t align = reinterpret_cast<uintptr_t>(weights) |
                          reinterpret_cast<uintptr_t>(rows) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) {
    a.units = row_bytes / 16;
    return launch_unit<uint4>(a, wide, s);
  }
  if (align % 8 == 0) {
    a.units = row_bytes / 8;
    return launch_unit<uint2>(a, wide, s);
  }
  if (align % 4 == 0) {
    a.units = row_bytes / 4;
    return launch_unit<uint32_t>(a, wide, s);
  }
  a.units = row_bytes / 2;
  return launch_unit<uint16_t>(a, wide, s);
}
