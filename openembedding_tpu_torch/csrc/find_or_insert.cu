// Find-or-insert of a hash table's keys (K3) for Hopper (sm_90a): the
// push's and the load's probe, which places missing keys IN PLACE.
//
// Replaces no Pallas kernel: the JAX package's find_or_insert
// (openembedding_tpu/hash_table.py:374) is XLA code, and the port ran it
// as PyTorch operations (hash_table.find_or_insert_reference), one set a
// chain level over every entry: the [n, 128] bucket-window gather, the
// match and EMPTY masks, a stable argsort, a searchsorted, a [128, n]
// cumsum and a scatter plan, whether or not any key was missing. This
// computes the same answer, slot for slot.
//
// The rule it reproduces. At level j every unplaced key of the batch is a
// contender for bucket b0 + j of its window (b0: the window's first
// bucket); the contenders of a bucket are ranked by their index in the
// batch, and rank r takes the bucket's (r + 1)-th EMPTY slot as the bucket
// stands after level j - 1; ranks at or past the bucket's free count move
// on to level j + 1, and after the last level they have failed.
//
// What bounds it: memory latency. A batch that holds its keys already (a
// trained table's steps, the benchmark's hash cell: 106,496 entries of
// which about 16k are valid) needs one dependent window read a key, a few
// hundred bytes, a few microseconds of bytes at 3.35 TB/s; the reference
// moved [n, 128] windows twice a level. So the work is split by what a
// key needs:
// - find_or_insert_find: one pass resolves every valid key by scanning its
//   bucket-aligned window, a group of 8 lanes a key, 16-byte loads, the
//   scan stopping at the first slot, in slot order, that holds the key or
//   EMPTY. That is exact under the precondition K2 states
//   (csrc/probe_gather.cu, ops/probe_gather.py): slots are never freed and
//   a key takes the first free slot of the first bucket of its window that
//   has one, so no stored key lies after an EMPTY slot of its own window.
//   The same precondition makes the find-first order exact: a stored key
//   in bucket b0 + j' > b0 + j was placed there when buckets b0 .. b0 + j'
//   - 1 were full, so at level j the reference ranks it among contenders
//   of a bucket with no free slot, which places nobody. A key that misses
//   joins its start bucket's group: one atomic on the group's count, and
//   one a warp to register new groups.
// - Only misses reach the insert work. The contenders of bucket B at level
//   j + 1 are exactly the losers of bucket B - 1 at level j, so a group
//   (the misses sharing b0) stays together down its chain.
//   find_or_insert_reserve gives each group a segment of one scratch array,
//   find_or_insert_append writes each miss into its group's segment, and
//   find_or_insert_place, one launch a level, gives each group a warp: the
//   warp reads its bucket's keys (one bucket a group a level, so no two
//   warps touch a bucket), takes the free count F, picks the min(s, F)
//   lowest indices of its s contenders (ranked pairwise in shared memory,
//   after a radix select of the F-th lowest when s > 128), writes each
//   winner's key into its free slot and compacts the losers in place for
//   the next level.
// - With no misses the insert launches read the group count and exit, so
//   a call costs a memset of the per-bucket counts (4 bytes a bucket), the
//   find pass and 2 + chain empty launches. Misses cost insert work in
//   proportion to their number and their buckets.
// - The keys found, inserted and failed are added, one atomic a block, to
//   g_counts, a per-device int64 [3] of this module, which
//   oe_find_or_insert_counts reads (never on the step path).
//
// Scratch (int32 words, allocated by the caller, the first kHeader +
// buckets of them zeroed here): a header (the group count, the segment
// cursor), each bucket's count of missing keys, then pos, mb0 and seg of
// [n] and gb0, gstart and gcnt of [min(n, buckets)] words: 2 MB plus
// 24 bytes an entry at 2^19 buckets.
//
// Three key modes, as K2's: int32 keys, wide (lo, hi) int32 pairs (free
// iff the hi word is EMPTY) and int64 keys (free iff the word is
// INT64_MIN). The window start is hashed with hash_table.probe_starts'
// mixing. Keys need 4-byte (int32) or 8-byte (pairs, int64) alignment; a
// 16-byte aligned key array whose bucket is whole 16-byte vectors (every
// table the port allocates) is read in vectors, others slot by slot.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                    // lanes a key in the find pass
constexpr int kLoads = 4;                    // unit loads a lane a step
constexpr int kKeysPerWarp = 32 / kGroup;
constexpr int kKeysPerBlock = kWarps * kKeysPerWarp;
constexpr int kMaxBucket = 128;              // slots a bucket at most
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNone = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;
constexpr int kBlocksPerSm = 8;

// key modes (the C entry's key_mode)
constexpr int kNarrow = 0, kWide = 1, kInt64 = 2;

// header words of the zeroed scratch
constexpr int kGroups = 0;                   // groups registered
constexpr int kCursor = 1;                   // segment words reserved
constexpr int kHeader = 4;

__device__ unsigned long long g_counts[3];   // found, inserted, failed

struct Args {
  int32_t* keys;          // the table's key words, written in place
  const int32_t* query;   // the batch's key words
  const uint8_t* valid;   // [n]
  int64_t* slot;          // [n] out: the key's slot, -1 if none
  uint8_t* inserted;      // [n] out
  uint8_t* failed;        // [n] out
  int32_t* head;          // header + per-bucket miss counts (zeroed)
  int32_t* pos;           // [n]: a miss's place in its group, else -1
  int32_t* mb0;           // [n]: a miss's start bucket
  int32_t* seg;           // [n]: the groups' members, by segment
  int32_t* gb0;           // [ng]: a group's start bucket
  int32_t* gstart;        // [ng]: its segment's first word
  int32_t* gcnt;          // [ng]: its unplaced members
  int64_t n;
  uint32_t span;          // window starts: buckets - chain + 1
  int bucket;
  int window;             // chain * bucket slots
  int chain;
  int32_t empty;
  int top_bit;            // highest bit of an entry index
};

__device__ __forceinline__ uint32_t mix32(uint32_t u) {
  u = (u ^ (u >> 16)) * 0x85EBCA6Bu;
  u = (u ^ (u >> 13)) * 0xC2B2AE35u;
  return u ^ (u >> 16);
}

// hash_table._mix64: the splitmix64 finalizer.
__device__ __forceinline__ uint64_t mix64(uint64_t u) {
  u = (u ^ (u >> 33)) * 0xFF51AFD7ED558CCDull;
  u = (u ^ (u >> 33)) * 0xC4CEB9FE1A85EC53ull;
  return u ^ (u >> 33);
}

__device__ __forceinline__ uint32_t mix_pair(uint32_t a, uint32_t b) {
  uint32_t h = a ^ (b * 0x9E3779B9u);
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = h ^ b;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The first bucket of a key's window (hash_table.window_starts / bucket).
template <int M>
__device__ __forceinline__ uint32_t start_bucket(int32_t lo, int32_t hi,
                                                 uint32_t span) {
  if (M == kInt64) {
    const uint64_t u = (static_cast<uint64_t>(static_cast<uint32_t>(hi))
                        << 32) | static_cast<uint32_t>(lo);
    return static_cast<uint32_t>(mix64(u) % span);
  }
  const uint32_t h = M == kWide ? mix_pair(static_cast<uint32_t>(lo),
                                           static_cast<uint32_t>(hi))
                                : mix32(static_cast<uint32_t>(lo));
  return h % span;
}

// A slot (lo, hi) is free: the word is EMPTY for int32 keys, the hi word
// for pairs, the whole int64 word is INT64_MIN (hi INT32_MIN, lo 0).
template <int M>
__device__ __forceinline__ bool slot_free(int32_t lo, int32_t hi,
                                          int32_t empty) {
  if (M == kNarrow) return lo == empty;
  if (M == kWide) return hi == empty;
  return hi == INT32_MIN && lo == 0;
}

template <int M>
__device__ __forceinline__ void key_words(const int32_t* words, int64_t i,
                                          int32_t& lo, int32_t& hi) {
  if (M == kNarrow) {
    lo = words[i];
    hi = 0;
  } else {
    const int2 k = reinterpret_cast<const int2*>(words)[i];
    lo = k.x;
    hi = k.y;
  }
}

// Adds each thread's v to *dst, one atomic a block; every thread of the
// block calls it, *total zeroed before the block's first barrier.
__device__ __forceinline__ void block_add(unsigned long long* dst,
                                          unsigned v, unsigned* total) {
  v = __reduce_add_sync(kFull, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(total, v);
  __syncthreads();
  if (threadIdx.x == 0 && *total)
    atomicAdd(dst, static_cast<unsigned long long>(*total));
}

// The find pass. A group of kGroup lanes serves one entry; each step a
// lane loads kLoads units (16-byte vectors, or single slots when the keys
// are not vector-aligned), lane gl's load u holding unit step * kStep +
// u * kGroup + gl of the window, so each load instruction reads
// consecutive bytes across the group. The first slot, in slot order, that
// holds the key or EMPTY ends the scan: each lane takes its least
// (position << 1 | stopped at EMPTY), and xor-shuffles give the group's.
template <int M, bool Aligned>
__global__ void __launch_bounds__(kThreads)
    find_or_insert_find(const Args a) {
  constexpr int V = M == kNarrow ? 4 : 2;    // slots a 16-byte vector
  constexpr int SPU = Aligned ? V : 1;       // slots a load unit
  constexpr int kStep = kGroup * kLoads;     // units a step
  __shared__ unsigned total;
  if (threadIdx.x == 0) total = 0;
  const int lane = threadIdx.x & 31;
  const int gl = lane % kGroup;
  const int units = a.window / SPU;
  unsigned found_keys = 0;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kKeysPerBlock;
       base < a.n; base += static_cast<int64_t>(gridDim.x) * kKeysPerBlock) {
    const int64_t i =
        base + (threadIdx.x / 32) * kKeysPerWarp + lane / kGroup;
    bool valid = false;
    int32_t lo = 0, hi = 0;
    uint32_t b0 = 0;
    int64_t start = 0;
    if (i < a.n) {
      valid = a.valid[i] != 0;
      key_words<M>(a.query, i, lo, hi);
      b0 = start_bucket<M>(lo, hi, a.span);
      start = static_cast<int64_t>(b0) * a.bucket;
    }
    bool active = valid;
    unsigned best = kNone;
    // the warp steps its groups together (the shuffles need every lane)
    for (int step = 0; __any_sync(kFull, active); ++step) {
      unsigned stop = 0, at_free = 0;       // bit u * SPU + e
      if (active) {
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int r = step * kStep + u * kGroup + gl;
          if (r >= units) continue;
          int32_t w[4];
          if (Aligned) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(a.keys) +
                                 start / V + r);
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
          } else {
            key_words<M>(a.keys, start + r, w[0], w[1]);
          }
#pragma unroll
          for (int e = 0; e < SPU; ++e) {
            const int32_t klo = M == kNarrow ? w[e] : w[2 * e];
            const int32_t khi = M == kNarrow ? 0 : w[2 * e + 1];
            const bool match = klo == lo && (M == kNarrow || khi == hi);
            const bool is_free = slot_free<M>(klo, khi, a.empty);
            stop |= static_cast<unsigned>(match || is_free) << (u * SPU + e);
            at_free |= static_cast<unsigned>(is_free && !match)
                       << (u * SPU + e);
          }
        }
      }
      unsigned mine = kNone;
      if (stop) {
        const int b = __ffs(stop) - 1;
        const int p = (step * kStep + (b / SPU) * kGroup + gl) * SPU + b % SPU;
        mine = (static_cast<unsigned>(p) << 1) | ((at_free >> b) & 1u);
      }
#pragma unroll
      for (int m = 1; m < kGroup; m <<= 1) {
        const unsigned other = __shfl_xor_sync(kFull, mine, m);
        mine = other < mine ? other : mine;
      }
      if (active) {
        if (mine != kNone) {
          best = mine;
          active = false;
        } else if ((step + 1) * kStep >= units) {
          active = false;                   // a full window: a miss
        }
      }
    }
    const bool found = valid && best != kNone && !(best & 1u);
    const bool miss = valid && !found;
    int32_t p = -1;
    if (gl == 0 && miss) p = atomicAdd(a.head + kHeader + b0, 1);
    // the first miss of a start bucket registers its group
    const bool fresh = gl == 0 && p == 0;
    const unsigned want = __ballot_sync(kFull, fresh);
    if (want) {
      const int leader = __ffs(want) - 1;
      int g0 = 0;
      if (lane == leader) g0 = atomicAdd(a.head + kGroups, __popc(want));
      g0 = __shfl_sync(kFull, g0, leader);
      if (fresh)
        a.gb0[g0 + __popc(want & ((1u << lane) - 1u))] =
            static_cast<int32_t>(b0);
    }
    if (gl == 0 && i < a.n) {
      a.slot[i] = found ? start + (best >> 1) : -1;
      a.inserted[i] = 0;
      a.failed[i] = 0;
      a.pos[i] = p;
      if (miss) a.mb0[i] = static_cast<int32_t>(b0);
    }
    found_keys += gl == 0 && found;
  }
  block_add(&g_counts[0], found_keys, &total);
}

// Each group's segment: its members' count, reserved from the cursor in
// one atomic a warp. The bucket's count is overwritten with the segment's
// first word, for find_or_insert_append.
__global__ void __launch_bounds__(kThreads)
    find_or_insert_reserve(const Args a) {
  const int64_t groups = a.head[kGroups];
  const int lane = threadIdx.x & 31;
  for (int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads +
                    (threadIdx.x & ~31);
       g0 < groups; g0 += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t g = g0 + lane;
    const int32_t b = g < groups ? a.gb0[g] : 0;
    const int s = g < groups ? a.head[kHeader + b] : 0;
    int incl = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    int first = 0;
    if (lane == 31) first = atomicAdd(a.head + kCursor, incl);
    first = __shfl_sync(kFull, first, 31) + incl - s;
    if (g < groups) {
      a.gstart[g] = first;
      a.gcnt[g] = s;
      a.head[kHeader + b] = first;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    find_or_insert_append(const Args a) {
  if (a.head[kGroups] == 0) return;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < a.n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int32_t p = a.pos[i];
    if (p >= 0) a.seg[a.head[kHeader + a.mb0[i]] + p] = static_cast<int32_t>(i);
  }
}

// The k-th lowest (1-based) of s distinct non-negative entries, each below
// 2^(top_bit + 1): a radix select, one pass a bit. The whole warp calls it.
__device__ int32_t select_kth(const int32_t* v, int s, int k, int top_bit,
                              int lane) {
  uint32_t prefix = 0;
  for (int bit = top_bit; bit >= 0; --bit) {
    const uint32_t upper = bit == 31 ? 0u : ~((2u << bit) - 1u);
    const uint32_t probe = upper | (1u << bit);
    unsigned c = 0;
    for (int t = lane; t < s; t += 32)
      c += ((static_cast<uint32_t>(v[t]) ^ prefix) & probe) == 0;
    c = __reduce_add_sync(kFull, c);
    if (static_cast<int>(c) < k) {
      k -= static_cast<int>(c);
      prefix |= 1u << bit;
    }
  }
  return static_cast<int32_t>(prefix);
}

// Position of the n-th (0-based) set bit of m, which has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int p = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const unsigned low = m & ((1u << half) - 1u);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      m >>= half;
      p += half;
    } else {
      m = low;
    }
  }
  return p;
}

// One chain level of the insert: a warp a group, its bucket
// gb0 + level. Winners take their bucket's free slots in rank order;
// losers stay in the segment for the next level, or fail after the last.
template <int M>
__global__ void __launch_bounds__(kThreads)
    find_or_insert_place(const Args a, int level) {
  __shared__ int32_t listed[kWarps][kMaxBucket];
  __shared__ unsigned totals[2];
  const int64_t groups = a.head[kGroups];
  if (groups == 0) return;
  if (threadIdx.x < 2) totals[threadIdx.x] = 0;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int warp = threadIdx.x / 32;
  const bool last = level == a.chain - 1;
  int32_t* list = listed[warp];
  unsigned placed = 0, lost = 0;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       g < groups; g += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int s = a.gcnt[g];
    if (s == 0) continue;
    int32_t* mine = a.seg + a.gstart[g];
    const int64_t first =
        (static_cast<int64_t>(a.gb0[g]) + level) * a.bucket;
    // the bucket's free slots: bit l of fm[k] is slot 32 k + l
    unsigned fm[kMaxBucket / 32];
    int free_slots = 0;
#pragma unroll
    for (int k = 0; k < kMaxBucket / 32; ++k) {
      bool is_free = false;
      if (32 * k + lane < a.bucket) {
        int32_t lo, hi;
        key_words<M>(a.keys, first + 32 * k + lane, lo, hi);
        is_free = slot_free<M>(lo, hi, a.empty);
      }
      fm[k] = __ballot_sync(kFull, is_free);
      free_slots += __popc(fm[k]);
    }
    const int winners = s < free_slots ? s : free_slots;
    int ranked;                              // entries of list to rank
    if (s <= kMaxBucket) {
      for (int t = lane; t < s; t += 32) list[t] = mine[t];
      ranked = s;
    } else if (free_slots == 0) {
      ranked = 0;
    } else {
      // the free_slots lowest indices to the list, the rest kept in the
      // segment (or failed after the last level)
      const int32_t cut = select_kth(mine, s, free_slots, a.top_bit, lane);
      int listed_n = 0, kept = 0;
      for (int t0 = 0; t0 < s; t0 += 32) {
        const int t = t0 + lane;
        const int32_t x = t < s ? mine[t] : 0;
        __syncwarp();                        // the chunk is read first
        const bool win = t < s && x <= cut;
        const bool lose = t < s && x > cut;
        const unsigned bw = __ballot_sync(kFull, win);
        const unsigned bl = __ballot_sync(kFull, lose);
        if (win) list[listed_n + __popc(bw & below)] = x;
        if (lose) {
          if (last) {
            a.failed[x] = 1;
            ++lost;
          } else {
            mine[kept + __popc(bl & below)] = x;
          }
        }
        listed_n += __popc(bw);
        kept += __popc(bl);
      }
      ranked = free_slots;
    }
    if (s > kMaxBucket && free_slots == 0 && last) {
      for (int t = lane; t < s; t += 32) {
        a.failed[mine[t]] = 1;
        ++lost;
      }
    }
    __syncwarp();
    int kept = 0;
    for (int t0 = 0; t0 < ranked; t0 += 32) {
      const int t = t0 + lane;
      const bool have = t < ranked;
      const int32_t x = have ? list[t] : 0;
      int r = 0;
      if (have)
        for (int u = 0; u < ranked; ++u) r += list[u] < x;
      const bool win = have && r < free_slots;
      const bool lose = have && r >= free_slots;
      if (win) {
        int k = 0, rr = r;
        while (rr >= __popc(fm[k])) rr -= __popc(fm[k++]);
        const int64_t at = first + 32 * k + nth_set_bit(fm[k], rr);
        int32_t lo, hi;
        key_words<M>(a.query, x, lo, hi);
        if (M == kNarrow)
          a.keys[at] = lo;
        else
          reinterpret_cast<int2*>(a.keys)[at] = make_int2(lo, hi);
        a.slot[x] = at;
        a.inserted[x] = 1;
        ++placed;
      }
      // losers of a segment ranked whole go back to it, compacted
      const unsigned bl = __ballot_sync(kFull, lose);
      if (lose) {
        if (last) {
          a.failed[x] = 1;
          ++lost;
        } else {
          mine[kept + __popc(bl & below)] = x;
        }
      }
      kept += __popc(bl);
    }
    if (lane == 0) a.gcnt[g] = s - winners;
    __syncwarp();                            // list is reused
  }
  block_add(&g_counts[1], placed, &totals[0]);
  block_add(&g_counts[2], lost, &totals[1]);
}

// Streaming multiprocessors of the current device, queried once a device;
// 0 on a CUDA error (left for cudaGetLastError).
int sm_count() {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) {
    const int c = cached[dev].load(std::memory_order_relaxed);
    if (c > 0) return c;
  }
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < kMaxDevices) cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

int grid(int64_t items, int per_block, int cap) {
  const int64_t need = (items + per_block - 1) / per_block;
  return static_cast<int>(need < cap ? (need > 0 ? need : 1) : cap);
}

template <int M, bool Aligned>
int launch(const Args& a, int64_t groups_max, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? static_cast<int>(err) : -1;
  }
  const int cap = sms * kBlocksPerSm;
  find_or_insert_find<M, Aligned>
      <<<grid(a.n, kKeysPerBlock, cap), kThreads, 0, stream>>>(a);
  find_or_insert_reserve
      <<<grid(groups_max, kThreads, cap), kThreads, 0, stream>>>(a);
  find_or_insert_append<<<grid(a.n, kThreads, cap), kThreads, 0, stream>>>(a);
  for (int level = 0; level < a.chain; ++level)
    find_or_insert_place<M>
        <<<grid(groups_max, kWarps, cap), kThreads, 0, stream>>>(a, level);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_mode(const Args& a, int64_t groups_max, bool aligned,
                cudaStream_t stream) {
  return aligned ? launch<M, true>(a, groups_max, stream)
                 : launch<M, false>(a, groups_max, stream);
}

}  // namespace

// Scratch int32 words a call of oe_find_or_insert needs.
extern "C" int64_t oe_find_or_insert_scratch(int64_t n, int64_t buckets) {
  const int64_t groups = n < buckets ? n : buckets;
  return kHeader + buckets + 3 * n + 3 * groups;
}

// C entry bound through ctypes. keys: [capacity] int32 (key_mode 0),
// [capacity, 2] int32 pairs (1) or [capacity] int64 (2), 8-byte aligned
// for modes 1 and 2, written in place; new_keys: [n] or [n, 2] of the
// same kind; valid, inserted, failed: [n] bytes; slot: [n] int64; scratch:
// oe_find_or_insert_scratch(n, capacity / bucket) int32 words; empty: the
// EMPTY word of modes 0 and 1 (mode 2's is INT64_MIN). Launches on
// stream: a memset of the counts, the find pass, two launches that build
// the groups and one launch a chain level. Returns cudaGetLastError()
// after the launches (0 on success); -1 for arguments out of range,
// launching nothing. The caller guarantees 0 < n < 2^31, capacity %
// bucket == 0, 1 <= bucket <= 128, 1 <= chain <= capacity / bucket, that
// the valid keys are distinct, and that no stored key lies after an EMPTY
// slot of its window (the scan stops there; see the note at the top).
extern "C" int oe_find_or_insert(void* keys, const void* new_keys,
                                 const void* valid, void* slot,
                                 void* inserted, void* failed, void* scratch,
                                 int64_t n, int64_t capacity, int bucket,
                                 int chain, int empty, int key_mode,
                                 void* stream) {
  if (key_mode < kNarrow || key_mode > kInt64 || n <= 0 || n >= (1ll << 31) ||
      bucket < 1 || bucket > kMaxBucket || capacity % bucket != 0 ||
      chain < 1 || chain > capacity / bucket ||
      static_cast<int64_t>(chain) * bucket >= (1ll << 30))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t buckets = capacity / bucket;
  const int64_t groups_max = n < buckets ? n : buckets;
  int32_t* words = static_cast<int32_t*>(scratch);
  Args a;
  a.keys = static_cast<int32_t*>(keys);
  a.query = static_cast<const int32_t*>(new_keys);
  a.valid = static_cast<const uint8_t*>(valid);
  a.slot = static_cast<int64_t*>(slot);
  a.inserted = static_cast<uint8_t*>(inserted);
  a.failed = static_cast<uint8_t*>(failed);
  a.head = words;
  a.pos = words + kHeader + buckets;
  a.mb0 = a.pos + n;
  a.seg = a.mb0 + n;
  a.gb0 = a.seg + n;
  a.gstart = a.gb0 + groups_max;
  a.gcnt = a.gstart + groups_max;
  a.n = n;
  a.span = static_cast<uint32_t>(buckets - chain + 1);
  a.bucket = bucket;
  a.window = chain * bucket;
  a.chain = chain;
  a.empty = empty;
  int top = 0;
  while (top < 30 && (int64_t{1} << (top + 1)) < n) ++top;
  a.top_bit = top;
  const cudaError_t err = cudaMemsetAsync(
      words, 0, (kHeader + buckets) * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = key_mode == kNarrow ? 4 : 2;  // slots a 16-byte vector
  const bool aligned =
      reinterpret_cast<uintptr_t>(keys) % 16 == 0 && bucket % vec == 0;
  if (key_mode == kWide) return launch_mode<kWide>(a, groups_max, aligned, s);
  if (key_mode == kInt64)
    return launch_mode<kInt64>(a, groups_max, aligned, s);
  return launch_mode<kNarrow>(a, groups_max, aligned, s);
}

// The keys found, inserted and failed by this device's launches since the
// module loaded, into out[0..2]; reads g_counts on stream and waits for it.
// Returns a CUDA error code, 0 on success.
extern "C" int oe_find_or_insert_counts(int64_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long got[3] = {0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbolAsync(got, g_counts, sizeof(got), 0,
                                              cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  for (int k = 0; k < 3; ++k) out[k] = static_cast<int64_t>(got[k]);
  return static_cast<int>(err);
}
