// Batched XXH32 and XXH64 of rows on the card: kernels J and K.
//
// Replace the Pallas kernels lz4_tpu/kernels/xxh32_kernel.py _make_kernel
// (launched by _xxh32_stripes) and lz4_tpu/kernels/xxh64_kernel.py
// _make_kernel (launched by _xxh64_stripes).  The TPU kernels computed only
// the four stripe accumulators of every buffer, one buffer per vector lane,
// and left the tail and the avalanche to the host, since the vector unit
// cannot gather single bytes; XXH64 ran on 32-bit hi/lo pairs.  Here a
// kernel computes the whole digest (stripes, tail, avalanche), XXH64 in
// uint64_t, and the host fetches one word per row.
//
// What bounds them on the card: each of a row's four accumulators is a
// serial chain along the row (the rotate breaks any scan), so a row cannot
// be split, and a 64 KB row costs 4,096 (XXH32) or 2,048 (XXH64) dependent
// rounds whatever feeds it: an add, a rotate and a multiply, about 16
// cycles a round on an H100 (XXH64's 64-bit round about 44).  Past that
// chain, bytes: every row is read once.  A kernel that waits on each
// stripe's load from device memory pays a round trip a stripe instead.
//
// The design keeps the chains fed from shared memory:
// - A CTA takes ROWS rows at a time, persistent over groups of ROWS rows
//   (the grid is the groups, at most as many CTAs as fit on the card), so
//   1,024 rows give a CTA to 128 SMs and 4 KB pages several groups a CTA.
// - One producer warp copies the rows through a ring of STAGES stages with
//   bulk asynchronous copies (cp.async.bulk, completing on the stage's
//   full mbarrier); lane r copies row r.  A stage holds TILE bytes of every
//   row and the granule after them, so that a stripe or a tail that starts
//   in the tile lies wholly in it.
// - Bulk copies need 16-byte-aligned addresses and sizes, and a row may
//   start anywhere: a row is copied from the 16-byte granule of its first
//   byte to that of its last (the span), so no copy leaves the granules
//   that hold its bytes, and its words are read at its first byte's offset
//   in the span, s (0..15), two aligned words and a funnel shift each.
//   Stripe i of a row starts at s + STRIPE * i of its span, in tile
//   i / (TILE / STRIPE); the tail starts in tile m / (TILE / STRIPE) for m
//   whole stripes, or the tile of the last stripe when the tail is empty.
// - One consumer warp hashes: LANES = 4 lanes per row, one accumulator
//   each, the words of a batch of stripes loaded while the batch before it
//   runs its rounds (a funnel shift only where a row of the warp is not
//   4-aligned, 8 for XXH64: the branch is taken by the whole warp).  It
//   releases each stage on its empty mbarrier.  Row r's room in a stage is
//   TILE + 48 bytes (48 = 3 x 16 mod 128), so the eight rows' words at one
//   offset fall in different banks.  At the row's last tile its first lane
//   gathers the accumulators by shuffle and finishes the tail and the
//   avalanche from the stage.
// - Rows at most NARROW bytes apart (a batch of short records) take the
//   narrow path: a stage of NSTAGE bytes holds a group of whole rows,
//   copied as one range, so that a copy and a trip round the ring serve
//   dozens of rows; a lane hashes a row, the smaller stages let more CTAs
//   share an SM, and so more short rows, whose time is their tail's and
//   avalanche's latency, are in flight.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;          // rows per group: one consumer warp
constexpr int LANES = 4;         // lanes per row, one accumulator each
constexpr int TILE = 2048;       // bytes of a row per stage
constexpr int STAGES = 4;
constexpr int PITCH = TILE + 48;  // a row's room in a stage
constexpr int STAGE_BYTES = ROWS * PITCH;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8;  // + barriers
constexpr int NARROW = 256;      // rows at most this many bytes apart go
constexpr int NSTAGE = 4096;     // whole, in stages of NSTAGE bytes,
constexpr int RMAX = 256;        // at most RMAX rows a stage
constexpr int NSMEM = STAGES * (NSTAGE + RMAX * 4) + 2 * STAGES * 8;
constexpr int THREADS = 64;      // warp 0 hashes, warp 1 copies
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_DEVICES = 64;
static_assert(ROWS * LANES == 32, "one warp of each role");
static_assert(TILE % 32 == 0 && PITCH % 128 == 48, "tiles and banks");
static_assert((NSTAGE - 32) / NARROW >= ROWS, "a narrow group of ROWS");

// rows a stage of the narrow path holds: as many whole rows `stride` bytes
// apart as fit with their first and last granules, at most RMAX, a multiple
// of ROWS
__host__ __device__ constexpr int narrow_rows(long long stride) {
  return (int)((NSTAGE - 32) / stride < RMAX ? (NSTAGE - 32) / stride : RMAX) /
         ROWS * ROWS;
}

constexpr uint32_t P32_1 = 2654435761u, P32_2 = 2246822519u,
                   P32_3 = 3266489917u, P32_4 = 668265263u,
                   P32_5 = 374761393u;
constexpr uint64_t P64_1 = 11400714785074694791ull,
                   P64_2 = 14029467366897019727ull,
                   P64_3 = 1609587929392839161ull,
                   P64_4 = 9650029242287828579ull,
                   P64_5 = 2870177450012600261ull;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

// -- the stage ring ----------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16) from a 16-byte-aligned global address to shared
// memory; completes on bar's transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// -- the two hashes ----------------------------------------------------------
// A row's bytes in a stage are read through its words w at byte offset
// s & 3: word q of the row's bytes is funnel(w[q], w[q + 1]).
__device__ __forceinline__ uint32_t funnel(const uint32_t* w, int q, int sh) {
  return __funnelshift_r(w[q], w[q + 1], sh);
}

// The stage words a lane reads for its word of one stripe: WORDS of them
// where every row of the warp is ALIGN-aligned (s % ALIGN == 0), one more
// to funnel from where not.  Loaded a batch of stripes before their round.
template <class H, bool AL>
struct Raw {
  static constexpr int N = H::WORDS + (AL ? 0 : 1);
  uint32_t x[N];
  __device__ __forceinline__ void load(const uint32_t* w, int q) {
    if constexpr (AL && N == 2) {
      const uint2 t = *reinterpret_cast<const uint2*>(w + q);
      x[0] = t.x;
      x[1] = t.y;
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = w[q + i];
    }
  }
  __device__ __forceinline__ uint32_t word(int i, int sh) const {
    return AL ? x[i] : __funnelshift_r(x[i], x[i + 1], sh);
  }
};

struct X32 {
  using T = uint32_t;
  static constexpr int STRIPE = 16, WORDS = 1, ALIGN = 4, UNROLL = 8;
  __device__ static T load(const uint32_t* w, int q, int sh) {
    return funnel(w, q, sh);
  }
  template <bool AL>
  __device__ static T value(const Raw<X32, AL>& r, int sh) {
    return r.word(0, sh);
  }
  // the add is kept apart from the multiply (PTX the compiler does not
  // fold): on the chain an add waits less than a multiply-add
  __device__ static T round(T acc, T x) {
    uint32_t y;
    asm("add.u32 %0, %1, %2;" : "=r"(y) : "r"(acc), "r"(x * P32_2));
    return rotl32(y, 13) * P32_1;
  }
  __device__ static T init(T seed, int k) {
    return seed + (k == 0   ? P32_1 + P32_2
                   : k == 1 ? P32_2
                   : k == 2 ? 0u
                            : 0u - P32_1);
  }
  // the digest from the accumulators and the tail at byte offset o of w
  __device__ static T finish(const T (&v)[4], T seed, int n,
                             const uint32_t* w, int o) {
    const int sh = (o & 3) * 8;
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(w);
    uint32_t h = n >= 16 ? rotl32(v[0], 1) + rotl32(v[1], 7) +
                               rotl32(v[2], 12) + rotl32(v[3], 18)
                         : seed + P32_5;
    h += (uint32_t)n;
    int rem = n % 16;
    for (; rem >= 4; rem -= 4, o += 4)
      h = rotl32(h + funnel(w, o >> 2, sh) * P32_3, 17) * P32_4;
    for (; rem > 0; --rem, ++o) h = rotl32(h + bytes[o] * P32_5, 11) * P32_1;
    h ^= h >> 15;
    h *= P32_2;
    h ^= h >> 13;
    h *= P32_3;
    h ^= h >> 16;
    return h;
  }
};

struct X64 {
  using T = uint64_t;
  static constexpr int STRIPE = 32, WORDS = 2, ALIGN = 8, UNROLL = 4;
  template <bool AL>
  __device__ static T value(const Raw<X64, AL>& r, int sh) {
    return (uint64_t)r.word(0, sh) | ((uint64_t)r.word(1, sh) << 32);
  }
  __device__ static T load(const uint32_t* w, int q, int sh) {
    return (uint64_t)funnel(w, q, sh) | ((uint64_t)funnel(w, q + 1, sh) << 32);
  }
  __device__ static T round(T acc, T x) {  // as X32::round
    uint64_t y;
    asm("add.u64 %0, %1, %2;" : "=l"(y) : "l"(acc), "l"(x * P64_2));
    return rotl64(y, 31) * P64_1;
  }
  __device__ static T init(T seed, int k) {
    return seed + (k == 0   ? P64_1 + P64_2
                   : k == 1 ? P64_2
                   : k == 2 ? 0ull
                            : 0ull - P64_1);
  }
  __device__ static T merge(T h, T v) {
    return (h ^ round(0, v)) * P64_1 + P64_4;
  }
  __device__ static T finish(const T (&v)[4], T seed, int n,
                             const uint32_t* w, int o) {
    const int sh = (o & 3) * 8;
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(w);
    uint64_t h;
    if (n >= 32) {
      h = rotl64(v[0], 1) + rotl64(v[1], 7) + rotl64(v[2], 12) +
          rotl64(v[3], 18);
      h = merge(merge(merge(merge(h, v[0]), v[1]), v[2]), v[3]);
    } else {
      h = seed + P64_5;
    }
    h += (uint64_t)n;
    int rem = n % 32;
    for (; rem >= 8; rem -= 8, o += 8)
      h = rotl64(h ^ round(0, load(w, o >> 2, sh)), 27) * P64_1 + P64_4;
    if (rem >= 4) {
      h = rotl64(h ^ ((uint64_t)funnel(w, o >> 2, sh) * P64_1), 23) * P64_2 +
          P64_3;
      rem -= 4;
      o += 4;
    }
    for (; rem > 0; --rem, ++o) h = rotl64(h ^ (bytes[o] * P64_5), 11) * P64_1;
    h ^= h >> 33;
    h *= P64_2;
    h ^= h >> 29;
    h *= P64_3;
    h ^= h >> 32;
    return h;
  }
};

// A row's span: the 16-byte granules from its first byte to its last.
struct Span {
  const uint8_t* base;  // the first granule
  long long bytes;      // the span's length (0 for an empty or absent row)
  int s, n, m;          // first byte in the span, bytes hashed, stripes
  int tiles;            // stages the row takes (0 for an absent row)
};

template <class H>
__device__ __forceinline__ Span span_of(const uint8_t* rows, long long stride,
                                        const int32_t* lens, int N, int B,
                                        long long b, bool live) {
  Span sp{nullptr, 0, 0, 0, 0, 0};
  if (!live || b >= B) return sp;
  const uint8_t* first = rows + b * stride;
  sp.n = min(max(lens[b], 0), N);
  sp.s = (int)(reinterpret_cast<uintptr_t>(first) & 15);
  sp.base = first - sp.s;
  sp.bytes = sp.n ? ((long long)sp.s + sp.n + 15) / 16 * 16 : 0;
  sp.m = sp.n / H::STRIPE;
  constexpr int per = TILE / H::STRIPE;
  sp.tiles = 1 + (sp.n % H::STRIPE ? sp.m / per : max(sp.m - 1, 0) / per);
  return sp;
}

// count stripes into v from the stage words w, this lane's first word of
// the first stripe at q: each batch of UNROLL stripes' words is loaded while
// the batch before it runs its rounds (two buffers, so that no round waits
// on a load issued in its own batch)
template <class H, bool AL>
__device__ __forceinline__ void hash_stripes(typename H::T& v,
                                             const uint32_t* w, int q,
                                             int sh, int count) {
  constexpr int U = H::UNROLL, STEP = H::STRIPE / 4;  // words a stripe
  using R = Raw<H, AL>;
  const int batches = count / U;
  R a[U], b[U];
  auto load = [&](R (&r)[U], int batch) {
#pragma unroll
    for (int u = 0; u < U; ++u) r[u].load(w, q + (batch * U + u) * STEP);
  };
  auto rounds = [&](const R (&r)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) v = H::round(v, H::value(r[u], sh));
  };
  if (batches > 0) load(a, 0);
  int i = 0;
#pragma unroll 1
  for (; i + 2 <= batches; i += 2) {
    load(b, i + 1);
    rounds(a);
    if (i + 2 < batches) load(a, i + 2);
    rounds(b);
  }
  if (i < batches) rounds(a);
  for (int j = batches * U; j < count; ++j) {
    R r;
    r.load(w, q + j * STEP);
    v = H::round(v, H::value(r, sh));
  }
}

template <class H>
__device__ __forceinline__ void xxh_rows(const uint8_t* rows, long long stride,
                                         const int32_t* lens, int N,
                                         typename H::T seed,
                                         typename H::T* out, int B) {
  using T = typename H::T;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  constexpr int per = TILE / H::STRIPE;
  const int lane = threadIdx.x & 31;
  const long long groups = ((long long)B + ROWS - 1) / ROWS;
  uint32_t it = 0;  // tiles this CTA has taken through its ring
  if (threadIdx.x >= 32) {
    // the producer: lane r copies row r of each group, tile after tile
    for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
      const Span sp = span_of<H>(rows, stride, lens, N, B, g * ROWS + lane,
                                 lane < ROWS);
      const int tiles = __reduce_max_sync(FULL, sp.tiles);
      for (int t = 0; t < tiles; ++t, ++it) {
        const int st = it % STAGES;
        const long long at = (long long)t * TILE;
        const int bytes =
            t < sp.tiles
                ? (int)max(min((long long)TILE + 16, sp.bytes - at), 0ll)
                : 0;
        const int total = (int)__reduce_add_sync(FULL, (unsigned)bytes);
        bar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
        if (lane == 0) bar_arrive_expect(full + st, total);
        __syncwarp();
        if (bytes > 0)
          bulk_copy(smem + st * STAGE_BYTES + lane * PITCH, sp.base + at,
                    bytes, full + st);
      }
    }
    return;
  }
  // the consumer: lanes r * LANES .. r * LANES + LANES - 1 hash row r
  const int r = lane / LANES, k = lane % LANES;
  const unsigned mine = ((1u << LANES) - 1) << (r * LANES);
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long b = g * ROWS + r;
    const Span sp = span_of<H>(rows, stride, lens, N, B, b, true);
    const int tiles = __reduce_max_sync(FULL, sp.tiles);
    const bool aligned = __all_sync(FULL, sp.s % H::ALIGN == 0);
    const int sh = (sp.s & 3) * 8;
    T v = H::init(seed, k);
    for (int t = 0; t < tiles; ++t, ++it) {
      const int st = it % STAGES;
      bar_wait(full + st, (it / STAGES) & 1);
      if (t < sp.tiles) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(
            smem + st * STAGE_BYTES + r * PITCH);
        const int i0 = t * per, i1 = min(sp.m, i0 + per);
        // stripe i0's byte s of the stage, this lane's first word after it
        const int q = (sp.s >> 2) + k * H::WORDS;
        if (aligned)
          hash_stripes<H, true>(v, w, q, sh, max(i1 - i0, 0));
        else
          hash_stripes<H, false>(v, w, q, sh, max(i1 - i0, 0));
        if (t == sp.tiles - 1) {
          T all[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            all[j] = __shfl_sync(mine, v, r * LANES + j);
          if (k == 0)
            out[b] = H::finish(all, seed, sp.n, w,
                               sp.s + sp.m * H::STRIPE - t * TILE);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + st);
    }
  }
}

// The narrow path: rows of N <= stride <= NARROW bytes, R = narrow_rows
// of them a group.  A group's rows are one range of memory, copied by one
// bulk copy from the granule of its first byte (`s0` into it) to that of
// the last row's end, so row i lies at byte s0 + i * stride of the stage;
// their lengths go beside it in the stage, read a group ahead.  Lane l of
// the consumer hashes rows l, l + 32, ... of the group.
template <class H>
__device__ __forceinline__ void xxh_narrow(const uint8_t* rows,
                                           long long stride,
                                           const int32_t* lens, int N,
                                           typename H::T seed,
                                           typename H::T* out, int B) {
  using T = typename H::T;
  extern __shared__ __align__(128) uint8_t smem[];
  int32_t* stage_lens = reinterpret_cast<int32_t*>(smem + STAGES * NSTAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_lens + STAGES * RMAX);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int R = narrow_rows(stride);
  const int lane = threadIdx.x & 31;
  const long long groups = ((long long)B + R - 1) / R;
  uint32_t it = 0;
  if (threadIdx.x >= 32) {
    // the producer: the lengths of the next group in flight while this
    // group's are stored and its rows copied
    int ln[RMAX / 32];
    auto fetch = [&](long long g) {
#pragma unroll
      for (int u = 0; u < RMAX / 32; ++u) {
        const long long b = g * R + u * 32 + lane;
        ln[u] = u * 32 + lane < R && b < B ? lens[b] : 0;
      }
    };
    fetch(blockIdx.x);
    for (long long g = blockIdx.x; g < groups; g += gridDim.x, ++it) {
      const int st = it % STAGES;
      bar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
#pragma unroll
      for (int u = 0; u < RMAX / 32; ++u)
        stage_lens[st * RMAX + u * 32 + lane] = ln[u];
      fetch(g + gridDim.x);
      __syncwarp();
      if (lane == 0) {
        const long long count = min((long long)R, B - g * R);
        const uint8_t* first = rows + g * R * stride;
        const uint8_t* lo = first - (reinterpret_cast<uintptr_t>(first) & 15);
        const uintptr_t end =
            reinterpret_cast<uintptr_t>(first + (count - 1) * stride + N);
        const uint32_t bytes = (uint32_t)(((end + 15) & ~(uintptr_t)15) -
                                          reinterpret_cast<uintptr_t>(lo));
        bar_arrive_expect(full + st, bytes);
        bulk_copy(smem + st * NSTAGE, lo, bytes, full + st);
      }
    }
    return;
  }
  // the consumer: a short row's latency is its tail and avalanche, so each
  // lane hashes a row of its own, the four accumulators in step
  for (long long g = blockIdx.x; g < groups; g += gridDim.x, ++it) {
    const int st = it % STAGES;
    const int count = (int)min((long long)R, B - g * R);
    const int s0 =
        (int)(reinterpret_cast<uintptr_t>(rows + g * R * stride) & 15);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(smem + st * NSTAGE);
    bar_wait(full + st, (it / STAGES) & 1);
    for (int i = lane; i < count; i += 32) {
      const int n = min(max(stage_lens[st * RMAX + i], 0), N);
      const int o = s0 + i * (int)stride, m = n / H::STRIPE;
      const int q = o >> 2, sh = (o & 3) * 8;
      T v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = H::init(seed, k);
      for (int j = 0; j < m; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = H::round(v[k], H::load(w, q + (j * 4 + k) * H::WORDS, sh));
      out[g * R + i] = H::finish(v, seed, n, w, o + m * H::STRIPE);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + st);
  }
}

__global__ void __launch_bounds__(THREADS)
    xxh32_kernel(const uint8_t* rows, long long stride, const int32_t* lens,
                 int N, uint32_t seed, uint32_t* out, int B) {
  xxh_rows<X32>(rows, stride, lens, N, seed, out, B);
}

__global__ void __launch_bounds__(THREADS)
    xxh64_kernel(const uint8_t* rows, long long stride, const int32_t* lens,
                 int N, uint64_t seed, uint64_t* out, int B) {
  xxh_rows<X64>(rows, stride, lens, N, seed, out, B);
}

__global__ void __launch_bounds__(THREADS)
    xxh32_narrow_kernel(const uint8_t* rows, long long stride,
                        const int32_t* lens, int N, uint32_t seed,
                        uint32_t* out, int B) {
  xxh_narrow<X32>(rows, stride, lens, N, seed, out, B);
}

__global__ void __launch_bounds__(THREADS)
    xxh64_narrow_kernel(const uint8_t* rows, long long stride,
                        const int32_t* lens, int N, uint64_t seed,
                        uint64_t* out, int B) {
  xxh_narrow<X64>(rows, stride, lens, N, seed, out, B);
}

template <class T>
using Kernel = void (*)(const uint8_t*, long long, const int32_t*, int, T, T*,
                        int);

// One launch over B rows: the narrow kernel where rows lie at most NARROW
// bytes apart, else the general one; as many CTAs as there are groups, at
// most as many as the card holds at once (found once per device and
// kernel, with the shared memory above 48 KB allowed then).
template <class T>
int launch(Kernel<T> wide, Kernel<T> narrow, int (*caps)[MAX_DEVICES],
           const uint8_t* rows, long long stride, const int32_t* lens, int N,
           T seed, T* out, int B, cudaStream_t stream) {
  if (B > 0) {
    const bool thin = N > 0 && N <= stride && stride <= NARROW;
    Kernel<T> kernel = thin ? narrow : wide;
    const int bytes = thin ? NSMEM : SMEM;
    int dev = 0, cap = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) cap = caps[thin][dev];
    if (cap == 0) {
      int sms = 0, per = 0;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                            THREADS, bytes);
      if (err != cudaSuccess) return (int)err;
      cap = max(sms * per, 1);
      if (dev < MAX_DEVICES) caps[thin][dev] = cap;
    }
    const int per_group = thin ? narrow_rows(stride) : ROWS;
    const long long groups = ((long long)B + per_group - 1) / per_group;
    kernel<<<(int)min(groups, (long long)cap), THREADS, bytes, stream>>>(
        rows, stride, lens, N, seed, out, B);
  }
  return (int)cudaGetLastError();
}

int caps32[2][MAX_DEVICES], caps64[2][MAX_DEVICES];

}  // namespace

// rows is [B, >= N] uint8 with `stride` bytes between rows; row b's first
// min(lens[b], N) bytes are hashed.
extern "C" int lz4tt_xxh32_rows(const uint8_t* rows, long long stride,
                                const int32_t* lens, int N, uint32_t seed,
                                uint32_t* out, int B, void* cuda_stream) {
  return launch<uint32_t>(xxh32_kernel, xxh32_narrow_kernel, caps32, rows,
                          stride, lens, N, seed, out, B,
                          (cudaStream_t)cuda_stream);
}

extern "C" int lz4tt_xxh64_rows(const uint8_t* rows, long long stride,
                                const int32_t* lens, int N, uint64_t seed,
                                uint64_t* out, int B, void* cuda_stream) {
  return launch<uint64_t>(xxh64_kernel, xxh64_narrow_kernel, caps64, rows,
                          stride, lens, N, seed, out, B,
                          (cudaStream_t)cuda_stream);
}
