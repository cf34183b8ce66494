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
// What bounds them on the card: bytes.  A digest reads its row once and
// does a multiply, a rotate and a multiply per 4 (XXH32) or 8 (XXH64) input
// bytes, but each accumulator is a serial chain along the row, so a row
// cannot be split: the parallelism is the rows and the four accumulators.
// The design: four lanes per row, lane k carrying accumulator k and reading
// word k of every stripe, so the four lanes read 16 (or 32) consecutive
// bytes; the accumulators meet by shuffle and lane 0 of the four finishes
// the tail.  Eight rows share a warp, and a block is one warp so that rows
// spread over the SMs.  Rows are read along their length by their own four
// lanes, so loads of neighbouring rows do not coalesce.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 4;      // lanes per row: one per accumulator
constexpr int THREADS = 32;   // one warp, eight rows

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

// Little-endian loads; the word-wide load only where the address allows it.
__device__ __forceinline__ uint32_t read32(const uint8_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

__device__ __forceinline__ uint64_t read64(const uint8_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint64_t*>(p);
  return (uint64_t)read32(p, false) | ((uint64_t)read32(p + 4, false) << 32);
}

__device__ __forceinline__ uint32_t round32(uint32_t acc, uint32_t w) {
  return rotl32(acc + w * P32_2, 13) * P32_1;
}

__device__ __forceinline__ uint64_t round64(uint64_t acc, uint64_t w) {
  return rotl64(acc + w * P64_2, 31) * P64_1;
}

__device__ __forceinline__ uint64_t merge64(uint64_t h, uint64_t v) {
  return (h ^ round64(0, v)) * P64_1 + P64_4;
}

// Row and accumulator of this thread; rows past B hash nothing.
struct Slot {
  int row, k, n;
  const uint8_t* p;
  unsigned base;  // first lane of the row's four
};

__device__ __forceinline__ Slot slot(const uint8_t* rows, long long stride,
                                     const int32_t* lens, int N, int B) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  Slot s;
  s.row = t / LANES;
  s.k = t % LANES;
  const bool live = s.row < B;
  s.n = live ? min(max(lens[s.row], 0), N) : 0;
  s.p = rows + (live ? s.row * stride : 0);
  s.base = threadIdx.x & ~(LANES - 1);
  return s;
}

__global__ void xxh32_kernel(const uint8_t* rows, long long stride,
                             const int32_t* lens, int N, uint32_t seed,
                             uint32_t* out, int B) {
  const Slot s = slot(rows, stride, lens, N, B);
  const bool al = (reinterpret_cast<uintptr_t>(s.p) & 3) == 0;
  uint32_t v = seed + (s.k == 0   ? P32_1 + P32_2
                       : s.k == 1 ? P32_2
                       : s.k == 2 ? 0u
                                  : 0u - P32_1);
  const int stripes = s.n / 16;
  for (int i = 0; i < stripes; ++i)
    v = round32(v, read32(s.p + 16 * i + 4 * s.k, al));
  __syncwarp();
  const uint32_t v0 = __shfl_sync(0xFFFFFFFFu, v, s.base),
                 v1 = __shfl_sync(0xFFFFFFFFu, v, s.base + 1),
                 v2 = __shfl_sync(0xFFFFFFFFu, v, s.base + 2),
                 v3 = __shfl_sync(0xFFFFFFFFu, v, s.base + 3);
  if (s.k != 0 || s.row >= B) return;
  uint32_t h = s.n >= 16 ? rotl32(v0, 1) + rotl32(v1, 7) + rotl32(v2, 12) +
                               rotl32(v3, 18)
                         : seed + P32_5;
  h += (uint32_t)s.n;
  int pos = stripes * 16;
  for (; pos + 4 <= s.n; pos += 4)
    h = rotl32(h + read32(s.p + pos, al) * P32_3, 17) * P32_4;
  for (; pos < s.n; ++pos) h = rotl32(h + s.p[pos] * P32_5, 11) * P32_1;
  h ^= h >> 15;
  h *= P32_2;
  h ^= h >> 13;
  h *= P32_3;
  h ^= h >> 16;
  out[s.row] = h;
}

__global__ void xxh64_kernel(const uint8_t* rows, long long stride,
                             const int32_t* lens, int N, uint64_t seed,
                             uint64_t* out, int B) {
  const Slot s = slot(rows, stride, lens, N, B);
  const bool al = (reinterpret_cast<uintptr_t>(s.p) & 7) == 0;
  uint64_t v = seed + (s.k == 0   ? P64_1 + P64_2
                       : s.k == 1 ? P64_2
                       : s.k == 2 ? 0ull
                                  : 0ull - P64_1);
  const int stripes = s.n / 32;
  for (int i = 0; i < stripes; ++i)
    v = round64(v, read64(s.p + 32 * i + 8 * s.k, al));
  __syncwarp();
  const uint64_t v0 = __shfl_sync(0xFFFFFFFFu, v, s.base),
                 v1 = __shfl_sync(0xFFFFFFFFu, v, s.base + 1),
                 v2 = __shfl_sync(0xFFFFFFFFu, v, s.base + 2),
                 v3 = __shfl_sync(0xFFFFFFFFu, v, s.base + 3);
  if (s.k != 0 || s.row >= B) return;
  uint64_t h;
  if (s.n >= 32) {
    h = rotl64(v0, 1) + rotl64(v1, 7) + rotl64(v2, 12) + rotl64(v3, 18);
    h = merge64(merge64(merge64(merge64(h, v0), v1), v2), v3);
  } else {
    h = seed + P64_5;
  }
  h += (uint64_t)s.n;
  int pos = stripes * 32;
  for (; pos + 8 <= s.n; pos += 8)
    h = rotl64(h ^ round64(0, read64(s.p + pos, al)), 27) * P64_1 + P64_4;
  if (pos + 4 <= s.n) {
    // a 4-aligned address whenever the row start is 8-aligned
    h = rotl64(h ^ (read32(s.p + pos, al) * P64_1), 23) * P64_2 + P64_3;
    pos += 4;
  }
  for (; pos < s.n; ++pos) h = rotl64(h ^ (s.p[pos] * P64_5), 11) * P64_1;
  h ^= h >> 33;
  h *= P64_2;
  h ^= h >> 29;
  h *= P64_3;
  h ^= h >> 32;
  out[s.row] = h;
}

int blocks_for(int B) { return (B * LANES + THREADS - 1) / THREADS; }

}  // namespace

// rows is [B, >= N] uint8 with `stride` bytes between rows; row b's first
// min(lens[b], N) bytes are hashed.
extern "C" int lz4tt_xxh32_rows(const uint8_t* rows, long long stride,
                                const int32_t* lens, int N, uint32_t seed,
                                uint32_t* out, int B, void* cuda_stream) {
  if (B > 0)
    xxh32_kernel<<<blocks_for(B), THREADS, 0, (cudaStream_t)cuda_stream>>>(
        rows, stride, lens, N, seed, out, B);
  return (int)cudaGetLastError();
}

extern "C" int lz4tt_xxh64_rows(const uint8_t* rows, long long stride,
                                const int32_t* lens, int N, uint64_t seed,
                                uint64_t* out, int B, void* cuda_stream) {
  if (B > 0)
    xxh64_kernel<<<blocks_for(B), THREADS, 0, (cudaStream_t)cuda_stream>>>(
        rows, stride, lens, N, seed, out, B);
  return (int)cudaGetLastError();
}
