// Greedy LZ4 scan over a precomputed candidate table: kernels A and B.
//
// Replaces the Pallas kernels of lz4_tpu/kernels/encode_kernel.py:
//   A  _make_encode_linked_kernel (launched by _encode_blocks_linked):
//      linked 64 KB blocks, each matching into its predecessor or a prefix;
//   B  _make_encode_kernel (launched by _encode_blocks): independent rows.
// The parse is the same decision for decision, so payloads are
// bit-identical to the JAX package's.
//
// What bounds it on the card: the scan is a serial chain of dependent byte
// loads (candidate -> compare -> extend -> emit), so one row runs at the
// latency of L1/L2 hits, not at any bandwidth.  The design keeps the chain
// short and runs many chains at once: the candidate table comes from a sort
// done beforehand (no hash table, no stores in the probe loop), every
// (stream, block) row is independent once that table exists, and each row
// gets its own warp so that rows spread over all SMs.  Lane 0 runs the scan;
// the row's source window (at most 128 KB) stays hot in L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "emit.cuh"

namespace {

constexpr int WINDOW = 65536;
constexpr int SKIP_TRIGGER = 6;

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// One block's parse.  Positions index `buf`; the block is [start, start+n),
// matches may reach back to `low`.  LINKED selects the 4-granular jump table
// of kernel A (jump[k] = block-relative next candidate at/after lane 4k);
// otherwise jump[p] is the full-resolution distance to the next candidate.
template <bool LINKED>
__device__ int scan(const uint8_t* buf, int start, int n, int low, int ip,
                    const int32_t* delta, const int32_t* jump, int ns,
                    int acceleration, int min_match, int reject_step,
                    uint8_t* out) {
  const int n_end = start + n;
  const int mflimit = n_end - 12;
  const int matchlimit = n_end - 5;
  const int accel0 = acceleration << SKIP_TRIGGER;
  int op = 0, anchor = start, scnt = accel0;
  if (n >= 13) {
    while (ip <= mflimit) {
      const int d = delta[ip - start];
      const int q = ip - d;
      if (d > 0 && q >= low) {
        int mp = ip, qq = q;
        while (mp > anchor && qq > low && buf[mp - 1] == buf[qq - 1]) {
          --mp;
          --qq;
        }
        int ml = ip + 4 - mp;
        while (mp + ml + 8 <= matchlimit &&
               le32(buf + qq + ml) == le32(buf + mp + ml) &&
               le32(buf + qq + ml + 4) == le32(buf + mp + ml + 4))
          ml += 8;
        if (mp + ml + 4 <= matchlimit &&
            le32(buf + qq + ml) == le32(buf + mp + ml))
          ml += 4;
        const uint32_t diff = le32(buf + qq + ml) ^ le32(buf + mp + ml);
        const int tail = ((diff & 0xFFu) == 0) + ((diff & 0xFFFFu) == 0) +
                         ((diff & 0xFFFFFFu) == 0);
        ml = min(ml + tail, matchlimit - mp);
        if (ml >= min_match) {
          op = lz4tt::emit_seq(out, op, buf + anchor, mp - anchor, ip - q,
                               ml - 4);
          ip = anchor = mp + ml;
          scnt = accel0;
        } else {
          ip += max(scnt >> SKIP_TRIGGER, reject_step);
          ++scnt;
        }
      } else {
        const int step = scnt >> SKIP_TRIGGER;
        if (LINKED) {
          int ip2 = ip + step;
          const int j = ip2 - start;
          if (j < ns) ip2 = max(ip2, start + jump[min(j >> 2, ns / 4 - 1)]);
          ip = ip2;
        } else {
          ip += max(step, jump[ip - start]);
        }
        ++scnt;
      }
    }
  }
  return lz4tt::emit_final(out, op, buf + anchor, n_end - anchor);
}

// Kernel A: one warp per (stream s, block k); row s of `stream` is
// [64 KB window | blocks], block k at byte (k + 1) * WINDOW.
__global__ void encode_linked_kernel(const uint8_t* stream, long long L,
                                     const int32_t* delta,
                                     const int32_t* jump, const int32_t* slen,
                                     const int32_t* prefix, uint8_t* out,
                                     int M, int32_t* olen, int NB,
                                     int acceleration, int min_match,
                                     int reject_step) {
  if (threadIdx.x != 0) return;
  const int row = blockIdx.x;
  const int s = row / NB, k = row % NB;
  const int n = min(max(slen[row], 0), WINDOW);
  if (n == 0) {
    olen[row] = 0;
    return;
  }
  const int start = (k + 1) * WINDOW;
  const int pre = k == 0 ? min(max(prefix[s], 0), WINDOW) : WINDOW;
  olen[row] = scan<true>(stream + (long long)s * L, start, n, start - pre,
                         start + (pre > 0 ? 0 : 1),
                         delta + (long long)row * WINDOW,
                         jump + (long long)row * (WINDOW / 4), WINDOW,
                         acceleration, min_match, reject_step,
                         out + (long long)row * M);
}

// Kernel B: one warp per independent row.
__global__ void encode_kernel(const uint8_t* src, int NS,
                              const int32_t* delta, const int32_t* jump,
                              const int32_t* slen, uint8_t* out, int M,
                              int32_t* olen, int acceleration, int min_match,
                              int reject_step) {
  if (threadIdx.x != 0) return;
  const int row = blockIdx.x;
  const int n = min(max(slen[row], 0), NS);
  olen[row] = scan<false>(src + (long long)row * NS, 0, n, 0, 1,
                          delta + (long long)row * NS,
                          jump + (long long)row * NS, NS, acceleration,
                          min_match, reject_step, out + (long long)row * M);
}

}  // namespace

extern "C" int lz4tt_encode_linked(const uint8_t* stream, long long L,
                                   const int32_t* delta, const int32_t* jump,
                                   const int32_t* slen, const int32_t* prefix,
                                   uint8_t* out, int M, int32_t* olen, int S,
                                   int NB, int acceleration, int min_match,
                                   int reject_step, void* cuda_stream) {
  if (S * NB > 0)
    encode_linked_kernel<<<S * NB, 32, 0, (cudaStream_t)cuda_stream>>>(
        stream, L, delta, jump, slen, prefix, out, M, olen, NB, acceleration,
        min_match, reject_step);
  return (int)cudaGetLastError();
}

extern "C" int lz4tt_encode(const uint8_t* src, int NS, const int32_t* delta,
                            const int32_t* jump, const int32_t* slen,
                            uint8_t* out, int M, int32_t* olen, int B,
                            int acceleration, int min_match, int reject_step,
                            void* cuda_stream) {
  if (B > 0)
    encode_kernel<<<B, 32, 0, (cudaStream_t)cuda_stream>>>(
        src, NS, delta, jump, slen, out, M, olen, acceleration, min_match,
        reject_step);
  return (int)cudaGetLastError();
}
