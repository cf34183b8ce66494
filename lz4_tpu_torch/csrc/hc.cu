// High-compression (HC) block encoder: kernel I.
//
// Replaces the Pallas kernel of lz4_tpu/kernels/hc_kernel.py,
// _make_hc_kernel (launched by _encode_blocks_hc): one independent block of
// at most 64 KB per row, a match finder over precomputed 4-byte and 8-byte
// candidate chains (the d48 table of cand_delta48_rows: low 16 bits the
// 4-byte chain's delta, high 16 the 8-byte chain's), at most max_attempts
// candidates per position, a lossless beat-gate, the switch to the 8-byte
// chain once the best score reaches 8 + p - anchor, the stop at
// SUFFICIENT_LEN, and an iterative one-step lazy parse.  The parse is the
// same decision for decision, so payloads are bit-identical to the JAX
// package's.  Output goes through emit.cuh.
//
// What bounds it on the card: dependent loads along the chain walk.  Each
// candidate costs a load of its delta (to find the next candidate), then the
// beat-gate word at the best frontier, then, if the gate passes, the
// extension; each address depends on the load before it, and a chain hops
// backwards anywhere in the 64 KB row, so the walk runs at L1/L2 (or HBM)
// latency, not at any bandwidth.  The design runs many walks at once: the
// chains come from a sort done beforehand (no hash table, no chain upkeep,
// no stores in the walk), every row is independent, and each row gets its
// own warp so that the rows spread over all SMs (1,024 rows of 64 KB hold
// about 8 warps on each of the 132 SMs).  Lane 0 walks; the source is read
// as bytes from [0, n) and LE32 words are built in registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "emit.cuh"

namespace {

constexpr int SUFFICIENT_LEN = 64;

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

struct Hit {
  int score;  // forward + backward length (< 4: no match)
  int fwd;    // forward length from p
  int pos;    // candidate position
};

// Forward match length of (q, p), the first 4 bytes known equal; 8 and 4
// bytes at a time, then a <4-byte tail, capped at matchlimit - p.  Every
// byte read lies below matchlimit + 3 = n - 2.
__device__ __forceinline__ int extend(const uint8_t* buf, int q, int p,
                                      int matchlimit) {
  int ml = 4;
  while (p + ml + 8 <= matchlimit &&
         le32(buf + q + ml) == le32(buf + p + ml) &&
         le32(buf + q + ml + 4) == le32(buf + p + ml + 4))
    ml += 8;
  if (p + ml + 4 <= matchlimit && le32(buf + q + ml) == le32(buf + p + ml))
    ml += 4;
  const uint32_t diff = le32(buf + q + ml) ^ le32(buf + p + ml);
  const int tail = ((diff & 0xFFu) == 0) + ((diff & 0xFFFFu) == 0) +
                   ((diff & 0xFFFFFFu) == 0);
  return min(ml + tail, matchlimit - p);
}

// Walk p's chain for the widest match.
__device__ Hit search(const uint8_t* buf, const int32_t* d, int p, int anchor,
                      int matchlimit, int max_attempts) {
  const int d0 = d[p] & 0xFFFF;
  int cand = d0 > 0 ? p - d0 : p;  // p = stop sentinel
  const uint32_t vp4 = le32(buf + p + 4);
  const int tier8 = 8 + p - anchor;
  const int gmax = matchlimit - p - 1;
  Hit best = {0, 0, 0};
  for (int att = max_attempts; att > 0 && best.score < SUFFICIENT_LEN &&
                               cand >= 0 && cand < p && p - cand <= 65535;
       --att) {
    // beat-gate: the candidate can exceed the best score only if its bytes
    // still agree at the best frontier (clamped below matchlimit) or it can
    // extend backward
    const int g = min(max(best.score - 3, 0), gmax);
    if (le32(buf + cand + g) == le32(buf + p + g) ||
        (p > anchor && cand > 0 && buf[cand - 1] == buf[p - 1])) {
      const int fwd = extend(buf, cand, p, matchlimit);
      int back = 0;
      while (p - back > anchor && cand - back > 0 &&
             buf[p - back - 1] == buf[cand - back - 1])
        ++back;
      if (fwd + back > best.score) best = {fwd + back, fwd, cand};
    }
    const int pair = d[cand];
    const bool use8 =
        best.score >= tier8 && le32(buf + cand + 4) == vp4;
    const int step = use8 ? (pair >> 16) & 0xFFFF : pair & 0xFFFF;
    cand = step > 0 ? cand - step : p;  // delta 0 ends the chain
  }
  return best;
}

// One row's parse into `out`; returns the bytes written.
__device__ int parse_row(const uint8_t* buf, const int32_t* d, int n,
                         int max_attempts, uint8_t* out) {
  int op = 0, anchor = 0;
  if (n >= 13) {
    const int mflimit = n - 12;
    const int matchlimit = n - 5;
    int ip = 0;
    while (ip <= mflimit) {
      Hit h = search(buf, d, ip, anchor, matchlimit, max_attempts);
      if (h.score < 4) {
        ++ip;
        continue;
      }
      // lazy: defer while the next position yields a strictly wider match
      int cur = ip;
      while (cur + 1 <= mflimit) {
        const Hit h2 = search(buf, d, cur + 1, anchor, matchlimit,
                              max_attempts);
        if (h2.score <= h.score) break;
        h = h2;
        ++cur;
      }
      // take the match at cur, extended backward from there
      int mp = cur, q = h.pos;
      while (mp > anchor && q > 0 && buf[mp - 1] == buf[q - 1]) {
        --mp;
        --q;
      }
      const int ml = h.fwd + (cur - mp);
      op = lz4tt::emit_seq(out, op, buf + anchor, mp - anchor, cur - h.pos,
                           ml - 4);
      ip = anchor = mp + ml;
    }
  }
  return lz4tt::emit_final(out, op, buf + anchor, n - anchor);
}

// Kernel I: one warp per independent row; lane 0 parses.
__global__ void encode_hc_kernel(const uint8_t* src, int NS,
                                 const int32_t* d48, const int32_t* slen,
                                 uint8_t* out, int M, int32_t* olen,
                                 int max_attempts) {
  if (threadIdx.x != 0) return;
  const int row = blockIdx.x;
  const int n = min(max(slen[row], 0), NS);
  olen[row] = parse_row(src + (long long)row * NS,
                        d48 + (long long)row * NS, n, max_attempts,
                        out + (long long)row * M);
}

}  // namespace

extern "C" int lz4tt_encode_hc(const uint8_t* src, int NS,
                               const int32_t* d48, const int32_t* slen,
                               uint8_t* out, int M, int32_t* olen, int B,
                               int max_attempts, void* cuda_stream) {
  if (B > 0)
    encode_hc_kernel<<<B, 32, 0, (cudaStream_t)cuda_stream>>>(
        src, NS, d48, slen, out, M, olen, max_attempts);
  return (int)cudaGetLastError();
}
