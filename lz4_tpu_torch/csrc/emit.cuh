// LZ4 sequence emission for the encoder kernels: token, length extensions,
// literal run, LE16 offset, and the byte size of each.  The one place the
// port's kernels write the LZ4 block wire format (counterpart of
// lz4_tpu/kernels/emit.py).
//
// The TPU emitters copy literals 16 at a time and write up to 15 bytes past
// a run (scratch the next sequence overwrites); these copy exactly, so a
// kernel never writes past the end of its sequence.  The serial emitters
// serve one thread that parses and writes; the warp emitters write one
// sequence with the 32 lanes of a warp, at an offset summed beforehand from
// seq_size and final_run_size.
#pragma once

#include <stdint.h>

namespace lz4tt {

// Bytes of the length extension of a token field holding `x` (a literal
// run, or a match length minus 4).
__device__ __forceinline__ int ext_bytes(int x) {
  return x < 15 ? 0 : 1 + (x - 15) / 255;
}

// Bytes of a sequence of `litlen` literals and a match of mlc + 4.
__device__ __forceinline__ int seq_size(int litlen, int mlc) {
  return 1 + litlen + 2 + ext_bytes(litlen) + ext_bytes(mlc);
}

// Bytes of the block's trailing literal-only sequence.
__device__ __forceinline__ int final_run_size(int litlen) {
  return 1 + litlen + ext_bytes(litlen);
}

__device__ __forceinline__ uint8_t token(int litlen, int ml_code) {
  return (uint8_t)((min(litlen, 15) << 4) | min(ml_code, 15));
}

__device__ __forceinline__ int emit_ext(uint8_t* out, int op, int extra) {
  while (extra >= 255) {
    out[op++] = 255;
    extra -= 255;
  }
  out[op++] = (uint8_t)extra;
  return op;
}

__device__ __forceinline__ int copy_literals(uint8_t* out, int op,
                                             const uint8_t* lit, int n) {
  for (int i = 0; i < n; ++i) out[op + i] = lit[i];
  return op + n;
}

// One sequence: `litlen` literals from `lit`, then a match of ml_code + 4
// bytes at distance `offset`.
__device__ __forceinline__ int emit_seq(uint8_t* out, int op,
                                        const uint8_t* lit, int litlen,
                                        int offset, int ml_code) {
  out[op++] = token(litlen, ml_code);
  if (litlen >= 15) op = emit_ext(out, op, litlen - 15);
  op = copy_literals(out, op, lit, litlen);
  out[op] = (uint8_t)(offset & 0xFF);
  out[op + 1] = (uint8_t)((offset >> 8) & 0xFF);
  op += 2;
  if (ml_code >= 15) op = emit_ext(out, op, ml_code - 15);
  return op;
}

// The block's trailing literal-only sequence.
__device__ __forceinline__ int emit_final(uint8_t* out, int op,
                                          const uint8_t* lit, int litlen) {
  out[op++] = token(litlen, 0);
  if (litlen >= 15) op = emit_ext(out, op, litlen - 15);
  return copy_literals(out, op, lit, litlen);
}

// -- the same bytes, written by the 32 lanes of a warp ----------------------

// The ext_bytes(v) extension bytes of field `v` at `op`.
__device__ __forceinline__ void warp_ext(uint8_t* out, int op, int v,
                                         int lane) {
  const int nb = ext_bytes(v);
  for (int k = lane; k < nb; k += 32)
    out[op + k] = k < nb - 1 ? 255 : (uint8_t)((v - 15) % 255);
}

// `n` bytes, 512 per round: each lane loads 16 bytes, 32 apart, before it
// stores any, so one round costs one trip to memory.
__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src,
                                          int n, int lane) {
  for (int base = 0; base < n; base += 512) {
    uint8_t v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int k = base + 32 * u + lane;
      v[u] = k < n ? src[k] : 0;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int k = base + 32 * u + lane;
      if (k < n) dst[k] = v[u];
    }
  }
}

__device__ __forceinline__ void warp_emit_seq(uint8_t* out, int op,
                                              const uint8_t* lit, int litlen,
                                              int offset, int ml_code,
                                              int lane) {
  if (lane == 0) out[op] = token(litlen, ml_code);
  warp_ext(out, op + 1, litlen, lane);
  op += 1 + ext_bytes(litlen);
  warp_copy(out + op, lit, litlen, lane);
  op += litlen;
  if (lane == 0) {
    out[op] = (uint8_t)(offset & 0xFF);
    out[op + 1] = (uint8_t)((offset >> 8) & 0xFF);
  }
  warp_ext(out, op + 2, ml_code, lane);
}

__device__ __forceinline__ void warp_emit_final(uint8_t* out, int op,
                                                const uint8_t* lit,
                                                int litlen, int lane) {
  if (lane == 0) out[op] = token(litlen, 0);
  warp_ext(out, op + 1, litlen, lane);
  warp_copy(out + op + 1 + ext_bytes(litlen), lit, litlen, lane);
}

}  // namespace lz4tt
