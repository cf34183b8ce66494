// LZ4 sequence emission for the encoder kernels: token, length extensions,
// literal run, LE16 offset.  The one place the port's kernels write the
// LZ4 block wire format (counterpart of lz4_tpu/kernels/emit.py).
//
// The TPU emitters copy literals 16 at a time and write up to 15 bytes past
// a run (scratch the next sequence overwrites); these copy exactly, so a
// kernel never writes past the end of its sequence.
#pragma once

#include <stdint.h>

namespace lz4tt {

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
  out[op++] = (uint8_t)((min(litlen, 15) << 4) | min(ml_code, 15));
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
  out[op++] = (uint8_t)(min(litlen, 15) << 4);
  if (litlen >= 15) op = emit_ext(out, op, litlen - 15);
  return copy_literals(out, op, lit, litlen);
}

}  // namespace lz4tt
