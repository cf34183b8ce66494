// The scatter-gather chain decoder: kernel F.
//
// Replaces the Pallas kernel lz4_tpu/kernels/decode_kernel.py
// _make_decode_kernel in mode "sg" (launched by _decode_blocks_sg): the
// blocks of one SG frame, each of at most 64 KB of output, decode into ONE
// continuous output.  Block k lands at cum[k] = the sum of the sizes before
// it, whatever the earlier blocks produced, may decode to at most cap[k]
// bytes, and its window is the 64 KB of that space just before cum[k],
// across block boundaries.  A failed block reports -1 and moves no later
// block.  Payloads sit at any byte offset of one flat input.
//
// What bounds it on the card: the chain is serial by format (block k's
// window is the output of the blocks before it) and each block's token
// parse is a chain of dependent loads, so one warp walks the chain in order
// with the warp-wide decoder of kernels D and E (decode.cuh): lanes share
// literal and match copies, every load and store is checked before it
// happens.  The TPU kernel realigned the window and shifted each block's
// output by lane rolls into a zero-lead HBM space; global memory is byte
// addressed, so the window is the output itself and there is no lead: the
// output is the content from byte 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int MAX_OFFSET = 65535;

// Per block b: payload at flat[bstart[b]], clen[b] bytes; output at
// out[cum[b]], at most cap[b] bytes.
__global__ void sg_decode_kernel(const uint8_t* flat, const long long* bstart,
                                 const int32_t* clen, const int32_t* cap,
                                 const long long* cum, int B, uint8_t* out,
                                 int32_t* olen) {
  const int lane = threadIdx.x;
  for (int b = 0; b < B; ++b) {
    uint8_t* o = out + cum[b];
    const int r = decode_block(flat + bstart[b], clen[b], o, cap[b], o,
                               (int)min(cum[b], (long long)MAX_OFFSET), lane);
    if (lane == 0) olen[b] = r;
    __syncwarp();
  }
}

}  // namespace

extern "C" int lz4tt_decode_sg(const uint8_t* flat, const long long* bstart,
                               const int32_t* clen, const int32_t* cap,
                               const long long* cum, int B, uint8_t* out,
                               int32_t* olen, void* cuda_stream) {
  if (B > 0)
    sg_decode_kernel<<<1, WARP, 0, (cudaStream_t)cuda_stream>>>(
        flat, bstart, clen, cap, cum, B, out, olen);
  return (int)cudaGetLastError();
}
