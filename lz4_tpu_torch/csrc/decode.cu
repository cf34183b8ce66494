// Safe LZ4 block decoder: kernel D, modes `linked` and `batch`, the latter
// with optional dictionary rows and in its resumable (destSize) variant.
//
// Replaces the Pallas kernel lz4_tpu/kernels/decode_kernel.py
// _make_decode_kernel (launched by _decode_blocks) in mode "linked"
// (decode_blocks_linked), in mode "batch" (decode_blocks) and with
// resumable=True (decode_blocks_dest_size: a row that runs out of room
// stops at a token boundary and reports the bytes produced and consumed).
// Semantics of its general path (slow_seq): the literal
// run must lie inside clen, a run ending exactly at clen ends the block,
// otherwise the offset must lie in (0, opos + plen] and the output must fit
// min(ocap, N); anything else gives -1.  Every load is checked against clen
// and every store against the output limit before it happens, so hostile
// input cannot write outside its row.
//
// What bounds it on the card: the token parse is serial within a block, and
// in a linked chain across blocks too (block b's window is block b-1's
// output), so a chain runs at the latency of one warp's dependent loads;
// the bytes it moves are few per token.  The TPU kernel ran its grid in
// order on one core; here the "loop inside the block" replaces that
// sequential grid: one warp walks a chain's blocks in order, and block b's
// window is row b-1 of the output itself (no copy).  The warp-wide block
// decoder is in decode.cuh.  Batch mode runs one warp per row, all rows in
// parallel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

__global__ void decode_linked_kernel(const uint8_t* comp, int M,
                                     const int32_t* clen,
                                     const uint8_t* init_window, int init_len,
                                     uint8_t* out, int N, int32_t* olen,
                                     int B) {
  const int lane = threadIdx.x;
  int prev = -1;
  for (int b = 0; b < B; ++b) {
    const int plen = b == 0 ? init_len : (prev == N ? N : 0);
    const uint8_t* win_end =
        b == 0 ? init_window + N : out + (long long)b * N;
    const int n = min(max(clen[b], 0), M);
    prev = decode_block(comp + (long long)b * M, n, out + (long long)b * N,
                        N, win_end, plen, lane);
    if (lane == 0) olen[b] = prev;
    __syncwarp();
  }
}

// Row b's dictionary is right-aligned in dict[b * P, (b + 1) * P); `dict`
// may be null (no dictionary).  RESUMABLE writes cons[b] too.
template <bool RESUMABLE>
__global__ void decode_batch_kernel(const uint8_t* comp, int M,
                                    const int32_t* clen, const int32_t* ocap,
                                    const uint8_t* dict, int P,
                                    const int32_t* dict_lens, uint8_t* out,
                                    int N, int32_t* olen, int32_t* cons) {
  const int b = blockIdx.x;
  const int n = min(max(clen[b], 0), M);
  const int plen = dict ? min(max(dict_lens[b], 0), P) : 0;
  const uint8_t* win_end = dict ? dict + (long long)(b + 1) * P : nullptr;
  int c = 0;
  const int r = decode_block_t<RESUMABLE>(
      comp + (long long)b * M, n, out + (long long)b * N, min(ocap[b], N),
      win_end, plen, threadIdx.x, RESUMABLE ? &c : nullptr);
  if (threadIdx.x == 0) {
    olen[b] = r;
    if (RESUMABLE) cons[b] = c;
  }
}

}  // namespace

extern "C" int lz4tt_decode_linked(const uint8_t* comp, int M,
                                   const int32_t* clen,
                                   const uint8_t* init_window, int init_len,
                                   uint8_t* out, int N, int32_t* olen, int B,
                                   void* cuda_stream) {
  if (B > 0)
    decode_linked_kernel<<<1, WARP, 0, (cudaStream_t)cuda_stream>>>(
        comp, M, clen, init_window, init_len, out, N, olen, B);
  return (int)cudaGetLastError();
}

// cons selects the resumable decoder (null: a row that does not fit its
// cap reports -1); dict may be null.
extern "C" int lz4tt_decode_batch(const uint8_t* comp, int M,
                                  const int32_t* clen, const int32_t* ocap,
                                  const uint8_t* dict, int P,
                                  const int32_t* dict_lens, uint8_t* out,
                                  int N, int32_t* olen, int32_t* cons, int B,
                                  void* cuda_stream) {
  if (B > 0) {
    if (cons)
      decode_batch_kernel<true><<<B, WARP, 0, (cudaStream_t)cuda_stream>>>(
          comp, M, clen, ocap, dict, P, dict_lens, out, N, olen, cons);
    else
      decode_batch_kernel<false><<<B, WARP, 0, (cudaStream_t)cuda_stream>>>(
          comp, M, clen, ocap, dict, P, dict_lens, out, N, olen, cons);
  }
  return (int)cudaGetLastError();
}
