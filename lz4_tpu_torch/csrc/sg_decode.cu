// The scatter-gather chain decoder: kernel F.
//
// Replaces the Pallas kernel lz4_tpu/kernels/decode_kernel.py
// _make_decode_kernel in mode "sg" (launched by _decode_blocks_sg): the
// blocks of one SG frame, each of at most 64 KB of output, decode into ONE
// continuous output.  Block k lands at cum[k] = the sum of the sizes before
// it, whatever the earlier blocks produced, may decode to at most cap[k]
// bytes, and its window is the 64 KB of that space just before cum[k],
// across block boundaries.  A failed block reports -1 and moves no later
// block; it keeps the bytes of the sequences before its failing one (every
// sequence is checked whole before any of it is written), and every byte no
// block wrote reads as 0.  Payloads sit at any byte offset of one flat
// input.
//
// What bounds it on the card: a block's token parse is a chain of dependent
// loads (one warp decodes at 24-36 MB/s), and block k's window is the output
// of the blocks before it.  But nothing else is chained: block k's place is
// cum[k] and its offset check uses plen = min(cum[k], 65535) whatever the
// earlier blocks produced, so the blocks' statuses do not depend on each
// other, only their window bytes do.  So every block decodes at once, a
// warp each, into int32 cells (decode.cuh: a byte, or a reference to the
// cell a fixed distance back, for every byte copied from before the
// block's start), and rounds of pointer jumping resolve the references (a
// chain crosses at most B - 1 blocks).  The cells start zeroed, so what a
// block does not write is the byte 0, as in the serial walk.  A chain is
// decoded in windows of blocks that hold at most CELL_WINDOW bytes of
// output (decode_kernel.py), one after another; a window's references
// below its first block read the final bytes of the windows before it.
// The TPU kernel realigned the window and shifted each block's output by
// lane rolls into a zero-lead HBM space; global memory is byte addressed,
// so the output is the content from byte 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int MAX_OFFSET = 65535;
constexpr int JUMP_THREADS = 256;
constexpr int JUMP_CTAS = 1024;

// Warp i decodes block b = k0 + i into the cells at cum[b] - cum[k0].  Per
// block b: payload at flat[bstart[b]], clen[b] bytes; at most cap[b] bytes
// of output.
__global__ void sg_cells_kernel(const uint8_t* flat, const long long* bstart,
                                const int32_t* clen, const int32_t* cap,
                                const long long* cum, int k0, int32_t* cells,
                                int32_t* olen) {
  const int b = k0 + blockIdx.x;
  int far;
  const int r = decode_block_t<Out::kCells>(
      flat + bstart[b], clen[b], cells + (cum[b] - cum[k0]), cap[b], nullptr,
      (int)min(cum[b], (long long)MAX_OFFSET), threadIdx.x, &far);
  if (threadIdx.x == 0) olen[b] = r;
}

// Round k over the output bytes [start, end) of one window, whose cells
// begin at `start`; the bytes below it are final in out.
__global__ void sg_jump_kernel(long long start, long long end,
                               int32_t* cells, uint8_t* out, int32_t* more,
                               int k) {
  if (k > 0 && !more[k - 1]) return;
  jump_cells(cells, start, out, start, end, k == 0,
             (long long)blockIdx.x * blockDim.x + threadIdx.x,
             (long long)gridDim.x * blockDim.x, more + k);
}

}  // namespace

// win: nwin + 1 block indices on the host (the windows [win[w], win[w +
// 1])), wcum: the output offset of each bound (cum of win[w]; wcum[nwin] =
// the total); cells: int32, the most output bytes of one window; more:
// int32 [nwin * MAX_JUMP_ROUNDS], zeroed.
extern "C" int lz4tt_decode_sg(const uint8_t* flat, const long long* bstart,
                               const int32_t* clen, const int32_t* cap,
                               const long long* cum, int B, const int32_t* win,
                               const long long* wcum, int nwin,
                               int32_t* cells, int32_t* more, uint8_t* out,
                               int32_t* olen, void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  for (int w = 0; w < nwin && B > 0; ++w, more += MAX_JUMP_ROUNDS) {
    const int k0 = win[w], k1 = win[w + 1];
    const long long start = wcum[w], end = wcum[w + 1];
    if (end > start) {
      const cudaError_t e = cudaMemsetAsync(
          cells, 0, (size_t)(end - start) * sizeof(int32_t), s);
      if (e != 0) return (int)e;
    }
    sg_cells_kernel<<<k1 - k0, WARP, 0, s>>>(flat, bstart, clen, cap, cum, k0,
                                             cells, olen);
    if (end > start)
      // a chain links blocks k1 - 1, ..., k0 and ends in a byte
      for (int k = 0; k < jump_rounds(k1 - k0 + 1); ++k)
        sg_jump_kernel<<<JUMP_CTAS, JUMP_THREADS, 0, s>>>(start, end, cells,
                                                          out, more, k);
  }
  return (int)cudaGetLastError();
}
