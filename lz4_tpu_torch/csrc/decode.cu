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
// What bounds it on the card: the token parse is serial within a block, so
// a block decodes at the latency of one warp's dependent loads; the bytes
// it moves are few per token.  The TPU kernel ran its grid in order on one
// core, and a linked chain is serial by format: block b's window is block
// b-1's output, which exists only when b-1 decoded to exactly N bytes.
// Here no block waits for another.  Linked mode runs in 2 + ceil(log2 B)
// launches: (1) one warp per block, all at once, decodes block b into row
// b of int32 cells with its window assumed present (block 0 reads
// init_window; block b > 0 writes a reference wherever it copies a byte of
// row b-1) and records far[b], how far its matches reach before the row;
// (2) one thread sets the statuses, olen[b] = -1 where far[b] > 0 and
// olen[b-1] != N: exactly the serial walk, since with no window the serial
// decoder fails at the first match that reaches back, a block that never
// reaches back decodes the same either way, and every other failure is -1
// whatever the window; (3) rounds of pointer jumping over the good rows'
// cells, grid-wide, resolve the references (a chain links rows b, b-1, ...,
// so ceil(log2 B) rounds resolve the longest) and write the bytes out.  A
// chain whose rows hold more than CELL_WINDOW bytes (decode_kernel.py) runs
// these steps for W = CELL_WINDOW / N rows at a time, window after window.  A
// first design filled the references in one CTA, row after row in order:
// 20 % of the kernel's time on the main path, so the rounds replaced it
// (PERF.md).  Batch mode runs one warp per row, all rows in parallel.  The
// warp-wide block decoder and the rounds are in decode.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int JUMP_THREADS = 256;
constexpr int JUMP_CTAS_PER_ROW = 16;

// (1) Warp i decodes block b = r0 + i into cells row i: olen[b] its length
// or -1, far[b] how far it reaches before the row (0 when it does not
// decode).
__global__ void linked_cells_kernel(const uint8_t* comp, int M,
                                    const int32_t* clen,
                                    const uint8_t* init_window, int init_len,
                                    int32_t* cells, int N, int32_t* olen,
                                    int32_t* far, int r0) {
  const int b = r0 + blockIdx.x;
  const int n = min(max(clen[b], 0), M);
  int reach = 0;
  const int r = decode_block_t<false, Out::kCells>(
      comp + (long long)b * M, n, cells + (long long)blockIdx.x * N, N,
      b == 0 ? init_window + N : nullptr, b == 0 ? init_len : N, threadIdx.x,
      nullptr, &reach);
  if (threadIdx.x == 0) {
    olen[b] = r;
    far[b] = reach;
  }
}

// (2) One thread: the statuses of rows [r0, r1) (row r0 - 1's is final);
// the rounds' flags (more) cleared.
__global__ void linked_status_kernel(int32_t* olen, const int32_t* far,
                                     int32_t* more, int N, int r0, int r1) {
  for (int k = 0; k < MAX_JUMP_ROUNDS; ++k) more[k] = 0;
  for (int b = max(r0, 1); b < r1; ++b)
    if (far[b] > 0 && olen[b - 1] != N) olen[b] = -1;
}

// (3) Round k, grid (r1 - r0, JUMP_CTAS_PER_ROW): every good row's cells,
// cells row 0 at row r0; a round after one that left no reference returns
// at once.
__global__ void linked_jump_kernel(int32_t* cells, int N,
                                   const int32_t* olen, uint8_t* out,
                                   int32_t* more, int k, int r0) {
  if (k > 0 && !more[k - 1]) return;
  const long long row = (long long)(r0 + blockIdx.x) * N;
  jump_cells(cells, (long long)r0 * N, out, row,
             row + max(olen[r0 + blockIdx.x], 0), k == 0,
             (long long)blockIdx.y * blockDim.x + threadIdx.x,
             (long long)gridDim.y * blockDim.x, more + k);
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

// cells is [W, N] int32 scratch: the chain is decoded in windows of W rows,
// one after another.  far is int32 [B + MAX_JUMP_ROUNDS].
extern "C" int lz4tt_decode_linked(const uint8_t* comp, int M,
                                   const int32_t* clen,
                                   const uint8_t* init_window, int init_len,
                                   uint8_t* out, int N, int32_t* olen, int B,
                                   int32_t* cells, int W, int32_t* far,
                                   void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  int32_t* more = far + B;
  for (int r0 = 0; r0 < B; r0 += W) {
    const int r1 = min(r0 + W, B);
    linked_cells_kernel<<<r1 - r0, WARP, 0, s>>>(
        comp, M, clen, init_window, init_len, cells, N, olen, far, r0);
    linked_status_kernel<<<1, 1, 0, s>>>(olen, far, more, N, r0, r1);
    // a chain links rows r1 - 1, ..., max(r0, 1) and ends in a byte
    for (int k = 0; k < jump_rounds(r1 - max(r0, 1) + 1); ++k)
      linked_jump_kernel<<<dim3(r1 - r0, JUMP_CTAS_PER_ROW), JUMP_THREADS, 0,
                           s>>>(cells, N, olen, out, more, k, r0);
  }
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
