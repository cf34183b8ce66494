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
// (PERF.md).
//
// Batch mode (and its resumable variant) has independent rows, but one
// warp per row decoded each row as one serial chain of dependent loads and
// 32-byte strides, and 64 rows fill half the SMs with one warp each (1.6
// ms for 64 rows of 64 KB on the H100).  The row is split like kernel E's
// independent blocks, but its spans come from a serial walk that moves no
// byte:
// (1) one warp per row walks its tokens (walk_block in decode.cuh, with
//     the row's cap and dictionary length), which alone sets olen and cons
//     exactly as the serial decoder does (sequences after a resumable stop
//     are never read), and records a checkpoint every 2^span_log
//     sequences: its token offset and output base, in the row's `stride`
//     slots;
// (2) one warp per span of a good row decodes its sequences into int32
//     cells at its base (the last span stops at cons): a copy from the row
//     before the span is a reference, one from before the row reads the
//     dictionary's final byte (window_elem's three regions);
// (3) the rounds of pointer jumping of linked mode resolve each row's
//     references (a chain crosses at most stride - 1 spans) and write the
//     row at out + b * N.
// Steps 2 and 3 run over windows of W = CELL_WINDOW / N rows.  The walk is
// the floor of a row: a chain of dependent steps per sequence, one warp
// per row and nothing to hide its latency.  So it checks each offset one
// sequence late (its load is off the chain), takes the common sequence in
// a loop of its own, and prefetches the payload 256 bytes ahead: 0.2 ->
// 0.15 us a sequence on the card (PERF.md).  The rounds run on about
// JUMP_GRID CTAs, whatever the rows, so that a round after the last
// reference returns at once.  The warp-wide block decoder and the rounds
// are in decode.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int JUMP_THREADS = 256;
constexpr int JUMP_CTAS_PER_ROW = 16;
constexpr int SPAN_WARPS = 4;         // warps per CTA of batch step 2
constexpr int JUMP_GRID = 2048;       // CTAs of a batch round

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
  const int r = decode_block_t<Out::kCells>(
      comp + (long long)b * M, n, cells + (long long)blockIdx.x * N, N,
      b == 0 ? init_window + N : nullptr, b == 0 ? init_len : N, threadIdx.x,
      &reach);
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

// (3) Round k, grid (r1 - r0, CTAs per row): every good row's cells, cells
// row 0 at row r0; a round after one that left no reference returns at
// once.  Linked and batch mode.
__global__ void rows_jump_kernel(int32_t* cells, int N, const int32_t* olen,
                                 uint8_t* out, int32_t* more, int k, int r0) {
  if (k > 0 && !more[k - 1]) return;
  const long long row = (long long)(r0 + blockIdx.x) * N;
  jump_cells(cells, (long long)r0 * N, out, row,
             row + max(olen[r0 + blockIdx.x], 0), k == 0,
             (long long)blockIdx.y * blockDim.x + threadIdx.x,
             (long long)gridDim.y * blockDim.x, more + k);
}

// Batch mode's rows: row b's payload, length, cap and dictionary (right-
// aligned in dict[b * P, (b + 1) * P); dict may be null).
struct Rows {
  const uint8_t* comp;
  int M;
  const int32_t* clen;
  const int32_t* ocap;
  const uint8_t* dict;
  int P;
  const int32_t* dict_lens;
  int N;
  __device__ const uint8_t* src(int b) const {
    return comp + (long long)b * M;
  }
  __device__ int n(int b) const { return min(max(clen[b], 0), M); }
  __device__ int cap(int b) const { return min(ocap[b], N); }
  __device__ int plen(int b) const {
    return dict ? min(max(dict_lens[b], 0), P) : 0;
  }
  __device__ const uint8_t* dict_end(int b) const {
    return dict ? dict + (long long)(b + 1) * P : nullptr;
  }
};

// (1) Warp b walks row b: olen[b], cons[b] (RESUMABLE), and the spans of a
// good row, nspans[b] of them, span k from token span_ip[b * stride + k]
// at output byte span_base[b * stride + k].
template <bool RESUMABLE>
__global__ void rows_walk_kernel(Rows r, int span_log, int stride,
                                 int32_t* span_ip, int32_t* span_base,
                                 int32_t* nspans, int32_t* olen,
                                 int32_t* cons) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const long long so = (long long)b * stride;
  const int mask = (1 << span_log) - 1;
  int seq = 0, k = 0, c = 0;
  auto mark = [&](int at, int opos) {
    const bool m = (seq++ & mask) == 0;
    if (m && lane == 0) {
      span_ip[so + k] = at;
      span_base[so + k] = opos;
    }
    k += m;
  };
  const int res = walk_block<RESUMABLE>(r.src(b), r.n(b), r.cap(b),
                                       r.plen(b), &c, mark);
  if (lane == 0) {
    olen[b] = res;
    nspans[b] = res < 0 ? 0 : k;
    if (RESUMABLE) cons[b] = c;
  }
}

// (2) Warp g decodes span slot g of the rows [r0, r1) into cells row
// g / stride; slots past a row's spans return at once.
template <bool RESUMABLE>
__global__ void rows_spans_kernel(Rows r, int stride, long long nslots,
                                  int r0, const int32_t* span_ip,
                                  const int32_t* span_base,
                                  const int32_t* nspans, const int32_t* cons,
                                  int32_t* cells) {
  const long long g =
      (long long)blockIdx.x * SPAN_WARPS + threadIdx.x / WARP;
  if (g >= nslots) return;
  const int i = (int)(g / stride), k = (int)(g % stride), b = r0 + i;
  const int ns = nspans[b];
  if (k >= ns) return;
  const long long s = (long long)b * stride + k;
  const int base = span_base[s];
  const int stop = k + 1 < ns ? span_ip[s + 1] : RESUMABLE ? cons[b] : -1;
  int far;
  decode_block_t<Out::kCells>(
      r.src(b), r.n(b), cells + (long long)i * r.N + base, r.cap(b) - base,
      r.dict_end(b), base + r.plen(b), threadIdx.x % WARP, &far,
      span_ip[s], stop, base);
}

template <bool RESUMABLE>
void decode_rows(const Rows& r, int B, int span_log, int stride,
                 int32_t* slots, int32_t* nspans, int32_t* cells, int W,
                 int32_t* more, uint8_t* out, int32_t* olen, int32_t* cons,
                 cudaStream_t s) {
  int32_t* span_ip = slots;
  int32_t* span_base = slots + (long long)B * stride;
  rows_walk_kernel<RESUMABLE><<<B, WARP, 0, s>>>(
      r, span_log, stride, span_ip, span_base, nspans, olen, cons);
  const int rounds = min(jump_rounds(stride + 1), MAX_JUMP_ROUNDS);
  for (int r0 = 0; r0 < B; r0 += W, more += MAX_JUMP_ROUNDS) {
    const int r1 = min(r0 + W, B);
    // CTAs per row: JUMP_GRID in all, at most one per JUMP_THREADS cells
    const int ctas = max(min((JUMP_GRID + r1 - r0 - 1) / (r1 - r0),
                             (r.N + JUMP_THREADS - 1) / JUMP_THREADS),
                         1);
    const long long nslots = (long long)(r1 - r0) * stride;
    rows_spans_kernel<RESUMABLE>
        <<<(int)((nslots + SPAN_WARPS - 1) / SPAN_WARPS), SPAN_WARPS * WARP,
           0, s>>>(r, stride, nslots, r0, span_ip, span_base, nspans, cons,
                   cells);
    for (int k = 0; k < rounds; ++k)
      rows_jump_kernel<<<dim3(r1 - r0, ctas), JUMP_THREADS, 0, s>>>(
          cells, r.N, olen, out, more, k, r0);
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
      rows_jump_kernel<<<dim3(r1 - r0, JUMP_CTAS_PER_ROW), JUMP_THREADS, 0,
                         s>>>(cells, N, olen, out, more, k, r0);
  }
  return (int)cudaGetLastError();
}

// cons selects the resumable decoder (null: a row that does not fit its
// cap reports -1); dict may be null.  Scratch: slots (int32 [2, B *
// stride], stride = the span slots of an M-byte payload), nspans (int32
// [B]), cells (int32 [W, N]: rows decoded in windows of W) and more (int32
// [ceil(B / W) * MAX_JUMP_ROUNDS], zeroed).
extern "C" int lz4tt_decode_batch(const uint8_t* comp, int M,
                                  const int32_t* clen, const int32_t* ocap,
                                  const uint8_t* dict, int P,
                                  const int32_t* dict_lens, uint8_t* out,
                                  int N, int32_t* olen, int32_t* cons, int B,
                                  int span_log, int stride, int32_t* slots,
                                  int32_t* nspans, int32_t* cells, int W,
                                  int32_t* more, void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const Rows r{comp, M, clen, ocap, dict, P, dict_lens, N};
  if (B > 0) {
    if (cons)
      decode_rows<true>(r, B, span_log, stride, slots, nspans, cells, W,
                        more, out, olen, cons, s);
    else
      decode_rows<false>(r, B, span_log, stride, slots, nspans, cells, W,
                         more, out, olen, cons, s);
  }
  return (int)cudaGetLastError();
}
