// LZ4 stream decoder: kernel E.
//
// Replaces the Pallas kernel lz4_tpu/kernels/decode_kernel.py
// _make_stream_decode_kernel (launched by _decode_stream): one frame's block
// chain of any block size, linked or independent, decoded into one flat
// output.  Payloads sit at any byte offset of one flat input buffer (a raw
// frame or legacy file is uploaded as it is, never repacked), and stored
// blocks are copied in the kernel.  The TPU kernel's semantics:
// * blocks decode in order; a block starts where the previous good block
//   ended, and may decode to at most its cap (the wrapper has already
//   clamped caps to 8 MB);
// * in linked mode a match may reach into everything decoded so far
//   (offsets are at most 65535, so the window is the last 64 KB of the
//   output); in independent mode only into its own block;
// * a stored block is a straight copy of its n bytes when n fits its cap;
// * a failed block reports -1 and does not move the position.
// The wrapper checks that every block lies inside the input buffer; the
// decoder checks every load against the block's length and every store
// against its cap (decode.cuh).
//
// What bounds it on the card: as in kernel D, the token parse is serial, so
// a warp decodes at the latency of its dependent loads.  The TPU kernel
// paged input and output through 128 KB VMEM rings because VMEM is small;
// global memory holds the whole stream and its output, so there are no
// rings.  Independent mode runs one warp per block, all blocks at once,
// each writing into scratch at the exclusive prefix sum of the caps; a
// one-CTA scan of the decoded lengths and a copy kernel then compact the
// good blocks in order, so the bytes and lengths are the serial walk's
// (independent blocks never read each other).  Linked mode is serial by
// format (a block starts where the previous good block ended, and its
// window is the output before it), but only its statuses and positions
// are, and those need no bytes:
// (A) one warp per block, all at once, walks the tokens without moving a
//     byte (block 0, whose base is 0 and window empty, is decoded in full),
//     recording the decoded length or -1 and need[b], how far its matches
//     reach before its start;
// (B) one thread walks the B results in order: plen_b = min(base_b, 65535),
//     block b fails when need[b] > plen_b, base_{b+1} = base_b + max(olen_b,
//     0).  This is the serial walk exactly: every failed check is -1 in any
//     order, and the offset checks are the only ones the window changes;
// (C) one warp per good block b >= 1 decodes it at base_b into int32 cells,
//     with a reference wherever it copies a byte from before its start
//     (decode.cuh), and a stored block 0 is copied;
// (D) rounds of pointer jumping over the cells, grid-wide, resolve the
//     references (they may cross several short blocks; ceil(log2 B) rounds
//     resolve the longest chain) and write the bytes out.  Steps C and D run
//     over windows of blocks that hold at most CELL_WINDOW bytes of output
//     (decode_kernel.py), window after window.  A first design
//     filled the references in one CTA, block after block in order: 73 % of
//     the kernel's time on a flushed 64 MiB chain, so the rounds replaced it
//     (PERF.md).
// Block 0's decode keeps the form of the one-warp chain walk this replaces
// (its window pointer is the output itself, which plen = 0 never reads),
// and a stored block 0 is copied in step C: with that copy loop in step
// A's kernel, a one-block chain decoded 5-6 % slower on the card (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int MAX_OFFSET = 65535;
constexpr int SCAN_THREADS = 1024;
constexpr int COPY_THREADS = 256;
constexpr int COPY_CTAS_PER_BLOCK = 64;
constexpr int JUMP_CTAS = 1024;

// Block metadata: meta is int32 [4, B]: byte offset in the input, payload
// length, cap, stored flag.
struct Meta {
  const int32_t* m;
  int B;
  __device__ int start(int b) const { return m[b]; }
  __device__ int clen(int b) const { return m[B + b]; }
  __device__ int cap(int b) const { return m[2 * B + b]; }
  __device__ bool stored(int b) const { return m[3 * B + b] != 0; }
};

// Block b into out[0, cap): its decoded length, or -1.
__device__ int decode_one(const uint8_t* flat, Meta meta, int b, uint8_t* out,
                          const uint8_t* win_end, int plen, int lane) {
  const uint8_t* src = flat + meta.start(b);
  const int n = meta.clen(b);
  const int cap = meta.cap(b);
  if (!meta.stored(b))
    return decode_block(src, n, out, cap, win_end, plen, lane);
  if (n > cap) return -1;
  for (int i = lane; i < n; i += WARP) out[i] = src[i];
  __syncwarp();
  return n;
}

// (A) Warp b: olen[b] = block b's decoded length or -1, need[b] how far
// it reaches before its start; a compressed block 0 is decoded into out.
__global__ void stream_parse_kernel(const uint8_t* flat, Meta meta,
                                    uint8_t* out, int32_t* olen,
                                    int32_t* need) {
  const int b = blockIdx.x;
  int r, far = 0;
  if (meta.stored(b))
    r = meta.clen(b) <= meta.cap(b) ? meta.clen(b) : -1;
  else if (b == 0)
    r = decode_block(flat + meta.start(0), meta.clen(0), out, meta.cap(0),
                     out, 0, threadIdx.x);
  else
    r = decode_block_t<false, Out::kParse>(
        flat + meta.start(b), meta.clen(b), nullptr, meta.cap(b), nullptr,
        MAX_OFFSET, threadIdx.x, nullptr, &far);
  if (threadIdx.x == 0) {
    olen[b] = r;
    need[b] = far;
  }
}

// (B) One thread: the final statuses, dst[b] = base_b; the rounds' flags
// (nflags of them) cleared.
__global__ void stream_scan_kernel(int B, int32_t* olen, const int32_t* need,
                                   long long* dst, int32_t* more,
                                   int nflags) {
  for (int k = 0; k < nflags; ++k) more[k] = 0;
  long long base = 0;
  for (int b = 0; b < B; ++b) {
    int r = olen[b];
    if (r >= 0 && need[b] > min(base, (long long)MAX_OFFSET)) r = -1;
    olen[b] = r;
    dst[b] = base;
    if (r > 0) base += r;
  }
}

// (C) Warp i decodes good block b = b0 + i >= 1 of the window [b0, b1) into
// cells at dst[b] - dst[c0], c0 = max(b0, 1); warp 0 copies a stored block
// 0 into out.
__global__ void stream_cells_kernel(const uint8_t* flat, Meta meta,
                                    const int32_t* olen, const long long* dst,
                                    int32_t* cells, uint8_t* out, int b0) {
  const int b = b0 + blockIdx.x;
  if (olen[b] <= 0) return;
  if (b == 0) {
    if (meta.stored(0))
      for (int i = threadIdx.x; i < olen[0]; i += WARP)
        out[i] = flat[meta.start(0) + i];
    return;
  }
  int32_t* c = cells + (dst[b] - dst[max(b0, 1)]);
  const uint8_t* src = flat + meta.start(b);
  if (meta.stored(b)) {
    for (int i = threadIdx.x; i < olen[b]; i += WARP) c[i] = src[i];
  } else {
    int far;
    decode_block_t<false, Out::kCells>(
        src, meta.clen(b), c, meta.cap(b), nullptr,
        (int)min(dst[b], (long long)MAX_OFFSET), threadIdx.x, nullptr, &far);
  }
}

// (D) Round k over the cells of blocks [c0, b1), which the good blocks fill
// without a gap from dst[c0] on; the bytes below dst[c0] are in out
// already.
__global__ void stream_jump_kernel(int c0, int b1, const int32_t* olen,
                                   const long long* dst, int32_t* cells,
                                   uint8_t* out, int32_t* more, int k) {
  if (k > 0 && !more[k - 1]) return;
  jump_cells(cells, dst[c0], out, dst[c0],
             dst[b1 - 1] + max(olen[b1 - 1], 0), k == 0,
             (long long)blockIdx.x * blockDim.x + threadIdx.x,
             (long long)gridDim.x * blockDim.x, more + k);
}

__global__ void stream_blocks_kernel(const uint8_t* flat, Meta meta,
                                     const long long* cap_off,
                                     uint8_t* scratch, int32_t* olen) {
  const int b = blockIdx.x;
  const int r = decode_one(flat, meta, b, scratch + cap_off[b], nullptr, 0,
                           threadIdx.x);
  if (threadIdx.x == 0) olen[b] = r;
}

// dst[b] = the sum of max(olen[j], 0) over j < b, in one CTA: each thread
// sums a contiguous range, a Hillis-Steele scan runs over the range sums,
// then each thread writes its range's offsets.
__global__ void stream_offsets_kernel(const int32_t* olen, int B,
                                      long long* dst) {
  __shared__ long long part[SCAN_THREADS];
  const int t = threadIdx.x;
  const int per = (B + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(t * per, B), hi = min(lo + per, B);
  long long sum = 0;
  for (int i = lo; i < hi; ++i) sum += max(olen[i], 0);
  part[t] = sum;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {
    const long long v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - sum;
  for (int i = lo; i < hi; ++i) {
    dst[i] = run;
    run += max(olen[i], 0);
  }
}

// Copies good block b from scratch to its place in out; a grid of
// (B, COPY_CTAS_PER_BLOCK) CTAs.
__global__ void stream_compact_kernel(const uint8_t* scratch,
                                      const long long* cap_off,
                                      const int32_t* olen,
                                      const long long* dst, uint8_t* out) {
  const int b = blockIdx.x;
  const long long n = olen[b];
  const uint8_t* s = scratch + cap_off[b];
  uint8_t* d = out + dst[b];
  const long long step = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x; i < n;
       i += step)
    d[i] = s[i];
}

}  // namespace

// Independent mode uses cap_off, scratch (uint8, the sum of the caps) and
// dst.  Linked mode uses dst, win (nwin + 1 block indices on the host: the
// windows [win[w], win[w + 1]) of steps C and D, win[0] = 0, win[nwin] =
// B), cells (int32, the most output bytes of blocks >= 1 in one window)
// and need (int32 [B + nwin * MAX_JUMP_ROUNDS]).  Pass null for the
// others.
extern "C" int lz4tt_decode_stream(const uint8_t* flat, const int32_t* meta,
                                   int B, int linked,
                                   const long long* cap_off, uint8_t* scratch,
                                   const int32_t* win, int nwin,
                                   int32_t* cells, int32_t* need,
                                   long long* dst, uint8_t* out,
                                   int32_t* olen, void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const Meta m{meta, B};
  if (B > 0 && linked) {
    int32_t* more = need + B;
    stream_parse_kernel<<<B, WARP, 0, s>>>(flat, m, out, olen, need);
    stream_scan_kernel<<<1, 1, 0, s>>>(B, olen, need, dst, more,
                                       nwin * MAX_JUMP_ROUNDS);
    for (int w = 0; w < nwin; ++w, more += MAX_JUMP_ROUNDS) {
      const int b0 = win[w], b1 = win[w + 1], c0 = max(b0, 1);
      stream_cells_kernel<<<b1 - b0, WARP, 0, s>>>(flat, m, olen, dst, cells,
                                                   out, b0);
      // a chain links blocks b1 - 1, ..., c0 and ends in a byte
      if (b1 > c0)
        for (int k = 0; k < jump_rounds(b1 - c0 + 1); ++k)
          stream_jump_kernel<<<JUMP_CTAS, COPY_THREADS, 0, s>>>(
              c0, b1, olen, dst, cells, out, more, k);
    }
  } else if (B > 0) {
    stream_blocks_kernel<<<B, WARP, 0, s>>>(flat, m, cap_off, scratch, olen);
    stream_offsets_kernel<<<1, SCAN_THREADS, 0, s>>>(olen, B, dst);
    stream_compact_kernel<<<dim3(B, COPY_CTAS_PER_BLOCK), COPY_THREADS, 0,
                            s>>>(scratch, cap_off, olen, dst, out);
  }
  return (int)cudaGetLastError();
}
