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
// rings, and a linked block's window is the flat output itself.  Linked
// mode is serial by format: one warp walks the chain.  Independent mode
// runs one warp per block, all blocks at once, each writing into scratch
// at the exclusive prefix sum of the caps; a one-CTA scan of the decoded
// lengths and a copy kernel then compact the good blocks in order, so the
// bytes and lengths are the serial walk's (independent blocks never read
// each other).
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int MAX_OFFSET = 65535;
constexpr int SCAN_THREADS = 1024;
constexpr int COPY_THREADS = 256;
constexpr int COPY_CTAS_PER_BLOCK = 64;

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

__global__ void stream_linked_kernel(const uint8_t* flat, Meta meta,
                                     uint8_t* out, int32_t* olen) {
  const int lane = threadIdx.x;
  long long base = 0;  // output position of the next block
  for (int b = 0; b < meta.B; ++b) {
    uint8_t* o = out + base;
    const int r = decode_one(flat, meta, b, o, o,
                             (int)min(base, (long long)MAX_OFFSET), lane);
    if (lane == 0) olen[b] = r;
    if (r > 0) base += r;
    __syncwarp();
  }
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

// Linked mode uses neither cap_off, scratch nor dst (pass null).
extern "C" int lz4tt_decode_stream(const uint8_t* flat, const int32_t* meta,
                                   int B, int linked,
                                   const long long* cap_off, uint8_t* scratch,
                                   long long* dst, uint8_t* out,
                                   int32_t* olen, void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const Meta m{meta, B};
  if (B > 0 && linked) {
    stream_linked_kernel<<<1, WARP, 0, s>>>(flat, m, out, olen);
  } else if (B > 0) {
    stream_blocks_kernel<<<B, WARP, 0, s>>>(flat, m, cap_off, scratch, olen);
    stream_offsets_kernel<<<1, SCAN_THREADS, 0, s>>>(olen, B, dst);
    stream_compact_kernel<<<dim3(B, COPY_CTAS_PER_BLOCK), COPY_THREADS, 0,
                            s>>>(scratch, cap_off, olen, dst, out);
  }
  return (int)cudaGetLastError();
}
