// Frame body assembly: kernel C.
//
// Replaces the Pallas kernel lz4_tpu/kernels/pack_kernel.py
// _make_pack_kernel (launched by _pack_payloads, pack_kernel.py:161):
// [LE32 header | payload] per block at its exclusive-scan offset in one flat
// buffer, with the plaintext as payload for a stored block.
//
// What bounds it on the card: pure data movement, about 2 bytes of traffic
// per output byte, so device-memory bandwidth; and, at a 4 MB chunk's
// 0.0010 ms bound, the launches themselves.  On the TPU the kernel had to
// roll, merge and read back 128-lane rows to place a payload at a byte
// offset, and its wrapper worked the offsets out in XLA.  Here two launches
// do it all, and the host waits on neither:
// 1. pack_prologue_kernel, one CTA: per block the stored flag, the payload
//    size, the header, the exclusive scan of 4 + size to the record's
//    offset, and into meta the body's total and a fault flag, set when a
//    length falls outside its row (blen outside [0, NS], or a compressed
//    olen outside [0, M]).  The host reads both in one copy when it reads
//    the total (kernels/pack_kernel.py body_length).
// 2. pack_copy_kernel, a CTA per (block, 4 KB of its record) over the
//    whole card: the destination in 16-byte chunks, a thread each; a chunk
//    inside the payload is one 16-byte store of bytes gathered from five
//    aligned source words, the chunks at the payload's edges go byte by
//    byte.  After a fault it reads and writes nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int PRO_THREADS = 1024;
constexpr int COPY_THREADS = 256;  // one 16-byte chunk a thread

__global__ void __launch_bounds__(PRO_THREADS)
    pack_prologue_kernel(const int32_t* olen, const int32_t* blen, int B,
                         int M, int NS, int32_t* eff, int32_t* hdr,
                         long long* dst, uint8_t* stored, long long* meta) {
  __shared__ long long warp_sum[PRO_THREADS / WARP];
  __shared__ long long carry;
  __shared__ int fault;
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  if (threadIdx.x == 0) {
    carry = 0;
    fault = 0;
  }
  __syncthreads();
  for (int base = 0; base < B; base += PRO_THREADS) {
    const int b = base + threadIdx.x;
    long long step = 0;
    if (b < B) {
      const int bl = blen[b], ol = olen[b];
      const bool live = bl > 0, st = live && ol >= bl;
      if (bl < 0 || bl > NS || (live && !st && (ol < 0 || ol > M))) fault = 1;
      const int e = live ? (st ? bl : ol) : 0;
      eff[b] = e;
      hdr[b] = st ? (int32_t)((uint32_t)bl | 0x80000000u) : ol;
      stored[b] = st;
      step = live ? 4 + (long long)e : 0;
    }
    long long x = step;  // inclusive scan: the warp, then the warps' sums
#pragma unroll
    for (int o = 1; o < WARP; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == WARP - 1) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long s = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < WARP; o <<= 1) {
        const long long y = __shfl_up_sync(FULL, s, o);
        if (lane >= o) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    const long long incl = x + (warp ? warp_sum[warp - 1] : 0) + carry;
    if (b < B) dst[b] = incl - step;
    __syncthreads();
    if (threadIdx.x == PRO_THREADS - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    meta[0] = carry;
    meta[1] = fault;
  }
}

__global__ void __launch_bounds__(COPY_THREADS)
    pack_copy_kernel(const uint8_t* comp, int comp_stride, const uint8_t* src,
                     long long src_stride, const int32_t* blen,
                     const int32_t* eff, const int32_t* hdr,
                     const long long* dst, const uint8_t* stored,
                     const long long* meta, uint8_t* flat) {
  const int b = blockIdx.x;
  if (meta[1] || blen[b] <= 0) return;  // a fault, or a padding row
  const uint8_t* from = stored[b] ? src + b * src_stride
                                  : comp + (long long)b * comp_stride;
  const long long d = dst[b], first = d + 4, end = first + eff[b];
  if (blockIdx.y == 0 && threadIdx.x < 4)
    flat[d + threadIdx.x] = (uint8_t)((uint32_t)hdr[b] >> (8 * threadIdx.x));
  // chunk j holds flat[16 j, 16 j + 16); this thread's part of the payload
  const long long j =
      (first >> 4) + (long long)blockIdx.y * COPY_THREADS + threadIdx.x;
  const long long lo = max(16 * j, first), hi = min(16 * j + 16, end);
  if (lo >= hi) return;
  if (hi - lo == 16) {
    const uintptr_t a = (uintptr_t)(from + (lo - first));
    const uint32_t* q = (const uint32_t*)(a & ~(uintptr_t)3);
    const uint32_t sh = (uint32_t)(a & 3) * 8;
    const uint32_t x0 = q[0], x1 = q[1], x2 = q[2], x3 = q[3];
    const uint32_t x4 = sh ? q[4] : 0;  // the word of the last byte, if new
    *(uint4*)(flat + lo) =
        make_uint4(__funnelshift_r(x0, x1, sh), __funnelshift_r(x1, x2, sh),
                   __funnelshift_r(x2, x3, sh), __funnelshift_r(x3, x4, sh));
  } else {
    for (long long k = lo; k < hi; ++k) flat[k] = from[k - first];
  }
}

}  // namespace

extern "C" int lz4tt_pack(const uint8_t* comp, int comp_stride,
                          const uint8_t* src, long long src_stride, int NS,
                          const int32_t* olen, const int32_t* blen, int B,
                          int32_t* eff, int32_t* hdr, long long* dst,
                          uint8_t* stored, long long* meta, uint8_t* flat,
                          void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  pack_prologue_kernel<<<1, PRO_THREADS, 0, s>>>(olen, blen, B, comp_stride,
                                                 NS, eff, hdr, dst, stored,
                                                 meta);
  const int err = (int)cudaGetLastError();
  if (err || B <= 0) return err;
  // a record's payload touches at most (width + 15) / 16 + 1 chunks
  const long long width = comp_stride > NS ? comp_stride : NS;
  const int pieces =
      (int)(((width + 15) / 16 + 1 + COPY_THREADS - 1) / COPY_THREADS);
  pack_copy_kernel<<<dim3(B, pieces), COPY_THREADS, 0, s>>>(
      comp, comp_stride, src, src_stride, blen, eff, hdr, dst, stored, meta,
      flat);
  return (int)cudaGetLastError();
}
