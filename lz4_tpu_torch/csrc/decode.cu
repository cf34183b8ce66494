// Safe LZ4 block decoder: kernel D, modes `linked` and `batch`.
//
// Replaces the Pallas kernel lz4_tpu/kernels/decode_kernel.py
// _make_decode_kernel (launched by _decode_blocks) in mode "linked"
// (decode_blocks_linked) and mode "batch" without dictionary rows
// (decode_blocks).  Semantics of its general path (slow_seq): the literal
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
// window is row b-1 of the output itself (no copy).  All 32 lanes run the
// same parse on the same bytes (loads of one address are broadcast, so the
// warp never diverges) and split every literal run, and every match whose
// offset is at least 32, into 32-byte strides; a match with a shorter offset
// overlaps its own output and is copied bytewise by lane 0.  Batch mode runs
// one warp per row, all rows in parallel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;

// Length-extension bytes at *ip (a run of 255s closed by a smaller byte);
// false when the run reaches n.
__device__ __forceinline__ bool read_ext(const uint8_t* src, int n, int* ip,
                                         int* len) {
  while (true) {
    if (*ip >= n) return false;
    const int b = src[(*ip)++];
    *len += b;
    if (b != 255) return true;
  }
}

// Decode one block of n bytes into out[0, olim).  The window (plen bytes of
// history) ends at win_end: history byte -k is win_end[-k].  Returns the
// decoded length, or -1.  Called by all lanes of a warp with equal
// arguments except `lane`.
__device__ int decode_block(const uint8_t* src, int n, uint8_t* out, int olim,
                            const uint8_t* win_end, int plen, int lane) {
  int ip = 0, opos = 0;
  while (ip < n) {
    const int token = src[ip++];
    int litlen = token >> 4;
    if (litlen == 15 && !read_ext(src, n, &ip, &litlen)) return -1;
    const long long ip_after = (long long)ip + litlen;
    if (ip_after > n) return -1;                  // literals past clen
    if ((long long)opos + litlen > olim) return -1;
    const bool ended = ip_after == n;
    int mlen = 0, offset = 0, ip_m = 0;
    if (!ended) {
      if (ip_after + 2 > n) return -1;            // no room for the offset
      offset = src[ip_after] | (src[ip_after + 1] << 8);
      ip_m = (int)ip_after + 2;
      mlen = (token & 15) + 4;
      if ((token & 15) == 15 && !read_ext(src, n, &ip_m, &mlen)) return -1;
      if (offset == 0 || offset > opos + litlen + plen) return -1;
      if ((long long)opos + litlen + mlen > olim) return -1;
    }
    for (int i = lane; i < litlen; i += WARP) out[opos + i] = src[ip + i];
    __syncwarp();
    opos += litlen;
    if (ended) return opos;
    const int from = opos - offset;
    if (offset >= WARP) {
      // each 32-byte stride reads only bytes written before it
      for (int base = 0; base < mlen; base += WARP) {
        const int i = base + lane;
        if (i < mlen) {
          const int p = from + i;
          out[opos + i] = p < 0 ? win_end[p] : out[p];
        }
        __syncwarp();
      }
    } else {
      if (lane == 0)
        for (int i = 0; i < mlen; ++i) {
          const int p = from + i;
          out[opos + i] = p < 0 ? win_end[p] : out[p];
        }
      __syncwarp();
    }
    opos += mlen;
    ip = ip_m;
  }
  return -1;  // the block must end with a literal-only sequence
}

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

__global__ void decode_batch_kernel(const uint8_t* comp, int M,
                                    const int32_t* clen, const int32_t* ocap,
                                    uint8_t* out, int N, int32_t* olen) {
  const int b = blockIdx.x;
  const int n = min(max(clen[b], 0), M);
  const int r = decode_block(comp + (long long)b * M, n,
                             out + (long long)b * N, min(ocap[b], N),
                             nullptr, 0, threadIdx.x);
  if (threadIdx.x == 0) olen[b] = r;
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

extern "C" int lz4tt_decode_batch(const uint8_t* comp, int M,
                                  const int32_t* clen, const int32_t* ocap,
                                  uint8_t* out, int N, int32_t* olen, int B,
                                  void* cuda_stream) {
  if (B > 0)
    decode_batch_kernel<<<B, WARP, 0, (cudaStream_t)cuda_stream>>>(
        comp, M, clen, ocap, out, N, olen);
  return (int)cudaGetLastError();
}
