// The destSize block encoder: kernel H.
//
// Replaces the Pallas kernel lz4_tpu/kernels/destsize_kernel.py
// _make_destsize_kernel (launched by _encode_dest_size): every row holds
// [prefix | source]; the source is compressed into at most cap[b] bytes, the
// parse stops at a token boundary when the next sequence and a minimal final
// literal run would not fit, and the row reports the source bytes its block
// covers.  Matches may reach into the prefix, which is seeded into the hash
// table at every third position.  The parse is dest_size_block in
// destsize.cuh (shared with kernel G), the TPU kernel's decision for
// decision, so blocks, lengths and consumed counts are bit-identical to
// lz4_tpu's.
//
// What bounds it on the card: a row's parse is a chain of dependent loads
// (hash -> table -> compare -> extend -> emit), so a row runs at the latency
// of one thread, and the batch at its slowest rows over the rows resident
// at once.  The design: one CTA per row; its threads set the row's own
// 16,384-entry table (64 KB of dynamic shared memory, so at most three rows
// are resident per SM) to -1 and seed the prefix together, then thread 0
// scans.  The TPU kernel shared one table across rows under a row tag and
// cleared it every 8,192 rows; a fresh table per row gives the same
// answers.  The row is read where the parse stands, bytes [0, n) only: no
// val32 lanes and no slack lanes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "destsize.cuh"

namespace {

using lz4tt::HASH_BYTES;
using lz4tt::HASH_SIZE;

constexpr int THREADS = 128;

__global__ void dest_size_kernel(const uint8_t* rows, int NS,
                                 const int32_t* slen, const int32_t* caps,
                                 const int32_t* wlen, int acceleration,
                                 int min_match, uint8_t* out, int M,
                                 int32_t* olen, int32_t* consumed) {
  extern __shared__ int32_t table[];
  const int b = blockIdx.x;
  const uint8_t* src = rows + (long long)b * NS;
  const int start = min(max(wlen[b], 0), NS);
  const int n = start + min(max(slen[b], 0), NS - start);
  const bool scans = n - start >= 13;
  if (scans) {
    for (int i = threadIdx.x; i < HASH_SIZE; i += blockDim.x) table[i] = -1;
    __syncthreads();
    // every third prefix position; a later position replaces an earlier one
    // with the same hash, which is what the maximum keeps
    const int seeds = start >= 4 ? (start - 4) / 3 + 1 : 0;
    for (int i = threadIdx.x; i < seeds; i += blockDim.x)
      atomicMax(&table[lz4tt::hash5(src + 3 * i)], 3 * i);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  int cons = 0;
  olen[b] = lz4tt::dest_size_block(
      src, start, n, 0, start + (start > 0 ? 0 : 1), min(caps[b], M), table,
      acceleration, min_match, out + (long long)b * M, &cons);
  consumed[b] = cons;
}

}  // namespace

// rows is [B, NS] uint8, out [B, M] with M >= compress_bound(NS).
extern "C" int lz4tt_encode_dest_size(const uint8_t* rows, int NS,
                                      const int32_t* slen,
                                      const int32_t* caps,
                                      const int32_t* wlen, int acceleration,
                                      int min_match, uint8_t* out, int M,
                                      int32_t* olen, int32_t* consumed, int B,
                                      void* cuda_stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dest_size_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      HASH_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    dest_size_kernel<<<B, THREADS, HASH_BYTES, (cudaStream_t)cuda_stream>>>(
        rows, NS, slen, caps, wlen, acceleration, min_match, out, M, olen,
        consumed);
  return (int)cudaGetLastError();
}
