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
// What bounds it on the card: a row's parse is serial (each probe writes
// the table slot the next may read; a match moves the scan to its end), so
// a row runs at the latency of its chain of dependent steps, and the batch
// at its slowest rows over the rows resident at once.  The design: one CTA
// per row; its threads set the row's own 16,384-entry table to empty and
// seed the prefix together, then warp 0 runs the parse (dest_size_block in
// destsize.cuh) in rounds of 32 speculative probes, with the extension and
// the writing of the sequences spread over its lanes.  Rows of at most
// 64 KB keep 16-bit positions, so their table takes 32 KB of shared memory
// and up to six rows are resident per SM; wider rows take 32-bit positions
// and 64 KB, three rows per SM.  The TPU kernel shared one table across rows
// under a row tag and cleared it every 8,192 rows; a fresh table per row
// gives the same answers.  The row is read where the parse stands, in
// global memory (through L1): staging it in shared memory beside the table
// would leave room for fewer rows per SM.  No val32 lanes and no slack
// lanes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "destsize.cuh"

namespace {

using lz4tt::HASH_SIZE;

constexpr int THREADS = 128;
constexpr int SMALL_ROWS = 65536;  // rows up to this width take 16-bit tables

// table[h] = max(table[h], pos), for a table that is empty (-1) where no
// position went yet.
__device__ __forceinline__ void seed(int32_t* table, int h, int pos) {
  atomicMax(&table[h], pos);
}

__device__ __forceinline__ void seed(uint16_t* table, int h, int pos) {
  // (no 16-bit atomics: a compare-and-swap on the word holding the entry;
  // the empty entry 0xFFFF counts as below every position)
  unsigned* word = (unsigned*)(table + (h & ~1));
  const int sh = (h & 1) * 16;
  unsigned old = *word, seen;
  do {
    seen = old;
    const unsigned cur = (seen >> sh) & 0xFFFFu;
    if (cur != 0xFFFFu && (int)cur >= pos) return;
    old = atomicCAS(word, seen,
                    (seen & ~(0xFFFFu << sh)) | ((unsigned)pos << sh));
  } while (old != seen);
}

template <class T>
__global__ void dest_size_kernel(const uint8_t* rows, int NS,
                                 const int32_t* slen, const int32_t* caps,
                                 const int32_t* wlen, int acceleration,
                                 int min_match, uint8_t* out, int M,
                                 int32_t* olen, int32_t* consumed) {
  extern __shared__ int32_t smem[];
  T* table = (T*)smem;
  const int b = blockIdx.x;
  const uint8_t* src = rows + (long long)b * NS;
  const int start = min(max(wlen[b], 0), NS);
  const int n = start + min(max(slen[b], 0), NS - start);
  const bool scans = n - start >= 13;
  if (scans) {
    for (int i = threadIdx.x; i < HASH_SIZE; i += blockDim.x)
      table[i] = (T)-1;
    __syncthreads();
    // every third prefix position; a later position replaces an earlier one
    // with the same hash, which is what the maximum keeps
    const int seeds = start >= 4 ? (start - 4) / 3 + 1 : 0;
    for (int i = threadIdx.x; i < seeds; i += blockDim.x)
      seed(table, lz4tt::hash5(src + 3 * i), 3 * i);
    __syncthreads();
  }
  if (threadIdx.x >= lz4tt::WARP) return;
  int cons = 0;
  const int written = lz4tt::dest_size_block(
      src, start, n, 0, start + (start > 0 ? 0 : 1), min(caps[b], M), table,
      acceleration, min_match, out + (long long)b * M, &cons);
  if (threadIdx.x == 0) {
    olen[b] = written;
    consumed[b] = cons;
  }
}

template <class T>
int launch(const uint8_t* rows, int NS, const int32_t* slen,
           const int32_t* caps, const int32_t* wlen, int acceleration,
           int min_match, uint8_t* out, int M, int32_t* olen,
           int32_t* consumed, int B, cudaStream_t stream) {
  const int bytes = HASH_SIZE * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      dest_size_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    dest_size_kernel<T><<<B, THREADS, bytes, stream>>>(
        rows, NS, slen, caps, wlen, acceleration, min_match, out, M, olen,
        consumed);
  return (int)cudaGetLastError();
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
  // positions in a row fit 16 bits (65,535, never a probe, marks empty)
  return NS <= SMALL_ROWS
             ? launch<uint16_t>(rows, NS, slen, caps, wlen, acceleration,
                                min_match, out, M, olen, consumed, B,
                                (cudaStream_t)cuda_stream)
             : launch<int32_t>(rows, NS, slen, caps, wlen, acceleration,
                               min_match, out, M, olen, consumed, B,
                               (cudaStream_t)cuda_stream);
}
