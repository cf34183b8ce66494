// The scatter-gather chain encoder: kernel G.
//
// Replaces the Pallas kernel lz4_tpu/kernels/destsize_kernel.py
// _make_sg_chain_kernel (launched by _sg_encode_chain): the whole LZ4_SG
// buffer-pair walk of sg_compress in one pass.  Each step destSize-
// compresses the rest of the current input buffer (at most 64 KB of it)
// into the room left in the current output buffer, then advances the walk
// (input buffer switch; output buffer switch with an optional 5-byte
// zero-pad block).  The parse is the TPU kernel's decision for decision,
// including its int32 capacity arithmetic, so every step's bytes, lengths
// and consumed counts are bit-identical to lz4_tpu's.  A step's parse is
// dest_size_block in destsize.cuh, which kernel H (destsize.cu) shares.
//
// What bounds it on the card: the walk is serial by format (each step's
// source and room depend on what the step before consumed), and so is the
// parse inside a step (each probe writes the table slot the next may read;
// a match moves the scan to its end).  So one CTA runs the walk on 1 of the
// 132 SMs, and the time is the latency of the parse's chain of dependent
// steps, not bytes.  The design shortens that chain per sequence: warp 0
// runs each step's parse as dest_size_block in destsize.cuh does, in
// rounds of 32 speculative probes with the extension and the writing of
// the sequences spread over its lanes; its lanes hold the same walk state,
// and lane 0 writes the step records.  The 16,384-entry hash table (64 KB)
// lives in dynamic shared memory for the whole walk (the CTA's threads set
// it to -1 together first); the source is one flat buffer in global
// memory, read where the parse stands, so it stays hot in L1 (staging each
// step's window in a 128 KB ring of shared memory measured slower); there
// is no 64 KB zero lead and there are no val32 lanes, which the TPU needed
// only for its row copies.  The TPU kernel wrote each step into a [T, M]
// row (about 574 MB at 16 MiB of 4 KB buffers); here the steps' blocks
// follow each other at a running offset.
//
// The list axis (lz4tt_sg_encode_chain_batch): L lists of one layout (the
// same input ends and output caps) walk in one launch, one CTA per list,
// each with its own hash table in its SM's shared memory and its own rows
// of source, blocks, offsets and records.  The TPU's mesh walked a
// device's lists one after another (lax.map in lz4_tpu/parallel/mesh.py);
// here the lists' walks run side by side on up to 132 SMs (several per SM,
// as their 64 KB tables allow), so a bucket takes about one walk's time.
// lz4tt_sg_encode_chain is the batch of one list.
#include <cuda_runtime.h>
#include <stdint.h>

#include "destsize.cuh"

namespace {

using lz4tt::HASH_BYTES;
using lz4tt::HASH_SIZE;

constexpr int SG_HEADER = 15;
constexpr int BH = 4;
constexpr int CHAIN_BLOCK = 65536;
constexpr int THREADS = 256;  // all set the table; warp 0 walks

// List blockIdx.x: its source at src + blockIdx.x * src_stride, its blocks
// at blocks + blockIdx.x * blocks_stride, its offsets boff[blockIdx.x] [T]
// and its records recs[blockIdx.x], int32 [4, T]: blen, consumed, isz, osz.
__global__ void sg_chain_kernel(const uint8_t* src, long long src_stride,
                                const int32_t* in_ends, int n_in,
                                const int32_t* caps, int n_out, int total,
                                int max_dest, int T, int M, int acceleration,
                                int min_match, uint8_t* blocks,
                                long long blocks_stride, long long* boff,
                                int32_t* recs) {
  extern __shared__ int32_t table[];
  src += blockIdx.x * src_stride;
  blocks += blockIdx.x * blocks_stride;
  boff += (long long)blockIdx.x * T;
  recs += (long long)blockIdx.x * 4 * T;
  for (int i = threadIdx.x; i < HASH_SIZE; i += blockDim.x) table[i] = -1;
  __syncthreads();
  if (threadIdx.x >= lz4tt::WARP) return;
  const bool lead = threadIdx.x == 0;
  int32_t* blen = recs;
  int32_t* cons = recs + T;
  int32_t* isz = recs + 2 * T;
  int32_t* osz = recs + 3 * T;
  int ipos = 0, ibuf = 0, oidx = 0, opos = SG_HEADER, ototal = SG_HEADER;
  bool done = false;
  long long off = 0;  // where the next step's block goes
  for (int t = 0; t < T; ++t) {
    if (lead) boff[t] = off;
    if (done || ipos >= total || ototal + BH >= max_dest) {
      done = true;
      if (lead) {
        blen[t] = -1;
        cons[t] = isz[t] = osz[t] = 0;
      }
      continue;
    }
    const int opos_h = opos + BH, ototal_h = ototal + BH;
    const int i_size = min(in_ends[ibuf + 1] - ipos, total - ipos);
    const int i_take = min(i_size, CHAIN_BLOCK);
    const int o_size = min(caps[oidx] - opos_h, max_dest - ototal_h);
    const int cap = min(o_size, M);
    // matches reach back to the start of the previous input buffer
    const int low =
        max(max(ipos - 65535, ibuf > 0 ? in_ends[ibuf - 1] : 0), 0);
    int consumed = 0;
    const int o_written = lz4tt::dest_size_block(
        src, ipos, ipos + i_take, low, ipos + (ipos == 0 ? 1 : 0), cap, table,
        acceleration, min_match, blocks + off, &consumed);
    off += o_written;
    if (lead) {
      blen[t] = o_written;
      cons[t] = consumed;
      isz[t] = i_size;
      osz[t] = o_size;
    }
    // walk state update (sg.sg_compress's input and output advance)
    const bool no_progress = consumed == 0 || o_written == 0;
    ipos += consumed;
    const bool in_done = consumed == i_size;
    const int ibuf2 = in_done ? ibuf + 1 : ibuf;
    const bool input_exhausted = in_done && ibuf2 >= n_in;
    const bool adv_out = o_written + 1 + BH >= o_size;
    const int oidx2 = adv_out ? oidx + 1 : oidx;
    const bool out_exhausted = adv_out && oidx2 >= n_out;
    const bool zero_pad = adv_out && o_written != o_size &&
                          ototal_h + o_written + BH < max_dest;
    opos = adv_out ? (zero_pad ? 1 + BH - (o_size - o_written) : 0)
                   : opos_h + o_written;
    ototal = ototal_h + o_written + (zero_pad ? 1 + BH : 0);
    ibuf = min(ibuf2, n_in);
    oidx = min(oidx2, n_out - 1);
    done = no_progress || input_exhausted || out_exhausted;
  }
}

}  // namespace

// src holds L rows of src_stride bytes, each the content (total bytes) and
// at least 8 more.  blocks holds L rows of blocks_stride >= min(max_dest,
// T * M) + 2 * M bytes; boff is [L, T], recs [L, 4, T].
extern "C" int lz4tt_sg_encode_chain_batch(
    const uint8_t* src, long long src_stride, int L, const int32_t* in_ends,
    int n_in, const int32_t* caps, int n_out, int total, int max_dest, int T,
    int M, int acceleration, int min_match, uint8_t* blocks,
    long long blocks_stride, long long* boff, int32_t* recs,
    void* cuda_stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sg_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      HASH_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (T > 0 && L > 0)
    sg_chain_kernel<<<L, THREADS, HASH_BYTES, (cudaStream_t)cuda_stream>>>(
        src, src_stride, in_ends, n_in, caps, n_out, total, max_dest, T, M,
        acceleration, min_match, blocks, blocks_stride, boff, recs);
  return (int)cudaGetLastError();
}

// One list: src holds the content (total bytes) and at least 8 more.
// blocks must hold min(max_dest, T * M) + 2 * M bytes.
extern "C" int lz4tt_sg_encode_chain(const uint8_t* src,
                                     const int32_t* in_ends, int n_in,
                                     const int32_t* caps, int n_out,
                                     int total, int max_dest, int T, int M,
                                     int acceleration, int min_match,
                                     uint8_t* blocks, long long* boff,
                                     int32_t* recs, void* cuda_stream) {
  return lz4tt_sg_encode_chain_batch(src, 0, 1, in_ends, n_in, caps, n_out,
                                     total, max_dest, T, M, acceleration,
                                     min_match, blocks, 0, boff, recs,
                                     cuda_stream);
}
