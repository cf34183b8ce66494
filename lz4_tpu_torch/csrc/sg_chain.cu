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
// and consumed counts are bit-identical to lz4_tpu's.
//
// What bounds it on the card: the walk is serial by format (each step's
// source and room depend on what the step before consumed), and the parse
// inside a step is a chain of dependent loads (hash -> table -> compare ->
// extend -> emit).  So one thread runs it, as the TPU's ordered grid did,
// and the kernel uses 1 of the 132 SMs.  The design keeps that chain's
// loads short: the 16,384-entry hash table (64 KB) lives in dynamic shared
// memory for the whole walk (the CTA's threads zero it together first);
// the source is one flat buffer in global memory, read where the parse
// stands, so it stays hot in L1; there is no 64 KB zero lead and there are
// no val32 lanes, which the TPU needed only for its row copies.  The TPU
// kernel wrote each step into a [T, M] row (about 574 MB at 16 MiB of 4 KB
// buffers); here the steps' blocks follow each other at a running offset.
#include <cuda_runtime.h>
#include <stdint.h>

#include "emit.cuh"

namespace {

constexpr int HASH_LOG = 14;
constexpr int HASH_SIZE = 1 << HASH_LOG;
constexpr int SKIP_TRIGGER = 6;
constexpr uint32_t PRIME = 2654435761u;  // -1640531535 as uint32
constexpr int SG_HEADER = 15;
constexpr int BH = 4;
constexpr int CHAIN_BLOCK = 65536;
constexpr int ZERO_THREADS = 256;

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

__device__ __forceinline__ int hash5(const uint8_t* p) {
  const uint32_t x = (le32(p) ^ ((uint32_t)p[4] * PRIME)) * PRIME;
  return (int)((x >> (32 - HASH_LOG)) & (HASH_SIZE - 1));
}

// The TPU kernel's y // 255 by a magic multiply in int32 (exact below
// 65280; the wrap-around above it is part of the parse it defines).
__device__ __forceinline__ int div255(int y) {
  const int q0 = (int)((uint32_t)y * 32897u) >> 23;
  const int r = y - q0 * 255;
  return q0 - (r < 0 ? 1 : 0);
}

__device__ __forceinline__ int ext_bytes(int x) {
  return x < 15 ? 0 : 1 + div255(x - 15);
}

__device__ __forceinline__ int seq_size(int litlen, int mlc) {
  return 1 + litlen + 2 + ext_bytes(litlen) + ext_bytes(mlc);
}

__device__ __forceinline__ int final_run_size(int litlen) {
  return 1 + litlen + ext_bytes(litlen);
}

__device__ __forceinline__ int fix_guess(int g, int room) {
  return (g >= 15 && final_run_size(g) > room) ? g - 1 : g;
}

// Largest L <= avail whose final run fits room (-1 if none): the closed
// form and two fix-ups of the TPU kernel's _max_final_literals.
__device__ int max_final_literals(int room, int avail) {
  const int best14 = min(min(room - 1, 14), avail);
  int guess = min(avail, room - 2 - div255(max(room - 17, 0)));
  guess = fix_guess(fix_guess(guess, room), room);
  const bool big_ok = guess >= 15 && final_run_size(guess) <= room;
  const int best = big_ok ? max(guess, best14) : best14;
  return room < 1 ? -1 : best;
}

// recs is int32 [4, T]: blen, consumed, isz, osz.
__global__ void sg_chain_kernel(const uint8_t* src, const int32_t* in_ends,
                                int n_in, const int32_t* caps, int n_out,
                                int total, int max_dest, int T, int M,
                                int acceleration, int min_match,
                                uint8_t* blocks, long long* boff,
                                int32_t* recs) {
  extern __shared__ int32_t table[];
  for (int i = threadIdx.x; i < HASH_SIZE; i += blockDim.x) table[i] = -1;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int32_t* blen = recs;
  int32_t* cons = recs + T;
  int32_t* isz = recs + 2 * T;
  int32_t* osz = recs + 3 * T;
  const int accel0 = acceleration << SKIP_TRIGGER;
  int ipos = 0, ibuf = 0, oidx = 0, opos = SG_HEADER, ototal = SG_HEADER;
  bool done = false;
  long long off = 0;  // where the next step's block goes
  for (int t = 0; t < T; ++t) {
    boff[t] = off;
    if (done || ipos >= total || ototal + BH >= max_dest) {
      done = true;
      blen[t] = -1;
      cons[t] = isz[t] = osz[t] = 0;
      continue;
    }
    const int opos_h = opos + BH, ototal_h = ototal + BH;
    const int i_size = min(in_ends[ibuf + 1] - ipos, total - ipos);
    const int i_take = min(i_size, CHAIN_BLOCK);
    const int o_size = min(caps[oidx] - opos_h, max_dest - ototal_h);
    const int cap = min(o_size, M);
    const int start = ipos, n_end = ipos + i_take;
    const int mflimit = n_end - 12, matchlimit = n_end - 5;
    // matches reach back to the start of the previous input buffer
    const int low =
        max(max(ipos - 65535, ibuf > 0 ? in_ends[ibuf - 1] : 0), 0);
    uint8_t* out = blocks + off;
    int op = 0, anchor = start, scnt = accel0;
    int ip = start + (start == 0 ? 1 : 0);
    if (i_take >= 13) {
      while (ip <= mflimit) {
        const int h = hash5(src + ip);
        const int e = table[h];
        table[h] = ip;
        // a capacity-stopped step may have left entries at or past ip
        if (!(e >= low && e < ip && ip - e <= 65535 &&
              le32(src + e) == le32(src + ip))) {
          ip += scnt >> SKIP_TRIGGER;
          ++scnt;
          continue;
        }
        int mp = ip, q2 = e;
        while (mp > anchor && q2 > low && src[mp - 1] == src[q2 - 1]) {
          --mp;
          --q2;
        }
        int ml = ip + 4 - mp;
        while (mp + ml + 4 <= matchlimit &&
               le32(src + q2 + ml) == le32(src + mp + ml))
          ml += 4;
        const uint32_t diff = le32(src + q2 + ml) ^ le32(src + mp + ml);
        const int tail = ((diff & 0xFFu) == 0) + ((diff & 0xFFFFu) == 0) +
                         ((diff & 0xFFFFFFu) == 0);
        ml = min(ml + tail, matchlimit - mp);
        if (ml < min_match) {  // (min_match > 4): a skip, not a stop
          ip += scnt >> SKIP_TRIGGER;
          ++scnt;
          continue;
        }
        const int litlen = mp - anchor;
        const int need = seq_size(litlen, ml - 4) +
                         final_run_size(min(5, n_end - (mp + ml)));
        if (op + need > cap) break;  // capacity stop
        op = lz4tt::emit_seq(out, op, src + anchor, litlen, ip - e, ml - 4);
        ip = anchor = mp + ml;
        table[hash5(src + ip - 2)] = ip - 2;
        scnt = accel0;
      }
    }
    const int lit = max_final_literals(cap - op, n_end - anchor);
    int o_written = 0, consumed = 0;
    if (lit >= 0) {
      o_written = lz4tt::emit_final(out, op, src + anchor, lit);
      consumed = anchor - start + lit;
      off += o_written;
    }
    blen[t] = o_written;
    cons[t] = consumed;
    isz[t] = i_size;
    osz[t] = o_size;
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

// src holds the content (total bytes) and at least 8 more.  blocks must
// hold min(max_dest, T * M) + 2 * M bytes.
extern "C" int lz4tt_sg_encode_chain(const uint8_t* src,
                                     const int32_t* in_ends, int n_in,
                                     const int32_t* caps, int n_out,
                                     int total, int max_dest, int T, int M,
                                     int acceleration, int min_match,
                                     uint8_t* blocks, long long* boff,
                                     int32_t* recs, void* cuda_stream) {
  const int smem = HASH_SIZE * (int)sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sg_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (T > 0)
    sg_chain_kernel<<<1, ZERO_THREADS, smem, (cudaStream_t)cuda_stream>>>(
        src, in_ends, n_in, caps, n_out, total, max_dest, T, M, acceleration,
        min_match, blocks, boff, recs);
  return (int)cudaGetLastError();
}
