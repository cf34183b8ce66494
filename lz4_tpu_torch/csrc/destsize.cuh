// The destSize block parse shared by kernel G (sg_chain.cu) and kernel H
// (destsize.cu): a greedy hash-table scan that stops at a token boundary
// when its output would pass a capacity, always leaving room for a final
// literal run, and reports the source bytes it covered.
//
// Counterpart of the scan inside lz4_tpu/kernels/destsize_kernel.py's
// _make_destsize_kernel and _make_sg_chain_kernel, decision for decision,
// except that div255 is exact: the TPU kernels' int32 magic multiply wraps
// from 65,280, which sizes literal runs of 65,295 bytes or more short and
// lets a block pass its capacity.
// Sequences are sized and written through emit.cuh only.
#pragma once

#include <stdint.h>

#include "emit.cuh"

namespace lz4tt {

constexpr int HASH_LOG = 14;
constexpr int HASH_SIZE = 1 << HASH_LOG;
constexpr int HASH_BYTES = HASH_SIZE * (int)sizeof(int32_t);
constexpr int SKIP_TRIGGER = 6;
constexpr uint32_t PRIME = 2654435761u;  // -1640531535 as uint32

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

__device__ __forceinline__ int hash5(const uint8_t* p) {
  const uint32_t x = (le32(p) ^ ((uint32_t)p[4] * PRIME)) * PRIME;
  return (int)((x >> (32 - HASH_LOG)) & (HASH_SIZE - 1));
}

// y // 255 for y >= 0 (every caller's argument is).
__device__ __forceinline__ int div255(int y) { return y / 255; }

__device__ __forceinline__ int fix_guess(int g, int room) {
  return (g >= 15 && final_run_size(g) > room) ? g - 1 : g;
}

// Largest L <= avail whose final run fits room (-1 if none): the closed
// form and two fix-ups of the TPU kernel's _max_final_literals.
__device__ inline int max_final_literals(int room, int avail) {
  const int best14 = min(min(room - 1, 14), avail);
  int guess = min(avail, room - 2 - div255(max(room - 17, 0)));
  guess = fix_guess(fix_guess(guess, room), room);
  const bool big_ok = guess >= 15 && final_run_size(guess) <= room;
  const int best = big_ok ? max(guess, best14) : best14;
  return room < 1 ? -1 : best;
}

// One destSize block: source bytes [start, n_end) of `src` into at most
// `cap` bytes at `out`.  Matches reach back to `low` (backward extension
// stops above it).  `table` holds HASH_SIZE positions into `src`, -1 where
// empty; entries from earlier calls stay valid candidates.  The scan starts
// at `first` (`start`, or one past it for a source with no history).
// Returns the bytes written and sets *consumed; both are 0 when not even
// one literal fits.  Run by one thread.
//
// The block is a valid parse of the bytes it covers, so it is never longer
// than compress_bound(n_end - start), whatever `cap` says: `out` must hold
// that much.
__device__ inline int dest_size_block(const uint8_t* src, int start,
                                      int n_end, int low, int first, int cap,
                                      int32_t* table, int acceleration,
                                      int min_match, uint8_t* out,
                                      int* consumed) {
  const int mflimit = n_end - 12, matchlimit = n_end - 5;
  const int accel0 = acceleration << SKIP_TRIGGER;
  int op = 0, anchor = start, scnt = accel0, ip = first;
  if (n_end - start >= 13) {
    while (ip <= mflimit) {
      const int h = hash5(src + ip);
      const int e = table[h];
      table[h] = ip;
      // a capacity-stopped block may have left entries at or past ip
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
      op = emit_seq(out, op, src + anchor, litlen, ip - e, ml - 4);
      ip = anchor = mp + ml;
      table[hash5(src + ip - 2)] = ip - 2;
      scnt = accel0;
    }
  }
  const int lit = max_final_literals(cap - op, n_end - anchor);
  if (lit < 0) {
    *consumed = 0;
    return 0;
  }
  *consumed = anchor - start + lit;
  return emit_final(out, op, src + anchor, lit);
}

}  // namespace lz4tt
