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
//
// One warp runs a block.  The scan is serial by definition (each probe
// writes the table slot the next probe may read, and a match moves ip to
// its end), so the warp runs it in rounds of 32 speculative probes: lane k
// probes where the serial scan would after k probes without a match, and
// takes as its candidate the position of the latest lower lane with the
// same hash slot, else the table's entry as it stood before the round,
// which is exactly what the serial scan would read there.  The lanes that
// pass the serial test are extended in lane order by the whole warp
// (backward and forward together, 32 bytes a side per ballot); the first
// whose match holds min_match ends the round, and only the probes up to it
// write the table.  Those writes, and the write after a match, are made at
// the start of the next round, while its probe loads are in flight.  The
// sequences are written 32 at a time, a lane each.  Every lane holds the
// same scan state.  A round is a chain of dependent steps (load, hash,
// table, candidate word, ballots, shuffles, extension), so the code keeps
// that chain free of branches: idle lanes load at a safe position and
// drop the result.  On the CPU, kernels/destsize_kernel.py's
// dest_size_block_rounds_plain models the rounds.
#pragma once

#include <stdint.h>

#include "emit.cuh"

namespace lz4tt {

constexpr int HASH_LOG = 14;
constexpr int HASH_SIZE = 1 << HASH_LOG;
constexpr int HASH_BYTES = HASH_SIZE * (int)sizeof(int32_t);
constexpr int SKIP_TRIGGER = 6;
constexpr uint32_t PRIME = 2654435761u;  // -1640531535 as uint32
constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// The LE32 word of bytes p..p+3 and the byte p[4], from the two aligned
// words that hold them (so the reads never leave the aligned words of
// p..p+4).
struct Word5 {
  uint32_t w, b4;
};

__device__ __forceinline__ Word5 load5(const uint8_t* p) {
  const uintptr_t a = (uintptr_t)p;
  const uint32_t* q = (const uint32_t*)(a & ~(uintptr_t)3);
  const uint32_t sh = (uint32_t)(a & 3) * 8;
  const uint32_t lo = q[0], hi = q[1];
  return {__funnelshift_r(lo, hi, sh), (hi >> sh) & 0xFFu};
}

__device__ __forceinline__ int hash_of(Word5 v) {
  const uint32_t x = (v.w ^ (v.b4 * PRIME)) * PRIME;
  return (int)(x >> (32 - HASH_LOG));
}

__device__ __forceinline__ int hash5(const uint8_t* p) {
  return hash_of(load5(p));
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

// The sum of j >> SKIP_TRIGGER over j < n.
__device__ __forceinline__ int skip_below(int n) {
  const int q = n >> SKIP_TRIGGER, r = n & ((1 << SKIP_TRIGGER) - 1);
  return ((q * (q - 1) / 2) << SKIP_TRIGGER) + q * r;
}

// How far k probes without a match move ip from the skip count scnt.
__device__ __forceinline__ int skip_sum(int scnt, int k) {
  return skip_below(scnt + k) - skip_below(scnt);
}

// -- sequences written a batch at a time -----------------------------------

constexpr int LONG_RUN = 64;  // literal runs a lane copies alone, at most

// Up to 32 sequences of one block, lane i holding the i-th: written at
// out + op, `litlen` literals from src + lit, then a match of mlc + 4 at
// `offset`.  `n` is the same in every lane.
struct SeqBatch {
  int n, op, lit, litlen, offset, mlc;
};

__device__ __forceinline__ void batch_add(SeqBatch& b, int op, int lit,
                                          int litlen, int offset, int mlc,
                                          int lane) {
  const bool mine = lane == b.n;
  b.op = mine ? op : b.op;
  b.lit = mine ? lit : b.lit;
  b.litlen = mine ? litlen : b.litlen;
  b.offset = mine ? offset : b.offset;
  b.mlc = mine ? mlc : b.mlc;
  ++b.n;
}

// Writes the batch's sequences, byte for byte as emit_seq does: each lane
// its own sequence's token, length bytes, offset and literal run (the
// warp copies runs over LONG_RUN together afterwards).  Called by the whole
// warp.
__device__ inline void batch_write(SeqBatch& b, uint8_t* out,
                                   const uint8_t* src, int lane) {
  const bool mine = lane < b.n;
  const bool long_run = mine && b.litlen > LONG_RUN;
  if (mine) {
    uint8_t* o = out + b.op;
    o[0] = token(b.litlen, b.mlc);
    const int at = b.litlen >= 15 ? emit_ext(o, 1, b.litlen - 15) : 1;
    if (!long_run) {
#pragma unroll 4
      for (int k = 0; k < b.litlen; ++k) o[at + k] = src[b.lit + k];
    }
    const int q = at + b.litlen;
    o[q] = (uint8_t)(b.offset & 0xFF);
    o[q + 1] = (uint8_t)((b.offset >> 8) & 0xFF);
    if (b.mlc >= 15) emit_ext(o, q + 2, b.mlc - 15);
  }
  for (unsigned rest = __ballot_sync(FULL_MASK, long_run); rest;
       rest &= rest - 1) {
    const int i = __ffs(rest) - 1;
    const int litlen = __shfl_sync(FULL_MASK, b.litlen, i);
    warp_copy(out + __shfl_sync(FULL_MASK, b.op, i) + 1 + ext_bytes(litlen),
              src + __shfl_sync(FULL_MASK, b.lit, i), litlen, lane);
  }
  b.n = 0;
}

// -- the parse ---------------------------------------------------------------

// The common runs at a match of p with e: backward from p - 1 and e - 1, at
// most `back_limit` (>= 0) bytes, and forward from p + 4 and e + 4, at most
// `fwd_limit` (> 0), both 32 bytes (a byte a lane) per ballot.  Called by
// the whole warp with the same arguments.  (Lanes past a limit read byte p
// and ignore it: loads without branches keep the warp's path short.)
__device__ inline void warp_runs(const uint8_t* src, int p, int e,
                                 int back_limit, int fwd_limit, int lane,
                                 int& back, int& fwd) {
  back = back_limit > 0 ? -1 : 0;
  fwd = -1;
  for (int k = 0; back < 0 || fwd < 0; k += WARP) {
    const int i = k + lane;
    const bool bi = i < back_limit, fi = i < fwd_limit;
    const bool bd = src[bi ? p - 1 - i : p] != src[bi ? e - 1 - i : p];
    const bool fd = src[fi ? p + 4 + i : p] != src[fi ? e + 4 + i : p];
    const unsigned db = __ballot_sync(FULL_MASK, back < 0 && (!bi || bd));
    const unsigned df = __ballot_sync(FULL_MASK, fwd < 0 && (!fi || fd));
    if (back < 0 && db) back = k + __ffs(db) - 1;
    if (fwd < 0 && df) fwd = k + __ffs(df) - 1;
  }
}

// Lanes 0..k (none for k < 0).
__device__ __forceinline__ unsigned lanes_to(int k) {
  return k < 0 ? 0u : FULL_MASK >> (31 - k);
}

// A round's table writes, in the serial scan's order: each committed
// lane's probe at own_p (slot own_h) unless a later committed lane of its
// slot (a bit of `later`) writes it, then the write after the round's
// match at `post` (>= 0), which replaces a probe of its slot.  Called by
// the whole parse warp.
template <class T>
__device__ __forceinline__ void flush_writes(T* table, const uint8_t* src,
                                             bool committed, unsigned later,
                                             int own_h, int own_p, int post,
                                             int lane) {
  const int post_h = post >= 0 ? hash5(src + post) : -1;
  if (committed && !((later >> lane) & 1) && own_h != post_h)
    table[own_h] = (T)own_p;
  if (post >= 0 && lane == 0) table[post_h] = (T)post;
  __syncwarp();
}

// One destSize block: source bytes [start, n_end) of `src` into at most
// `cap` bytes at `out`.  Matches reach back to `low` (backward extension
// stops above it).  `table` (shared memory) holds HASH_SIZE positions into
// `src`, empty where it holds -1 (or 65,535 in a uint16_t table, which
// then serves sources of at most 65,536 bytes); entries from earlier calls
// stay valid candidates.  The scan starts at `first` (`start`, or one past
// it for a source with no history).  Returns the bytes written and sets
// *consumed; both are 0 when not even one literal fits.  Run by all 32
// lanes of one warp, which get the same results.
//
// The block is a valid parse of the bytes it covers, so it is never longer
// than compress_bound(n_end - start), whatever `cap` says: `out` must hold
// that much.
template <class T>
__device__ inline int dest_size_block(const uint8_t* src, int start,
                                      int n_end, int low, int first, int cap,
                                      T* table, int acceleration,
                                      int min_match, uint8_t* out,
                                      int* consumed) {
  const int lane = threadIdx.x & (WARP - 1);
  const unsigned below = (1u << lane) - 1;
  const int mflimit = n_end - 12, matchlimit = n_end - 5;
  const int accel0 = acceleration << SKIP_TRIGGER;
  int op = 0, anchor = start, scnt = accel0, ip = first;
  SeqBatch batch{0, 0, 0, 0, 0, 0};
  // the table writes of the last round (if `pending`), not made yet: see
  // flush_writes
  bool pending = false, committed = false;
  unsigned later = 0;
  int own_h = 0, own_p = 0, post = -1;
  if (n_end - start >= 13) {
    while (ip <= mflimit) {
      // lane k probes where the serial scan would after k misses
      const int p = ip + skip_sum(scnt, lane);
      const bool active = p <= mflimit;
      // (an idle lane loads at ip, and takes no slot)
      const Word5 w = load5(src + (active ? p : ip));
      if (pending) {  // the last round's writes, in serial order
        flush_writes(table, src, committed, later, own_h, own_p, post,
                     lane);
        post = -1;
      }
      const int h = active ? hash_of(w) : HASH_SIZE + lane;
      const int et = active ? (int)table[h & (HASH_SIZE - 1)] : -1;
      // a capacity-stopped block may have left entries at or past ip
      const bool table_ok = active && et >= low && et < p && p - et <= 65535;
      const bool table_hit =
          table_ok && load5(src + (table_ok ? et : p)).w == w.w;
      // a lower lane with the same slot wrote it after the table was read:
      // the latest such lane's position is the candidate (4 masks, for
      // independent chains of shuffles)
      unsigned same[4] = {0, 0, 0, 0};
#pragma unroll
      for (int d = 1; d < WARP; ++d)
        if (__shfl_up_sync(FULL_MASK, h, d) == h) same[d & 3] |= 1u << d;
      const unsigned lower =
          (same[0] | same[1] | same[2] | same[3]) & (below << 1);
      const bool in_round = lower != 0;
      const int from = in_round ? lane - (__ffs(lower) - 1) : lane;
      const int pj = __shfl_sync(FULL_MASK, p, from);
      const uint32_t vj = __shfl_sync(FULL_MASK, w.w, from);
      const int e = in_round ? pj : et;
      const bool hit = in_round ? p - pj <= 65535 && vj == w.w : table_hit;
      int m = -1, mp = 0, ml = 0, offset = 0;
      for (unsigned pass = __ballot_sync(FULL_MASK, hit); pass;
           pass &= pass - 1) {
        const int k = __ffs(pass) - 1;
        const int pk = __shfl_sync(FULL_MASK, p, k);
        const int ek = __shfl_sync(FULL_MASK, e, k);
        int back, fwd;
        warp_runs(src, pk, ek, min(pk - anchor, ek - low),
                  matchlimit - pk - 4, lane, back, fwd);
        if (4 + back + fwd >= min_match) {
          // (min_match > 4): a shorter match is a skip, not a stop
          m = k;
          mp = pk - back;
          ml = 4 + back + fwd;
          offset = pk - ek;
          break;
        }
      }
      const unsigned lanes = __ballot_sync(FULL_MASK, active);
      // the probes up to the match (all, without one) write the table; of
      // lanes sharing a slot the highest writes last
      committed = ((m < 0 ? lanes : lanes & lanes_to(m)) >> lane) & 1;
      later = __reduce_or_sync(FULL_MASK,
                               committed && in_round ? 1u << from : 0u);
      pending = true;
      own_h = h;
      own_p = p;
      if (m < 0) {
        const int n = __popc(lanes);
        ip += skip_sum(scnt, n);
        scnt += n;
        continue;
      }
      const int litlen = mp - anchor;
      const int need = seq_size(litlen, ml - 4) +
                       final_run_size(min(5, n_end - (mp + ml)));
      if (op + need > cap) break;  // capacity stop
      batch_add(batch, op, anchor, litlen, offset, ml - 4, lane);
      if (batch.n == WARP) batch_write(batch, out, src, lane);
      op += seq_size(litlen, ml - 4);
      ip = anchor = mp + ml;
      post = ip - 2;
      scnt = accel0;
    }
  }
  if (pending)
    flush_writes(table, src, committed, later, own_h, own_p, post, lane);
  batch_write(batch, out, src, lane);
  const int lit = max_final_literals(cap - op, n_end - anchor);
  if (lit < 0) {
    *consumed = 0;
    return 0;
  }
  warp_emit_final(out, op, src + anchor, lit, lane);
  *consumed = anchor - start + lit;
  return op + final_run_size(lit);
}

}  // namespace lz4tt
