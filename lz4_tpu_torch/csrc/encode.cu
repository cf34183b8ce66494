// Greedy LZ4 scan over a precomputed candidate table: kernels A and B.
//
// Replaces the Pallas kernels of lz4_tpu/kernels/encode_kernel.py:
//   A  _make_encode_linked_kernel (launched by _encode_blocks_linked):
//      linked 64 KB blocks, each matching into its predecessor or a prefix;
//      its dynamic_mm variant too (a min_match per block, `mm_rows`);
//   B  _make_encode_kernel (launched by _encode_blocks): independent rows.
// The parse is the same decision for decision, so payloads are
// bit-identical to the JAX package's.
//
// What bounds it on the card: the parse is a serial chain of decisions (a
// probe's outcome sets the next position), so one block runs at the latency
// of that chain, not at any bandwidth.  The design moves the byte work onto
// every thread of the card and splits the chain of decisions itself, in
// three launches:
//   1. probe: a thread per position.  A candidate's forward end runs from
//      p + 4 to the first mismatch, capped at matchlimit, and so does not
//      depend on the walk; its backward run depends on it only through the
//      clamp mp >= anchor.  Both runs are measured here, 8 bytes a compare,
//      up to FWD_CAP and BACK_CAP bytes (a run of zeros would otherwise cost
//      its length at every position), and packed with the delta into one
//      word per position.
//   2. walk: 128 threads per block.  After a match the scan's whole state
//      is its end, so each thread walks the decisions (skip counter, reject
//      step, jump tables, block edges) over the words of its 1/128 of the
//      block from a fresh state, and the walks are joined where one takes a
//      match ending where the next also ends one; on text they join within
//      a few matches.  From where no walk joins, one warp walks until it
//      takes a match that a later walk also took, capped runs finished 512
//      bytes a round.  It records (mp, end, d, op) per sequence, op being
//      the sequence's output offset.
//   3. emit: a warp per sequence writes it at its offset through emit.cuh,
//      literals copied by all 32 lanes.
// Each launch reads only what the one before wrote; the wrapper allocates
// the words and records.
#include <cuda_runtime.h>
#include <stdint.h>

#include "emit.cuh"

namespace {

constexpr int WINDOW = 65536;
constexpr int SKIP_TRIGGER = 6;
constexpr int FWD_CAP = 127;           // 7 bits of the probe word
constexpr int BACK_CAP = 63;           // 6 bits
constexpr uint32_t PROBE_VALID = 1u << 31;
constexpr int STAGE = 4096;            // positions of words in shared memory
constexpr int WALK_WARPS = 4;          // warps of a block's walk
constexpr int WALKERS = 32 * WALK_WARPS;  // speculative walks per block
constexpr int HEADS = 8;               // first match ends a walker publishes
constexpr int OVERLAP = 512;           // bytes a lane walks past its segment
constexpr int LANE_RUN = 128;          // bytes a lane follows a capped run
constexpr int EMIT_CTAS = 8;           // CTAs of 8 warps per block in phase 3
constexpr unsigned FULL = 0xFFFFFFFFu;

// A block: positions index `buf`; the block is [start, start + n), matches
// reach back to `low`, and the scan starts at `ip`.
struct Block {
  const uint8_t* buf;
  int start, n, low, ip;
};

// Kernel A's block `row` = (stream s, block k): row s of `stream` is
// [64 KB window | blocks], block k at byte (k + 1) * WINDOW.
__device__ __forceinline__ Block linked_block(const uint8_t* stream,
                                              long long L,
                                              const int32_t* slen,
                                              const int32_t* prefix, int NB,
                                              int row) {
  const int s = row / NB, k = row % NB;
  const int start = (k + 1) * WINDOW;
  const int pre = k == 0 ? min(max(prefix[s], 0), WINDOW) : WINDOW;
  return {stream + (long long)s * L, start, min(max(slen[row], 0), WINDOW),
          start - pre, start + (pre > 0 ? 0 : 1)};
}

// Kernel B's independent row.
__device__ __forceinline__ Block row_block(const uint8_t* src, int NS,
                                           const int32_t* slen, int row) {
  return {src + (long long)row * NS, 0, min(max(slen[row], 0), NS), 0, 1};
}

// The 8 bytes at p (little-endian) from aligned loads, so p may have any
// alignment; every byte loaded lies in an 8-byte word holding a byte of
// [p, p + 8).
__device__ __forceinline__ uint64_t load8(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned long long* w =
      reinterpret_cast<const unsigned long long*>(a & ~uintptr_t(7));
  const int s = (int)(a & 7) * 8;
  const uint64_t lo = __ldg(w);
  return s ? (lo >> s) | ((uint64_t)__ldg(w + 1) << (64 - s)) : lo;
}

// Count of k < room with buf[x + j] == buf[y + j] for every j <= k.
__device__ __forceinline__ int forward_run(const uint8_t* buf, int x, int y,
                                           int room) {
  int k = 0;
  for (; k + 8 <= room; k += 8) {
    const uint64_t diff = load8(buf + x + k) ^ load8(buf + y + k);
    if (diff) return k + (__ffsll((long long)diff) - 1) / 8;
  }
  while (k < room && buf[x + k] == buf[y + k]) ++k;
  return k;
}

// Count of k < room with buf[x - j] == buf[y - j] for every j <= k.
__device__ __forceinline__ int backward_run(const uint8_t* buf, int x, int y,
                                            int room) {
  int k = 0;
  for (; k + 8 <= room; k += 8) {
    const uint64_t diff = load8(buf + x - k - 7) ^ load8(buf + y - k - 7);
    if (diff) return k + __clzll((long long)diff) / 8;
  }
  while (k < room && buf[x - k] == buf[y - k]) ++k;
  return k;
}

// Phase 1: the probe word of position j of a block (kernel A's words row is
// `ns` wide, B's `ns` rounded up to 4).  For a probe the scan can take
// (d > 0, q = p - d >= low, p <= mflimit):
//   PROBE_VALID | d << 13 | fwd << 6 | back,
// d < 2^18 (a valid q lies at most 64 KB before the block, or in B's row),
// fwd the equal bytes from p + 4 up to min(FWD_CAP, matchlimit - p - 4),
// back the equal bytes before p up to min(BACK_CAP, p - start, q - low).
// Other positions hold B's jump, clamped to [0, 2^30] (the walk's
// max(step, jump) is the same), and 0 in A.
__device__ __forceinline__ int32_t probe_word(const Block& b, int j, int d,
                                              int32_t other) {
  const int p = b.start + j, q = p - d;
  if (d <= 0 || q < b.low || j > b.n - 12) return other;
  const int fwd = forward_run(b.buf, p + 4, q + 4, min(FWD_CAP, b.n - 9 - j));
  const int back = backward_run(b.buf, p - 1, q - 1,
                                min(min(BACK_CAP, j), q - b.low));
  return (int32_t)(PROBE_VALID | (uint32_t)d << 13 | fwd << 6 | back);
}

// Every launch below covers the rows [row0, row0 + gridDim.x) of a group;
// the scratch (words, lrec, rec, nrec) holds that group's rows only.
__global__ void probe_linked_kernel(const uint8_t* stream, long long L,
                                    const int32_t* delta,
                                    const int32_t* slen,
                                    const int32_t* prefix, int NB, int row0,
                                    int32_t* words) {
  const int row = row0 + blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const Block b = linked_block(stream, L, slen, prefix, NB, row);
  words[(long long)blockIdx.x * WINDOW + j] =
      probe_word(b, j, delta[(long long)row * WINDOW + j], 0);
}

__global__ void probe_rows_kernel(const uint8_t* src, int NS,
                                  const int32_t* delta, const int32_t* jump,
                                  const int32_t* slen, int row0,
                                  int32_t* words, int stride) {
  const int row = row0 + blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= NS) return;
  const Block b = row_block(src, NS, slen, row);
  const long long at = (long long)row * NS + j;
  words[(long long)blockIdx.x * stride + j] =
      probe_word(b, j, delta[at], min(max(jump[at], 0), 1 << 30));
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// The first x in [x, limit) with buf[x] != buf[x - d], or limit: each lane
// compares 16 bytes of a 512-byte round.
__device__ int warp_forward_end(const uint8_t* buf, int x, int d, int limit,
                                int lane) {
  for (; x < limit; x += 512) {
    const int y = x + 16 * lane;
    int hit = limit;
    if (y + 16 <= limit) {
      const uint64_t d0 = load8(buf + y) ^ load8(buf + y - d);
      const uint64_t d1 = load8(buf + y + 8) ^ load8(buf + y + 8 - d);
      if (d0)
        hit = y + (__ffsll((long long)d0) - 1) / 8;
      else if (d1)
        hit = y + 8 + (__ffsll((long long)d1) - 1) / 8;
    } else {
      for (int t = y; t < limit; ++t)
        if (buf[t] != buf[t - d]) {
          hit = t;
          break;
        }
    }
    const unsigned m = __ballot_sync(FULL, hit < limit);
    if (m) return __shfl_sync(FULL, hit, __ffs(m) - 1);
  }
  return limit;
}

// The backward extension from mp: the smallest m <= mp such that every
// t in [m, mp) has t >= lo and buf[t] == buf[t - d].
__device__ int warp_backward_start(const uint8_t* buf, int mp, int d, int lo,
                                   int lane) {
  if (mp <= lo) return mp;
  for (int top = mp - 1;; top -= 512) {
    const int t0 = top - 16 * lane;    // this lane: [t0 - 15, t0]
    int hit = -1;
    if (t0 - 15 >= lo) {
      const uint64_t d1 = load8(buf + t0 - 7) ^ load8(buf + t0 - 7 - d);
      const uint64_t d0 = load8(buf + t0 - 15) ^ load8(buf + t0 - 15 - d);
      if (d1)
        hit = t0 - __clzll((long long)d1) / 8;
      else if (d0)
        hit = t0 - 8 - __clzll((long long)d0) / 8;
    } else {
      for (int t = t0; t >= lo; --t)
        if (buf[t] != buf[t - d]) {
          hit = t;
          break;
        }
    }
    const unsigned m = __ballot_sync(FULL, hit >= 0);
    if (m) return __shfl_sync(FULL, hit, __ffs(m) - 1) + 1;
    if (top - 512 < lo) return lo;
  }
}

// One block's limits, as the walk reads them.
struct Scan {
  const uint8_t* buf;
  int start, low, mflimit, matchlimit, ns, accel0, min_match, reject_step;
};

enum Outcome { NONE, TAKE, OPEN };

// One decision of the scan at ip, the JAX package's decision for decision:
// TAKE when it takes the match [mp, end) at distance d.  ip, anchor and
// scnt move as the scan's do.  word(j) reads the probe word of position j,
// jump(g) kernel A's 4-granular jump table (g < ns / 4: the block-relative
// next candidate at or after lane 4g); B's full-resolution jump is in the
// words.  forward_end and backward_start finish a capped run.  With OPEN
// allowed, a capped forward run is followed LANE_RUN bytes further only;
// if it is still equal there and the match is taken whatever its end,
// decide returns OPEN: the match is [mp, end...) with its run going on
// from end, and ip, anchor and scnt wait for that end.
template <bool LINKED, class Word, class Jump, class Fwd, class Bwd>
__device__ __forceinline__ Outcome decide(const Scan& s, int& ip,
                                          int& anchor, int& scnt, int& mp,
                                          int& end, int& d, bool can_open,
                                          Word word, Jump jump,
                                          Fwd forward_end,
                                          Bwd backward_start) {
  const int32_t w = word(ip - s.start);
  if (w < 0) {                         // PROBE_VALID
    d = (w >> 13) & 0x3FFFF;
    const int back = w & 63, fwd = (w >> 6) & 127;
    mp = max(ip - back, anchor);
    if (back == BACK_CAP && mp > anchor)
      mp = backward_start(mp, d, max(anchor, s.low + d));
    end = ip + 4 + fwd;
    if (fwd == FWD_CAP && end < s.matchlimit) {
      const int lim = can_open ? min(s.matchlimit, end + LANE_RUN)
                               : s.matchlimit;
      end = forward_end(end, d, lim);
      if (end == lim && lim < s.matchlimit) {
        if (end - mp >= s.min_match) return OPEN;
        end = forward_end(end, d, s.matchlimit);
      }
    }
    if (end - mp >= s.min_match) {
      ip = anchor = end;
      scnt = s.accel0;
      return TAKE;
    }
    ip += max(scnt >> SKIP_TRIGGER, s.reject_step);
  } else if (LINKED) {
    int ip2 = ip + (scnt >> SKIP_TRIGGER);
    if (ip2 - s.start < s.ns)
      ip2 = max(ip2, s.start + jump(min((ip2 - s.start) >> 2, s.ns / 4 - 1)));
    ip = ip2;
  } else {
    ip += max(scnt >> SKIP_TRIGGER, w);
  }
  ++scnt;
  return NONE;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// A capped backward run finished by one lane.
__device__ int lane_backward_start(const uint8_t* buf, int mp, int d,
                                   int lo) {
  return mp - backward_run(buf, mp - 1, mp - 1 - d, mp - lo);
}

// Phase 2: the scan's decisions for one block, in two steps.
//
// Speculation: lane k walks its 1/WALKERS of the block from a fresh state
// (ip = anchor = its segment start, scnt = accel0; lane 0 from the block's
// true start) until OVERLAP bytes past its segment, recording its matches.
// After a match ending at e the scan's whole state is (e, e, accel0), so a
// walk that takes a match ending where the next lane's walk also ends one
// (or where that lane started) continues exactly as that lane's walk did.
// The true parse is lane 0's matches up to the first end it shares with
// lane 1, then lane 1's after it, and so on: on text the walks meet within
// a few matches past a segment boundary.  Where a lane's walk meets the
// next lane's nowhere after the end the parse came in by, that lane hands
// its final state to the serial walk.
//
// Serial walk: every lane of warp 0 runs the same decisions from that state
// (lane 0 stores), over probe words staged in shared memory STAGE
// positions at a time, capped runs finished by the whole warp, until it
// takes a match that a later walker also took (or ends where one started):
// the parse then follows the walkers again, and so on to the block's end.
//
// min_match is the block's own (kernel A's adaptive mode gives each block
// one, `mm_rows`): every walk and every join lies inside one block, so the
// joins only ever compare decisions taken at that one min_match.
//
// Writes the block's records (mp, end, d, op), op being the sequence's
// output offset, then the final literal run, their count and the block's
// output length, and, when `tail` is set, the offset of the final literal
// run's token.  `lrec` holds each lane's matches ([lcap][WALKERS] per block)
// as (mp, end, d, bytes of the lane's sequences through this one).
template <bool LINKED>
__device__ void walk(const Block& b, const int32_t* words, const int32_t* jump,
                     int ns, int acceleration, int min_match,
                     int reject_step, int4* lrec, int4* rec,
                     int32_t* nrec, int32_t* olen, int32_t* tail) {
  __shared__ __align__(16) int32_t sw[STAGE];
  __shared__ int32_t sj[LINKED ? STAGE / 4 : 1];
  __shared__ int count_of[WALKERS], sync_at[WALKERS], sync_next[WALKERS];
  __shared__ int3 state_of[WALKERS];
  __shared__ int open_x[WALKERS], open_d[WALKERS], open_end[WALKERS];
  __shared__ int first_x[WALKERS], first_d[WALKERS], first_end[WALKERS];
  __shared__ volatile int heads[WALKERS][HEADS];
  __shared__ volatile int nheads[WALKERS];
  __shared__ int warp_op[WALK_WARPS], warp_n[WALK_WARPS];
  const int lane = threadIdx.x, wl = lane & 31, warp = lane >> 5;
  const int start = b.start, n_end = b.start + b.n;
  const Scan s = {b.buf, start, b.low, n_end - 12, n_end - 5, ns,
                  acceleration << SKIP_TRIGGER, min_match, reject_step};
  auto lane_rec = [&](int k, int i) -> int4& {
    return lrec[(long long)i * WALKERS + k];
  };
  auto end_of = [&](int k, int i) { return lane_rec(k, i).y; };

  // -- speculation --------------------------------------------------------
  const int seg = max((b.n + WALKERS - 1) / WALKERS, 1);
  const int s_k = start + lane * seg, s_next = s_k + seg;
  const int stop = lane == WALKERS - 1 ? s.mflimit : s_next + OVERLAP - 1;
  int ip = lane ? s_k : b.ip, anchor = s_k, scnt = s.accel0;
  int count = 0, first_tail = -1, bytes = 0, fx = -1, fd = 0;
  bool met = false;
  nheads[lane] = 0;
  __syncthreads();
  // a walker's match: recorded and published; a walker stops at a match
  // that ends where the next walker started or at one of the first ends the
  // next walker has published so far.  That stop is a hint that depends on
  // timing (the next walker is still walking); the joins below read only
  // the final records, so the parse does not depend on it.
  auto take = [&](int mp, int end, int d, int anc) {
    bytes += lz4tt::seq_size(mp - anc, end - mp - 4);
    lane_rec(lane, count) = make_int4(mp, end, d, bytes);
    if (count < HEADS) {
      heads[lane][count] = end;
      __threadfence_block();
      nheads[lane] = count + 1;
    }
    if (end >= s_next && lane < WALKERS - 1) {
      if (first_tail < 0) first_tail = count;
      met = end == s_next;
      const int nh = nheads[lane + 1];
      __threadfence_block();           // heads[.][h < nh] were written first
      for (int h = 0; h < nh && !met; ++h) met = heads[lane + 1][h] == end;
    }
    if (count == 0) first_end[lane] = end;
    ++count;
  };
  // Walks until every walker is done, a walker parking at a capped forward
  // run (OPEN).  Warp 0 then finishes the parked runs from the last walker
  // to the first: a run at distance d from x goes on as walker k + 1's
  // first match does if that match has distance d too and its own run
  // starts at some x' >= x, so only [x, x') is compared, and that match's
  // end taken when all of it is equal (its run covers [x', end) already).
  for (;;) {
    int mp = 0, end = 0, d = 0;
    bool open = false;
    while (b.n >= 13 && ip <= s.mflimit && ip <= stop && !met) {
      const int ip0 = ip, anchor0 = anchor;
      prefetch_l1(words + min(ip - start + 32, ns - 1));
      const Outcome o = decide<LINKED>(
          s, ip, anchor, scnt, mp, end, d, true,
          [&](int j) { return __ldg(words + j); },
          [&](int g) { return __ldg(jump + g); },
          [&](int x, int dd, int lim) {
            return x + forward_run(b.buf, x, x - dd, lim - x);
          },
          [&](int m, int dd, int lo) {
            return lane_backward_start(b.buf, m, dd, lo);
          });
      if (o == NONE) continue;
      if (fx < 0) {
        fx = ip0 + 4;
        fd = d;
      }
      if (o == OPEN) {
        open = true;
        break;
      }
      take(mp, end, d, anchor0);
    }
    first_x[lane] = fx;
    first_d[lane] = fd;
    open_x[lane] = open ? end : -1;
    open_d[lane] = d;
    count_of[lane] = count;
    if (!__syncthreads_or(open)) break;
    if (warp == 0)
      for (int k = WALKERS - 1; k >= 0; --k) {
        const int x = open_x[k];
        if (x < 0) continue;
        const int dk = open_d[k];
        const bool follow = k < WALKERS - 1 && first_x[k + 1] >= x &&
                            first_d[k + 1] == dk;
        const int lim = follow ? first_x[k + 1] : s.matchlimit;
        int e = warp_forward_end(b.buf, x, dk, lim, wl);
        if (follow && e == lim) e = first_end[k + 1];
        if (wl == 0) {
          open_end[k] = e;
          if (count_of[k] == 0) first_end[k] = e;
        }
        __syncwarp();
      }
    __syncthreads();
    if (open) {
      end = open_end[lane];
      take(mp, end, d, anchor);
      ip = anchor = end;
      scnt = s.accel0;
    }
  }
  state_of[lane] = make_int3(ip, anchor, scnt);
  __syncthreads();
  // the first of my matches whose end is walker + 1's start or one of its
  // match ends; walker + 1's walk goes on from the match after that end
  int at = -1, next = 0;
  if (lane < WALKERS - 1 && first_tail >= 0) {
    const int nh = count_of[lane + 1];
    for (int t = first_tail, h = 0; t < count; ++t) {
      const int e = end_of(lane, t);
      if (e == s_next) {
        at = t;
        break;
      }
      while (h < nh && end_of(lane + 1, h) < e) ++h;
      if (h == nh) break;
      if (end_of(lane + 1, h) == e) {
        at = t;
        next = h + 1;
        break;
      }
    }
  }
  sync_at[lane] = at;
  sync_next[lane] = next;
  __syncthreads();
  // my slice [lo, hi) of the parse; `last` is the walker the serial walk
  // goes on from
  int lo = 0, hi = 0, last = 0;
  for (int k = 0, idx = 0;; ++k) {
    const int j = sync_at[k];          // j == idx - 1: the end we came in by
    const bool meets = j >= 0 && j >= idx - 1;
    if (k == lane) {
      lo = idx;
      hi = meets ? j + 1 : count_of[k];
    }
    if (!meets) {
      last = k;
      break;
    }
    idx = sync_next[k];
  }
  if (lane > last) lo = hi = 0;
  // my slice's bytes and count, summed over the walkers before me; the
  // bytes come from the walker's running sums (a slice starts after a match
  // end, so its first sequence's literals start there in the parse too)
  const int before = lo > 0 ? lane_rec(lane, lo - 1).w : 0;
  const int mine = hi > lo ? lane_rec(lane, hi - 1).w - before : 0;
  int op = mine, nseq = hi - lo;       // inclusive scans over the walkers
  for (int o = 1; o < 32; o <<= 1) {
    const int po = __shfl_up_sync(FULL, op, o);
    const int pn = __shfl_up_sync(FULL, nseq, o);
    if (wl >= o) {
      op += po;
      nseq += pn;
    }
  }
  if (wl == 31) {
    warp_op[warp] = op;
    warp_n[warp] = nseq;
  }
  __syncthreads();
  int total_op = 0, total_n = 0;
  for (int w = 0; w < WALK_WARPS; ++w) {
    if (w < warp) {
      op += warp_op[w];
      nseq += warp_n[w];
    }
    total_op += warp_op[w];
    total_n += warp_n[w];
  }
  const int base_op = op - mine - before, base_n = nseq - (hi - lo) - lo;
  for (int i = lo; i < hi; i += 4) {
    int4 r[4];
    int w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u < hi) {
        r[u] = lane_rec(lane, i + u);
        w[u] = i + u > 0 ? lane_rec(lane, i + u - 1).w : 0;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u < hi)
        rec[base_n + i + u] = make_int4(r[u].x, r[u].y, r[u].z, base_op + w[u]);
  }
  if (warp > 0) return;
  op = total_op;
  nseq = total_n;

  // -- the serial walk from walker `last`'s state, by warp 0 --------------
  const int3 st = state_of[last];
  ip = st.x;
  anchor = st.y;
  scnt = st.z;
  int wbeg = 0, wend = 0;              // staged words [wbeg, wend)
  auto staged_word = [&](int j) {
    if (j >= wend) {                   // ip only grows: stage from j on
      __syncwarp();                    // every lane is done with the last
      wbeg = j & ~3;
      wend = min(wbeg + STAGE, ns);
      for (int i = 4 * wl; i < wend - wbeg; i += 128)
        cp_async(sw + i, words + wbeg + i, 16);
      if (LINKED)
        for (int i = wl; i < (wend - wbeg) / 4; i += 32)
          cp_async(sj + i, jump + wbeg / 4 + i, 4);
      cp_async_wait();
    }
    return sw[j - wbeg];
  };
  auto staged_jump = [&](int g) {
    const int gs = g - wbeg / 4;
    return gs < (wend - wbeg) / 4 ? sj[gs] : __ldg(jump + g);
  };
  // the first walker after `last` that may share a later match end, and
  // how far its ends have been passed (the serial walk's ends only grow)
  int rj = last + 1, rh = 0;
  while (b.n >= 13 && ip <= s.mflimit) {
    const int anchor0 = anchor;
    int mp, end, d;
    if (decide<LINKED>(
            s, ip, anchor, scnt, mp, end, d, false, staged_word, staged_jump,
            [&](int x, int dd, int lim) {
              return warp_forward_end(b.buf, x, dd, lim, wl);
            },
            [&](int m, int dd, int lo2) {
              return warp_backward_start(b.buf, m, dd, lo2, wl);
            }) != TAKE)
      continue;
    if (wl == 0) rec[nseq] = make_int4(mp, end, d, op);
    ++nseq;
    op += lz4tt::seq_size(mp - anchor0, end - mp - 4);
    // A walker that starts at `end`, or took a match ending there, holds
    // the parse from there on: follow the walkers again as above.
    int j = -1, idx = 0;
    while (rj < WALKERS) {
      const int s_j = start + rj * seg;
      if (end <= s_j) {
        if (end == s_j) j = rj;
        break;
      }
      const int cnt = count_of[rj];
      while (rh < cnt && end_of(rj, rh) < end) ++rh;
      if (rh < cnt) {
        if (end_of(rj, rh) == end) {
          j = rj;
          idx = rh + 1;
        }
        break;
      }
      ++rj;
      rh = 0;
    }
    if (j < 0) continue;
    for (;; ++j) {
      const int at = sync_at[j];
      const bool meets = at >= 0 && at >= idx - 1;
      const int hi = meets ? at + 1 : count_of[j];
      const int base = idx > 0 ? lane_rec(j, idx - 1).w : 0;
      for (int i = idx + wl; i < hi; i += 32) {
        const int4 r = lane_rec(j, i);
        const int w = i > 0 ? lane_rec(j, i - 1).w : 0;
        rec[nseq + i - idx] = make_int4(r.x, r.y, r.z, op + w - base);
      }
      if (hi > idx) {
        op += lane_rec(j, hi - 1).w - base;
        nseq += hi - idx;
      }
      if (!meets) break;
      idx = sync_next[j];
    }
    const int3 nst = state_of[j];
    ip = nst.x;
    anchor = nst.y;
    scnt = nst.z;
    rj = j + 1;
    rh = 0;
  }
  if (wl == 0) {
    rec[nseq] = make_int4(n_end, n_end, 0, op);
    *nrec = nseq + 1;
    *olen = op + lz4tt::final_run_size(n_end - anchor);
    if (tail) *tail = op;
  }
}

__global__ void walk_linked_kernel(const uint8_t* stream, long long L,
                                   const int32_t* words, const int32_t* jump,
                                   const int32_t* slen, const int32_t* prefix,
                                   int NB, int row0, int acceleration,
                                   int min_match, const int32_t* mm_rows,
                                   int reject_step,
                                   int4* lrec, int lcap, int4* rec,
                                   int rec_cap, int32_t* nrec,
                                   int32_t* olen, int32_t* tails) {
  const int g = blockIdx.x, row = row0 + g;
  const Block b = linked_block(stream, L, slen, prefix, NB, row);
  if (b.n == 0) {                      // a padding row: no block at all
    if (threadIdx.x == 0) {
      nrec[g] = olen[row] = 0;
      if (tails) tails[row] = 0;
    }
    return;
  }
  walk<true>(b, words + (long long)g * WINDOW,
             jump + (long long)row * (WINDOW / 4), WINDOW, acceleration,
             mm_rows ? mm_rows[row] : min_match, reject_step, lrec + (long long)g * lcap * WALKERS,
             rec + (long long)g * rec_cap, nrec + g, olen + row,
             tails ? tails + row : nullptr);
}

__global__ void walk_rows_kernel(const uint8_t* src, int NS,
                                 const int32_t* words, int stride,
                                 const int32_t* slen, int row0,
                                 int acceleration, int min_match,
                                 int reject_step, int4* lrec, int lcap,
                                 int4* rec, int rec_cap, int32_t* nrec,
                                 int32_t* olen) {
  const int g = blockIdx.x, row = row0 + g;
  walk<false>(row_block(src, NS, slen, row), words + (long long)g * stride,
              nullptr, stride, acceleration, min_match, reject_step,
              lrec + (long long)g * lcap * WALKERS,
              rec + (long long)g * rec_cap, nrec + g, olen + row, nullptr);
}

// Phase 3: a warp per record; record i's literals start at record i-1's
// end (the block's start for the first), the last record is the final
// literal run.
__device__ void emit(const Block& b, const int4* rec, int nr, uint8_t* out) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x / 32;
  for (int i = blockIdx.y * warps + threadIdx.x / 32; i < nr;
       i += gridDim.y * warps) {
    const int4 r = rec[i];
    const int anchor = i ? rec[i - 1].y : b.start;
    if (i == nr - 1)
      lz4tt::warp_emit_final(out, r.w, b.buf + anchor, r.x - anchor, lane);
    else
      lz4tt::warp_emit_seq(out, r.w, b.buf + anchor, r.x - anchor, r.z,
                           r.y - r.x - 4, lane);
  }
}

__global__ void emit_linked_kernel(const uint8_t* stream, long long L,
                                   const int32_t* slen, const int32_t* prefix,
                                   int NB, int row0, const int4* rec,
                                   int rec_cap, const int32_t* nrec,
                                   uint8_t* out, int M) {
  const int g = blockIdx.x, row = row0 + g;
  emit(linked_block(stream, L, slen, prefix, NB, row),
       rec + (long long)g * rec_cap, nrec[g], out + (long long)row * M);
}

__global__ void emit_rows_kernel(const uint8_t* src, int NS,
                                 const int32_t* slen, int row0,
                                 const int4* rec, int rec_cap,
                                 const int32_t* nrec, uint8_t* out, int M) {
  const int g = blockIdx.x, row = row0 + g;
  emit(row_block(src, NS, slen, row), rec + (long long)g * rec_cap, nrec[g],
       out + (long long)row * M);
}

}  // namespace

// Kernel A over S streams of NB blocks, `group` rows (blocks) at a time.
// Scratch from the caller, for one group: words [group, 65536] int32; lrec
// [group, lcap, 128] int4 with lcap >= (65536 / 128 + OVERLAP) / 4 + 2;
// rec [group, rec_cap] int4 with rec_cap >= 16385; nrec [group] int32.
// `tails` ([S * NB] int32, or null) takes each block's offset of its final
// literal run's token.  `mm_rows` ([S * NB] int32, or null for `min_match`
// everywhere) gives each block its own min_match (adaptive mode); only the
// walk reads it, the probe words and the emission do not depend on it.
extern "C" int lz4tt_encode_linked(const uint8_t* stream, long long L,
                                   const int32_t* delta, const int32_t* jump,
                                   const int32_t* slen, const int32_t* prefix,
                                   int32_t* words, int32_t* lrec, int lcap,
                                   int32_t* rec, int rec_cap,
                                   int32_t* nrec, int group, uint8_t* out,
                                   int M, int32_t* olen, int32_t* tails,
                                   int S, int NB, int acceleration,
                                   int min_match, const int32_t* mm_rows,
                                   int reject_step, void* cuda_stream) {
  const int rows = S * NB;
  cudaStream_t cs = (cudaStream_t)cuda_stream;
  int4* r4 = reinterpret_cast<int4*>(rec);
  int4* l4 = reinterpret_cast<int4*>(lrec);
  for (int row0 = 0; row0 < rows; row0 += group) {
    const int g = min(group, rows - row0);
    probe_linked_kernel<<<dim3(g, WINDOW / 256), 256, 0, cs>>>(
        stream, L, delta, slen, prefix, NB, row0, words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    walk_linked_kernel<<<g, WALKERS, 0, cs>>>(
        stream, L, words, jump, slen, prefix, NB, row0, acceleration,
        min_match, mm_rows, reject_step, l4, lcap, r4, rec_cap, nrec, olen,
        tails);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    emit_linked_kernel<<<dim3(g, EMIT_CTAS), 256, 0, cs>>>(
        stream, L, slen, prefix, NB, row0, r4, rec_cap, nrec, out, M);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Kernel B over B rows of NS bytes, `group` rows at a time.  Scratch from
// the caller, for one group: words [group, stride] int32 with stride = NS
// rounded up to 4; lrec [group, lcap, 128] int4 with lcap >=
// (ceil(NS / 128) + OVERLAP) / 4 + 2; rec [group, rec_cap] int4 with
// rec_cap >= NS / 4 + 1; nrec [group] int32.
extern "C" int lz4tt_encode(const uint8_t* src, int NS, const int32_t* delta,
                            const int32_t* jump, const int32_t* slen,
                            int32_t* words, int stride, int32_t* lrec,
                            int lcap, int32_t* rec, int rec_cap,
                            int32_t* nrec, int group, uint8_t* out, int M,
                            int32_t* olen, int B, int acceleration,
                            int min_match, int reject_step,
                            void* cuda_stream) {
  cudaStream_t cs = (cudaStream_t)cuda_stream;
  int4* r4 = reinterpret_cast<int4*>(rec);
  int4* l4 = reinterpret_cast<int4*>(lrec);
  for (int row0 = 0; row0 < B; row0 += group) {
    const int g = min(group, B - row0);
    probe_rows_kernel<<<dim3(g, (NS + 255) / 256), 256, 0, cs>>>(
        src, NS, delta, jump, slen, row0, words, stride);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    walk_rows_kernel<<<g, WALKERS, 0, cs>>>(
        src, NS, words, stride, slen, row0, acceleration, min_match,
        reject_step, l4, lcap, r4, rec_cap, nrec, olen);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    emit_rows_kernel<<<dim3(g, EMIT_CTAS), 256, 0, cs>>>(
        src, NS, slen, row0, r4, rec_cap, nrec, out, M);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
