// High-compression (HC) block encoder: kernel I.
//
// Replaces the Pallas kernel of lz4_tpu/kernels/hc_kernel.py,
// _make_hc_kernel (launched by _encode_blocks_hc, hc_kernel.py:329): one
// block of at most 64 KB per row, a match finder over the
// 4-byte and 8-byte candidate chains, at most max_attempts candidates per
// position, a lossless beat gate, the switch to the 8-byte chain once the
// best score reaches 8 + p - anchor, the stop at SUFFICIENT_LEN, and an
// iterative one-step lazy parse.  The parse is the same decision for
// decision, so payloads are bit-identical to the JAX package's.  Output
// goes through emit.cuh.
//
// The chains come from one stable sort of each row's LE32 keys
// (kernels/hc_kernel.py hc_sorted_tables: perm, the positions in key order,
// and slot, its inverse).  The 4-byte chain of p is the run of
// equal keys just before slot[p], newest first, so a warp reads 32
// candidates with one load and chases no pointer; the 8-byte chain is that
// run filtered on bytes 4..7.
//
// A row may hold a prefix, [prefix | source] (window_lens, as kernel H has
// it): the prefix's positions are in the tables, so a candidate may lie in
// it, but the parse starts at the source's first byte and the block is the
// source's alone.  A prefix makes the run before slot[p] hold positions
// more than 65,535 bytes back; the run is newest first, so the first such
// candidate ends the chain, as the distance test ends the serial walk, and
// the lanes that hold a candidate stay a prefix of the warp (only rows past
// 64 KB can hold such a candidate, so only they test for it).  A 64 KB
// prefix and a 64 KB source need 17-bit positions.  The tables keep 16
// bits up to rows of 64 KB, so the independent rows keep their memory and
// time, and take 32 bits past it: the kernel is a template on the tables'
// index type, and the entry point picks the instance (`wide`).
//
// What bounds it on the card: the latency of the serial walk.  The TPU
// kernel, and this kernel before, walked a chain one dependent load per
// candidate with one thread.  Here a search runs in rounds of 32
// candidates, one a lane, the next round's candidates loaded while a round
// runs: every lane loads its candidate's words and scores it (forward plus
// backward run) unless the beat gate, against the best at the round's
// start, shows it cannot win.  Ballots, popcounts and a warp maximum then
// make the serial walk's decisions (the switch lane, the lanes visited
// after it, the lane where the budget or SUFFICIENT_LEN stops the walk,
// the first lane that holds the final maximum).  A search takes about
// three rounds at level 9 instead of about seventy dependent steps.  Every
// search between two taken matches has the same anchor, so a CTA of P
// warps searches P consecutive positions at once; the lazy parse reads
// their results in order (every thread makes the same decisions from
// shared memory), and warp 0 writes each sequence with its 32 lanes.  The
// take needs no loads: the hit's backward run is the one its search
// counted.  Words are read as two aligned words and a funnel shift,
// through L1 (a row may start at any address).  P and a row staged in
// shared memory (three CTAs per SM) were measured with chip_smoke.py
// --hc-times (PERF.md): P = 2 is within a few per cent of P = 1 on 1,024
// rows at level 9 and faster on few rows at low levels; P = 4 and the
// staged row are slower on 1,024 rows.
// Each round is still a chain of dependent steps (table, words, gate,
// extension, ballots), about 0.6 us.  kernels/hc_kernel.py
// hc_row_rounds_plain models the rounds on the CPU.
#include <cuda_runtime.h>
#include <stdint.h>

#include "emit.cuh"

namespace {

constexpr int P = 2;  // search warps of a row's CTA
constexpr int WARP = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SUFFICIENT_LEN = 64;
constexpr int MAX_DISTANCE = 65535;

// A row read as aligned words: w is the word that holds the row's byte 0,
// at byte off of it.
struct Row {
  const uint32_t* w;
  int off;
};

// The LE32 word of bytes pos..pos+3, from the two aligned words that hold
// them.  Every caller keeps pos <= end - 5 (end: the source's end in the
// row), so the second word starts at a byte of the row (pos + 4 at the
// latest) and every word read holds one.
__device__ __forceinline__ uint32_t ld32(Row r, int pos) {
  pos += r.off;
  const int i = pos >> 2;
  return __funnelshift_r(r.w[i], r.w[i + 1], (uint32_t)(pos & 3) * 8);
}

__device__ __forceinline__ int byte_at(Row r, int pos) {
  pos += r.off;
  return (int)((r.w[pos >> 2] >> ((pos & 3) * 8)) & 0xFFu);
}

// The equal low bytes of two words, from their XOR (4 when they are
// equal).
__device__ __forceinline__ int low_run(uint32_t diff) {
  return diff ? (__ffs(diff) - 1) >> 3 : 4;
}

// Forward match length of (c, p), the first 4 bytes known equal, capped at
// matchlimit - p; 8 bytes a step.  Every word read ends below
// matchlimit + 4 = end - 1.
__device__ __forceinline__ int extend(Row w, int c, int p,
                                      int matchlimit) {
  int ml = 4;
  while (p + ml + 8 <= matchlimit) {
    const uint32_t d0 = ld32(w, c + ml) ^ ld32(w, p + ml);
    const uint32_t d1 = ld32(w, c + ml + 4) ^ ld32(w, p + ml + 4);
    if (d0 | d1) return ml + (d0 ? low_run(d0) : 4 + low_run(d1));
    ml += 8;
  }
  if (p + ml + 4 <= matchlimit && ld32(w, c + ml) == ld32(w, p + ml))
    ml += 4;
  return min(ml + min(low_run(ld32(w, c + ml) ^ ld32(w, p + ml)), 3),
             matchlimit - p);
}

// Backward run of (c, p): equal bytes before both, at most lim.
__device__ __forceinline__ int back_run(Row w, int c, int p,
                                        int lim) {
  int k = 0;
  while (k + 4 <= lim) {
    const uint32_t d = ld32(w, p - k - 4) ^ ld32(w, c - k - 4);
    if (d) return k + (__clz(d) >> 3);
    k += 4;
  }
  while (k < lim && byte_at(w, p - k - 1) == byte_at(w, c - k - 1)) ++k;
  return k;
}

// The lanes from the lowest set lane of `m` up (none when m is 0).
__device__ __forceinline__ unsigned from_first(unsigned m) {
  return m ? ~((m & (~m + 1u)) - 1u) : 0u;
}

struct Hit {
  int score;  // forward + backward length (< 4: no match)
  int fwd;    // forward length from p
  int pos;    // candidate position
};

// The widest match at p, searched by one warp (every lane returns it).
// s0 = slot[p]: the candidates are perm[s0 - 1], perm[s0 - 2], ... while
// they lie before p, at most MAX_DISTANCE back, and share its 4 bytes.
template <typename Idx>
__device__ Hit search(Row w, const Idx* perm, int s0, int p,
                      int anchor, int matchlimit, int max_attempts,
                      int lane) {
  const uint32_t vp = ld32(w, p), vp4 = ld32(w, p + 4);
  const int before = p > anchor ? byte_at(w, p - 1) : -1;
  const int tier8 = 8 + p - anchor, gmax = matchlimit - p - 1;
  const unsigned below = (2u << lane) - 1u;  // lanes 0..lane
  int bs = 0, bf = 0, bpos = 0, att = max_attempts;
  bool switched = false;
  int held = s0 - 1 - lane >= 0 ? (int)perm[s0 - 1 - lane] : p;
  for (int base = s0 - 1;; base -= WARP) {
    const int idx = base - lane;
    int c = held;
    // the next round's candidates, loaded while this round runs
    held = idx - WARP >= 0 ? (int)perm[idx - WARP] : p;
    // a lane past the run reads at p and drops what it reads; in a row of
    // at most 64 KB (16-bit tables) no candidate lies farther back than
    // MAX_DISTANCE, so only the 32-bit instance tests the distance
    bool valid = c < p;
    if constexpr (sizeof(Idx) > 2) valid = valid && p - c <= MAX_DISTANCE;
    c = valid ? c : p;
    const uint32_t vc = ld32(w, c), vc4 = ld32(w, c + 4);
    const int g = min(max(bs - 3, 0), gmax);
    const uint32_t gc = ld32(w, c + g), gp = ld32(w, p + g);
    const int cb = byte_at(w, max(c - 1, 0));
    valid = valid && vc == vp;
    const bool m8 = valid && vc4 == vp4;
    int score = 0, fwd = 0;
    if (valid && (gc == gp || (c > 0 && cb == before))) {
      fwd = extend(w, c, p, matchlimit);
      score = fwd + back_run(w, c, p, min(p - anchor, c));
    }
    // The best after lane i reaches a threshold T from the first lane
    // whose score reaches T on (every lane, when the best before the round
    // does), so the serial walk's tests are ballots, not a prefix maximum.
    const unsigned vmask = __ballot_sync(FULL, valid);  // a prefix of lanes
    const unsigned m8mask = __ballot_sync(FULL, m8);
    const unsigned reach8 =
        bs >= tier8 ? FULL : from_first(__ballot_sync(FULL, score >= tier8));
    const unsigned reach64 =
        from_first(__ballot_sync(FULL, score >= SUFFICIENT_LEN));
    const unsigned swmask = m8mask & reach8;  // possible switch lanes
    unsigned visit = vmask;
    if (switched) {
      visit = m8mask;  // the 8-byte chain: the run filtered on bytes 4..7
    } else if (swmask) {
      const unsigned upto = (2u << (__ffs(swmask) - 1)) - 1u;
      visit = (vmask & upto) | (m8mask & ~upto);
    }
    const bool vis = (visit >> lane) & 1u;
    const unsigned stop =
        (visit & reach64) |
        __ballot_sync(FULL, vis && __popc(visit & below) == att);
    const int last = stop ? __ffs(stop) - 1 : WARP - 1;
    const int fin =
        max(bs, (int)__reduce_max_sync(FULL, lane <= last ? score : 0));
    if (fin > bs) {  // the first lane that holds the final maximum
      const int j =
          __ffs(__ballot_sync(FULL, score == fin && lane <= last)) - 1;
      bf = __shfl_sync(FULL, fwd, j);
      bpos = __shfl_sync(FULL, c, j);
      bs = fin;
    }
    if (stop || vmask != FULL) break;
    att -= __popc(visit);
    switched = switched || swmask != 0;
  }
  return {bs, bf, bpos};
}

// Kernel I: one CTA of P warps per row; `wlen` ([B] int32, or null for
// none) gives each row's prefix, clamped to [0, NS], and the source length
// is clamped to [0, NS - prefix]; `tails` ([B] int32, or null) takes each
// row's offset of its final literal run's token.
template <typename Idx>
__global__ void __launch_bounds__(P* WARP)
    encode_hc_kernel(const uint8_t* src, int NS, const Idx* perm,
                     const Idx* slot, const int32_t* slen,
                     const int32_t* wlen, uint8_t* out, int M, int32_t* olen,
                     int32_t* tails, int max_attempts) {
  __shared__ Hit res[2][P];
  const int row = blockIdx.x, warp = threadIdx.x / WARP,
            lane = threadIdx.x % WARP;
  const int start = wlen ? min(max(wlen[row], 0), NS) : 0;
  const int end = start + min(max(slen[row], 0), NS - start);
  const uint8_t* buf = src + (long long)row * NS;
  const int off = (int)((uintptr_t)buf & 3);
  const Row w = {(const uint32_t*)(buf - off), off};
  const Idx* pr = perm + (long long)row * NS;
  const Idx* sl = slot + (long long)row * NS;
  uint8_t* o = out + (long long)row * M;
  int op = 0, anchor = start;
  if (end - start >= 13) {
    const int mflimit = end - 12, matchlimit = end - 5;
    int ip = start, cur = start, t = 0;
    bool has = false;  // a match found at cur, waiting on the lazy test
    Hit pend = {0, 0, 0};
    while (true) {
      const int q0 = has ? cur + 1 : ip;
      bool took = q0 > mflimit;
      if (!took) {
        const int q = q0 + warp;
        if (q <= mflimit) {
          const Hit h = search(w, pr, (int)sl[q], q, anchor, matchlimit,
                               max_attempts, lane);
          if (lane == 0) res[t][warp] = h;
        }
        __syncthreads();
        // every thread reads the results in order and decides alike
        const int nq = min(P, mflimit - q0 + 1);
        for (int k = 0; k < nq; ++k) {
          const Hit h = res[t][k];
          if (!has) {
            if (h.score < 4) {
              ip = q0 + k + 1;
              continue;
            }
            has = true;
          } else if (h.score <= pend.score) {
            took = true;
            break;
          }
          pend = h;
          cur = q0 + k;
        }
        t ^= 1;  // the next batch writes the other buffer
      }
      if (took) {
        if (!has) break;
        // the hit's backward run is its score less its forward length
        const int mp = cur - (pend.score - pend.fwd);
        if (warp == 0)
          lz4tt::warp_emit_seq(o, op, buf + anchor, mp - anchor,
                               cur - pend.pos, pend.score - 4, lane);
        op += lz4tt::seq_size(mp - anchor, pend.score - 4);
        ip = anchor = mp + pend.score;
        has = false;
      }
    }
  }
  if (warp == 0) {
    lz4tt::warp_emit_final(o, op, buf + anchor, end - anchor, lane);
    if (lane == 0) {
      olen[row] = op + lz4tt::final_run_size(end - anchor);
      if (tails) tails[row] = op;
    }
  }
}

}  // namespace

// `perm` and `slot` are uint16_t tables (wide == 0: rows of at most 64 KB)
// or int32_t ones (wide != 0).
extern "C" int lz4tt_encode_hc(const uint8_t* src, int NS, const void* perm,
                               const void* slot, int wide,
                               const int32_t* slen, const int32_t* wlen,
                               uint8_t* out, int M, int32_t* olen,
                               int32_t* tails, int B, int max_attempts,
                               void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  if (B > 0 && wide)
    encode_hc_kernel<int32_t><<<B, P * WARP, 0, s>>>(
        src, NS, (const int32_t*)perm, (const int32_t*)slot, slen, wlen,
        out, M, olen, tails, max_attempts);
  else if (B > 0)
    encode_hc_kernel<uint16_t><<<B, P * WARP, 0, s>>>(
        src, NS, (const uint16_t*)perm, (const uint16_t*)slot, slen, wlen,
        out, M, olen, tails, max_attempts);
  return (int)cudaGetLastError();
}
