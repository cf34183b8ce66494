// The warp-wide safe LZ4 block decoder shared by kernel D (decode.cu),
// kernel E (stream.cu) and kernel F (sg_decode.cu), and the rounds of
// pointer jumping that finish a chain decoded into cells.
//
// All 32 lanes of a warp run the same parse on the same bytes (loads of one
// address are broadcast, so the warp never diverges) and split every
// literal run and every match into 32-byte strides.  A match that overlaps
// its own output (offset < length) repeats its first `offset` elements, so
// each lane takes element i from element i % offset of that head, which
// lies before the match: no element waits for another, whatever the
// offset.  Every load is checked against the block's length and every
// store against the output limit before it happens, so hostile input
// cannot read or write outside its block.
//
// Chains of linked blocks (kernels D and E linked, F) are decoded with
// every block at once, and kernel E's independent blocks and kernel D's
// batch rows in spans of sequences at once: a block or span whose window
// is not final yet writes int32 *cells*, each a byte (0..255) or a
// reference c < 0 to the cell -c positions back, which lies before the
// block or span (a match inside it copies cells, and a copied reference
// keeps naming its cell).  Once the statuses are known, rounds of pointer
// jumping (jump_cells) resolve the references in parallel, and no block
// waits for another.  A chain is decoded this way in windows of blocks
// that hold at most CELL_WINDOW bytes of output (kernels/decode_kernel.py),
// one window after another: a window's references below its first block
// read the final bytes of the windows before it, the cells stay bounded,
// and every reference fits int32.
#pragma once

#include <stdint.h>

namespace {

constexpr int WARP = 32;

// What decode_block_t writes: the bytes (kBytes), int32 cells (kCells),
// or nothing (kParse: the walk and its checks alone).
enum class Out { kBytes, kCells, kParse };

template <Out K>
struct OutElem {
  using type = uint8_t;
};
template <>
struct OutElem<Out::kCells> {
  using type = int32_t;
};

// Length-extension bytes at *ip (a run of 255s closed by a smaller byte);
// false when the run reaches n.  The length saturates at EXT_MAX, past any
// length a block can hold, so that a run longer than int32 fails its
// checks instead of wrapping to a negative read position.
constexpr int EXT_MAX = 1 << 30;
__device__ __forceinline__ bool read_ext(const uint8_t* src, int n, int* ip,
                                         int* len) {
  while (true) {
    if (*ip >= n) return false;
    const int b = src[(*ip)++];
    *len = min(*len + b, EXT_MAX);
    if (b != 255) return true;
  }
}

// Window byte p < 0 for a copy at distance `offset`, as decode_block_t<..,
// K> stores it: the byte itself, or in kCells a reference, -offset (the
// cell `offset` positions back), for the `refs` positions right before the
// output and for every position without a window buffer.  Past those lie
// final bytes: window byte p is win_end[p + refs].
template <Out K>
__device__ __forceinline__ typename OutElem<K>::type window_elem(
    const uint8_t* win_end, int p, int offset, int refs) {
  if constexpr (K == Out::kCells) {
    if (p >= -refs || win_end == nullptr) return -offset;
    return win_end[p + refs];
  }
  return win_end[p];
}

// Element v copied `offset` positions forward: a reference still names the
// same cell, now `offset` farther back.
template <Out K>
__device__ __forceinline__ typename OutElem<K>::type copied(
    typename OutElem<K>::type v, int offset) {
  if constexpr (K == Out::kCells) return v < 0 ? v - offset : v;
  return v;
}

// Decode one block of n bytes into out[0, olim).  The window (plen bytes of
// history) ends at win_end: history byte -k is win_end[-k].  Returns the
// decoded length, or -1.  Called by all lanes of a warp with equal
// arguments except `lane`.  The literal run must lie inside n, and a run
// that ends exactly at n ends the block; otherwise the offset must lie in
// (0, opos + plen] and the output must fit olim.  Every failure is -1, so
// the order of the checks does not show; the common sequence (no length
// extension, a token after it) takes one test instead of the general
// path's checks one by one.
//
// kCells writes cells; a window byte is read from win_end when it is not
// null and lies before the `refs` positions right before the output, and
// written as a reference otherwise (window_elem; plen still bounds the
// offsets).  kCells and kParse set *far, when the block decodes, to the
// farthest a match reached before the block's start, max(offset - opos -
// litlen), 0 if none; a kParse walk with plen = 65535 fails no offset
// check but offset 0.  kBytes compiles to the decoder without cells.
//
// A span of a block (kernel E's independent mode, kernel D's batch rows)
// starts at the token at ip0 and, when stop >= 0, returns the bytes it
// wrote once it reaches the token at stop (stop = n included); with out at
// the span's output base b, olim = cap - b and plen = b plus the window,
// its checks are the whole block's.
template <Out K = Out::kBytes>
__device__ int decode_block_t(const uint8_t* src, int n,
                              typename OutElem<K>::type* out, int olim,
                              const uint8_t* win_end, int plen, int lane,
                              int* far = nullptr, int ip0 = 0, int stop = -1,
                              int refs = 0) {
  const int end = stop < 0 ? n : stop;
  int ip = ip0, opos = 0, reach = 0;
  while (ip < end) {
    const int token = src[ip++];
    int litlen = token >> 4, mlen = (token & 15) + 4, offset = 0;
    int ip_m = ip + litlen + 2;
    bool ended = false;
    if (litlen < 15 && mlen < 19 && ip_m < n) {
      // the common sequence: no extension, and a token after it
      offset = src[ip_m - 2] | (src[ip_m - 1] << 8);
      if (offset == 0 || offset > opos + litlen + plen ||
          (long long)opos + litlen + mlen > olim)
        return -1;
    } else {
      mlen = 0;
      if (litlen == 15 && !read_ext(src, n, &ip, &litlen)) return -1;
      const long long ip_after = (long long)ip + litlen;
      if (ip_after > n) return -1;                // literals past clen
      if ((long long)opos + litlen > olim) return -1;
      ended = ip_after == n;
      if (!ended) {
        if (ip_after + 2 > n) return -1;          // no room for the offset
        offset = src[ip_after] | (src[ip_after + 1] << 8);
        ip_m = (int)ip_after + 2;
        mlen = (token & 15) + 4;
        if ((token & 15) == 15 && !read_ext(src, n, &ip_m, &mlen)) return -1;
        if (offset == 0 || offset > opos + litlen + plen ||
            (long long)opos + litlen + mlen > olim)
          return -1;
      }
    }
    if constexpr (K != Out::kBytes)
      if (!ended) reach = max(reach, offset - opos - litlen);
    if constexpr (K != Out::kParse) {
      for (int i = lane; i < litlen; i += WARP) out[opos + i] = src[ip + i];
      __syncwarp();
    }
    opos += litlen;
    if (ended) {
      if constexpr (K != Out::kBytes) *far = reach;
      return opos;
    }
    if constexpr (K != Out::kParse) {
      // element i = q * offset + r is element r of the head, q hops on
      const int from = opos - offset;
      const bool overlaps = mlen > offset;
      for (int i = lane; i < mlen; i += WARP) {
        const int q = overlaps ? i / offset : 0, p = from + i - q * offset;
        const auto v = p < 0 ? window_elem<K>(win_end, p, offset, refs)
                             : copied<K>(out[p], offset);
        out[opos + i] = copied<K>(v, q * offset);
      }
      __syncwarp();
    }
    opos += mlen;
    ip = ip_m;
  }
  // a span stops at its last token; a block must end with a literal-only
  // sequence
  return stop >= 0 ? opos : -1;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The token walk of a block without a byte moved (kernel D's batch step 1),
// with the window length plen: the serial decoder's length, or -1, and
// mark(token offset, output position) on every sequence it passes.
//
// RESUMABLE is the destSize decode: a whole sequence is parsed and
// validated first (anything malformed gives -1 and *cons = -1), and only
// then held against the room.  A sequence that does not fit olim is not
// started: the block stops at its token, returns the bytes produced so far
// and sets *cons to the token's offset.  A block that ends, with its
// terminal literal run or exactly after a match, sets *cons = n.  Without
// RESUMABLE every failure is -1 and `cons` is not touched.
//
// The next token's place needs only the token and its extensions, so a
// sequence's offset is checked one sequence late, after the next token's
// load is issued, and before any return but a failure: the chain of
// dependent loads is one load a sequence.  A failure returns -1 as the
// serial decoder would (every check of a sequence still comes before its
// room check); a sequence marked and then found malformed fails the block.
template <bool RESUMABLE, typename Mark>
__device__ int walk_block(const uint8_t* src, int n, int olim, int plen,
                          int* cons, Mark mark) {
  int ip = 0, opos = 0;
  int lo = 1, hi = 0, limit = 1;      // the offset check left over
  auto bad_offset = [&]() {
    const int offset = lo | (hi << 8);
    return offset == 0 || offset > limit;
  };
  auto malformed = [&]() {
    if (RESUMABLE) *cons = -1;
    return -1;
  };
  while (ip < n) {
    // the common sequences (no extension, a token after them) in a loop of
    // their own, without a taken branch but the loop's
    while (true) {
      const int token = src[ip];
      prefetch_l1(src + min(ip + 256, n - 1));
      if (bad_offset()) return malformed();
      const int litlen = token >> 4, mlen = (token & 15) + 4;
      const int ia = ip + 1 + litlen;
      if (litlen == 15 || mlen == 19 || ia + 2 >= n) break;
      lo = src[ia];
      hi = src[ia + 1];
      limit = opos + litlen + plen;
      if ((long long)opos + litlen + mlen > olim) {
        if (!RESUMABLE) return -1;
        if (bad_offset()) return malformed();
        *cons = ip;
        return opos;
      }
      mark(ip, opos);
      opos += litlen + mlen;
      ip = ia + 2;
    }
    const int at = ip;
    const int token = src[ip++];
    int litlen = token >> 4;
    if (litlen == 15 && !read_ext(src, n, &ip, &litlen)) return malformed();
    const long long ip_after = (long long)ip + litlen;
    if (ip_after > n) return malformed();
    if (!RESUMABLE && (long long)opos + litlen > olim) return -1;
    const bool ended = ip_after == n;
    int mlen = 0, ip_m = 0;
    if (!ended) {
      if (ip_after + 2 > n) return malformed();
      lo = src[ip_after];
      hi = src[ip_after + 1];
      limit = opos + litlen + plen;
      ip_m = (int)ip_after + 2;
      mlen = (token & 15) + 4;
      if ((token & 15) == 15 && !read_ext(src, n, &ip_m, &mlen))
        return malformed();
      if (!RESUMABLE && (long long)opos + litlen + mlen > olim) return -1;
    }
    if (RESUMABLE && (long long)opos + litlen + mlen > olim) {
      if (bad_offset()) return malformed();
      *cons = at;
      return opos;
    }
    mark(at, opos);
    opos += litlen;
    if (ended) {
      if (RESUMABLE) *cons = n;
      return opos;
    }
    opos += mlen;
    ip = ip_m;
  }
  if (bad_offset()) return malformed();
  if (!RESUMABLE) return -1;
  *cons = ip;
  return opos;
}

__device__ __forceinline__ int decode_block(const uint8_t* src, int n,
                                            uint8_t* out, int olim,
                                            const uint8_t* win_end, int plen,
                                            int lane) {
  return decode_block_t(src, n, out, olim, win_end, plen, lane);
}

// The rounds of jump_cells that resolve every chain of a B-block chain,
// and the most any B takes: a reference names a cell of an earlier block,
// so a chain has at most B - 1 links, and after round k (from 0) every
// chain of up to 2^(k+1) - 1 links is resolved (synchronous pointer jumping
// gives that; following more links in a round, or reading a cell that
// another thread already advanced in the same round, only helps).
constexpr int MAX_JUMP_ROUNDS = 32;
__host__ __device__ inline int jump_rounds(int B) {
  int k = 1;
  while ((1LL << k) < B) ++k;
  return k;
}

// Links a reference follows in one round: most chains of real data end
// within them, so the first round or two resolve nearly every cell and the
// rest return at once.
constexpr int JUMP_LINKS = 16;

// Round k of pointer jumping over positions [start, end): cells[i - origin]
// holds position i's cell, and a reference c names position i + c; cell i
// follows up to JUMP_LINKS links of its chain and takes the byte it
// reaches, or a reference to the last position it reached.  Positions below
// `origin` hold no cells: their bytes are final in out.  Round 0 also
// writes every byte cell out, and every round writes the bytes it
// resolves; a reference left over sets *more.  Any value another thread
// reads from a cell, before or after this round changes it, is a byte or a
// link of the same chain, so the rounds need no ordering inside.  A
// reference spans at most the cells' extent plus 64 KB, which the callers
// keep far inside int32 (the windows above).  Threads t of nt.
__device__ __forceinline__ void jump_cells(int32_t* cells, long long origin,
                                           uint8_t* out, long long start,
                                           long long end, bool first,
                                           long long t, long long nt,
                                           int32_t* more) {
  bool left = false;
  for (long long i = start + t; i < end; i += nt) {
    int v = cells[i - origin];
    if (v >= 0) {
      if (first) out[i] = (uint8_t)v;
      continue;
    }
    long long j = i;
    for (int link = 0; v < 0 && link < JUMP_LINKS; ++link) {
      j += v;
      v = j < origin ? out[j] : cells[j - origin];
    }
    if (v >= 0) {
      cells[i - origin] = v;
      out[i] = (uint8_t)v;
    } else {
      cells[i - origin] = (int)(j + v - i);
      left = true;
    }
  }
  if (left) *more = 1;
}

}  // namespace
