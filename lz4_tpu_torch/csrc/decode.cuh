// The warp-wide safe LZ4 block decoder shared by kernel D (decode.cu) and
// kernel E (stream.cu).
//
// All 32 lanes of a warp run the same parse on the same bytes (loads of one
// address are broadcast, so the warp never diverges) and split every
// literal run, and every match whose offset is at least 32, into 32-byte
// strides; a match with a shorter offset overlaps its own output and is
// copied bytewise by lane 0.  Every load is checked against the block's
// length and every store against the output limit before it happens, so
// hostile input cannot read or write outside its block.
#pragma once

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
// arguments except `lane`.  The literal run must lie inside n, and a run
// that ends exactly at n ends the block; otherwise the offset must lie in
// (0, opos + plen] and the output must fit olim.
//
// RESUMABLE is the destSize decode: a whole sequence is parsed and
// validated first (anything malformed gives -1 and *cons = -1), and only
// then held against the room.  A sequence that does not fit olim is not
// started: the block stops at its token, returns the bytes produced so far
// and sets *cons to the token's offset.  A block that ends, with its
// terminal literal run or exactly after a match, sets *cons = n.  Without
// RESUMABLE the order of the checks does not show (every failure is -1),
// `cons` is not touched, and the compiled decoder is the one it was.
template <bool RESUMABLE>
__device__ int decode_block_t(const uint8_t* src, int n, uint8_t* out,
                              int olim, const uint8_t* win_end, int plen,
                              int lane, int* cons) {
  int ip = 0, opos = 0;
  auto malformed = [&]() {
    if (RESUMABLE) *cons = -1;
    return -1;
  };
  while (ip < n) {
    const int ip0 = ip;
    const int token = src[ip++];
    int litlen = token >> 4;
    if (litlen == 15 && !read_ext(src, n, &ip, &litlen)) return malformed();
    const long long ip_after = (long long)ip + litlen;
    if (ip_after > n) return malformed();         // literals past clen
    if (!RESUMABLE && (long long)opos + litlen > olim) return -1;
    const bool ended = ip_after == n;
    int mlen = 0, offset = 0, ip_m = 0;
    if (!ended) {
      if (ip_after + 2 > n) return malformed();   // no room for the offset
      offset = src[ip_after] | (src[ip_after + 1] << 8);
      ip_m = (int)ip_after + 2;
      mlen = (token & 15) + 4;
      if ((token & 15) == 15 && !read_ext(src, n, &ip_m, &mlen))
        return malformed();
      if (offset == 0 || offset > opos + litlen + plen) return malformed();
      if (!RESUMABLE && (long long)opos + litlen + mlen > olim) return -1;
    }
    if (RESUMABLE && (long long)opos + litlen + mlen > olim) {
      *cons = ip0;                                // stop at the token
      return opos;
    }
    for (int i = lane; i < litlen; i += WARP) out[opos + i] = src[ip + i];
    __syncwarp();
    opos += litlen;
    if (ended) {
      if (RESUMABLE) *cons = n;
      return opos;
    }
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
  // the block must end with a literal-only sequence
  if (!RESUMABLE) return -1;
  *cons = ip;                 // the source ran out at a token boundary
  return opos;
}

__device__ __forceinline__ int decode_block(const uint8_t* src, int n,
                                            uint8_t* out, int olim,
                                            const uint8_t* win_end, int plen,
                                            int lane) {
  return decode_block_t<false>(src, n, out, olim, win_end, plen, lane,
                               nullptr);
}

}  // namespace
