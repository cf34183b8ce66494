// LZ4 stream decoder: kernel E.
//
// Replaces the Pallas kernel lz4_tpu/kernels/decode_kernel.py
// _make_stream_decode_kernel (launched by _decode_stream): one frame's block
// chain of any block size, linked or independent, decoded into one flat
// output.  Payloads sit at any byte offset of one flat input buffer (a raw
// frame or legacy file is uploaded as it is, never repacked), and stored
// blocks are copied in the kernel.  The TPU kernel's semantics:
// * blocks decode in order; a block starts where the previous good block
//   ended, and may decode to at most its cap (the wrapper has already
//   clamped caps to 8 MB);
// * in linked mode a match may reach into everything decoded so far
//   (offsets are at most 65535, so the window is the last 64 KB of the
//   output); in independent mode only into its own block;
// * a stored block is a straight copy of its n bytes when n fits its cap;
// * a failed block reports -1 and does not move the position.
// The wrapper checks that every block lies inside the input buffer; the
// decoder checks every load against the block's length and every store
// against its cap (decode.cuh).
//
// What bounds it on the card: as in kernel D, a block's token parse is
// serial, so one warp decodes at the latency of its dependent loads (24-30
// MB/s).  The TPU kernel paged input and output through 128 KB VMEM rings
// because VMEM is small; global memory holds the whole stream and its
// output, so there are no rings.
//
// Independent mode splits the parse inside each block, so that a 4 or 8 MB
// block is decoded by hundreds of warps (a warp per block would give a 64
// MiB -B7 file 16 warps).  Per window of blocks (below):
// (1) the payloads of the blocks to parse are gathered into one parse
//     space; a block whose payload is longer than any block of its cap can
//     be (cap + cap/8 + 64: literals cost at most 16/15 of their bytes, a
//     match at most its length) is rejected without a parse;
// (2) run ends: for every byte, the first byte at or after it that is not
//     255 (a reverse min-scan inside 4 KB tiles, then across the tiles), so
//     a length extension is read in O(1) and a payload of 255s costs O(n);
// (3) next: for every byte p, the token that follows if a token starts at
//     p, and len(p), the bytes its sequence writes; END marks a
//     literal-only sequence that ends the block, FAIL one that runs past
//     it, has offset 0, ends the block with a match or outgrows the cap;
// (4) s rounds of pointer doubling over next carry the sums of len, the
//     sentinels absorbing: jump(p) is 2^s sequences on;
// (5) one thread per block walks from byte 0 by 2^s sequences a step and
//     writes the spans: start token and output base (about 860 steps for
//     a 4 MB block of text at s = 8);
// (6) one warp per span decodes its sequences into int32 cells at its base
//     (decode.cuh, with the span's base as window length, so its checks
//     are the block's: offset <= opos + litlen, output <= cap); a copy
//     from before the span is a reference;
// (7) the good blocks' places in the output (a one-CTA scan), then rounds
//     of pointer jumping resolve the references (a chain crosses at most
//     spans - 1 links) and write the bytes there; a stored block is
//     copied in round 0.
// Every failure is -1 and a failed block's bytes are dropped, so the order
// of the checks does not show: the bytes and lengths are the serial
// walk's.  The scratch is bounded: a window holds blocks whose caps sum to
// at most CELL_WINDOW and whose parsed payloads sum to at most
// PARSE_WINDOW (decode_kernel.py), or one block.
//
// Linked mode is serial by format (a block starts where the previous good
// block ended, and its window is the output before it), but only its
// statuses and positions are, and those need no bytes:
// (A) one warp per block, all at once, walks the tokens without moving a
//     byte (block 0, whose base is 0 and window empty, is decoded in full),
//     recording the decoded length or -1 and need[b], how far its matches
//     reach before its start;
// (B) one thread walks the B results in order: plen_b = min(base_b, 65535),
//     block b fails when need[b] > plen_b, base_{b+1} = base_b + max(olen_b,
//     0).  This is the serial walk exactly: every failed check is -1 in any
//     order, and the offset checks are the only ones the window changes;
// (C) one warp per good block b >= 1 decodes it at base_b into int32 cells,
//     with a reference wherever it copies a byte from before its start
//     (decode.cuh), and a stored block 0 is copied;
// (D) rounds of pointer jumping over the cells, grid-wide, resolve the
//     references (they may cross several short blocks; ceil(log2 B) rounds
//     resolve the longest chain) and write the bytes out.  Steps C and D run
//     over windows of blocks that hold at most CELL_WINDOW bytes of output
//     (decode_kernel.py), window after window.  A first design
//     filled the references in one CTA, block after block in order: 73 % of
//     the kernel's time on a flushed 64 MiB chain, so the rounds replaced it
//     (PERF.md).
// Block 0's decode keeps the form of the one-warp chain walk this replaces
// (its window pointer is the output itself, which plen = 0 never reads),
// and a stored block 0 is copied in step C: with that copy loop in step
// A's kernel, a one-block chain decoded 5-6 % slower on the card (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int MAX_OFFSET = 65535;
constexpr int SCAN_THREADS = 1024;
constexpr int COPY_THREADS = 256;
constexpr int COPY_CTAS_PER_BLOCK = 64;
constexpr int JUMP_CTAS = 1024;

// Block metadata: meta is int32 [4, B]: byte offset in the input, payload
// length, cap, stored flag.
struct Meta {
  const int32_t* m;
  int B;
  __device__ int start(int b) const { return m[b]; }
  __device__ int clen(int b) const { return m[B + b]; }
  __device__ int cap(int b) const { return m[2 * B + b]; }
  __device__ bool stored(int b) const { return m[3 * B + b] != 0; }
};

// (A) Warp b: olen[b] = block b's decoded length or -1, need[b] how far
// it reaches before its start; a compressed block 0 is decoded into out.
__global__ void stream_parse_kernel(const uint8_t* flat, Meta meta,
                                    uint8_t* out, int32_t* olen,
                                    int32_t* need) {
  const int b = blockIdx.x;
  int r, far = 0;
  if (meta.stored(b))
    r = meta.clen(b) <= meta.cap(b) ? meta.clen(b) : -1;
  else if (b == 0)
    r = decode_block(flat + meta.start(0), meta.clen(0), out, meta.cap(0),
                     out, 0, threadIdx.x);
  else
    r = decode_block_t<Out::kParse>(
        flat + meta.start(b), meta.clen(b), nullptr, meta.cap(b), nullptr,
        MAX_OFFSET, threadIdx.x, &far);
  if (threadIdx.x == 0) {
    olen[b] = r;
    need[b] = far;
  }
}

// (B) One thread: the final statuses, dst[b] = base_b; the rounds' flags
// (nflags of them) cleared.
__global__ void stream_scan_kernel(int B, int32_t* olen, const int32_t* need,
                                   long long* dst, int32_t* more,
                                   int nflags) {
  for (int k = 0; k < nflags; ++k) more[k] = 0;
  long long base = 0;
  for (int b = 0; b < B; ++b) {
    int r = olen[b];
    if (r >= 0 && need[b] > min(base, (long long)MAX_OFFSET)) r = -1;
    olen[b] = r;
    dst[b] = base;
    if (r > 0) base += r;
  }
}

// (C) Warp i decodes good block b = b0 + i >= 1 of the window [b0, b1) into
// cells at dst[b] - dst[c0], c0 = max(b0, 1); warp 0 copies a stored block
// 0 into out.
__global__ void stream_cells_kernel(const uint8_t* flat, Meta meta,
                                    const int32_t* olen, const long long* dst,
                                    int32_t* cells, uint8_t* out, int b0) {
  const int b = b0 + blockIdx.x;
  if (olen[b] <= 0) return;
  if (b == 0) {
    if (meta.stored(0))
      for (int i = threadIdx.x; i < olen[0]; i += WARP)
        out[i] = flat[meta.start(0) + i];
    return;
  }
  int32_t* c = cells + (dst[b] - dst[max(b0, 1)]);
  const uint8_t* src = flat + meta.start(b);
  if (meta.stored(b)) {
    for (int i = threadIdx.x; i < olen[b]; i += WARP) c[i] = src[i];
  } else {
    int far;
    decode_block_t<Out::kCells>(
        src, meta.clen(b), c, meta.cap(b), nullptr,
        (int)min(dst[b], (long long)MAX_OFFSET), threadIdx.x, &far);
  }
}

// (D) Round k over the cells of blocks [c0, b1), which the good blocks fill
// without a gap from dst[c0] on; the bytes below dst[c0] are in out
// already.
__global__ void stream_jump_kernel(int c0, int b1, const int32_t* olen,
                                   const long long* dst, int32_t* cells,
                                   uint8_t* out, int32_t* more, int k) {
  if (k > 0 && !more[k - 1]) return;
  jump_cells(cells, dst[c0], out, dst[c0],
             dst[b1 - 1] + max(olen[b1 - 1], 0), k == 0,
             (long long)blockIdx.x * blockDim.x + threadIdx.x,
             (long long)gridDim.x * blockDim.x, more + k);
}

// ---- independent mode: a parallel parse inside every block ---------------

constexpr int TILE = 4096;            // bytes per CTA of the run-end pass
constexpr int TILE_PER_THREAD = TILE / COPY_THREADS;
constexpr int NEXT_PER_THREAD = 8;    // positions per thread of step 3
constexpr int SPAN_WARPS = 4;         // warps per CTA of step 6
constexpr int NO_RUN_END = 0x7fffffff;
constexpr int SEQ_END = -1;           // next(p): the block ends at p's run
constexpr int SEQ_FAIL = -2;          // next(p): p's sequence fails
// len sums saturate here: no block decodes past 8 MB
constexpr int LEN_SAT = (1 << 23) + 1;

// Per-block layout of a window, window-relative (int64 [4, B]): the
// block's base in the parse space, its parsed length (0: not parsed), its
// cells' base and its first span slot.
struct Spans {
  const long long* m;
  int B;
  __device__ long long pbase(int b) const { return m[b]; }
  __device__ int plen(int b) const { return (int)m[B + b]; }
  __device__ long long cbase(int b) const { return m[2 * B + b]; }
  __device__ long long soff(int b) const { return m[3 * B + b]; }
};

// The largest b in [lo, hi) with base(b) <= x: the block that owns
// position x of a prefix-sum layout (blocks of length 0 share their
// successor's base and come before it).
template <typename F>
__device__ __forceinline__ int owner(F base, int lo, int hi, long long x) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (base(mid) <= x)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// (1) The payloads of the window's parsed blocks into the parse space; a
// grid of (blocks, COPY_CTAS_PER_BLOCK) CTAs.
__global__ void spans_gather_kernel(const uint8_t* flat, Meta meta, Spans sp,
                                    int b0, uint8_t* pbuf) {
  const int b = b0 + blockIdx.x;
  const long long n = sp.plen(b);
  const uint8_t* s = flat + meta.start(b);
  uint8_t* d = pbuf + sp.pbase(b);
  const long long step = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x; i < n;
       i += step)
    d[i] = s[i];
}

// (2a) Tile t of the parse space: run[q] = the first q' >= q in the tile
// whose byte is not 255 (NO_RUN_END if none), tile_first[t] = the tile's
// first such byte.  Each thread takes TILE_PER_THREAD bytes; a reverse
// Hillis-Steele min-scan joins the threads.
__global__ void spans_runs_kernel(const uint8_t* pbuf, long long P,
                                  int32_t* run, int32_t* tile_first) {
  __shared__ int part[COPY_THREADS];
  const int t = threadIdx.x;
  const long long lo = (long long)blockIdx.x * TILE + t * TILE_PER_THREAD;
  int first = NO_RUN_END;
  for (int i = TILE_PER_THREAD - 1; i >= 0; --i)
    if (lo + i < P && pbuf[lo + i] != 255) first = (int)(lo + i);
  part[t] = first;
  __syncthreads();
  for (int d = 1; d < COPY_THREADS; d <<= 1) {
    const int v = t + d < COPY_THREADS ? part[t + d] : NO_RUN_END;
    __syncthreads();
    part[t] = min(part[t], v);
    __syncthreads();
  }
  int cur = t + 1 < COPY_THREADS ? part[t + 1] : NO_RUN_END;
  for (int i = TILE_PER_THREAD - 1; i >= 0; --i) {
    const long long q = lo + i;
    if (q < P) {
      if (pbuf[q] != 255) cur = (int)q;
      run[q] = cur;
    }
  }
  if (t == 0) tile_first[blockIdx.x] = part[0];
}

// (2b) tile_next[t] = the min of tile_first[t..T), in one CTA: each thread
// takes a contiguous range, a reverse scan runs over the ranges' minima.
__global__ void spans_tiles_kernel(const int32_t* tile_first, int T,
                                   int32_t* tile_next) {
  __shared__ int part[SCAN_THREADS];
  const int t = threadIdx.x;
  const int per = (T + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(t * per, T), hi = min(lo + per, T);
  int m = NO_RUN_END;
  for (int i = lo; i < hi; ++i) m = min(m, tile_first[i]);
  part[t] = m;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {
    const int v = t + d < SCAN_THREADS ? part[t + d] : NO_RUN_END;
    __syncthreads();
    part[t] = min(part[t], v);
    __syncthreads();
  }
  int run = t + 1 < SCAN_THREADS ? part[t + 1] : NO_RUN_END;
  for (int i = hi - 1; i >= lo; --i) {
    run = min(run, tile_first[i]);
    tile_next[i] = run;
  }
}

// The first byte at or after x that is not 255, from steps 2a-2b.
__device__ __forceinline__ long long run_end(const int32_t* run,
                                             const int32_t* tile_next,
                                             int T, long long x) {
  int r = run[x];
  if (r == NO_RUN_END) {
    const long long t = x / TILE + 1;
    r = t < T ? tile_next[t] : NO_RUN_END;
  }
  return r;
}

// (3) next(q) and len(q) for a token at q of a block ending at `end` (all
// parse-space positions): the serial decoder's checks that need no output
// position, in its order.
__device__ __forceinline__ void next_of(const uint8_t* pb, long long q,
                                        long long end, int cap,
                                        const int32_t* run,
                                        const int32_t* tile_next, int T,
                                        int2* JS) {
  const int token = pb[q];
  long long ip = q + 1, lit = token >> 4, len = 0;
  int res = SEQ_FAIL;
  do {
    if (lit == 15) {                        // a run of 255s ending at r
      if (ip >= end) break;
      const long long r = run_end(run, tile_next, T, ip);
      if (r >= end) break;
      lit += 255 * (r - ip) + pb[r];
      ip = r + 1;
    }
    const long long ia = ip + lit;
    if (ia > end || lit > cap) break;       // literals past clen or the cap
    if (ia == end) {
      res = SEQ_END;
      len = lit;
      break;
    }
    if (ia + 2 > end) break;                // no room for the offset
    if ((pb[ia] | (pb[ia + 1] << 8)) == 0) break;
    long long im = ia + 2, ml = (token & 15) + 4;
    if ((token & 15) == 15) {
      if (im >= end) break;
      const long long r = run_end(run, tile_next, T, im);
      if (r >= end) break;
      ml += 255 * (r - im) + pb[r];
      im = r + 1;
    }
    if (im == end || lit + ml > cap) break; // ends with a match; the cap
    res = (int)im;
    len = lit + ml;
  } while (false);
  JS[q] = make_int2(res, (int)len);
}

__global__ void spans_next_kernel(const uint8_t* pbuf, long long P, Meta meta,
                                  Spans sp, int b0, int b1,
                                  const int32_t* run,
                                  const int32_t* tile_next, int T,
                                  int2* JS) {
  const long long q0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * NEXT_PER_THREAD;
  if (q0 >= P) return;
  int b = owner([&](int i) { return sp.pbase(i); }, b0, b1, q0);
  long long end = sp.pbase(b) + sp.plen(b);
  for (long long q = q0; q < min(q0 + NEXT_PER_THREAD, P); ++q) {
    while (q >= end) {
      ++b;
      end = sp.pbase(b) + sp.plen(b);
    }
    next_of(pbuf, q, end, meta.cap(b), run, tile_next, T, JS);
  }
}

// (4) One round of pointer doubling: jump and sum over twice as many
// sequences; END and FAIL absorb.  (next, len) pairs are one int2, so a
// step of the doubling or of the walk is one 8-byte load.
__global__ void spans_double_kernel(long long P, const int2* in,
                                    int2* out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < P;
       q += step) {
    int2 a = in[q];
    if (a.x >= 0) {
      const int2 b = in[a.x];
      a = make_int2(b.x, min(a.y + b.y, LEN_SAT));
    }
    out[q] = a;
  }
}

// (5) Thread per block: its status so far (a stored block's is final) and
// its spans: span k starts at token span_ip[soff + k] (block-relative)
// and writes from output byte span_base[soff + k].
__global__ void spans_walk_kernel(Meta meta, Spans sp, int b0, int b1,
                                  const int2* JS, int32_t* span_ip,
                                  int32_t* span_base,
                                  int32_t* nspans, int32_t* olen) {
  const int b = b0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= b1) return;
  const int cap = meta.cap(b);
  if (meta.stored(b) || sp.plen(b) == 0) {
    nspans[b] = 0;
    olen[b] = meta.stored(b) && meta.clen(b) <= cap ? meta.clen(b) : -1;
    return;
  }
  const long long p0 = sp.pbase(b);
  const long long so = sp.soff(b);
  long long p = p0;
  int base = 0, k = 0, r = -1;
  while (true) {
    span_ip[so + k] = (int)(p - p0);
    span_base[so + k] = base;
    ++k;
    const int2 js = JS[p];
    if (js.x == SEQ_FAIL) break;
    base += js.y;
    if (base > cap) break;
    if (js.x == SEQ_END) {
      r = base;
      break;
    }
    p = js.x;
  }
  nspans[b] = r < 0 ? 0 : k;
  olen[b] = r;
}

// (6) Warp g decodes span slot g into cells; any failure makes its block -1.
__global__ void spans_decode_kernel(const uint8_t* flat, Meta meta, Spans sp,
                                    int b0, int b1, long long nslots,
                                    const int32_t* span_ip,
                                    const int32_t* span_base,
                                    const int32_t* nspans, int32_t* olen,
                                    int32_t* cells) {
  const long long g =
      (long long)blockIdx.x * SPAN_WARPS + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (g >= nslots) return;
  const int b = owner([&](int i) { return sp.soff(i); }, b0, b1, g);
  const long long k = g - sp.soff(b);
  // (not olen[b], which other warps may set to -1 meanwhile: every lane
  // must take the same path to the decoder's __syncwarp)
  if (k >= nspans[b]) return;
  const int n = meta.clen(b);
  const bool last = k + 1 == nspans[b];
  const int base = span_base[g];
  int far;
  const int r = decode_block_t<Out::kCells>(
      flat + meta.start(b), n, cells + sp.cbase(b) + base,
      meta.cap(b) - base, nullptr, base, lane, &far, span_ip[g],
      last ? -1 : span_ip[g + 1]);
  if (r < 0 && lane == 0) olen[b] = -1;
}

// (7a) dst[b] for the window's blocks [b0, b1): the sum of max(olen[j], 0)
// over j < b, in one CTA (dst[b0 - 1] and olen[b0 - 1] are final): each
// thread sums a contiguous range, a Hillis-Steele scan runs over the range
// sums, then each thread writes its range's offsets.
__global__ void stream_offsets_kernel(const int32_t* olen, int b0, int b1,
                                      long long* dst) {
  __shared__ long long part[SCAN_THREADS];
  const int t = threadIdx.x;
  const int B = b1 - b0;
  const int per = (B + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = b0 + min(t * per, B), hi = min(lo + per, b1);
  long long sum = 0;
  for (int i = lo; i < hi; ++i) sum += max(olen[i], 0);
  part[t] = sum;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {
    const long long v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = part[t] - sum;
  if (b0 > 0) run += dst[b0 - 1] + max(olen[b0 - 1], 0);
  for (int i = lo; i < hi; ++i) {
    dst[i] = run;
    run += max(olen[i], 0);
  }
}

// (7b) Round k over good block b0 + blockIdx.x, by (gridDim.y, blockDim.x)
// threads: its cells resolved into out at dst[b] (references never leave
// a good block); round 0 copies a stored block.
__global__ void spans_jump_kernel(const uint8_t* flat, Meta meta, Spans sp,
                                  int b0, const int32_t* olen,
                                  const long long* dst, int32_t* cells,
                                  uint8_t* out, int32_t* more, int k) {
  const int b = b0 + blockIdx.x;
  const long long n = olen[b];
  if (n <= 0 || (k > 0 && !more[k - 1])) return;
  const long long t = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  const long long nt = (long long)gridDim.y * blockDim.x;
  if (meta.stored(b)) {
    if (k == 0) {
      const uint8_t* s = flat + meta.start(b);
      for (long long i = t; i < n; i += nt) out[dst[b] + i] = s[i];
    }
    return;
  }
  jump_cells(cells + sp.cbase(b), 0, out + dst[b], 0, n, k == 0, t, nt,
             more + k);
}

}  // namespace

// Kernel E in linked mode: dst, win (nwin + 1 block indices on the host:
// the windows [win[w], win[w + 1]) of steps C and D, win[0] = 0, win[nwin]
// = B), cells (int32, the most output bytes of blocks >= 1 in one window)
// and need (int32 [B + nwin * MAX_JUMP_ROUNDS]).
extern "C" int lz4tt_decode_stream(const uint8_t* flat, const int32_t* meta,
                                   int B, const int32_t* win, int nwin,
                                   int32_t* cells, int32_t* need,
                                   long long* dst, uint8_t* out,
                                   int32_t* olen, void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const Meta m{meta, B};
  if (B > 0) {
    int32_t* more = need + B;
    stream_parse_kernel<<<B, WARP, 0, s>>>(flat, m, out, olen, need);
    stream_scan_kernel<<<1, 1, 0, s>>>(B, olen, need, dst, more,
                                       nwin * MAX_JUMP_ROUNDS);
    for (int w = 0; w < nwin; ++w, more += MAX_JUMP_ROUNDS) {
      const int b0 = win[w], b1 = win[w + 1], c0 = max(b0, 1);
      stream_cells_kernel<<<b1 - b0, WARP, 0, s>>>(flat, m, olen, dst, cells,
                                                   out, b0);
      // a chain links blocks b1 - 1, ..., c0 and ends in a byte
      if (b1 > c0)
        for (int k = 0; k < jump_rounds(b1 - c0 + 1); ++k)
          stream_jump_kernel<<<JUMP_CTAS, COPY_THREADS, 0, s>>>(
              c0, b1, olen, dst, cells, out, more, k);
    }
  }
  return (int)cudaGetLastError();
}

// Kernel E in independent mode.  spans: int64 [4, B] (struct Spans).  win:
// nwin rows of 6 int64 on the host: b0, b1, the parse space's length P,
// the span slots, the jump rounds and the jump kernel's CTAs per block.
// Scratch, sized for the largest window: pbuf (uint8 [P]), parse (int32
// [4 * P]), tiles (int32 [2 * ceil(P / TILE)]),
// slots (int32 [2 * slots]), nspans (int32 [B]), cells (int32, the caps
// of the parsed blocks) and more (int32 [nwin * MAX_JUMP_ROUNDS], zeroed).
// parse holds two int2 arrays of pmax (next, len) pairs; the run ends of
// step 2 live in the second until the first doubling round.
extern "C" int lz4tt_decode_stream_spans(
    const uint8_t* flat, const int32_t* meta, int B, const long long* spans,
    const long long* win, int nwin, int span_log, long long pmax,
    long long smax, uint8_t* pbuf, int32_t* parse, int32_t* tiles,
    int32_t* slots, int32_t* nspans, int32_t* cells, int32_t* more,
    long long* dst, uint8_t* out, int32_t* olen, void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const Meta m{meta, B};
  const Spans sp{spans, B};
  const long long tmax = (pmax + TILE - 1) / TILE;
  for (int w = 0; w < nwin; ++w, more += MAX_JUMP_ROUNDS) {
    const long long* wm = win + 6 * w;
    const int b0 = (int)wm[0], b1 = (int)wm[1], nb = b1 - b0;
    const long long P = wm[2], nslots = wm[3];
    int2* JS = (int2*)parse;
    int2* JS2 = (int2*)(parse + 2 * pmax);
    int32_t* run = parse + 2 * pmax;
    if (P > 0) {
      const int T = (int)((P + TILE - 1) / TILE);
      spans_gather_kernel<<<dim3(nb, COPY_CTAS_PER_BLOCK), COPY_THREADS, 0,
                            s>>>(flat, m, sp, b0, pbuf);
      spans_runs_kernel<<<T, COPY_THREADS, 0, s>>>(pbuf, P, run, tiles);
      spans_tiles_kernel<<<1, SCAN_THREADS, 0, s>>>(tiles, T, tiles + tmax);
      const long long per_cta = (long long)COPY_THREADS * NEXT_PER_THREAD;
      spans_next_kernel<<<(int)((P + per_cta - 1) / per_cta), COPY_THREADS, 0,
                          s>>>(pbuf, P, m, sp, b0, b1, run, tiles + tmax, T,
                               JS);
      const int grid = (int)min((P + COPY_THREADS - 1) / COPY_THREADS,
                                (long long)JUMP_CTAS * 8);
      for (int r = 0; r < span_log; ++r) {
        spans_double_kernel<<<grid, COPY_THREADS, 0, s>>>(P, JS, JS2);
        int2* t = JS;
        JS = JS2;
        JS2 = t;
      }
    }
    spans_walk_kernel<<<(nb + 127) / 128, 128, 0, s>>>(
        m, sp, b0, b1, JS, slots, slots + smax, nspans, olen);
    if (nslots > 0)
      spans_decode_kernel<<<(int)((nslots + SPAN_WARPS - 1) / SPAN_WARPS),
                            SPAN_WARPS * WARP, 0, s>>>(
          flat, m, sp, b0, b1, nslots, slots, slots + smax, nspans, olen,
          cells);
    stream_offsets_kernel<<<1, SCAN_THREADS, 0, s>>>(olen, b0, b1, dst);
    for (int k = 0; k < (int)wm[4]; ++k)
      spans_jump_kernel<<<dim3(nb, (unsigned)wm[5]), COPY_THREADS, 0, s>>>(
          flat, m, sp, b0, olen, dst, cells, out, more, k);
  }
  return (int)cudaGetLastError();
}
