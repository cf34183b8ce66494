// Frame body assembly: kernel C.
//
// Replaces the Pallas kernel lz4_tpu/kernels/pack_kernel.py
// _make_pack_kernel (launched by _pack_payloads): [LE32 header | payload]
// per block at its exclusive-scan offset in one flat buffer, with the
// plaintext as payload for a stored block.
//
// What bounds it on the card: pure data movement, about 2 bytes of traffic
// per output byte, so device-memory bandwidth.  On the TPU the kernel had to
// roll, merge and read back 128-lane rows to place a payload at a byte
// offset; global memory here is byte-addressable, so one CTA per block
// copies its bytes straight to their offset, neighbouring threads on
// neighbouring bytes (coalesced).  The offsets come from a torch.cumsum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pack_kernel(const uint8_t* comp, int comp_stride,
                            const uint8_t* src, long long src_stride,
                            const int32_t* eff, const int32_t* hdr,
                            const long long* dst, const int32_t* blen,
                            uint8_t* flat) {
  const int b = blockIdx.x;
  if (blen[b] <= 0) return;  // padding row: writes nothing
  const uint32_t h = (uint32_t)hdr[b];
  const bool stored = (h & 0x80000000u) != 0;
  const uint8_t* from =
      stored ? src + (long long)b * src_stride : comp + (long long)b * comp_stride;
  uint8_t* to = flat + dst[b];
  if (threadIdx.x < 4) to[threadIdx.x] = (uint8_t)(h >> (8 * threadIdx.x));
  const int e = eff[b];
  for (int i = threadIdx.x; i < e; i += blockDim.x) to[4 + i] = from[i];
}

}  // namespace

extern "C" int lz4tt_pack(const uint8_t* comp, int comp_stride,
                          const uint8_t* src, long long src_stride,
                          const int32_t* eff, const int32_t* hdr,
                          const long long* dst, const int32_t* blen,
                          uint8_t* flat, int B, void* cuda_stream) {
  if (B > 0)
    pack_kernel<<<B, 256, 0, (cudaStream_t)cuda_stream>>>(
        comp, comp_stride, src, src_stride, eff, hdr, dst, blen, flat);
  return (int)cudaGetLastError();
}
