/* Streaming XXH32 for the port's host frame layer: the stripe rounds of
 * XXH32State.update, so that a content checksum over a long stream costs
 * a pass of native code rather than a Python loop per 16 bytes.  Compiled
 * with cc together with native/lz4t_native.c (the one-shot hash) into one
 * host library; plain C, bound with ctypes.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define P32_1 2654435761u
#define P32_2 2246822519u

static inline uint32_t round32(uint32_t acc, const uint8_t *p) {
    uint32_t lane;
    memcpy(&lane, p, 4); /* little-endian hosts only (x86-64/arm64) */
    acc += lane * P32_2;
    return ((acc << 13) | (acc >> 19)) * P32_1;
}

/* Feed every whole 16-byte stripe of p[0:len) into the accumulators v[4];
 * returns the number of bytes consumed (len rounded down to 16). */
size_t lz4tt_xxh32_stripes(uint32_t *v, const uint8_t *p, size_t len) {
    size_t n = len & ~(size_t)15;
    uint32_t v1 = v[0], v2 = v[1], v3 = v[2], v4 = v[3];
    for (size_t i = 0; i < n; i += 16) {
        v1 = round32(v1, p + i);
        v2 = round32(v2, p + i + 4);
        v3 = round32(v3, p + i + 8);
        v4 = round32(v4, p + i + 12);
    }
    v[0] = v1; v[1] = v2; v[2] = v3; v[3] = v4;
    return n;
}
