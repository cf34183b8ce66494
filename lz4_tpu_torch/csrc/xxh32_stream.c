/* XXH32 for the port's host frame layer: the one-shot hash (header checksum
 * byte, block and content checksums) and the stripe rounds of
 * XXH32State.update, so that a checksum over a long stream costs a pass of
 * native code rather than a Python loop per 16 bytes.  Written from the
 * public xxHash algorithm definition; compiled with cc into one host
 * library, plain C, bound with ctypes.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define P32_1 2654435761u
#define P32_2 2246822519u
#define P32_3 3266489917u
#define P32_4 668265263u
#define P32_5 374761393u

static inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

static inline uint32_t read32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4); /* little-endian hosts only (x86-64/arm64) */
    return v;
}

static inline uint32_t round32(uint32_t acc, const uint8_t *p) {
    return rotl32(acc + read32(p) * P32_2, 13) * P32_1;
}

/* One-shot XXH32 of p[0:len). */
uint32_t lz4tt_xxh32(const uint8_t *p, size_t len, uint32_t seed) {
    const uint8_t *end = p + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + P32_1 + P32_2;
        uint32_t v2 = seed + P32_2;
        uint32_t v3 = seed;
        uint32_t v4 = seed - P32_1;
        const uint8_t *lim = end - 16;
        do {
            v1 = round32(v1, p);
            v2 = round32(v2, p + 4);
            v3 = round32(v3, p + 8);
            v4 = round32(v4, p + 12);
            p += 16;
        } while (p <= lim);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + P32_5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        h = rotl32(h + read32(p) * P32_3, 17) * P32_4;
        p += 4;
    }
    while (p < end) {
        h = rotl32(h + (*p) * P32_5, 11) * P32_1;
        p++;
    }
    h ^= h >> 15; h *= P32_2;
    h ^= h >> 13; h *= P32_3;
    h ^= h >> 16;
    return h;
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
