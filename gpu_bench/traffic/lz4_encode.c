/* A greedy LZ4 block encoder for the benchmark's cube writer.

   Written from the LZ4 block format description: a block is a run of
   sequences, each a token (literal count in the high nibble, match length
   less 4 in the low one, 15 meaning more bytes follow, each 255 meaning
   one more), the literals, a 2-byte little-endian offset and the match
   length's extra bytes; the last sequence holds literals only. The last
   5 bytes are literals and the last match starts 12 bytes or more before
   the end.

   The search is LZ4's fast one: a hash of 4 bytes to the last position
   seen, a step that starts at `accel` and grows by one every 64 misses,
   a match extended forward and back as far as its bytes agree.

   lz4_streams encodes `count` streams of `n` bytes each, stream k at
   src + k n, into dst + k n and stores its size in sizes[k], or 0 where
   the encoding would not be shorter than the stream. */
#include <stdint.h>
#include <string.h>

#define HASH_LOG 12
#define MIN_MATCH 4
#define MF_LIMIT 12
#define LAST_LITERALS 5
#define MAX_OFFSET 65535

static uint32_t read32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_LOG);
}

static uint8_t *put_count(uint8_t *op, int count) {
    while (count >= 255) {
        *op++ = 255;
        count -= 255;
    }
    *op++ = (uint8_t)count;
    return op;
}

/* One sequence's literals src[anchor, pos) and, where len > 0, its match
   (offset, len). -> the end of what was written, or NULL past `oend`. */
static uint8_t *put_sequence(uint8_t *op, uint8_t *oend, const uint8_t *lit,
                             int nlit, int offset, int len) {
    long need = 1 + nlit + nlit / 255 + 1 + (len ? 2 + len / 255 + 1 : 0);
    if (op + need > oend) return NULL;
    uint8_t *token = op++;
    *token = (uint8_t)((nlit >= 15 ? 15 : nlit) << 4);
    if (nlit >= 15) op = put_count(op, nlit - 15);
    memcpy(op, lit, (size_t)nlit);
    op += nlit;
    if (len) {
        int ml = len - MIN_MATCH;
        *op++ = (uint8_t)(offset & 255);
        *op++ = (uint8_t)(offset >> 8);
        *token |= (uint8_t)(ml >= 15 ? 15 : ml);
        if (ml >= 15) op = put_count(op, ml - 15);
    }
    return op;
}

/* src[0, n) as one LZ4 block in dst[0, cap). -> its size, or 0 where it
   does not fit. */
int lz4_block(const uint8_t *src, int n, uint8_t *dst, int cap, int accel) {
    int32_t table[1 << HASH_LOG];
    uint8_t *op = dst, *oend = dst + cap;
    int anchor = 0;
    if (n >= MF_LIMIT + 1) {
        int last = n - MF_LIMIT, limit = n - LAST_LITERALS;
        int pos = 1;
        unsigned misses = (unsigned)accel << 6;
        for (int i = 0; i < (1 << HASH_LOG); i++) table[i] = -1;
        table[hash4(read32(src))] = 0;
        while (pos <= last) {
            uint32_t h = hash4(read32(src + pos));
            int cand = table[h];
            table[h] = pos;
            if (cand < 0 || pos - cand > MAX_OFFSET ||
                read32(src + cand) != read32(src + pos)) {
                pos += (int)(misses++ >> 6);
                continue;
            }
            while (pos > anchor && cand > 0 && src[pos - 1] == src[cand - 1]) {
                pos--;
                cand--;
            }
            int len = MIN_MATCH;
            while (pos + len < limit && src[cand + len] == src[pos + len])
                len++;
            op = put_sequence(op, oend, src + anchor, pos - anchor,
                              pos - cand, len);
            if (!op) return 0;
            pos += len;
            anchor = pos;
            if (pos - 2 >= 0 && pos - 2 <= last)
                table[hash4(read32(src + pos - 2))] = pos - 2;
            misses = (unsigned)accel << 6;
        }
    }
    op = put_sequence(op, oend, src + anchor, n - anchor, 0, 0);
    return op ? (int)(op - dst) : 0;
}

int lz4_streams(const uint8_t *src, int count, int n, int accel,
                uint8_t *dst, int32_t *sizes) {
    for (int k = 0; k < count; k++)
        sizes[k] = lz4_block(src + (long)k * n, n, dst + (long)k * n, n - 1,
                             accel);
    return 0;
}
