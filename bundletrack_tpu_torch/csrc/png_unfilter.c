/* Undo PNG's per-row filters (PNG specification, section 9: None, Sub, Up,
 * Average, Paeth) for a non-interlaced image.  Host code, built with the
 * host C compiler and called through ctypes, which releases the Python
 * interpreter lock for the call, so decode threads run in parallel.
 *
 * raw: zlib's output, h rows of one filter-type byte followed by `stride`
 *      bytes (h * (stride + 1) bytes in all).
 * bpp: bytes per complete pixel, at least 1 (the left neighbour's offset).
 * out: h * stride bytes, the unfiltered rows.
 *
 * Returns -1, or the index of the first row whose filter type is not 0-4
 * (the rows before it are unfiltered).
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

int unfilter(const uint8_t *raw, int h, int stride, int bpp, uint8_t *out) {
    for (int y = 0; y < h; ++y) {
        const uint8_t *line = raw + (size_t)y * (size_t)(stride + 1);
        const uint8_t *in = line + 1;
        uint8_t *cur = out + (size_t)y * (size_t)stride;
        /* the row above; the first row's is all zeros */
        const uint8_t *prev = y > 0 ? cur - stride : NULL;
        int lead = bpp < stride ? bpp : stride; /* bytes with no left neighbour */
        int x;
        switch (line[0]) {
        case 0:
            memcpy(cur, in, (size_t)stride);
            break;
        case 1:
            memcpy(cur, in, (size_t)lead);
            for (x = lead; x < stride; ++x) cur[x] = (uint8_t)(in[x] + cur[x - bpp]);
            break;
        case 2:
            if (prev == NULL) {
                memcpy(cur, in, (size_t)stride);
            } else {
                for (x = 0; x < stride; ++x) cur[x] = (uint8_t)(in[x] + prev[x]);
            }
            break;
        case 3:
            if (prev == NULL) {
                memcpy(cur, in, (size_t)lead);
                for (x = lead; x < stride; ++x) cur[x] = (uint8_t)(in[x] + (cur[x - bpp] >> 1));
            } else {
                for (x = 0; x < lead; ++x) cur[x] = (uint8_t)(in[x] + (prev[x] >> 1));
                for (x = lead; x < stride; ++x)
                    cur[x] = (uint8_t)(in[x] + ((cur[x - bpp] + prev[x]) >> 1));
            }
            break;
        case 4:
            if (prev == NULL) { /* b = c = 0: the predictor is the left byte */
                memcpy(cur, in, (size_t)lead);
                for (x = lead; x < stride; ++x) cur[x] = (uint8_t)(in[x] + cur[x - bpp]);
            } else {
                for (x = 0; x < lead; ++x) cur[x] = (uint8_t)(in[x] + prev[x]);
                for (x = lead; x < stride; ++x)
                    cur[x] = (uint8_t)(in[x] + paeth(cur[x - bpp], prev[x], prev[x - bpp]));
            }
            break;
        default:
            return y;
        }
    }
    return -1;
}
