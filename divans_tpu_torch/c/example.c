/* Round-trip example for the C API of the PyTorch port, divans_tpu_torch
 * (mirrors the upstream codec's c/ example): compress a file, decompress,
 * verify, check the error codes of two corrupt containers, print the
 * ratio. */
#include "divans/ffi.h"
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static unsigned char* read_file(const char* path, size_t* n) {
    FILE* f = fopen(path, "rb");
    if (!f) { perror(path); exit(1); }
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    unsigned char* buf = malloc(sz);
    if (fread(buf, 1, sz, f) != (size_t)sz) { perror("read"); exit(1); }
    fclose(f);
    *n = sz;
    return buf;
}

int main(int argc, char** argv) {
    if (argc < 2) { fprintf(stderr, "usage: %s <file>\n", argv[0]); return 2; }
    size_t n;
    unsigned char* data = read_file(argv[1], &n);

    struct DivansCompressorState* c = divans_new_compressor();
    if (!c) { fprintf(stderr, "new_compressor failed\n"); return 1; }
    divans_set_option(c, DIVANS_OPTION_QUALITY, 10);
    divans_set_option(c, DIVANS_OPTION_DYNAMIC_CONTEXT_MIXING, 1);

    size_t cap = n * 2 + 1024, clen = 0, in_off = 0;
    unsigned char* comp = malloc(cap);
    DivansResult r = divans_encode(c, data, n, &in_off, comp, cap, &clen);
    if (r == DIVANS_FAILURE) { fprintf(stderr, "encode failed\n"); return 1; }
    r = divans_encode_flush(c, comp, cap, &clen);
    if (r != DIVANS_SUCCESS) { fprintf(stderr, "flush failed: %d\n", r); return 1; }
    divans_free_compressor(c);

    struct DivansDecompressorState* d = divans_new_decompressor();
    unsigned char* out = malloc(n + 1024);
    size_t din = 0, dout = 0;
    r = divans_decode(d, comp, clen, &din, out, n + 1024, &dout);
    if (r != DIVANS_SUCCESS) { fprintf(stderr, "decode failed: %d\n", r); return 1; }
    divans_free_decompressor(d);

    if (dout != n || memcmp(out, data, n) != 0) {
        fprintf(stderr, "MISMATCH\n");
        return 1;
    }

    /* structured error taxonomy (extension): corrupt streams must fail
     * with DISTINCT codes per check — magic (10) vs crc (19) */
    {
        unsigned char* bad = malloc(clen);
        size_t bin, bout;
        int32_t code_magic, code_crc;
        struct DivansDecompressorState* d2;

        memcpy(bad, comp, clen);
        bad[0] = 0;                              /* magic */
        d2 = divans_new_decompressor();
        bin = bout = 0;
        r = divans_decode(d2, bad, clen, &bin, out, n + 1024, &bout);
        if (r != DIVANS_FAILURE) { fprintf(stderr, "magic not caught\n"); return 1; }
        code_magic = divans_last_error_code();
        divans_free_decompressor(d2);

        memcpy(bad, comp, clen);
        bad[clen - 8] ^= 0xFF;                   /* stored crc */
        d2 = divans_new_decompressor();
        bin = bout = 0;
        r = divans_decode(d2, bad, clen, &bin, out, n + 1024, &bout);
        if (r != DIVANS_FAILURE) { fprintf(stderr, "crc not caught\n"); return 1; }
        code_crc = divans_last_error_code();
        divans_free_decompressor(d2);
        free(bad);

        if (code_magic == 0 || code_crc == 0 || code_magic == code_crc) {
            fprintf(stderr, "error codes not distinct: magic=%d crc=%d\n",
                    code_magic, code_crc);
            return 1;
        }
    }
    printf("ok %zu -> %zu (ratio %.4f)\n", n, clen, (double)clen / (double)n);
    return 0;
}
