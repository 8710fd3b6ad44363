/* divans C API of the PyTorch port (divans_tpu_torch): a drop-in surface
 * of the upstream divans C FFI (c/divans/ffi.h upstream).  The same
 * result codes, option selectors and zlib-style streaming entry points,
 * byte for byte the ABI of the repository's c/divans/ffi.h; underneath,
 * an embedded CPython drives the port's streaming adapters, which run on
 * the host and launch no kernel.
 *
 * Link against libdivans_tpu_torch_capi.  If the divans_tpu_torch
 * package is not on the default Python path, set DIVANS_TPU_PYTHONPATH
 * before the first call.  The embedded interpreter finds its
 * site-packages through the first python3 on PATH: put the interpreter
 * that has torch and numpy first there.
 */
#ifndef _DIVANS_TPU_H_
#define _DIVANS_TPU_H_
#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef uint8_t DivansResult;

#define DIVANS_SUCCESS ((uint8_t)0)
#define DIVANS_NEEDS_MORE_INPUT ((uint8_t)1)
#define DIVANS_NEEDS_MORE_OUTPUT ((uint8_t)2)
#define DIVANS_FAILURE ((uint8_t)3)

/* EXTENSION beyond the upstream ABI: the structured error code
 * (divans_tpu_torch.errors.ErrCode — the upstream codec's internal
 * ErrMsg taxonomy, interface.rs:28-64) behind the most recent DIVANS_FAILURE.
 * 0 = none since startup; 1 = generic.  Container codes are 10..39
 * (10 bad magic, 12 bad window, 16 truncated frame, 19 crc mismatch,
 * ...), codec-stream codes 40+ (41 distance beyond window, ...). */
int32_t divans_last_error_code(void);

typedef uint8_t DivansOptionSelect;

#define DIVANS_OPTION_QUALITY 1
#define DIVANS_OPTION_WINDOW_SIZE 2
#define DIVANS_OPTION_LGBLOCK 3
#define DIVANS_OPTION_DYNAMIC_CONTEXT_MIXING 4
#define DIVANS_OPTION_USE_BROTLI_COMMAND_SELECTION 5
#define DIVANS_OPTION_USE_BROTLI_BITSTREAM 6
#define DIVANS_OPTION_USE_CONTEXT_MAP 7
#define DIVANS_OPTION_LITERAL_ADAPTATION_CM_HIGH 8
#define DIVANS_OPTION_FORCE_STRIDE_VALUE 9
#define DIVANS_OPTION_STRIDE_DETECTION_QUALITY 10
#define DIVANS_OPTION_PRIOR_DEPTH 11
#define DIVANS_OPTION_LITERAL_ADAPTATION_STRIDE_HIGH 12
#define DIVANS_OPTION_LITERAL_ADAPTATION_CM_LOW 13
#define DIVANS_OPTION_LITERAL_ADAPTATION_STRIDE_LOW 14
#define DIVANS_OPTION_BROTLI_LITERAL_BYTE_SCORE 15
#define DIVANS_OPTION_SPEED_DETECTION_QUALITY 16
#define DIVANS_OPTION_PRIOR_BITMASK_DETECTION 17
#define DIVANS_OPTION_Q9_5 18
#define DIVANS_OPTION_FORCE_LITERAL_CONTEXT_MODE 19

/* Custom allocators are accepted for ABI compatibility with the
 * upstream codec; the embedded runtime manages its own memory, so the
 * callbacks are not invoked. */
struct CAllocator {
    void* (*alloc_func)(void * opaque, size_t length);
    void (*free_func)(void * opaque, void * mfd);
    void * opaque;
};
struct DivansDecompressorState;
struct DivansCompressorState;

struct DivansCompressorState* divans_new_compressor(void);
struct DivansCompressorState* divans_new_compressor_with_custom_alloc(struct CAllocator alloc);
DivansResult divans_set_option(struct DivansCompressorState* state,
                               DivansOptionSelect selector, uint32_t value);
DivansResult divans_encode(struct DivansCompressorState* state,
                           const uint8_t *input_buf_ptr, size_t input_size,
                           size_t *input_offset,
                           uint8_t *output_buf_ptr, size_t output_size,
                           size_t *output_offset);
DivansResult divans_encode_flush(struct DivansCompressorState* state,
                                 uint8_t *output_buf_ptr, size_t output_size,
                                 size_t *output_offset);
void divans_free_compressor(struct DivansCompressorState* mfd);

struct DivansDecompressorState* divans_new_decompressor(void);
struct DivansDecompressorState* divans_new_decompressor_with_custom_alloc(struct CAllocator alloc, uint8_t skip_crc);
DivansResult divans_decode(struct DivansDecompressorState* state,
                           const uint8_t *input_buf_ptr, size_t input_size,
                           size_t *input_offset,
                           uint8_t *output_buf_ptr, size_t output_size,
                           size_t *output_offset);
void divans_free_decompressor(struct DivansDecompressorState* mfd);

#ifdef __cplusplus
}
#endif
#endif
