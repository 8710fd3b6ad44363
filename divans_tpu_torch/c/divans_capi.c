/* C implementation of the divans streaming FFI (see divans/ffi.h), bound
 * to the PyTorch port, divans_tpu_torch.
 *
 * Architecture: a thin native shim that embeds CPython and drives the
 * port's streaming adapters (divans_tpu_torch/io_adapters.py) through
 * divans_tpu_torch/capi_support.py.  The adapters run on the host, a
 * metablock at a time, and launch no kernel.  The upstream codec
 * implements this layer in Rust over its Rust engine (src/ffi/mod.rs,
 * compressor.rs, decompressor.rs); this one is C over the port's Python
 * host codec: the same wire bytes, the same API.
 *
 * Thread-safety: each state owns independent Python objects; calls
 * acquire the GIL, so states may be used from different threads (one
 * thread per state at a time).
 */
#include "divans/ffi.h"

#include <Python.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ init */

static int g_python_inited = 0;

static int ensure_python(void) {
    if (g_python_inited) return 0;
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
    }
    PyGILState_STATE g = PyGILState_Ensure();
    const char* extra = getenv("DIVANS_TPU_PYTHONPATH");
    if (extra && extra[0]) {
        PyObject* sys_path = PySys_GetObject("path"); /* borrowed */
        PyObject* p = PyUnicode_FromString(extra);
        if (sys_path && p) PyList_Insert(sys_path, 0, p);
        Py_XDECREF(p);
    }
    g_python_inited = 1;
    PyGILState_Release(g);
    return 0;
}

/* option selector -> DivansOptions field (NULL = accepted, ignored) */
static const char* option_field(DivansOptionSelect sel) {
    switch (sel) {
        case DIVANS_OPTION_QUALITY: return "quality";
        case DIVANS_OPTION_WINDOW_SIZE: return "window_size";
        case DIVANS_OPTION_LGBLOCK: return "lgblock";
        case DIVANS_OPTION_DYNAMIC_CONTEXT_MIXING: return "dynamic_context_mixing";
        case DIVANS_OPTION_USE_CONTEXT_MAP: return "use_context_map";
        case DIVANS_OPTION_FORCE_STRIDE_VALUE: return "force_stride_value";
        case DIVANS_OPTION_STRIDE_DETECTION_QUALITY: return "stride_detection_quality";
        case DIVANS_OPTION_PRIOR_DEPTH: return "prior_depth";
        case DIVANS_OPTION_SPEED_DETECTION_QUALITY: return "speed_detection_quality";
        case DIVANS_OPTION_PRIOR_BITMASK_DETECTION: return "prior_bitmask_detection";
        default: return NULL;
    }
}

struct DivansCompressorState {
    PyObject* opts;    /* dict of option kwargs */
    PyObject* writer;  /* CompressorWriter, created lazily */
    PyObject* sink;    /* io.BytesIO */
    size_t drained;    /* bytes of sink already handed to the caller */
    int finished;
};

struct DivansDecompressorState {
    PyObject* src;     /* _PushSource with .buf bytearray */
    PyObject* reader;  /* DecompressorReader(partial=True) */
    PyObject* pending; /* bytes not yet copied out */
    size_t pending_off;
};

/* run a module-level helper from divans_tpu_torch.capi_support */
static PyObject* capi_call(const char* fn, PyObject* args) {
    PyObject* mod = PyImport_ImportModule("divans_tpu_torch.capi_support");
    if (!mod) return NULL;
    PyObject* f = PyObject_GetAttrString(mod, fn);
    Py_DECREF(mod);
    if (!f) return NULL;
    PyObject* r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    return r;
}

/* Last structured error code (divans_tpu_torch.errors.ErrCode) captured from
 * the Python exception that produced the most recent DIVANS_FAILURE on
 * THIS THREAD — thread-local so concurrent compressors/decompressors
 * never report each other's failures.  The FFI surface of the
 * upstream codec's ErrMsg taxonomy (src/interface.rs:28-64).
 * 0 = none; 1 = generic. */
static _Thread_local int32_t g_last_err_code = 0;

int32_t divans_last_error_code(void) { return g_last_err_code; }

static DivansResult fail_clear(void) {
    if (PyErr_Occurred()) {
        PyObject *type, *value, *tb;
        PyErr_Fetch(&type, &value, &tb);
        PyErr_NormalizeException(&type, &value, &tb);
        g_last_err_code = 1; /* GENERIC */
        if (value) {
            PyObject* code = PyObject_GetAttrString(value, "code");
            if (code) {
                long c = PyLong_AsLong(code);
                if (c > 0 && c < (1L << 30)) g_last_err_code = (int32_t)c;
                Py_DECREF(code);
            }
            if (PyErr_Occurred()) PyErr_Clear(); /* no .code attr */
        }
        Py_XDECREF(type); Py_XDECREF(value); Py_XDECREF(tb);
    }
    return DIVANS_FAILURE;
}

/* -------------------------------------------------------------- compress */

struct DivansCompressorState* divans_new_compressor(void) {
    if (ensure_python()) return NULL;
    PyGILState_STATE g = PyGILState_Ensure();
    struct DivansCompressorState* st = calloc(1, sizeof(*st));
    if (st) {
        st->opts = PyDict_New();
        if (!st->opts) { free(st); st = NULL; PyErr_Clear(); }
    }
    PyGILState_Release(g);
    return st;
}

struct DivansCompressorState* divans_new_compressor_with_custom_alloc(struct CAllocator alloc) {
    (void)alloc; /* runtime-managed memory; see header */
    return divans_new_compressor();
}

DivansResult divans_set_option(struct DivansCompressorState* state,
                               DivansOptionSelect selector, uint32_t value) {
    if (!state) return DIVANS_FAILURE;
    const char* field = option_field(selector);
    if (!field) return DIVANS_SUCCESS; /* accepted, ignored (upstream parity) */
    PyGILState_STATE g = PyGILState_Ensure();
    DivansResult res = DIVANS_SUCCESS;
    PyObject* v = PyLong_FromUnsignedLong(value);
    if (!v || PyDict_SetItemString(state->opts, field, v)) res = fail_clear();
    Py_XDECREF(v);
    PyGILState_Release(g);
    return res;
}

static int ensure_writer(struct DivansCompressorState* st) {
    if (st->writer) return 0;
    PyObject* args = Py_BuildValue("(O)", st->opts);
    if (!args) return -1;
    PyObject* pair = capi_call("new_writer", args);
    Py_DECREF(args);
    if (!pair) return -1;
    st->writer = PySequence_GetItem(pair, 0);
    st->sink = PySequence_GetItem(pair, 1);
    Py_DECREF(pair);
    return (st->writer && st->sink) ? 0 : -1;
}

static DivansResult drain_sink(struct DivansCompressorState* st,
                               uint8_t* out, size_t out_size, size_t* out_off,
                               int flushing) {
    PyObject* val = PyObject_CallMethod(st->sink, "getvalue", NULL);
    if (!val) return fail_clear();
    char* buf; Py_ssize_t n;
    if (PyBytes_AsStringAndSize(val, &buf, &n)) { Py_DECREF(val); return fail_clear(); }
    size_t avail = (size_t)n - st->drained;
    size_t space = out_size - *out_off;
    size_t take = avail < space ? avail : space;
    memcpy(out + *out_off, buf + st->drained, take);
    st->drained += take;
    *out_off += take;
    int leftover = st->drained < (size_t)n;
    Py_DECREF(val);
    if (leftover) return DIVANS_NEEDS_MORE_OUTPUT;
    return flushing ? DIVANS_SUCCESS : DIVANS_NEEDS_MORE_INPUT;
}

DivansResult divans_encode(struct DivansCompressorState* state,
                           const uint8_t* in, size_t in_size, size_t* in_off,
                           uint8_t* out, size_t out_size, size_t* out_off) {
    if (!state || !in_off || !out_off) return DIVANS_FAILURE;
    PyGILState_STATE g = PyGILState_Ensure();
    DivansResult res;
    if (ensure_writer(state)) { res = fail_clear(); goto done; }
    if (*in_off < in_size) {
        PyObject* chunk = PyBytes_FromStringAndSize(
            (const char*)in + *in_off, (Py_ssize_t)(in_size - *in_off));
        PyObject* r = chunk ? PyObject_CallMethod(state->writer, "write", "O", chunk) : NULL;
        Py_XDECREF(chunk);
        if (!r) { res = fail_clear(); goto done; }
        Py_DECREF(r);
        *in_off = in_size;
    }
    res = drain_sink(state, out, out_size, out_off, 0);
done:
    PyGILState_Release(g);
    return res;
}

DivansResult divans_encode_flush(struct DivansCompressorState* state,
                                 uint8_t* out, size_t out_size, size_t* out_off) {
    if (!state || !out_off) return DIVANS_FAILURE;
    PyGILState_STATE g = PyGILState_Ensure();
    DivansResult res;
    if (ensure_writer(state)) { res = fail_clear(); goto done; }
    if (!state->finished) {
        PyObject* r = PyObject_CallMethod(state->writer, "flush_final", NULL);
        if (!r) { res = fail_clear(); goto done; }
        Py_DECREF(r);
        state->finished = 1;
    }
    res = drain_sink(state, out, out_size, out_off, 1);
done:
    PyGILState_Release(g);
    return res;
}

void divans_free_compressor(struct DivansCompressorState* st) {
    if (!st) return;
    PyGILState_STATE g = PyGILState_Ensure();
    Py_XDECREF(st->opts);
    Py_XDECREF(st->writer);
    Py_XDECREF(st->sink);
    PyGILState_Release(g);
    free(st);
}

/* ------------------------------------------------------------ decompress */

struct DivansDecompressorState* divans_new_decompressor(void) {
    struct CAllocator a = {0, 0, 0};
    return divans_new_decompressor_with_custom_alloc(a, 0);
}

struct DivansDecompressorState* divans_new_decompressor_with_custom_alloc(struct CAllocator alloc, uint8_t skip_crc) {
    (void)alloc; (void)skip_crc;
    if (ensure_python()) return NULL;
    PyGILState_STATE g = PyGILState_Ensure();
    struct DivansDecompressorState* st = calloc(1, sizeof(*st));
    if (st) {
        PyObject* pair = capi_call("new_reader", NULL);
        if (pair) {
            st->src = PySequence_GetItem(pair, 0);
            st->reader = PySequence_GetItem(pair, 1);
            Py_DECREF(pair);
        }
        if (!st->src || !st->reader) {
            PyErr_Clear();
            Py_XDECREF(st->src); Py_XDECREF(st->reader);
            free(st); st = NULL;
        }
    }
    PyGILState_Release(g);
    return st;
}

DivansResult divans_decode(struct DivansDecompressorState* state,
                           const uint8_t* in, size_t in_size, size_t* in_off,
                           uint8_t* out, size_t out_size, size_t* out_off) {
    if (!state || !in_off || !out_off) return DIVANS_FAILURE;
    PyGILState_STATE g = PyGILState_Ensure();
    DivansResult res = DIVANS_FAILURE;
    /* feed the push-source */
    if (*in_off < in_size) {
        PyObject* buf = PyObject_GetAttrString(state->src, "buf");
        PyObject* chunk = PyBytes_FromStringAndSize(
            (const char*)in + *in_off, (Py_ssize_t)(in_size - *in_off));
        PyObject* r = (buf && chunk) ? PyObject_CallMethod(buf, "extend", "O", chunk) : NULL;
        Py_XDECREF(buf); Py_XDECREF(chunk);
        if (!r) { res = fail_clear(); goto done; }
        Py_DECREF(r);
        *in_off = in_size;
    }
    while (*out_off < out_size) {
        if (!state->pending) {
            PyObject* piece = PyObject_CallMethod(
                state->reader, "read", "n", (Py_ssize_t)(out_size - *out_off));
            if (!piece) { res = fail_clear(); goto done; }
            if (PyBytes_GET_SIZE(piece) == 0) {
                Py_DECREF(piece);
                PyObject* eof = PyObject_GetAttrString(state->reader, "_eof");
                int is_eof = eof && PyObject_IsTrue(eof);
                Py_XDECREF(eof);
                res = is_eof ? DIVANS_SUCCESS : DIVANS_NEEDS_MORE_INPUT;
                goto done;
            }
            state->pending = piece;
            state->pending_off = 0;
        }
        {
            char* pbuf; Py_ssize_t pn;
            if (PyBytes_AsStringAndSize(state->pending, &pbuf, &pn)) {
                res = fail_clear(); goto done;
            }
            size_t avail = (size_t)pn - state->pending_off;
            size_t space = out_size - *out_off;
            size_t take = avail < space ? avail : space;
            memcpy(out + *out_off, pbuf + state->pending_off, take);
            *out_off += take;
            state->pending_off += take;
            if (state->pending_off == (size_t)pn) {
                Py_CLEAR(state->pending);
            }
        }
    }
    res = DIVANS_NEEDS_MORE_OUTPUT;
done:
    PyGILState_Release(g);
    return res;
}

void divans_free_decompressor(struct DivansDecompressorState* st) {
    if (!st) return;
    PyGILState_STATE g = PyGILState_Ensure();
    Py_XDECREF(st->src);
    Py_XDECREF(st->reader);
    Py_XDECREF(st->pending);
    PyGILState_Release(g);
    free(st);
}
