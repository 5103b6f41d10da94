/* Native hot-path core of the port's master (copy of the repo-root
 * csrc/hotcore.c): the frame families that carry most of the master's
 * route and stream CPU, in C.
 *
 * Twin of xllm_service_tpu_torch/common/native.py: every entry point here
 * has a mandatory pure-Python path at its call site, and
 * tests/test_torch_native_hotcore.py asserts byte-for-byte parity between
 * the two (and with the reference's pure paths):
 *
 *   - hc_json_bytes / hc_sse_data_frame / hc_sse_event_frame:
 *     compact JSON serialization + SSE `data: ...\n\n` framing, parity
 *     with json.dumps(obj, ensure_ascii=False, separators=(",", ":"))
 *     (http_service/service.py, the SSE drain).
 *   - hc_packb / hc_unpackb / hc_pack_b64 / hc_unpack_b64:
 *     msgpack encode/decode, parity with msgpack.packb(use_bin_type=True)
 *     / msgpack.unpackb(raw=False) (rpc/msgpack_lite.py), plus the fused
 *     base64(msgpack) form of the KV and load frames (rpc/wire.py).
 *   - hc_rendezvous: the blake2b-8 highest-random-weight walk of
 *     multimaster/ownership.py (one native call over the member set).
 *   - hc_tok_encode: SimpleTokenizer.encode's utf8-byte+offset id map.
 *
 * Error contract: every PyObject* entry point returns NULL with an
 * exception set for ANY input it does not support bit-exactly (int
 * subclasses, ext types, lone surrogates, non-canonical base64, depth
 * over the guard). The loader's wrappers catch, discard, and rerun the
 * pure-Python path, which either handles the input or raises the
 * canonical library error. Native is therefore an all-or-nothing fast
 * path: it never produces bytes the Python path would not.
 *
 * All entry points are called via ctypes.PyDLL — the GIL is held, so
 * CPython C-API use is safe and no locking is needed.
 *
 * Build: common/native.py compiles this file with the host C compiler
 * against the running Python's headers at first use, into build/native/
 * (a name hashed from the source); XLLM_NATIVE=0 keeps every call site
 * on its pure-Python path.
 */

#include <Python.h>

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* BLAKE2b core (RFC 7693), identical to csrc/blockhash.c — duplicated
 * rather than cross-linked so each .so stays a single-file build.      */
/* ------------------------------------------------------------------ */

static const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

typedef struct {
    uint64_t h[8];
    uint64_t t0, t1;
    uint8_t buf[128];
    size_t buflen;
    size_t outlen;
} b2b_state;

static inline uint64_t rotr64(uint64_t x, unsigned n) {
    return (x >> n) | (x << (64 - n));
}

static inline uint64_t load64le(const uint8_t *p) {
    return (uint64_t)p[0] | ((uint64_t)p[1] << 8) | ((uint64_t)p[2] << 16) |
           ((uint64_t)p[3] << 24) | ((uint64_t)p[4] << 32) |
           ((uint64_t)p[5] << 40) | ((uint64_t)p[6] << 48) |
           ((uint64_t)p[7] << 56);
}

#define B2B_G(a, b, c, d, x, y)                                               \
    do {                                                                      \
        v[a] = v[a] + v[b] + (x);                                             \
        v[d] = rotr64(v[d] ^ v[a], 32);                                       \
        v[c] = v[c] + v[d];                                                   \
        v[b] = rotr64(v[b] ^ v[c], 24);                                       \
        v[a] = v[a] + v[b] + (y);                                             \
        v[d] = rotr64(v[d] ^ v[a], 16);                                       \
        v[c] = v[c] + v[d];                                                   \
        v[b] = rotr64(v[b] ^ v[c], 63);                                       \
    } while (0)

static void b2b_compress(b2b_state *S, const uint8_t block[128], int last) {
    uint64_t v[16], m[16];
    int i;
    for (i = 0; i < 8; i++) {
        v[i] = S->h[i];
        v[i + 8] = B2B_IV[i];
    }
    v[12] ^= S->t0;
    v[13] ^= S->t1;
    if (last)
        v[14] = ~v[14];
    for (i = 0; i < 16; i++)
        m[i] = load64le(block + 8 * i);
    for (i = 0; i < 12; i++) {
        const uint8_t *s = B2B_SIGMA[i];
        B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (i = 0; i < 8; i++)
        S->h[i] ^= v[i] ^ v[i + 8];
}

static void b2b_update(b2b_state *S, const uint8_t *in, size_t inlen) {
    while (inlen > 0) {
        if (S->buflen == 128) {
            S->t0 += 128;
            if (S->t0 < 128)
                S->t1++;
            b2b_compress(S, S->buf, 0);
            S->buflen = 0;
        }
        size_t n = 128 - S->buflen;
        if (n > inlen)
            n = inlen;
        memcpy(S->buf + S->buflen, in, n);
        S->buflen += n;
        in += n;
        inlen -= n;
    }
}

static void b2b_init(b2b_state *S, size_t outlen) {
    int i;
    memset(S, 0, sizeof(*S));
    for (i = 0; i < 8; i++)
        S->h[i] = B2B_IV[i];
    S->h[0] ^= 0x01010000ULL ^ (uint64_t)outlen;
    S->outlen = outlen;
}

static void b2b_final(b2b_state *S, uint8_t *out) {
    size_t i;
    S->t0 += S->buflen;
    if (S->t0 < S->buflen)
        S->t1++;
    memset(S->buf + S->buflen, 0, 128 - S->buflen);
    b2b_compress(S, S->buf, 1);
    for (i = 0; i < S->outlen; i++)
        out[i] = (uint8_t)(S->h[i >> 3] >> (8 * (i & 7)));
}

/* ------------------------------------------------------------------ */
/* Growable output buffer.                                             */
/* ------------------------------------------------------------------ */

typedef struct {
    char *p;
    size_t len, cap;
    int err; /* sticky: 1 = OOM */
} hc_buf;

static int buf_init(hc_buf *b, size_t cap) {
    b->p = (char *)PyMem_Malloc(cap);
    b->len = 0;
    b->cap = cap;
    b->err = b->p == NULL;
    return b->err ? -1 : 0;
}

static void buf_free(hc_buf *b) {
    if (b->p)
        PyMem_Free(b->p);
    b->p = NULL;
}

static int buf_grow(hc_buf *b, size_t need) {
    size_t cap = b->cap;
    while (cap - b->len < need)
        cap = cap < 4096 ? cap * 2 : cap + cap / 2;
    char *np = (char *)PyMem_Realloc(b->p, cap);
    if (np == NULL) {
        b->err = 1;
        return -1;
    }
    b->p = np;
    b->cap = cap;
    return 0;
}

static inline int buf_reserve(hc_buf *b, size_t need) {
    if (b->err)
        return -1;
    if (b->cap - b->len < need)
        return buf_grow(b, need);
    return 0;
}

static inline void buf_put(hc_buf *b, const char *src, size_t n) {
    if (buf_reserve(b, n) < 0)
        return;
    memcpy(b->p + b->len, src, n);
    b->len += n;
}

static inline void buf_putc(hc_buf *b, char c) {
    if (buf_reserve(b, 1) < 0)
        return;
    b->p[b->len++] = c;
}

/* "This input is valid but outside the native subset — rerun on the
 * pure-Python path." The loader treats any exception as this signal. */
static void *unsupported(const char *what) {
    PyErr_Format(PyExc_TypeError, "hotcore: unsupported input (%s)", what);
    return NULL;
}

#define HC_MAX_DEPTH 64

/* ------------------------------------------------------------------ */
/* JSON serializer: parity with                                        */
/*   json.dumps(obj, ensure_ascii=False, separators=(",", ":"))        */
/* ------------------------------------------------------------------ */

static const char HEXDIG[] = "0123456789abcdef";

static int json_write_str(hc_buf *b, PyObject *s) {
    Py_ssize_t n;
    const char *u = PyUnicode_AsUTF8AndSize(s, &n);
    if (u == NULL)
        return -1; /* lone surrogate: UnicodeEncodeError -> fallback */
    buf_putc(b, '"');
    Py_ssize_t run = 0, i = 0;
    for (i = 0; i < n; i++) {
        unsigned char c = (unsigned char)u[i];
        /* ensure_ascii=False: only '"', '\\' and controls < 0x20 are
         * escaped; everything else (incl. UTF-8 multibyte) passes raw. */
        if (c >= 0x20 && c != '"' && c != '\\') {
            run++;
            continue;
        }
        if (run)
            buf_put(b, u + i - run, (size_t)run);
        run = 0;
        switch (c) {
        case '"':
            buf_put(b, "\\\"", 2);
            break;
        case '\\':
            buf_put(b, "\\\\", 2);
            break;
        case '\b':
            buf_put(b, "\\b", 2);
            break;
        case '\t':
            buf_put(b, "\\t", 2);
            break;
        case '\n':
            buf_put(b, "\\n", 2);
            break;
        case '\f':
            buf_put(b, "\\f", 2);
            break;
        case '\r':
            buf_put(b, "\\r", 2);
            break;
        default: {
            char esc[6] = {'\\', 'u', '0', '0', HEXDIG[c >> 4],
                           HEXDIG[c & 15]};
            buf_put(b, esc, 6);
        }
        }
    }
    if (run)
        buf_put(b, u + n - run, (size_t)run);
    buf_putc(b, '"');
    return 0;
}

static int json_write_float(hc_buf *b, double v) {
    if (Py_IS_NAN(v)) {
        buf_put(b, "NaN", 3);
        return 0;
    }
    if (Py_IS_INFINITY(v)) {
        if (v < 0)
            buf_put(b, "-Infinity", 9);
        else
            buf_put(b, "Infinity", 8);
        return 0;
    }
    /* Exactly float.__repr__, which is exactly what json.dumps emits. */
    char *s = PyOS_double_to_string(v, 'r', 0, Py_DTSF_ADD_DOT_0, NULL);
    if (s == NULL)
        return -1;
    buf_put(b, s, strlen(s));
    PyMem_Free(s);
    return 0;
}

static int json_write_long(hc_buf *b, PyObject *obj) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (v == -1 && !overflow && PyErr_Occurred())
        return -1;
    if (!overflow) {
        char tmp[24];
        int n = snprintf(tmp, sizeof(tmp), "%lld", v);
        buf_put(b, tmp, (size_t)n);
        return 0;
    }
    /* Arbitrary-size int: same digits as int.__repr__. */
    PyObject *r = PyLong_Type.tp_repr(obj);
    if (r == NULL)
        return -1;
    Py_ssize_t n;
    const char *u = PyUnicode_AsUTF8AndSize(r, &n);
    if (u == NULL) {
        Py_DECREF(r);
        return -1;
    }
    buf_put(b, u, (size_t)n);
    Py_DECREF(r);
    return 0;
}

static int json_write(hc_buf *b, PyObject *obj, int depth) {
    if (depth > HC_MAX_DEPTH) {
        unsupported("nesting depth");
        return -1;
    }
    if (obj == Py_None) {
        buf_put(b, "null", 4);
        return 0;
    }
    if (obj == Py_True) {
        buf_put(b, "true", 4);
        return 0;
    }
    if (obj == Py_False) {
        buf_put(b, "false", 5);
        return 0;
    }
    if (PyUnicode_CheckExact(obj))
        return json_write_str(b, obj);
    if (PyLong_CheckExact(obj))
        return json_write_long(b, obj);
    if (PyFloat_CheckExact(obj))
        return json_write_float(b, PyFloat_AS_DOUBLE(obj));
    if (PyDict_CheckExact(obj)) {
        buf_putc(b, '{');
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        int first = 1;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            if (!PyUnicode_CheckExact(k)) {
                unsupported("non-str dict key");
                return -1;
            }
            if (!first)
                buf_putc(b, ',');
            first = 0;
            if (json_write_str(b, k) < 0)
                return -1;
            buf_putc(b, ':');
            if (json_write(b, v, depth + 1) < 0)
                return -1;
        }
        buf_putc(b, '}');
        return 0;
    }
    if (PyList_CheckExact(obj) || PyTuple_CheckExact(obj)) {
        buf_putc(b, '[');
        Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
        PyObject **items = PySequence_Fast_ITEMS(obj);
        for (Py_ssize_t i = 0; i < n; i++) {
            if (i)
                buf_putc(b, ',');
            if (json_write(b, items[i], depth + 1) < 0)
                return -1;
        }
        buf_putc(b, ']');
        return 0;
    }
    /* Subclasses, enums, dataclasses, ... -> Python encoder. */
    unsupported(Py_TYPE(obj)->tp_name);
    return -1;
}

static PyObject *buf_to_bytes(hc_buf *b) {
    if (b->err) {
        buf_free(b);
        if (!PyErr_Occurred())
            PyErr_NoMemory();
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(b->p, (Py_ssize_t)b->len);
    buf_free(b);
    return out;
}

PyObject *hc_json_bytes(PyObject *obj) {
    hc_buf b;
    if (buf_init(&b, 256) < 0)
        return PyErr_NoMemory();
    if (json_write(&b, obj, 0) < 0) {
        buf_free(&b);
        return NULL;
    }
    return buf_to_bytes(&b);
}

/* SSE data frame: b"data: " + json + b"\n\n" (service.py _respond). */
PyObject *hc_sse_data_frame(PyObject *obj) {
    hc_buf b;
    if (buf_init(&b, 256) < 0)
        return PyErr_NoMemory();
    buf_put(&b, "data: ", 6);
    if (json_write(&b, obj, 0) < 0) {
        buf_free(&b);
        return NULL;
    }
    buf_put(&b, "\n\n", 2);
    return buf_to_bytes(&b);
}

/* SSE named-event frame: b"event: <name>\ndata: <json>\n\n". */
PyObject *hc_sse_event_frame(PyObject *name, PyObject *obj) {
    if (!PyUnicode_CheckExact(name))
        return unsupported("event name");
    Py_ssize_t nlen;
    const char *n = PyUnicode_AsUTF8AndSize(name, &nlen);
    if (n == NULL)
        return NULL;
    hc_buf b;
    if (buf_init(&b, 256 + (size_t)nlen) < 0)
        return PyErr_NoMemory();
    buf_put(&b, "event: ", 7);
    buf_put(&b, n, (size_t)nlen);
    buf_put(&b, "\ndata: ", 7);
    if (json_write(&b, obj, 0) < 0) {
        buf_free(&b);
        return NULL;
    }
    buf_put(&b, "\n\n", 2);
    return buf_to_bytes(&b);
}

/* ------------------------------------------------------------------ */
/* msgpack packer: parity with msgpack.packb(obj, use_bin_type=True).  */
/* ------------------------------------------------------------------ */

static inline void put_be16(hc_buf *b, uint16_t v) {
    char t[2] = {(char)(v >> 8), (char)v};
    buf_put(b, t, 2);
}

static inline void put_be32(hc_buf *b, uint32_t v) {
    char t[4] = {(char)(v >> 24), (char)(v >> 16), (char)(v >> 8), (char)v};
    buf_put(b, t, 4);
}

static inline void put_be64(hc_buf *b, uint64_t v) {
    char t[8] = {(char)(v >> 56), (char)(v >> 48), (char)(v >> 40),
                 (char)(v >> 32), (char)(v >> 24), (char)(v >> 16),
                 (char)(v >> 8),  (char)v};
    buf_put(b, t, 8);
}

static int mp_write_long(hc_buf *b, PyObject *obj) {
    int overflow = 0;
    long long d = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (d == -1 && !overflow && PyErr_Occurred())
        return -1;
    if (overflow > 0) {
        /* LLONG_MAX < v: msgpack packs uint64 when it fits, else
         * OverflowError (via the fallback). */
        unsigned long long u = PyLong_AsUnsignedLongLong(obj);
        if (u == (unsigned long long)-1 && PyErr_Occurred())
            return -1;
        buf_putc(b, (char)0xcf);
        put_be64(b, (uint64_t)u);
        return 0;
    }
    if (overflow < 0) {
        unsupported("int below int64");
        return -1;
    }
    /* msgpack-c pack_template.h: smallest encoding that fits. */
    if (d < -(1LL << 5)) {
        if (d < -(1LL << 15)) {
            if (d < -(1LL << 31)) {
                buf_putc(b, (char)0xd3);
                put_be64(b, (uint64_t)d);
            } else {
                buf_putc(b, (char)0xd2);
                put_be32(b, (uint32_t)(int32_t)d);
            }
        } else if (d < -(1LL << 7)) {
            buf_putc(b, (char)0xd1);
            put_be16(b, (uint16_t)(int16_t)d);
        } else {
            buf_putc(b, (char)0xd0);
            buf_putc(b, (char)(int8_t)d);
        }
    } else if (d < (1LL << 7)) {
        buf_putc(b, (char)(int8_t)d); /* pos/neg fixint */
    } else if (d < (1LL << 8)) {
        buf_putc(b, (char)0xcc);
        buf_putc(b, (char)(uint8_t)d);
    } else if (d < (1LL << 16)) {
        buf_putc(b, (char)0xcd);
        put_be16(b, (uint16_t)d);
    } else if (d < (1LL << 32)) {
        buf_putc(b, (char)0xce);
        put_be32(b, (uint32_t)d);
    } else {
        buf_putc(b, (char)0xcf);
        put_be64(b, (uint64_t)d);
    }
    return 0;
}

static int mp_write(hc_buf *b, PyObject *obj, int depth) {
    if (depth > HC_MAX_DEPTH) {
        unsupported("nesting depth");
        return -1;
    }
    if (obj == Py_None) {
        buf_putc(b, (char)0xc0);
        return 0;
    }
    if (obj == Py_True) {
        buf_putc(b, (char)0xc3);
        return 0;
    }
    if (obj == Py_False) {
        buf_putc(b, (char)0xc2);
        return 0;
    }
    if (PyLong_CheckExact(obj))
        return mp_write_long(b, obj);
    if (PyFloat_CheckExact(obj)) {
        double v = PyFloat_AS_DOUBLE(obj);
        uint64_t bits;
        memcpy(&bits, &v, 8);
        buf_putc(b, (char)0xcb);
        put_be64(b, bits);
        return 0;
    }
    if (PyUnicode_CheckExact(obj)) {
        Py_ssize_t n;
        const char *u = PyUnicode_AsUTF8AndSize(obj, &n);
        if (u == NULL)
            return -1;
        if (n < 32) {
            buf_putc(b, (char)(0xa0 | (unsigned)n));
        } else if (n < 256) {
            buf_putc(b, (char)0xd9);
            buf_putc(b, (char)(uint8_t)n);
        } else if (n < 65536) {
            buf_putc(b, (char)0xda);
            put_be16(b, (uint16_t)n);
        } else {
            buf_putc(b, (char)0xdb);
            put_be32(b, (uint32_t)n);
        }
        buf_put(b, u, (size_t)n);
        return 0;
    }
    if (PyBytes_CheckExact(obj)) {
        Py_ssize_t n = PyBytes_GET_SIZE(obj);
        if (n < 256) {
            buf_putc(b, (char)0xc4);
            buf_putc(b, (char)(uint8_t)n);
        } else if (n < 65536) {
            buf_putc(b, (char)0xc5);
            put_be16(b, (uint16_t)n);
        } else {
            buf_putc(b, (char)0xc6);
            put_be32(b, (uint32_t)n);
        }
        buf_put(b, PyBytes_AS_STRING(obj), (size_t)n);
        return 0;
    }
    if (PyList_CheckExact(obj) || PyTuple_CheckExact(obj)) {
        Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
        if (n < 16) {
            buf_putc(b, (char)(0x90 | (unsigned)n));
        } else if (n < 65536) {
            buf_putc(b, (char)0xdc);
            put_be16(b, (uint16_t)n);
        } else {
            buf_putc(b, (char)0xdd);
            put_be32(b, (uint32_t)n);
        }
        PyObject **items = PySequence_Fast_ITEMS(obj);
        for (Py_ssize_t i = 0; i < n; i++)
            if (mp_write(b, items[i], depth + 1) < 0)
                return -1;
        return 0;
    }
    if (PyDict_CheckExact(obj)) {
        Py_ssize_t n = PyDict_GET_SIZE(obj);
        if (n < 16) {
            buf_putc(b, (char)(0x80 | (unsigned)n));
        } else if (n < 65536) {
            buf_putc(b, (char)0xde);
            put_be16(b, (uint16_t)n);
        } else {
            buf_putc(b, (char)0xdf);
            put_be32(b, (uint32_t)n);
        }
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            if (mp_write(b, k, depth + 1) < 0)
                return -1;
            if (mp_write(b, v, depth + 1) < 0)
                return -1;
        }
        return 0;
    }
    unsupported(Py_TYPE(obj)->tp_name);
    return -1;
}

PyObject *hc_packb(PyObject *obj) {
    hc_buf b;
    if (buf_init(&b, 256) < 0)
        return PyErr_NoMemory();
    if (mp_write(&b, obj, 0) < 0) {
        buf_free(&b);
        return NULL;
    }
    return buf_to_bytes(&b);
}

/* ------------------------------------------------------------------ */
/* msgpack unpacker: parity with msgpack.unpackb(data, raw=False).     */
/* Any shortfall (ext types, invalid utf-8, truncation, trailing       */
/* bytes) -> NULL, and the loader reruns msgpack for the canonical     */
/* result or error.                                                    */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *p;
    size_t len, off;
} mp_reader;

static inline int rd_need(mp_reader *r, size_t n) {
    if (r->len - r->off < n) {
        unsupported("truncated msgpack");
        return -1;
    }
    return 0;
}

static inline uint16_t rd_be16(mp_reader *r) {
    const uint8_t *p = r->p + r->off;
    r->off += 2;
    return (uint16_t)((p[0] << 8) | p[1]);
}

static inline uint32_t rd_be32(mp_reader *r) {
    const uint8_t *p = r->p + r->off;
    r->off += 4;
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static inline uint64_t rd_be64(mp_reader *r) {
    uint64_t hi = rd_be32(r);
    return (hi << 32) | rd_be32(r);
}

static PyObject *mp_read(mp_reader *r, int depth);

static PyObject *mp_read_str(mp_reader *r, size_t n) {
    if (rd_need(r, n) < 0)
        return NULL;
    PyObject *s = PyUnicode_DecodeUTF8((const char *)r->p + r->off,
                                       (Py_ssize_t)n, NULL);
    r->off += n;
    return s; /* invalid utf-8 -> NULL -> fallback raises canonically */
}

static PyObject *mp_read_bin(mp_reader *r, size_t n) {
    if (rd_need(r, n) < 0)
        return NULL;
    PyObject *s =
        PyBytes_FromStringAndSize((const char *)r->p + r->off, (Py_ssize_t)n);
    r->off += n;
    return s;
}

static PyObject *mp_read_array(mp_reader *r, size_t n, int depth) {
    if (n > r->len - r->off) { /* >=1 byte per element */
        unsupported("truncated msgpack array");
        return NULL;
    }
    PyObject *list = PyList_New((Py_ssize_t)n);
    if (list == NULL)
        return NULL;
    for (size_t i = 0; i < n; i++) {
        PyObject *v = mp_read(r, depth + 1);
        if (v == NULL) {
            Py_DECREF(list);
            return NULL;
        }
        PyList_SET_ITEM(list, (Py_ssize_t)i, v);
    }
    return list;
}

static PyObject *mp_read_map(mp_reader *r, size_t n, int depth) {
    if (n > (r->len - r->off) / 2) {
        unsupported("truncated msgpack map");
        return NULL;
    }
    PyObject *d = PyDict_New();
    if (d == NULL)
        return NULL;
    for (size_t i = 0; i < n; i++) {
        PyObject *k = mp_read(r, depth + 1);
        if (k == NULL) {
            Py_DECREF(d);
            return NULL;
        }
        PyObject *v = mp_read(r, depth + 1);
        if (v == NULL) {
            Py_DECREF(k);
            Py_DECREF(d);
            return NULL;
        }
        int rc = PyDict_SetItem(d, k, v);
        Py_DECREF(k);
        Py_DECREF(v);
        if (rc < 0) {
            Py_DECREF(d);
            return NULL;
        }
    }
    return d;
}

static PyObject *mp_read(mp_reader *r, int depth) {
    if (depth > HC_MAX_DEPTH)
        return unsupported("nesting depth");
    if (rd_need(r, 1) < 0)
        return NULL;
    uint8_t c = r->p[r->off++];
    if (c < 0x80)
        return PyLong_FromLong(c); /* positive fixint */
    if (c >= 0xe0)
        return PyLong_FromLong((long)(int8_t)c); /* negative fixint */
    if ((c & 0xf0) == 0x80)
        return mp_read_map(r, c & 0x0f, depth);
    if ((c & 0xf0) == 0x90)
        return mp_read_array(r, c & 0x0f, depth);
    if ((c & 0xe0) == 0xa0)
        return mp_read_str(r, c & 0x1f);
    switch (c) {
    case 0xc0:
        Py_RETURN_NONE;
    case 0xc2:
        Py_RETURN_FALSE;
    case 0xc3:
        Py_RETURN_TRUE;
    case 0xc4:
        if (rd_need(r, 1) < 0)
            return NULL;
        return mp_read_bin(r, r->p[r->off++]);
    case 0xc5:
        if (rd_need(r, 2) < 0)
            return NULL;
        return mp_read_bin(r, rd_be16(r));
    case 0xc6:
        if (rd_need(r, 4) < 0)
            return NULL;
        return mp_read_bin(r, rd_be32(r));
    case 0xca: { /* float32: widened to double, like msgpack-python */
        if (rd_need(r, 4) < 0)
            return NULL;
        uint32_t bits = rd_be32(r);
        float f;
        memcpy(&f, &bits, 4);
        return PyFloat_FromDouble((double)f);
    }
    case 0xcb: {
        if (rd_need(r, 8) < 0)
            return NULL;
        uint64_t bits = rd_be64(r);
        double d;
        memcpy(&d, &bits, 8);
        return PyFloat_FromDouble(d);
    }
    case 0xcc:
        if (rd_need(r, 1) < 0)
            return NULL;
        return PyLong_FromLong(r->p[r->off++]);
    case 0xcd:
        if (rd_need(r, 2) < 0)
            return NULL;
        return PyLong_FromLong(rd_be16(r));
    case 0xce:
        if (rd_need(r, 4) < 0)
            return NULL;
        return PyLong_FromUnsignedLong(rd_be32(r));
    case 0xcf:
        if (rd_need(r, 8) < 0)
            return NULL;
        return PyLong_FromUnsignedLongLong(rd_be64(r));
    case 0xd0:
        if (rd_need(r, 1) < 0)
            return NULL;
        return PyLong_FromLong((long)(int8_t)r->p[r->off++]);
    case 0xd1:
        if (rd_need(r, 2) < 0)
            return NULL;
        return PyLong_FromLong((long)(int16_t)rd_be16(r));
    case 0xd2:
        if (rd_need(r, 4) < 0)
            return NULL;
        return PyLong_FromLong((long)(int32_t)rd_be32(r));
    case 0xd3:
        if (rd_need(r, 8) < 0)
            return NULL;
        return PyLong_FromLongLong((long long)(int64_t)rd_be64(r));
    case 0xd9:
        if (rd_need(r, 1) < 0)
            return NULL;
        return mp_read_str(r, r->p[r->off++]);
    case 0xda:
        if (rd_need(r, 2) < 0)
            return NULL;
        return mp_read_str(r, rd_be16(r));
    case 0xdb:
        if (rd_need(r, 4) < 0)
            return NULL;
        return mp_read_str(r, rd_be32(r));
    case 0xdc:
        if (rd_need(r, 2) < 0)
            return NULL;
        return mp_read_array(r, rd_be16(r), depth);
    case 0xdd:
        if (rd_need(r, 4) < 0)
            return NULL;
        return mp_read_array(r, rd_be32(r), depth);
    case 0xde:
        if (rd_need(r, 2) < 0)
            return NULL;
        return mp_read_map(r, rd_be16(r), depth);
    case 0xdf:
        if (rd_need(r, 4) < 0)
            return NULL;
        return mp_read_map(r, rd_be32(r), depth);
    default:
        /* ext family (0xc1, 0xc7-0xc9, 0xd4-0xd8): never on this wire;
         * the fallback decides whether it is valid. */
        return unsupported("msgpack type");
    }
}

static PyObject *mp_unpack_buf(const uint8_t *p, size_t len) {
    mp_reader r = {p, len, 0};
    PyObject *obj = mp_read(&r, 0);
    if (obj == NULL)
        return NULL;
    if (r.off != r.len) {
        Py_DECREF(obj);
        return unsupported("trailing msgpack bytes");
    }
    return obj;
}

PyObject *hc_unpackb(PyObject *data) {
    if (!PyBytes_CheckExact(data))
        return unsupported("unpack input");
    return mp_unpack_buf((const uint8_t *)PyBytes_AS_STRING(data),
                         (size_t)PyBytes_GET_SIZE(data));
}

/* ------------------------------------------------------------------ */
/* base64 (standard alphabet, canonical form only) fused with msgpack  */
/* for the LOADFRAME wire: str = b64(msgpack(frame)).                  */
/* ------------------------------------------------------------------ */

static const char B64E[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

static int8_t B64D[256]; /* built lazily: -1 invalid */
static int b64d_ready = 0;

static void b64d_build(void) {
    memset(B64D, -1, sizeof(B64D));
    for (int i = 0; i < 64; i++)
        B64D[(uint8_t)B64E[i]] = (int8_t)i;
    b64d_ready = 1;
}

PyObject *hc_pack_b64(PyObject *obj) {
    hc_buf b;
    if (buf_init(&b, 256) < 0)
        return PyErr_NoMemory();
    if (mp_write(&b, obj, 0) < 0) {
        buf_free(&b);
        return NULL;
    }
    if (b.err) {
        buf_free(&b);
        return PyErr_NoMemory();
    }
    size_t n = b.len;
    size_t outn = ((n + 2) / 3) * 4;
    PyObject *s = PyUnicode_New((Py_ssize_t)outn, 127);
    if (s == NULL) {
        buf_free(&b);
        return NULL;
    }
    uint8_t *o = (uint8_t *)PyUnicode_1BYTE_DATA(s);
    const uint8_t *in = (const uint8_t *)b.p;
    size_t i = 0;
    while (i + 3 <= n) {
        uint32_t v = ((uint32_t)in[i] << 16) | ((uint32_t)in[i + 1] << 8) |
                     in[i + 2];
        *o++ = (uint8_t)B64E[(v >> 18) & 63];
        *o++ = (uint8_t)B64E[(v >> 12) & 63];
        *o++ = (uint8_t)B64E[(v >> 6) & 63];
        *o++ = (uint8_t)B64E[v & 63];
        i += 3;
    }
    if (i + 1 == n) {
        uint32_t v = (uint32_t)in[i] << 16;
        *o++ = (uint8_t)B64E[(v >> 18) & 63];
        *o++ = (uint8_t)B64E[(v >> 12) & 63];
        *o++ = '=';
        *o++ = '=';
    } else if (i + 2 == n) {
        uint32_t v = ((uint32_t)in[i] << 16) | ((uint32_t)in[i + 1] << 8);
        *o++ = (uint8_t)B64E[(v >> 18) & 63];
        *o++ = (uint8_t)B64E[(v >> 12) & 63];
        *o++ = (uint8_t)B64E[(v >> 6) & 63];
        *o++ = '=';
    }
    buf_free(&b);
    return s;
}

PyObject *hc_unpack_b64(PyObject *s) {
    const uint8_t *in;
    size_t n;
    Py_ssize_t sn;
    if (PyUnicode_CheckExact(s)) {
        const char *u = PyUnicode_AsUTF8AndSize(s, &sn);
        if (u == NULL)
            return NULL;
        in = (const uint8_t *)u;
        n = (size_t)sn;
    } else if (PyBytes_CheckExact(s)) {
        in = (const uint8_t *)PyBytes_AS_STRING(s);
        n = (size_t)PyBytes_GET_SIZE(s);
    } else {
        return unsupported("b64 input");
    }
    /* Canonical base64 only (what our encoders emit); anything looser
     * (whitespace, missing padding) goes to base64.b64decode via the
     * fallback. */
    if (n == 0 || n % 4 != 0)
        return unsupported("non-canonical base64");
    if (!b64d_ready)
        b64d_build();
    size_t pad = 0;
    if (in[n - 1] == '=')
        pad++;
    if (in[n - 2] == '=')
        pad++;
    size_t outn = n / 4 * 3 - pad;
    uint8_t *buf = (uint8_t *)PyMem_Malloc(outn ? outn : 1);
    if (buf == NULL)
        return PyErr_NoMemory();
    uint8_t *o = buf;
    for (size_t i = 0; i < n; i += 4) {
        int8_t a = B64D[in[i]], b = B64D[in[i + 1]];
        int8_t c, d;
        int npad = 0;
        if (in[i + 2] == '=') {
            c = 0;
            npad = 2;
            if (in[i + 3] != '=' || i + 4 != n)
                goto bad;
            d = 0;
        } else {
            c = B64D[in[i + 2]];
            if (in[i + 3] == '=') {
                npad = 1;
                if (i + 4 != n)
                    goto bad;
                d = 0;
            } else {
                d = B64D[in[i + 3]];
            }
        }
        if (a < 0 || b < 0 || c < 0 || d < 0)
            goto bad;
        uint32_t v = ((uint32_t)a << 18) | ((uint32_t)b << 12) |
                     ((uint32_t)c << 6) | (uint32_t)d;
        *o++ = (uint8_t)(v >> 16);
        if (npad < 2)
            *o++ = (uint8_t)(v >> 8);
        if (npad < 1)
            *o++ = (uint8_t)v;
    }
    {
        PyObject *obj = mp_unpack_buf(buf, outn);
        PyMem_Free(buf);
        return obj;
    }
bad:
    PyMem_Free(buf);
    return unsupported("non-canonical base64");
}

/* ------------------------------------------------------------------ */
/* Rendezvous (HRW) walk: parity with ownership._rendezvous_score —    */
/* score(m) = BE-uint64 of blake2b(f"{m}|{key}", digest_size=8);       */
/* first strictly-greatest member wins. One native call per walk.      */
/* ------------------------------------------------------------------ */

PyObject *hc_rendezvous(PyObject *members, PyObject *key) {
    if (!(PyTuple_CheckExact(members) || PyList_CheckExact(members)))
        return unsupported("members sequence");
    if (!PyUnicode_CheckExact(key))
        return unsupported("rendezvous key");
    Py_ssize_t klen;
    const char *k = PyUnicode_AsUTF8AndSize(key, &klen);
    if (k == NULL)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(members);
    PyObject **items = PySequence_Fast_ITEMS(members);
    PyObject *best = NULL;
    uint64_t best_score = 0;
    uint8_t stackbuf[512];
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *m = items[i];
        if (!PyUnicode_CheckExact(m))
            return unsupported("member");
        Py_ssize_t mlen;
        const char *mu = PyUnicode_AsUTF8AndSize(m, &mlen);
        if (mu == NULL)
            return NULL;
        size_t total = (size_t)mlen + 1 + (size_t)klen;
        uint8_t *msg = stackbuf;
        if (total > sizeof(stackbuf)) {
            msg = (uint8_t *)PyMem_Malloc(total);
            if (msg == NULL)
                return PyErr_NoMemory();
        }
        memcpy(msg, mu, (size_t)mlen);
        msg[mlen] = '|';
        memcpy(msg + mlen + 1, k, (size_t)klen);
        b2b_state S;
        uint8_t dig[8];
        b2b_init(&S, 8);
        b2b_update(&S, msg, total);
        b2b_final(&S, dig);
        if (msg != stackbuf)
            PyMem_Free(msg);
        uint64_t score = ((uint64_t)dig[0] << 56) | ((uint64_t)dig[1] << 48) |
                         ((uint64_t)dig[2] << 40) | ((uint64_t)dig[3] << 32) |
                         ((uint64_t)dig[4] << 24) | ((uint64_t)dig[5] << 16) |
                         ((uint64_t)dig[6] << 8) | (uint64_t)dig[7];
        if (best == NULL || score > best_score) {
            best = m;
            best_score = score;
        }
    }
    if (best == NULL)
        return PyUnicode_FromStringAndSize("", 0);
    Py_INCREF(best);
    return best;
}

/* ------------------------------------------------------------------ */
/* Byte tokenizer: parity with SimpleTokenizer.encode —                */
/* [b + 256 for b in text.encode("utf-8")].                            */
/* ------------------------------------------------------------------ */

/* The id space is exactly byte+256 = [256, 511], so every id a prompt can
 * produce comes from a 256-entry table of interned PyLongs built on first
 * use.  Encoding is then one INCREF + pointer store per byte instead of a
 * PyLong allocation, which is what keeps the native slope flat under
 * allocator pressure at fleet load (boxing 24K ints per batch prompt
 * otherwise dominates the C path).  GIL held (PyDLL), so the lazy init
 * needs no locking. */
static PyObject *tok_id_table[256];

static int tok_table_init(void) {
    if (tok_id_table[0] != NULL)
        return 0;
    for (int i = 0; i < 256; i++) {
        PyObject *v = PyLong_FromLong((long)i + 256);
        if (v == NULL) {
            for (int j = 0; j < i; j++) {
                Py_CLEAR(tok_id_table[j]);
            }
            return -1;
        }
        tok_id_table[i] = v;
    }
    return 0;
}

PyObject *hc_tok_encode(PyObject *text) {
    if (!PyUnicode_CheckExact(text))
        return unsupported("tokenizer input");
    if (tok_table_init() != 0)
        return NULL;
    Py_ssize_t n;
    const char *u = PyUnicode_AsUTF8AndSize(text, &n);
    if (u == NULL)
        return NULL;
    PyObject *list = PyList_New(n);
    if (list == NULL)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *v = tok_id_table[(uint8_t)u[i]];
        Py_INCREF(v);
        PyList_SET_ITEM(list, i, v);
    }
    return list;
}

/* Loader handshake (ctypes CDLL-callable). */
int hc_abi_version(void) { return 1; }
