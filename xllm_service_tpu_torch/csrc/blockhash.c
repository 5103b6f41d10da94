/* Chained BLAKE2b-128 block hashing for the global prefix-KV-cache index.
 *
 * Native twin of xllm_service_tpu_torch/common/hashing.py (copy of the
 * repo-root csrc/blockhash.c): digests are
 * byte-identical to Python's hashlib.blake2b(digest_size=16, key=...) —
 * RFC 7693 keyed sequential mode — so engines running the pure-Python
 * path and orchestration components running this extension compute the
 * same 16-byte keys for the same token prefixes (the whole point of the
 * index). tests/test_torch_native_hotcore.py asserts the equivalence.
 *
 * The exported entry point loops the chain in C: one call hashes every
 * complete block of a token buffer, keying block i with the digest of
 * block i-1 (the seed for block 0), amortizing the per-block Python/FFI
 * overhead that dominates the hashlib loop.
 *
 * Build: common/native.py compiles this file at first use into
 * build/native/ (with -DBLOCKHASH_PYLIST and the running Python's
 * headers); XLLM_NO_NATIVE_HASH=1 keeps hashing.py on its pure path.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

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
            /* Buffer full AND more input follows: compress as non-final. */
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

static void b2b_init_keyed(b2b_state *S, size_t outlen, const uint8_t *key,
                           size_t keylen) {
    int i;
    memset(S, 0, sizeof(*S));
    for (i = 0; i < 8; i++)
        S->h[i] = B2B_IV[i];
    S->h[0] ^= 0x01010000ULL ^ ((uint64_t)keylen << 8) ^ (uint64_t)outlen;
    S->outlen = outlen;
    if (keylen > 0) {
        uint8_t block[128];
        memset(block, 0, sizeof(block));
        memcpy(block, key, keylen);
        b2b_update(S, block, 128);
    }
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

/* Chained driver: data is the raw little-endian int32 token buffer of
 * n_blocks complete blocks, block_bytes bytes each. Block 0 is keyed with
 * seed; block i with block i-1's 16-byte digest. Writes 16 bytes per block
 * into out. */
void chained_block_hashes(const uint8_t *data, size_t n_blocks,
                          size_t block_bytes, const uint8_t *seed,
                          size_t seed_len, uint8_t *out) {
    const uint8_t *key = seed;
    size_t keylen = seed_len;
    size_t i;
    b2b_state S;
    for (i = 0; i < n_blocks; i++) {
        b2b_init_keyed(&S, 16, key, keylen);
        b2b_update(&S, data + i * block_bytes, block_bytes);
        b2b_final(&S, out + i * 16);
        key = out + i * 16;
        keylen = 16;
    }
}

/* Single keyed hash, exposed for the equivalence tests. */
void blake2b_128_keyed(const uint8_t *data, size_t datalen,
                       const uint8_t *key, size_t keylen, uint8_t *out) {
    b2b_state S;
    b2b_init_keyed(&S, 16, key, keylen);
    b2b_update(&S, data, datalen);
    b2b_final(&S, out);
}

#ifdef BLOCKHASH_PYLIST
/* List-ingest entry point, called via ctypes.PyDLL (GIL held): converts
 * the Python token sequence to little-endian int32 in C — profiling shows
 * np.asarray(list) costs ~25x the hash chain itself for a 4k-token
 * prompt — then runs the chain. Returns bytes(n_blocks*16); NULL with an
 * exception set on a non-integer element. Compiled in only when Python.h
 * is available (see csrc/Makefile); hashing.py probes for the symbol. */
#include <Python.h>

PyObject *chained_block_hashes_list(PyObject *tokens, Py_ssize_t block_size,
                                    PyObject *seed) {
    PyObject *fast = PySequence_Fast(tokens, "token_ids must be a sequence");
    if (fast == NULL)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    Py_ssize_t n_blocks = block_size > 0 ? n / block_size : 0;
    if (n_blocks <= 0) {
        Py_DECREF(fast);
        return PyBytes_FromStringAndSize(NULL, 0);
    }
    char *seed_buf;
    Py_ssize_t seed_len;
    if (PyBytes_AsStringAndSize(seed, &seed_buf, &seed_len) < 0) {
        Py_DECREF(fast);
        return NULL;
    }
    Py_ssize_t n_used = n_blocks * block_size;
    int32_t *data = (int32_t *)PyMem_Malloc((size_t)n_used * 4);
    if (data == NULL) {
        Py_DECREF(fast);
        return PyErr_NoMemory();
    }
    PyObject **items = PySequence_Fast_ITEMS(fast);
    for (Py_ssize_t i = 0; i < n_used; i++) {
        long v = PyLong_AsLong(items[i]);
        if (v == -1 && PyErr_Occurred()) {
            PyMem_Free(data);
            Py_DECREF(fast);
            return NULL;
        }
        /* Same narrowing as the np.int32 conversion on the Python path
         * (token ids are < 2^31 in practice). Stored little-endian;
         * byte-swap would be needed on a big-endian host, but every
         * deployment target (x86/ARM TPU-VM hosts) is little-endian. */
        data[i] = (int32_t)v;
    }
    Py_DECREF(fast);
    PyObject *out = PyBytes_FromStringAndSize(NULL, n_blocks * 16);
    if (out == NULL) {
        PyMem_Free(data);
        return NULL;
    }
    chained_block_hashes((const uint8_t *)data, (size_t)n_blocks,
                         (size_t)block_size * 4, (const uint8_t *)seed_buf,
                         (size_t)seed_len, (uint8_t *)PyBytes_AS_STRING(out));
    PyMem_Free(data);
    return out;
}
#endif /* BLOCKHASH_PYLIST */
