// Native topic tokenizer: the host-side tokenizer of the port's probe
// batches (copy of native/tokenizer.cpp; built by g++ into build/host/ by
// bifromq_tpu_torch/utils/nativelib.py, bound in models/native_tok.py).
//
// The host legs of the serving path (models/automaton.py tokenize(): the
// mesh's per-shard prepare, pre-parsed level-list batches, the escalation
// re-walk's sub-batch) hash every level of every PUBLISH topic into the
// probe batch; the per-level Python loop of tokenize(native=False) is its
// semantics reference, and the per-byte work stays in C++.
//
// Contains a compact BLAKE2b (RFC 7693) with digest_length=8 and a 16-byte
// salt in the parameter block, bit-exact with Python's
// hashlib.blake2b(level, digest_size=8, salt=salt8) where salt8 is the
// 8-byte little-endian salt zero-padded to 16 (hashlib pads too).
//
// C ABI for ctypes. Thread-safe (no globals).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

static const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t SIGMA[12][16] = {
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
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

static inline uint64_t load64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;  // little-endian hosts only (x86/ARM)
}

#define G(a, b, c, d, x, y)                \
    do {                                   \
        a = a + b + (x);                   \
        d = rotr64(d ^ a, 32);             \
        c = c + d;                         \
        b = rotr64(b ^ c, 24);             \
        a = a + b + (y);                   \
        d = rotr64(d ^ a, 16);             \
        c = c + d;                         \
        b = rotr64(b ^ c, 63);             \
    } while (0)

static void compress(uint64_t h[8], const uint8_t block[128], uint64_t t,
                     bool last) {
    uint64_t m[16], v[16];
    for (int i = 0; i < 16; i++) m[i] = load64(block + 8 * i);
    for (int i = 0; i < 8; i++) v[i] = h[i];
    for (int i = 0; i < 8; i++) v[8 + i] = IV[i];
    v[12] ^= t;        // t0 (inputs < 2^64 bytes)
    if (last) v[14] = ~v[14];
    for (int r = 0; r < 12; r++) {
        const uint8_t* s = SIGMA[r];
        G(v[0], v[4], v[8], v[12], m[s[0]], m[s[1]]);
        G(v[1], v[5], v[9], v[13], m[s[2]], m[s[3]]);
        G(v[2], v[6], v[10], v[14], m[s[4]], m[s[5]]);
        G(v[3], v[7], v[11], v[15], m[s[6]], m[s[7]]);
        G(v[0], v[5], v[10], v[15], m[s[8]], m[s[9]]);
        G(v[1], v[6], v[11], v[12], m[s[10]], m[s[11]]);
        G(v[2], v[7], v[8], v[13], m[s[12]], m[s[13]]);
        G(v[3], v[4], v[9], v[14], m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[8 + i];
}

// blake2b(digest=8, salt=salt16) of msg; returns the 8 digest bytes as u64
static uint64_t blake2b8(const uint8_t* msg, size_t len,
                         const uint8_t salt16[16]) {
    uint64_t h[8];
    uint8_t param[64] = {0};
    param[0] = 8;   // digest_length
    param[2] = 1;   // fanout
    param[3] = 1;   // depth
    memcpy(param + 32, salt16, 16);
    for (int i = 0; i < 8; i++) h[i] = IV[i] ^ load64(param + 8 * i);
    uint8_t block[128];
    size_t off = 0;
    // full (non-final) blocks
    while (len - off > 128) {
        compress(h, msg + off, (uint64_t)(off + 128), false);
        off += 128;
    }
    size_t rem = len - off;
    memset(block, 0, 128);
    if (rem) memcpy(block, msg + off, rem);
    compress(h, block, (uint64_t)len, true);
    return h[0];  // first 8 little-endian digest bytes
}

// Tokenize rows [lo, hi) of a batch of '/'-separated topics into
// fixed-shape probe arrays.
//
// data/offsets: topic i is the UTF-8 bytes data[offsets[i]:offsets[i+1]].
// Outputs are row-major [batch, width] (width = max_levels + 1) int32 for
// tok_h1/tok_h2 (+ tok_kind in filter mode), plus per-row lengths, roots
// and sys flags. Rows with > max_levels levels are left as padding
// (length -1) for the caller's host-fallback path.
//
// filter_mode != 0 treats '+'/'#' levels as wildcard kinds (retained-probe
// tokenization) and skips their hashing; kind codes match automaton.py
// (0=literal, 1='+', 2='#'). tok_kind may be null when filter_mode == 0.
static void tok_rows(const uint8_t* data, const int32_t* offsets, int lo,
                     int hi, const int32_t* roots, int max_levels,
                     const uint8_t salt16[16], int filter_mode,
                     int32_t* tok_h1, int32_t* tok_h2, int32_t* tok_kind,
                     int32_t* lengths, int32_t* root_out, uint8_t* sys_mask,
                     int width) {
    for (int i = lo; i < hi; i++) {
        const uint8_t* s = data + offsets[i];
        int tlen = offsets[i + 1] - offsets[i];
        // count levels ('/' separators + 1)
        int n_levels = 1;
        for (int j = 0; j < tlen; j++)
            if (s[j] == '/') n_levels++;
        if (n_levels > max_levels) continue;  // padding row
        lengths[i] = n_levels;
        root_out[i] = roots[i];
        if (tlen > 0 && s[0] == '$') sys_mask[i] = 1;
        int32_t* h1 = tok_h1 + (int64_t)i * width;
        int32_t* h2 = tok_h2 + (int64_t)i * width;
        int32_t* kd = tok_kind ? tok_kind + (int64_t)i * width : nullptr;
        int lvl = 0, start = 0;
        for (int j = 0; j <= tlen; j++) {
            if (j == tlen || s[j] == '/') {
                const uint8_t* lp = s + start;
                int ll = j - start;
                if (filter_mode && ll == 1 && lp[0] == '+') {
                    kd[lvl] = 1;
                } else if (filter_mode && ll == 1 && lp[0] == '#') {
                    kd[lvl] = 2;
                } else {
                    uint64_t d = blake2b8(lp, (size_t)ll, salt16);
                    h1[lvl] = (int32_t)(uint32_t)(d & 0xFFFFFFFFu);
                    h2[lvl] = (int32_t)(uint32_t)(d >> 32);
                }
                lvl++;
                start = j + 1;
            }
        }
    }
}

}  // namespace

extern "C" {

// Serial tokenization (original ABI); see tok_rows for the contract.
void tok_topics(const uint8_t* data, const int32_t* offsets, int n_topics,
                const int32_t* roots, int max_levels, uint64_t salt,
                int filter_mode, int32_t* tok_h1, int32_t* tok_h2,
                int32_t* tok_kind, int32_t* lengths, int32_t* root_out,
                uint8_t* sys_mask, int width) {
    uint8_t salt16[16] = {0};
    memcpy(salt16, &salt, 8);  // little-endian, zero-padded like hashlib
    tok_rows(data, offsets, 0, n_topics, roots, max_levels, salt16,
             filter_mode, tok_h1, tok_h2, tok_kind, lengths, root_out,
             sys_mask, width);
}

// Multithreaded tokenization: rows are independent and each thread writes a
// disjoint row range, so the split is embarrassingly parallel. ctypes
// releases the GIL for the whole call. n_threads <= 1 degrades to serial.
void tok_topics_mt(const uint8_t* data, const int32_t* offsets, int n_topics,
                   const int32_t* roots, int max_levels, uint64_t salt,
                   int filter_mode, int32_t* tok_h1, int32_t* tok_h2,
                   int32_t* tok_kind, int32_t* lengths, int32_t* root_out,
                   uint8_t* sys_mask, int width, int n_threads) {
    uint8_t salt16[16] = {0};
    memcpy(salt16, &salt, 8);
    int hw = (int)std::thread::hardware_concurrency();
    int nt = std::min({n_threads > 0 ? n_threads : (hw > 0 ? hw : 1),
                       n_topics, 64});
    if (nt <= 1) {
        tok_rows(data, offsets, 0, n_topics, roots, max_levels, salt16,
                 filter_mode, tok_h1, tok_h2, tok_kind, lengths, root_out,
                 sys_mask, width);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(nt);
    int chunk = (n_topics + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        int lo = t * chunk;
        int hi = std::min(n_topics, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(tok_rows, data, offsets, lo, hi, roots,
                             max_levels, salt16, filter_mode, tok_h1, tok_h2,
                             tok_kind, lengths, root_out, sys_mask, width);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
