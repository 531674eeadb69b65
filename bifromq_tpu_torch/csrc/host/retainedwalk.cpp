// Native host-side retained-filter walker over the COMPILED automaton
// tables the device walk reads (copy of native/retainedwalk.cpp; built by
// g++ into build/host/ by bifromq_tpu_torch/utils/nativelib.py, bound in
// models/native_retained.py).
//
// Role: the bounded-lanes device walk (ops/retained.py
// retained_walk_ext) flags '+'-heavy filters whose frontier outgrows the
// lane budget; this DFS has no lane concept, so those rows resolve at C++
// speed instead of in the Python trie oracle. Semantics mirror the walk
// and models/retained.py match_filter_host exactly: literal steps are
// single-choice bucket probes, '+' iterates the CSR child slice ('$'
// children skipped at the root), '#' emits the subtree slot range with
// the root-level '$' prefix skipped, reaching the end emits the node's
// own slot range. Output is (start, count) slot ranges, which the caller
// expands like the device results. It reads only the frozen base ranges,
// so the caller uses it only while the patched base is pristine.

#include <cstdint>
#include <cstring>

namespace {

// node_tab columns (models/automaton.py layout contract)
constexpr int NODE_HASH = 1;
constexpr int NODE_RSTART = 2;
constexpr int NODE_RCOUNT = 3;
constexpr int NODE_CCOUNT = 5;
constexpr int NODE_CSTART = 6;
constexpr int NODE_SUB_RCOUNT = 7;
constexpr int NODE_SYS_CCOUNT = 8;
constexpr int NODE_SYS_SLOTS = 9;
constexpr int NODE_COLS = 12;

constexpr int KIND_LIT = 0;
constexpr int KIND_PLUS = 1;
constexpr int KIND_HASH = 2;

// MUST stay in sync with models.automaton._mix_u32 / ops.match._mix_u32
inline uint32_t mix_u32(uint32_t node, uint32_t h1, uint32_t h2) {
    uint32_t x = node * 0x9E3779B1u;
    x ^= h1 * 0x85EBCA6Bu;
    x ^= x >> 15;
    x *= 0xC2B2AE35u;
    x ^= h2 * 0x27D4EB2Fu;
    x ^= x >> 13;
    return x;
}

struct Walker {
    const int32_t *node_tab;
    const int32_t *edge_tab;   // [NB, P, 4]
    int64_t n_buckets;
    int64_t probe_len;
    const int32_t *child_list;
    const int32_t *kinds;      // this row's tok_kind
    const int32_t *h1s;
    const int32_t *h2s;
    int32_t n_levels;
    int32_t *ranges;           // [max_ranges, 2]
    int64_t max_ranges;
    int64_t n_ranges = 0;
    int64_t emitted = 0;       // total slots emitted (limit check)
    int64_t limit;             // <=0: unbounded
    bool range_overflow = false;

    inline const int32_t *rec(int32_t node) const {
        return node_tab + (int64_t)node * NODE_COLS;
    }

    // returns false when the walk should stop (limit reached or range
    // budget blown)
    bool emit(int32_t start, int32_t count) {
        if (count <= 0) return true;
        if (n_ranges >= max_ranges) {
            range_overflow = true;
            return false;
        }
        ranges[n_ranges * 2] = start;
        ranges[n_ranges * 2 + 1] = count;
        ++n_ranges;
        emitted += count;
        return !(limit > 0 && emitted >= limit);
    }

    int32_t edge_lookup(int32_t node, int32_t h1, int32_t h2) const {
        uint32_t b = mix_u32((uint32_t)node, (uint32_t)h1, (uint32_t)h2) &
                     (uint32_t)(n_buckets - 1);
        const int32_t *row = edge_tab + (int64_t)b * probe_len * 4;
        for (int64_t p = 0; p < probe_len; ++p) {
            const int32_t *e = row + p * 4;
            if (e[0] == node && e[1] == h1 && e[2] == h2) return e[3];
            if (e[0] < 0) break;  // buckets fill front-to-back
        }
        return -1;
    }

    bool walk(int32_t node, int32_t i) {
        const int32_t *r = rec(node);
        if (i == n_levels) return emit(r[NODE_RSTART], r[NODE_RCOUNT]);
        int32_t kind = kinds[i];
        bool at_root = i == 0;
        if (kind == KIND_HASH) {
            // subtree range; at the root skip own slots + '$' subtrees
            // (mirrors retained_walk's sys_skip = rcount + sys_slots)
            int32_t skip = at_root
                ? r[NODE_RCOUNT] + r[NODE_SYS_SLOTS] : 0;
            return emit(r[NODE_RSTART] + skip,
                        r[NODE_SUB_RCOUNT] - skip);
        }
        if (kind == KIND_PLUS) {
            int32_t cstart = r[NODE_CSTART];
            int32_t ccount = r[NODE_CCOUNT];
            if (at_root) {
                cstart += r[NODE_SYS_CCOUNT];
                ccount -= r[NODE_SYS_CCOUNT];
            }
            for (int32_t c = 0; c < ccount; ++c) {
                if (!walk(child_list[cstart + c], i + 1)) return false;
            }
            return true;
        }
        int32_t child = edge_lookup(node, h1s[i], h2s[i]);
        if (child >= 0) return walk(child, i + 1);
        return true;
    }
};

}  // namespace

extern "C" {

// Walk ``n_rows`` tokenized filters; per row writes up to ``max_ranges``
// (start, count) pairs, the range count, and an overflow flag (range
// budget blown — caller falls back to the Python oracle for that row).
void retained_match_rows(
    const int32_t *node_tab, const int32_t *edge_tab, int64_t n_buckets,
    int64_t probe_len, const int32_t *child_list,
    const int32_t *tok_h1, const int32_t *tok_h2, const int32_t *tok_kind,
    const int32_t *lengths, const int32_t *roots,
    int64_t n_rows, int64_t width,
    int64_t max_ranges, int64_t limit,
    int32_t *out_ranges, int32_t *out_nranges, uint8_t *out_overflow) {
    for (int64_t row = 0; row < n_rows; ++row) {
        out_nranges[row] = 0;
        out_overflow[row] = 0;
        int32_t len = lengths[row];
        int32_t root = roots[row];
        if (len < 0 || root < 0) continue;
        Walker w;
        w.node_tab = node_tab;
        w.edge_tab = edge_tab;
        w.n_buckets = n_buckets;
        w.probe_len = probe_len;
        w.child_list = child_list;
        w.kinds = tok_kind + row * width;
        w.h1s = tok_h1 + row * width;
        w.h2s = tok_h2 + row * width;
        w.n_levels = len;
        w.ranges = out_ranges + row * max_ranges * 2;
        w.max_ranges = max_ranges;
        w.limit = limit;
        w.walk(root, 0);
        out_nranges[row] = (int32_t)w.n_ranges;
        out_overflow[row] = w.range_overflow ? 1 : 0;
    }
}

}  // extern "C"
