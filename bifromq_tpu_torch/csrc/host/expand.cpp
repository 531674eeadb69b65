// Interval -> slot-id expansion (the host half of the route-materializing
// walk; copy of native/expand.cpp, built by g++ into build/host/ by
// bifromq_tpu_torch/utils/nativelib.py, bound in ops/match.py): writes
// start..start+count-1 for every (start, count) pair into one flat int32
// vector. Pure sequential stores, memory-bandwidth-bound. It serves the
// rows the device expansion does not: escalated rows and rows truncated by
// the device pair buffer, which re-expand from their interval grids.

#include <cstdint>

extern "C" {

// Expand a [rows, lanes, 2] interval grid (the walk_routes output shape);
// fills row_totals[r] = slots written for row r and returns the total
// (the caller asserts it against its own count sum).
int64_t expand_grid(const int32_t *grid, int64_t rows, int64_t lanes,
                    int32_t *out, int64_t *row_totals) {
    int64_t w = 0;
    for (int64_t r = 0; r < rows; ++r) {
        int64_t before = w;
        const int32_t *row = grid + r * lanes * 2;
        for (int64_t l = 0; l < lanes; ++l) {
            int32_t start = row[l * 2];
            int32_t count = row[l * 2 + 1];
            for (int32_t j = 0; j < count; ++j) out[w++] = start + j;
        }
        row_totals[r] = w - before;
    }
    return w;
}

}  // extern "C"
