// Native preprocessing for effectivediffusivityfvm_tpu_torch: the host-side
// O(N) passes that feed the solvers -- the reference's threshold/porosity
// passes (Deff2D.cuh:383-448/1693-1701) and its std::set-frontier BFS
// FloodFill (Deff2D.cuh:557-713).  The port's own copy of the JAX package's
// csrc/preprocess.cpp, built with g++ by models/_native.py and called
// through a plain C ABI with ctypes; each call releases the GIL, so a
// Python thread can preprocess one batch while the card solves another.
//
// Flood fill is a two-pass union-find connected-components pass (4-connected,
// periodic in Y, non-periodic in X) instead of the reference's BFS -- same
// result, linear time.  It implements the documented intent (both boundary
// columns seed participation); the reference's `Domain[indexR == -1]`
// right-seed bug (Deff2D.cuh:601) is deliberately not replicated.  path_flag
// is true left<->right percolation: some component touches both boundary
// columns.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// --- phase classification -------------------------------------------------

// 2-phase: pixel < 150 -> 0 (fluid) else 1 (solid)   [Deff2D.cuh:1779-1783]
void classify_two_phase(const uint8_t* img, int64_t n, uint8_t* classes) {
    for (int64_t i = 0; i < n; ++i) classes[i] = img[i] < 150 ? 0 : 1;
}

// 3-phase: >200 -> 1 (solid), <50 -> 2 (gas), else 0 (fluid)
//   [Deff2D.cuh:1456-1467]
void classify_three_phase(const uint8_t* img, int64_t n, uint8_t* classes) {
    for (int64_t i = 0; i < n; ++i)
        classes[i] = img[i] > 200 ? 1 : (img[i] < 50 ? 2 : 0);
}

// porosity: fraction of pixels < 150   [calcPorosity, Deff2D.cuh:383-408]
double porosity(const uint8_t* img, int64_t n) {
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) count += img[i] < 150;
    return n ? static_cast<double>(count) / static_cast<double>(n) : 0.0;
}

// --- flood fill -----------------------------------------------------------

namespace {
struct UnionFind {
    std::vector<int32_t> parent;
    explicit UnionFind(size_t n) : parent(n) {
        for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
    }
    int32_t find(int32_t a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];
            a = parent[a];
        }
        return a;
    }
    void unite(int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a != b) parent[b] = a;
    }
};
}  // namespace

// solid:  (ny*nx) bytes, 1 = impermeable.
// participating/isolated: output masks (may be null if not wanted).
// Returns 1 if a left<->right percolation path exists, else 0.
int flood_fill(const uint8_t* solid, int32_t ny, int32_t nx,
               uint8_t* participating, uint8_t* isolated) {
    const int64_t n = static_cast<int64_t>(ny) * nx;
    std::vector<int32_t> label(n, -1);
    // Pass 1: row-major scan, union with west and north neighbors
    // (periodic-Y north for row 0 handled after the scan).
    int32_t next = 0;
    UnionFind uf(static_cast<size_t>(n) / 2 + 2);
    for (int32_t i = 0; i < ny; ++i) {
        for (int32_t j = 0; j < nx; ++j) {
            const int64_t p = static_cast<int64_t>(i) * nx + j;
            if (solid[p]) continue;
            int32_t lw = (j > 0 && !solid[p - 1]) ? label[p - 1] : -1;
            int32_t ln = (i > 0 && !solid[p - nx]) ? label[p - nx] : -1;
            if (lw < 0 && ln < 0) {
                label[p] = next++;
                if (static_cast<size_t>(next) > uf.parent.size())
                    uf.parent.push_back(next - 1);
            } else if (lw >= 0 && ln >= 0) {
                label[p] = lw;
                uf.unite(lw, ln);
            } else {
                label[p] = lw >= 0 ? lw : ln;
            }
        }
    }
    // Periodic wrap in Y (Deff2D.cuh:640-671): row 0 and row ny-1 are
    // neighbors column-wise.
    if (ny > 1) {
        for (int32_t j = 0; j < nx; ++j) {
            const int64_t top = j, bot = static_cast<int64_t>(ny - 1) * nx + j;
            if (!solid[top] && !solid[bot]) uf.unite(label[top], label[bot]);
        }
    }
    // Boundary-connected roots.
    std::vector<uint8_t> reach_left(static_cast<size_t>(next), 0);
    std::vector<uint8_t> reach_right(static_cast<size_t>(next), 0);
    for (int32_t i = 0; i < ny; ++i) {
        const int64_t pl = static_cast<int64_t>(i) * nx;
        const int64_t pr = pl + nx - 1;
        if (!solid[pl]) reach_left[uf.find(label[pl])] = 1;
        if (!solid[pr]) reach_right[uf.find(label[pr])] = 1;
    }
    int path = 0;
    for (int32_t r = 0; r < next; ++r) {
        if (uf.parent[r] == r && reach_left[r] && reach_right[r]) { path = 1; break; }
    }
    if (participating || isolated) {
        for (int64_t p = 0; p < n; ++p) {
            uint8_t part = 0, iso = 0;
            if (!solid[p]) {
                const int32_t r = uf.find(label[p]);
                part = reach_left[r] | reach_right[r];
                iso = !part;
            }
            if (participating) participating[p] = part;
            if (isolated) isolated[p] = iso;
        }
    }
    return path;
}

// Batch driver: images (B, ny, nx) contiguous; outputs per image.
void flood_fill_batch(const uint8_t* solid, int32_t batch, int32_t ny, int32_t nx,
                      uint8_t* participating, uint8_t* isolated,
                      int32_t* path_flags) {
    const int64_t stride = static_cast<int64_t>(ny) * nx;
    for (int32_t b = 0; b < batch; ++b) {
        path_flags[b] = flood_fill(
            solid + b * stride, ny, nx,
            participating ? participating + b * stride : nullptr,
            isolated ? isolated + b * stride : nullptr);
    }
}

}  // extern "C"
