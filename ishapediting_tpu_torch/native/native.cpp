// Native host-side geometry for ishapediting_tpu_torch (a copy of the JAX
// package's native/native.cpp; the port never imports that package).
//
// 1. marching_tets: iso-surface extraction via the 6-tetrahedra cube
//    decomposition (same algorithm/case tables as geometry/marching.py; the
//    Python version is the executable spec). Replaces PyMCubes in the
//    reference decode path (reference: visualize.py:76-105).
// 2. points_occupancy: vertical-ray parity point-in-mesh test with a uniform
//    2D grid accelerator. Replaces Open3D RaycastingScene.compute_occupancy
//    (reference: meshProcess.py:7-14).
// 3. smooth_simple: Laplacian smoothing with unique-neighbor dedup (Open3D
//    filter_smooth_simple semantics, the reference's 10-iteration post-
//    marching smooth, drag_utils.py:300).
// 4. write_obj: buffered ascii OBJ writer ("%.8g" vertex format, matching
//    the Python writer byte-for-byte; std::to_chars does the formatting).
// 5. read_obj: ascii OBJ reader: "v" and "f" lines only, a face token read
//    by its first index ("a/b/c" -> a), polygons fan-triangulated (the JAX
//    package's Python reader, geometry/mesh.py::_read_obj, line for line).
// 6. triangle_areas: per-triangle areas, bit-equal to the NumPy formula in
//    geometry/mesh.py (the area-weighted point sampling's weights).
// 7. zstd_decompress and 8. crc32c: the orbax reader's codec and checksum
//    (io/orbax.py), at the end of this file.
// 9. raster_triangles: the z-buffer loop of the headless renderer
//    (geometry/render.py), pixel-equal to its NumPy formulation.
//
// smooth_simple, points_occupancy and triangle_areas split their loops
// over threads (parallel_for); their results do not depend on the split.
//
// Exposed via a plain C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>
#include <algorithm>
#include <charconv>
#include <system_error>
#include <thread>
#include <type_traits>

// f(begin, end) over [0, n) split into contiguous ranges, one std::thread
// each (at most 16, none below `grain` items per range); the threads are
// joined before it returns, so a later fork sees none of them.
template <class F>
static void parallel_for(long long n, long long grain, F&& f) {
  const unsigned hw = std::thread::hardware_concurrency();
  long long k = std::min<long long>(hw ? hw : 1, 16);
  k = std::min<long long>(k, std::max<long long>(1, n / std::max<long long>(grain, 1)));
  if (k <= 1) {
    f(0LL, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve((size_t)k);
  for (long long i = 0; i < k; ++i) pool.emplace_back([&f, n, k, i] { f(n * i / k, n * (i + 1) / k); });
  for (auto& t : pool) t.join();
}

extern "C" {

static const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};
static const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};
static const int TET_EDGES[6][2] = {
    {0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3},
};
// triangles per inside-bitmask, as local edge ids, -1 terminated (max 2 tris)
static const int CASES[16][7] = {
    {-1},                       // 0000
    {0, 1, 2, -1},              // 0001
    {0, 3, 4, -1},              // 0010
    {1, 2, 4, 1, 4, 3, -1},     // 0011
    {1, 3, 5, -1},              // 0100
    {0, 2, 5, 0, 5, 3, -1},     // 0101
    {0, 4, 5, 0, 5, 1, -1},     // 0110
    {2, 4, 5, -1},              // 0111
    {2, 4, 5, -1},              // 1000
    {0, 1, 5, 0, 5, 4, -1},     // 1001
    {0, 3, 5, 0, 5, 2, -1},     // 1010
    {1, 3, 5, -1},              // 1011
    {1, 3, 4, 1, 4, 2, -1},     // 1100
    {0, 3, 4, -1},              // 1101
    {0, 1, 2, -1},              // 1110
    {-1},                       // 1111
};

long long marching_tets(const float* grid, long long r0, long long r1,
                        long long r2, float iso, double** out_verts,
                        long long** out_tris, long long* out_nv,
                        long long* out_nf) {
  const long long plane = r1 * r2;
  auto val = [&](long long f) -> double { return (double)grid[f]; };

  std::unordered_map<uint64_t, long long> edge_to_vertex;
  std::vector<double> verts;
  std::vector<long long> tris;
  edge_to_vertex.reserve(1 << 20);
  verts.reserve(3 << 20);
  tris.reserve(3 << 20);

  auto edge_vertex = [&](long long fa, long long fb) -> long long {
    long long lo = std::min(fa, fb), hi = std::max(fa, fb);
    uint64_t key = ((uint64_t)lo << 32) ^ (uint64_t)hi;  // r^3 < 2^31 assumed
    auto it = edge_to_vertex.find(key);
    if (it != edge_to_vertex.end()) return it->second;
    double v1 = val(lo), v2 = val(hi);
    double denom = v2 - v1;
    double t = (std::fabs(denom) > 1e-30) ? ((double)iso - v1) / denom : 0.5;
    t = std::min(1.0, std::max(0.0, t));
    double p1[3] = {(double)(lo / plane), (double)((lo / r2) % r1),
                    (double)(lo % r2)};
    double p2[3] = {(double)(hi / plane), (double)((hi / r2) % r1),
                    (double)(hi % r2)};
    long long id = (long long)(verts.size() / 3);
    for (int k = 0; k < 3; ++k) verts.push_back(p1[k] + t * (p2[k] - p1[k]));
    edge_to_vertex.emplace(key, id);
    return id;
  };

  for (long long i = 0; i + 1 < r0; ++i) {
    for (long long j = 0; j + 1 < r1; ++j) {
      const float* row0 = grid + i * plane + j * r2;
      const float* row1 = grid + i * plane + (j + 1) * r2;
      const float* row2 = grid + (i + 1) * plane + j * r2;
      const float* row3 = grid + (i + 1) * plane + (j + 1) * r2;
      for (long long k = 0; k + 1 < r2; ++k) {
        float c[8] = {row0[k],     row2[k],     row3[k],     row1[k],
                      row0[k + 1], row2[k + 1], row3[k + 1], row1[k + 1]};
        int inside = 0;
        for (int q = 0; q < 8; ++q) inside += (c[q] > iso);
        if (inside == 0 || inside == 8) continue;
        long long flat[8];
        bool ins[8];
        for (int q = 0; q < 8; ++q) {
          flat[q] = (i + CORNERS[q][0]) * plane + (j + CORNERS[q][1]) * r2 +
                    (k + CORNERS[q][2]);
          ins[q] = c[q] > iso;
        }
        for (int tt = 0; tt < 6; ++tt) {
          int code = 0;
          for (int q = 0; q < 4; ++q)
            if (ins[TETS[tt][q]]) code |= 1 << q;
          const int* tc = CASES[code];
          for (int e = 0; tc[e] >= 0; e += 3) {
            for (int w = 0; w < 3; ++w) {
              int eid = tc[e + w];
              long long fa = flat[TETS[tt][TET_EDGES[eid][0]]];
              long long fb = flat[TETS[tt][TET_EDGES[eid][1]]];
              tris.push_back(edge_vertex(fa, fb));
            }
          }
        }
      }
    }
  }

  // orient outward: flip triangles whose normal aligns with the field gradient
  long long nf = (long long)(tris.size() / 3);
  for (long long f = 0; f < nf; ++f) {
    long long ia = tris[3 * f], ib = tris[3 * f + 1], ic = tris[3 * f + 2];
    double cx = (verts[3 * ia] + verts[3 * ib] + verts[3 * ic]) / 3.0;
    double cy = (verts[3 * ia + 1] + verts[3 * ib + 1] + verts[3 * ic + 1]) / 3.0;
    double cz = (verts[3 * ia + 2] + verts[3 * ib + 2] + verts[3 * ic + 2]) / 3.0;
    long long gi = std::min(r0 - 1, std::max(0LL, (long long)std::lround(cx)));
    long long gj = std::min(r1 - 1, std::max(0LL, (long long)std::lround(cy)));
    long long gk = std::min(r2 - 1, std::max(0LL, (long long)std::lround(cz)));
    auto at = [&](long long a, long long b, long long cc) {
      return (double)grid[a * plane + b * r2 + cc];
    };
    double gx = at(std::min(r0 - 1, gi + 1), gj, gk) - at(std::max(0LL, gi - 1), gj, gk);
    double gy = at(gi, std::min(r1 - 1, gj + 1), gk) - at(gi, std::max(0LL, gj - 1), gk);
    double gz = at(gi, gj, std::min(r2 - 1, gk + 1)) - at(gi, gj, std::max(0LL, gk - 1));
    double ux = verts[3 * ib] - verts[3 * ia];
    double uy = verts[3 * ib + 1] - verts[3 * ia + 1];
    double uz = verts[3 * ib + 2] - verts[3 * ia + 2];
    double vx = verts[3 * ic] - verts[3 * ia];
    double vy = verts[3 * ic + 1] - verts[3 * ia + 1];
    double vz = verts[3 * ic + 2] - verts[3 * ia + 2];
    double nx = uy * vz - uz * vy;
    double ny = uz * vx - ux * vz;
    double nz = ux * vy - uy * vx;
    if (nx * gx + ny * gy + nz * gz > 0) std::swap(tris[3 * f + 1], tris[3 * f + 2]);
  }

  *out_nv = (long long)(verts.size() / 3);
  *out_nf = nf;
  *out_verts = (double*)malloc(verts.size() * sizeof(double));
  *out_tris = (long long*)malloc(tris.size() * sizeof(long long));
  if ((verts.size() && !*out_verts) || (tris.size() && !*out_tris)) {
    free(*out_verts);
    free(*out_tris);
    *out_verts = nullptr;
    *out_tris = nullptr;
    return 1;  // allocation failed; caller raises and falls back
  }
  std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(double));
  std::memcpy(*out_tris, tris.data(), tris.size() * sizeof(long long));
  return 0;
}

void free_buffers(void* a, void* b) {
  free(a);
  free(b);
}

void points_occupancy(const double* verts, long long nv, const long long* tris,
                      long long nf, const double* points, long long np,
                      double* out) {
  if (nf == 0) {
    for (long long i = 0; i < np; ++i) out[i] = 0.0;
    return;
  }
  // bounds in xy
  double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
  for (long long i = 0; i < nv; ++i) {
    minx = std::min(minx, verts[3 * i]);
    maxx = std::max(maxx, verts[3 * i]);
    miny = std::min(miny, verts[3 * i + 1]);
    maxy = std::max(maxy, verts[3 * i + 1]);
  }
  minx -= 1e-9; miny -= 1e-9; maxx += 1e-9; maxy += 1e-9;
  int ncell = (int)std::sqrt((double)nf / 4.0);
  ncell = std::max(1, std::min(512, ncell));
  double cw = (maxx - minx) / ncell, ch = (maxy - miny) / ncell;
  auto cellx = [&](double x) {
    return std::min(ncell - 1, std::max(0, (int)((x - minx) / cw)));
  };
  auto celly = [&](double y) {
    return std::min(ncell - 1, std::max(0, (int)((y - miny) / ch)));
  };

  // the triangles over each cell's xy box as a CSR (a count pass, then a
  // fill pass); the order within a cell does not matter, as a point's
  // hits are only counted
  const long long grain = 1 << 14;
  auto box = [&](long long f, int* x0, int* x1, int* y0, int* y1) {
    const double* A = verts + 3 * tris[3 * f];
    const double* B = verts + 3 * tris[3 * f + 1];
    const double* C = verts + 3 * tris[3 * f + 2];
    *x0 = cellx(std::min({A[0], B[0], C[0]}));
    *x1 = cellx(std::max({A[0], B[0], C[0]}));
    *y0 = celly(std::min({A[1], B[1], C[1]}));
    *y1 = celly(std::max({A[1], B[1], C[1]}));
  };
  std::vector<long long> start((size_t)ncell * ncell + 1, 0);
  long long* const sp = start.data();
  parallel_for(nf, grain, [&](long long b, long long e) {
    int x0, x1, y0, y1;
    for (long long f = b; f < e; ++f) {
      box(f, &x0, &x1, &y0, &y1);
      for (int x = x0; x <= x1; ++x)
        for (int y = y0; y <= y1; ++y) __atomic_fetch_add(&sp[(size_t)x * ncell + y + 1], 1, __ATOMIC_RELAXED);
    }
  });
  for (size_t c = 0; c + 1 < start.size(); ++c) sp[c + 1] += sp[c];
  std::vector<int> members((size_t)sp[(size_t)ncell * ncell]);
  {
    std::vector<long long> fill(start.begin(), start.end() - 1);
    long long* const fp = fill.data();
    parallel_for(nf, grain, [&](long long b, long long e) {
      int x0, x1, y0, y1;
      for (long long f = b; f < e; ++f) {
        box(f, &x0, &x1, &y0, &y1);
        for (int x = x0; x <= x1; ++x)
          for (int y = y0; y <= y1; ++y)
            members[(size_t)__atomic_fetch_add(&fp[(size_t)x * ncell + y], 1, __ATOMIC_RELAXED)] = (int)f;
      }
    });
  }

  const double ex = 1.3e-7, ey = 2.9e-7;  // degeneracy-breaking shift
  parallel_for(np, 1 << 10, [&](long long b, long long e) {
    for (long long i = b; i < e; ++i) {
      double px = points[3 * i] + ex, py = points[3 * i + 1] + ey,
             pz = points[3 * i + 2];
      if (px < minx || px > maxx || py < miny || py > maxy) {
        out[i] = 0.0;
        continue;
      }
      const size_t cell = (size_t)cellx(px) * ncell + celly(py);
      int hits = 0;
      for (long long m = sp[cell]; m < sp[cell + 1]; ++m) {
        const int f = members[(size_t)m];
        const double* A = verts + 3 * tris[3 * f];
        const double* B = verts + 3 * tris[3 * f + 1];
        const double* C = verts + 3 * tris[3 * f + 2];
        double d = (B[1] - C[1]) * (A[0] - C[0]) + (C[0] - B[0]) * (A[1] - C[1]);
        if (std::fabs(d) < 1e-30) continue;
        double w0 = ((B[1] - C[1]) * (px - C[0]) + (C[0] - B[0]) * (py - C[1])) / d;
        double w1 = ((C[1] - A[1]) * (px - C[0]) + (A[0] - C[0]) * (py - C[1])) / d;
        double w2 = 1.0 - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        double z = w0 * A[2] + w1 * B[2] + w2 * C[2];
        if (z > pz) ++hits;
      }
      out[i] = (hits & 1) ? 1.0 : 0.0;
    }
  });
}

// v' = (v + sum(unique neighbors)) / (1 + deg), `iters` times.
// out must hold nv*3 doubles; verts/out may not alias.
void smooth_simple(const double* verts, long long nv, const long long* tris,
                   long long nt, long long iters, double* out) {
  if (nv == 0) return;
  // CSR of the directed edges (both directions of every triangle edge),
  // bucketed by source vertex (a counting sort), then each row sorted and
  // deduped: the unique neighbors in ascending order, as a global
  // sort+unique of (row, col) keys gives them (the scipy-CSR fallback's
  // duplicate-sum reset), in O(E) plus one small sort per vertex. The
  // order in which threads fill a row does not matter: the row is sorted.
  const long long grain = 1 << 16;
  std::vector<long long> indptr((size_t)nv + 1, 0);
  long long* const ip = indptr.data();
  parallel_for(3 * nt, grain, [&](long long b, long long e) {
    for (long long i = b; i < e; ++i) __atomic_fetch_add(&ip[tris[i] + 1], 2, __ATOMIC_RELAXED);
  });
  for (long long i = 0; i < nv; ++i) ip[i + 1] += ip[i];
  std::vector<long long> indices((size_t)ip[nv]);
  long long* const ix = indices.data();
  {
    std::vector<long long> fill(indptr.begin(), indptr.end() - 1);
    long long* const fp = fill.data();
    auto put = [&](long long r, long long a, long long b) {
      const long long at = __atomic_fetch_add(&fp[r], 2, __ATOMIC_RELAXED);
      ix[at] = a;
      ix[at + 1] = b;
    };
    parallel_for(nt, grain, [&](long long b, long long e) {
      for (long long i = b; i < e; ++i) {
        const long long x = tris[3 * i], y = tris[3 * i + 1], z = tris[3 * i + 2];
        put(x, y, z);
        put(y, z, x);
        put(z, x, y);
      }
    });
  }
  std::vector<long long> unique((size_t)nv);
  parallel_for(nv, grain, [&](long long b, long long e) {
    for (long long i = b; i < e; ++i) {
      long long* const row = ix + ip[i];
      const long long len = ip[i + 1] - ip[i];
      std::sort(row, row + len);
      unique[(size_t)i] = std::unique(row, row + len) - row;
    }
  });
  long long w = 0;
  for (long long i = 0; i < nv; ++i) {
    const long long from = ip[i], n = unique[(size_t)i];
    ip[i] = w;
    if (from != w) std::memmove(ix + w, ix + from, (size_t)n * sizeof(long long));
    w += n;
  }
  ip[nv] = w;
  std::vector<double> cur(verts, verts + 3 * nv), nxt((size_t)3 * nv);
  for (long long it = 0; it < iters; ++it) {
    const double* const c = cur.data();
    double* const x = nxt.data();
    parallel_for(nv, grain, [&](long long b, long long e) {
      for (long long i = b; i < e; ++i) {
        double sx = c[3 * i], sy = c[3 * i + 1], sz = c[3 * i + 2];
        const long long e0 = ip[i], e1 = ip[i + 1];
        for (long long k = e0; k < e1; ++k) {
          const long long j = ix[k];
          sx += c[3 * j];
          sy += c[3 * j + 1];
          sz += c[3 * j + 2];
        }
        const double inv = 1.0 / (1.0 + (double)(e1 - e0));
        x[3 * i] = sx * inv;
        x[3 * i + 1] = sy * inv;
        x[3 * i + 2] = sz * inv;
      }
    });
    cur.swap(nxt);
  }
  std::memcpy(out, cur.data(), (size_t)3 * nv * sizeof(double));
}

// 0.5 * |(v1 - v0) x (v2 - v0)| per triangle, with NumPy's operations in
// NumPy's order (np.cross: a1*b2 - a2*b1, ...; np.linalg.norm over three:
// (x0^2 + x1^2) + x2^2) and no fused multiply-add, so the areas equal
// geometry/mesh.py's NumPy spec bit for bit.
__attribute__((optimize("fp-contract=off")))
static void triangle_areas_range(const double* verts, const long long* tris, long long b, long long e,
                                 double* out) {
  for (long long i = b; i < e; ++i) {
    const double* A = verts + 3 * tris[3 * i];
    const double* B = verts + 3 * tris[3 * i + 1];
    const double* C = verts + 3 * tris[3 * i + 2];
    const double a0 = B[0] - A[0], a1 = B[1] - A[1], a2 = B[2] - A[2];
    const double b0 = C[0] - A[0], b1 = C[1] - A[1], b2 = C[2] - A[2];
    const double c0 = a1 * b2 - a2 * b1, c1 = a2 * b0 - a0 * b2, c2 = a0 * b1 - a1 * b0;
    out[i] = 0.5 * std::sqrt((c0 * c0 + c1 * c1) + c2 * c2);
  }
}

void triangle_areas(const double* verts, const long long* tris, long long nt, double* out) {
  parallel_for(nt, 1 << 16, [&](long long b, long long e) { triangle_areas_range(verts, tris, b, e, out); });
}

long long write_obj(const char* path, const double* verts, long long nv,
                    const long long* tris, long long nt) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  // std::to_chars with (general, 8) prints exactly what printf's "%.8g"
  // prints, several times faster; each line is under 128 bytes
  const size_t cap = 1 << 22;
  std::vector<char> buf(cap + 128);
  char* const b = buf.data();
  char* const last = b + buf.size();
  size_t len = 0;
  bool ok = true;
  auto flush = [&]() {
    // a short fwrite (e.g. ENOSPC) must fail the call, or the Python
    // fallback writer never runs and a truncated OBJ reads as success
    if (ok && len && std::fwrite(b, 1, len, f) != len) ok = false;
    len = 0;
  };
  for (long long i = 0; i < nv; ++i) {
    b[len++] = 'v';
    for (int k = 0; k < 3; ++k) {
      b[len++] = ' ';
      len = std::to_chars(b + len, last, verts[3 * i + k], std::chars_format::general, 8).ptr - b;
    }
    b[len++] = '\n';
    if (len > cap) flush();
  }
  for (long long i = 0; i < nt; ++i) {
    b[len++] = 'f';
    for (int k = 0; k < 3; ++k) {
      b[len++] = ' ';
      len = std::to_chars(b + len, last, tris[3 * i + k] + 1).ptr - b;
    }
    b[len++] = '\n';
    if (len > cap) flush();
  }
  flush();
  if (std::ferror(f)) ok = false;
  const int rc = std::fclose(f);
  return (ok && rc == 0) ? 0 : 2;
}

long long read_obj(const char* path, double** out_verts, long long** out_tris,
                   long long* out_nv, long long* out_nt) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::vector<char> text;
  char chunk[1 << 16];
  size_t got;
  if (std::fseek(f, 0, SEEK_END) == 0) {
    const long size = std::ftell(f);
    if (size > 0) text.reserve((size_t)size + 1);
    std::rewind(f);
  }
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    text.insert(text.end(), chunk, chunk + got);
  const bool bad = std::ferror(f);
  std::fclose(f);
  if (bad) return 1;
  text.push_back('\0');  // strtod/strtoll stop before the end
  // std::from_chars parses a plain number as strtod/strtoll do (both round
  // correctly); where it refuses or stops inside a token ("+1", "0x1p3",
  // out of range), the C parser reads the token as before
  auto number = [](const char* q, const char* eol, auto& x, char** stop) {
    using T = std::remove_reference_t<decltype(x)>;
    if (*q != '+') {
      const std::from_chars_result r = std::from_chars(q, eol, x);
      if (r.ec == std::errc() && (r.ptr == eol || *r.ptr == ' ' || *r.ptr == '\t' || *r.ptr == '\r' ||
                                  *r.ptr == '\v' || *r.ptr == '\f' || (!std::is_floating_point_v<T> && *r.ptr == '/'))) {
        *stop = const_cast<char*>(r.ptr);
        return;
      }
    }
    if constexpr (std::is_floating_point_v<T>) x = std::strtod(q, stop);
    else x = std::strtoll(q, stop, 10);
  };
  std::vector<double> verts;
  std::vector<long long> tris, idx;
  const char* p = text.data();
  const char* end = p + text.size() - 1;
  auto blank = [](char c) { return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f'; };
  while (p < end) {
    const char* eol = static_cast<const char*>(std::memchr(p, '\n', end - p));
    if (!eol) eol = end;
    if (eol - p >= 2 && p[1] == ' ' && (p[0] == 'v' || p[0] == 'f')) {
      const char* q = p + 2;
      if (p[0] == 'v') {
        for (int k = 0; k < 3; ++k) {
          while (q < eol && blank(*q)) ++q;
          char* stop;
          double x;
          number(q, eol, x, &stop);
          if (stop == q || stop > eol) return 3;
          verts.push_back(x);
          q = stop;
        }
      } else {
        idx.clear();
        while (true) {
          while (q < eol && blank(*q)) ++q;
          if (q >= eol) break;
          char* stop;
          long long i;
          number(q, eol, i, &stop);
          if (stop == q) return 3;
          idx.push_back(i - 1);
          q = stop;
          while (q < eol && !blank(*q)) ++q;  // the rest of "a/b/c"
        }
        for (size_t k = 1; k + 1 < idx.size(); ++k) {
          tris.push_back(idx[0]);
          tris.push_back(idx[k]);
          tris.push_back(idx[k + 1]);
        }
      }
    }
    p = eol + 1;
  }
  *out_nv = (long long)(verts.size() / 3);
  *out_nt = (long long)(tris.size() / 3);
  *out_verts = (double*)std::malloc(std::max<size_t>(verts.size(), 1) * sizeof(double));
  *out_tris = (long long*)std::malloc(std::max<size_t>(tris.size(), 1) * sizeof(long long));
  if (!*out_verts || !*out_tris) {
    std::free(*out_verts);
    std::free(*out_tris);
    return 1;
  }
  std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(double));
  std::memcpy(*out_tris, tris.data(), tris.size() * sizeof(long long));
  return 0;
}

}  // extern "C"

// 9. raster_triangles: the z-buffer loop of geometry/render.py::render_scene.
//    Triangles in drawing order (far first); a pixel takes a triangle's
//    colour where its barycentric weights are all >= 0 and its depth is
//    strictly nearer than the buffer's, so among equal depths the first
//    drawn stays. The weights and depth are NumPy's expressions in NumPy's
//    order (no fused multiply-add); rows are split over threads, each
//    walking every triangle in order, so the image does not depend on the
//    split.
__attribute__((optimize("fp-contract=off")))
static void raster_rows(const double* xs, const double* ys, const double* zs, const long long* x0,
                        const long long* x1, const long long* y0, const long long* y1, const double* d,
                        const long long* kept, long long nk, const double* colors, long long width,
                        long long r0, long long r1, double* zbuf, double* rgb) {
  for (long long k = 0; k < nk; ++k) {
    const long long ti = kept[k];
    const long long ya = std::max(y0[ti], r0), yz = std::min(y1[ti], r1 - 1);
    if (ya > yz) continue;
    const double xa = xs[3 * ti], xb = xs[3 * ti + 1], xc = xs[3 * ti + 2];
    const double ya_ = ys[3 * ti], yb = ys[3 * ti + 1], yc = ys[3 * ti + 2];
    const double za = zs[3 * ti], zb = zs[3 * ti + 1], zc = zs[3 * ti + 2];
    const double dd = d[ti];
    for (long long gy = ya; gy <= yz; ++gy) {
      const double fy = (double)gy;
      for (long long gx = x0[ti]; gx <= x1[ti]; ++gx) {
        const double fx = (double)gx;
        const double w0 = ((yb - yc) * (fx - xc) + (xc - xb) * (fy - yc)) / dd;
        const double w1 = ((yc - ya_) * (fx - xc) + (xa - xc) * (fy - yc)) / dd;
        const double w2 = 1.0 - w0 - w1;
        const double depth = w0 * za + w1 * zb + w2 * zc;
        if (!(w0 >= 0 && w1 >= 0 && w2 >= 0 && depth < HUGE_VAL)) continue;
        const long long p = gy * width + gx;
        if (depth < zbuf[p]) {
          zbuf[p] = depth;
          rgb[3 * p] = colors[3 * ti];
          rgb[3 * p + 1] = colors[3 * ti + 1];
          rgb[3 * p + 2] = colors[3 * ti + 2];
        }
      }
    }
  }
}

extern "C" void raster_triangles(const double* xs, const double* ys, const double* zs, const long long* x0,
                                 const long long* x1, const long long* y0, const long long* y1, const double* d,
                                 const long long* kept, long long nk, const double* colors, long long width,
                                 long long height, double* zbuf, double* rgb) {
  parallel_for(height, 8, [&](long long b, long long e) {
    raster_rows(xs, ys, zs, x0, x1, y0, y1, d, kept, nk, colors, width, b, e, zbuf, rgb);
  });
}

// ---------------------------------------------------------------------------
// 7. zstd_decompress: a Zstandard frame decoder after RFC 8878 (the orbax
//    reader's codec: tensorstore's OCDBT nodes and zarr chunks are zstd
//    frames). Frames one after another, skippable frames, raw / RLE /
//    compressed blocks; literals raw, RLE, Huffman-coded in 1 or 4 streams
//    or with the previous block's tree; sequences with predefined, RLE, FSE
//    or repeated tables and the repeat offsets; the XXH64 content checksum
//    verified when the frame carries one. Frames naming a dictionary are
//    refused. Every read is bounds-checked: bad input raises, never reads
//    past the buffer.
// 8. crc32c: CRC-32C (Castagnoli), the checksum OCDBT files end with.
// ---------------------------------------------------------------------------

#include <stdexcept>
#include <string>

namespace zstd {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] static void fail(const std::string& msg) { throw Error("zstd: " + msg); }

static inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static uint64_t read_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= (uint64_t)p[i] << (8 * i);
  return v;
}

static uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed = 0) {
  const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                 P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;
  auto round = [&](uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; };
  auto merge = [&](uint64_t acc, uint64_t v) { return (acc ^ round(0, v)) * P1 + P4; };
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = round(v1, read_le(p, 8));
      v2 = round(v2, read_le(p + 8, 8));
      v3 = round(v3, read_le(p + 16, 8));
      v4 = round(v4, read_le(p + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ round(0, read_le(p, 8)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (read_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// A byte range of the input with a read cursor.
struct Span {
  const uint8_t* p;
  size_t n;
  size_t i = 0;
  size_t left() const { return n - i; }
  const uint8_t* take(size_t k, const char* what) {
    if (k > left()) fail(std::string("truncated input (") + what + ")");
    const uint8_t* r = p + i;
    i += k;
    return r;
  }
  uint8_t byte(const char* what) { return *take(1, what); }
};

// Forward bit reader (LSB first), for FSE table descriptions.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int b = 0; b < k; ++b) {
      size_t q = pos + b;
      if ((q >> 3) < n) v |= (uint32_t)((p[q >> 3] >> (q & 7)) & 1) << b;
    }
    return v;
  }
  void skip(int k) {
    pos += k;
    if (pos > 8 * n) fail("truncated table description");
  }
};

// Backward bit reader: the stream's last byte holds a 1 bit above its
// highest data bit; reads take the highest remaining bits first. Reads past
// the start yield zeros and leave `pos` negative (the FSE and Huffman
// decoders test for it).
struct BackBits {
  std::vector<uint8_t> buf;  // 8 zero bytes, the stream, 8 zero bytes
  int64_t pos;               // bits left
  BackBits(const uint8_t* p, size_t n) {
    if (n == 0) fail("empty bitstream");
    if (p[n - 1] == 0) fail("bitstream without its end marker");
    buf.assign(n + 16, 0);
    std::memcpy(buf.data() + 8, p, n);
    int hb = 7;
    while (!((p[n - 1] >> hb) & 1)) --hb;
    pos = (int64_t)(n - 1) * 8 + hb;
  }
  uint64_t peek(int k) const {  // k <= 56
    if (k == 0) return 0;
    int64_t lo = pos - k;
    if (lo < -64) fail("bitstream overread");
    int64_t bit = lo + 64;
    uint64_t w;
    std::memcpy(&w, buf.data() + (bit >> 3), 8);
    return (w >> (bit & 7)) & ((1ULL << k) - 1);
  }
  uint64_t get(int k) {
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
};

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint32_t base;
};

struct Fse {
  int log = 0;
  std::vector<FseEntry> t;
};

static int highbit(uint32_t v) {
  int r = 0;
  while (v >>= 1) ++r;
  return r;
}

static Fse build_fse(const std::vector<int16_t>& norm, int log) {
  Fse f;
  f.log = log;
  const uint32_t size = 1u << log;
  f.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  uint32_t high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      f.t[high--].symbol = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint32_t)std::max<int>(norm[s], 0);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      f.t[pos].symbol = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table description does not fill the table");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t x = next[f.t[u].symbol]++;
    int bits = log - highbit(x);
    f.t[u].bits = (uint8_t)bits;
    f.t[u].base = (x << bits) - size;
  }
  return f;
}

static Fse rle_fse(uint16_t symbol) {
  Fse f;
  f.log = 0;
  f.t.assign(1, FseEntry{symbol, 0, 0});
  return f;
}

// An FSE table description (RFC 8878 4.1.1) from the start of `in`.
static Fse read_fse(Span& in, int max_log, int max_symbol) {
  FwdBits br{in.p + in.i, in.left()};
  int log = (int)br.peek(4) + 5;
  br.skip(4);
  if (log > max_log) fail("FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log));
  int32_t remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  std::vector<int16_t> norm;
  bool prev0 = false;
  while (remaining > 1) {
    if (prev0) {
      size_t n0 = norm.size();
      while (br.peek(2) == 3) {
        n0 += 3;
        br.skip(2);
      }
      n0 += br.peek(2);
      br.skip(2);
      if (n0 > (size_t)max_symbol) fail("FSE table description past the last symbol");
      while (norm.size() < n0) norm.push_back(0);
    }
    if ((int)norm.size() > max_symbol) fail("FSE table description past the last symbol");
    int32_t mx = (2 * threshold - 1) - remaining;
    int32_t count;
    if ((int32_t)(br.peek(nbits - 1)) < mx) {
      count = (int32_t)br.peek(nbits - 1);
      br.skip(nbits - 1);
    } else {
      count = (int32_t)br.peek(nbits);
      if (count >= threshold) count -= mx;
      br.skip(nbits);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm.push_back((int16_t)count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE table description: probabilities do not sum to the table size");
  in.take((br.pos + 7) >> 3, "FSE table description");
  return build_fse(norm, log);
}

struct Huffman {
  int log = 0;
  std::vector<uint16_t> dt;  // by the next `log` bits: symbol | bits consumed << 8
};

// Huffman tree description (RFC 8878 4.2.1), from the start of `in`.
static Huffman read_huffman(Span& in) {
  uint8_t head = in.byte("Huffman tree description");
  std::vector<uint8_t> w;
  if (head >= 128) {
    int n = head - 127;
    const uint8_t* q = in.take((n + 1) / 2, "Huffman weights");
    for (int i = 0; i < n; ++i) w.push_back(i % 2 ? q[i / 2] & 15 : q[i / 2] >> 4);
  } else {
    Span sub{in.take(head, "Huffman weights"), head};
    Fse f = read_fse(sub, 6, 255);
    BackBits b(sub.p + sub.i, sub.left());
    uint32_t s1 = (uint32_t)b.get(f.log), s2 = (uint32_t)b.get(f.log);
    if (b.pos < 0) fail("Huffman weights bitstream too short");
    // two interleaved states; the stream ends when a state update reads past its start
    for (;;) {
      if (w.size() > 254) fail("too many Huffman weights");
      const FseEntry& e1 = f.t[s1];
      w.push_back((uint8_t)e1.symbol);
      s1 = e1.base + (uint32_t)b.get(e1.bits);
      if (b.pos < 0) {
        w.push_back((uint8_t)f.t[s2].symbol);
        break;
      }
      const FseEntry& e2 = f.t[s2];
      w.push_back((uint8_t)e2.symbol);
      s2 = e2.base + (uint32_t)b.get(e2.bits);
      if (b.pos < 0) {
        w.push_back((uint8_t)f.t[s1].symbol);
        break;
      }
    }
  }
  uint64_t total = 0;
  for (uint8_t x : w) {
    if (x > 11) fail("Huffman weight above 11");
    if (x) total += 1ULL << (x - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int log = highbit((uint32_t)total) + 1;
  if (log > 11) fail("Huffman table log above 11");
  uint64_t rest = (1ULL << log) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not complete a tree");
  w.push_back((uint8_t)(highbit((uint32_t)rest) + 1));
  if (w.size() > 256) fail("too many Huffman symbols");
  Huffman h;
  h.log = log;
  h.dt.assign(1u << log, 0);
  std::vector<uint32_t> start(log + 2, 0);
  uint32_t next = 0;
  for (int wt = 1; wt <= log; ++wt) {
    start[wt] = next;
    for (uint8_t x : w) if (x == wt) next += 1u << (wt - 1);
  }
  for (size_t s = 0; s < w.size(); ++s) {
    if (!w[s]) continue;
    uint32_t len = 1u << (w[s] - 1);
    for (uint32_t k = 0; k < len; ++k) h.dt[start[w[s]] + k] = (uint16_t)(s | (log + 1 - w[s]) << 8);
    start[w[s]] += len;
  }
  return h;
}

// Decode `count[k]` symbols from each of `n` Huffman streams, interleaved
// (the streams are independent, so their lookups overlap). Each stream must
// be consumed exactly.
static void huffman_streams(const Huffman& h, int n, const uint8_t* const* p, const size_t* len,
                            uint8_t* const* out, const size_t* count) {
  std::vector<BackBits> b;
  for (int k = 0; k < n; ++k) b.emplace_back(p[k], len[k]);
  const int log = h.log;
  const uint64_t mask = (1ULL << log) - 1;
  const uint16_t* dt = h.dt.data();
  size_t common = count[0];
  for (int k = 1; k < n; ++k) common = std::min(common, count[k]);
  // while every stream has `log` bits left no read falls below its start
  auto step = [&](BackBits& s, uint8_t* o) {
    int64_t bit = s.pos - log + 64;
    uint64_t w;
    std::memcpy(&w, s.buf.data() + (bit >> 3), 8);
    uint16_t e = dt[(w >> (bit & 7)) & mask];
    *o = (uint8_t)e;
    s.pos -= e >> 8;
  };
  size_t i = 0;
  if (n == 4) {
    for (; i < common; ++i) {
      if (b[0].pos < log || b[1].pos < log || b[2].pos < log || b[3].pos < log) break;
      step(b[0], out[0] + i);
      step(b[1], out[1] + i);
      step(b[2], out[2] + i);
      step(b[3], out[3] + i);
    }
  }
  for (int k = 0; k < n; ++k) {
    for (size_t j = i; j < count[k]; ++j) {
      uint16_t e = dt[b[k].peek(log)];
      out[k][j] = (uint8_t)e;
      b[k].pos -= e >> 8;
    }
    if (b[k].pos != 0) fail("Huffman stream not consumed exactly");
  }
}

static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
static const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,   6,   7,   8,    9,    10,   11,
                                     12, 13, 14, 15, 16, 18,  20,  22,  24,   28,   32,   40,
                                     48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                                     17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                                     31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                                     99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// What a frame's blocks carry over to the next block.
struct FrameState {
  bool have_huffman = false;
  Huffman huffman;
  Fse tables[3];  // literal lengths, offsets, match lengths
  bool have_table[3] = {false, false, false};
  uint64_t rep[3] = {1, 4, 8};
};

static size_t read_literals(Span& in, FrameState& st, std::vector<uint8_t>& lit) {
  uint8_t b0 = in.byte("literals header");
  int type = b0 & 3, fmt = (b0 >> 2) & 3;
  size_t regen, comp = 0;
  int streams = 1;
  if (type < 2) {
    if ((fmt & 1) == 0) {
      regen = b0 >> 3;
    } else if (fmt == 1) {
      regen = (b0 >> 4) + ((size_t)in.byte("literals header") << 4);
    } else {
      const uint8_t* q = in.take(2, "literals header");
      regen = (b0 >> 4) + ((size_t)q[0] << 4) + ((size_t)q[1] << 12);
    }
  } else {
    int extra = fmt < 2 ? 2 : fmt == 2 ? 3 : 4;
    uint64_t v = b0 | (read_le(in.take(extra, "literals header"), extra) << 8);
    int sz = fmt < 2 ? 10 : fmt == 2 ? 14 : 18;
    regen = (v >> 4) & ((1ULL << sz) - 1);
    comp = (v >> (4 + sz)) & ((1ULL << sz) - 1);
    streams = fmt == 0 ? 1 : 4;
  }
  if (regen > (128u << 10)) fail("literals larger than a block");
  lit.resize(regen);
  if (type == 0) {
    std::memcpy(lit.data(), in.take(regen, "raw literals"), regen);
  } else if (type == 1) {
    std::memset(lit.data(), in.byte("RLE literal"), regen);
  } else {
    Span body{in.take(comp, "compressed literals"), comp};
    if (type == 2) {
      st.huffman = read_huffman(body);
      st.have_huffman = true;
    } else if (!st.have_huffman) {
      fail("treeless literals with no earlier Huffman tree");
    }
    if (streams == 1) {
      const uint8_t* p = body.p + body.i;
      size_t n = body.left();
      uint8_t* o = lit.data();
      huffman_streams(st.huffman, 1, &p, &n, &o, &regen);
    } else {
      const uint8_t* jt = body.take(6, "jump table");
      size_t s[4] = {(size_t)read_le(jt, 2), (size_t)read_le(jt + 2, 2), (size_t)read_le(jt + 4, 2), 0};
      if (s[0] + s[1] + s[2] > body.left()) fail("jump table past the literals");
      s[3] = body.left() - s[0] - s[1] - s[2];
      size_t per = (regen + 3) / 4;
      if (3 * per > regen) fail("4 literal streams for too few literals");
      const uint8_t* p[4];
      uint8_t* o[4];
      size_t cnt[4];
      for (int k = 0; k < 4; ++k) {
        p[k] = body.take(s[k], "literal stream");
        o[k] = lit.data() + k * per;
        cnt[k] = k < 3 ? per : regen - 3 * per;
      }
      huffman_streams(st.huffman, 4, p, s, o, cnt);
    }
  }
  return regen;
}

static void read_table(Span& in, int mode, int which, FrameState& st) {
  static const int max_log[3] = {9, 8, 9}, max_sym[3] = {35, 31, 52};
  if (mode == 0) {
    if (which == 0) st.tables[0] = build_fse(std::vector<int16_t>(LL_DEFAULT, LL_DEFAULT + 36), 6);
    if (which == 1) st.tables[1] = build_fse(std::vector<int16_t>(OF_DEFAULT, OF_DEFAULT + 29), 5);
    if (which == 2) st.tables[2] = build_fse(std::vector<int16_t>(ML_DEFAULT, ML_DEFAULT + 53), 6);
  } else if (mode == 1) {
    uint8_t s = in.byte("RLE symbol");
    if (s > max_sym[which]) fail("RLE sequence symbol out of range");
    st.tables[which] = rle_fse(s);
  } else if (mode == 2) {
    st.tables[which] = read_fse(in, max_log[which], max_sym[which]);
  } else if (!st.have_table[which]) {
    fail("repeated sequence table with no earlier table");
  }
  st.have_table[which] = true;
}

static void compressed_block(Span in, FrameState& st, std::vector<uint8_t>& out, uint64_t window) {
  std::vector<uint8_t> lit;
  size_t nlit = read_literals(in, st, lit);
  uint32_t nseq = in.byte("sequences header");
  if (nseq >= 128) {
    uint8_t b1 = in.byte("sequences header");
    if (nseq < 255) {
      nseq = ((nseq - 128) << 8) + b1;
    } else {
      nseq = b1 + ((uint32_t)in.byte("sequences header") << 8) + 0x7F00;
    }
  }
  size_t start = out.size();
  if (nseq == 0) {
    if (in.left()) fail("bytes after a block without sequences");
    out.insert(out.end(), lit.begin(), lit.end());
    return;
  }
  uint8_t modes = in.byte("sequence modes");
  if (modes & 3) fail("reserved bits set in the sequence modes");
  read_table(in, modes >> 6, 0, st);
  read_table(in, (modes >> 4) & 3, 1, st);
  read_table(in, (modes >> 2) & 3, 2, st);
  const Fse &ll = st.tables[0], &of = st.tables[1], &ml = st.tables[2];
  BackBits b(in.p + in.i, in.left());
  uint32_t sl = (uint32_t)b.get(ll.log), so = (uint32_t)b.get(of.log), sm = (uint32_t)b.get(ml.log);
  size_t lpos = 0;
  for (uint32_t k = 0; k < nseq; ++k) {
    const FseEntry &el = ll.t[sl], &eo = of.t[so], &em = ml.t[sm];
    if (eo.symbol > 31 || em.symbol > 52 || el.symbol > 35) fail("sequence code out of range");
    uint64_t ofv = (1ULL << eo.symbol) + b.get(eo.symbol);
    uint64_t mlen = ML_BASE[em.symbol] + b.get(ML_BITS[em.symbol]);
    uint64_t llen = LL_BASE[el.symbol] + b.get(LL_BITS[el.symbol]);
    if (k + 1 < nseq) {
      sl = el.base + (uint32_t)b.get(el.bits);
      sm = em.base + (uint32_t)b.get(em.bits);
      so = eo.base + (uint32_t)b.get(eo.bits);
    }
    if (b.pos < 0) fail("sequences bitstream overread");
    uint64_t off;
    if (ofv > 3) {
      off = ofv - 3;
      st.rep[2] = st.rep[1];
      st.rep[1] = st.rep[0];
      st.rep[0] = off;
    } else {
      uint64_t idx = ofv - 1 + (llen == 0);
      if (idx == 0) {
        off = st.rep[0];
      } else {
        off = idx == 3 ? st.rep[0] - 1 : st.rep[idx];
        if (idx != 1) st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = off;
      }
    }
    if (llen > nlit - lpos) fail("sequence takes more literals than the block has");
    out.insert(out.end(), lit.begin() + lpos, lit.begin() + lpos + llen);
    lpos += llen;
    if (off == 0 || off > out.size() || off > window) fail("match offset out of range");
    size_t from = out.size() - off;
    if (out.size() + mlen - start > (128u << 10)) fail("block larger than 128 KiB");
    size_t at = out.size();
    out.resize(at + mlen);
    uint8_t* o = out.data();
    if (off >= mlen) {
      std::memcpy(o + at, o + from, mlen);
    } else {
      for (uint64_t j = 0; j < mlen; ++j) o[at + j] = o[from + j];
    }
  }
  if (b.pos != 0) fail("sequences bitstream not consumed exactly");
  out.insert(out.end(), lit.begin() + lpos, lit.end());
  if (out.size() - start > (128u << 10)) fail("block larger than 128 KiB");
}

static void frame(Span& in, std::vector<uint8_t>& out) {
  uint8_t fhd = in.byte("frame header");
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit set in the frame header");
  uint64_t window = 0;
  if (!single) {
    uint8_t wd = in.byte("window descriptor");
    uint64_t base = 1ULL << (10 + (wd >> 3));
    window = base + (base / 8) * (wd & 7);
  }
  static const int did_size[4] = {0, 1, 2, 4};
  if (did_flag) {
    uint64_t did = read_le(in.take(did_size[did_flag], "dictionary ID"), did_size[did_flag]);
    if (did) fail("the frame names dictionary " + std::to_string(did) + "; dictionaries are not supported");
  }
  int fcs_size = fcs_flag == 0 ? single : 1 << fcs_flag;
  uint64_t fcs = 0;
  bool have_fcs = fcs_size > 0;
  if (have_fcs) {
    fcs = read_le(in.take(fcs_size, "frame content size"), fcs_size);
    if (fcs_size == 2) fcs += 256;
  }
  if (single) window = fcs;
  size_t start = out.size();
  if (have_fcs) out.reserve(start + fcs);
  FrameState st;
  for (bool last = false; !last;) {
    uint32_t bh = (uint32_t)read_le(in.take(3, "block header"), 3);
    last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 0) {
      const uint8_t* q = in.take(size, "raw block");
      out.insert(out.end(), q, q + size);
    } else if (type == 1) {
      out.insert(out.end(), size, in.byte("RLE block"));
    } else if (type == 2) {
      if (size > (128u << 10)) fail("compressed block larger than 128 KiB");
      compressed_block(Span{in.take(size, "compressed block"), size}, st, out,
                       std::max<uint64_t>(window, out.size() - start));
    } else {
      fail("reserved block type");
    }
    if (have_fcs && out.size() - start > fcs) fail("frame larger than its content size");
  }
  if (have_fcs && out.size() - start != fcs) fail("frame smaller than its content size");
  if (checksum) {
    uint32_t want = (uint32_t)read_le(in.take(4, "content checksum"), 4);
    if ((uint32_t)xxh64(out.data() + start, out.size() - start) != want) fail("content checksum mismatch");
  }
}

static void decompress(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  Span in{p, n};
  if (n == 0) fail("empty input");
  while (in.left()) {
    uint32_t magic = (uint32_t)read_le(in.take(4, "frame magic"), 4);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      uint32_t size = (uint32_t)read_le(in.take(4, "skippable frame size"), 4);
      in.take(size, "skippable frame");
    } else if (magic == 0xFD2FB528u) {
      frame(in, out);
    } else {
      fail("not a zstd frame (magic " + std::to_string(magic) + ")");
    }
  }
}

}  // namespace zstd

extern "C" {

// Decode the zstd frames in src[0, n) into a malloc'd buffer (*out, free it
// with free_buffers). Returns 0, or -1 with a message in err[0, err_cap).
long long zstd_decompress(const uint8_t* src, long long n, uint8_t** out, long long* out_len, char* err,
                          long long err_cap) {
  *out = nullptr;
  *out_len = 0;
  try {
    std::vector<uint8_t> buf;
    zstd::decompress(src, (size_t)n, buf);
    *out = (uint8_t*)std::malloc(buf.size() ? buf.size() : 1);
    if (!*out) throw zstd::Error("zstd: out of memory");
    std::memcpy(*out, buf.data(), buf.size());
    *out_len = (long long)buf.size();
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)err_cap, "%s", e.what());
    return -1;
  }
}

uint32_t crc32c(const uint8_t* p, long long n) {
  static const std::vector<uint32_t> table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xFFFFFFFFu;
  for (long long i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
