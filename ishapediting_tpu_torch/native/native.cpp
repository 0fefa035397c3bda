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
