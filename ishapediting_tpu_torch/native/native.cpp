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
//    the Python writer byte-for-byte).
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

  std::vector<std::vector<int>> cells((size_t)ncell * ncell);
  for (long long f = 0; f < nf; ++f) {
    const double* A = verts + 3 * tris[3 * f];
    const double* B = verts + 3 * tris[3 * f + 1];
    const double* C = verts + 3 * tris[3 * f + 2];
    int x0 = cellx(std::min({A[0], B[0], C[0]}));
    int x1 = cellx(std::max({A[0], B[0], C[0]}));
    int y0 = celly(std::min({A[1], B[1], C[1]}));
    int y1 = celly(std::max({A[1], B[1], C[1]}));
    for (int x = x0; x <= x1; ++x)
      for (int y = y0; y <= y1; ++y)
        cells[(size_t)x * ncell + y].push_back((int)f);
  }

  const double ex = 1.3e-7, ey = 2.9e-7;  // degeneracy-breaking shift
  for (long long i = 0; i < np; ++i) {
    double px = points[3 * i] + ex, py = points[3 * i + 1] + ey,
           pz = points[3 * i + 2];
    if (px < minx || px > maxx || py < miny || py > maxy) {
      out[i] = 0.0;
      continue;
    }
    const auto& cand = cells[(size_t)cellx(px) * ncell + celly(py)];
    int hits = 0;
    for (int f : cand) {
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
}

// v' = (v + sum(unique neighbors)) / (1 + deg), `iters` times.
// out must hold nv*3 doubles; verts/out may not alias.
void smooth_simple(const double* verts, long long nv, const long long* tris,
                   long long nt, long long iters, double* out) {
  if (nv == 0) return;
  // directed edges (both directions) as packed keys; sort+unique dedups
  // shared edges, exactly like the scipy-CSR fallback's duplicate-sum reset
  std::vector<unsigned long long> keys;
  keys.reserve((size_t)(6 * nt));
  const unsigned long long n = (unsigned long long)nv;
  for (long long i = 0; i < nt; ++i) {
    unsigned long long a = (unsigned long long)tris[3 * i];
    unsigned long long b = (unsigned long long)tris[3 * i + 1];
    unsigned long long c = (unsigned long long)tris[3 * i + 2];
    keys.push_back(a * n + b);
    keys.push_back(b * n + c);
    keys.push_back(c * n + a);
    keys.push_back(b * n + a);
    keys.push_back(c * n + b);
    keys.push_back(a * n + c);
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  // CSR over the deduped directed edges
  std::vector<long long> indptr((size_t)nv + 1, 0);
  std::vector<long long> indices(keys.size());
  for (size_t e = 0; e < keys.size(); ++e) {
    long long r = (long long)(keys[e] / n);
    indices[e] = (long long)(keys[e] % n);
    indptr[(size_t)r + 1]++;
  }
  for (long long i = 0; i < nv; ++i) indptr[(size_t)i + 1] += indptr[(size_t)i];
  std::vector<double> cur(verts, verts + 3 * nv), nxt((size_t)3 * nv);
  for (long long it = 0; it < iters; ++it) {
    for (long long i = 0; i < nv; ++i) {
      double sx = cur[3 * i], sy = cur[3 * i + 1], sz = cur[3 * i + 2];
      const long long e0 = indptr[(size_t)i], e1 = indptr[(size_t)i + 1];
      for (long long e = e0; e < e1; ++e) {
        const long long j = indices[(size_t)e];
        sx += cur[3 * j];
        sy += cur[3 * j + 1];
        sz += cur[3 * j + 2];
      }
      const double inv = 1.0 / (1.0 + (double)(e1 - e0));
      nxt[3 * i] = sx * inv;
      nxt[3 * i + 1] = sy * inv;
      nxt[3 * i + 2] = sz * inv;
    }
    cur.swap(nxt);
  }
  std::memcpy(out, cur.data(), (size_t)3 * nv * sizeof(double));
}

long long write_obj(const char* path, const double* verts, long long nv,
                    const long long* tris, long long nt) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  std::vector<char> buf;
  buf.reserve(1 << 22);
  char line[128];
  bool ok = true;
  auto flush = [&]() {
    // a short fwrite (e.g. ENOSPC) must fail the call, or the Python
    // fallback writer never runs and a truncated OBJ reads as success
    if (ok && !buf.empty() &&
        std::fwrite(buf.data(), 1, buf.size(), f) != buf.size())
      ok = false;
    buf.clear();
  };
  for (long long i = 0; i < nv; ++i) {
    int n = std::snprintf(line, sizeof(line), "v %.8g %.8g %.8g\n",
                          verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]);
    buf.insert(buf.end(), line, line + n);
    if (buf.size() > (1 << 22) - 256) flush();
  }
  for (long long i = 0; i < nt; ++i) {
    int n = std::snprintf(line, sizeof(line), "f %lld %lld %lld\n",
                          tris[3 * i] + 1, tris[3 * i + 1] + 1,
                          tris[3 * i + 2] + 1);
    buf.insert(buf.end(), line, line + n);
    if (buf.size() > (1 << 22) - 256) flush();
  }
  flush();
  if (std::ferror(f)) ok = false;
  const int rc = std::fclose(f);
  return (ok && rc == 0) ? 0 : 2;
}

}  // extern "C"
