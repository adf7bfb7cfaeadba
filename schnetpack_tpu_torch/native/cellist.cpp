// O(N) linked-cell neighbor list (full/bidirectional, with PBC shifts).
//
// A copy of schnetpack_tpu/native/cellist.cpp for the PyTorch port: the
// host neighbor lists of the port (data pipeline, column and 27-cell
// layouts, MD rebuilds, pair potentials) call it through ctypes
// (native/cellist.py).
//
// Algorithm: fractional-coordinate binning with >=1-bin cutoff coverage per
// axis.  Periodic axes require at least 3 bins (minimal-image with +-1 bin
// neighborhoods); the Python wrapper falls back to brute-force shift
// enumeration for small cells.  Non-periodic axes bin the bounding box.
//
// Build: g++ -O3 -shared -fPIC cellist.cpp -o libcellist.so (cellist.py
// builds it at first use; no -march=native, so a library built on one
// host CPU loads on another).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// 3x3 inverse; returns false if singular.
bool inv3(const double* m, double* out) {
  double a = m[0], b = m[1], c = m[2];
  double d = m[3], e = m[4], f = m[5];
  double g = m[6], h = m[7], i = m[8];
  double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  if (std::fabs(det) < 1e-300) return false;
  double inv = 1.0 / det;
  out[0] = (e * i - f * h) * inv;
  out[1] = (c * h - b * i) * inv;
  out[2] = (b * f - c * e) * inv;
  out[3] = (f * g - d * i) * inv;
  out[4] = (a * i - c * g) * inv;
  out[5] = (c * d - a * f) * inv;
  out[6] = (d * h - e * g) * inv;
  out[7] = (b * g - a * h) * inv;
  out[8] = (a * e - b * d) * inv;
  return true;
}

}  // namespace

extern "C" {

// Returns number of pairs written, or -(pairs needed) if max_pairs was too
// small, or -1000000000 on unsupported geometry (caller should fall back).
long long cellist_neighbor_list(
    const double* positions,  // [n,3]
    long long n,
    const double* cell,       // [3,3] row-major lattice vectors, may be null
    const uint8_t* pbc,       // [3], may be null
    double cutoff,
    long long max_pairs,
    int32_t* out_i, int32_t* out_j, int32_t* out_shifts /* [max_pairs*3] */) {
  const double c2 = cutoff * cutoff;
  bool periodic[3] = {false, false, false};
  bool any_pbc = false;
  if (pbc) {
    for (int d = 0; d < 3; ++d) {
      periodic[d] = pbc[d] != 0;
      any_pbc |= periodic[d];
    }
  }

  // --- coordinates in (possibly synthetic) fractional space --------------
  double C[9];
  if (any_pbc) {
    std::memcpy(C, cell, 9 * sizeof(double));
  } else {
    // synthetic orthorhombic bounding box (+ cutoff margin)
    double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
    for (long long a = 0; a < n; ++a)
      for (int d = 0; d < 3; ++d) {
        double v = positions[3 * a + d];
        if (v < lo[d]) lo[d] = v;
        if (v > hi[d]) hi[d] = v;
      }
    std::memset(C, 0, sizeof(C));
    for (int d = 0; d < 3; ++d) C[4 * d] = (hi[d] - lo[d]) + 2.0 * cutoff + 1e-6;
    // shift positions handled via lo below
    double Cinv[9];
    if (!inv3(C, Cinv)) return -1000000000LL;
    // bins
    int nb[3];
    for (int d = 0; d < 3; ++d) {
      nb[d] = (int)std::floor(C[4 * d] / cutoff);
      if (nb[d] < 1) nb[d] = 1;
      if (nb[d] > 512) nb[d] = 512;
    }
    const long long nbins = (long long)nb[0] * nb[1] * nb[2];
    std::vector<int32_t> head(nbins, -1), next(n, -1);
    std::vector<int> binof(3 * n);
    for (long long a = 0; a < n; ++a) {
      int b[3];
      for (int d = 0; d < 3; ++d) {
        double f = (positions[3 * a + d] - lo[d] + cutoff) / C[4 * d];
        int bi = (int)(f * nb[d]);
        if (bi < 0) bi = 0;
        if (bi >= nb[d]) bi = nb[d] - 1;
        b[d] = bi;
        binof[3 * a + d] = bi;
      }
      long long bid = ((long long)b[0] * nb[1] + b[1]) * nb[2] + b[2];
      next[a] = head[bid];
      head[bid] = (int32_t)a;
    }
    long long np = 0;
    for (long long a = 0; a < n; ++a) {
      const double* ra = positions + 3 * a;
      int b0 = binof[3 * a], b1 = binof[3 * a + 1], b2 = binof[3 * a + 2];
      for (int dx = -1; dx <= 1; ++dx) {
        int x = b0 + dx;
        if (x < 0 || x >= nb[0]) continue;
        for (int dy = -1; dy <= 1; ++dy) {
          int y = b1 + dy;
          if (y < 0 || y >= nb[1]) continue;
          for (int dz = -1; dz <= 1; ++dz) {
            int z = b2 + dz;
            if (z < 0 || z >= nb[2]) continue;
            long long bid = ((long long)x * nb[1] + y) * nb[2] + z;
            for (int32_t bj = head[bid]; bj >= 0; bj = next[bj]) {
              if (bj == a) continue;
              const double* rb = positions + 3 * bj;
              double ddx = rb[0] - ra[0], ddy = rb[1] - ra[1], ddz = rb[2] - ra[2];
              double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
              if (d2 < c2) {
                if (np < max_pairs) {
                  out_i[np] = (int32_t)a;
                  out_j[np] = bj;
                  out_shifts[3 * np] = 0;
                  out_shifts[3 * np + 1] = 0;
                  out_shifts[3 * np + 2] = 0;
                }
                ++np;
              }
            }
          }
        }
      }
    }
    return (np <= max_pairs) ? np : -np;
  }

  // --- periodic path ------------------------------------------------------
  double Cinv[9];
  if (!inv3(C, Cinv)) return -1000000000LL;

  // perpendicular heights: 1 / |row d of Cinv^T| = 1/|col d of Cinv|
  double height[3];
  for (int d = 0; d < 3; ++d) {
    double col[3] = {Cinv[d], Cinv[3 + d], Cinv[6 + d]};
    height[d] = 1.0 / std::sqrt(dot3(col, col));
  }

  int nb[3];
  for (int d = 0; d < 3; ++d) {
    if (periodic[d]) {
      nb[d] = (int)std::floor(height[d] / cutoff);
      if (nb[d] < 3) return -1000000000LL;  // too small: caller falls back
      if (nb[d] > 512) nb[d] = 512;
    } else {
      nb[d] = (int)std::floor(height[d] / cutoff);
      if (nb[d] < 1) nb[d] = 1;
      if (nb[d] > 512) nb[d] = 512;
    }
  }

  // fractional coords wrapped into [0,1) on periodic axes
  std::vector<double> frac(3 * n);
  std::vector<int32_t> wrapshift(3 * n);  // how many cells the wrap moved
  for (long long a = 0; a < n; ++a) {
    const double* r = positions + 3 * a;
    for (int d = 0; d < 3; ++d) {
      double f = r[0] * Cinv[3 * 0 + d] + r[1] * Cinv[3 * 1 + d] + r[2] * Cinv[3 * 2 + d];
      if (periodic[d]) {
        double w = std::floor(f);
        frac[3 * a + d] = f - w;
        wrapshift[3 * a + d] = (int32_t)w;
      } else {
        frac[3 * a + d] = f;
        wrapshift[3 * a + d] = 0;
      }
    }
  }
  // non-periodic axes: normalize to [0,1) over the extent
  double lo_np[3] = {0, 0, 0}, span_np[3] = {1, 1, 1};
  for (int d = 0; d < 3; ++d) {
    if (!periodic[d]) {
      double lo = 1e300, hi = -1e300;
      for (long long a = 0; a < n; ++a) {
        double f = frac[3 * a + d];
        if (f < lo) lo = f;
        if (f > hi) hi = f;
      }
      lo_np[d] = lo;
      span_np[d] = (hi - lo) + 1e-9;
      nb[d] = (int)std::floor(span_np[d] * height[d] / cutoff);
      if (nb[d] < 1) nb[d] = 1;
      if (nb[d] > 512) nb[d] = 512;
    }
  }

  const long long nbins = (long long)nb[0] * nb[1] * nb[2];
  std::vector<int32_t> head(nbins, -1), next(n, -1);
  std::vector<int> binof(3 * n);
  for (long long a = 0; a < n; ++a) {
    int b[3];
    for (int d = 0; d < 3; ++d) {
      double f = frac[3 * a + d];
      if (!periodic[d]) f = (f - lo_np[d]) / span_np[d];
      int bi = (int)(f * nb[d]);
      if (bi < 0) bi = 0;
      if (bi >= nb[d]) bi = nb[d] - 1;
      b[d] = bi;
      binof[3 * a + d] = bi;
    }
    long long bid = ((long long)b[0] * nb[1] + b[1]) * nb[2] + b[2];
    next[a] = head[bid];
    head[bid] = (int32_t)a;
  }

  // wrapped Cartesian positions
  std::vector<double> rw(3 * n);
  for (long long a = 0; a < n; ++a)
    for (int d = 0; d < 3; ++d)
      rw[3 * a + d] = frac[3 * a] * C[0 + d] + frac[3 * a + 1] * C[3 + d] +
                      frac[3 * a + 2] * C[6 + d];

  long long np = 0;
  for (long long a = 0; a < n; ++a) {
    const double* ra = &rw[3 * a];
    int b0 = binof[3 * a], b1 = binof[3 * a + 1], b2 = binof[3 * a + 2];
    for (int dx = -1; dx <= 1; ++dx) {
      int x = b0 + dx, sx = 0;
      if (periodic[0]) {
        if (x < 0) { x += nb[0]; sx = -1; }
        else if (x >= nb[0]) { x -= nb[0]; sx = 1; }
      } else if (x < 0 || x >= nb[0]) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        int y = b1 + dy, sy = 0;
        if (periodic[1]) {
          if (y < 0) { y += nb[1]; sy = -1; }
          else if (y >= nb[1]) { y -= nb[1]; sy = 1; }
        } else if (y < 0 || y >= nb[1]) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          int z = b2 + dz, sz = 0;
          if (periodic[2]) {
            if (z < 0) { z += nb[2]; sz = -1; }
            else if (z >= nb[2]) { z -= nb[2]; sz = 1; }
          } else if (z < 0 || z >= nb[2]) continue;
          // walking past a periodic boundary in direction s means the
          // relevant image of j is displaced by s cells: offset = s @ C
          double off[3] = {
              (double)sx * C[0] + (double)sy * C[3] + (double)sz * C[6],
              (double)sx * C[1] + (double)sy * C[4] + (double)sz * C[7],
              (double)sx * C[2] + (double)sy * C[5] + (double)sz * C[8],
          };
          long long bid = ((long long)x * nb[1] + y) * nb[2] + z;
          for (int32_t bj = head[bid]; bj >= 0; bj = next[bj]) {
            if (bj == a && sx == 0 && sy == 0 && sz == 0) continue;
            const double* rb = &rw[3 * bj];
            double ddx = rb[0] + off[0] - ra[0];
            double ddy = rb[1] + off[1] - ra[1];
            double ddz = rb[2] + off[2] - ra[2];
            double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 < c2) {
              if (np < max_pairs) {
                out_i[np] = (int32_t)a;
                out_j[np] = bj;
                // shift in original (unwrapped) coordinates:
                // Rj_orig + S@C - Ri_orig == Rj_w + s@C - Ri_w
                // Rj_w = Rj_orig - wrap_j@C ; Ri_w = Ri_orig - wrap_i@C
                out_shifts[3 * np] = sx - wrapshift[3 * bj] + wrapshift[3 * a];
                out_shifts[3 * np + 1] = sy - wrapshift[3 * bj + 1] + wrapshift[3 * a + 1];
                out_shifts[3 * np + 2] = sz - wrapshift[3 * bj + 2] + wrapshift[3 * a + 2];
              }
              ++np;
            }
          }
        }
      }
    }
  }
  return (np <= max_pairs) ? np : -np;
}

}  // extern "C"
