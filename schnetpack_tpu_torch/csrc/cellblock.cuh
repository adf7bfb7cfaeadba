// The 27-cell atom layout shared by cellblock_gather.cu and painn_fused.cu.
//
// Atoms are sorted into nx*ny*nz cells of C rows (cell id (x*ny + y)*nz +
// z, row cell*C + s).  Edge slot e = a*K + k belongs to destination row a;
// its code q = qidx[e] = o*C + s_j names source row s_j of the neighbor
// cell ((x+dx) mod nx, (y+dy) mod ny, (z+dz) mod nz) with
// o = ((dx+1)*3 + (dy+1))*3 + (dz+1) (schnetpack_tpu/ops/cellblock.py:52,
// OFFSETS); q < 0 marks a padded slot.  On grids of one or two cells along
// an axis several offsets name the same cell: the decode below is exact
// for each, since it wraps every offset on its own.
#pragma once

// source row of edge slot e with code q >= 0
__device__ __forceinline__ int cell_source_row(int e, int q, int nx, int ny,
                                               int nz, int C, int K) {
  const int cell = e / K / C;
  const int cz = cell % nz, cy = (cell / nz) % ny, cx = cell / (nz * ny);
  const int o = q / C, s = q - o * C;
  const int sx = (cx + o / 9 - 1 + nx) % nx;
  const int sy = (cy + (o / 3) % 3 - 1 + ny) % ny;
  const int sz = (cz + o % 3 - 1 + nz) % nz;
  return ((sx * ny + sy) * nz + sz) * C + s;
}
