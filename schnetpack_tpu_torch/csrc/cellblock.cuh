// The 27-cell atom layout shared by the cell index modes of the select
// kernels (colblock_select.cu, K16) and of the message bodies
// (colblock_message.cu, K18; colblock_message_bwd.cu, K19).
//
// Atoms are sorted into nx*ny*nz cells of C rows (cell id (x*ny + y)*nz +
// z, row cell*C + s).  Edge slot e = a*K + k belongs to destination row a;
// its code q = qidx[e] = o*C + s_j names source row s_j of the neighbor
// cell ((x+dx) mod nx, (y+dy) mod ny, (z+dz) mod nz) with
// o = ((dx+1)*3 + (dy+1))*3 + (dz+1) (schnetpack_tpu/ops/cellblock.py:52,
// OFFSETS); q < 0 marks a padded slot.  On grids of one or two cells along
// an axis several offsets name the same cell: the decode below is exact
// for each, since it wraps every offset on its own.
//
// The stack view: the nz cells of one (x, y) are nz consecutive row blocks,
// so the layout is a column layout of nx*ny columns (stacks) of P' = nz*C
// rows and Ktot' = nz*C*K slots, slot e being slot e - col*Ktot' of column
// col = x*ny + y, and rbf_aug [A', K, B+1] is byte for byte an edge-major
// [nx*ny, Ktot', B+1].  Then o / 3 is the column layout's bucket c9 =
// (dx+1)*3 + (dy+1), whose wrap-mode source column is the source stack.
#pragma once

struct CellStack {
  int nz, C, K;  // nz = 0: not the cell index mode

  // slot k < Ktot' of a stack with code q >= 0: its bucket c9, its source
  // row in the source stack and its destination row in its own stack
  __device__ __forceinline__ void decode(int k, int q, int& c9, int& src,
                                         int& dst) const {
    const int o = q / C, s = q - o * C, a = k / K;
    int sz = a / C + o % 3 - 1;
    sz += sz < 0 ? nz : (sz >= nz ? -nz : 0);
    c9 = o / 3;
    src = sz * C + s;
    dst = a;
  }
};
