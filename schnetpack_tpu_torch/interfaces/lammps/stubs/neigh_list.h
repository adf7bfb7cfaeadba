// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_NEIGH_LIST_H
#define LMP_NEIGH_LIST_H

namespace LAMMPS_NS {

class NeighList {
 public:
  int inum;
  int *ilist;
  int *numneigh;
  int **firstneigh;
};

}  // namespace LAMMPS_NS

#endif
