// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_NEIGH_REQUEST_H
#define LMP_NEIGH_REQUEST_H

namespace LAMMPS_NS {

class NeighConst {
 public:
  enum {
    REQ_DEFAULT = 0,
    REQ_FULL = 1 << 0,
    REQ_GHOST = 1 << 1,
    REQ_OCCASIONAL = 1 << 4,
  };
};

class NeighRequest {};

}  // namespace LAMMPS_NS

#endif
