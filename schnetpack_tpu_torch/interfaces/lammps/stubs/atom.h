// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_ATOM_H
#define LMP_ATOM_H

#include "pointers.h"

namespace LAMMPS_NS {

class Atom {
 public:
  int ntypes;
  int nlocal, nghost;
  bigint natoms;
  double **x;
  double **f;
  int *type;
  tagint *tag;
};

}  // namespace LAMMPS_NS

#endif
