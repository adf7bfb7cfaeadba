// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_COMM_H
#define LMP_COMM_H

namespace LAMMPS_NS {

class Comm {
 public:
  int nprocs;
  int me;
};

}  // namespace LAMMPS_NS

#endif
