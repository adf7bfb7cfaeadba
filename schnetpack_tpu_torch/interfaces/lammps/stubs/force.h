// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_FORCE_H
#define LMP_FORCE_H

namespace LAMMPS_NS {

class Force {
 public:
  int newton, newton_pair, newton_bond;
};

}  // namespace LAMMPS_NS

#endif
