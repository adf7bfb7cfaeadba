// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_DOMAIN_H
#define LMP_DOMAIN_H

namespace LAMMPS_NS {

class Domain {
 public:
  double boxlo[3], boxhi[3];
  double xy, xz, yz;
  int triclinic;
};

}  // namespace LAMMPS_NS

#endif
