// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_MEMORY_H
#define LMP_MEMORY_H

namespace LAMMPS_NS {

class Memory {
 public:
  template <typename T>
  T **create(T **&array, int n1, int n2, const char *name);
  template <typename T>
  void destroy(T **&array);
};

}  // namespace LAMMPS_NS

#endif
