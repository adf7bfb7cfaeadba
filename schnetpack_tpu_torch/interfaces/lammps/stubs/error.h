// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_ERROR_H
#define LMP_ERROR_H

#include <string>

namespace LAMMPS_NS {

class Error {
 public:
  [[noreturn]] void all(const char *file, int line, const std::string &msg);
  [[noreturn]] void one(const char *file, int line, const std::string &msg);
};

}  // namespace LAMMPS_NS

#endif
