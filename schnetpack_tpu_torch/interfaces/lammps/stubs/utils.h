// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_UTILS_H
#define LMP_UTILS_H

#include <string>

namespace LAMMPS_NS {
class LAMMPS;

namespace utils {
double numeric(const char *file, int line, const std::string &str,
               bool do_abort, LAMMPS *lmp);
int inumeric(const char *file, int line, const std::string &str,
             bool do_abort, LAMMPS *lmp);
bigint bnumeric(const char *file, int line, const std::string &str,
                bool do_abort, LAMMPS *lmp);
}  // namespace utils
}  // namespace LAMMPS_NS

#endif
