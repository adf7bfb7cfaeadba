// NOT LAMMPS.  Minimal API-shape stubs mirroring the real LAMMPS headers
// (2023+ vintage) so pair_schnetpack_tpu.cpp can be COMPILE-GATED
// (g++ -fsyntax-only) in environments without a LAMMPS source tree.
// Only the declarations the pair style touches are present; nothing here
// is linked or executed.  Real builds use patch_lammps.sh + a LAMMPS tree.
#ifndef LMP_LMPTYPE_H
#define LMP_LMPTYPE_H

#include <cstdint>

namespace LAMMPS_NS {
typedef int64_t bigint;
typedef int tagint;  // default (non -DLAMMPS_BIGBIG) build
}  // namespace LAMMPS_NS

#define NEIGHMASK 0x3FFFFFFF

#endif
