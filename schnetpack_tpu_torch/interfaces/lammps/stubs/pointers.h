// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_POINTERS_H
#define LMP_POINTERS_H

#include "lmptype.h"
#include "utils.h"

#define FLERR __FILE__, __LINE__

namespace LAMMPS_NS {

class Atom;
class Comm;
class Domain;
class Error;
class Force;
class Memory;
class Neighbor;
class Update;

class LAMMPS {
 public:
  Atom *atom;
  Comm *comm;
  Domain *domain;
  Error *error;
  Force *force;
  Memory *memory;
  Neighbor *neighbor;
  Update *update;
};

class Pointers {
 public:
  explicit Pointers(LAMMPS *ptr)
      : lmp(ptr), atom(ptr->atom), comm(ptr->comm), domain(ptr->domain),
        error(ptr->error), force(ptr->force), memory(ptr->memory),
        neighbor(ptr->neighbor), update(ptr->update) {}
  virtual ~Pointers() = default;

 protected:
  LAMMPS *lmp;
  Atom *atom;
  Comm *comm;
  Domain *domain;
  Error *error;
  Force *force;
  Memory *memory;
  Neighbor *neighbor;
  Update *update;
};

}  // namespace LAMMPS_NS

#endif
