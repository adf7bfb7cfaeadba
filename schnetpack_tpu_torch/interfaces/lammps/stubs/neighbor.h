// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_NEIGHBOR_H
#define LMP_NEIGHBOR_H

namespace LAMMPS_NS {

class Pair;
class NeighRequest;

class Neighbor {
 public:
  NeighRequest *add_request(Pair *requestor, int flags = 0);
};

}  // namespace LAMMPS_NS

#endif
