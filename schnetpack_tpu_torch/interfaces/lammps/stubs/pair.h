// NOT LAMMPS — compile-gate stub (see lmptype.h).
#ifndef LMP_PAIR_H
#define LMP_PAIR_H

#include "pointers.h"

namespace LAMMPS_NS {

class NeighList;

class Pair : protected Pointers {
 public:
  int writedata;
  int single_enable;
  int restartinfo;
  int manybody_flag;
  int no_virial_fdotr_compute;
  int allocated;
  int **setflag;
  double **cutsq;

  double eng_vdwl, eng_coul;
  double virial[6];
  double *eatom;
  double **vatom;
  int eflag_global, eflag_atom, vflag_global, vflag_atom;

  NeighList *list;

  explicit Pair(LAMMPS *lmp);
  ~Pair() override;

  virtual void compute(int eflag, int vflag) = 0;
  virtual void settings(int narg, char **arg) = 0;
  virtual void coeff(int narg, char **arg) = 0;
  virtual void init_style();
  virtual double init_one(int i, int j);

 protected:
  void ev_init(int eflag, int vflag);
};

}  // namespace LAMMPS_NS

#endif
