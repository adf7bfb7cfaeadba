// LAMMPS pair style driving a schnetpack model server: the JAX package's
// server or the PyTorch port's (the same wire format; this file is the
// port's copy of the JAX package's pair style).
//
// Counterpart of the reference TorchScript pair style
// (reference interfaces/lammps/pair_schnetpack.cpp): LAMMPS builds the
// full neighbor list; the pair style assembles the periodic structure in
// GLOBAL tag order (pair_schnetpack.cpp:208-231), encodes every edge with
// its Cartesian image offset (:238-276), and ships atoms + cell + edges
// to the persistent model-server process over a Unix socket.  The server
// returns the total energy, per-atom energies, forces, and the virial
// tensor, so energy minimisation, NVT and NPT all work.
//
// Usage in a LAMMPS input script (metal units: eV, Angstrom):
//   pair_style schnetpack_tpu /tmp/schnetpack_tpu.sock 5.0
//   pair_coeff * * 8 1            # atomic number of each LAMMPS type
// with the server started separately, on the GPU:
//   python -m schnetpack_tpu_torch.interfaces.lammps.server model_dir=... \
//       socket=/tmp/schnetpack_tpu.sock cutoff=5.0 device=cuda
//
// The type -> element map is REQUIRED: LAMMPS type ids are arbitrary
// 1-based labels (the reference reads the same map from its pair_coeff
// file, pair_schnetpack.cpp:218).
//
// MPI domain decomposition is supported: each rank ships its LOCAL atoms
// (global tags) and its local edge list (destination local, source as a
// global tag + the ghost image's absolute position) as a PARTIAL request;
// the server gathers all ranks' parts, evaluates the model ONCE on the
// assembled global structure (exact — a per-rank evaluation would truncate
// the message-passing receptive field at domain boundaries, since LAMMPS
// ghosts only extend one cutoff, not n_interactions cutoffs), and returns
// each rank its local forces, per-atom energies, energy share and a
// 1/nprocs virial share.  Serial runs use the single-structure protocol.
//
// Build: see patch_lammps.sh (copies these sources into lammps/src and
// adds them to the build; requires the LAMMPS source tree).

#ifdef PAIR_CLASS
// clang-format off
PairStyle(schnetpack_tpu, PairSchnetpackTPU);
// clang-format on
#else

#ifndef LMP_PAIR_SCHNETPACK_TPU_H
#define LMP_PAIR_SCHNETPACK_TPU_H

#include "pair.h"
#include "spk_client.h"

#include <vector>

namespace LAMMPS_NS {

class PairSchnetpackTPU : public Pair {
 public:
  PairSchnetpackTPU(class LAMMPS *);
  ~PairSchnetpackTPU() override;
  void compute(int, int) override;
  void settings(int, char **) override;
  void coeff(int, char **) override;
  void init_style() override;
  double init_one(int, int) override;

 protected:
  void allocate();

  void compute_partial(int eflag, int vflag);

  double cutoff_;
  spk_tpu::ModelClient *client_;
  std::vector<int32_t> type_to_z_;
  std::vector<int32_t> numbers_;
  std::vector<double> positions_;
  std::vector<int64_t> tags_;
  std::vector<int64_t> idx_i_, idx_j_;
  std::vector<double> offsets_;
  std::vector<double> e_atom_;
  std::vector<double> forces_;
};

}  // namespace LAMMPS_NS

#endif
#endif

#ifndef PAIR_CLASS

#include "atom.h"
#include "comm.h"
#include "domain.h"
#include "error.h"
#include "force.h"
#include "memory.h"
#include "neigh_list.h"
#include "neigh_request.h"
#include "neighbor.h"

#include <cstring>

using namespace LAMMPS_NS;

PairSchnetpackTPU::PairSchnetpackTPU(LAMMPS *lmp)
    : Pair(lmp), cutoff_(5.0), client_(nullptr) {
  writedata = 0;
  single_enable = 0;
  restartinfo = 0;
  manybody_flag = 1;
  no_virial_fdotr_compute = 1;  // the server returns the exact virial
}

PairSchnetpackTPU::~PairSchnetpackTPU() {
  delete client_;
  if (allocated) {
    memory->destroy(setflag);
    memory->destroy(cutsq);
  }
}

void PairSchnetpackTPU::allocate() {
  allocated = 1;
  const int n = atom->ntypes + 1;
  memory->create(setflag, n, n, "pair:setflag");
  for (int i = 1; i < n; i++)
    for (int j = i; j < n; j++) setflag[i][j] = 0;
  memory->create(cutsq, n, n, "pair:cutsq");
}

void PairSchnetpackTPU::settings(int narg, char **arg) {
  if (narg != 2)
    error->all(FLERR, "pair_style schnetpack_tpu requires <socket> <cutoff>");
  client_ = new spk_tpu::ModelClient(arg[0]);
  cutoff_ = utils::numeric(FLERR, arg[1], false, lmp);
}

void PairSchnetpackTPU::coeff(int narg, char **arg) {
  // pair_coeff * * Z_1 ... Z_ntypes  (atomic number per LAMMPS type)
  const int ntypes = atom->ntypes;
  if (narg != 2 + ntypes)
    error->all(FLERR,
               "pair_coeff schnetpack_tpu requires one atomic number per "
               "LAMMPS atom type: pair_coeff * * Z_1 ... Z_ntypes");
  if (std::strcmp(arg[0], "*") != 0 || std::strcmp(arg[1], "*") != 0)
    error->all(FLERR, "pair_coeff schnetpack_tpu must use * * wildcards");
  type_to_z_.assign(ntypes + 1, -1);
  for (int t = 1; t <= ntypes; t++) {
    type_to_z_[t] = utils::inumeric(FLERR, arg[1 + t], false, lmp);
    if (type_to_z_[t] <= 0 || type_to_z_[t] > 118)
      error->all(FLERR, "invalid atomic number in pair_coeff");
  }
  if (!allocated) allocate();
  for (int i = 1; i <= ntypes; i++)
    for (int j = i; j <= ntypes; j++) setflag[i][j] = 1;
}

void PairSchnetpackTPU::init_style() {
  if (force->newton_pair)
    error->all(FLERR, "pair schnetpack_tpu requires newton off");
  if (type_to_z_.empty())
    error->all(FLERR, "pair schnetpack_tpu requires a pair_coeff type map");
  neighbor->add_request(this, NeighConst::REQ_FULL);
  if (!client_->connect_server())
    error->all(FLERR, "cannot connect to schnetpack_tpu model server");
}

double PairSchnetpackTPU::init_one(int, int) { return cutoff_; }

void PairSchnetpackTPU::compute_partial(int eflag, int vflag) {
  // MPI path: ship this rank's local atoms + local edges; the server
  // assembles the global structure and evaluates once (exact result).
  ev_init(eflag, vflag);

  const int nlocal = atom->nlocal;
  double **x = atom->x;
  double **f = atom->f;
  int *type = atom->type;
  tagint *tag = atom->tag;

  int inum = list->inum;
  int *ilist = list->ilist;
  int *numneigh = list->numneigh;
  int **firstneigh = list->firstneigh;

  numbers_.resize(nlocal);
  positions_.resize(3 * nlocal);
  tags_.resize(nlocal);
  std::vector<int> order(nlocal);  // local slot -> x/f index
  idx_i_.clear();
  idx_j_.clear();
  offsets_.clear();  // reused as xj_abs
  const double c2 = cutoff_ * cutoff_;
  for (int ii = 0; ii < inum; ii++) {
    int i = ilist[ii];
    order[ii] = i;
    tags_[ii] = static_cast<int64_t>(tag[i]) - 1;
    numbers_[ii] = type_to_z_[type[i]];
    positions_[3 * ii + 0] = x[i][0];
    positions_[3 * ii + 1] = x[i][1];
    positions_[3 * ii + 2] = x[i][2];
    int jnum = numneigh[i];
    int *jlist = firstneigh[i];
    for (int jj = 0; jj < jnum; jj++) {
      int j = jlist[jj];
      j &= NEIGHMASK;
      double dx = x[i][0] - x[j][0];
      double dy = x[i][1] - x[j][1];
      double dz = x[i][2] - x[j][2];
      if (dx * dx + dy * dy + dz * dz >= c2) continue;
      idx_i_.push_back(static_cast<int64_t>(tag[i]) - 1);
      idx_j_.push_back(static_cast<int64_t>(tag[j]) - 1);
      offsets_.push_back(x[j][0]);
      offsets_.push_back(x[j][1]);
      offsets_.push_back(x[j][2]);
    }
  }

  double cell[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  cell[0] = domain->boxhi[0] - domain->boxlo[0];
  cell[3] = domain->xy;
  cell[4] = domain->boxhi[1] - domain->boxlo[1];
  cell[6] = domain->xz;
  cell[7] = domain->yz;
  cell[8] = domain->boxhi[2] - domain->boxlo[2];

  double energy_share = 0.0;
  double virial9[9];
  if (!client_->evaluate_partial(
          comm->me, comm->nprocs, static_cast<int64_t>(atom->natoms),
          nlocal, static_cast<int64_t>(idx_i_.size()), tags_.data(),
          numbers_.data(), positions_.data(), cell, idx_i_.data(),
          idx_j_.data(), offsets_.data(), &energy_share, &e_atom_,
          &forces_, virial9))
    error->one(FLERR, "schnetpack_tpu model server evaluation failed");

  for (int ii = 0; ii < nlocal; ii++) {
    int i = order[ii];
    f[i][0] += forces_[3 * ii + 0];
    f[i][1] += forces_[3 * ii + 1];
    f[i][2] += forces_[3 * ii + 2];
    if (eflag_atom) eatom[i] += e_atom_[ii];
  }
  if (eflag_global) eng_vdwl += energy_share;
  if (vflag_global) {
    virial[0] += virial9[0];
    virial[1] += virial9[4];
    virial[2] += virial9[8];
    virial[3] += 0.5 * (virial9[1] + virial9[3]);
    virial[4] += 0.5 * (virial9[2] + virial9[6]);
    virial[5] += 0.5 * (virial9[5] + virial9[7]);
  }
}

void PairSchnetpackTPU::compute(int eflag, int vflag) {
  if (comm->nprocs > 1) {
    compute_partial(eflag, vflag);
    return;
  }
  ev_init(eflag, vflag);

  const int nlocal = atom->nlocal;
  double **x = atom->x;
  double **f = atom->f;
  int *type = atom->type;
  tagint *tag = atom->tag;

  // global tag-ordered structure (tags are 1-based and dense in serial)
  numbers_.resize(nlocal);
  positions_.resize(3 * nlocal);
  std::vector<int> tag2i(nlocal);
  for (int i = 0; i < nlocal; i++) {
    int itag = static_cast<int>(tag[i]) - 1;
    if (itag < 0 || itag >= nlocal)
      error->one(FLERR, "pair schnetpack_tpu requires dense 1..N atom tags");
    tag2i[itag] = i;
    numbers_[itag] = type_to_z_[type[i]];
    positions_[3 * itag + 0] = x[i][0];
    positions_[3 * itag + 1] = x[i][1];
    positions_[3 * itag + 2] = x[i][2];
  }

  // triclinic cell (row-vector convention, reference :224-231)
  double cell[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  cell[0] = domain->boxhi[0] - domain->boxlo[0];
  cell[3] = domain->xy;
  cell[4] = domain->boxhi[1] - domain->boxlo[1];
  cell[6] = domain->xz;
  cell[7] = domain->yz;
  cell[8] = domain->boxhi[2] - domain->boxlo[2];

  // edges from the LAMMPS full neighbor list; each edge carries the
  // Cartesian image offset x[j]_ghost - x[jtag]_real (reference :250-263)
  int inum = list->inum;
  int *ilist = list->ilist;
  int *numneigh = list->numneigh;
  int **firstneigh = list->firstneigh;
  idx_i_.clear();
  idx_j_.clear();
  offsets_.clear();
  const double c2 = cutoff_ * cutoff_;
  for (int ii = 0; ii < inum; ii++) {
    int i = ilist[ii];
    int itag = static_cast<int>(tag[i]) - 1;
    int jnum = numneigh[i];
    int *jlist = firstneigh[i];
    for (int jj = 0; jj < jnum; jj++) {
      int j = jlist[jj];
      j &= NEIGHMASK;
      int jtag = static_cast<int>(tag[j]) - 1;
      double dx = x[i][0] - x[j][0];
      double dy = x[i][1] - x[j][1];
      double dz = x[i][2] - x[j][2];
      if (dx * dx + dy * dy + dz * dz >= c2) continue;
      idx_i_.push_back(itag);
      idx_j_.push_back(jtag);
      offsets_.push_back(x[j][0] - positions_[3 * jtag + 0]);
      offsets_.push_back(x[j][1] - positions_[3 * jtag + 1]);
      offsets_.push_back(x[j][2] - positions_[3 * jtag + 2]);
    }
  }

  double energy = 0.0;
  double virial9[9];
  if (!client_->evaluate(nlocal, static_cast<int64_t>(idx_i_.size()),
                         numbers_.data(), positions_.data(), cell,
                         idx_i_.data(), idx_j_.data(), offsets_.data(),
                         &energy, &e_atom_, &forces_, virial9))
    error->one(FLERR, "schnetpack_tpu model server evaluation failed");

  for (int itag = 0; itag < nlocal; itag++) {
    int i = tag2i[itag];
    f[i][0] += forces_[3 * itag + 0];
    f[i][1] += forces_[3 * itag + 1];
    f[i][2] += forces_[3 * itag + 2];
    if (eflag_atom) eatom[i] += e_atom_[itag];
  }
  if (eflag_global) eng_vdwl += energy;
  if (vflag_global) {
    // LAMMPS order: xx yy zz xy xz yz (symmetrised server tensor)
    virial[0] += virial9[0];
    virial[1] += virial9[4];
    virial[2] += virial9[8];
    virial[3] += 0.5 * (virial9[1] + virial9[3]);
    virial[4] += 0.5 * (virial9[2] + virial9[6]);
    virial[5] += 0.5 * (virial9[5] + virial9[7]);
  }
}

#endif  // !PAIR_CLASS
