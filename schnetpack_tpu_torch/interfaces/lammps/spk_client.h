// Unix-socket client for the schnetpack_tpu model server.
// Shared by the LAMMPS pair style and the standalone test client.
#ifndef SPK_CLIENT_H
#define SPK_CLIENT_H

#include <cstdint>
#include <string>
#include <vector>

namespace spk_tpu {

class ModelClient {
 public:
  explicit ModelClient(const std::string &socket_path);
  ~ModelClient();

  bool connect_server();
  void close_connection();
  bool connected() const { return fd_ >= 0; }

  // Evaluate the potential for a periodic structure given an explicit
  // edge list (LAMMPS-built full neighbor list mapped to global tags,
  // with per-edge Cartesian image offsets — the reference pair style's
  // convention, pair_schnetpack.cpp:238-276).  Returns the total energy,
  // per-atom energies, forces on the n_atoms real atoms, and the 3x3
  // virial tensor W = -dE/d(strain) in row-major order.
  bool evaluate(int64_t n_atoms, int64_t n_edges, const int32_t *numbers,
                const double *positions, const double *cell,
                const int64_t *idx_i, const int64_t *idx_j,
                const double *offsets, double *energy,
                std::vector<double> *e_atom, std::vector<double> *forces,
                double *virial9);

  // Multi-rank (MPI domain decomposition): send this rank's local atoms
  // (0-based global tags) and local edge list (idx in global tags;
  // xj_abs = neighbor image's absolute position — the server derives the
  // image offset since only it knows remote atoms' wrapped positions).
  // The server gathers all nprocs parts of the step, evaluates the model
  // ONCE on the assembled global structure, and returns this rank's
  // forces, per-atom energies, energy share (sums to the global energy
  // over ranks) and a 1/nprocs virial share.
  bool evaluate_partial(int64_t rank, int64_t nprocs, int64_t n_global,
                        int64_t n_local, int64_t n_edges,
                        const int64_t *tags, const int32_t *numbers,
                        const double *positions, const double *cell,
                        const int64_t *idx_i, const int64_t *idx_j,
                        const double *xj_abs, double *energy_share,
                        std::vector<double> *e_atom,
                        std::vector<double> *forces, double *virial9);

 private:
  bool send_all(const void *buf, size_t n);
  bool recv_all(void *buf, size_t n);

  std::string socket_path_;
  int fd_ = -1;
};

}  // namespace spk_tpu

#endif  // SPK_CLIENT_H
