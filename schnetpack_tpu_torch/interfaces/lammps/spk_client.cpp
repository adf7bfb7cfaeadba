// Implementation of the schnetpack_tpu model-server client.
#include "spk_client.h"

#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <cstring>

namespace spk_tpu {

ModelClient::ModelClient(const std::string &socket_path)
    : socket_path_(socket_path) {}

ModelClient::~ModelClient() { close_connection(); }

bool ModelClient::connect_server() {
  if (fd_ >= 0) return true;
  fd_ = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd_ < 0) return false;
  sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, socket_path_.c_str(), sizeof(addr.sun_path) - 1);
  if (::connect(fd_, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) != 0) {
    ::close(fd_);
    fd_ = -1;
    return false;
  }
  return true;
}

void ModelClient::close_connection() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

bool ModelClient::send_all(const void *buf, size_t n) {
  const char *p = static_cast<const char *>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd_, p, n, 0);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool ModelClient::recv_all(void *buf, size_t n) {
  char *p = static_cast<char *>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd_, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool ModelClient::evaluate(int64_t n_atoms, int64_t n_edges,
                           const int32_t *numbers, const double *positions,
                           const double *cell, const int64_t *idx_i,
                           const int64_t *idx_j, const double *offsets,
                           double *energy, std::vector<double> *e_atom,
                           std::vector<double> *forces, double *virial9) {
  if (!connect_server()) return false;
  int64_t header[2] = {n_atoms, n_edges};
  if (!send_all(header, sizeof(header))) return false;
  if (!send_all(numbers, sizeof(int32_t) * n_atoms)) return false;
  if (!send_all(positions, sizeof(double) * 3 * n_atoms)) return false;
  if (!send_all(cell, sizeof(double) * 9)) return false;
  if (!send_all(idx_i, sizeof(int64_t) * n_edges)) return false;
  if (!send_all(idx_j, sizeof(int64_t) * n_edges)) return false;
  if (!send_all(offsets, sizeof(double) * 3 * n_edges)) return false;

  int64_t n_back = 0;
  if (!recv_all(&n_back, sizeof(n_back))) return false;
  if (n_back != n_atoms) return false;
  if (!recv_all(energy, sizeof(double))) return false;
  e_atom->resize(n_atoms);
  forces->resize(3 * n_atoms);
  if (!recv_all(e_atom->data(), sizeof(double) * n_atoms)) return false;
  if (!recv_all(forces->data(), sizeof(double) * 3 * n_atoms)) return false;
  if (!recv_all(virial9, sizeof(double) * 9)) return false;
  return true;
}

bool ModelClient::evaluate_partial(
    int64_t rank, int64_t nprocs, int64_t n_global, int64_t n_local,
    int64_t n_edges, const int64_t *tags, const int32_t *numbers,
    const double *positions, const double *cell, const int64_t *idx_i,
    const int64_t *idx_j, const double *xj_abs, double *energy_share,
    std::vector<double> *e_atom, std::vector<double> *forces,
    double *virial9) {
  if (!connect_server()) return false;
  // header: sentinel -2 + rank, then the partial block
  int64_t header[2] = {-2, rank};
  if (!send_all(header, sizeof(header))) return false;
  int64_t meta[4] = {nprocs, n_global, n_local, n_edges};
  if (!send_all(meta, sizeof(meta))) return false;
  if (!send_all(tags, sizeof(int64_t) * n_local)) return false;
  if (!send_all(numbers, sizeof(int32_t) * n_local)) return false;
  if (!send_all(positions, sizeof(double) * 3 * n_local)) return false;
  if (!send_all(cell, sizeof(double) * 9)) return false;
  if (!send_all(idx_i, sizeof(int64_t) * n_edges)) return false;
  if (!send_all(idx_j, sizeof(int64_t) * n_edges)) return false;
  if (!send_all(xj_abs, sizeof(double) * 3 * n_edges)) return false;

  int64_t n_back = 0;
  if (!recv_all(&n_back, sizeof(n_back))) return false;
  if (n_back != n_local) return false;
  if (!recv_all(energy_share, sizeof(double))) return false;
  e_atom->resize(n_local);
  forces->resize(3 * n_local);
  if (!recv_all(e_atom->data(), sizeof(double) * n_local)) return false;
  if (!recv_all(forces->data(), sizeof(double) * 3 * n_local)) return false;
  if (!recv_all(virial9, sizeof(double) * 9)) return false;
  return true;
}

}  // namespace spk_tpu
