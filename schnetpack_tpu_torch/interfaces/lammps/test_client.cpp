// Standalone test client: replicates the PAIR STYLE's structure assembly
// (type -> element map, triclinic cell, periodic edge list with per-edge
// image offsets) against a brute-force image search, queries the model
// server, and prints energy / forces / virial.  Used by the offline test
// suite to validate the wire protocol and the pair-style conventions
// without a LAMMPS build.
//
// stdin:  n ntypes cutoff
//         cell row-major (9 floats)
//         Z_of_type[1..ntypes]
//         n lines: "<type> <x> <y> <z>"
// Usage: ./test_client <socket>
#include "spk_client.h"

#include <cstdio>
#include <cstdlib>
#include <vector>

int main(int argc, char **argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: %s <socket>\n", argv[0]);
    return 2;
  }
  spk_tpu::ModelClient client(argv[1]);

  long n, ntypes;
  double cutoff;
  if (std::scanf("%ld %ld %lf", &n, &ntypes, &cutoff) != 3) return 2;
  double cell[9];
  for (int k = 0; k < 9; k++)
    if (std::scanf("%lf", &cell[k]) != 1) return 2;
  std::vector<int32_t> type_to_z(ntypes + 1, -1);
  for (long t = 1; t <= ntypes; t++) {
    int z;
    if (std::scanf("%d", &z) != 1) return 2;
    type_to_z[t] = z;
  }
  std::vector<int32_t> numbers(n);
  std::vector<double> pos(3 * n);
  for (long i = 0; i < n; i++) {
    int t;
    if (std::scanf("%d %lf %lf %lf", &t, &pos[3 * i], &pos[3 * i + 1],
                   &pos[3 * i + 2]) != 4)
      return 2;
    numbers[i] = type_to_z[t];
  }

  // brute-force periodic edge list over +-1 images (the ghost shell a
  // LAMMPS full neighbor list would provide)
  std::vector<int64_t> idx_i, idx_j;
  std::vector<double> offsets;
  const double c2 = cutoff * cutoff;
  for (long i = 0; i < n; i++) {
    for (long j = 0; j < n; j++) {
      for (int sx = -1; sx <= 1; sx++)
        for (int sy = -1; sy <= 1; sy++)
          for (int sz = -1; sz <= 1; sz++) {
            if (i == j && sx == 0 && sy == 0 && sz == 0) continue;
            double ox = sx * cell[0] + sy * cell[3] + sz * cell[6];
            double oy = sx * cell[1] + sy * cell[4] + sz * cell[7];
            double oz = sx * cell[2] + sy * cell[5] + sz * cell[8];
            double dx = pos[3 * j] + ox - pos[3 * i];
            double dy = pos[3 * j + 1] + oy - pos[3 * i + 1];
            double dz = pos[3 * j + 2] + oz - pos[3 * i + 2];
            if (dx * dx + dy * dy + dz * dz >= c2) continue;
            idx_i.push_back(i);
            idx_j.push_back(j);
            offsets.push_back(ox);
            offsets.push_back(oy);
            offsets.push_back(oz);
          }
    }
  }

  double energy = 0.0, virial9[9];
  std::vector<double> e_atom, forces;
  if (!client.evaluate(n, static_cast<int64_t>(idx_i.size()), numbers.data(),
                       pos.data(), cell, idx_i.data(), idx_j.data(),
                       offsets.data(), &energy, &e_atom, &forces, virial9)) {
    std::fprintf(stderr, "evaluation failed\n");
    return 1;
  }
  std::printf("energy %.10f\n", energy);
  std::printf("n_edges %ld\n", (long)idx_i.size());
  double e_sum = 0.0;
  for (long i = 0; i < n; i++) e_sum += e_atom[i];
  std::printf("energy_atom_sum %.10f\n", e_sum);
  for (long i = 0; i < n; i++)
    std::printf("force %ld %.10f %.10f %.10f\n", i, forces[3 * i],
                forces[3 * i + 1], forces[3 * i + 2]);
  std::printf("virial %.10f %.10f %.10f %.10f %.10f %.10f %.10f %.10f %.10f\n",
              virial9[0], virial9[1], virial9[2], virial9[3], virial9[4],
              virial9[5], virial9[6], virial9[7], virial9[8]);
  return 0;
}
