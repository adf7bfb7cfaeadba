#!/usr/bin/env bash
# Integrate the schnetpack_tpu pair style into a LAMMPS source tree
# (parity: reference interfaces/lammps/patch_lammps.sh); the pair style
# talks to the PyTorch port's model server on the GPU.
#
# Usage: ./patch_lammps.sh /path/to/lammps
set -euo pipefail

LAMMPS_DIR="${1:?usage: patch_lammps.sh <lammps source dir>}"
HERE="$(cd "$(dirname "$0")" && pwd)"

if [ ! -d "$LAMMPS_DIR/src" ]; then
  echo "error: $LAMMPS_DIR does not look like a LAMMPS source tree" >&2
  exit 1
fi

cp "$HERE/pair_schnetpack_tpu.cpp" "$LAMMPS_DIR/src/"
cp "$HERE/spk_client.h" "$HERE/spk_client.cpp" "$LAMMPS_DIR/src/"

echo "Sources copied. Build LAMMPS as usual, e.g.:"
echo "  cd $LAMMPS_DIR && mkdir -p build && cd build"
echo "  cmake ../cmake -DBUILD_MPI=on && make -j"
echo
echo "Run the model server before launching lammps:"
echo "  python -m schnetpack_tpu_torch.interfaces.lammps.server \\"
echo "      model_dir=<trained run dir or deployed artifact> \\"
echo "      socket=/tmp/schnetpack_tpu.sock cutoff=5.0 device=cuda"
