"""The LAMMPS model server (``server.py``) and the C++ pair style and
client sources it serves (``pair_schnetpack_tpu.cpp``, ``spk_client.*``,
``test_client.cpp``, ``patch_lammps.sh``, ``stubs/``)."""
from .server import LammpsModelServer

__all__ = ["LammpsModelServer"]
