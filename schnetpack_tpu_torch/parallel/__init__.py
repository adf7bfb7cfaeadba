"""Several ranks: meshes (``mesh.py``), the slab-decomposed column path
(``columns.py``), data-parallel training (``data_parallel.py``) and the
pair-sharded flat layout (``spatial.py``)."""
from .columns import (
    ColumnMesh, SpatialColumnSimulator, column_inputs, column_noise,
    gather_slabs, make_column_mesh, make_sharded_column_chunk,
    make_sharded_column_eval, make_sharded_column_md,
    make_sharded_column_rpmd, slab_of,
)
from .data_parallel import (
    DataParallelTask, GroupedLoader, make_parallel_eval_step,
    make_parallel_train_step, split_loader_for_mesh, stack_device_batches,
)
from .mesh import Mesh, MeshError, make_mesh, spawn_ranks

__all__ = ["ColumnMesh", "DataParallelTask", "GroupedLoader", "Mesh",
           "MeshError", "SpatialColumnSimulator", "column_inputs",
           "column_noise", "gather_slabs", "make_column_mesh", "make_mesh",
           "make_parallel_eval_step", "make_parallel_train_step",
           "make_sharded_column_chunk", "make_sharded_column_eval",
           "make_sharded_column_md", "make_sharded_column_rpmd", "slab_of",
           "spawn_ranks", "split_loader_for_mesh", "stack_device_batches"]
