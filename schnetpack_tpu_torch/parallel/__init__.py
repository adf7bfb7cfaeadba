from .columns import (
    ColumnMesh, SpatialColumnSimulator, column_inputs, column_noise,
    make_column_mesh, make_sharded_column_chunk, make_sharded_column_eval,
    make_sharded_column_md, make_sharded_column_rpmd,
)

__all__ = ["ColumnMesh", "SpatialColumnSimulator", "column_inputs",
           "column_noise", "make_column_mesh", "make_sharded_column_chunk",
           "make_sharded_column_eval", "make_sharded_column_md",
           "make_sharded_column_rpmd"]
