from .columns import (
    ColumnMesh, SpatialColumnSimulator, column_inputs, make_column_mesh,
    make_sharded_column_chunk, make_sharded_column_eval,
)

__all__ = ["ColumnMesh", "SpatialColumnSimulator", "column_inputs",
           "make_column_mesh", "make_sharded_column_chunk",
           "make_sharded_column_eval"]
