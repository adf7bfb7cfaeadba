"""Training: the task and its optimizers, the trainer, checkpoints and
loggers (port of ``schnetpack_tpu/train``)."""
from .callbacks import ModelCheckpoint, PredictionWriter, load_pytree, save_pytree
from .loop import CSVLogger, TensorBoardLogger, Trainer
from .lr_scheduler import ReduceLROnPlateau
from .task import (
    AtomisticTask,
    ConsiderOnlySelectedAtoms,
    ModelOutput,
    TrainState,
    UnsupervisedModelOutput,
    aggregate_metrics,
    as_tensors,
)

__all__ = [
    "ModelCheckpoint", "PredictionWriter", "load_pytree", "save_pytree",
    "CSVLogger", "TensorBoardLogger", "Trainer", "ReduceLROnPlateau",
    "AtomisticTask", "ConsiderOnlySelectedAtoms", "ModelOutput",
    "TrainState", "UnsupervisedModelOutput", "aggregate_metrics",
    "as_tensors",
]
