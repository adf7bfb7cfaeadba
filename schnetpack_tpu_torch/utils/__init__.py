"""Host utilities of the port (parity: ``schnetpack_tpu/utils``): file
locking, dotted-path lookup, dtypes by name (as torch dtypes), the fields
that response properties need, model loading with migrations, and the
run scripts' config printing and hyperparameter logging."""
from .compatibility import load_model, migrate_config, register_migration
from .locking import file_lock
from .script import log_hyperparameters, print_config


def str2class(path: str):
    """The object at a dotted path such as
    ``schnetpack_tpu_torch.data.StratifiedSampler``."""
    import importlib

    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


def as_dtype(name: str):
    """A dtype name -> the torch dtype."""
    import torch

    return {
        "float32": torch.float32,
        "float64": torch.float64,
        "bfloat16": torch.bfloat16,
        "float16": torch.float16,
        "int32": torch.int32,
        "int64": torch.int64,
    }[name]


def int2precision(precision: int):
    """16/32/64 -> the torch dtype (16 is bfloat16, as in the JAX
    package)."""
    import torch

    return {16: torch.bfloat16, 32: torch.float32,
            64: torch.float64}[int(precision)]


def required_fields_from_properties(properties_list):
    """External fields needed for the given response properties
    (parity: utils/__init__.py:38-96)."""
    from .. import properties as structure

    fields = []
    for p in properties_list:
        for f in structure.required_external_fields.get(p, []):
            if f not in fields:
                fields.append(f)
    return fields


__all__ = [
    "file_lock", "str2class", "as_dtype", "int2precision",
    "required_fields_from_properties",
    "load_model", "migrate_config", "register_migration",
    "log_hyperparameters", "print_config",
]
