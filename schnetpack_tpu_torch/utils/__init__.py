"""Host utilities of the port (copies of ``schnetpack_tpu/utils``'s
numpy-free pieces)."""
from .locking import file_lock


def str2class(path: str):
    """The object at a dotted path such as
    ``schnetpack_tpu_torch.data.StratifiedSampler``."""
    import importlib

    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


__all__ = ["file_lock", "str2class"]
