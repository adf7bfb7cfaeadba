"""Inter-process file locking with ``fcntl`` (a copy of
``schnetpack_tpu/utils/locking.py``)."""
from __future__ import annotations

import contextlib
import fcntl
import os


@contextlib.contextmanager
def file_lock(path: str):
    """Exclusive advisory lock on ``path`` (created if missing)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
