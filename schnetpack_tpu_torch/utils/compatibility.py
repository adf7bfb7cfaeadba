"""Model loading with version-migration shims (parity:
``schnetpack_tpu/utils/compatibility.py``).

``load_model`` takes a run directory (the JAX training CLI's format, which
the port's ``spktrain`` also writes) or a deployed artifact (``deploy.py``)
and applies the registered migrations to a run directory's model config,
so that configs written by older versions keep loading.
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Tuple

#: (from_version, migration) pairs applied in order to model configs
_MIGRATIONS: List[Tuple[str, Callable[[Dict], Dict]]] = []


def register_migration(from_version: str):
    def deco(fn):
        _MIGRATIONS.append((from_version, fn))
        return fn
    return deco


def migrate_config(model_cfg: Dict) -> Dict:
    version = model_cfg.pop("_version", "0.1.0")
    for from_version, fn in _MIGRATIONS:
        if version <= from_version:
            model_cfg = fn(model_cfg)
    return model_cfg


def load_model(model_dir: str, device="cuda"):
    """(model on ``device``, state dict) of a run directory or a deployed
    artifact; the card unless the caller asks for the CPU."""
    from ..cli import model_from_config
    from ..convert import load_jax_params

    if os.path.isfile(model_dir):
        from ..deploy import load_deployed

        model, params, _ = load_deployed(model_dir, device)
        return model, params
    with open(os.path.join(model_dir, "model_config.pkl"), "rb") as f:
        model_cfg = migrate_config(pickle.load(f))
    return model_from_config(model_cfg, load_jax_params(
        os.path.join(model_dir, "best_model")), device)
