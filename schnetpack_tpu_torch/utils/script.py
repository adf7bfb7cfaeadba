"""Run-script helpers: config printing and hyperparameter logging (a copy
of ``schnetpack_tpu/utils/script.py``, dependency-free)."""
from __future__ import annotations

import json
from typing import Dict, Optional, Sequence


def print_config(
    config: Dict,
    fields: Sequence[str] = ("run", "globals", "data", "model", "task", "trainer"),
    indent: int = 2,
) -> None:
    """Pretty-print the composed config tree."""
    for field in fields:
        if field not in config:
            continue
        print(f"├─ {field}")
        body = json.dumps(config[field], indent=indent, default=str)
        for line in body.splitlines():
            print("│  " + line)


def log_hyperparameters(config: Dict, loggers: Optional[Sequence] = None) -> None:
    """Flatten and log the config once (parity: script.py:25-38)."""
    flat = {}

    def walk(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        else:
            flat[prefix[:-1]] = node

    walk(config)
    for lg in loggers or []:
        writer = getattr(lg, "writer", None)
        if writer is not None and hasattr(writer, "add_text"):
            writer.add_text("hparams", json.dumps(flat, default=str))
