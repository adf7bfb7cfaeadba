"""Minimal hydra-style config composition (a copy of
``schnetpack_tpu/config/compose.py`` that reads and writes YAML through
``miniyaml``, the port's reader of the configs' YAML subset, in place of
PyYAML).  It implements the subset of Hydra the CLIs need:

* config groups: ``<dir>/<group>/<name>.yaml``;
* a ``defaults:`` list with ``- group: name``, ``- _self_`` and
  ``- override /group: name`` entries (experiment overlays);
* dotted CLI overrides ``a.b.c=value`` (+``+a.b=value`` to add);
* ``${...}`` interpolation: config references, ``${uuid:}``,
  ``${petname:}``, ``${tmpdir:}``, ``${env:VAR}``, ``${now:}``;
* ``instantiate()`` for ``_target_`` nodes (recursive, ``_args_`` support).
"""
from __future__ import annotations

import copy
import importlib
import os
import random
import re
import tempfile
import time
import uuid as uuid_mod
from typing import Any, Dict, Optional, Sequence

from . import miniyaml

_PETNAMES_A = ["swift", "calm", "brave", "merry", "quiet", "sunny", "bold", "witty"]
_PETNAMES_B = ["otter", "falcon", "willow", "maple", "argon", "quartz", "comet", "fern"]


def _load_yaml(path: str) -> Dict:
    return miniyaml.load(path) or {}


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in (over or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(v: str) -> Any:
    try:
        return miniyaml.loads(v)
    except ValueError:
        return v


def _set_dotted(cfg: Dict, key: str, value: Any, allow_new: bool = True):
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if not allow_new:
                raise KeyError(key)
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def _get_dotted(cfg: Dict, key: str) -> Any:
    node = cfg
    for p in key.split("."):
        node = node[p]
    return node


class Composer:
    def __init__(self, config_dirs: Sequence[str]):
        self.config_dirs = [d for d in config_dirs if d and os.path.isdir(d)]

    def _find(self, group: str, name: str) -> Optional[str]:
        for d in self.config_dirs:
            p = os.path.join(d, group, f"{name}.yaml") if group else os.path.join(d, f"{name}.yaml")
            if os.path.exists(p):
                return p
        return None

    def _load_group(self, group: str, name: str) -> Dict:
        path = self._find(group, name)
        if path is None:
            raise FileNotFoundError(f"config {group}/{name}.yaml not found in {self.config_dirs}")
        node = _load_yaml(path)
        # nested defaults inside group configs
        return self._expand(node, group)

    def _expand(self, node: Dict, group: str = "") -> Dict:
        defaults = node.pop("defaults", None)
        if not defaults:
            return node
        merged: Dict = {}
        self_pos_applied = False
        for entry in defaults:
            if entry == "_self_":
                merged = _deep_merge(merged, node)
                self_pos_applied = True
                continue
            if isinstance(entry, dict):
                for g, n in entry.items():
                    # "override /group" entries resolve against the config
                    # root, like plain "group" entries (absolute groups)
                    g = str(g).replace("override ", "").lstrip("/")
                    if n is None:
                        continue
                    sub = self._load_group(g, str(n))
                    key = g.split("/")[-1]
                    merged = _deep_merge(merged, {key: sub})
            else:
                # bare name: same-group include
                sub = self._load_group(group, str(entry))
                merged = _deep_merge(merged, sub)
        if not self_pos_applied:
            merged = _deep_merge(merged, node)
        return merged

    def compose(self, config_name: str, overrides: Sequence[str] = ()) -> Dict:
        cfg = self._load_group("", config_name)
        # experiment overlays etc. via overrides of the form group=name
        simple_overrides = []
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override {ov!r} must be key=value")
            key, value = ov.split("=", 1)
            add = key.startswith("+")
            key = key.lstrip("+")
            if "." not in key and self._find(key, str(value)):
                sub = self._load_group(key, str(value))
                if key == "experiment":
                    # experiment overlays patch the whole tree
                    cfg = _deep_merge(cfg, sub)
                elif "/" in key:
                    # subgroup swap (e.g. task/optimizer=sgd): the file
                    # holds keys of the PARENT group node — merge them
                    # into that node (hydra-style package semantics)
                    parent = key.rsplit("/", 1)[0]
                    node = cfg
                    for seg in parent.split("/"):
                        node = node.setdefault(seg, {})
                    node.update(_deep_merge(node, sub))
                else:
                    # group swap: REPLACE the group node entirely
                    cfg[key] = sub
            else:
                simple_overrides.append((key, _parse_value(value), add))
        for key, value, add in simple_overrides:
            _set_dotted(cfg, key, value, allow_new=True)
        cfg = resolve_interpolations(cfg)
        return cfg


_INTERP = re.compile(r"\$\{([^}]+)\}")


def resolve_interpolations(cfg: Dict) -> Dict:
    resolvers = {
        "uuid": lambda arg: uuid_mod.uuid4().hex,
        "petname": lambda arg: f"{random.choice(_PETNAMES_A)}-{random.choice(_PETNAMES_B)}",
        "tmpdir": lambda arg: tempfile.gettempdir(),
        "env": lambda arg: os.environ.get(arg, ""),
        "now": lambda arg: time.strftime(arg or "%Y-%m-%d_%H-%M-%S"),
    }

    def resolve(value, root):
        if isinstance(value, str):
            def sub(m):
                expr = m.group(1)
                if ":" in expr:
                    name, _, arg = expr.partition(":")
                    if name in resolvers:
                        return str(resolvers[name](arg))
                try:
                    return str(resolve(_get_dotted(root, expr), root))
                except Exception:
                    return m.group(0)
            new = _INTERP.sub(sub, value)
            if new != value:
                return _parse_value(new) if not _INTERP.search(new) else new
            return value
        if isinstance(value, dict):
            return {k: resolve(v, root) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, root) for v in value]
        return value

    # two passes for chained references
    out = resolve(cfg, cfg)
    return resolve(out, out)


def instantiate(node: Any, **kwargs):
    """Recursively build objects from ``_target_`` nodes (hydra-style)."""
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    if not isinstance(node, dict):
        return node
    node = dict(node)
    target = node.pop("_target_", None)
    args = node.pop("_args_", [])
    built = {k: instantiate(v) for k, v in node.items()}
    built.update(kwargs)
    if target is None:
        return built
    module, _, name = target.rpartition(".")
    cls = getattr(importlib.import_module(module), name)
    return cls(*[instantiate(a) for a in args], **built)


def save_config(cfg: Dict, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    miniyaml.dump(cfg, path)
