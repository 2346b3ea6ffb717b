"""Plain-Python config files with ``_base_`` inheritance (counterpart of
``detmatch_tpu/config/config.py``, which it matches result for result).

A config file is a python module; its module-level variables become the
config dict. ``_base_`` (str or list) merges parent files first (dicts
merge recursively, a child dict with ``_delete_=True`` replaces its
parent's; everything else overrides). After the merge, a string
``"${key}"`` becomes a copy of the top-level value ``key``, and
``"{key}"`` placeholders in strings are filled from top-level scalars.
:meth:`Config.merge_from_options` applies the dotted ``--cfg-options``
overrides of the command-line tools after that resolution, as the JAX
package does (an override of ``data_root`` does not reflow into paths).
"""
from __future__ import annotations

import copy
import os
import runpy
from typing import Any, Dict


def _deep_merge(base: Dict, new: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in new.items():
        if (k in out and isinstance(out[k], dict) and isinstance(v, dict)
                and not v.pop("_delete_", False)):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _map(obj, leaf):
    """Apply ``leaf`` to every leaf of nested dicts, lists and tuples."""
    if isinstance(obj, dict):
        return {k: _map(v, leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(v, leaf) for v in obj)
    return leaf(obj)


class _SafeMap(dict):
    def __missing__(self, k):
        return "{" + k + "}"


def _resolve(cfg: Dict) -> Dict:
    def ref(o):
        if isinstance(o, str) and o.startswith("${") and o.endswith("}"):
            return copy.deepcopy(cfg[o[2:-1]])
        return o

    cfg = _map(cfg, ref)
    scalars = _SafeMap({k: v for k, v in cfg.items()
                        if isinstance(v, (str, int, float))})

    def fmt(o):
        if isinstance(o, str) and "{" in o:
            try:
                return o.format_map(scalars)
            except (ValueError, KeyError, IndexError):
                return o
        return o

    return _map(cfg, fmt)


class Config(dict):
    """dict with attribute access."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(
            v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def fromfile(path: str) -> "Config":
        return Config(_resolve(_load(os.path.abspath(path))))

    def merge_from_options(self, options: Dict[str, Any]) -> "Config":
        """Dotted-path overrides ``{"a.b.c": value}``: missing or non-dict
        intermediate keys become empty dicts; returns ``self``."""
        for key, val in options.items():
            *parents, last = key.split(".")
            d = self
            for p in parents:
                if p not in d or not isinstance(d[p], dict):
                    d[p] = {}
                d = d[p]
            d[last] = val
        return self

    def dump(self) -> str:
        """The config as ``pprint`` text, 100 columns wide."""
        import pprint
        return pprint.pformat(dict(self), width=100)


def _load(path: str) -> Dict[str, Any]:
    """One file merged over its ``_base_`` files, references unresolved."""
    ns = runpy.run_path(path)
    cfg = {k: v for k, v in ns.items()
           if not k.startswith("_") and not callable(v)
           and not isinstance(v, type(os))}
    bases = ns.get("_base_", [])
    merged: Dict[str, Any] = {}
    for b in [bases] if isinstance(bases, str) else bases:
        merged = _deep_merge(merged, _load(
            os.path.join(os.path.dirname(path), b)))
    return _deep_merge(merged, cfg)
