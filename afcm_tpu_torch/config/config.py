"""Configuration system.

A lightweight re-implementation of the reference's fvcore-based CfgNode
(reference: configs/config.py:37-150): attribute-style nested dicts, YAML
files with ``_BASE_`` inheritance, dotted-key CLI overrides, model-default
injection before the YAML merge (so experiment YAMLs only override known
keys), and freezing.

The port's own copy of ``afcm_tpu/config/config.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
from typing import Any, Dict, List, Optional

import yaml

_BASE_KEY = "_BASE_"


class CfgNode(dict):
    """Nested attribute dict with freeze + strict merge."""

    __frozen = False

    def __init__(self, init: Optional[Dict] = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # attribute access -------------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_CfgNode__"):
            object.__setattr__(self, name, value)
            return
        if self.__frozen:
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    def __setitem__(self, key, value):
        if self.__frozen:
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # lifecycle --------------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def freeze(self):
        self.__frozen = True
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self):
        self.__frozen = False
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return self.__frozen

    # merging ----------------------------------------------------------------
    def merge_from_other(self, other: Dict, allow_new: bool = False,
                         _path: str = ""):
        for key, value in other.items():
            full = f"{_path}.{key}" if _path else key
            if key not in self:
                if not allow_new:
                    raise KeyError(f"Non-existent config key: {full}")
                self[key] = CfgNode(value) if isinstance(value, dict) else value
                continue
            if isinstance(self[key], CfgNode) and isinstance(value, dict):
                self[key].merge_from_other(value, allow_new=allow_new, _path=full)
            else:
                self[key] = _coerce(value, self[key], full)

    def merge_from_file(self, filename: str, allow_new: bool = False):
        cfg = _load_yaml_with_base(filename)
        cfg.pop("VERSION", None)
        self.merge_from_other(cfg, allow_new=allow_new)

    def merge_from_list(self, opts: List[str]):
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(_parse_literal(value), node[leaf], key)

    def to_dict(self) -> Dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v
                for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _parse_literal(value: str) -> Any:
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Light type reconciliation between override and existing value."""
    if old is None or value is None:
        return value
    if isinstance(old, bool) and not isinstance(value, bool):
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes"):
                return True
            if value.lower() in ("false", "0", "no"):
                return False
        raise TypeError(f"Cannot coerce {value!r} to bool for key {key}")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if type(old) is not type(value) and not (
            isinstance(old, (int, float)) and isinstance(value, (int, float))):
        raise TypeError(
            f"Type mismatch for key {key}: {type(old).__name__} vs "
            f"{type(value).__name__} ({value!r})")
    return value


def _load_yaml_with_base(filename: str) -> Dict:
    with open(filename) as f:
        cfg = yaml.safe_load(f) or {}
    base = cfg.pop(_BASE_KEY, None)
    if base is not None:
        base_path = base if os.path.isabs(base) else \
            os.path.join(os.path.dirname(filename), base)
        merged = _load_yaml_with_base(base_path)
        _deep_update(merged, cfg)
        return merged
    return cfg


def _deep_update(dst: Dict, src: Dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


# ---------------------------------------------------------------------------


def get_cfg() -> CfgNode:
    from .defaults import get_default_cfg
    return get_default_cfg()


def setup(args) -> CfgNode:
    """Build the final frozen config (reference: configs/config.py:19-34).

    Order: defaults -> model-specific defaults (selected by --model or the
    YAML's model.name) -> YAML (with _BASE_ chain) -> CLI overrides.
    """
    from .defaults import apply_model_defaults

    cfg = get_cfg()
    model_name = getattr(args, "model", None)
    if model_name is None and getattr(args, "config_file", None):
        yaml_cfg = _load_yaml_with_base(args.config_file)
        model_name = yaml_cfg.get("model", {}).get("name", cfg.model.name)
    apply_model_defaults(cfg, model_name or cfg.model.name)

    if getattr(args, "config_file", None):
        cfg.merge_from_file(args.config_file)
    # --num-gpus N (reference: configs/config.py:29-31 → cfg.gpu_ids /
    # DataParallel): the JAX package's analog is N devices on the mesh's data axis.
    # Only the data axis is set — a YAML-configured model (tensor-parallel)
    # axis is preserved. Applied before opts so an explicit
    # `tpu.mesh_shape` override wins.
    n_dev = getattr(args, "num_gpus", None)
    if n_dev:
        cfg.tpu.mesh_shape = [int(n_dev), int(cfg.tpu.mesh_shape[1])]
    if getattr(args, "opts", None):
        cfg.merge_from_list(args.opts)
    cfg.model.name = model_name or cfg.model.name
    cfg.freeze()
    return cfg


def default_argument_parser(argv: Optional[List[str]] = None) -> CfgNode:
    parser = argparse.ArgumentParser(description="afcm_tpu_torch")
    parser.add_argument("--config-file", default="", metavar="FILE",
                        help="path to config file")
    parser.add_argument("--model", default=None,
                        help="model family: stylegan3 | comodgan | pix2pix")
    parser.add_argument("--num-gpus", "--num-devices", type=int, default=0,
                        dest="num_gpus",
                        help="devices on the mesh's data axis (reference "
                             "CLI compat; same as `tpu.mesh_shape [N,1]`)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                        help="dotted-key config overrides: KEY VALUE ...")
    args = parser.parse_args(argv)
    return setup(args)


def pop_flag(argv: List[str], name: str, has_value: bool = True):
    """Extract an ad-hoc ``--name value`` / ``--name=value`` (or boolean
    ``--name``) flag from an argv list in place.

    Returns the value string (or True for boolean flags) when present,
    else None (False). Shared by the CLIs for their few flags that live
    outside the config tree (``--device``).
    """
    for i, tok in enumerate(argv):
        if tok == name:
            if not has_value:
                del argv[i]
                return True
            if i + 1 >= len(argv):
                raise SystemExit(f"{name} requires a value")
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if has_value and tok.startswith(name + "="):
            del argv[i]
            return tok[len(name) + 1:]
    return None if has_value else False
