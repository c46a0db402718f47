"""Config version compatibility (``afcm_tpu/config/compat.py``; reference:
configs/compat.py), a copy over the port's ``CfgNode``.

The reference ships detectron2's up/downgrade scaffolding with no converters
registered beyond the version guard; the same contract here: configs carry
``VERSION`` and ``upgrade_config`` walks the registered ConverterVN steps.
"""

from __future__ import annotations

from typing import Dict, Type

from .config import CfgNode

LATEST_VERSION = 2

_CONVERTERS: Dict[int, Type] = {}


def register_converter(version: int):
    def deco(cls):
        _CONVERTERS[version] = cls
        return cls
    return deco


def upgrade_config(cfg: CfgNode, to_version: int = LATEST_VERSION) -> CfgNode:
    cfg = cfg.clone()
    version = cfg.get("VERSION", LATEST_VERSION)
    assert version <= to_version, \
        f"Cannot upgrade from v{version} to older v{to_version}"
    for v in range(version, to_version):
        converter = _CONVERTERS.get(v + 1)
        if converter is not None:
            converter.upgrade(cfg)
        cfg.VERSION = v + 1
    return cfg


def downgrade_config(cfg: CfgNode, to_version: int) -> CfgNode:
    cfg = cfg.clone()
    version = cfg.get("VERSION", LATEST_VERSION)
    assert version >= to_version
    for v in range(version, to_version, -1):
        converter = _CONVERTERS.get(v)
        if converter is not None:
            converter.downgrade(cfg)
        cfg.VERSION = v - 1
    return cfg


@register_converter(2)
class ConverterV2:
    """v1 -> v2: no structural changes (parity with the reference, which
    registers no converters either)."""

    @staticmethod
    def upgrade(cfg: CfgNode):
        pass

    @staticmethod
    def downgrade(cfg: CfgNode):
        pass
