"""Config layer of the port: the port's own copy of ``afcm_tpu/config``. The
YAML files under ``configs/`` are shared with the JAX package, so the key
names (``tpu.*`` included) stay as they are."""

from .config import (CfgNode, default_argument_parser, get_cfg,
                     pop_flag, setup)
from .defaults import apply_model_defaults, get_default_cfg

__all__ = ["CfgNode", "apply_model_defaults", "default_argument_parser",
           "get_cfg", "get_default_cfg", "pop_flag", "setup"]
