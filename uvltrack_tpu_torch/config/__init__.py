from .cfgnode import CfgNode
from .defaults import default_cfg, load_cfg

__all__ = ["CfgNode", "default_cfg", "load_cfg"]
