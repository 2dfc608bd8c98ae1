"""YAML configs with the HGNN reference's custom tags.

The port of ``gcn_tpu.utils.config`` (pyhgnn/config/config.py:6-43):
``!join`` joins path segments with the OS separator, ``!concat``
string-concatenates, and the result/checkpoint directories are created on
request while the data root is only read. PyYAML is imported inside
``get_config``, so nothing else of the port needs it.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict

CONFIG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                      "configs")


def check_dir(folder: str, mk_dir: bool = True) -> None:
    if not osp.exists(folder):
        if mk_dir:
            os.makedirs(folder, exist_ok=True)
        else:
            raise FileNotFoundError(f"required directory missing: {folder}")


def get_config(path: str, *, make_dirs: bool = True) -> Dict[str, Any]:
    """Load a YAML config with !join/!concat tags; with ``make_dirs``,
    create its result directories."""
    import yaml

    class TagLoader(yaml.SafeLoader):
        pass

    def join(loader, node):
        return os.path.sep.join(map(str, loader.construct_sequence(node)))

    def concat(loader, node):
        return "".join(map(str, loader.construct_sequence(node)))

    TagLoader.add_constructor("!join", join)
    TagLoader.add_constructor("!concat", concat)
    with open(path) as f:
        cfg = yaml.load(f, Loader=TagLoader)
    if make_dirs:
        for key in ("result_root", "ckpt_folder", "result_sub_folder"):
            if cfg.get(key):
                check_dir(cfg[key], mk_dir=True)
    return cfg
