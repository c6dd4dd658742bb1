"""Hierarchical YAML config system.

A copy of ``clipspm_tpu/utils/config.py``; it reads ``configs/`` in place.

Reproduces the observable semantics of the reference config loader
(reference: utils/config.py:9-147): a base YAML (``configs/base.yaml``) is
recursively overridden by a model/dataset YAML given on the command line;
nested dicts become attribute trees; keys containing ``"BASE"`` are not
introduced by overrides; strings that look like scientific notation with a
negative exponent (``"5e-5"``) are coerced to float (reference:
utils/config.py:127-128 applies the coercion when ``elem[1:3] == "e-"``).

This implementation is a fresh design: a single ``ConfigNode`` mapping type
with attribute access plus free functions for loading/merging, rather than a
class that parses argv in its constructor. CLI parsing lives in ``cli/run.py``.

Derived fields that the reference trainer computes in ``parse_config``
(reference: run/main_run.py:143-177 — dataset -> split dir / frame dir,
``trans_linear_in_dim``) are attached here by :func:`finalize_config` so every
consumer sees one fully-resolved config.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional

import yaml

# matches e.g. "5e-5", "1.25e-3" (the reference coerces any str with "e-" at
# positions 1:3; we use a real scientific-notation regex instead, which is a
# strict superset of the values that appear in the shipped configs).
_SCI_RE = re.compile(r"^[+-]?\d+(\.\d+)?[eE][+-]?\d+$")


class ConfigNode(Mapping):
    """An immutable-by-convention attribute tree over a nested dict.

    Supports both attribute (``cfg.TRAIN.WAY``) and mapping (``cfg["TRAIN"]``)
    access. Unknown attribute access raises ``AttributeError`` so typos fail
    loudly. Use :meth:`to_dict` for serialization.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = self._wrap(v)

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict):
            return ConfigNode(value)
        if isinstance(value, str) and _SCI_RE.match(value):
            return float(value)
        return value

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(f"config has no key {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = self._wrap(value)

    # -- mapping protocol ----------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- utilities -----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else v
        return out

    def deep_copy(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def dump(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def __repr__(self) -> str:
        return f"ConfigNode({self.dump()})"


def merge_into_base(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (mutates and returns base).

    Matches the reference merge rule (reference: utils/config.py:92-113):
    existing keys are replaced (dicts recurse); new keys are added unless the
    key name contains ``"BASE"``.
    """
    for k, v in override.items():
        if k in base:
            if isinstance(v, dict) and isinstance(base[k], dict):
                merge_into_base(base[k], v)
            else:
                base[k] = v
        elif "BASE" not in k:
            base[k] = v
    return base


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        data = yaml.safe_load(f.read())
    return data or {}


def apply_opts(cfg_dict: Dict[str, Any], opts: Optional[list]) -> Dict[str, Any]:
    """Apply ``KEY.SUBKEY=value`` command-line overrides.

    The reference accepts an ``opts`` remainder but never applies it
    (reference: utils/config.py:52-57); we repair that: dotted keys index into
    the nested dict and values are parsed as YAML scalars.
    """
    for opt in opts or []:
        if "=" not in opt:
            raise ValueError(f"override {opt!r} is not of the form KEY.PATH=value")
        key, value = opt.split("=", 1)
        node = cfg_dict
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(value)
    return cfg_dict


# Per-dataset SPM hyperparameters. The reference injects these in code, with
# the rows for the other datasets left as comments (reference: run/run.py:10-17);
# we ship them as a proper table keyed by dataset name.
SPM_DEFAULT_PARAMS: Dict[str, Dict[str, float]] = {
    "hmdb": dict(mid_dim_vision=0.5, mid_dim_text=1.5, negative_slope=0.0025,
                 alpha=0.2, consist_1=0.54, text_dis=0.07, motion_alpha=1),
    "ssv2_cmn": dict(mid_dim_vision=0.5, mid_dim_text=1.5, negative_slope=0.0025,
                     alpha=0.2, consist_1=0.54, text_dis=0.07, motion_alpha=1),
    "ucf": dict(mid_dim_vision=2, mid_dim_text=2, negative_slope=0.054,
                alpha=0.228, consist_1=0.221, text_dis=0.0295, motion_alpha=1),
    "kinetics": dict(mid_dim_vision=0.5, mid_dim_text=1.5, negative_slope=0.042,
                     alpha=0.86, consist_1=0.62, text_dis=0.041, motion_alpha=1),
    "ssv2": dict(mid_dim_vision=0.5, mid_dim_text=0.75, negative_slope=0.052,
                 alpha=0.353, consist_1=0.579, text_dis=0.49, motion_alpha=1),
}

# dataset name -> (split list subdir, frame dir name)
# (reference: run/main_run.py:161-175)
DATASET_PATHS: Dict[str, tuple] = {
    "ssv2": ("splits/ssv2_OTAM", "ssv2_256x256q5_l8"),
    "ssv2_cmn": ("splits/ssv2_CMN", "ssv2_CMN_256x256q5_l8"),
    "hmdb": ("splits/hmdb_ARN", "hmdb_256x256q5_l8"),
    "ucf": ("splits/ucf_ARN", "ucf_256x256q5_l8"),
    "kinetics": ("splits/kinetics_CMN", "k100_256x256q5_l8"),
}


def finalize_config(cfg: ConfigNode, splits_root: Optional[str] = None) -> ConfigNode:
    """Attach derived fields (reference: run/main_run.py:143-177).

    - ``trans_linear_in_dim``: 2048 for resnet50 backbones else 512
    - ``traintestlist`` / ``path``: split-list dir and frame-root dir
    - ``params``: per-dataset SPM hyperparameters if not already set
    """
    backbone = cfg.MODEL.BACKBONE
    cfg.trans_linear_in_dim = 2048 if backbone == "resnet50" else 512

    dataset = cfg.DATA.DATASET
    if dataset in DATASET_PATHS:
        split_dir, frame_dir = DATASET_PATHS[dataset]
        root = splits_root if splits_root is not None else os.getcwd()
        cfg.traintestlist = os.path.join(root, split_dir)
        cfg.path = os.path.join(cfg.DATA.DATA_DIR, frame_dir)

    if "params" not in cfg:
        cfg.params = SPM_DEFAULT_PARAMS.get(dataset, SPM_DEFAULT_PARAMS["hmdb"])

    # class-name captions for CLIP text prompts: resolve from the
    # consolidated table when the override YAML doesn't embed them (the
    # reference embeds the lists in every CLIP-head config, e.g.
    # reference configs/clipspm/hmdb.yaml:16,23)
    names_path = os.path.join(_repo_root(), "configs", "class_names.yaml")
    if dataset in DATASET_PATHS and os.path.isfile(names_path):
        needs_train = "CLASS_NAME" not in cfg.get("TRAIN", {})
        needs_test = "CLASS_NAME" not in cfg.get("TEST", {})
        if needs_train or needs_test:
            table = load_yaml(names_path).get(dataset)
            if table:
                if needs_train and "TRAIN" in cfg:
                    cfg.TRAIN.CLASS_NAME = table["train"]
                if needs_test and "TEST" in cfg:
                    cfg.TEST.CLASS_NAME = table["test"]
    return cfg


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def load_config(
    cfg_path: str,
    base_path: Optional[str] = None,
    opts: Optional[list] = None,
    splits_root: Optional[str] = None,
) -> ConfigNode:
    """Load base.yaml + override yaml + CLI opts into a resolved ConfigNode."""
    if base_path is None:
        base_path = os.path.join(_repo_root(), "configs", "base.yaml")
    base = load_yaml(base_path)
    override = load_yaml(cfg_path)
    merged = merge_into_base(base, override)
    merged = apply_opts(merged, opts)
    cfg = ConfigNode(merged)
    return finalize_config(cfg, splits_root=splits_root)
