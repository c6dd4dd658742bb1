"""The system under test, built from the benchmark's inputs.

The program is ``clipspm_tpu_torch`` alone: its model from
``models/fsar.py:build_model`` on the device, the benchmark's weights loaded
into it (the towers through the port's ``CLIPModel``, as its set-up loads a
released checkpoint), its text tables from ``models/text_features.py``, and
its ``Learner``. The entries a traffic mix drives are in ``entries/``.
"""

from __future__ import annotations

import copy

import torch

from clipspm_tpu_torch import set_matmul_precision
from clipspm_tpu_torch.data.episode import Episode
from clipspm_tpu_torch.models.backbones.clip import CLIP_ARCHS, CLIPModel
from clipspm_tpu_torch.models.fsar import build_model
from clipspm_tpu_torch.train.learner import Learner
from clipspm_tpu_torch.train.setup import build_text_tables
from clipspm_tpu_torch.utils.config import ConfigNode

from .inputs import make_weights


def port_config(config: dict, seed: int) -> ConfigNode:
    """The configuration's port config with ``MODEL.SEED`` set to the
    run's seed."""
    cfg = copy.deepcopy(config["port_config"])
    cfg["MODEL"]["SEED"] = int(seed)
    return ConfigNode(cfg)


def build(config: dict, seed: int, device) -> Learner:
    """The learner of ``config`` on ``device`` with the weights of
    ``seed``."""
    cfg = port_config(config, seed)
    set_matmul_precision(bool(cfg.get("USE_AMP", False)))
    weights = make_weights(config, seed, device)
    with torch.device(device):
        model = build_model(cfg)
        clip = CLIPModel(CLIP_ARCHS[cfg.MODEL.BACKBONE])
    clip.load_state_dict({k: v for k, v in weights.items()
                          if not k.startswith("head.")})
    state = {f"backbone.{k[len('visual.'):]}": v for k, v in weights.items()
             if k.startswith("visual.")}
    state.update({k: v for k, v in weights.items() if k.startswith("head.")})
    model.load_state_dict(state)
    del weights
    clip.eval()
    text_train, text_test = build_text_tables(cfg, clip)
    del clip
    return Learner(cfg, model, text_train, text_test, torch.device(device),
                   log_fn=lambda msg: None)


def episode(d: dict) -> Episode:
    return Episode(**d)
