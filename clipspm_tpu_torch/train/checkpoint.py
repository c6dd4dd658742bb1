"""Checkpoints: ``checkpoint_<tag>/`` directories written with ``torch.save``.

Port of ``clipspm_tpu/train/checkpoint.py`` with the same logical payload:
the model's ``state_dict`` (BatchNorm running statistics included), the
optimizer and schedule state, the episode count, the generator states, both
class-text tables, and ``meta`` ``{iteration, acc}``. The payload is one
file, ``checkpoint.pt``, inside the tag's directory; a save writes a
temporary file beside it and renames it over the old one, so an existing
directory is never deleted.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

PAYLOAD = "checkpoint.pt"


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"checkpoint_{tag}")

    def save(self, learner, tag: str, best_acc: float = 0.0) -> str:
        path = self._path(tag)
        os.makedirs(path, exist_ok=True)
        payload = learner.state_dict()
        payload["meta"] = {"iteration": int(learner.episode),
                           "acc": float(best_acc)}
        tmp = os.path.join(path, PAYLOAD + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, PAYLOAD))
        return path

    def restore(self, tag: str, learner) -> Dict[str, Any]:
        return self.restore_path(self._path(tag), learner)

    def restore_path(self, path: str, learner) -> Dict[str, Any]:
        """Load the checkpoint directory ``path`` into ``learner`` (the
        ``TEST.TEST_MODEL_PATH`` surface); returns the payload."""
        path = os.path.abspath(path)
        payload = torch.load(payload_file(path), map_location="cpu",
                             weights_only=True)
        try:
            learner.load_state_dict(payload)
        except (RuntimeError, KeyError, ValueError) as e:
            raise ValueError(
                f"checkpoint at {path} does not match the current model's "
                "parameter tree — it was likely saved by a different "
                "MODEL.NAME/BACKBONE. Point CHECKPOINT.CHECKPOINT_DIR at a "
                "matching checkpoint (or an empty directory to skip "
                "restore).") from e
        return payload

    def exists(self, tag: str) -> bool:
        return os.path.isfile(os.path.join(self._path(tag), PAYLOAD))


def payload_file(path: str) -> str:
    """The payload file of checkpoint directory ``path``; raises when
    ``path`` is a file or holds no payload."""
    if os.path.isfile(path):
        raise ValueError(
            f"checkpoint path {path} is a FILE — this framework saves "
            "checkpoint DIRECTORIES (checkpoint_<tag>/). A reference torch "
            ".pt head checkpoint is not loadable here (different parameter "
            "layout); pretrained CLIP backbone .pt weights load at build "
            "time instead.")
    f = os.path.join(path, PAYLOAD)
    if not os.path.isfile(f):
        raise FileNotFoundError(f"checkpoint directory {path} holds no "
                                f"{PAYLOAD}")
    return f
