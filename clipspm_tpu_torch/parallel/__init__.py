"""The rank grid: episode parallelism over the dp ranks
(``DEVICE.NUM_CHIPS``, ``mesh.py``) and Megatron tensor parallelism over the
tp ranks of each (``DEVICE.TP``, ``tensor.py``, imported on its own: it
imports the towers it shards)."""

from .mesh import (EpisodeMesh, episode_mean_, flat_buffers, init,
                   join_torchrun, rank_device, spawn, torchrun_env)

__all__ = ["EpisodeMesh", "episode_mean_", "flat_buffers", "init",
           "join_torchrun", "rank_device", "spawn", "torchrun_env"]
