"""Episode parallelism over ranks (``DEVICE.NUM_CHIPS``)."""

from .mesh import (EpisodeMesh, episode_mean_, flat_buffers, init,
                   join_torchrun, rank_device, spawn, torchrun_env)

__all__ = ["EpisodeMesh", "episode_mean_", "flat_buffers", "init",
           "join_torchrun", "rank_device", "spawn", "torchrun_env"]
