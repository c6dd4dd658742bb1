"""Device milliseconds an episode of the kernels launched under the
benchmark's ``portbench.tower`` span (every forward of the model's vision
tower), from the host trace (the kernels' own times, which the host's
profiler does not stretch). Layer: transform + encode."""

from portbench.trace import TOWER


def read(run):
    events = run.host.device_under(TOWER)
    if not events or not run.host_episodes:
        return None
    return sum(e - s for _, s, e, _ in events) / 1e6 / run.host_episodes
