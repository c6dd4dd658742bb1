"""Kernel K1's share of its roofline, in %: the least time of each fused
launch on the card (``flops.otam_fused_bound_ms``) over K1's device time
in the host trace (the kernel's own time, which the host's profiler does
not stretch). A launch's shapes are its ``_OtamDistance`` op's inputs
``[S, L, D]`` and ``[Q, L, D]`` where the trace recorded them; otherwise
those the clipspm head makes each episode (class and task distances of
the ``way`` prototypes against the queries, and of the ``way`` task
tokens against one: ``L`` the frames, ``D`` the tower's width), read only
when the trace holds three launches an episode. Layer: kernels."""

from portbench import flops

KERNEL = "otam_fused_kernel"


def _episode_launches(run):
    way, q = run.traffic["way"], run.traffic["queries"]
    L = int(run.config["port_config"]["DATA"]["SEQ_LEN"])
    D = run.config["published"]["embed_dim"]
    return [(way, L, D, way * q), (way, L, D, way * q), (way, L, D, 1)]


def read(run):
    kernels = [(s, e) for n, s, e, _ in run.host.device if KERNEL in n]
    calls = [shapes for n, _, _, _, _, shapes in run.host.cpu
             if n == "_OtamDistance"]
    if not kernels or len(calls) != len(kernels):
        return None
    if all(len(c) >= 2 and len(c[0]) == 3 and len(c[1]) == 3
           for c in calls):
        launches = [(c[0][0], c[0][1], c[0][2], c[1][0]) for c in calls]
    elif len(kernels) == 3 * run.host_episodes:
        launches = _episode_launches(run) * run.host_episodes
    else:
        return None
    bound = sum(flops.otam_fused_bound_ms(Q, S, L, D)
                for S, L, D, Q in launches)
    device_ms = sum(e - s for s, e in kernels) / 1e6
    return 100.0 * bound / device_ms
