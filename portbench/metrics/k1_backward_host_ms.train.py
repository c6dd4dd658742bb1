"""Host milliseconds an episode in K1's backward (``_OtamDistance``'s
autograd node, which replays the plain OTAM under autograd in fp32): the
profiler's own events for it in the host trace, the engine's outermost one
where it records both. The host's profiler stretches them (a breakdown of
the traced step, not its untraced time). Layer: the kernel backwards."""

NODE = "_OtamDistanceBackward"


def read(run):
    outer = [(s, e) for n, s, e, _, _, _ in run.host.cpu
             if n.startswith("autograd::engine::evaluate_function")
             and n.endswith(NODE)]
    spans = outer or [(s, e) for n, s, e, _, _, _ in run.host.cpu
                      if n == NODE]
    if not spans or not run.host_episodes:
        return None
    return sum(e - s for s, e in spans) / 1e6 / run.host_episodes
