"""Share of the untraced window's wall in which ``Learner.evaluate``'s
loop waited on its staging thread (its own ``host_stall_seconds`` over its
``seconds``), in %. Layer: the evaluator."""


def read(run):
    res = run.window.get("result")
    if not res or not res.get("seconds"):
        return None
    return 100.0 * res["host_stall_seconds"] / res["seconds"]
