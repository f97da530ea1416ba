"""decode.call_p95_ms: the 95th percentile of the wall (host clock) of
every decode call that completed in the window, all clients together."""


def read(run):
    if run.op_name != "decode":
        return None
    from benchmark.harness import percentile
    walls = [(c.t1 - c.t0) * 1e3 for c in run.calls()]
    return percentile(walls, 95) if len(walls) >= 20 else None
