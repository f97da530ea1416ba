"""encode_GBps: raw bytes consumed by every encode call that completed in
the window, over the seconds from the window's start to its last
completion (host clock)."""


def read(run):
    return run.rate_GBps() if run.op_name == "encode" else None
