"""decode_GBps: raw bytes returned by every decode call of every client
that completed in the window, over the seconds from the window's start to
its last completion (host clock)."""


def read(run):
    return run.rate_GBps() if run.op_name == "decode" else None
