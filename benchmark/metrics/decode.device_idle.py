"""decode.device_idle: the share of the traced sub-window in which no
kernel, copy or memset ran on the card, in %."""


def read(run):
    if run.op_name != "decode" or run.trace is None:
        return None
    from benchmark.roofline import idle_share
    return idle_share(run.trace)
