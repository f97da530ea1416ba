"""encode.frontend_ms: mean host milliseconds per encode call of
``stats["frontend"]`` (``native.frontend_stage`` per source on host
threads, into the staging pool)."""


def read(run):
    if run.op_name != "encode":
        return None
    return run.mean_stat("frontend")
