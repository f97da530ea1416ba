"""decode.rebuild_ms: mean host milliseconds per decode call of
``stats["flatten"] + stats["rebuild"]`` (the parts' offsets and
``native.flatten_rebuild`` into the output bytes)."""


def read(run):
    if run.op_name != "decode":
        return None
    return run.mean_stat("flatten", "rebuild")
