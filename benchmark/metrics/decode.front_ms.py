"""decode.front_ms: mean host milliseconds per decode call of the front,
``stats["parse"] + stats["prep"]`` (``native.walk_batch``, the table build
and payload gather into the staging buffer, the upload's enqueue)."""


def read(run):
    if run.op_name != "decode":
        return None
    return run.mean_stat("parse", "prep")
