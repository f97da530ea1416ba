"""decode.host_only_share: mean over the window's decode calls of the share
of the output, in %, that the card took no part in:
``stats["detail_parts"]`` ``host_only_bytes / raw_bytes``, the raw bytes of
the containers that the call's path decodes on the host alone (with the
native rebuild those with no FSE block, whose LZVN and RAW blocks are
decoded on host threads; with the device rebuild none that holds a block)
over those of every container the walk accepted. None from a program that
records no ``detail_parts``."""

import statistics


def read(run):
    if run.op_name != "decode":
        return None
    shares = []
    for c in run.calls():
        parts = c.stats.get("detail_parts")
        if parts is None:
            return None
        if parts["raw_bytes"]:
            shares.append(parts["host_only_bytes"] / parts["raw_bytes"])
    return statistics.fmean(shares) * 100 if shares else None
