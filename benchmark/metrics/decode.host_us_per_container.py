"""decode.host_us_per_container: mean over the window's decode calls of the
host stages' wall, ``stats["parse"] + stats["prep"] + stats["flatten"] +
stats["rebuild"]``, in microseconds, over the call's containers
(``stats["detail_parts"]["containers"]``): the per-container cost of the
walk, the front, the flatten plan, the output allocation and the native
rebuild (LZVN and RAW decode included). None from a program that records
no ``detail_parts``."""

import statistics

STAGES = ("parse", "prep", "flatten", "rebuild")


def read(run):
    if run.op_name != "decode":
        return None
    per = []
    for c in run.calls():
        parts = c.stats.get("detail_parts")
        if parts is None or any(k not in c.stats for k in STAGES):
            return None
        if parts["containers"]:
            per.append(sum(c.stats[k] for k in STAGES) * 1e6
                       / parts["containers"])
    return statistics.fmean(per) if per else None
