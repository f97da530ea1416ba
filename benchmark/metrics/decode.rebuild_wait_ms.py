"""decode.rebuild_wait_ms: mean milliseconds per decode call that the
calling thread spent off a CPU in ``stats["flatten"] + stats["rebuild"]``,
their wall less its user and system CPU there (``stats["detail_cpu"]``):
the join on ``native.flatten_rebuild``'s slowest worker (a straggler
container holds it), then the interpreter lock, the cores and blocking
page faults. None from a program that records no ``detail_cpu``."""


def read(run):
    from benchmark.thread_cpu import mean_ms
    return mean_ms(run, ("flatten", "rebuild"),
                   lambda wall, user, sys: wall - user - sys)
