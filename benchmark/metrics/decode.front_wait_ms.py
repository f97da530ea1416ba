"""decode.front_wait_ms: mean milliseconds per decode call that the
calling thread spent off a CPU in the front, ``stats["parse"] +
stats["prep"]`` less its user and system CPU there
(``stats["detail_cpu"]``): waiting for the interpreter lock, a core or a
page, and the join on the slowest worker of ``native.walk_batch``,
``build_tables3_batch`` and ``gather_payloads``. Under several clients
the join is short on many small containers, so what is left there is the
lock, the cores and blocking page faults. None from a program that
records no ``detail_cpu``."""


def read(run):
    from benchmark.thread_cpu import mean_ms
    return mean_ms(run, ("parse", "prep"),
                   lambda wall, user, sys: wall - user - sys)
