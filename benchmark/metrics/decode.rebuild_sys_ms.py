"""decode.rebuild_sys_ms: mean milliseconds per decode call of the calling
thread's system CPU in ``stats["flatten"] + stats["rebuild"]``
(``stats["detail_cpu"]``): first touches of the fresh output pages,
allocator calls into the kernel, thread starts. The calling thread's
share only: the other native workers are not counted, and the atomic work
queue hands out one container at a time, so the share is a sample of the
stage. None from a program that records no ``detail_cpu``."""


def read(run):
    from benchmark.thread_cpu import mean_ms
    return mean_ms(run, ("flatten", "rebuild"),
                   lambda wall, user, sys: sys)
