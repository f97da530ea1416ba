"""decode.kernel_roofline: the two FSE decode kernels' least time over
their profiler device time, in %. The least time of one call is the larger
of its bytes over the memory rate and its operations over the 32-bit
operation rate (``benchmark/peaks.json``); its work is counted from the
containers by the plain reference: bytes read are the FSE blocks' coded
bytes (headers, weights, payloads), bytes written a byte a literal and
``LMD_VALUE_BYTES`` a decoded L, M or D value, and ``OPS_PER_SYMBOL`` an
operation a coded symbol."""

KERNELS = ("literal_kernel", "lmd_kernel")


def read(run):
    if run.op_name != "decode" or run.trace is None:
        return None
    from benchmark.roofline import share
    w = run.work()
    return share(run.trace, KERNELS, w["coded_bytes"] + w["decoded_bytes"],
                 w["ops"])
