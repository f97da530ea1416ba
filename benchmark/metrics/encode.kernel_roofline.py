"""encode.kernel_roofline: the two FSE encode kernels' least time over
their profiler device time, in %. The work of one call is counted from its
output containers by the plain reference, as for decode with the
directions swapped: bytes read are a byte a literal and ``LMD_VALUE_BYTES``
an L, M or D value, bytes written the FSE blocks' coded bytes. Blocks the
kernels encode and the containers do not keep (period-split alternatives)
are not counted."""

KERNELS = ("literal_encode_kernel", "lmd_encode_kernel")


def read(run):
    if run.op_name != "encode" or run.trace is None:
        return None
    from benchmark.roofline import share
    w = run.work()
    return share(run.trace, KERNELS, w["coded_bytes"] + w["decoded_bytes"],
                 w["ops"])
