"""setup_s: seconds from process start to the first timed call (inputs
made from the seed, CUDA context, kernels loaded from the checkout's
build cache, the decode cells' containers encoded, one warm-up call per
client)."""


def read(run):
    return run.setup_s
