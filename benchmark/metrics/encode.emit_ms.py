"""encode.emit_ms: mean host milliseconds per encode call of the device
emission, ``stats`` ``emit_prep + emit_dispatch + emit_kernels + pack``
(the upload, the E tables and both encode kernels, the wait for them, and
``native.pack_stage``)."""


def read(run):
    if run.op_name != "encode":
        return None
    return run.mean_stat("emit_prep", "emit_dispatch", "emit_kernels", "pack")
