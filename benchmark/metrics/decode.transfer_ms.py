"""decode.transfer_ms: mean CUDA-event milliseconds per decode call of the
staging upload and the pinned download (``stats["detail_device"]``
``upload_ms + download_ms``)."""


def read(run):
    if run.op_name != "decode":
        return None
    return run.mean_device_ms("upload_ms", "download_ms")
