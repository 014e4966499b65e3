"""setup_s: from the process's start to the window's first request: the
CUDA context, the weights made on the device, quantisation, the kernels
loaded (built in a checkout's first run) and the cell's warm-up."""

UNIT = "s"


def read(rec):
    return rec.setup_s
