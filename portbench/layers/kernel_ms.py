"""Device ms a batch of the program's own kernels: every device kernel that
PyTorch did not launch (``devtrace.reduce_device``). Reads
``kernel_ms.<path>`` for every path."""


def read(ctx):
    return ctx.trace["port_ms"]
