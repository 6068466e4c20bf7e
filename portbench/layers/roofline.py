"""The program's own kernels' share (%) of their roofline: the least time a
batch's work needs on the chip (``work/model.py``: operations at the
float32 peak or bytes at the HBM peak, whichever is longer) over the
kernels' device time a batch. Nothing without a bound or without kernel
time. Reads every ``<kernels>_roofline`` that has no reader of its own."""


def read(ctx):
    if ctx.bound is None or ctx.trace["port_ms"] <= 0:
        return None
    return 100.0 * ctx.bound["bound_ms"] / ctx.trace["port_ms"]
