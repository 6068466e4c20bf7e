"""The share (%) of the loop's wall time in which nothing ran on the
device: 100 (1 - busy / wall) a batch, busy from the device-only profile,
wall from an unprofiled stretch of the same run (the profiler slows the
host). Reads ``idle_share.<path>`` for every path."""


def read(ctx):
    busy_ms = ctx.trace["busy_s"] / ctx.trace["batches"] * 1e3
    return 100.0 * (1.0 - busy_ms / ctx.trace["untraced_wall_ms"])
