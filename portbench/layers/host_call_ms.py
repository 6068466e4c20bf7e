"""Host ms a batch inside the entry's call: the program's Python and its
launches, before the host waits on the device; the median over the
traced run's unprofiled stretch. Where it nears the batch's wall time,
the host holds the device back, and the host's speed moves the rate.
Reads ``host_call_ms.<path>`` for every path."""

import statistics


def read(ctx):
    calls = ctx.window["calls"]
    return statistics.median(calls) * 1e3 if calls else None
