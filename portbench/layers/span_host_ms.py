"""Host self ms a batch of one stage of the program's entry, from the
program's own spans (``bvh_tpu_torch.obs``) over the traced run's
spans-on unprofiled stretch: ``span_host_ms.<top>.<stage>`` reads the
span ``<top>/<stage>`` (``span_host_ms.trace.sort``: ``trace/sort``).
Nothing where the run kept no spans."""


def read(ctx):
    if not ctx.spans:
        return None
    _, top, stage = ctx.name.split(".", 2)
    rec = ctx.spans.get(f"{top}/{stage}")
    return None if rec is None else rec["self_ms"]
