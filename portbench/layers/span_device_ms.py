"""Device ms a batch of the operations, PyTorch's and the program's, that
one stage of the program's entry launched, from its spans on the traced
run's labelling stretch (``devtrace.classify_stages``):
``span_device_ms.<top>.<stage>`` reads the stage ``<top>/<stage>``.
Nothing where the run placed no operation by stage."""


def read(ctx):
    if not ctx.stages:
        return None
    _, top, stage = ctx.name.split(".", 2)
    rec = ctx.stages.get(f"{top}/{stage}")
    return None if rec is None else rec["device_ms"]
