"""Device ms a batch of the operations, PyTorch's and the program's, that
one stage of the program's entry launched, from the program's spans on a
profiled stretch (``portbench/stages.py::classify_stages``):
``span_device_ms.<top>.<stage>`` reads the stage ``<top>/<stage>``.
Nothing where the run placed no operation by stage (``ctx.stages``)."""


def read(ctx):
    stages = getattr(ctx, "stages", None)
    if not stages:
        return None
    _, top, stage = ctx.name.split(".", 2)
    rec = stages.get(f"{top}/{stage}")
    return None if rec is None else rec["device_ms"]
