"""Device operations a batch, PyTorch's and the program's, launched inside
the program's top span of the entry (``portbench/stages.py::
classify_stages``): ``launches.<top>`` reads the stage ``<top>``. Nothing
where the run placed no operation by stage (``ctx.stages``)."""


def read(ctx):
    stages = getattr(ctx, "stages", None)
    if not stages:
        return None
    rec = stages.get(ctx.name.split(".", 1)[1])
    return None if rec is None else rec["launches"]
