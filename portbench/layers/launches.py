"""Device operations a batch, PyTorch's and the program's, launched inside
the program's top span of the entry, from its spans on the traced run's
labelling stretch (``devtrace.classify_stages``): ``launches.<top>``
reads the stage ``<top>``. Nothing where the run placed no operation by
stage."""


def read(ctx):
    if not ctx.stages:
        return None
    rec = ctx.stages.get(ctx.name.split(".", 1)[1])
    return None if rec is None else rec["launches"]
