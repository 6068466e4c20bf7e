"""Device ms a batch of PyTorch's kernels, copies and fills: the entry's
sort, prologue and epilogue around the program's own kernels. Reads
``torch_ops_ms.<path>`` for every path."""


def read(ctx):
    return ctx.trace["torch_ms"]
