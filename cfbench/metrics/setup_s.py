"""setup_s: seconds from the process's start to the window's (imports,
the system, inputs, warm start, graph captures)."""


def read(ctx):
    return ctx.setup_s
