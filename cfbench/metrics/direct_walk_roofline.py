"""direct_walk_roofline: the fused direct-space walk (the kernels of
``ops/direct_walk``, names containing ``direct_walk``) against its least
time: per evaluation every in-cutoff pair of different molecules once,
counted at the last frame, and each atom's inputs and outputs
(``cfbench.work.walk``)."""
from cfbench import work
from cfbench.readers import roofline


def read(ctx):
    if "pairs" not in ctx.work:
        return None
    w = ctx.work
    return roofline(ctx, r"direct_walk", work.walk(w["pairs"], w["n_atoms"]))
