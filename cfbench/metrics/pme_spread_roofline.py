"""pme_spread_roofline: the SPME spread and its backward (the kernels of
``ops/pme_spread``, names containing ``spread``) against their least time:
per evaluation n atoms at spline order p onto a K^3 mesh and back
(``cfbench.work.spread``)."""
from cfbench import work
from cfbench.readers import roofline


def read(ctx):
    if "order" not in ctx.work:
        return None
    w = ctx.work
    return roofline(ctx, r"spread", work.spread(w["n_atoms"], w["order"],
                                                w["mesh"]))
