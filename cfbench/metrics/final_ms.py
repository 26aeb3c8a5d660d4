"""final_ms: host milliseconds per trajectory call inside the program's
cf.md.final span (the eager neighbor rebuild and energy evaluation at
the end of each call, waits on the card included); from the host spans
of chargeflux_tpu_torch.utils.profiling.totals in the traced window.
None where the program keeps no such span."""
from chargeflux_tpu_torch.utils import profiling


def read(ctx):
    if not hasattr(profiling, "totals"):
        return None
    span = profiling.totals()["host"].get("cf.md.final")
    if not span or not span["count"]:
        return None
    return 1e3 * span["total_s"] / span["count"]
