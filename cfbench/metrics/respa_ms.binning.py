"""respa_ms.binning: device milliseconds per replayed r-RESPA outer step
inside the slow tier's cf_binning stage (blockify on the chunk's reused
neighbor state), forward and backward, from the stage stamps the chunk
graphs replay in the traced window
(chargeflux_tpu_torch.utils.profiling.totals, per outer step by its
respa_ms). None where the program keeps no such record, or where the
record does not account for the window's outer steps."""
from chargeflux_tpu_torch.utils import profiling


def read(ctx):
    if not hasattr(profiling, "respa_ms"):
        return None
    ms = profiling.respa_ms(profiling.totals(), ctx.steps)
    return None if ms is None else ms["binning"]
