"""stage_ms.bonded: device milliseconds per replayed MD step inside the
program's cf_bonded stage (the water bonds and angles and their
backward), from the stage stamps the chunk graphs replay in the traced
window (chargeflux_tpu_torch.utils.profiling.totals, per step by its
stage_ms). None where the program keeps no such record, or where the
record does not account for the window's steps."""
from chargeflux_tpu_torch.utils import profiling


def read(ctx):
    if not hasattr(profiling, "stage_ms"):
        return None
    ms = profiling.stage_ms(profiling.totals(), ctx.steps)
    return None if ms is None else ms["bonded"]
