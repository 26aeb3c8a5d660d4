"""stage_ms.other: device milliseconds per replayed MD step of the chunk
graphs' replays that no stage covers (the Verlet updates, the autograd
glue between stages, the NaN guards and the chunk's copies): the
replays' device time between each graph's first and last node (the
stamps of the stage replay) less every stage's, from
chargeflux_tpu_torch.utils.profiling.totals. None where the program
keeps no such record, or where the record does not account for the
window's steps."""
from chargeflux_tpu_torch.utils import profiling


def read(ctx):
    if not hasattr(profiling, "stage_ms"):
        return None
    ms = profiling.stage_ms(profiling.totals(), ctx.steps)
    return None if ms is None else ms["other"]
