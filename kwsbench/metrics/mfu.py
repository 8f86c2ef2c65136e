"""Model FLOPs of the window's work (a training step 3 x the forward's, an eval forward or a search's forwards
1 x, counted from the configuration's shapes by the cell's driver) over the window's seconds, as a share of the
cards' dense bf16 peak, in %. Every ``mfu.<what>`` reads this file."""

from kwsbench.reference.work import BF16_PEAK


def read(r):
    c = r.counters
    return 100.0 * c["model_flops"] / c["window_s"] / (BF16_PEAK * r.chips) if c["window_s"] > 0 else None
