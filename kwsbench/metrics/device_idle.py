"""Share of the untraced window in which the card or cards did no work, in %: one less the device seconds a unit of
work in the traced slice (kernels other than the collectives, copies, sets; the mean over the cards) times
the window's units, over the window's seconds. The traced slice's own idle share (``device.busy_s`` over
``device.window_s``) carries the profiler's cost on the host, and a collective's kernel runs while it waits
for the other ranks."""


def read(r):
    c = r.counters
    if not c.get("work_s") or not c.get("traced_units") or not c.get("window_s"):
        return None
    return 100.0 * (1.0 - c["work_s"] / c["traced_units"] * c["units"] / c["window_s"])
