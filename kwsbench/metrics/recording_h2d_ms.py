"""Device ms of host-to-device copies per recording searched (the waveform's copy to the card)."""


def read(r):
    times = r.trace.copies("HtoD")
    n = r.counters.get("traced_units")
    return sum(times) / n if times and n else None
