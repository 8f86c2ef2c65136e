"""Device ms of rank 0's NCCL kernels (BN's float64 sums forward and back, the flat float64 gradient
all-reduce, the metrics' all-reduce) per step. A collective's kernel runs from its launch until every rank
has joined, so this holds the wait for the slowest rank as well as the transfer."""


def read(r):
    times = r.trace.kernels("nccl")
    n = r.counters.get("traced_units")
    return sum(times) / n if times and n else None
