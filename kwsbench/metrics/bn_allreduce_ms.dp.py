"""Device ms of rank 0's NCCL kernels that the port's ``bn_forward`` and ``bn_backward`` spans launched (BN's
float64 cross-rank sums, forward and back), per step. As in ``collective_ms.dp``, a collective's kernel runs
until every rank has joined, so this holds the wait for the slowest rank as well as the transfer."""


def read(r):
    n = r.counters.get("traced_units")
    times = [e - s for span in ("bn_forward", "bn_backward") for kind, name, s, e, _ in r.trace.in_span(span)
             if kind == "kernel" and "nccl" in name]
    return sum(times) * 1e-6 / n if n and times else None
