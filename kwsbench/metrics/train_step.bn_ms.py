"""Device ms of what the port's ``bn_forward`` and ``bn_backward`` spans launched (BN's float64 sums, the
normalisation, the input gradient, the running statistics), per step; kernels named ``nccl`` (BN's cross-rank
sums, ``bn_allreduce_ms.dp``) left out."""


def read(r):
    n = r.counters.get("traced_units")
    acts = [a for span in ("bn_forward", "bn_backward") for a in r.trace.in_span(span)
            if not (a[0] == "kernel" and "nccl" in a[1])]
    return sum(e - s for _, _, s, e, _ in acts) * 1e-6 / n if n and acts else None
