"""Device kernels that the port's ``train_step`` spans launched, per step."""


def read(r):
    n = r.trace.n_spans("train_step")
    kernels = [a for a in r.trace.in_span("train_step") if a[0] == "kernel"]
    return len(kernels) / n if n and kernels else None
