"""Device ms of what the port's ``train_step`` spans launched (kernels, copies, sets), per step."""


def read(r):
    n = r.trace.n_spans("train_step")
    acts = r.trace.in_span("train_step")
    return sum(e - s for _, _, s, e, _ in acts) * 1e-6 / n if n and acts else None
