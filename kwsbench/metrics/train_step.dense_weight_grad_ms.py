"""Device ms of what the port's ``dense_weight_grad`` spans launched (a Dense layer's weight and bias gradients:
the float64 casts of its cotangent and input, the float64 GEMM and the bias's float64 sum), per step."""


def read(r):
    n = r.counters.get("traced_units")
    acts = r.trace.in_span("dense_weight_grad")
    return sum(e - s for _, _, s, e, _ in acts) * 1e-6 / n if n and acts else None
