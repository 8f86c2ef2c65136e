"""Host ms per batch covered by the port's eval path: the union of its ``eval_gather``, ``mfcc`` and
``eval_forward`` ranges in the traced slice. The rest of a batch's host time is the caller's loop. Read
under the profiler, so it holds the profiler's own cost per op."""

SPANS = ("eval_gather", "mfcc", "eval_forward")


def read(r):
    n = r.counters.get("traced_units")
    ranges = sorted(x for span in SPANS for x in r.trace.spans.get(span, []))
    if not n or not ranges:
        return None
    covered, (start, end) = 0, ranges[0]
    for s, e in ranges[1:]:
        if s > end:
            covered, start = covered + end - start, s
        end = max(end, e)
    return (covered + end - start) * 1e-6 / n
