"""The readers of the port's spans (``kwsbench/metrics/``), each fed a hand-made trace: kernels launched inside
and outside its spans, an ``nccl`` kernel inside a BN span, and a trace without the span (a program that lacks
it), where the reader finds nothing and returns None."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the checkout on the path)

from kwsbench import common, harness
from kwsbench.tracing import Trace


class Events:
    """A Chrome trace's events, times in us: spans, and device activities each with the launch that made it."""

    def __init__(self):
        self.events, self.corr = [], 0

    def span(self, name, start, end):
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": start, "dur": end - start})
        return self

    def device(self, name, launched, start, dur, kind="kernel"):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launched,
                            "dur": 1, "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": kind, "name": name, "ts": start, "dur": dur,
                            "args": {"correlation": self.corr}})
        return self

    def reading(self, units=2):
        return common.Reading(Trace(self.events, 1.0), {"traced_units": units}, {}, {}, "cpu", 1)


def read(metric, reading):
    return harness.reader(metric).read(reading)


def train_trace():
    """Two steps: in each a weight gradient (two kernels), BN forward (a sum and an nccl all-reduce) and BN
    backward (a copy and an nccl all-reduce); kernels outside every span besides."""
    ev = Events()
    for base in (0, 1000):
        ev.span("train_step", base, base + 900)
        ev.span("bn_forward", base + 10, base + 50).device("reduce_kernel", base + 11, base + 100, 30)
        ev.device("ncclDevKernel_AllReduce_Sum_f64", base + 20, base + 130, 7)
        ev.span("conv_weight_grad", base + 200, base + 260).device("im2col", base + 201, base + 300, 40)
        ev.device("sm80_xmma_gemm_f32f32", base + 210, base + 340, 60)
        ev.span("bn_backward", base + 400, base + 450).device("copy", base + 401, base + 500, 5, "gpu_memcpy")
        ev.device("ncclDevKernel_AllReduce_Sum_f64", base + 420, base + 510, 3)
        ev.device("outside_kernel", base + 600, base + 700, 100)  # in train_step, in no layer's span
        ev.device("ncclDevKernel_AllReduce_Sum_f64", base + 610, base + 800, 50)  # the gradients' all-reduce
    return ev


def test_the_weight_gradient_reads_what_its_spans_launched_per_step():
    assert read("train_step.weight_grad_ms", train_trace().reading()) == pytest.approx((40 + 60) * 1e-3)


def test_bn_reads_its_spans_without_their_collectives_and_the_all_reduce_reads_them_alone():
    reading = train_trace().reading()
    assert read("train_step.bn_ms", reading) == pytest.approx((30 + 5) * 1e-3)
    assert read("bn_allreduce_ms.dp", reading) == pytest.approx((7 + 3) * 1e-3)
    # Both layers and what lies outside them stay within the step's device time.
    whole = read("train_step.device_ms", reading)
    assert read("train_step.weight_grad_ms", reading) + read("train_step.bn_ms", reading) < whole
    assert read("bn_allreduce_ms.dp", reading) < read("collective_ms.dp", reading)


def test_bn_without_collectives_reads_no_all_reduce():
    ev = Events().span("bn_forward", 0, 50).device("reduce_kernel", 1, 100, 30)
    assert read("train_step.bn_ms", ev.reading(1)) == pytest.approx(0.03)
    assert read("bn_allreduce_ms.dp", ev.reading(1)) is None


def test_the_eval_path_reads_the_union_of_its_host_ranges_per_batch():
    ev = Events()
    for base in (0, 1000):  # the forward's range overlaps the MFCC's; the loop's own time lies between
        ev.span("eval_gather", base, base + 100).span("mfcc", base + 150, base + 300)
        ev.span("eval_forward", base + 250, base + 500).span("eval_batch", base, base + 900)
    assert read("score.host_ms", ev.reading()) == pytest.approx((100 + 350) * 1e-3)
    one = Events().span("mfcc", 10, 30)  # a program with the MFCC's span alone
    assert read("score.host_ms", one.reading(1)) == pytest.approx(0.02)


def test_the_search_reads_its_forward_on_the_device_and_its_copy_and_detection_on_the_host():
    ev = Events()
    for base in (0, 10_000):
        ev.span("stream_copy", base, base + 800).device("Memcpy HtoD (Pageable -> Device)", base + 5, base + 10,
                                                        400, "gpu_memcpy")
        ev.device("mfcc_kernel", base + 900, base + 950, 60)
        ev.span("stream_forward", base + 1000, base + 3000).device("conv", base + 1100, base + 1200, 2000)
        ev.span("eval_forward", base + 1050, base + 2900).device("softmax", base + 2950, base + 3300, 10)
        ev.span("stream_detect", base + 5000, base + 5300)
    reading = ev.reading()
    assert read("search.forward_ms", reading) == pytest.approx(2.01)
    assert read("search.copy_host_ms", reading) == pytest.approx(0.8)
    assert read("search.detect_host_ms", reading) == pytest.approx(0.3)
    assert read("search.forward_ms", reading) < reading.trace.busy_s() * 1e3 / 2


@pytest.mark.parametrize("metric", ["train_step.weight_grad_ms", "train_step.bn_ms", "bn_allreduce_ms.dp",
                                    "score.host_ms", "search.forward_ms", "search.copy_host_ms",
                                    "search.detect_host_ms"])
def test_a_reader_finds_nothing_where_the_program_has_no_span(metric):
    ev = Events().span("train_step", 0, 1000).span("eval_batch", 0, 1000)
    ev.device("kernel", 10, 20, 50).device("ncclDevKernel_AllReduce_Sum_f64", 30, 80, 5)
    assert read(metric, ev.reading()) is None
    assert read(metric, Events().reading()) is None
