"""The readers of a transformer's spans (``kwsbench/metrics/train_step.{attention,layer_norm,dense_weight_grad}_ms``),
fed a hand-made trace of attention, LayerNorm and Dense weight-gradient spans with kernels inside and outside
them, and a trace without the spans (a program that lacks them), where each reader finds nothing and returns
None."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the checkout on the path)
from test_kwsbench_span_readers import Events, read

LAYERS = ("train_step.attention_ms", "train_step.layer_norm_ms", "train_step.dense_weight_grad_ms")


def kwt_trace():
    """Two steps of a transformer's: attention forward and backward, LayerNorm forward and backward (with a
    float64 sum), a Dense's weight gradient (a cast and a GEMM), and kernels outside every span besides."""
    ev = Events()
    for base in (0, 1000):
        ev.span("train_step", base, base + 900)
        ev.span("attention", base + 10, base + 40).device("flash_fwd_kernel", base + 11, base + 100, 20)
        ev.span("layer_norm", base + 50, base + 60).device("layer_norm_kernel", base + 51, base + 130, 4)
        ev.device("gemm_bf16", base + 70, base + 140, 30)  # the next Dense's forward, in no layer's span
        ev.span("layer_norm", base + 300, base + 340).device("layer_norm_backward", base + 301, base + 400, 6)
        ev.device("reduce_f64", base + 310, base + 410, 2)
        ev.span("dense_weight_grad", base + 350, base + 380).device("copy_f64", base + 351, base + 420, 3)
        ev.device("gemm_f64", base + 360, base + 430, 50)
        ev.span("attention", base + 500, base + 560).device("flash_bwd_kernel", base + 501, base + 600, 40)
        ev.device("outside_kernel", base + 700, base + 800, 100)
    return ev


def test_the_transformers_layers_read_what_their_spans_launched_per_step():
    reading = kwt_trace().reading()
    assert read("train_step.attention_ms", reading) == pytest.approx((20 + 40) * 1e-3)
    assert read("train_step.layer_norm_ms", reading) == pytest.approx((4 + 6 + 2) * 1e-3)
    assert read("train_step.dense_weight_grad_ms", reading) == pytest.approx((3 + 50) * 1e-3)
    assert sum(read(m, reading) for m in LAYERS) < read("train_step.device_ms", reading)
    assert read("train_step.weight_grad_ms", reading) is None and read("train_step.bn_ms", reading) is None


@pytest.mark.parametrize("metric", LAYERS)
def test_a_transformer_reader_finds_nothing_where_the_program_has_no_span(metric):
    ev = Events().span("train_step", 0, 1000).span("bn_forward", 10, 40).span("conv_weight_grad", 50, 90)
    ev.device("kernel", 11, 20, 50).device("gemm", 51, 80, 5)
    assert read(metric, ev.reading()) is None
    assert read(metric, Events().reading()) is None
