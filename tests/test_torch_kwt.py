"""The Keyword Transformer (``models/kwt.py``) against its plain reference (``tests/kwt_reference.py``), on the
CPU at a small size (d=32, 2 heads of 16, MLP 64, 2 blocks, B=3, 101 frames) on seeded random weights; KWT-3 at
its published size built, not run; its recipe (``train.state.AdamW``) and the training CLI.

Tolerances, each with its reason:
- float32 logits within the port's 2e-4 (the eval gates' absolute tolerance): the same arithmetic in
  another order;
- bf16 logits within BF16_GAP of the reference's RMS, largest gap: the bf16 model rounds each Dense's
  operands and output and the attention's output; measured 0.0071-0.0182 on seeds 0-5, where the
  reference rounded to bf16 at the same points reads 0.0059-0.0173 and rounded to int8 0.070-0.165, so
  the limit lies between them;
- float32 gradients and three float32 AdamW steps within float32 round-off of the reference's.
"""

import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from honk_tpu_torch.models import ConfigType, KeywordTransformer, find_config, find_model, init_weights, kwt
from honk_tpu_torch.models.layers import finish_grads, wide_grads
from honk_tpu_torch.train import AdamW, create_train_state, make_adamw, make_train_step, warmup_cosine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import kwt_reference as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = dict(find_config("kwt-3"), dim=32, heads=2, head_dim=16, mlp_dim=64, depth=2)
BF16_GAP = 0.04


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def weights(cfg: dict, seed: int) -> dict:
    """Seeded float32 parameters in the port's names: Dense weights uniform in +-1/sqrt(fan_in), LayerNorm
    gains 1 +- 0.1, biases, the class token and the positions uniform in +-0.1 (none 0, so every path is
    exercised)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for n, p in KeywordTransformer(cfg).named_parameters():
        u = torch.rand(p.shape, generator=g) * 2 - 1
        if n.endswith(("norm1.weight", "norm2.weight")):
            out[n] = 1 + 0.1 * u
        elif n.endswith("weight"):
            out[n] = u / math.sqrt(p.shape[1])
        else:
            out[n] = 0.1 * u
    return out


def port(cfg: dict, w: dict, dtype=None) -> KeywordTransformer:
    m = KeywordTransformer(cfg, dtype=dtype)
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(w[n])
    return m


def features(seed: int, b: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator().manual_seed(1000 + seed)
    return torch.randn((b, 101, 40), generator=g) * 3, torch.randint(0, 12, (b,), generator=g)


def test_float32_logits_match_the_reference():
    w, (x, _) = weights(SMALL, 0), features(0)
    with torch.no_grad(), R.no_tf32():
        torch.testing.assert_close(port(SMALL, w)(x), R.forward(w, SMALL, x), rtol=0, atol=2e-4)
        torch.testing.assert_close(port(SMALL, w).eval()(x), R.forward(w, SMALL, x), rtol=0, atol=2e-4)


@pytest.mark.parametrize("seed", range(3))
def test_bf16_logits_are_within_bf16s_gap_and_int8s_are_not(seed):
    w, (x, _) = weights(SMALL, seed), features(seed)
    with torch.no_grad(), R.no_tf32():
        ref = R.forward(w, SMALL, x)
        rms = ref.pow(2).mean().sqrt()
        gap = lambda logits: float((logits - ref).abs().max() / rms)  # noqa: E731
        got = port(SMALL, w, torch.bfloat16)(x)
        assert got.dtype == torch.float32
        assert gap(got) <= BF16_GAP
        assert gap(R.forward(w, SMALL, x, rounding=R.int8)) > BF16_GAP


def _port_grads(cfg, w, x, labels, dtype=None):
    """Every leaf's gradient as the update takes it (``finish_grads``), and the float64 sums kept."""
    model = port(cfg, w, dtype)
    with wide_grads() as wide:
        R.loss(model(x), labels, 0.1).backward()
    finish_grads(model, wide)
    return {n: p.grad.clone() for n, p in model.named_parameters()}, {n: wide[p] for n, p in model.named_parameters()
                                                                     if p in wide}


def _ref_grads(cfg, w, x, labels):
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    with R.no_tf32():
        grads = torch.autograd.grad(R.loss(R.forward(params, cfg, x), labels, 0.1), list(params.values()))
    return dict(zip(params, grads))


def test_every_leafs_gradient_matches_the_reference():
    """float32: every leaf within round-off, LayerNorm's, the class token's and the positions' gradients
    float64 sums; bf16: every leaf a float64 sum, each leaf's norm within BF16_GAP of the reference's."""
    w, (x, labels) = weights(SMALL, 1), features(1)
    ref = _ref_grads(SMALL, w, x, labels)
    got, wide = _port_grads(SMALL, w, x, labels)
    assert got.keys() == ref.keys()
    for n, g in ref.items():
        torch.testing.assert_close(got[n], g, rtol=1e-4, atol=1e-6 * float(g.abs().max()), msg=n)
    kept = {n for n in ref if "norm" in n} | {"class_token", "positions", "output.weight", "output.bias"}
    assert set(wide) == kept and all(v.dtype == torch.float64 for v in wide.values())
    got, wide = _port_grads(SMALL, w, x, labels, torch.bfloat16)
    assert set(wide) == set(ref)
    for n, g in ref.items():
        assert abs(float(got[n].norm() - g.norm())) <= BF16_GAP * float(g.norm()), n


def test_three_adamw_steps_with_warm_up_and_label_smoothing_match_the_reference():
    """``make_train_step``'s loss and update with KWT's recipe at 1 update an epoch (lr 1e-4, 2e-4, 3e-4),
    float32, on the features of three batches."""
    tx = make_adamw(steps_per_epoch=1, n_epochs=140)
    assert isinstance(tx, AdamW) and tx.label_smoothing == 0.1 and tx.weight_decay == 0.1
    w = weights(SMALL, 2)
    batches = [features(10 + k, 4) for k in range(3)]
    state = create_train_state(port(SMALL, w), tx)
    step = make_train_step(tx, 4, None)
    lrs = [tx.schedule(k) for k in range(3)]
    assert lrs == pytest.approx([1e-4, 2e-4, 3e-4], rel=1e-12)
    ref = R.adamw_steps(w, SMALL, batches, lrs)
    losses = []
    for k, (feats, labels) in enumerate(batches):
        state, m = step.apply_features(state, feats, labels)
        losses.append(float(m["loss"]))
        if k == 0:  # the first gradient, read back from the first moment as the benchmark's recipe reads it
            for n, p in state.model.named_parameters():
                g = ref["grads1"][n]
                torch.testing.assert_close(state.optimizer.state[p]["exp_avg"] / (1 - tx.betas[0]), g, rtol=1e-4,
                                           atol=1e-6 * float(g.abs().max()), msg=n)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    d = SMALL["heads"] * SMALL["head_dim"]
    for n, p in state.model.named_parameters():
        got, want = p.detach(), ref["params"][n]
        if n.endswith("qkv.bias"):
            # The keys' bias moves every score of a query alike, which softmax ignores: its gradient is 0 but
            # for round-off, and Adam's update of it the ratio of two round-offs, within the steps' lr apart.
            keys = slice(d, 2 * d)
            assert float((got[keys] - want[keys]).abs().max()) <= 2 * sum(lrs)
            got, want = torch.cat([got[:d], got[2 * d:]]), torch.cat([want[:d], want[2 * d:]])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6, msg=n)


def test_the_schedule_warms_up_from_update_0_and_decays_to_0():
    s = warmup_cosine(1e-3, 1010, 14140)
    assert s(0) == pytest.approx(1e-3 / 1010) and s(1009) == pytest.approx(1e-3) and s(1010) == pytest.approx(1e-3)
    assert s(7575) == pytest.approx(0.5e-3) and s(14139) < 1e-9 and s(14140) == 0.0
    assert make_adamw(101, 140).schedule(1009) == pytest.approx(1e-3)


def test_the_benchmarks_reference_names_the_ports_parameters_in_their_order():
    from kwsbench.reference import kwt as family

    cfg = json.loads((ROOT / "kwsbench/configs/kwt3.json").read_text())
    for c in (cfg, dict(cfg, **{k: SMALL[k] for k in ("dim", "heads", "head_dim", "mlp_dim", "depth")})):
        model = find_model(c["registry_name"])(c)
        assert list(family.param_shapes(c).items()) == [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def test_kwt3_at_its_published_size_has_the_papers_parameters_and_work():
    """Built, not run: 5.37M parameters; 2 x (the Dense layers' 542,236,416 multiply-adds and QK^T's and
    AV's 47,941,632 at 102 tokens) = 1,180,356,096 FLOPs a clip."""
    from kwsbench.reference import kwt as family

    cfg = json.loads((ROOT / "kwsbench/configs/kwt3.json").read_text())
    assert {k: cfg[k] for k in find_config("kwt-3") if k != "recipe"} == {
        k: v for k, v in find_config("kwt-3").items() if k != "recipe"}
    model = find_model("kwt-3")(find_config("kwt-3"))
    assert sum(p.numel() for p in model.parameters()) == 5_368_332
    dense = 101 * 40 * 192 + 12 * 102 * (192 * 576 + 192 * 192 + 2 * 192 * 768) + 192 * 12
    assert dense == 542_236_416
    assert family.model_flops(cfg) == 2 * (dense + 12 * 3 * 2 * 102 * 102 * 64) == 1_180_356_096
    assert ConfigType("kwt-3") is ConfigType.KWT3 and find_model("kwt-3") is KeywordTransformer


def test_attention_calls_read_24_a_step_of_12_blocks():
    cfg = dict(SMALL, depth=12)
    model = KeywordTransformer(cfg, dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    tx = make_adamw(1, 140)
    state, step = create_train_state(model, tx), make_train_step(tx, 2, None)
    feats, labels = features(0, 2)
    kwt.attention_calls = 0
    step.apply_features(state, feats, labels)
    assert kwt.attention_calls == 24
    with torch.no_grad():
        model.eval()(feats)
    assert kwt.attention_calls == 36


def test_init_weights_sets_layer_norm_gains_to_1():
    model = init_weights(KeywordTransformer(SMALL), torch.Generator().manual_seed(0))
    for i in range(SMALL["depth"]):
        for k in ("norm1", "norm2"):
            norm = getattr(model.blocks[i], k)
            assert torch.equal(norm.weight, torch.ones(32)) and torch.equal(norm.bias, torch.zeros(32))
    assert float(model.blocks[0].qkv.weight.detach().abs().max()) <= 1 / math.sqrt(32)
    assert not model.class_token.any() and not model.positions.any()


def test_cli_train_runs_two_steps_of_kwt3_with_its_recipe(tmp_path, capsys):
    """``cli.train --model kwt-3`` on a small synthetic corpus: one step an epoch (the batch holds the
    split and its silence), two epochs; the step checkpoint holds AdamW's moments."""
    from honk_tpu_torch.cli.train import main
    from honk_tpu_torch.data import generate_dataset, load_speech_commands

    corpus = str(tmp_path / "sc")
    generate_dataset(corpus, clips_per_word=2, n_speakers=2, noise_seconds=1)
    n = len(load_speech_commands(corpus).train)
    out_dir, metrics = tmp_path / "run", tmp_path / "m.jsonl"
    rc = main(["--type", "train", "--model", "kwt-3", "--data_dir", corpus, "--batch_size", str(n + int(0.1 * n)),
               "--n_epochs", "2", "--eval_batch_size", "64", "--device", "cpu", "--output_dir", str(out_dir),
               "--metrics_jsonl", str(metrics)])
    assert rc == 0 and "final test accuracy:" in capsys.readouterr().out
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    epochs = [r for r in recs if r["kind"] == "train_epoch"]
    assert [r["step"] for r in epochs] == [1, 2] and all(math.isfinite(r["loss"]) for r in epochs)
    assert sorted(os.listdir(out_dir)) == ["best.pt", "step_00000002.pt"]
    saved = torch.load(out_dir / "step_00000002.pt", weights_only=False)
    moments = saved["state"]["optimizer"]["state"]
    assert moments and all({"exp_avg", "exp_avg_sq"} <= set(s) for s in moments.values())
