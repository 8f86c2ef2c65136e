"""The port's train-step ablation and corpus tools against the JAX package, on the CPU.

- ``cli.prof_train`` (``prof_train.py``): its ``fwdbwd`` link (forward,
  backward and SGD on the fixed features) and its ``full`` link (one train
  step: draws, assembly, MFCC, forward, backward, SGD) against one JAX step
  on the same weights (flax's, carried across), features and draws: for
  ``fwdbwd`` the JAX package's ``_fwdbwd`` body of ``prof_train.py``
  (``value_and_grad`` of the mean cross-entropy, the optax update), for
  ``full`` its ``make_train_step`` with the port's draws replaced by the
  JAX step's own (``fold_in(key, step)``). Float32 res8-narrow at B=4 and
  ``tests/test_torch_train.py``'s gates: the loss within 1e-5, the weights
  and running statistics after the step within atol 1e-5, rtol 1e-4.
  The tool's own dtype, bf16: the ``fwdbwd`` link's gradients and running
  statistics by ``tests/test_torch_bf16_train.py``'s ratio rule against
  JAX's op-by-op bf16 step (at most max(0.5, JAX's compiled step's own
  ratio) of JAX's bf16-to-float32 distance).
  The ``aug`` and ``frontend`` links: the assembled batch equals
  ``sample_train_batch`` of the same step generator, and the MFCC the
  frontend's.
- ``cli.make_corpus`` against ``scripts/make_corpus.py::main`` at tiny
  counts, hard (twice: default knobs, and the ngram word mode with the
  SNR, spread and jitter knobs) and easy: the same file tree byte for byte
  and the same printed JSON apart from the root (easy mode names clips
  with the salted ``hash()``, so both run in this one process).
"""

import filecmp
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from honk_tpu.data import augment as JA
from honk_tpu.frontend.mfcc import compute_mfccs as jcompute_mfccs
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.train import state as JS
from honk_tpu.train import steps as JT
from honk_tpu_torch.cli import make_corpus, prof_train
from honk_tpu_torch.data import augment as A
from honk_tpu_torch.models import SpeechResModel, find_config, from_flax_variables, load_state_dict
from test_torch_bf16_train import _assert_ratios, _jax_step, _ratios, _variables
from test_torch_bf16_train import _port as _bf16_port
from test_torch_train import _jax_draws

CONF = "res8-narrow"
B = 4
N_CLIPS = 16
LOSS_ATOL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
FRONTEND_ATOL = 2e-5
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flax_state():
    fmodel = jfind_model(CONF)(config=jfind_config(CONF), precision="highest")
    tx = JS.make_optimizer()
    return fmodel, tx, JS.create_train_state(fmodel, tx, jax.random.PRNGKey(0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(jstate):
    model = load_state_dict(SpeechResModel(find_config(CONF)),
                            from_flax_variables({"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)}))
    return prof_train.make_setup(CONF, torch.float32, B, CPU, n_clips=N_CLIPS, model=model)


def _held(s, loss, jloss, jstate):
    assert abs(float(loss) - float(jloss)) < LOSS_ATOL
    want = from_flax_variables({"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)})
    got = s["state"].model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **PARAM_TOL)
    assert s["state"].step == int(jstate.step) == 1


def test_prof_train_fwdbwd_link_is_one_jax_step_on_the_fixed_features():
    fmodel, tx, jstate = _flax_state()
    s = _setup(jstate)
    feats = jnp.asarray(s["fixed_feats"].numpy())
    labels = jnp.asarray(s["fixed_labels"].numpy())

    def loss_fn(params):  # prof_train.py's _fwdbwd body
        logits, mut = fmodel.apply({"params": params, "batch_stats": jstate.batch_stats}, feats, train=True,
                                   mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), mut["batch_stats"]

    (jloss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(jstate.params)
    updates, opt_state = tx.update(grads, jstate.opt_state, jstate.params)
    jstate = JS.TrainState(step=jstate.step + 1, params=optax.apply_updates(jstate.params, updates),
                           batch_stats=stats, opt_state=opt_state)
    kind, fn = prof_train.make_leg("fwdbwd", s)
    assert kind == "state"
    _held(s, fn(), jloss, jstate)


def test_prof_train_full_link_is_one_jax_train_step_on_the_same_draws(monkeypatch):
    fmodel, tx, jstate = _flax_state()
    s = _setup(jstate)
    rng = np.random.default_rng(0)  # the tool's corpus, drawn again in its order
    raw = rng.integers(-3000, 3000, (N_CLIPS, 16000), dtype=np.int16)
    noise = rng.standard_normal(16000 * 3).astype(np.float32) * 0.05
    labels = rng.integers(0, 12, (N_CLIPS,), dtype=np.int32)
    assert torch.equal(s["arrays"].labels, torch.from_numpy(labels).long())
    jaug = JA.AugmentConfig()
    jpool, jwin = JA.prepare_train_arrays(raw, noise, jaug, layout="xla")
    key = jax.random.PRNGKey(prof_train.KEY)
    k_sample, _ = jax.random.split(jax.random.fold_in(key, 0))
    draws = _jax_draws(k_sample, N_CLIPS, jaug, s["arrays"].n_noise, B)
    monkeypatch.setattr(A, "draw_batch", lambda *a, **k: draws)
    jstep = JT.make_train_step(fmodel, tx, B, jaug, donate=False)
    jstate, jm = jstep(jstate, key, jpool, jnp.asarray(labels), jwin)
    kind, fn = prof_train.make_leg("full", s)
    assert kind == "state"
    _held(s, fn(), jm["loss"], jstate)


def test_prof_train_bf16_fwdbwd_link_is_held_to_jax_by_the_ratio_rule():
    variables = _variables(CONF)
    s = prof_train.make_setup(CONF, torch.bfloat16, B, CPU, n_clips=N_CLIPS, model=_bf16_port(CONF, variables))
    feats, labels = s["fixed_feats"].numpy(), s["fixed_labels"].numpy()
    _, fn = prof_train.make_leg("fwdbwd", s)
    fn()
    model = s["state"].model
    port = {"grads": {k: p.grad.numpy() for k, p in model.named_parameters()},
            "stats": {k: v.numpy() for k, v in model.state_dict().items() if "running" in k}}
    jax_steps = [_jax_step(CONF, variables, feats, labels, dtype, mode)
                 for dtype, mode in ((jnp.bfloat16, "exact"), (jnp.bfloat16, "jit"), (None, "jit"))]
    _assert_ratios(_ratios(port, *jax_steps))


@pytest.mark.parametrize("leg", ["aug", "frontend"])
def test_prof_train_scalar_links_add_what_the_step_computes(leg):
    s = prof_train.make_setup(CONF, torch.float32, B, CPU, n_clips=N_CLIPS)
    kind, link = prof_train.make_leg(leg, s)
    assert kind == "scalar"
    acc = torch.tensor(0.0)  # each link adds ~1e-18: only from 0 is it representable
    if leg == "aug":
        audio, labels = A.sample_train_batch(A.step_generator(prof_train.KEY, 3, CPU), s["arrays"], B, s["aug"])
        assert audio.shape == (B, 16000) and float(audio.abs().max()) <= 1.0
        want = (audio.sum() * 1e-9 + labels.sum() * 1e-9) * 1e-12
    else:
        feats = s["fixed_feats"]
        np.testing.assert_allclose(feats.numpy(), np.asarray(jcompute_mfccs(jnp.asarray(s["fixed_audio"].numpy()))),
                                   atol=FRONTEND_ATOL, rtol=0)
        want = feats.sum() * 1e-9 * 1e-12
    assert float(want) != 0 and float(link(3, acc)) == pytest.approx(float(want), rel=1e-5, abs=0)


def _reference_make_corpus():
    spec = importlib.util.spec_from_file_location("reference_make_corpus", REPO / "scripts" / "make_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_tree(a: Path, b: Path) -> None:
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    _, mismatch, errors = filecmp.cmpfiles(a, b, [str(f) for f in files], shallow=False)
    assert not mismatch and not errors, mismatch + errors


def test_prof_train_setup_reads_the_corpus_size_when_called(monkeypatch):
    monkeypatch.setattr(prof_train, "N_CLIPS", N_CLIPS)
    s = prof_train.make_setup(CONF, torch.float32, B, CPU)
    assert s["arrays"].n_clips == N_CLIPS
    assert prof_train.make_setup(CONF, torch.float32, B, CPU, n_clips=8)["arrays"].n_clips == 8


@pytest.mark.parametrize("flags", [
    ["--hard"],
    ["--hard", "--word_mode", "ngram", "--snr_db", "0", "12", "--speaker_spread", "0.2", "--formant_jitter", "0.04",
     "--seed", "3"],
    ["--speaker_spread", "0.2"],  # easy mode drops the hard-mode knobs, as the reference does
], ids=["hard", "hard-knobs", "easy"])
def test_make_corpus_writes_the_reference_corpus(flags, tmp_path, capsys):
    tiny = ["--clips_per_word", "2", "--n_speakers", "2"]
    assert _reference_make_corpus().main([str(tmp_path / "ref"), *tiny, *flags]) == 0
    want = json.loads(capsys.readouterr().out)
    assert make_corpus.main([str(tmp_path / "port"), *tiny, *flags, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    _same_tree(tmp_path / "port", tmp_path / "ref")
    if "--hard" not in flags:
        assert got.pop("root") == str(tmp_path / "port") and want.pop("root") == str(tmp_path / "ref")
        assert list(got) == ["generator", "seed", "clips_per_word", "n_speakers"]
    assert got == want
    assert os.path.isfile(tmp_path / "port" / "CORPUS.json")
