"""The port's native WAV loader (``honk_tpu_torch.native.wavpack``) against the
Python reader and the JAX package's loader, on the CPU.

Mirrors ``tests/test_native.py``: the library builds with g++ (into the
package's build directory, keyed by its source), its int16 output equals
the pure-Python reader and ``honk_tpu.native.wavpack`` byte for byte, a
file that is not a WAV gives length -1 and zeros, and the corpus loader
uses it (and still decodes, with the Python reader, when it is off).
"""

import numpy as np
import pytest

from honk_tpu.native import wavpack as jwavpack
from honk_tpu_torch.data import load_speech_commands, generate_dataset, wavio
from honk_tpu_torch.native import wavpack


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate([16000, 8000, 20000, 1]):
        x = (rng.standard_normal(n) * 0.3).clip(-1, 1).astype(np.float32)
        p = str(d / f"t{i}.wav")
        wavio.write_wav(p, x)
        paths.append(p)
    return paths


def test_native_available():
    assert wavpack.available(), "the native loader should build with g++"
    lib = wavpack.library_path()
    assert lib.exists() and lib.parent == wavpack.BUILD_DIR and lib.name.startswith("libwavpack-")
    assert wavpack.SOURCE.parent.name == "csrc" and not list(wavpack.SOURCE.parent.glob("*.so"))


def test_native_matches_python_reader_and_jax(wav_dir):
    out, lengths = wavpack.load_files_packed(wav_dir, 16000)
    jout, jlengths = jwavpack.load_files_packed(wav_dir, 16000)
    assert np.array_equal(out, jout) and np.array_equal(lengths, jlengths)
    for i, p in enumerate(wav_dir):
        ref = wavio.read_wav_int16(p)
        assert lengths[i] == min(16000, len(ref))
        np.testing.assert_array_equal(out[i], np.pad(ref[:16000], (0, 16000 - min(16000, len(ref)))))


def test_no_native_env_falls_back_to_the_python_reader(wav_dir, monkeypatch):
    """``HONK_TPU_NO_NATIVE`` turns the library off, as in the JAX package: the loader returns None."""
    monkeypatch.setenv("HONK_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(wavpack, "_tried", False)
    monkeypatch.setattr(wavpack, "_lib", None)
    assert not wavpack.available()
    assert wavpack.load_files_packed(wav_dir, 16000) is None


def test_native_bad_file(tmp_path, wav_dir):
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"definitely not a wav file")
    out, lengths = wavpack.load_files_packed(wav_dir + [bad], 16000)
    assert lengths[-1] == -1
    assert (out[-1] == 0).all()


def test_dataset_load_uses_native(tmp_path, monkeypatch):
    root = str(tmp_path / "sc")
    generate_dataset(root, clips_per_word=4, n_speakers=2, noise_seconds=2)
    calls = []
    real = wavpack.load_files_packed
    monkeypatch.setattr(wavpack, "load_files_packed", lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    ds = load_speech_commands(root)
    total = len(ds.train) + len(ds.dev) + len(ds.test)
    assert total > 0 and calls and ds.train.audio.dtype == np.int16
    assert np.abs(ds.train.audio.astype(np.int32)).mean() > 10  # real signal, not fallback zeros
    # The Python reader alone (no native library) gives the same arrays.
    monkeypatch.setattr(wavpack, "load_files_packed", lambda *a, **k: None)
    py = load_speech_commands(root)
    for split in ("train", "dev", "test"):
        assert np.array_equal(getattr(ds, split).audio, getattr(py, split).audio)
        assert np.array_equal(getattr(ds, split).labels, getattr(py, split).labels)
