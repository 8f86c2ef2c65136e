"""Port's MFCC frontend (honk_tpu_torch) against the JAX package, on the CPU.

On CPU tensors the MFCC kernel's wrapper runs its plain PyTorch version, so
these tests hold that version (the kernel's arithmetic) against
``honk_tpu.frontend.compute_mfccs``, against the TPU kernel run in
interpret mode, and against the float64 golden. The CUDA kernel itself is
held against the same plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from honk_tpu import frontend as jfe
from honk_tpu.frontend import filters as jfilters
from honk_tpu.ops import compute_mfccs_pallas
from honk_tpu_torch import frontend as tfe
from honk_tpu_torch.frontend import filters as tfilters
from honk_tpu_torch.ops import mfcc_kernel

# Port (f32, PyTorch CPU matmuls) against JAX (f32, XLA:CPU or Pallas
# interpret): the same f32 algorithm summed in another order. This is the
# reference's own gate between its Pallas kernel and its XLA frontend.
F32_TOL = dict(atol=2e-5, rtol=1e-5)
# Against the float64 golden: the reference's golden gate.
GOLDEN_TOL = dict(atol=5e-3, rtol=1e-3)


def _audio(batch, seed=0, scale=0.2):
    return (np.random.default_rng(seed).standard_normal((batch, 16000)) * scale).astype(np.float32)


def _port(audio):
    return tfe.compute_mfccs(torch.from_numpy(audio)).numpy()


def test_constants_equal_reference():
    ref = jfilters.frontend_constants(np.float32)
    got = tfilters.frontend_constants(np.float32)
    assert ref.keys() == got.keys()
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    dev = tfe.mfcc.constants(torch.device("cpu"))
    for k in ref:
        assert dev[k].is_contiguous()
        np.testing.assert_array_equal(dev[k].numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("batch", [1, 3])
def test_mfcc_matches_jax_frontend(batch):
    audio = _audio(batch, seed=batch)
    got = _port(audio)
    ref = np.asarray(jfe.compute_mfccs_jit(audio))
    assert got.shape == ref.shape == (batch, 101, 40)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **F32_TOL)


@pytest.mark.parametrize("batch", [1, 3])
def test_mfcc_matches_tpu_kernel_interpret(batch):
    audio = _audio(batch, seed=10 + batch)
    got = _port(audio)
    ref = np.asarray(compute_mfccs_pallas(audio, interpret=True))
    np.testing.assert_allclose(got, ref, **F32_TOL)


@pytest.mark.parametrize("batch", [1, 3])
def test_mfcc_matches_golden(batch):
    audio = _audio(batch, seed=20 + batch, scale=0.1)
    got = _port(audio)
    for i in range(batch):
        golden = jfe.compute_mfccs_reference(audio[i].astype(np.float64))
        np.testing.assert_allclose(got[i], golden, **GOLDEN_TOL)
        # The port's copy of the golden is the reference's golden.
        np.testing.assert_array_equal(tfe.compute_mfccs_reference(audio[i].astype(np.float64)), golden)


def test_mfcc_silence_is_exactly_zero():
    out = _port(np.zeros((2, 16000), np.float32))
    assert np.all(out == 0.0)


def test_frame_audio_matches_reference_framing():
    audio = _audio(2, seed=5)
    got = tfe.frame_audio(torch.from_numpy(audio)).numpy()
    ref = np.asarray(jfe.mfcc.frame_audio(audio))
    assert got.shape == (2, 101, 480)
    np.testing.assert_array_equal(got, ref)


def test_mfcc_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        tfe.compute_mfccs(torch.zeros(16000))
    with pytest.raises(ValueError):
        tfe.compute_mfccs(torch.zeros((1, 16000), dtype=torch.int16))
    with pytest.raises(ValueError):
        mfcc_kernel.mfcc(torch.zeros((0, 16000)))
    with pytest.raises(ValueError):
        mfcc_kernel.mfcc(torch.zeros((2, 16000))[:, ::2])  # not contiguous


def test_mfcc_wrapper_only_takes_plain_path_on_cpu():
    # A tensor that is neither CPU nor CUDA is refused, not run by the plain path.
    with pytest.raises(ValueError, match="cuda or cpu"):
        mfcc_kernel.mfcc(torch.zeros((1, 16000), device="meta"))
    before = mfcc_kernel.launches
    _port(_audio(1))
    assert mfcc_kernel.launches == before  # the plain path is not a kernel launch
