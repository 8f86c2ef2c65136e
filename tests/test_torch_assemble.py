"""Port's batch assembly (kernel module and sampler) against the JAX package, on the CPU.

On CPU tensors the assembly wrapper runs its plain version (indexing, a
multiply, a multiply, an add, a clamp); ``chip_smoke.py`` holds the CUDA
kernel against that version on the card, bit for bit. Here:

- the plain version against the TPU kernel itself,
  ``honk_tpu.ops.assemble_kernel._assemble_call(..., interpret=True)``, fed
  the same five scalar arrays (made with numpy from a seed);
- the port's sampler, fed the JAX package's own draws (reproduced from its
  key as ``tests/test_assemble_kernel.py`` does: threefry cannot be
  reproduced in torch), against ``sample_train_batch`` (exact shifts) and
  ``sample_train_batch_pallas`` (the TPU's sub-row layout).

Tolerance: atol 1e-6 on the audio, the reference's own gate
(``tests/test_assemble_kernel.py``); labels, packed arrays and offsets equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honk_tpu.data import augment as JA
from honk_tpu.ops import assemble_kernel as JK
from honk_tpu_torch.data import augment as A
from honk_tpu_torch.ops import assemble_kernel as K

ATOL = 1e-6  # tests/test_assemble_kernel.py:66


def _corpus(seed, n, noise_len=16000 * 4):
    rng = np.random.default_rng(seed)
    raw = rng.integers(-20000, 20000, (n, 16000), dtype=np.int16)
    labels = rng.integers(2, 12, (n,), dtype=np.int32)
    noise = (rng.standard_normal(noise_len) * 0.05).astype(np.float32)
    return raw, labels, noise


def _jax_draws(key, n, cfg, max_shift, n_noise, batch):
    """The draws of sample_train_batch / sample_train_batch_pallas, from their key."""
    k_idx, k_shift, k_off, k_noise, k_scale = jax.random.split(key, 5)

    def t(a):
        return torch.from_numpy(np.array(a))

    return A.Draws(
        idx=t(jax.random.randint(k_idx, (batch,), 0, n + cfg.n_silence)).long(),
        shift=t(jax.random.randint(k_shift, (batch,), -max_shift, max_shift + 1, jnp.int32)).long(),
        noise_row=t(jax.random.randint(k_off, (batch,), 0, n_noise, jnp.int32)).long(),
        add_u=t(jax.random.uniform(k_noise, (batch,))),
        scale_u=t(jax.random.uniform(k_scale, (batch,))),
    )


@pytest.mark.parametrize("timeshift", [1600, 640])
def test_packers_equal_reference(timeshift):
    raw, _, noise = _corpus(0, 5)
    assert K._geometry(timeshift) == JK._geometry(timeshift)
    np.testing.assert_array_equal(K.pack_pool_subrows(raw, timeshift).numpy(),
                                  np.asarray(JK.pack_pool_subrows(raw, timeshift)))
    for flat in (noise, noise[:3000]):  # long enough, and tiled
        np.testing.assert_array_equal(K.pack_noise_subrows(flat).numpy(),
                                      np.asarray(JK.pack_noise_subrows(flat)))


@pytest.mark.parametrize("timeshift", [1600, 640])
def test_assemble_plain_matches_pallas_call(timeshift):
    """The five scalars of the TPU kernel, made with numpy, through both."""
    raw, _, noise = _corpus(1, 12)
    batch = 16
    pool_j = JK.pack_pool_subrows(raw, timeshift)
    noise_j = JK.pack_noise_subrows(noise)
    pad_sub, row_subs, q_max = JK._geometry(timeshift)
    rng = np.random.default_rng(timeshift)
    clip = rng.integers(0, 12, batch)
    s = pad_sub - rng.integers(-q_max, q_max + 1, batch)
    s0 = (s // 8) * 8
    base8 = ((clip * row_subs + s0) // 8).astype(np.int32)
    fine = (s - s0).astype(np.int32)
    silence = rng.random(batch) < 0.25
    gain = np.where(silence, 0.0, 1.0 / 32768.0).astype(np.float32)
    nsub8 = rng.integers(0, (noise_j.shape[0] - JK.CP) // 8 + 1, batch).astype(np.int32)
    nscale = (rng.random(batch) * 0.1 * (rng.random(batch) < 0.8)).astype(np.float32)
    nscale[silence] = 0.07

    want = np.asarray(JK._assemble_call(
        jnp.asarray(base8), jnp.asarray(fine), jnp.asarray(gain), jnp.asarray(nsub8),
        jnp.asarray(nscale), pool_j, noise_j, blk=4, interpret=True,
    )).reshape(batch, 16000)

    # The TPU kernel's scalars as start offsets in samples.
    clip_start = (torch.from_numpy(base8).long() * 8 + torch.from_numpy(fine).long()) * 128
    noise_start = torch.from_numpy(nsub8).long() * 8 * 128
    before = K.launches
    got = K.assemble(
        K.pack_pool_subrows(raw, timeshift).reshape(-1), K.pack_noise_subrows(noise).reshape(-1),
        clip_start, noise_start, torch.from_numpy(gain), torch.from_numpy(nscale),
    )
    assert K.launches == before  # CPU tensors: the plain version, no kernel launch
    assert got.shape == (batch, 16000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert (got.abs() <= 1.0).all()


@pytest.mark.parametrize("timeshift", [1600, 640])
def test_subrow_sampler_matches_pallas_sampler(timeshift):
    raw, labels, noise = _corpus(2, 12)
    batch = 16
    cfg = JA.AugmentConfig(timeshift_samples=timeshift, n_silence=3)
    pool_j, noise_j = JK.pack_pool_subrows(raw, timeshift), JK.pack_noise_subrows(noise)
    key = jax.random.PRNGKey(7)
    want, want_lab = JK.sample_train_batch_pallas(key, pool_j, jnp.asarray(labels), noise_j, batch, cfg,
                                                  interpret=True)

    pcfg = A.AugmentConfig(timeshift_samples=timeshift, n_silence=3)
    arrays = A.prepare_train_arrays(raw, labels, noise, pcfg, layout="subrow")
    assert arrays.max_shift == JK._geometry(timeshift)[2]
    draws = _jax_draws(key, 12, cfg, arrays.max_shift, arrays.n_noise, batch)
    got, lab = A.assemble_batch(draws, arrays, pcfg)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("timeshift,seed", [(1600, 3), (640, 4), (0, 5)])
def test_exact_sampler_matches_sample_train_batch(timeshift, seed):
    raw, labels, noise = _corpus(seed, 10)
    batch = 24
    cfg = JA.AugmentConfig(timeshift_samples=timeshift, n_silence=4)
    pool_j, windows_j = JA.prepare_train_arrays(raw, noise, cfg, layout="xla")
    key = jax.random.PRNGKey(seed)
    want, want_lab = JA.sample_train_batch(key, pool_j, jnp.asarray(labels), windows_j, batch, cfg)

    pcfg = A.AugmentConfig(timeshift_samples=timeshift, n_silence=4)
    arrays = A.prepare_train_arrays(raw, labels, noise, pcfg)  # "auto" is exact
    assert arrays.layout == "exact" and arrays.n_noise == windows_j.shape[0]
    draws = _jax_draws(key, 10, cfg, timeshift, arrays.n_noise, batch)
    got, lab = A.assemble_batch(draws, arrays, pcfg)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_exact_sampler_all_silence_is_noise_only():
    raw, labels, noise = _corpus(6, 4)
    batch = 16
    cfg = JA.AugmentConfig(n_silence=100000, noise_prob=0.0)
    pool_j, windows_j = JA.prepare_train_arrays(raw, noise, cfg, layout="xla")
    key = jax.random.PRNGKey(0)
    want, want_lab = JA.sample_train_batch(key, pool_j, jnp.asarray(labels), windows_j, batch, cfg)

    pcfg = A.AugmentConfig(n_silence=100000, noise_prob=0.0)
    arrays = A.prepare_train_arrays(raw, labels, noise, pcfg)
    draws = _jax_draws(key, 4, cfg, pcfg.timeshift_samples, arrays.n_noise, batch)
    assert bool((draws.idx >= 4).all())
    got, lab = A.assemble_batch(draws, arrays, pcfg)
    assert (lab == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # Silence is pure scaled noise: the noise window at the drawn offset, times its scale.
    starts = (draws.noise_row * arrays.stride).clamp(0, arrays.noise.shape[0] - 16000)
    for b in range(batch):
        window = arrays.noise[starts[b]: starts[b] + 16000]
        np.testing.assert_allclose(got[b].numpy(), (window * draws.scale_u[b] * 0.1).clamp(-1, 1).numpy(),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("noise_len,stride", [(16000 * 3 + 123, 2000), (5000, 2000), (40000, 1024)])
def test_noise_windows_without_building_them(noise_len, stride):
    noise = (np.random.default_rng(noise_len).standard_normal(noise_len) * 0.1).astype(np.float32)
    want = np.asarray(JA.make_noise_windows(jnp.asarray(noise), 16000, stride))
    tiled, starts = A.make_noise_windows(noise, 16000, stride)
    assert starts.shape[0] == want.shape[0]
    got = np.stack([tiled[s: s + 16000].numpy() for s in starts.tolist()])
    np.testing.assert_array_equal(got, want)


def test_pad_pool_timeshift_eval_batch_equal_reference():
    raw, labels, _ = _corpus(7, 5)
    np.testing.assert_array_equal(A.pad_pool(raw, 640).numpy(), np.asarray(JA.pad_pool(jnp.asarray(raw), 640)))
    audio = raw.astype(np.float32) / 32768.0
    shift = np.array([-300, 0, 7, 1600, -1600], np.int32)
    np.testing.assert_array_equal(
        A.timeshift(torch.from_numpy(audio), torch.from_numpy(shift).long()).numpy(),
        np.asarray(JA.timeshift(jnp.asarray(audio), jnp.asarray(shift))),
    )
    got = A.eval_batch(torch.from_numpy(raw), torch.from_numpy(labels).long(), 3, 4)
    want = JA.eval_batch(jnp.asarray(raw), jnp.asarray(labels), jnp.int32(3), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_draws_depend_on_key_and_step_only():
    raw, labels, noise = _corpus(8, 6)
    cfg = A.AugmentConfig(n_silence=2)
    arrays = A.prepare_train_arrays(raw, labels, noise, cfg)

    def draws(key, step):
        return A.draw_batch(A.step_generator(key, step, "cpu"), arrays, 64, cfg)

    d1, d2, d3 = draws(1, 5), draws(1, 5), draws(1, 6)
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    assert not torch.equal(d1.idx, d3.idx)
    assert 0 <= int(d1.idx.min()) and int(d1.idx.max()) < 6 + 2
    assert int(d1.shift.abs().max()) <= cfg.timeshift_samples
    assert 0 <= int(d1.noise_row.min()) and int(d1.noise_row.max()) < arrays.n_noise
    assert 0.0 <= float(d1.add_u.min()) and float(d1.scale_u.max()) < 1.0


def test_assemble_checks_its_inputs():
    pool = torch.zeros(20000, dtype=torch.int16)
    noise = torch.zeros(20000)
    starts = torch.zeros(2, dtype=torch.int64)
    gain = torch.ones(2)
    with pytest.raises(ValueError, match="int16"):
        K.assemble(pool.float(), noise, starts, starts, gain, gain)
    with pytest.raises(ValueError, match="int64"):
        K.assemble(pool, noise, starts.int(), starts, gain, gain)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        K.assemble(pool, noise, starts, starts[:1], gain, gain)
    with pytest.raises(ValueError, match="clip_start out of range"):
        K.assemble(pool, noise, torch.tensor([0, 4001]), starts, gain, gain)
    with pytest.raises(ValueError, match="noise_start out of range"):
        K.assemble(pool, noise, starts, torch.tensor([-1, 0]), gain, gain)
    with pytest.raises(ValueError, match="layout"):
        A.prepare_train_arrays(np.zeros((1, 16000), np.int16), [2], np.zeros(16001, np.float32),
                               A.AugmentConfig(), layout="pallas")
