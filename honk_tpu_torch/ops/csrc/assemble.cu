// Batch-assembly kernel for Hopper (sm_90a): one augmented training batch
// from the device-resident corpus and background noise.
//
//   out[b, t] = clamp(float(pool[clip_start[b] + t]) * gain[b]
//                     + noise[noise_start[b] + t] * nscale[b], -1, 1),  t < n_samples
//
// Replaces the TPU kernel honk_tpu/ops/assemble_kernel.py::_assemble_call
// (Pallas body _make_kernel). That kernel DMAs a 136 x 128 block of int16
// corpus "sub-rows" and a 136 x 128 block of noise per sample and selects a
// residual shift of 0..7 sub-rows, because Mosaic needs 8-row-aligned DMA
// slices; its time shift is therefore rounded to 128 samples. Nothing here
// needs that alignment: each sample gets a start offset in samples into the
// flat pool and the flat noise, so both the TPU's sub-row layout
// (clip_start = (base8 * 8 + fine) * 128) and the exact per-sample shifts of
// honk_tpu/data/augment.py::sample_train_batch (clip_start into the padded
// pool) are cases of the one formula. Offsets are int64: the sub-row pool of
// Speech Commands v2 is about 2.2e9 samples, beyond int32.
//
// Bound on this card: bytes. Per output sample 2 B of int16 and 4 B of noise
// are read and 4 B written, with two multiplies, an add and a clamp: about
// 0.4 operations per byte, far below the ~20 at which f32 arithmetic would
// bind. The design only has to keep the loads and stores coalesced: a block
// covers THREADS * PER_THREAD consecutive samples of one output row, and
// thread i takes samples i, i + THREADS, ..., so a warp reads 32 consecutive
// int16 and 32 consecutive floats whatever the (unaligned) offsets, and
// writes 128 consecutive bytes. Products and the sum use __fmul_rn /
// __fadd_rn, so nvcc contracts nothing into an FMA and the result equals the
// plain PyTorch version (a multiply, a multiply, an add) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define PER_THREAD 4  // samples per thread, THREADS apart

__global__ void __launch_bounds__(THREADS)
assemble_kernel(const int16_t* __restrict__ pool, const float* __restrict__ noise,
                const int64_t* __restrict__ clip_start, const int64_t* __restrict__ noise_start,
                const float* __restrict__ gain, const float* __restrict__ nscale,
                float* __restrict__ out, int n_samples) {
  const int b = blockIdx.y;
  const int16_t* src = pool + clip_start[b];
  const float* nsrc = noise + noise_start[b];
  const float g = gain[b], s = nscale[b];
  float* dst = out + (int64_t)b * n_samples;
  const int t0 = blockIdx.x * (THREADS * PER_THREAD) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int t = t0 + j * THREADS;
    if (t < n_samples) {
      const float v = __fadd_rn(__fmul_rn((float)src[t], g), __fmul_rn(nsrc[t], s));
      dst[t] = fminf(fmaxf(v, -1.f), 1.f);
    }
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int assemble_forward(const int16_t* pool, const float* noise, const int64_t* clip_start,
                                const int64_t* noise_start, const float* gain, const float* nscale,
                                float* out, int batch, int n_samples, void* stream) {
  const dim3 grid((n_samples + THREADS * PER_THREAD - 1) / (THREADS * PER_THREAD), batch);
  assemble_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pool, noise, clip_start, noise_start, gain, nscale, out, n_samples);
  return (int)cudaGetLastError();
}
