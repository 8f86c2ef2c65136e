// Fused MFCC kernel for Hopper (sm_90a): raw audio (B, n_samples) f32 ->
// MFCC (B, n_frames, 40) f32, with n_frames = 1 + n_samples / 160.
//
// Replaces the TPU kernel honk_tpu/ops/mfcc_kernel.py::_mfcc_rows (Pallas
// body _mfcc_kernel). Like it, no intermediate leaves the chip: the windowed
// frames, the DFT real/imaginary parts, the power spectrum and the mel
// energies live in shared memory and registers. Unlike it, the frames are
// built here from the audio with center reflect padding (240 samples, no
// edge repeat), so no (B, 101, 480) frame tensor is written to HBM, and no
// TPU lane padding (480->512, 241->256, 40->128) is carried over.
//
// Bound on this card: float32 FMAs. One utterance is about 49.0 MFLOP
// (101 frames x 2 x (2*480*241 + 241*40 + 40*40), no padding) against
// about 80 KB of input and output, so the kernel is compute-bound by a wide
// margin. Everything stays full f32 (no TF32, no bf16): the frontend feeds
// a parity-gated classifier. The design spends its effort on the DFT, which
// is 95% of the operations: each block takes ROWS frame rows, each thread
// owns one of the 241 bins and keeps the real and imaginary sums of all
// ROWS rows in registers, so each basis value read from L2 feeds 2*ROWS FMAs
// and each float4 of frame samples read from shared memory feeds 8 FMAs.
// The cos/sin bases (2 x 480 x 241 f32, 925 KB) stay in L2. Tensor-core
// versions (3xTF32 wgmma) are later work.

#include <cuda_runtime.h>

#define N_FFT 480
#define HOP 160
#define N_RFFT 241
#define N_MELS 40
#define N_DCT 40
#define ROWS 32      // frame rows per block
#define THREADS 256  // one DFT bin per thread; threads 241..255 help in the other phases

__global__ void __launch_bounds__(THREADS)
mfcc_kernel(const float* __restrict__ audio, const float* __restrict__ window,
            const float* __restrict__ dft_cos, const float* __restrict__ dft_sin,
            const float* __restrict__ mel, const float* __restrict__ dct,
            float* __restrict__ out, int n_rows, int n_samples, int n_frames) {
  extern __shared__ float4 smem4[];
  float* frames = reinterpret_cast<float*>(smem4);  // [ROWS][N_FFT], then power [ROWS][N_RFFT]
  float* logmel = frames + ROWS * N_FFT;             // [ROWS][N_MELS]
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;

  // 1. Windowed frames straight from the audio; rows past the end are 0.
  for (int i = tid; i < ROWS * N_FFT; i += THREADS) {
    const int r = i / N_FFT, n = i - r * N_FFT, row = row0 + r;
    float v = 0.f;
    if (row < n_rows) {
      const int b = row / n_frames, t = row - b * n_frames;
      int p = t * HOP + n - N_FFT / 2;
      if (p < 0) p = -p;                                      // reflect, no edge repeat
      else if (p >= n_samples) p = 2 * (n_samples - 1) - p;
      v = audio[(long long)b * n_samples + p] * window[n];
    }
    frames[i] = v;
  }
  __syncthreads();

  // 2. Real DFT as two products against the cos / -sin bases.
  const int k = tid;
  float re[ROWS], im[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) re[r] = im[r] = 0.f;
  if (k < N_RFFT) {
    for (int n = 0; n < N_FFT; n += 4) {
      float c[4], s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = dft_cos[(n + j) * N_RFFT + k];
        s[j] = dft_sin[(n + j) * N_RFFT + k];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(frames + r * N_FFT + n);
        re[r] = fmaf(x.x, c[0], re[r]); im[r] = fmaf(x.x, s[0], im[r]);
        re[r] = fmaf(x.y, c[1], re[r]); im[r] = fmaf(x.y, s[1], im[r]);
        re[r] = fmaf(x.z, c[2], re[r]); im[r] = fmaf(x.z, s[2], im[r]);
        re[r] = fmaf(x.w, c[3], re[r]); im[r] = fmaf(x.w, s[3], im[r]);
      }
    }
  }
  __syncthreads();  // every thread is done reading the frames before they are overwritten

  float* power = frames;
  if (k < N_RFFT) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) power[r * N_RFFT + k] = re[r] * re[r] + im[r] * im[r];
  }
  __syncthreads();

  // 3. Mel projection and honk's masked log: zeros stay exactly 0.
  for (int i = tid; i < ROWS * N_MELS; i += THREADS) {
    const int r = i / N_MELS, m = i - r * N_MELS;
    const float* pr = power + r * N_RFFT;
    float acc = 0.f;
    for (int f = 0; f < N_RFFT; ++f) acc = fmaf(pr[f], mel[f * N_MELS + m], acc);
    logmel[i] = acc > 0.f ? logf(acc) : acc;
  }
  __syncthreads();

  // 4. DCT, written straight to the output; the ragged last tile is masked.
  for (int i = tid; i < ROWS * N_DCT; i += THREADS) {
    const int r = i / N_DCT, j = i - r * N_DCT, row = row0 + r;
    if (row >= n_rows) continue;
    const float* lr = logmel + r * N_MELS;
    float acc = 0.f;
    for (int m = 0; m < N_MELS; ++m) acc = fmaf(lr[m], dct[m * N_DCT + j], acc);
    out[(long long)row * N_DCT + j] = acc;
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int mfcc_forward(const float* audio, const float* window, const float* dft_cos,
                            const float* dft_sin, const float* mel, const float* dct,
                            float* out, int batch, int n_samples, int n_frames, void* stream) {
  const int n_rows = batch * n_frames;
  const int smem = (ROWS * N_FFT + ROWS * N_MELS) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rows + ROWS - 1) / ROWS;
  mfcc_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, window, dft_cos, dft_sin, mel, dct, out, n_rows, n_samples, n_frames);
  return (int)cudaGetLastError();
}
