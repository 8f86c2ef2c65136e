// Fused MFCC kernel for Hopper (sm_90a): raw audio (B, n_samples) f32 ->
// MFCC (B, n_frames, 40) f32. Frame t reads samples t * 160 - pad ..
// t * 160 - pad + 479 of its row, in one of two framings:
//   pad 240: center framing with reflect padding, n_frames = 1 + n_samples / 160
//            (the utterance frontend and offline streaming);
//   pad 0:   causal framing, no padding, n_frames given by the caller with
//            (n_frames - 1) * 160 + 480 <= n_samples (the online streaming step,
//            whose rows are [480-sample tail | chunk]).
//
// Replaces the TPU kernel honk_tpu/ops/mfcc_kernel.py::_mfcc_rows (Pallas
// body _mfcc_kernel), which takes the DFT as two dense products against
// cos / -sin bases and the mel projection as a dense product. Like it, no
// intermediate leaves the chip. Unlike it, the frames are built here from
// the audio (center reflect padding of 240 samples with no edge repeat, or
// causal with none), so no (B, 101, 480) frame tensor is written to HBM, and the transform is a
// real FFT that computes only the bins the mel filters use.
//
// Per frame, one warp (FRAMES warps a block, so B=1's 101 frames take 26
// blocks):
//   1. the 480 windowed samples, read (with the reflect index) by the warp's
//      lanes from consecutive addresses, packed as 240 complex values
//      z[n] = x[2n] + i x[2n+1] in shared memory;
//   2. a Stockham FFT of 240 points, radices 4, 4, 3, 5 (one pass each,
//      ping-pong between two shared buffers, twiddles from the table);
//   3. the real-FFT split step for bins k = 0..119 only:
//      X[k] = (Z[k] + conj Z[240-k]) / 2 + w^k (Z[k] - conj Z[240-k]) / 2i,
//      w = exp(-2 pi i / 480), then |X[k]|^2;
//   4. each mel filter as its run of at most 13 bins (start, length, taps),
//      summed in bin order with fmaf, then honk's masked log (logf behind
//      > 0: a silent frame stays exactly 0);
//   5. the 40x40 DCT, written straight to the output.
// The twiddles (308 for the four passes, 120 for the split step) are made
// on the host in float64 and rounded to f32 (ops/mfcc_kernel.py), like the
// window, the mel taps and the DCT.
//
// Operations per frame, as done here (a complex product is 6): window 480;
// the four passes 9,936 (radix 4: 60 butterflies of 3 twiddle products and
// 16, twice; radix 3: 80 of 2 products and 18; radix 5: 48 of 4 products
// and 48); the split step and power 2,280; mel 460 (230 taps); 40 logs; DCT
// 3,200. About 16.4 k in all, against 485 k for the dense DFT and mel
// products it replaces. At about 80 KB of audio and MFCCs per utterance
// the function is bound by bytes on this card; what the kernel adds above
// that is latency: one warp walks its frame through five dependent phases.

#include <cuda_runtime.h>

#define N_FFT 480
#define HOP 160
#define N_CPLX 240   // complex points of the packed transform
#define N_BINS 120   // bins 0..119: every bin a mel filter uses (checked by the wrapper)
#define N_MELS 40
#define N_DCT 40
#define FRAMES 4     // frames per block, one warp each
#define THREADS (32 * FRAMES)
// Twiddle table (float2): one run per pass, (j mod Ns) * R + r, then the split step.
#define TW_PASS1 0     // radix 4, Ns 1
#define TW_PASS2 4     // radix 4, Ns 4
#define TW_PASS3 20    // radix 3, Ns 16
#define TW_PASS4 68    // radix 5, Ns 48
#define TW_SPLIT 308   // w^k, k = 0..119

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
// -i * a
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// In-place DFT of R points: v[q] <- sum_r v[r] exp(-2 pi i r q / R).
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 a0 = cadd(v[0], v[2]), a1 = csub(v[0], v[2]);
  const float2 a2 = cadd(v[1], v[3]), a3 = mul_neg_i(csub(v[1], v[3]));
  v[0] = cadd(a0, a2);
  v[2] = csub(a0, a2);
  v[1] = cadd(a1, a3);
  v[3] = csub(a1, a3);
}

template <>
__device__ __forceinline__ void dft<3>(float2 (&v)[3]) {
  const float c = -0.5f, s = 0.866025403784438647f;  // cos(2pi/3), sin(2pi/3)
  const float2 t = cadd(v[1], v[2]), d = mul_neg_i(csub(v[1], v[2]));
  const float2 m = make_float2(v[0].x + c * t.x, v[0].y + c * t.y);
  v[0] = cadd(v[0], t);
  v[1] = make_float2(m.x + s * d.x, m.y + s * d.y);
  v[2] = make_float2(m.x - s * d.x, m.y - s * d.y);
}

template <>
__device__ __forceinline__ void dft<5>(float2 (&v)[5]) {
  const float c1 = 0.309016994374947424f, c2 = -0.809016994374947424f;  // cos(2pi/5), cos(4pi/5)
  const float s1 = 0.951056516295153572f, s2 = 0.587785252292473129f;   // sin(2pi/5), sin(4pi/5)
  const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
  const float2 d1 = mul_neg_i(csub(v[1], v[4])), d2 = mul_neg_i(csub(v[2], v[3]));
  const float2 m1 = make_float2(v[0].x + c1 * t1.x + c2 * t2.x, v[0].y + c1 * t1.y + c2 * t2.y);
  const float2 m2 = make_float2(v[0].x + c2 * t1.x + c1 * t2.x, v[0].y + c2 * t1.y + c1 * t2.y);
  const float2 e1 = make_float2(s1 * d1.x + s2 * d2.x, s1 * d1.y + s2 * d2.y);
  const float2 e2 = make_float2(s2 * d1.x - s1 * d2.x, s2 * d1.y - s1 * d2.y);
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = cadd(m1, e1);
  v[4] = csub(m1, e1);
  v[2] = cadd(m2, e2);
  v[3] = csub(m2, e2);
}

// One Stockham pass of radix R after passes whose radices multiply to ns:
// butterfly j reads in[j + r*N/R], multiplies by tw[(j mod ns)*R + r],
// takes the R-point DFT and writes out[(j/ns)*ns*R + j mod ns + r*ns].
template <int R>
__device__ __forceinline__ void pass(const float2* __restrict__ in, float2* __restrict__ out, int ns,
                                     const float2* __restrict__ tw, int lane) {
  constexpr int J = N_CPLX / R;
  for (int j = lane; j < J; j += 32) {
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[j + r * J];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(tw + k * R + r));
    dft<R>(v);
    const int d = (j / ns) * ns * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out[d + r * ns] = v[r];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
mfcc_kernel(const float* __restrict__ audio, const float* __restrict__ window,
            const float2* __restrict__ twiddle, const int* __restrict__ mel_runs,
            const float* __restrict__ mel_taps, const float* __restrict__ dct,
            float* __restrict__ out, int n_rows, int n_samples, int n_frames, int pad) {
  __shared__ float2 bufs[FRAMES][2][N_CPLX];
  __shared__ float power[FRAMES][N_BINS];
  __shared__ float logmel[FRAMES][N_MELS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * FRAMES + warp;
  if (row >= n_rows) return;  // warps synchronise only among their own lanes
  const int b = row / n_frames, t = row - b * n_frames;
  float2* z = bufs[warp][0];
  float2* y = bufs[warp][1];

  // 1. The windowed frame, as 240 complex values.
  float* f = reinterpret_cast<float*>(z);
  const float* a = audio + (long long)b * n_samples;
  for (int n = lane; n < N_FFT; n += 32) {
    int p = t * HOP + n - pad;
    if (p < 0) p = -p;                                      // reflect, no edge repeat (pad 240 only)
    else if (p >= n_samples) p = 2 * (n_samples - 1) - p;
    f[n] = a[p] * __ldg(window + n);
  }
  __syncwarp();

  // 2. FFT of 240 points; the result lands back in z.
  pass<4>(z, y, 1, twiddle + TW_PASS1, lane);
  pass<4>(y, z, 4, twiddle + TW_PASS2, lane);
  pass<3>(z, y, 16, twiddle + TW_PASS3, lane);
  pass<5>(y, z, 48, twiddle + TW_PASS4, lane);

  // 3. Split step and power, bins 0..119.
  for (int k = lane; k < N_BINS; k += 32) {
    const float2 zk = z[k], zn = z[(N_CPLX - k) % N_CPLX];
    const float2 xe = make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y));
    const float2 xo = make_float2(0.5f * (zk.y + zn.y), -0.5f * (zk.x - zn.x));
    const float2 x = cadd(xe, cmul(__ldg(twiddle + TW_SPLIT + k), xo));
    power[warp][k] = x.x * x.x + x.y * x.y;
  }
  __syncwarp();

  // 4. Mel filters as runs of bins, and honk's masked log: zeros stay exactly 0.
  for (int m = lane; m < N_MELS; m += 32) {
    const int start = __ldg(mel_runs + 3 * m), len = __ldg(mel_runs + 3 * m + 1);
    const float* w = mel_taps + __ldg(mel_runs + 3 * m + 2);
    float acc = 0.f;
    for (int i = 0; i < len; ++i) acc = fmaf(power[warp][start + i], __ldg(w + i), acc);
    logmel[warp][m] = acc > 0.f ? logf(acc) : acc;
  }
  __syncwarp();

  // 5. DCT, straight to the output.
  for (int j = lane; j < N_DCT; j += 32) {
    float acc = 0.f;
    for (int m = 0; m < N_MELS; ++m) acc = fmaf(logmel[warp][m], __ldg(dct + m * N_DCT + j), acc);
    out[(long long)row * N_DCT + j] = acc;
  }
}

// Launches on `stream`, one warp per frame; `pad` is 240 (center, reflect)
// or 0 (causal). Returns the cudaError_t of the launch (0 = success).
extern "C" int mfcc_forward(const float* audio, const float* window, const float* twiddle,
                            const int* mel_runs, const float* mel_taps, const float* dct,
                            float* out, int batch, int n_samples, int n_frames, int pad,
                            void* stream) {
  const int n_rows = batch * n_frames;
  const int grid = (n_rows + FRAMES - 1) / FRAMES;
  mfcc_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      audio, window, reinterpret_cast<const float2*>(twiddle), mel_runs, mel_taps, dct, out,
      n_rows, n_samples, n_frames, pad);
  return (int)cudaGetLastError();
}
