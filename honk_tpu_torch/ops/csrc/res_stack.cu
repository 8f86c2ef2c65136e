// Res-stack kernel for Hopper (sm_90a): the eval-mode residual stack of the
// res8 / res8-narrow / res26(-narrow) models after conv0 and the pool, plus
// the global mean and the Dense layer, in float32.
//
// Replaces the TPU kernel honk_tpu/ops/res_kernel.py::_res_stack_call
// (Pallas body _make_kernel). Semantics kept exactly (models/res.py):
//     x = old = pooled conv0 output
//     for each layer i = 1..L:  y = relu(conv3x3_i(x))            (SAME, no bias)
//                               if i even: y += old; old = y      (pre-BN sum)
//                               x = y * scale_i + offset_i        (folded BN)
//     logits = mean_hw(x) @ dense_w + dense_b
//
// Bound on this card: float32 FMAs. res8 is about 71.1 MFLOP per utterance
// (2 x 6 layers x 25*13 pixels x 9*45 x 45, no channel padding) against
// 58.5 KB of input per utterance and 0.44 MB of weights shared by the batch,
// so it is compute-bound. The design keeps every activation on the chip:
// one block per utterance holds two zero-bordered activation buffers (a 3x3
// conv cannot overwrite its own input, so layers ping-pong between them)
// and the residual carry in dynamic shared memory (res8: 2 x 72.9 KB +
// 58.5 KB = 204 KB of the 227 KB a block may use). Where that does not fit
// (res26's 50x20 maps), the wrapper passes a global scratch buffer and the
// same code runs on it through generic pointers, out of L1/L2. Each thread
// computes OCB=4 output channels for one row of up to CW=13 pixels (res8's
// pooled width): each input row segment is loaded once into registers and
// feeds 3 taps x 4 channels, so there are 52 independent FMA chains per
// thread and about 6 FMAs per load. Consecutive threads take consecutive
// rows of the same channels, so their weight loads are one broadcast and
// their activation loads fall in distinct banks (the row stride W+2 is odd
// for res8). bf16 operands (the TPU kernel's compute_dtype) and tensor
// cores are later work.

#include <cuda_runtime.h>

#define MAX_C 64     // n_maps <= MAX_C
#define OCB 4        // output channels per work item
#define CW 13        // output pixels of one row per work item
#define THREADS 320  // res8: ceil(45 / OCB) x 25 rows = 300 work items per layer, one round

__global__ void __launch_bounds__(THREADS)
res_stack_kernel(const float* __restrict__ x_in,       // (B, C, H, W) pooled conv0 output
                 const float* __restrict__ w_all,      // (L, 9, C, C): [layer][dy*3+dx][in][out]
                 const float* __restrict__ bn_scale,   // (L, C)
                 const float* __restrict__ bn_offset,  // (L, C)
                 const float* __restrict__ dense_w,    // (C, n_labels)
                 const float* __restrict__ dense_b,    // (n_labels,)
                 float* __restrict__ out,              // (B, n_labels)
                 float* scratch,  // nullptr: buffers in shared memory; else per-utterance global buffers
                 int C, int H, int W, int L, int n_labels) {
  extern __shared__ float4 smem4[];
  __shared__ float feats[MAX_C];
  const int Wp = W + 2, plane = (H + 2) * Wp, HW = H * W;
  // Buffer layout (same in shared and in global scratch):
  //   xa, xb: [C][H+2][W+2] zero-bordered activations;  old: [C][H][W] residual carry.
  const long long per_utt = 2LL * C * plane + (long long)C * HW;
  float* xa = scratch ? scratch + blockIdx.x * per_utt : reinterpret_cast<float*>(smem4);
  float* xb = xa + C * plane;
  float* old = xb + C * plane;
  const int tid = threadIdx.x;
  const float* xin = x_in + (long long)blockIdx.x * C * HW;

  for (int i = tid; i < 2 * C * plane; i += THREADS) xa[i] = 0.f;  // borders of xa and xb
  __syncthreads();
  for (int i = tid; i < C * HW; i += THREADS) {
    const int c = i / HW, p = i - c * HW, y = p / W, x = p - y * W;
    const float v = xin[i];
    xa[c * plane + (y + 1) * Wp + x + 1] = v;
    old[i] = v;
  }
  __syncthreads();

  const int n_chunks = (W + CW - 1) / CW;
  const int cw = (W + n_chunks - 1) / n_chunks;
  const int items = (C + OCB - 1) / OCB * n_chunks * H;
  for (int l = 0; l < L; ++l) {
    const float* src = (l & 1) ? xb : xa;
    float* dst = (l & 1) ? xa : xb;
    const float* wl = w_all + (long long)l * 9 * C * C;
    const bool residual = (l & 1) != 0;  // 1-based layer l+1 is even
    for (int it = tid; it < items; it += THREADS) {
      const int y = it % H, rest = it / H;
      const int x0 = (rest % n_chunks) * cw, oc0 = (rest / n_chunks) * OCB;
      const int n = min(cw, W - x0);
      float acc[OCB][CW];
#pragma unroll
      for (int j = 0; j < OCB; ++j)
#pragma unroll
        for (int p = 0; p < CW; ++p) acc[j][p] = 0.f;
      for (int ic = 0; ic < C; ++ic) {
        const float* wic = wl + ic * C + oc0;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          // Bordered row y+dy, columns x0 .. x0+n+1, covers the three taps of n outputs.
          const float* row = src + ic * plane + (y + dy) * Wp + x0;
          float seg[CW + 2];
#pragma unroll
          for (int p = 0; p < CW + 2; ++p) seg[p] = (p < n + 2) ? row[p] : 0.f;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* wt = wic + (dy * 3 + dx) * C * C;
            float w[OCB];
#pragma unroll
            for (int j = 0; j < OCB; ++j) w[j] = (oc0 + j < C) ? wt[j] : 0.f;
#pragma unroll
            for (int j = 0; j < OCB; ++j)
#pragma unroll
              for (int p = 0; p < CW; ++p) acc[j][p] = fmaf(w[j], seg[p + dx], acc[j][p]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < OCB; ++j) {
        const int oc = oc0 + j;
        if (oc >= C) break;
        const float s = bn_scale[l * C + oc], o = bn_offset[l * C + oc];
#pragma unroll
        for (int p = 0; p < CW; ++p) {
          if (p < n) {
            float v = fmaxf(acc[j][p], 0.f);
            const int hw = oc * HW + y * W + x0 + p;
            if (residual) {
              v += old[hw];
              old[hw] = v;
            }
            dst[oc * plane + (y + 1) * Wp + x0 + p + 1] = v * s + o;
          }
        }
      }
    }
    __syncthreads();  // the layer's output is complete before the next layer reads it
  }

  const float* fin = (L & 1) ? xb : xa;  // layer L-1 wrote xa when L is even
  for (int c = tid; c < C; c += THREADS) {
    const float* pc = fin + c * plane;
    float acc = 0.f;
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) acc += pc[(y + 1) * Wp + x + 1];
    feats[c] = acc / (float)HW;
  }
  __syncthreads();
  for (int j = tid; j < n_labels; j += THREADS) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(feats[c], dense_w[c * n_labels + j], acc);
    out[(long long)blockIdx.x * n_labels + j] = acc + dense_b[j];
  }
}

// Launches on `stream`, one block per utterance; with scratch == nullptr the
// buffers take (2*C*(H+2)*(W+2) + C*H*W) floats of dynamic shared memory.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int res_stack_forward(const float* x, const float* w_all, const float* bn_scale,
                                 const float* bn_offset, const float* dense_w,
                                 const float* dense_b, float* out, float* scratch, int batch,
                                 int C, int H, int W, int L, int n_labels, void* stream) {
  if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
  int smem = 0;
  if (!scratch) {
    smem = (2 * C * (H + 2) * (W + 2) + C * H * W) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        res_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  res_stack_kernel<<<batch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w_all, bn_scale, bn_offset, dense_w, dense_b, out, scratch, C, H, W, L, n_labels);
  return (int)cudaGetLastError();
}
