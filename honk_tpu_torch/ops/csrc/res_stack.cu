// Res-stack kernel for Hopper (sm_90a): the eval-mode residual stack of the
// res8 / res8-narrow / res26(-narrow) models after conv0 and the pool, plus
// the global mean and the Dense layer, in three modes: the TPU kernel's two
// operand types (its compute_dtype) with float32 activations, float32 taken
// as 3xTF32 or bfloat16, and bfloat16 operands with bf16 activations, the
// dtype flow of flax's eval apply of a bf16 model.
//
// Replaces the TPU kernel honk_tpu/ops/res_kernel.py::_res_stack_call
// (Pallas body _make_kernel) and, in the bf16-activation mode, what the JAX
// package runs through XLA for a bf16 model's eval forward
// (honk_tpu/models/res.py, apply(train=False)). Semantics (models/res.py):
//     x = old = pooled conv0 output
//     for each layer i = 1..L:  y = relu(conv3x3_i(x))            (SAME, no bias)
//                               if i even: y += old; old = y      (pre-BN sum)
//                               x = y * scale_i + offset_i        (folded BN)
//     logits = mean_hw(x) @ dense_w + dense_b
//
// Bound on this card: the convolutions' multiply-adds. res8 is about 71.1
// MFLOP per utterance (2 x 6 layers x 25*13 pixels x 9*45 x 45) against
// 58.5 KB of input per utterance and 0.44 MB of weights shared by the
// batch. The convolutions run on the tensor cores in 3xTF32: each f32
// operand x is split into big and small (see Tf32x3), and a product is
// taken as big*big + big*small + small*big, summed in f32. That is three
// tensor-core products per product, so the operations bound is
// 3 x flops / 495 TFLOP/s (dense TF32), and the result stays within f32
// parity gates where one TF32 product would not
// (tests/test_torch_kernel_design.py). In the bf16 modes (Bf16, Bf16Act)
// each product is one bf16 product, so the bound is flops / 989 TFLOP/s
// (dense bf16), and a weight stage is a quarter of the tf32 mode's for
// res8's 45 maps (half the bytes a value, one tile in place of big and
// small; a third for the narrow models' 19, whose K pads to 32).
//
// Two kernels, launched one after the other by res_stack_forward:
// - res_stack_pack puts each tap's weights in the shared-memory layout that
//   wgmma reads B from (the host-built index table,
//   ops/res_kernel.py::fragment_index) and splits them once, a big and a
//   small tile per K chunk, so that no warp of the stack kernel rounds or
//   splits a weight; res_stack_pack_bf16 rounds them to bf16 into K chunks
//   of 16 (the table's bf16 layout), for both bf16 modes.
// - res_stack_kernel: one thread block cluster per utterance. CTA `rank` of
//   a cluster of `cs` owns the output rows [rank*H/cs, (rank+1)*H/cs) for
//   every channel, in two zero-bordered channel-last activation buffers in
//   shared memory (a 3x3 conv cannot overwrite its input, so layers
//   ping-pong between them) and the residual carry. The one-row halo above
//   and below the band is read from the neighbours' shared memory
//   (distributed shared memory) after the cluster barrier that ends each
//   layer, the only barrier across CTAs. The wrapper picks cs from B, H and
//   W (ops/res_kernel.py::cluster_size).
//   Each conv is an implicit GEMM: M = the band's pixels, N = C padded to
//   NT*8, K = 9 taps x NT*8, with wgmma.m64nNk8 TF32 on four warpgroups.
//   A comes from registers, read straight from the activation buffer
//   (pixel-major, channel stride NT*8+4, so the 32 lanes of a warp's load
//   hit 32 banks) and split in 3 instructions; B comes by descriptor from
//   a ring of STAGES per-tap weight stages, filled by 16-byte cp.async
//   while the taps before are multiplied. A warpgroup's work item is a
//   64-pixel M tile with all N tiles or, where a band has few M tiles (B=1
//   in small bands), with a half, a third or a quarter of them. Its
//   accumulators stay in registers across the 9 taps in two sets, the two
//   small terms and the big one, added in the epilogue: the tensor cores'
//   f32 accumulation truncates, so the big products' chain is kept apart.
// - Epilogue as the reference: ReLU, the residual add on even layers with
//   `old` carried pre-BN, then the folded BN (one fmaf); then the band's
//   channel sums go to rank 0, which takes the mean and the Dense layer.
// - The mode is a template parameter. Bf16 is the TPU kernel's
//   bf16-operand mode: wgmma.m64nNk16 bf16 with A from registers, each
//   bf16x2 register made by cvt.rn.bf16x2.f32 from two f32 activations
//   (one float2 load), one accumulator set, K = 9 taps x KT*16 with KT =
//   ceil(C / 16): a tap's depth must be a multiple of 16, so the channel
//   stride covers KT*16 channels (res8's 45 pad to 48, the narrow models'
//   19 to 32), the padding zero in the activations and the weights alike.
//   The Dense layer takes bf16-rounded features and weights, as the TPU
//   kernel's does. Bf16Act multiplies as Bf16 does, but its epilogue
//   follows flax's bf16 dtype flow: the conv's f32 sum rounded to bf16,
//   ReLU, on even layers the bf16 carry added and the sum rounded, the
//   folded BN taken in f32 and rounded back to bf16; the mean is taken over
//   those values in f32 and the Dense layer multiplies f32 operands. Its
//   activations stay in the f32 buffers, holding bf16 values, so the
//   layout and the wgmma path are Bf16's. Rounding is to nearest even
//   everywhere, so the kernel and ops/res_kernel.py::res_stack_plain round
//   the same f32 values to the same bf16 values; only f32 sum orders differ.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

#define MAX_C 64       // n_maps <= MAX_C
#define MAX_CLUSTER 8  // portable cluster size
#define THREADS 512
#define WARPS (THREADS / 32)  // a CTA's band has at most WARPS * 16 pixels
#define GROUPS (WARPS / 4)    // warpgroups
#define STAGES 3              // per-tap weight stages in flight

// wgmma D += A * B with A (64 x K) from registers, B (K x N) by descriptor
// and D (64 x N) f32 in registers, N / 8 groups of 4 a thread. One function
// per N and operand type, made by WGMMA_ALL: .m64nNk8.f32.tf32.tf32
// (A in the layout of mma.m16n8k8's A per warp of the warpgroup, four tf32
// registers) and .m64nNk16.f32.bf16.bf16 (mma.m16n8k16's A, four bf16x2
// registers; the trailing 0 is imm-trans-b: B is K-major as for tf32).

#define WGMMA_N8(fn, kind, tail) \
  __device__ __forceinline__ void fn(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n8" kind " {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1" tail ";\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N16(fn, kind, tail) \
  __device__ __forceinline__ void fn(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n16" kind " {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1" tail ";\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N24(fn, kind, tail) \
  __device__ __forceinline__ void fn(float (&d)[12], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n24" kind " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1" tail ";\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N32(fn, kind, tail) \
  __device__ __forceinline__ void fn(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n32" kind " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1" tail ";\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N40(fn, kind, tail) \
  __device__ __forceinline__ void fn(float (&d)[20], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n40" kind " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1" tail ";\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N48(fn, kind, tail) \
  __device__ __forceinline__ void fn(float (&d)[24], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n48" kind " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1" tail ";\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N56(fn, kind, tail) \
  __device__ __forceinline__ void fn(float (&d)[28], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n56" kind " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1" tail ";\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N64(fn, kind, tail) \
  __device__ __forceinline__ void fn(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n64" kind " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1" tail ";\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_ALL(suffix, kind, tail) \
  WGMMA_N8(wgmma_n8##suffix, kind, tail) \
  WGMMA_N16(wgmma_n16##suffix, kind, tail) \
  WGMMA_N24(wgmma_n24##suffix, kind, tail) \
  WGMMA_N32(wgmma_n32##suffix, kind, tail) \
  WGMMA_N40(wgmma_n40##suffix, kind, tail) \
  WGMMA_N48(wgmma_n48##suffix, kind, tail) \
  WGMMA_N56(wgmma_n56##suffix, kind, tail) \
  WGMMA_N64(wgmma_n64##suffix, kind, tail)
WGMMA_ALL(_tf32, "k8.f32.tf32.tf32", "")
WGMMA_ALL(_bf16, "k16.f32.bf16.bf16", ", 0")

template <int NN, bool BF16>
__device__ __forceinline__ void wgmma(float (&d)[NN * 4], const uint32_t (&a)[4], uint64_t desc) {
#define WGMMA_CASE(n) \
  if constexpr (NN * 8 == n) { \
    if constexpr (BF16) \
      wgmma_n##n##_bf16(d, a, desc); \
    else \
      wgmma_n##n##_tf32(d, a, desc); \
  }
  WGMMA_CASE(8) WGMMA_CASE(16) WGMMA_CASE(24) WGMMA_CASE(32) WGMMA_CASE(40) WGMMA_CASE(48) WGMMA_CASE(56)
  WGMMA_CASE(64)
#undef WGMMA_CASE
}

// B tiles in shared memory, no swizzle: a K chunk x N tile is N / 8 blocks
// of two core matrices (8 n x 16 B of K: 4 tf32 or 8 bf16 values a row, so
// a chunk is 8 tf32 or 16 bf16 deep), the two K halves 128 B apart (leading
// byte offset), the N blocks 256 B apart (stride byte offset). One
// descriptor serves both operand types.
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((a >> 4) & 0x3FFF) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

// 3xTF32 operands: x = big + small with big = x rounded to TF32 (to
// nearest, ties away) and small = x - big (exact in f32), which the tensor
// core reads as TF32 by dropping its low 13 bits; a*b = big*big + big*small
// + small*big (small*small dropped). big is rounded on the bits,
// (bits + 0x1000) & ~0x1FFF: that is cvt.rna.tf32.f32 for finite x without
// its infinity check, which compiles to a compare and a predicated add that
// stall the K loop (activations and weights here are finite). small is not
// rounded in software: |small| <= 2^-11 |x|, so the 13 bits the tensor core
// drops of it are less than 2^-21 |x|, and rounding would cost 2 more
// instructions per operand.
struct Tf32x3 {
  static constexpr bool kBf16 = false;
  __device__ __forceinline__ static uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }
  __device__ __forceinline__ static void split(float x, uint32_t& big, uint32_t& small) {
    big = tf32(x);
    small = __float_as_uint(x - __uint_as_float(big));
  }
  __device__ __forceinline__ static float operand(float x) { return x; }  // the Dense layer's, in f32
  __device__ __forceinline__ static float act(float x) { return x; }
};

// bf16 operands, the TPU kernel's compute_dtype=bfloat16: each conv's
// activations and weights and the Dense layer's features and weights are
// rounded to bf16, to nearest even (as astype(bfloat16)), and multiplied
// once on the tensor cores with the sums in f32; activations, the residual
// carry and BN stay f32. pack2 makes one bf16x2 register of mma.m16n8k16's
// A fragment: the lower K index in the low half (cvt.rn.bf16x2.f32 puts
// its first source in the high half).
struct Bf16 {
  static constexpr bool kBf16 = true;
  __device__ __forceinline__ static uint32_t pack2(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
  }
  __device__ __forceinline__ static float operand(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ __forceinline__ static float act(float x) { return x; }  // activations stay f32
};

// bf16 operands with bf16 activations, flax's eval flow for a bf16 model:
// every activation the epilogue writes (the conv's output, the residual sum,
// BN's output) is rounded to bf16, to nearest even, and the Dense layer
// multiplies the f32 mean by the f32 weights.
struct Bf16Act : Bf16 {
  __device__ __forceinline__ static float operand(float x) { return x; }
  __device__ __forceinline__ static float act(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

// Per (layer, tap): for each K chunk kc, a big then a small B tile of
// NT * 64 floats, entry e of a tile taken from frag_idx[kc * NT * 64 + e]
// (an offset in the tap's (C, C) block of w_all, or -1 for padding).
template <class Op>
__global__ void res_stack_pack(const float* __restrict__ w_all, const int* __restrict__ frag_idx,
                               float* __restrict__ packed, int C, int NT, int L) {
  const int per_tap = NT * NT * 64;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * 9 * per_tap) return;
  const int lt = i / per_tap, e = i - lt * per_tap, kc = e / (NT * 64);
  const int o = frag_idx[e];
  uint32_t big, small;
  Op::split(o >= 0 ? w_all[(long long)lt * C * C + o] : 0.f, big, small);
  float* tile = packed + (long long)lt * 2 * per_tap + kc * 2 * NT * 64 + (e - kc * NT * 64);
  tile[0] = __uint_as_float(big);
  tile[NT * 64] = __uint_as_float(small);
}

// Per (layer, tap): KT = ceil(C / 16) K chunks of 16, each a bf16 B tile of
// NT * 128 values, entry e of the tap's tiles taken from frag_idx[e] (its
// bf16 layout, ops/res_kernel.py::fragment_index) and rounded to nearest even.
__global__ void res_stack_pack_bf16(const float* __restrict__ w_all, const int* __restrict__ frag_idx,
                                    __nv_bfloat16* __restrict__ packed, int C, int per_tap, int L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * 9 * per_tap) return;
  const int lt = i / per_tap, o = frag_idx[i - lt * per_tap];
  packed[i] = __float2bfloat16_rn(o >= 0 ? w_all[(long long)lt * C * C + o] : 0.f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Shared-memory layout, in floats (the same in every CTA, so a neighbour's
// buffer sits at the same offset in its shared memory).
struct Layout {
  // Channel stride of a pixel. tf32: NT*8 + 4 (== 4 mod 8: a warp's 32 A
  // loads hit 32 banks). bf16: KT*16 + 8, the K chunks' padding included
  // (== 8 mod 16: a half warp's 16 float2 A loads hit 32 banks).
  int S;
  int Wp;      // bordered row width W + 2
  int band;    // most rows a CTA owns: ceil(H / cs)
  int act;     // one activation buffer: (band + 2) x Wp pixels, rounded up to 4 floats
  int old;     // residual carry: band x W pixels
  int wstage;  // one tap's B tiles, in floats: NT K chunks x (big, small) x NT * 64, or KT x NT * 128 bf16
  __host__ __device__ Layout(int NT, int H, int W, int cs, bool bf16) {
    const int KT = (NT + 1) / 2;
    S = bf16 ? KT * 16 + 8 : NT * 8 + 4;
    Wp = W + 2;
    band = (H + cs - 1) / cs;
    act = ((band + 2) * Wp * S + 3) / 4 * 4;
    old = band * W * S;
    wstage = bf16 ? KT * NT * 64 : NT * NT * 128;
  }
  __host__ __device__ int floats() const { return 2 * act + old + STAGES * wstage; }
};

template <class Op, int NT>
__global__ void __launch_bounds__(THREADS, 1)
res_stack_kernel(const float* __restrict__ x_in,      // (B, C, H, W) pooled conv0 output
                 const float* __restrict__ wpack,     // (L, 9, NT, 2, NT * 64) or (L, 9, KT, NT * 128 bf16) B tiles
                 const float* __restrict__ bn_scale,  // (L, C)
                 const float* __restrict__ bn_offset, // (L, C)
                 const float* __restrict__ dense_w,   // (C, n_labels)
                 const float* __restrict__ dense_b,   // (n_labels,)
                 float* __restrict__ out,             // (B, n_labels)
                 int C, int H, int W, int L, int n_labels) {
  constexpr bool BF16 = Op::kBf16;
  constexpr int KT = BF16 ? (NT + 1) / 2 : NT;  // K chunks of one tap
  constexpr int SETS = BF16 ? 1 : 2;            // accumulator sets
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int utt = blockIdx.x / cs;
  const Layout lay(NT, H, W, cs, BF16);
  const int S = lay.S, Wp = lay.Wp, HW = H * W;
  const int r0 = rank * H / cs, band = (rank + 1) * H / cs - r0;
  const int row_floats = Wp * S;

  extern __shared__ float4 smem4[];
  float* act0 = reinterpret_cast<float*>(smem4);
  float* act1 = act0 + lay.act;
  float* old = act1 + lay.act;
  float* wbuf = old + lay.old;  // STAGES stages of lay.wstage
  __shared__ float partial[MAX_CLUSTER * MAX_C];
  __shared__ float feats[MAX_C];
  __shared__ float bn[2 * MAX_C];  // the layer's BN scale, then offset

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // Stage s = (layer s / 9, tap s % 9) of the weights into wbuf[s % STAGES].
  const int n_stages = L * 9;
  auto load_stage = [&](int s) {
    if (s < n_stages) {
      const float4* src = reinterpret_cast<const float4*>(wpack + (long long)s * lay.wstage);
      float4* dst = reinterpret_cast<float4*>(wbuf + (s % STAGES) * lay.wstage);
      for (int e = tid; e < lay.wstage / 4; e += THREADS) cp_async16(dst + e, src + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);  // an empty group past the end keeps the count
  };
  for (int s = 0; s < STAGES - 1; ++s) load_stage(s);

  // Zero both activation buffers (borders, halo rows outside the image and
  // the channel padding stay 0) and the carry.
  for (int i = tid; i < (2 * lay.act + lay.old) / 4; i += THREADS) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // Layer 0 input: the band and its halo rows straight from x (no neighbour yet).
  {
    const int y_lo = max(r0 - 1, 0), y_hi = min(r0 + band + 1, H);
    const int rows = y_hi - y_lo, n = C * rows * W;
    const float* xin = x_in + (long long)utt * C * HW;
    for (int i = tid; i < n; i += THREADS) {
      const int c = i / (rows * W), rem = i - c * rows * W, yy = rem / W, x = rem - yy * W;
      const int y = y_lo + yy, lr = y - r0 + 1;  // local row: 0 is the top halo
      const float v = xin[c * HW + y * W + x];
      act0[(lr * Wp + x + 1) * S + c] = v;
      if (lr >= 1 && lr <= band) old[((lr - 1) * W + x) * S + c] = v;
    }
  }

  // This warpgroup's work item: 64-pixel M tile `tile` with N tiles
  // part*NN .. part*NN + NN - 1, where each M tile's NT N tiles split into
  // `parts` equal parts (the most, up to 4, with tiles x parts <= GROUPS).
  // This warp's two A rows are pixels g and g+8 of its 16 rows of the tile.
  const int n_pix = band * W, tiles = (n_pix + 63) / 64;
  int parts = 1;
  for (int p = 2; p <= 4; ++p)
    if (NT % p == 0 && tiles * p <= GROUPS) parts = p;
  const int group = warp / 4, tile = group / parts, part = group % parts;
  const bool have = tile < tiles;
  const int row16 = tile * 64 + (warp % 4) * 16;
  int abase[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int p = row16 + g + 8 * h;
    if (p >= n_pix) p = 0;  // a padding row: computed, never stored
    abase[h] = ((p / W) * Wp + p % W) * S;
  }

  auto layers = [&](auto nn) {
    constexpr int NN = decltype(nn)::value;
    const int n0 = part * NN;
    float acc[SETS][NN * 4];  // tf32: small*big + big*small, then big*big; bf16: the one product
#pragma unroll
    for (int q = 0; q < SETS; ++q)
#pragma unroll
      for (int e = 0; e < NN * 4; ++e) acc[q][e] = 0.f;

    for (int s = 0; s < n_stages; ++s) {
      const int l = s / 9, tap = s - l * 9;
      float* src = (l & 1) ? act1 : act0;
      float* dst = (l & 1) ? act0 : act1;
      if (tap == 0) {
        for (int c = tid; c < C; c += THREADS) {
          bn[c] = bn_scale[l * C + c];
          bn[MAX_C + c] = bn_offset[l * C + c];
        }
      }
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
      __syncthreads();  // stage s landed; every warpgroup is done with stage s-1's buffer; the halo is in
      load_stage(s + STAGES - 1);

      if (have) {
        const float* wt = wbuf + (s % STAGES) * lay.wstage + n0 * 64;
        if constexpr (BF16) {
          // Rows g and g+8 of the warp's 16, K values 2t, 2t+1 and 2t+8, 2t+9 of the chunk.
          const float* sa = src + ((tap / 3) * Wp + tap % 3) * S + 2 * t;
          uint32_t frag[2][4];  // A fragments, double-buffered over K chunks
#pragma unroll
          for (int kc = 0; kc < KT; ++kc) {
            const float* a = sa + kc * 16;
            uint32_t(&f)[4] = frag[kc & 1];
            const float2 x0 = *reinterpret_cast<const float2*>(a + abase[0]);
            const float2 x1 = *reinterpret_cast<const float2*>(a + abase[1]);
            const float2 x2 = *reinterpret_cast<const float2*>(a + abase[0] + 8);
            const float2 x3 = *reinterpret_cast<const float2*>(a + abase[1] + 8);
            f[0] = Op::pack2(x0.x, x0.y);
            f[1] = Op::pack2(x1.x, x1.y);
            f[2] = Op::pack2(x2.x, x2.y);
            f[3] = Op::pack2(x3.x, x3.y);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            wgmma<NN, true>(acc[0], f, b_desc(wt + kc * NT * 64));
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // chunk kc-1's A is free
          }
        } else {
          const float* sa = src + ((tap / 3) * Wp + tap % 3) * S + t;
          uint32_t big[2][4], small[2][4];  // A fragments, double-buffered over K chunks
#pragma unroll
          for (int kc = 0; kc < NT; ++kc) {
            const float* a = sa + kc * 8;
            uint32_t(&ab)[4] = big[kc & 1];
            uint32_t(&as)[4] = small[kc & 1];
            Op::split(a[abase[0]], ab[0], as[0]);
            Op::split(a[abase[1]], ab[1], as[1]);
            Op::split(a[abase[0] + 4], ab[2], as[2]);
            Op::split(a[abase[1] + 4], ab[3], as[3]);
            const float* b = wt + kc * 2 * NT * 64;
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            wgmma<NN, false>(acc[0], as, b_desc(b));
            wgmma<NN, false>(acc[0], ab, b_desc(b + NT * 64));
            wgmma<NN, false>(acc[1], ab, b_desc(b));
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // chunk kc-1's A is free
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
      if (tap != 8) continue;

      // Epilogue of layer l: ReLU, residual on even (1-based) layers, folded BN, each
      // result rounded to bf16 in the Bf16Act mode (Op::act).
      const bool residual = (l & 1) != 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = row16 + g + 8 * h;
        if (!have || p >= n_pix) continue;
        const int yl = p / W, x = p - yl * W;
        float* d = dst + ((yl + 1) * Wp + x + 1) * S;
        float* o = old + p * S;
#pragma unroll
        for (int j = 0; j < NN; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = (n0 + j) * 8 + 2 * t + e, r = 4 * j + 2 * h + e;
            if (c >= C) continue;
            float v = acc[0][r];
            if constexpr (!BF16) v += acc[1][r];
            v = fmaxf(Op::act(v), 0.f);
            if (residual) {
              v = Op::act(v + o[c]);
              o[c] = v;
            }
            d[c] = Op::act(fmaf(v, bn[c], bn[MAX_C + c]));
          }
      }
#pragma unroll
      for (int q = 0; q < SETS; ++q)
#pragma unroll
        for (int e = 0; e < NN * 4; ++e) acc[q][e] = 0.f;
      cluster.sync();  // every CTA's layer-l output is complete; its layer-l input is no longer read
      if (l + 1 < L) {
        // Halo rows of the next layer's input from the neighbours' own rows.
        float4* top = reinterpret_cast<float4*>(dst);
        float4* bottom = reinterpret_cast<float4*>(dst + (band + 1) * row_floats);
        if (rank > 0) {
          const int prev_band = r0 - (rank - 1) * H / cs;
          const float4* nb = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(dst, rank - 1) + prev_band * row_floats);
          for (int i = tid; i < row_floats / 4; i += THREADS) top[i] = nb[i];
        }
        if (rank + 1 < cs) {
          const float4* nb = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(dst, rank + 1) + row_floats);
          for (int i = tid; i < row_floats / 4; i += THREADS) bottom[i] = nb[i];
        }
      }
    }
  };
  switch (parts) {
    case 1: layers(std::integral_constant<int, NT>{}); break;
    case 2: layers(std::integral_constant<int, (NT % 2 == 0 ? NT / 2 : NT)>{}); break;
    case 3: layers(std::integral_constant<int, (NT % 3 == 0 ? NT / 3 : NT)>{}); break;
    default: layers(std::integral_constant<int, (NT % 4 == 0 ? NT / 4 : NT)>{}); break;
  }

  // Mean over the image: each CTA sums its band, rank 0 gathers the sums.
  const float* fin = ((L - 1) & 1) ? act0 : act1;  // layer L-1 wrote act1 when it is even (0-based)
  float* partial0 = cluster.map_shared_rank(partial, 0);
  for (int c = tid; c < C; c += THREADS) {
    float sum = 0.f;
    for (int p = 0; p < n_pix; ++p) {
      const int yl = p / W, x = p - yl * W;
      sum += fin[((yl + 1) * Wp + x + 1) * S + c];
    }
    partial0[rank * MAX_C + c] = sum;
  }
  cluster.sync();
  if (rank != 0) return;
  for (int c = tid; c < C; c += THREADS) {
    float sum = 0.f;
    for (int r = 0; r < cs; ++r) sum += partial[r * MAX_C + c];
    feats[c] = sum / (float)HW;
  }
  __syncthreads();
  for (int j = tid; j < n_labels; j += THREADS) {
    float a = 0.f;
    for (int c = 0; c < C; ++c) a = fmaf(Op::operand(feats[c]), Op::operand(dense_w[c * n_labels + j]), a);
    out[(long long)utt * n_labels + j] = a + dense_b[j];
  }
}

// Dynamic shared memory of one CTA of the stack kernel, in bytes
// (ops/res_kernel.py::smem_bytes computes the same to choose the cluster size).
static int res_stack_smem_bytes(int C, int H, int W, int cluster, bool bf16) {
  return Layout((C + 7) / 8, H, W, cluster, bf16).floats() * (int)sizeof(float);
}

template <class Op, int NT>
static int launch(const float* x, const float* wpack, const float* bn_scale, const float* bn_offset,
                  const float* dense_w, const float* dense_b, float* out, int batch, int C, int H, int W,
                  int L, int n_labels, int cluster, cudaStream_t stream) {
  auto kernel = res_stack_kernel<Op, NT>;
  const int smem = res_stack_smem_bytes(C, H, W, cluster, Op::kBf16);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, wpack, bn_scale, bn_offset, dense_w, dense_b, out, C, H, W, L,
                           n_labels);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches on `stream`: the pack kernel into `wpack` (tf32: L * 9 * NT * NT
// * 128 floats, NT = ceil(C/8); bf16: L * 9 * KT * NT * 128 bf16, KT =
// ceil(C/16)) by `frag_idx` (the index table of that mode), then `cluster`
// CTAs per utterance, one cluster each, in `mode` 0 (3xTF32 operands), 1
// (bf16 operands, f32 activations) or 2 (bf16 operands and activations).
// Returns the cudaError_t of the launches (0 = success); a shape or mode the
// kernel does not take is cudaErrorInvalidValue.
extern "C" int res_stack_forward(const float* x, const float* w_all, const int* frag_idx,
                                 const float* bn_scale, const float* bn_offset,
                                 const float* dense_w, const float* dense_b, float* out, float* wpack,
                                 int batch, int C, int H, int W, int L, int n_labels, int cluster,
                                 int mode, void* stream) {
  if (C < 1 || C > MAX_C || cluster < 1 || cluster > MAX_CLUSTER || cluster > H || L < 1 || mode < 0 ||
      mode > 2 || ((H + cluster - 1) / cluster * W + 15) / 16 > WARPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NT = (C + 7) / 8, KT = (C + 15) / 16;
  if (mode != 0) {
    const int n_pack = L * 9 * KT * NT * 128;
    res_stack_pack_bf16<<<(n_pack + 255) / 256, 256, 0, s>>>(w_all, frag_idx, reinterpret_cast<__nv_bfloat16*>(wpack),
                                                             C, KT * NT * 128, L);
  } else {
    const int n_pack = L * 9 * NT * NT * 64;
    res_stack_pack<Tf32x3><<<(n_pack + 255) / 256, 256, 0, s>>>(w_all, frag_idx, wpack, C, NT, L);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (NT) {
#define CASE(nt) \
  case nt: \
    return mode == 2   ? launch<Bf16Act, nt>(x, wpack, bn_scale, bn_offset, dense_w, dense_b, out, batch, C, H, W, L, \
                                             n_labels, cluster, s) \
           : mode == 1 ? launch<Bf16, nt>(x, wpack, bn_scale, bn_offset, dense_w, dense_b, out, batch, C, H, W, L, \
                                          n_labels, cluster, s) \
                       : launch<Tf32x3, nt>(x, wpack, bn_scale, bn_offset, dense_w, dense_b, out, batch, C, H, W, L, \
                                            n_labels, cluster, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
