// Res-stack kernel for Hopper (sm_90a): the eval forward of the res8 /
// res8-narrow / res26(-narrow) models from the MFCC features to the logits
// (conv0, ReLU and the average pool, the residual stack, the global mean and
// the Dense layer) in one launch, or, as the TPU kernel, from the pooled
// conv0 output. Three modes: the TPU kernel's two operand types (its
// compute_dtype) with float32 activations, float32 taken as 3xTF32 or
// bfloat16, and bfloat16 operands with bf16 activations, the dtype flow of
// flax's eval apply of a bf16 model.
//
// Replaces the TPU kernel honk_tpu/ops/res_kernel.py::_res_stack_call
// (Pallas body _make_kernel), the conv0 and pool that the JAX package's
// res_forward_fused leaves to XLA, and, in the bf16-activation mode, what
// the JAX package runs through XLA for a bf16 model's eval forward
// (honk_tpu/models/res.py, apply(train=False)). Semantics (models/res.py):
//     x = old = avg_pool(relu(conv0(feats)))                     (the stem)
//     for each layer i = 1..L:  y = relu(conv3x3_i(x))            (SAME, no bias)
//                               if i even: y += old; old = y      (pre-BN sum)
//                               x = y * scale_i + offset_i        (folded BN)
//     logits = mean_hw(x) @ dense_w + dense_b
//
// Bound on this card: the convolutions' multiply-adds. res8 is about 71.1
// MFLOP per utterance (2 x 6 layers x 25*13 pixels x 9*45 x 45) against
// 16 KB of features per utterance and 0.44 MB of weights shared by the
// batch; conv0 adds 3.2 MFLOP (100 x 39 pixels x 45 maps x 9 taps x 2) on
// the CUDA cores. Taking the stem inside keeps conv0's full-resolution map
// (12 times the pooled one) out of device memory. The convolutions run on
// the tensor cores in 3xTF32: each f32 operand x is split into big and
// small (see Tf32x3), and a product is taken as big*big + big*small +
// small*big, summed in f32. That is three tensor-core products per
// product, so the operations bound is 3 x flops / 495 TFLOP/s (dense
// TF32), and the result stays within f32 parity gates where one TF32
// product would not (tests/test_torch_kernel_design.py). In the bf16 modes
// (Bf16, Bf16Act) each product is one bf16 product: flops / 989 TFLOP/s.
//
// One thread block cluster per utterance: CTA `rank` of a cluster of `cs`
// owns the output rows [rank*H/cs, (rank+1)*H/cs) for every channel, in two
// zero-bordered channel-last activation buffers in shared memory (a 3x3
// conv cannot overwrite its input, so layers ping-pong between them) and the
// residual carry. The one-row halo above and below the band is read from
// the neighbours' shared memory (distributed shared memory) after the
// cluster barrier that ends each layer, the only barrier across CTAs. The
// wrapper picks cs from B, H, W and the mode (ops/res_kernel.py::cluster_size).
// - Prologue: with conv0's weights, each CTA computes the stem for its rows
//   and their two halo rows straight from the features (staged in the
//   second activation buffer, not yet in use): conv0 on the CUDA cores,
//   ReLU and the window's mean, in the mode's flow (Op::act: float32, or
//   bf16 with each sum and the pool's adds rounded, as flax's). Without
//   them, it loads the pooled map (the TPU kernel's interface).
// - Each conv is an implicit GEMM: M = the band's pixels in 64-pixel tiles,
//   N = C padded to NT*8, K = 9 taps x the padded channels, on four
//   warpgroups with A from registers, read straight from the activation
//   buffer, and B by descriptor from shared memory.
//   * float32 (Tf32x3): activations f32 (channel stride
//     NT*8+4, so the 32 lanes of a warp's load hit 32 banks), wgmma.m64nNk8
//     TF32, each A value split in 3 instructions; B from a ring of STAGES
//     per-tap weight stages filled by 16-byte cp.async while the taps before
//     are multiplied, a CTA barrier per tap. A warpgroup's one work item is
//     a 64-pixel M tile with all N tiles or, where a band has few M tiles,
//     a half, a third or a quarter of them; two accumulator sets (the two
//     small terms, the big one) added in the epilogue.
//   * bf16 (Bf16, Bf16Act): activations stored as bf16 (channel stride
//     KT*16+8 with KT = ceil(C/16): a tap's depth is a multiple of 16, and
//     the stride is 4 mod 8 in 32-bit words, so a warp's A loads hit 32
//     banks), so an A register is one 32-bit load of two channels and a
//     buffer is half the f32 one. A layer's weights for all 9 taps (41.5 KB
//     for 45 maps) arrive as one stage by one cp.async.bulk (TMA) that
//     completes on an mbarrier, double-buffered across layers: the next
//     layer's weights load while this one multiplies, and the K loop runs
//     over all 9 taps x KT chunks of a work item (wgmma.m64nNk16) with no
//     barrier. A warpgroup loops over work items, so a band may hold any
//     number of M tiles: res8 fits one CTA per utterance.
// - Epilogue as the reference: ReLU, the residual add on even layers with
//   `old` carried pre-BN, then the folded BN (one fmaf). The last layer's
//   outputs are not stored: each warp adds them into its channel sums, the
//   CTA's sums go to rank 0, which takes the mean and the Dense layer.
// - The mode is a template parameter. Bf16 is the TPU kernel's
//   bf16-operand mode: the conv's input is rounded to bf16 where it is
//   stored (it is read by nothing else), the carry, BN and the mean stay
//   f32, and the Dense layer takes bf16-rounded features and weights, as
//   the TPU kernel's does; its stem is float32, as the JAX package's fused
//   forward. Bf16Act multiplies as Bf16 does, but follows flax's bf16 dtype
//   flow everywhere: the stem's features and conv0 weights rounded to bf16,
//   conv0's f32 sum rounded, ReLU, the pool's adds one at a time in window
//   order, each rounded, and the division by the window's size rounded;
//   each conv's f32 sum rounded, ReLU, on even layers the bf16 carry added
//   and the sum rounded, the folded BN taken in f32 and rounded back; the
//   carry holds bf16; the mean is taken over those values in f32 and the
//   Dense layer multiplies f32 operands. Rounding is to nearest even
//   everywhere, so the kernel and ops/res_kernel.py's plain versions round
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
#define WARPS (THREADS / 32)  // float32: a CTA's band has at most WARPS * 16 pixels
#define GROUPS (WARPS / 4)    // warpgroups
#define STAGES 3              // float32: per-tap weight stages in flight
#define WBUFS 2               // bf16: per-layer weight stages (double-buffered)
#define MAX_PH 4              // the stem's largest pool window
#define MAX_PW 3
// bf16: a work item's A loads and fixed work, in N tiles' worth of products,
// in the cost of a split of N. Fit to the forced splits that
// scripts/probe_torch_res_stack.py times on an H100 (7.4 from res26 at 4 or
// 5 tiles a CTA, 10.3 from res8 at 6): below 3 the kernel split 5 or 6
// tiles' N in two, 6-16% slower than whole.
#define ITEM_COST 8

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
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((a >> 4) & 0x3FFF) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// 3xTF32 operands: x = big + small with big = x rounded to TF32 (to
// nearest, ties away) and small = x - big (exact in f32), which the tensor
// core reads as TF32 by dropping its low 13 bits; a*b = big*big + big*small
// + small*big (small*small dropped). big is rounded on the bits,
// (bits + 0x1000) & ~0x1FFF: that is cvt.rna.tf32.f32 for finite x without
// its infinity check, which compiles to a compare and a predicated add that
// stall the K loop (activations and weights here are finite). small is not
// rounded in software: |small| <= 2^-11 |x|, so the 13 bits the tensor core
// drops of it are less than 2^-21 |x|, and rounding would cost 2 more
// instructions per operand. The weights are split the same way on the host
// (ops/res_kernel.py::pack_tiles). Elem is what an activation buffer holds,
// Carry what the residual carry holds.
struct Tf32x3 {
  static constexpr bool kBf16 = false;
  static constexpr int kMode = 0;
  using Elem = float;
  using Carry = float;
  __device__ __forceinline__ static uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }
  __device__ __forceinline__ static void split(float x, uint32_t& big, uint32_t& small) {
    big = tf32(x);
    small = __float_as_uint(x - __uint_as_float(big));
  }
  __device__ __forceinline__ static float operand(float x) { return x; }  // the Dense layer's, in f32
  __device__ __forceinline__ static float act(float x) { return x; }
  __device__ __forceinline__ static Elem to_elem(float x) { return x; }
  __device__ __forceinline__ static Carry to_carry(float x) { return x; }
  __device__ __forceinline__ static float from_carry(Carry x) { return x; }
};

// bf16 operands, the TPU kernel's compute_dtype=bfloat16: each conv's
// activations and weights and the Dense layer's features and weights are
// rounded to bf16, to nearest even (as astype(bfloat16)), and multiplied
// once on the tensor cores with the sums in f32; the residual carry, BN and
// the mean stay f32. An activation buffer holds the conv's operand, so it
// is rounded where it is stored.
struct Bf16 {
  static constexpr bool kBf16 = true;
  static constexpr int kMode = 1;
  using Elem = __nv_bfloat16;
  using Carry = float;
  __device__ __forceinline__ static float operand(float x) { return bf16_round(x); }
  __device__ __forceinline__ static float act(float x) { return x; }  // activations stay f32
  __device__ __forceinline__ static Elem to_elem(float x) { return __float2bfloat16_rn(x); }
  __device__ __forceinline__ static Carry to_carry(float x) { return x; }
  __device__ __forceinline__ static float from_carry(Carry x) { return x; }
};

// bf16 operands with bf16 activations, flax's eval flow for a bf16 model:
// every activation the stem and the epilogue make (conv0's and each conv's
// output, the pool's partial sums and mean, the residual sum, BN's output)
// is rounded to bf16, to nearest even, the carry holds bf16, and the Dense
// layer multiplies the f32 mean by the f32 weights.
struct Bf16Act {
  static constexpr bool kBf16 = true;
  static constexpr int kMode = 2;
  using Elem = __nv_bfloat16;
  using Carry = __nv_bfloat16;
  __device__ __forceinline__ static float operand(float x) { return x; }
  __device__ __forceinline__ static float act(float x) { return bf16_round(x); }
  __device__ __forceinline__ static Elem to_elem(float x) { return __float2bfloat16_rn(x); }
  __device__ __forceinline__ static Carry to_carry(float x) { return __float2bfloat16_rn(x); }
  __device__ __forceinline__ static float from_carry(Carry x) { return __bfloat162float(x); }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The bf16 modes' weight stages: one mbarrier per buffer, armed with the
// stage's bytes by one thread, which then issues the bulk copy (TMA)
// that completes on it.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Shared-memory layout, in bytes (the same in every CTA, so a neighbour's
// buffer sits at the same offset in its shared memory): the weight stages,
// then the two activation buffers, then the residual carry.
struct Layout {
  // Channel stride of a pixel, in elements. float32: NT*8 + 4 floats (== 4
  // mod 8: a warp's 32 A loads hit 32 banks). bf16: KT*16 + 8 bf16 values,
  // the K chunks' padding included (KT*8 + 4 words, == 4 mod 8: a warp's
  // 32 word loads hit 32 banks).
  int S;
  int Sc;      // channel stride of the carry: S (float32), C (bf16 modes)
  int Wp;      // bordered row width W + 2
  int band;    // most rows a CTA owns: ceil(H / cs)
  int act;     // one activation buffer: (band + 2) x Wp pixels
  int old;     // residual carry: band x W pixels
  int wstage;  // one weight stage: a tap's B tiles (float32, NT K chunks x (big, small) x NT * 64 floats)
               // or a layer's (bf16, 9 taps x KT K chunks x NT * 128 values)
  int stages;
  __host__ __device__ Layout(int C, int H, int W, int cs, int mode) {
    const int NT = (C + 7) / 8, KT = (C + 15) / 16;
    Wp = W + 2;
    band = (H + cs - 1) / cs;
    if (mode == 0) {
      S = NT * 8 + 4;
      Sc = S;
      act = ((band + 2) * Wp * S + 3) / 4 * 16;
      old = band * W * S * 4;
      wstage = NT * NT * 128 * 4;
      stages = STAGES;
    } else {
      S = KT * 16 + 8;
      Sc = C;
      act = ((band + 2) * Wp * S * 2 + 15) / 16 * 16;
      old = (band * W * C * (mode == 2 ? 2 : 4) + 15) / 16 * 16;
      wstage = 9 * KT * NT * 256;
      stages = WBUFS;
    }
  }
  __host__ __device__ int bytes() const { return stages * wstage + 2 * act + old; }
};

// Epilogue of one work item of a layer: the conv's sums acc (this thread's
// pixels g and g+8 of its warp's 16 rows of the M tile, channels
// (n0+j)*8 + 2t + e) through ReLU, the residual on even layers and BN, each
// result rounded to bf16 in the Bf16Act mode (Op::act), into dst, or, on
// the last layer, into the warp's channel sums wsum.
template <class Op, int NN>
__device__ __forceinline__ void epilogue(const float (&acc)[NN * 4], int row16, int n0, int n_pix, int W,
                                         const Layout& lay, int C, bool residual, bool last,
                                         typename Op::Elem* dst, typename Op::Carry* old, const float* bn,
                                         float* wsum, int g, int t) {
  float sums[NN][2];
#pragma unroll
  for (int j = 0; j < NN; ++j) sums[j][0] = sums[j][1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = row16 + g + 8 * h;
    if (p >= n_pix) continue;
    const int yl = p / W, x = p - yl * W;
    typename Op::Elem* d = dst + ((yl + 1) * lay.Wp + x + 1) * lay.S;
    typename Op::Carry* o = old + p * lay.Sc;
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = (n0 + j) * 8 + 2 * t + e;
        if (c >= C) continue;
        float v = fmaxf(Op::act(acc[4 * j + 2 * h + e]), 0.f);
        if (residual) {
          v = Op::act(v + Op::from_carry(o[c]));
          o[c] = Op::to_carry(v);
        }
        v = Op::act(fmaf(v, bn[c], bn[MAX_C + c]));
        if (last)
          sums[j][e] += v;
        else
          d[c] = Op::to_elem(v);
      }
  }
  if (!last) return;
  // The warp's sums over its 16 rows: lanes with the same t hold the same channels.
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = sums[j][e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const int c = (n0 + j) * 8 + 2 * t + e;
      if (g == 0 && c < C) wsum[c] += s;
    }
}

template <class Op, int NT>
__global__ void __launch_bounds__(THREADS, 1)
res_stack_kernel(const float* __restrict__ x_in,       // (B, Hin, Win) features, or (B, C, H, W) pooled map
                 const float* __restrict__ w0,         // (C, 9) conv0 weights, or null: x_in is the pooled map
                 const void* __restrict__ wpack,       // (L, 9, NT, 2, NT * 64) f32 or (L, 9, KT, NT * 128) bf16 B tiles
                 const float* __restrict__ bn_scale,   // (L, C)
                 const float* __restrict__ bn_offset,  // (L, C)
                 const float* __restrict__ dense_w,    // (C, n_labels)
                 const float* __restrict__ dense_b,    // (n_labels,)
                 float* __restrict__ out,              // (B, n_labels)
                 int C, int H, int W, int L, int n_labels, int ph, int pw, int Hin, int Win, int n_parts) {
  using Elem = typename Op::Elem;
  using Carry = typename Op::Carry;
  constexpr bool BF16 = Op::kBf16;
  constexpr int KT = BF16 ? (NT + 1) / 2 : NT;  // K chunks of one tap
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int utt = blockIdx.x / cs;
  const Layout lay(C, H, W, cs, Op::kMode);
  const int S = lay.S, Wp = lay.Wp;
  const int r0 = rank * H / cs, band = (rank + 1) * H / cs - r0;
  const int row_bytes = Wp * S * (int)sizeof(Elem);
  const int n_pix = band * W, tiles = (n_pix + 63) / 64;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wbuf = smem;  // lay.stages weight stages
  unsigned char* act0b = smem + lay.stages * lay.wstage;
  Elem* act0 = reinterpret_cast<Elem*>(act0b);
  Elem* act1 = reinterpret_cast<Elem*>(act0b + lay.act);
  Carry* old = reinterpret_cast<Carry*>(act0b + 2 * lay.act);
  __shared__ float partial[MAX_CLUSTER * MAX_C];
  __shared__ float feats[MAX_C];
  __shared__ float bn[2 * MAX_C];       // the layer's BN scale, then offset
  __shared__ float wsum[WARPS * MAX_C];  // each warp's channel sums of the last layer
  __shared__ __align__(8) uint64_t wbar[WBUFS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, group = warp / 4;

  // Weights. float32: stage s = (layer s / 9, tap s % 9) into wbuf[s % STAGES]
  // by cp.async, all threads. bf16: layer l into buffer l % 2 by one bulk copy.
  const int n_stages = L * 9;
  auto load_stage = [&](int s) {
    if (s < n_stages) {
      const float4* src = reinterpret_cast<const float4*>(static_cast<const unsigned char*>(wpack) +
                                                          (long long)s * lay.wstage);
      float4* dst = reinterpret_cast<float4*>(wbuf + (s % STAGES) * lay.wstage);
      for (int e = tid; e < lay.wstage / 16; e += THREADS) cp_async16(dst + e, src + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);  // an empty group past the end keeps the count
  };
  auto load_layer = [&](int l) {  // one thread
    bulk_load(wbuf + (l % WBUFS) * lay.wstage,
              static_cast<const unsigned char*>(wpack) + (long long)l * lay.wstage, lay.wstage, &wbar[l % WBUFS]);
  };
  if constexpr (BF16) {
    if (tid == 0) {
      for (int b = 0; b < WBUFS; ++b) mbar_init(&wbar[b]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int l = 0; l < WBUFS && l < L; ++l) load_layer(l);
    }
  } else {
    for (int s = 0; s < STAGES - 1; ++s) load_stage(s);
  }

  // Zero both activation buffers (borders, halo rows outside the image and
  // the channel padding stay 0), the carry and the channel sums.
  float4* zero4 = reinterpret_cast<float4*>(act0b);
  for (int i = tid; i < (2 * lay.act + lay.old) / 16; i += THREADS) zero4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < WARPS * MAX_C; i += THREADS) wsum[i] = 0.f;
  __syncthreads();

  // Layer 0 input: the band and its halo rows (no neighbour yet), local row
  // lr = y - r0 + 1 (0 is the top halo).
  const int y_lo = max(r0 - 1, 0), y_hi = min(r0 + band + 1, H);
  if (w0 != nullptr) {
    // The stem. The features of rows y_lo*ph - 1 .. y_hi*ph (zero outside the
    // image), bordered by a zero column each side, staged in act1.
    const int Wf = Win + 2, f_lo = y_lo * ph - 1, f_rows = (y_hi - y_lo) * ph + 2;
    float* fs = reinterpret_cast<float*>(act1);
    const float* fin = x_in + (long long)utt * Hin * Win;
    for (int i = tid; i < f_rows * Wf; i += THREADS) {
      const int r = i / Wf, y = f_lo + r, x = i - r * Wf - 1;
      fs[i] = (y >= 0 && y < Hin && x >= 0 && x < Win) ? Op::act(fin[y * Win + x]) : 0.f;
    }
    __syncthreads();
    // Each thread one channel, its conv0 weights in registers, and every
    // per_c-th pooled pixel, its (ph+2) x (pw+2) feature patch in registers.
    const int per_c = THREADS / C, c = tid % C, n_px = (y_hi - y_lo) * W;
    const float window = (float)(ph * pw);
    if (tid < per_c * C) {
      float w[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) w[k] = Op::act(__ldg(w0 + c * 9 + k));
      for (int px = tid / C; px < n_px; px += per_c) {
        const int yy = px / W, x = px - yy * W;
        const float* f0 = fs + yy * ph * Wf + x * pw;
        float patch[MAX_PH + 2][MAX_PW + 2];
#pragma unroll
        for (int r = 0; r < MAX_PH + 2; ++r)
#pragma unroll
          for (int q = 0; q < MAX_PW + 2; ++q) patch[r][q] = (r < ph + 2 && q < pw + 2) ? f0[r * Wf + q] : 0.f;
        float pooled = 0.f;
#pragma unroll
        for (int a = 0; a < MAX_PH; ++a)
#pragma unroll
          for (int b = 0; b < MAX_PW; ++b) {
            if (a >= ph || b >= pw) continue;
            float s = 0.f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) s = fmaf(w[dy * 3 + dx], patch[a + dy][b + dx], s);
            const float v = fmaxf(Op::act(s), 0.f);
            pooled = (a | b) ? Op::act(pooled + v) : v;  // flax's window order, each add rounded in bf16
          }
        pooled = Op::act(pooled / window);
        const int lr = y_lo + yy - r0 + 1;
        act0[(lr * Wp + x + 1) * S + c] = Op::to_elem(pooled);
        if (lr >= 1 && lr <= band) old[((lr - 1) * W + x) * lay.Sc + c] = Op::to_carry(pooled);
      }
    }
    __syncthreads();
    float4* z1 = reinterpret_cast<float4*>(act1);  // act1 back to zeros for layer 0's output
    for (int i = tid; i < lay.act / 16; i += THREADS) z1[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    const int HW = H * W, rows = y_hi - y_lo, n = C * rows * W;
    const float* xin = x_in + (long long)utt * C * HW;
    for (int i = tid; i < n; i += THREADS) {
      const int c = i / (rows * W), rem = i - c * rows * W, yy = rem / W, x = rem - yy * W;
      const int y = y_lo + yy, lr = y - r0 + 1;
      const float v = xin[c * HW + y * W + x];
      act0[(lr * Wp + x + 1) * S + c] = Op::to_elem(v);
      if (lr >= 1 && lr <= band) old[((lr - 1) * W + x) * lay.Sc + c] = Op::to_carry(v);
    }
  }
  __syncthreads();

  // The one-row halos of layer l's output (dst) from the neighbours' own rows.
  auto halo = [&](Elem* dst) {
    unsigned char* d = reinterpret_cast<unsigned char*>(dst);
    if (rank > 0) {
      const int prev_band = r0 - (rank - 1) * H / cs;
      const float4* nb = reinterpret_cast<const float4*>(
          reinterpret_cast<unsigned char*>(cluster.map_shared_rank(dst, rank - 1)) + prev_band * row_bytes);
      float4* top = reinterpret_cast<float4*>(d);
      for (int i = tid; i < row_bytes / 16; i += THREADS) top[i] = nb[i];
    }
    if (rank + 1 < cs) {
      const float4* nb = reinterpret_cast<const float4*>(
          reinterpret_cast<unsigned char*>(cluster.map_shared_rank(dst, rank + 1)) + row_bytes);
      float4* bottom = reinterpret_cast<float4*>(d + (band + 1) * row_bytes);
      for (int i = tid; i < row_bytes / 16; i += THREADS) bottom[i] = nb[i];
    }
  };
  auto load_bn = [&](int l) {
    for (int c = tid; c < C; c += THREADS) {
      bn[c] = bn_scale[l * C + c];
      bn[MAX_C + c] = bn_offset[l * C + c];
    }
  };
  // This warp's two A rows of a 64-pixel M tile starting at row16 - (warp % 4) * 16:
  // pixels g and g+8 of its 16, as an element offset of the bordered buffer.
  auto a_rows = [&](int row16, int (&abase)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = row16 + g + 8 * h;
      if (p >= n_pix) p = 0;  // a padding row: computed, never stored
      abase[h] = ((p / W) * Wp + p % W) * S;
    }
  };

  // float32: one work item per warpgroup, 64-pixel M tile `tile` with N tiles
  // part*NN .. part*NN + NN - 1, where each M tile's NT N tiles split into
  // `parts` equal parts (the most, up to 4, with tiles x parts <= GROUPS).
  auto layers_tf32 = [&](auto nn) {
    constexpr int NN = decltype(nn)::value;
    constexpr int parts = NT / NN;
    const int tile = group / parts, n0 = (group % parts) * NN;
    const bool have = tile < tiles;
    const int row16 = tile * 64 + (warp % 4) * 16;
    int abase[2];
    a_rows(row16, abase);
    float acc[2][NN * 4];  // small*big + big*small, then big*big
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < NN * 4; ++e) acc[q][e] = 0.f;

    for (int s = 0; s < n_stages; ++s) {
      const int l = s / 9, tap = s - l * 9;
      const Elem* src = (l & 1) ? act1 : act0;
      Elem* dst = (l & 1) ? act0 : act1;
      if (tap == 0) load_bn(l);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
      __syncthreads();  // stage s landed; every warpgroup is done with stage s-1's buffer; the halo is in
      load_stage(s + STAGES - 1);

      if (have) {
        const float* wt = reinterpret_cast<const float*>(wbuf + (s % STAGES) * lay.wstage) + n0 * 64;
        const float* sa = reinterpret_cast<const float*>(src) + ((tap / 3) * Wp + tap % 3) * S + t;
        uint32_t big[2][4], small[2][4];  // A fragments, double-buffered over K chunks
#pragma unroll
        for (int kc = 0; kc < NT; ++kc) {
          const float* a = sa + kc * 8;
          uint32_t(&ab)[4] = big[kc & 1];
          uint32_t(&as)[4] = small[kc & 1];
          Tf32x3::split(a[abase[0]], ab[0], as[0]);
          Tf32x3::split(a[abase[1]], ab[1], as[1]);
          Tf32x3::split(a[abase[0] + 4], ab[2], as[2]);
          Tf32x3::split(a[abase[1] + 4], ab[3], as[3]);
          const float* b = wt + kc * 2 * NT * 64;
          wgmma_fence();
          wgmma<NN, false>(acc[0], as, b_desc(b));
          wgmma<NN, false>(acc[0], ab, b_desc(b + NT * 64));
          wgmma<NN, false>(acc[1], ab, b_desc(b));
          wgmma_commit();
          wgmma_wait<1>();  // chunk kc-1's A is free
        }
        wgmma_wait<0>();
      }
      if (tap != 8) continue;

      if (have) {
#pragma unroll
        for (int e = 0; e < NN * 4; ++e) {
          acc[0][e] += acc[1][e];  // the small terms, then the big one
          acc[1][e] = 0.f;
        }
        epilogue<Op, NN>(acc[0], row16, n0, n_pix, W, lay, C, (l & 1) != 0, l == L - 1, dst, old, bn,
                         wsum + warp * MAX_C, g, t);
#pragma unroll
        for (int e = 0; e < NN * 4; ++e) acc[0][e] = 0.f;
      }
      cluster.sync();  // every CTA's layer-l output is complete; its layer-l input is no longer read
      if (l + 1 < L) halo(dst);
    }
  };

  // bf16: a layer's weights in one stage; each warpgroup loops over the work
  // items item = group, group + GROUPS, ... of tiles x parts, where each M
  // tile's NT N tiles split into `parts` equal parts (NN = NT / parts each).
  auto layers_bf16 = [&](auto nn) {
    constexpr int NN = decltype(nn)::value;
    constexpr int parts = NT / NN;
    const int items = tiles * parts;
    for (int l = 0; l < L; ++l) {
      const Elem* src = (l & 1) ? act1 : act0;
      Elem* dst = (l & 1) ? act0 : act1;
      load_bn(l);
      mbar_wait(&wbar[l % WBUFS], (l / WBUFS) & 1);
      __syncthreads();  // BN in
      const unsigned char* wl = wbuf + (l % WBUFS) * lay.wstage;
      for (int item = group; item < items; item += GROUPS) {
        const int tile = item / parts, n0 = (item - tile * parts) * NN;
        const int row16 = tile * 64 + (warp % 4) * 16;
        int abase[2];
        a_rows(row16, abase);
        float acc[NN * 4];
#pragma unroll
        for (int e = 0; e < NN * 4; ++e) acc[e] = 0.f;
        uint32_t frag[2][4];  // A fragments, double-buffered over K chunks
        // Rows g and g+8 of the warp's 16, K values 2t, 2t+1 and 2t+8, 2t+9 of each chunk.
#pragma unroll
        for (int q = 0; q < 9 * KT; ++q) {
          const int tap = q / KT, kc = q - tap * KT;
          const Elem* a = src + ((tap / 3) * Wp + tap % 3) * S + kc * 16 + 2 * t;
          uint32_t(&f)[4] = frag[q & 1];
          f[0] = *reinterpret_cast<const uint32_t*>(a + abase[0]);
          f[1] = *reinterpret_cast<const uint32_t*>(a + abase[1]);
          f[2] = *reinterpret_cast<const uint32_t*>(a + abase[0] + 8);
          f[3] = *reinterpret_cast<const uint32_t*>(a + abase[1] + 8);
          wgmma_fence();
          wgmma<NN, true>(acc, f, b_desc(wl + ((tap * KT + kc) * NT + n0) * 256));
          wgmma_commit();
          wgmma_wait<1>();  // chunk q-1's A is free
        }
        wgmma_wait<0>();
        epilogue<Op, NN>(acc, row16, n0, n_pix, W, lay, C, (l & 1) != 0, l == L - 1, dst, old, bn,
                         wsum + warp * MAX_C, g, t);
      }
      cluster.sync();  // every CTA's layer-l output is complete; its layer-l input and weights are no longer read
      if (tid == 0 && l + WBUFS < L) load_layer(l + WBUFS);
      if (l + 1 < L) halo(dst);
    }
  };

  if constexpr (BF16) {
    // The split of N with the least cost, counted as rounds of work items
    // over the warpgroups, each round as its N tiles plus ITEM_COST for an
    // item's A loads and fixed work; or the caller's n_parts (> 0, checked
    // to divide NT by the host entry).
    int parts = n_parts, best = 1 << 30;
    for (int p = 1; p <= 4 && n_parts == 0; ++p) {
      if (NT % p != 0) continue;
      const int cost = (tiles * p + GROUPS - 1) / GROUPS * (NT / p + ITEM_COST);
      if (cost < best) best = cost, parts = p;
    }
    switch (parts) {
      case 1: layers_bf16(std::integral_constant<int, NT>{}); break;
      case 2: layers_bf16(std::integral_constant<int, (NT % 2 == 0 ? NT / 2 : NT)>{}); break;
      case 3: layers_bf16(std::integral_constant<int, (NT % 3 == 0 ? NT / 3 : NT)>{}); break;
      default: layers_bf16(std::integral_constant<int, (NT % 4 == 0 ? NT / 4 : NT)>{}); break;
    }
  } else {
    int parts = 1;
    for (int p = 2; p <= 4; ++p)
      if (NT % p == 0 && tiles * p <= GROUPS) parts = p;
    switch (parts) {
      case 1: layers_tf32(std::integral_constant<int, NT>{}); break;
      case 2: layers_tf32(std::integral_constant<int, (NT % 2 == 0 ? NT / 2 : NT)>{}); break;
      case 3: layers_tf32(std::integral_constant<int, (NT % 3 == 0 ? NT / 3 : NT)>{}); break;
      default: layers_tf32(std::integral_constant<int, (NT % 4 == 0 ? NT / 4 : NT)>{}); break;
    }
  }

  // Mean over the image: each CTA sums its warps' sums, rank 0 gathers the CTAs'.
  float* partial0 = cluster.map_shared_rank(partial, 0);
  for (int c = tid; c < C; c += THREADS) {
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += wsum[w * MAX_C + c];
    partial0[rank * MAX_C + c] = sum;
  }
  cluster.sync();
  if (rank != 0) return;
  for (int c = tid; c < C; c += THREADS) {
    float sum = 0.f;
    for (int r = 0; r < cs; ++r) sum += partial[r * MAX_C + c];
    feats[c] = sum / (float)(H * W);
  }
  __syncthreads();
  for (int j = tid; j < n_labels; j += THREADS) {
    float a = 0.f;
    for (int c = 0; c < C; ++c) a = fmaf(Op::operand(feats[c]), Op::operand(dense_w[c * n_labels + j]), a);
    out[(long long)utt * n_labels + j] = a + dense_b[j];
  }
}

template <class Op, int NT>
static int launch(const float* x, const float* w0, const void* wpack, const float* bn_scale,
                  const float* bn_offset, const float* dense_w, const float* dense_b, float* out, int batch, int C,
                  int H, int W, int L, int n_labels, int cluster, int ph, int pw, int Hin, int Win, int n_parts,
                  cudaStream_t stream) {
  auto kernel = res_stack_kernel<Op, NT>;
  const int smem = Layout(C, H, W, cluster, Op::kMode).bytes();
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
  err = cudaLaunchKernelEx(&cfg, kernel, x, w0, wpack, bn_scale, bn_offset, dense_w, dense_b, out, C, H, W, L,
                           n_labels, ph, pw, Hin, Win, n_parts);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches on `stream` `cluster` CTAs per utterance, one cluster each, in
// `mode` 0 (3xTF32 operands), 1 (bf16 operands, f32 activations) or 2 (bf16
// operands and activations), on the B tiles `wpack` that
// ops/res_kernel.py::pack_tiles made for the mode. With `w0` (conv0's
// (C, 1, 3, 3) weights) `x` is (batch, Hin, Win) features and the kernel
// runs the stem with a ph x pw pool (H = Hin / ph, W = Win / pw); without,
// `x` is the (batch, C, H, W) pooled map. In the bf16 modes `n_parts` > 0
// sets how many parts each M tile's N tiles split into (a divisor of
// ceil(C / 8), at most 4) in place of the kernel's cost; 0 everywhere else
// (scripts/probe_torch_res_stack.py compares them). Returns the cudaError_t
// of the launch (0 = success); a shape or mode the kernel does not take is
// cudaErrorInvalidValue.
extern "C" int res_stack_forward(const float* x, const float* w0, const void* wpack, const float* bn_scale,
                                 const float* bn_offset, const float* dense_w, const float* dense_b, float* out,
                                 int batch, int C, int H, int W, int L, int n_labels, int cluster, int mode, int ph,
                                 int pw, int Hin, int Win, int n_parts, void* stream) {
  if (C < 1 || C > MAX_C || cluster < 1 || cluster > MAX_CLUSTER || cluster > H || L < 1 || mode < 0 ||
      mode > 2 || (mode == 0 && ((H + cluster - 1) / cluster * W + 15) / 16 > WARPS) || n_parts < 0 ||
      n_parts > 4 || (n_parts > 0 && (mode == 0 || ((C + 7) / 8) % n_parts != 0)))
    return (int)cudaErrorInvalidValue;
  if (w0 != nullptr) {  // the stem's features fit the second activation buffer
    const Layout lay(C, H, W, cluster, mode);
    if (ph < 1 || pw < 1 || ph > MAX_PH || pw > MAX_PW || Hin / ph != H || Win / pw != W ||
        ((lay.band + 2) * ph + 2) * (Win + 2) * 4 > lay.act)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 7) / 8) {
#define CASE(nt) \
  case nt: \
    return mode == 2   ? launch<Bf16Act, nt>(x, w0, wpack, bn_scale, bn_offset, dense_w, dense_b, out, batch, C, H, W, \
                                             L, n_labels, cluster, ph, pw, Hin, Win, n_parts, s) \
           : mode == 1 ? launch<Bf16, nt>(x, w0, wpack, bn_scale, bn_offset, dense_w, dense_b, out, batch, C, H, W, L, \
                                          n_labels, cluster, ph, pw, Hin, Win, n_parts, s) \
                       : launch<Tf32x3, nt>(x, w0, wpack, bn_scale, bn_offset, dense_w, dense_b, out, batch, C, H, W, \
                                            L, n_labels, cluster, ph, pw, Hin, Win, n_parts, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
