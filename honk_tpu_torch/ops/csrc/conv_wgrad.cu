// Weight-gradient kernel for Hopper (sm_90a): each sample's float32 weight
// gradient of a bf16 convolution, from the bf16 input and the bf16 cotangent
// of the output, both read in place:
//
//   out[b, o, r] = sum over p of gy[b, o, p] * col[b, r, p]
//   col[b, r, p] = x[b, c, ho*sh + i*dh - ph, wo*sw + j*dw - pw], 0 outside the input,
//
// with r = (c*kh + i)*kw + j (F.unfold's column order) and p = ho*Wo + wo.
//
// It replaces no Pallas kernel: the JAX package leaves the weight gradient to
// XLA. The port needs its own because of what a data-parallel step adds: a
// rank hands back the float64 sum of its samples' float32 partials, and the
// ranks' parts must add up to the one-rank sum (ROADMAP §3). So each sample's
// partial is summed in one fixed order that depends on neither the batch size
// nor the sample's place in the batch: a CTA owns one sample's (M tile, N
// tile), walks that sample's positions in order, and nothing else adds into
// its accumulators. Every product of two bf16 values is exact in float32, so
// the partial is a float32 sum of exact products, as the float32 GEMM over
// im2col columns that it replaces computed it.
//
// Bound on this card: bytes, at res15's shapes. A 45-map conv at 101 x 40 and
// B = 64 does 9.43 GFLOP (9.5 us at 989 TFLOP/s in bf16) against about 51 MB
// (x and gy read once in bf16, the float32 partials written once): 15 us at
// 3.35 TB/s. The path it replaces moved about 1.4 GB a conv (the cotangent
// cast to float32, im2col materialised, copied again to float32, then a GEMM
// on the CUDA cores). The design keeps every intermediate out of device
// memory:
// - Grid (M tile x N tile, sample). M = C*kh*kw in 64-row tiles (res15: 405
//   rows, 7 tiles, 90% used), N = O in tiles of at most 64, padded to a
//   multiple of 8 (45 -> 48), K = the sample's Ho*Wo positions, 64 a stage.
// - The CTA copies the input channels its M tile touches (at most 8 for a 3x3
//   conv: 64.6 KB at 101 x 40) into shared memory with one bulk copy (TMA),
//   and writes a table of each position's top-left input coordinate. A rows
//   are built in registers from that copy (implicit im2col): zero outside the
//   input, dilation and stride as offsets, so no column reaches device
//   memory. The A fragment is wgmma's register operand (mma.m16n8k16's A
//   layout per warp).
// - gy[b]'s rows are the K-major B operand, stored as core matrices (8 n x 16
//   B of K, no swizzle) by cp.async in a ring of NB stages: while stage s is
//   multiplied, s + 1 and s + 2 are in flight, and s + 3 is issued into the
//   buffer s - 1 read once the stage's barrier shows every warp done with
//   it; two threads read each 32-byte sector.
// - One warpgroup multiplies with wgmma.m64nNk16 bf16 -> f32: a stage's four
//   k16 chunks are one wgmma group, each chunk into an accumulator of its own
//   (the four added in order at the end), and the next stage's A fragments
//   are built while the group runs.
// - The sums go straight to out[b] (float32); the caller sums the samples in
//   float64.
// What is left above the bound: every M tile's CTA reads its sample's whole
// gy (7 times at res15, from L2), the A fragments take about eight
// instructions an element, and each stage ends in a barrier (PERF.md §6
// splits the time among the three).
// Geometry (C, O, H, W, kernel, stride, padding, dilation) is a runtime
// argument; the N tile width is the template parameter (8 to 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128  // one warpgroup
#define KC 64        // positions a stage: four k16 chunks
#define NB 4         // B stages in shared memory: two in flight while one is multiplied, one refilled
#define INVALID_ROW (-(1 << 20))

struct Geom {
  int C, H, W, O, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw;
  int n_tiles;  // N tiles a sample's M tile
};

// wgmma D += A * B, .m64nNk16.f32.bf16.bf16, A (64 x 16) from registers, B
// (16 x N) by descriptor, D (64 x N) f32 in registers, N / 8 groups of 4 a
// thread. The trailing 0 is imm-trans-b: B is K-major.
#define WGMMA_N8 \
  __device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N16 \
  __device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N24 \
  __device__ __forceinline__ void wgmma_n24(float (&d)[12], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N32 \
  __device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N40 \
  __device__ __forceinline__ void wgmma_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N48 \
  __device__ __forceinline__ void wgmma_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N56 \
  __device__ __forceinline__ void wgmma_n56(float (&d)[28], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
#define WGMMA_N64 \
  __device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n" \
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)); \
  }
WGMMA_N8 WGMMA_N16 WGMMA_N24 WGMMA_N32 WGMMA_N40 WGMMA_N48 WGMMA_N56 WGMMA_N64

template <int NN>
__device__ __forceinline__ void wgmma(float (&d)[NN * 4], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (NN == 1) wgmma_n8(d, a, desc);
  if constexpr (NN == 2) wgmma_n16(d, a, desc);
  if constexpr (NN == 3) wgmma_n24(d, a, desc);
  if constexpr (NN == 4) wgmma_n32(d, a, desc);
  if constexpr (NN == 5) wgmma_n40(d, a, desc);
  if constexpr (NN == 6) wgmma_n48(d, a, desc);
  if constexpr (NN == 7) wgmma_n56(d, a, desc);
  if constexpr (NN == 8) wgmma_n64(d, a, desc);
}

// A k16 chunk of B in shared memory, no swizzle: NN blocks of two core
// matrices (8 n x 8 bf16 of K, 16 B a row), the two K halves 128 B apart
// (leading byte offset), the N blocks 256 B apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((a >> 4) & 0x3FFF) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// Generic-proxy stores to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, asynchronously; the bytes past src_bytes (0 or 16) are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// One bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// Shared memory, in bytes: NB B stages (NN * 1024 each), the position
// table (stages * KC * 4), the input channels (nch * H * W * 2), an
// mbarrier (16). The wrapper computes the same sum (ops/wgrad_kernel.py::plan).
template <int NN>
__global__ void __launch_bounds__(THREADS)
conv_wgrad_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ gy, float* __restrict__ out,
                  const Geom g) {
  constexpr int NT = NN * 8;
  constexpr int CHUNK_BYTES = NT * 32;           // a k16 chunk of B
  constexpr int STAGE_BYTES = CHUNK_BYTES * (KC / 16);
  constexpr int ROWS = NT * (KC / 8);            // core-matrix rows of a stage: (n, 8 positions)
  constexpr int ITEMS = (ROWS + THREADS - 1) / THREADS;
  extern __shared__ __align__(128) unsigned char smem[];

  const int P = g.Ho * g.Wo, stages = (P + KC - 1) / KC, HW = g.H * g.W;
  const int khw = g.kh * g.kw, R = g.C * khw;
  uint32_t* table = reinterpret_cast<uint32_t*>(smem + NB * STAGE_BYTES);
  uint16_t* slab = reinterpret_cast<uint16_t*>(smem + NB * STAGE_BYTES + stages * KC * 4);

  const int b = blockIdx.y;
  const int m_tile = blockIdx.x / g.n_tiles;
  const int m0 = m_tile * 64, n0 = (blockIdx.x - m_tile * g.n_tiles) * NT;
  const int c_lo = m0 / khw, nch = (min(R, m0 + 64) - 1) / khw - c_lo + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const uint16_t* gyb = gy + (size_t)b * g.O * P;
  const bool gy_vec = (P % 8 == 0) && ((reinterpret_cast<uintptr_t>(gy) & 15) == 0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(slab + ((nch * HW + 7) & ~7));

  // Stage s of B into buffer s % NB, as one cp.async group: gy[b, n0 + n, s*KC + 8*kg ...+8] for
  // n < NT, kg < KC/8, zeros past O or P. Item e is (n = (e / 2) % NT, kg = 2 * (e / 2 / NT) + e % 2):
  // two threads read one 32-byte sector of a row, and a quarter warp's stores hit 4 core-matrix rows.
  // Where gy's rows are not 16-byte aligned, plain loads and stores.
  auto load_b = [&](int s) {
    unsigned char* buf = smem + (s % NB) * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int e = tid + i * THREADS, n = (e >> 1) % NT, kg = 2 * ((e >> 1) / NT) + (e & 1);
      if (e >= ROWS) continue;
      const int o = n0 + n, p = s * KC + kg * 8;
      const bool inside = o < g.O && p < P;
      const uint16_t* src = gyb + (inside ? (size_t)o * P + p : 0);
      void* dst = buf + (kg >> 1) * CHUNK_BYTES + (n >> 3) * 256 + (kg & 1) * 128 + (n & 7) * 16;
      if (gy_vec) {
        cp_async16(dst, src, inside ? 16u : 0u);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t lo = inside && p + 2 * k < P ? src[2 * k] : 0u;
          const uint32_t hi = inside && p + 2 * k + 1 < P ? src[2 * k + 1] : 0u;
          w[k] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    cp_async_commit();  // one group a stage, empty or not, so the counts below hold
  };

  // The input channels c_lo .. c_lo + nch - 1 of sample b, one contiguous run of x: one bulk copy
  // where both ends are 16-byte aligned, else plain loads.
  const uint16_t* xsrc = x + ((size_t)b * g.C + c_lo) * HW;
  const int count = nch * HW;
  const bool x_bulk = (count & 7) == 0 && (reinterpret_cast<uintptr_t>(xsrc) & 15) == 0;
  if (x_bulk && tid == 0) bulk_load(slab, xsrc, count * 2, bar);
#pragma unroll 1
  for (int s = 0; s < NB - 1; ++s) {
    if (s < stages) load_b(s);
    else cp_async_commit();
  }
  if (!x_bulk) {
#pragma unroll 8
    for (int i = tid; i < count; i += THREADS) slab[i] = xsrc[i];
  }
  // Each position's top-left input coordinate (ys, xs), 16 bits each; past P a row no input has.
  for (int p = tid; p < stages * KC; p += THREADS) {
    int ys = -16384, xs = 0;
    if (p < P) {
      const int ho = p / g.Wo, wo = p - ho * g.Wo;
      ys = ho * g.sh - g.ph;
      xs = wo * g.sw - g.pw;
    }
    table[p] = ((uint32_t)ys << 16) | ((uint32_t)xs & 0xffffu);
  }
  // This thread's two A rows, gq and gq + 8 of its warp's 16: the tap's offset (ri, rj) and the
  // element offset of (channel, ri, rj) in the copied channels; a padding row matches no input.
  int ri[2], rj[2], roff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + warp * 16 + gq + 8 * h;
    if (r < R) {
      const int c = r / khw, tap = r - c * khw, i = tap / g.kw, j = tap - i * g.kw;
      ri[h] = i * g.dh;
      rj[h] = j * g.dw;
      roff[h] = (c - c_lo) * HW + ri[h] * g.W + rj[h];
    } else {
      ri[h] = INVALID_ROW;
      rj[h] = 0;
      roff[h] = 0;
    }
  }
  auto elem = [&](int h, int ys, int xs, int off) -> uint32_t {
    const int y = ys + ri[h], xx = xs + rj[h];
    uint32_t v = 0u;
    if ((unsigned)y < (unsigned)g.H && (unsigned)xx < (unsigned)g.W) v = slab[off + roff[h]];
    return v;
  };
  // Stage s's A fragments, chunk q in f[q]: positions 2t, 2t+1, 2t+8, 2t+9 of the chunk, A's K
  // columns in mma.m16n8k16's layout, for rows gq and gq + 8.
  auto build_a = [&](int s, uint32_t(&f)[KC / 16][4]) {
#pragma unroll
    for (int q = 0; q < KC / 16; ++q) {
      const int p = s * KC + q * 16 + 2 * t;
      const uint2 lo = *reinterpret_cast<const uint2*>(table + p);
      const uint2 hi = *reinterpret_cast<const uint2*>(table + p + 8);
      const uint32_t pos[4] = {lo.x, lo.y, hi.x, hi.y};
      int ys[4], xs[4], off[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ys[k] = static_cast<int>(pos[k]) >> 16;
        xs[k] = static_cast<int16_t>(pos[k] & 0xffffu);
        off[k] = ys[k] * g.W + xs[k];
      }
      f[q][0] = elem(0, ys[0], xs[0], off[0]) | (elem(0, ys[1], xs[1], off[1]) << 16);
      f[q][1] = elem(1, ys[0], xs[0], off[0]) | (elem(1, ys[1], xs[1], off[1]) << 16);
      f[q][2] = elem(0, ys[2], xs[2], off[2]) | (elem(0, ys[3], xs[3], off[3]) << 16);
      f[q][3] = elem(1, ys[2], xs[2], off[2]) | (elem(1, ys[3], xs[3], off[3]) << 16);
    }
  };

  __syncthreads();  // the table is in; the mbarrier is initialised
  if (x_bulk) mbar_wait(bar, 0);
  cp_async_wait<NB - 2>();  // stage 0 has landed
  fence_proxy_async();
  __syncthreads();

  // One accumulator a chunk of the stage, so a stage's four products do not wait on each other;
  // chunk q of every stage adds into acc[q], and the four are added in order at the end.
  float acc[KC / 16][NN * 4];
#pragma unroll
  for (int q = 0; q < KC / 16; ++q)
#pragma unroll
    for (int e = 0; e < NN * 4; ++e) acc[q][e] = 0.f;
  // A fragments of two stages: stage s multiplies from one while stage s + 1's are built in the
  // other, so a stage's A loads overlap the previous stage's products.
  uint32_t fa[KC / 16][4], fb[KC / 16][4];
  build_a(0, fa);
  // Stage s: its four products as one wgmma group; once this warp's part of stage s - 1's group is
  // done, stage s + 1's A is built into the fragments s - 1 read. Stage s + NB - 1 is loaded into the
  // buffer s - 1 read only after the barrier, when every warp has passed its wait for that group:
  // each warp's products read the whole of B.
  auto step = [&](int s, uint32_t(&cur)[KC / 16][4], uint32_t(&next)[KC / 16][4]) {
    const unsigned char* bt = smem + (s % NB) * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < KC / 16; ++q) wgmma<NN>(acc[q], cur[q], b_desc(bt + q * CHUNK_BYTES));
    wgmma_commit();
    wgmma_wait<1>();
    if (s + 1 < stages) build_a(s + 1, next);
    cp_async_wait<NB - 3>();  // stage s + 1 has landed (stages 0 .. s + NB - 2 are committed)
    fence_proxy_async();
    __syncthreads();
    if (s + NB - 1 < stages) load_b(s + NB - 1);
    else cp_async_commit();
  };
  for (int s = 0; s < stages; s += 2) {
    step(s, fa, fb);
    if (s + 1 < stages) step(s + 1, fb, fa);
  }
  wgmma_wait<0>();

  // acc[q][4j + 2h + e] is row gq + 8h of the warp's 16, column 8j + 2t + e.
  float* ob = out + (size_t)b * g.O * R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + warp * 16 + gq + 8 * h;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = n0 + 8 * j + 2 * t + e;
        const int k = 4 * j + 2 * h + e;
        if (o < g.O) ob[(size_t)o * R + r] = ((acc[0][k] + acc[1][k]) + acc[2][k]) + acc[3][k];
      }
  }
}

template <int NN>
static int launch(const uint16_t* x, const uint16_t* gy, float* out, const Geom& g, int batch, int m_tiles,
                  int smem, cudaStream_t stream) {
  auto kernel = conv_wgrad_kernel<NN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(m_tiles * g.n_tiles, batch), THREADS, smem, stream>>>(x, gy, out, g);
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// x (batch, C, H, W) and gy (batch, O, Ho, Wo) bf16, out (batch, O, C*kh*kw)
// float32, all contiguous; nn, m_tiles, n_tiles and smem from the wrapper's plan.
extern "C" int conv_wgrad_forward(const void* x, const void* gy, float* out, int batch, int C, int H, int W, int O,
                                  int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw, int dh, int dw,
                                  int nn, int m_tiles, int n_tiles, int smem, void* stream) {
  const Geom g = {C, H, W, O, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw, n_tiles};
  const uint16_t* xs = static_cast<const uint16_t*>(x);
  const uint16_t* gys = static_cast<const uint16_t*>(gy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nn) {
    case 1: return launch<1>(xs, gys, out, g, batch, m_tiles, smem, st);
    case 2: return launch<2>(xs, gys, out, g, batch, m_tiles, smem, st);
    case 3: return launch<3>(xs, gys, out, g, batch, m_tiles, smem, st);
    case 4: return launch<4>(xs, gys, out, g, batch, m_tiles, smem, st);
    case 5: return launch<5>(xs, gys, out, g, batch, m_tiles, smem, st);
    case 6: return launch<6>(xs, gys, out, g, batch, m_tiles, smem, st);
    case 7: return launch<7>(xs, gys, out, g, batch, m_tiles, smem, st);
    case 8: return launch<8>(xs, gys, out, g, batch, m_tiles, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
