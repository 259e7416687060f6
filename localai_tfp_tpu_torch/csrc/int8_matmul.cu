// Weight-only int8 matrix product for Hopper (sm_90a), CUDA C++ with a plain
// C entry point (bound with ctypes by ops/int8_matmul.py).
//
// Replaces: localai_tfp_tpu/ops/int8_matmul.py::_kernel (pallas_call in
// int8_matmul). It computes the same function:
//   y[M, N] = cast_out((sum_k x[m, k] * float(q[k, n])) * scale[n])
// with x bf16 or f32 [M, K] row-major, q int8 [K, N] row-major (the serving
// [in, out] layout), scale f32 [N] (one per output channel), the sum in f32
// and the scale applied once to the f32 sum. out is bf16 or f32.
//
// What bounds it on an H100 SXM: at decode (M = 8) it reads K * N weight
// bytes once and does 2 * M flops per byte, so it is bound by those bytes
// over 3.35 TB/s. At M = 1024 each weight byte carries 2048 flops, above the
// card's ridge of ~295 flops per byte: bound by the bf16 tensor-core rate.
//
// The TPU kernel's grid (N / 512, K / 512) carried a whole-M f32
// accumulator in VMEM across sequential K steps. Hopper blocks run in
// parallel and in no order, so a block owns one output tile and loops over
// its K range itself. Where too few output tiles exist to fill 132 SMs,
// K splits over blockIdx.z: each split writes its f32 partial tile to a
// workspace [splits, M, N] and a second small kernel sums the splits in a
// fixed order, applies the scale and casts (the result does not depend on
// the order blocks finish in; no workspace is zeroed first). With one
// split the first kernel applies the scale and casts itself. The wrapper's
// plan picks the instance, its tile and the splits from static shapes.
//
// Three instances:
// - i8mm_mma<BM> (bf16 x, M > 16; BM 64 for M <= 64, else 128): the
//   mixed-step instance, bound by operations. A block owns a [BM, 128]
//   tile and walks K in steps of 64 with 8 warps, each holding a
//   (BM / 2) x 32 tile of mma.sync.m16n8k16 bf16 -> f32 accumulators.
//   What it does about the faults of the first design (one tile loaded,
//   barrier, products, barrier; 64-row tiles of WMMA fragments):
//   1. no pipeline: a 3-stage ring of 16-byte cp.async.cg copies: step
//      k + 2's copies are in flight while step k's products run, with one
//      barrier per K step;
//   2. the 48 KB static limit: the ring is dynamic shared memory, sized
//      with cudaFuncSetAttribute (112 KB at BM 128, 85 KB at BM 64; two
//      blocks per SM either way: 3 stages rather than 4, because a fourth
//      stage (138 KB at BM 128) leaves room for one block per SM, and one
//      block of 8 warps hides latency worse than two);
//   3. small warp tiles: a warp's 64 x 32 tile (BM 128) reuses each A
//      fragment across 4 n8 tiles and each B fragment across 4 m16 tiles,
//      both loaded with ldmatrix (.trans for the [K, N] weight) from rows
//      padded by 16 bytes, so the loads are free of bank conflicts;
//   4. exposed int8 latency: the weight stays 1 byte per element until it
//      is in shared memory (8 KB per stage); it is widened to bf16 once per
//      tile there (exact: 2^23 + byte as f32 by a byte permute, one
//      subtract, the upper half kept) into the second of two widened
//      tiles, right after step k's products, so a warp widens tile k + 1
//      while the block's other warps, and the SM's other block, still run
//      their products (this measured faster than interleaving a quarter
//      of the widening between each k16 slice of the products);
//   5. the epilogue round trip: the scale is read once per column pair and
//      applied to the accumulators in registers, which are stored as packed
//      bf16x2 / float2 (split partials likewise, unscaled, to the workspace).
//   The grid runs the M tiles of one column block next to each other, so a
//   weight tile is read from device memory once and x stays in the L2.
//   What holds it back now is shared memory, not the tensor cores: a
//   128 x 128 x 64 step moves ~144 KB through it (96 KB of ldmatrix
//   fragments, 24 KB of widening, 24 KB of cp.async), ~1150 cycles at 128
//   bytes a cycle against ~1000 for its 512 MMAs. Next: wgmma fed by TMA,
//   which reads its operands from shared memory without the register
//   round trip, and a persistent schedule over the tiles.
// - i8mm_bf16<16> (bf16 x, M <= 16): the decode instance, bound by weight
//   bytes. 16-row tiles, K split until about four blocks per SM; int8 read
//   with 16-byte loads, widened to bf16 in registers while staged into
//   shared memory, 16x16x16 WMMA tiles.
// - i8mm_f32<16|64> (f32 x, the f32 test models): f32 FMA on CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 128;       // output columns per block
constexpr int kKStep = 64;     // the K granularity of a split (both paths)

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* x;
  const int8_t* q;
  const float* scale;
  void* y;
  float* ws;  // [splits, M, N] partial sums, or null with one split
  int M, N, K;
  int k_split;  // K elements per split (a multiple of kKStep)
  int out_bf16;
};

__device__ __forceinline__ void store_out(void* y, size_t i, float v,
                                          int out_bf16) {
  if (out_bf16)
    static_cast<bf16*>(y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(y)[i] = v;
}

// One finished f32 sum: this split's partial into the workspace, or the
// scaled and cast output when K is not split.
__device__ __forceinline__ void emit(const Args& a, int m, int n, float v) {
  const size_t i = static_cast<size_t>(m) * a.N + n;
  if (a.ws != nullptr)
    a.ws[static_cast<size_t>(blockIdx.z) * a.M * a.N + i] = v;
  else
    store_out(a.y, i, v * a.scale[n], a.out_bf16);
}

// byte j of w, sign-extended, as f32
__device__ __forceinline__ float byte_f(uint32_t w, int j) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * j)) >> 24);
}

// bytes j and j + 1 of w as two packed bf16 (low half first). An integer
// of magnitude <= 127 has at most 7 significant bits, so its f32 bits end
// in 16 zero bits and the upper half is its exact bf16.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t w, int j) {
  return (__float_as_uint(byte_f(w, j)) >> 16) |
         (__float_as_uint(byte_f(w, j + 1)) & 0xffff0000u);
}

// ---- the mixed-step instance (bf16 x, M > 16): helpers as in
// ragged_paged_attention.cu (kept here: the build hashes only this file)

constexpr int kStages = 3;  // cp.async ring depth of i8mm_mma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) @ b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four int8 of w as bf16 pairs (bytes 0, 1) -> lo and (2, 3) -> hi,
// low half first, as bf16_pair gives them. Each byte b of w ^ 0x80808080
// (q + 128, unsigned) becomes the f32 2^23 + b by one byte permute; less
// 2^23 + 128 that is q exactly, and, as in bf16_pair, the upper half of an
// f32 integer of magnitude <= 128 is its exact bf16. Byte permutes and an
// f32 add run at full rate, where the int-to-float convert of byte_f runs
// at a quarter.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
  constexpr float kBias = 8388736.0f;       // 2^23 + 128
  const uint32_t f0 =
      __float_as_uint(__uint_as_float(__byte_perm(u, kMagic, 0x7650)) - kBias);
  const uint32_t f1 =
      __float_as_uint(__uint_as_float(__byte_perm(u, kMagic, 0x7651)) - kBias);
  const uint32_t f2 =
      __float_as_uint(__uint_as_float(__byte_perm(u, kMagic, 0x7652)) - kBias);
  const uint32_t f3 =
      __float_as_uint(__uint_as_float(__byte_perm(u, kMagic, 0x7653)) - kBias);
  lo = __byte_perm(f0, f1, 0x7632);
  hi = __byte_perm(f2, f3, 0x7632);
}

// Two adjacent finished f32 sums (columns n, n + 1; n even): this split's
// partials into the workspace, or the output, scaled and cast.
__device__ __forceinline__ void emit2(const Args& a, int m, int n, float v0,
                                      float v1, float2 s) {
  const size_t i = static_cast<size_t>(m) * a.N + n;
  if (a.ws != nullptr)
    *reinterpret_cast<float2*>(
        a.ws + static_cast<size_t>(blockIdx.z) * a.M * a.N + i) =
        make_float2(v0, v1);
  else if (a.out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.y) + i) =
        __floats2bfloat162_rn(v0 * s.x, v1 * s.y);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(a.y) + i) =
        make_float2(v0 * s.x, v1 * s.y);
}

template <int BM>
struct MmaCfg {
  static constexpr int BK = 64;
  static constexpr int LDA = BK + 8;   // x tile rows, padded by 16 bytes
  static constexpr int LDW = kBN + 8;  // widened weight rows, likewise
  static constexpr int WN = 4;         // warps along N (2 along M)
  static constexpr int TM = BM / 2;    // a warp's rows ...
  static constexpr int TN = kBN / WN;  // ... and columns
  static constexpr int FM = TM / 16;   // m16 tiles a warp holds
  static constexpr int FN = TN / 8;    // n8 tiles a warp holds
  static constexpr int a_bytes = BM * LDA * 2;  // bf16 x tile
  static constexpr int q_bytes = BK * kBN;      // int8 weight tile
  static constexpr int stage_bytes = a_bytes + q_bytes;
  static constexpr int w_bytes = BK * LDW * 2;  // one widened tile
  static constexpr int smem = kStages * stage_bytes + 2 * w_bytes;
  // widening passes of 8 weights a thread over one int8 tile
  static constexpr int kPasses = BK * kBN / 8 / kThreads;
  static_assert(BM == 64 || BM == 128, "row tile");
  static_assert(kStages >= 3, "widening reads one tile ahead");
};

// Grid (M / BM, N / 128, splits): the M tiles of a column block are
// neighbours in launch order, so its weight tile is read once.
template <int BM>
__global__ void __launch_bounds__(kThreads, 2) i8mm_mma(Args a) {
  using C = MmaCfg<BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* W = reinterpret_cast<bf16*>(smem + kStages * C::stage_bytes);

  const bf16* x = static_cast<const bf16*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * a.k_split;
  const int steps = (min(a.K, k_begin + a.k_split) - k_begin) / C::BK;

  // K step j's x and int8 weight tiles into ring stage j % kStages (rows
  // past M zero-filled); one commit group per step, empty past the end
  auto load = [&](int j) {
    if (j < steps) {
      unsigned char* st = smem + (j % kStages) * C::stage_bytes;
      bf16* As = reinterpret_cast<bf16*>(st);
      int8_t* Qs = reinterpret_cast<int8_t*>(st + C::a_bytes);
      const int k0 = k_begin + j * C::BK;
#pragma unroll
      for (int u = 0; u < BM * C::BK / 8 / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int r = i / (C::BK / 8), c = (i % (C::BK / 8)) * 8;
        const bool in = m0 + r < a.M;
        cp_async16(As + r * C::LDA + c,
                   x + static_cast<size_t>(in ? m0 + r : 0) * a.K + k0 + c,
                   in);
      }
#pragma unroll
      for (int u = 0; u < C::BK * kBN / 16 / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
        cp_async16(Qs + r * kBN + c,
                   a.q + static_cast<size_t>(k0 + r) * a.N + n0 + c, true);
      }
    }
    cp_async_commit();
  };
  // pass u (of 4) of widening K step j's int8 tile (landed) into bf16
  // widened tile j & 1; a thread widens 8 weights a pass, so a quarter
  // warp stores one whole 128-byte run of a row
  auto widen = [&](int j, int u) {
    const int8_t* Qs = reinterpret_cast<const int8_t*>(
        smem + (j % kStages) * C::stage_bytes + C::a_bytes);
    bf16* Wt = W + (j & 1) * C::BK * C::LDW;
    const int i = tid + u * kThreads;
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const uint2 w = *reinterpret_cast<const uint2*>(Qs + r * kBN + c);
    uint4 o;
    widen4(w.x, o.x, o.y);
    widen4(w.y, o.z, o.w);
    *reinterpret_cast<uint4*>(Wt + r * C::LDW + c) = o;
  };

  float acc[C::FM][C::FN][4];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int j = 0; j < kStages - 1; ++j) load(j);
  cp_async_wait<kStages - 2>();  // step 0 has landed
  __syncthreads();
#pragma unroll
  for (int u = 0; u < C::kPasses; ++u) widen(0, u);
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<kStages - 3>();  // step j + 1 has landed
    // the one barrier of the step: widened tile j is whole, and stage
    // (j - 1) % kStages and widened tile (j + 1) & 1 are no longer read
    __syncthreads();
    load(j + kStages - 1);
    const bf16* As =
        reinterpret_cast<const bf16*>(smem + (j % kStages) * C::stage_bytes);
    const bf16* Wt = W + (j & 1) * C::BK * C::LDW;
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      uint32_t af[C::FM][4];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        ldmatrix_x4(af[i], As + (wm * C::TM + i * 16 + (lane & 15)) * C::LDA +
                               kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < C::FN / 2; ++j2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, Wt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * C::LDW +
                    wn * C::TN + j2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < C::FM; ++i) {
          mma_bf16(acc[i][2 * j2], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j2 + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    // step j + 1's int8 tile into the other widened tile: a warp widens
    // while the block's other warps, and the SM's other block, still run
    // their products
    if (j + 1 < steps) {
#pragma unroll
      for (int u = 0; u < C::kPasses; ++u) widen(j + 1, u);
    }
  }

  // acc[i][jn] holds rows +lane/4 and +lane/4 + 8 of m16 tile i, columns
  // 2 (lane % 4) + {0, 1} of n8 tile jn
  const int r0 = m0 + wm * C::TM + (lane >> 2);
#pragma unroll
  for (int jn = 0; jn < C::FN; ++jn) {
    const int n = n0 + wn * C::TN + jn * 8 + 2 * (lane & 3);
    const float2 s = a.ws != nullptr
                         ? make_float2(1.0f, 1.0f)
                         : *reinterpret_cast<const float2*>(a.scale + n);
#pragma unroll
    for (int i = 0; i < C::FM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + i * 16 + h * 8;
        if (m < a.M)
          emit2(a, m, n, acc[i][jn][2 * h], acc[i][jn][2 * h + 1], s);
      }
  }
}

// ---- the decode instance (bf16 x, M <= 16): WMMA bf16 tiles, f32
// accumulators
template <int BM>
__global__ void __launch_bounds__(kThreads) i8mm_bf16(Args a) {
  using namespace nvcuda;
  constexpr int BK = 64;
  constexpr int LDA = BK + 8, LDB = kBN + 8, LDC = kBN + 4;  // padded rows
  constexpr int WM = BM >= 32 ? 2 : 1;   // warps along M
  constexpr int WN = 8 / WM;             // warps along N
  constexpr int FM = BM / (16 * WM);     // 16x16 fragments a warp holds
  constexpr int FN = kBN / (16 * WN);
  constexpr int kAB = (BM * LDA + BK * LDB) * 2;
  constexpr int kC = BM * LDC * 4;
  // the operand tiles and, after the K loop, the f32 output tile
  __shared__ __align__(128) unsigned char smem[kAB > kC ? kAB : kC];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const bf16* x = static_cast<const bf16*>(a.x);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * a.k_split;
  const int k_end = min(a.K, k_begin + a.k_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // x tile [BM, BK]: 8 bf16 per 16-byte load, rows past M are zero
    for (int i = tid; i < BM * BK / 8; i += kThreads) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < a.M)
        v = *reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m0 + r) * a.K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDA + c) = v;
    }
    // q tile [BK, 128]: 16 int8 per 16-byte load, upcast to bf16
    for (int i = tid; i < BK * kBN / 16; i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const uint4 w = *reinterpret_cast<const uint4*>(
          a.q + static_cast<size_t>(k0 + r) * a.N + n0 + c);
      const uint4 lo = make_uint4(bf16_pair(w.x, 0), bf16_pair(w.x, 2),
                                  bf16_pair(w.y, 0), bf16_pair(w.y, 2));
      const uint4 hi = make_uint4(bf16_pair(w.z, 0), bf16_pair(w.z, 2),
                                  bf16_pair(w.w, 0), bf16_pair(w.w, 2));
      *reinterpret_cast<uint4*>(Bs + r * LDB + c) = lo;
      *reinterpret_cast<uint4*>(Bs + r * LDB + c + 8) = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * FM + i) * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + (wn * FN + j) * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * FM + i) * 16 * LDC + (wn * FN + j) * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    if (m0 + r < a.M) emit(a, m0 + r, n0 + c, Cs[r * LDC + c]);
  }
}

// f32 x: f32 FMA. Thread (tx, ty) owns rows ty * TM .. + TM and columns
// tx * 4 .. + 4 of the block's tile; a warp shares ty, so its x reads are
// broadcasts and its q reads 16 consecutive bytes per lane.
template <int BM>
__global__ void __launch_bounds__(kThreads) i8mm_f32(Args a) {
  constexpr int BK = 32, TM = BM / 8;
  __shared__ __align__(16) float As[BM][BK + 4];
  __shared__ __align__(16) float Bs[BK][kBN];

  const float* x = static_cast<const float*>(a.x);
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * a.k_split;
  const int k_end = min(a.K, k_begin + a.k_split);
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK / 4; i += kThreads) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < a.M)
        v = *reinterpret_cast<const float4*>(
            x + static_cast<size_t>(m0 + r) * a.K + k0 + c);
      *reinterpret_cast<float4*>(&As[r][c]) = v;
    }
    for (int i = tid; i < BK * kBN / 16; i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const uint4 w = *reinterpret_cast<const uint4*>(
          a.q + static_cast<size_t>(k0 + r) * a.N + n0 + c);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(&Bs[r][c + 4 * j]) =
            make_float4(byte_f(words[j], 0), byte_f(words[j], 1),
                        byte_f(words[j], 2), byte_f(words[j], 3));
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float av = As[ty * TM + i][k];
        acc[i][0] += av * b.x;
        acc[i][1] += av * b.y;
        acc[i][2] += av * b.z;
        acc[i][3] += av * b.w;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m < a.M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) emit(a, m, n0 + tx * 4 + j, acc[i][j]);
    }
  }
}

// second pass of a split K: sum the splits in order, scale, cast
__global__ void __launch_bounds__(kThreads)
    i8mm_reduce(const float* ws, const float* scale, void* y, int M, int N,
                int splits, int out_bf16) {
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    float s = 0.0f;
    for (int p = 0; p < splits; ++p) s += ws[p * total + i];
    store_out(y, i, s * scale[i % N], out_bf16);
  }
}

// The mixed-step instance: its dynamic shared memory is set once per
// instance (the first call is eager, never under capture). occ == nullptr:
// launch; otherwise report its dynamic shared memory and resident blocks
// per SM into occ[0], occ[1] (no launch).
template <int BM>
cudaError_t launch_mma(const Args& a, dim3 grid, cudaStream_t st, int* occ) {
  auto kern = i8mm_mma<BM>;
  constexpr int smem = MmaCfg<BM>::smem;
  static const cudaError_t attr = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const cudaError_t last = cudaGetLastError();
    return e != cudaSuccess ? e : last;
  }();
  if (attr != cudaSuccess) return attr;
  if (occ != nullptr) {
    occ[0] = smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ + 1, kern,
                                                         kThreads, smem);
  }
  kern<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when every launch was accepted.
int i8mm_forward(const void* x, const void* q, const void* scale, void* y,
                 void* ws, int M, int N, int K, int bm, int splits,
                 int k_split, int x_dtype, int out_dtype, void* stream) {
  // bf16 x: bm 16 is the decode instance, 64 and 128 the mixed-step
  // instance; f32 x: bm 16 or 64
  const bool mma = x_dtype == kBF16 && (bm == 64 || bm == 128);
  const bool ok =
      M >= 1 && N % kBN == 0 && K % kKStep == 0 &&
      (mma || bm == 16 || (x_dtype == kF32 && bm == 64)) &&
      (x_dtype == kF32 || x_dtype == kBF16) &&
      (out_dtype == kF32 || out_dtype == kBF16) && splits >= 1 &&
      k_split > 0 && k_split % kKStep == 0 &&
      static_cast<long long>(splits) * k_split >= K &&
      static_cast<long long>(splits - 1) * k_split < K &&
      (ws == nullptr) == (splits == 1);
  if (!ok) return cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.q = static_cast<const int8_t*>(q);
  a.scale = static_cast<const float*>(scale);
  a.y = y;
  a.ws = static_cast<float*>(ws);
  a.M = M;
  a.N = N;
  a.K = K;
  a.k_split = k_split;
  a.out_bf16 = out_dtype == kBF16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m_tiles = (M + bm - 1) / bm;
  cudaError_t e;
  if (mma) {
    const dim3 grid(m_tiles, N / kBN, splits);
    e = bm == 64 ? launch_mma<64>(a, grid, st, nullptr)
                 : launch_mma<128>(a, grid, st, nullptr);
  } else {
    const dim3 grid(N / kBN, m_tiles, splits);
    if (x_dtype == kBF16)
      i8mm_bf16<16><<<grid, kThreads, 0, st>>>(a);
    else if (bm == 16)
      i8mm_f32<16><<<grid, kThreads, 0, st>>>(a);
    else
      i8mm_f32<64><<<grid, kThreads, 0, st>>>(a);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || splits == 1) return e;
  const size_t total = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(
      total / kThreads + 1 < 2048 ? total / kThreads + 1 : 2048);
  i8mm_reduce<<<blocks, kThreads, 0, st>>>(a.ws, a.scale, y, M, N, splits,
                                           a.out_bf16);
  return cudaGetLastError();
}

// Dynamic shared memory and resident blocks per SM of the mixed-step
// instance with bm rows (64 or 128) into out[0], out[1], for the build
// report; returns a cudaError_t code.
int i8mm_occupancy(int bm, int* out) {
  if (bm == 64) return launch_mma<64>(Args{}, dim3(), nullptr, out);
  if (bm == 128) return launch_mma<128>(Args{}, dim3(), nullptr, out);
  return cudaErrorInvalidValue;
}

const char* i8mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
