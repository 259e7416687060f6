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
// What bounds it on an H100 SXM: at decode (M <= 8) it reads K * N weight
// bytes once and does 2 * M flops per byte, so it is bound by those bytes
// over 3.35 TB/s. At M = 1024 each weight byte carries 2048 flops, above the
// card's ridge of ~295 flops per byte: bound by the bf16 tensor-core rate.
//
// Design. The TPU kernel's grid (N / 512, K / 512) carried a whole-M f32
// accumulator in VMEM across sequential K steps. Hopper blocks run in
// parallel and in no order, so:
// - a block owns one [BM, 128] output tile and loops over its K range
//   itself. BM is 16 for M <= 16 (decode rows) and 64 otherwise.
// - small M gives too few output tiles to fill 132 SMs (wk / wv at
//   N = 1024 give 8), so K splits over blockIdx.z. Each split writes its f32
//   partial tile to a workspace [splits, M, N]; a second small kernel sums
//   the splits in a fixed order, applies the scale and casts. Two passes
//   rather than f32 atomics: the result does not depend on the order blocks
//   finish in, and no workspace has to be zeroed first. With one split the
//   first kernel applies the scale and casts itself.
// - int8 weights are read with 16-byte vector loads and upcast while they
//   are staged into shared memory: to bf16 for bf16 x (exact for
//   |q| <= 127), then 16x16x16 bf16 WMMA tiles (mma.sync) with f32
//   accumulators; to f32 for f32 x, then f32 FMA on CUDA cores.
// - no TMA, no wgmma, no multi-stage pipeline yet: a block loads a tile,
//   synchronises, multiplies, synchronises. Load latency is hidden only by
//   the several blocks resident on each SM.

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

// bf16 x: WMMA bf16 tiles, f32 accumulators.
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

template <int BM>
void launch_main(const Args& a, int x_dtype, dim3 grid, cudaStream_t st) {
  if (x_dtype == kBF16)
    i8mm_bf16<BM><<<grid, kThreads, 0, st>>>(a);
  else
    i8mm_f32<BM><<<grid, kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when every launch was accepted.
int i8mm_forward(const void* x, const void* q, const void* scale, void* y,
                 void* ws, int M, int N, int K, int bm, int splits,
                 int k_split, int x_dtype, int out_dtype, void* stream) {
  const bool ok =
      M >= 1 && N % kBN == 0 && K % kKStep == 0 && (bm == 16 || bm == 64) &&
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
  const dim3 grid(N / kBN, (M + bm - 1) / bm, splits);
  if (bm == 16)
    launch_main<16>(a, x_dtype, grid, st);
  else
    launch_main<64>(a, x_dtype, grid, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t total = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(
      total / kThreads + 1 < 2048 ? total / kThreads + 1 : 2048);
  i8mm_reduce<<<blocks, kThreads, 0, st>>>(a.ws, a.scale, y, M, N, splits,
                                           a.out_bf16);
  return cudaGetLastError();
}

const char* i8mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
