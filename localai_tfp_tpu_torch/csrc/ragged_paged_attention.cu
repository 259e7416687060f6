// Ragged paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry
// point (bound with ctypes by ops/ragged_paged_attention.py).
//
// Replaces: localai_tfp_tpu/ops/ragged_paged_attention.py::_ragged_kernel
// (pallas_call in ragged_paged_attention). It computes the same function:
// causal GQA attention, with an optional uniform sliding window, for each
// row's q_lens[b] queries at absolute positions pos0[b] + t, reading only
// that row's live pages of the [L, n_pages, page, F] arena through its
// page table. int8 pages are dequantized by their per-token f32 scales;
// seeded (T == 1) rows take the current token's exact K/V from seed_k /
// seed_v instead of its (possibly quantized) arena copy. Pad queries
// (t >= q_lens[b]) write 0.
//
// What bounds it on an H100 SXM: a decode row (q_len 1) reads every live
// K/V byte of its context once and does 4 * group flops per byte pair, so
// decode is bound by the bytes of live pages over 3.35 TB/s. A long prefill
// chunk does O(T * ctx * Dh) flops over O(ctx * Dh) bytes and is bound by
// the tensor-core rate (989 TF/s bf16).
//
// Design. The TPU kernel ran one grid step per batch row with the whole
// row's [Hkv*G, Dh] queries and whole [page, F] pages in VMEM. Neither fits
// a Hopper SM (one bf16 page at F = 1024 is 512 KB against 227 KB of shared
// memory; a 512-token chunk has 2048 query rows per kv head). So:
// - grid (B, Hkv, ceil(G / BQ)) with G = group * T: the group query heads
//   of one kv head share every K/V tile, and long chunks split over
//   blockIdx.z. Each block loads its own q_len, pos0 and table row.
// - the block walks kv positions in tiles of 64 tokens x Dh of its kv head
//   (K/V dequantized to f32 in shared memory), from the first position the
//   block's earliest query can see (sliding window) to the last position
//   its latest valid query sees (causal): pages beyond are never read.
// - online softmax in f32, with the TPU kernel's mask
//   kvrow <= qpos & t < q_len & kvrow > qpos - window.
// - logits and P @ V are plain f32 FMA on CUDA cores. That is far from the
//   tensor-core rate for long prefill chunks; wgmma/TMA tiles and split-K
//   over pages for long decode rows are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kBK = 64;        // kv tokens per tile
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// 8 consecutive elements -> f32 (callers guarantee 8-element alignment)
template <typename T>
struct Load8;

template <>
struct Load8<float> {
  __device__ __forceinline__ static void run(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

template <>
struct Load8<__nv_bfloat16> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Load8<int8_t> {
  __device__ __forceinline__ static void run(const int8_t* p, float* o) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
  }
};

struct Params {
  const void* q;        // [B, Hkv * G, DH] QT, row (g * T + t) per kv head
  const void* ck;       // [L, n_arena_pages, page, Hkv * DH] KT
  const void* cv;
  const float* ks;      // [L, n_arena_pages, page] or null (non-int8)
  const float* vs;
  const void* seed_k;   // [B, Hkv * DH] QT or null (not seeded)
  const void* seed_v;
  const int* page_table;  // [B, max_pages]
  const int* pos0;        // [B]
  const int* q_lens;      // [B]
  float* out;             // [B, Hkv * G, DH]
  int T, Hkv, group, n_arena_pages, page, max_pages, layer, window;
  float scale;
};

template <int DH, int BQ>
constexpr size_t smem_floats() {
  return (size_t)BQ * DH          // Q tile
         + (size_t)kBK * (DH + 4)  // K tile (rows padded: float4, no conflicts)
         + (size_t)kBK * DH        // V tile
         + (size_t)BQ * kBK;       // P tile
}

template <typename QT, typename KT, int DH, int BQ>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const Params p) {
  constexpr int RQ = BQ / 16;   // query rows per thread
  constexpr int CS = kBK / 16;  // score columns per thread
  constexpr int CO = DH / 16;   // output columns per thread
  constexpr int KST = DH + 4;   // padded K row stride (floats)
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DH;
  float* Vs = Ks + kBK * KST;
  float* Ps = Vs + kBK * DH;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int T = p.T;
  const int G = p.group * T;
  const int F = p.Hkv * DH;
  const int qlen = p.q_lens[b];
  const int p0 = p.pos0[b];
  const bool seeded = p.seed_k != nullptr;

  // range of query offsets t held by this block's rows (row = g * T + t)
  const int r_last = min(r0 + BQ, G) - 1;
  int t_lo = 0, t_hi = T - 1;
  if (r_last - r0 + 1 < T && (r0 % T) <= (r_last % T)) {
    t_lo = r0 % T;
    t_hi = r_last % T;
  }
  t_hi = min(t_hi, qlen - 1);
  // kv positions [kv_begin, kv_end) that any valid query of the block sees
  const int kv_end = (t_lo <= t_hi) ? p0 + t_hi + 1 : 0;
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, p0 + t_lo + 1 - p.window);
  kv_begin = (kv_begin / kBK) * kBK;

  // query tile -> shared memory (f32)
  const QT* qb = reinterpret_cast<const QT*>(p.q) +
                 ((size_t)b * p.Hkv * G + (size_t)h * G) * DH;
  for (int i = tid; i < BQ * (DH / 8); i += kThreads) {
    const int row = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    float v[8];
    if (r0 + row < G) {
      Load8<QT>::run(qb + (size_t)(r0 + row) * DH + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[row * DH + c + e] = v[e];
  }

  int qpos[RQ];
  bool qvalid[RQ];
  float m[RQ], l[RQ], acc[RQ][CO];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = r0 + ty * RQ + i;
    const int t = r % T;
    qpos[i] = p0 + t;
    qvalid[i] = r < G && t < qlen;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  const size_t layer_off = (size_t)p.layer * p.n_arena_pages * p.page;
  const KT* kbase = reinterpret_cast<const KT*>(p.ck) + layer_off * F + h * DH;
  const KT* vbase = reinterpret_cast<const KT*>(p.cv) + layer_off * F + h * DH;
  const int* pt = p.page_table + (size_t)b * p.max_pages;

  for (int s0 = kv_begin; s0 < kv_end; s0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * (DH / 8); i += kThreads) {
      const int j = i / (DH / 8);
      const int c = (i % (DH / 8)) * 8;
      const int kvrow = s0 + j;
      float kf[8], vf[8];
      if (kvrow < kv_end && seeded && kvrow == p0) {
        // the current token's exact row (decode contract, T == 1)
        const size_t o = (size_t)b * F + h * DH + c;
        Load8<QT>::run(reinterpret_cast<const QT*>(p.seed_k) + o, kf);
        Load8<QT>::run(reinterpret_cast<const QT*>(p.seed_v) + o, vf);
      } else if (kvrow < kv_end) {
        const int lp = min(kvrow / p.page, p.max_pages - 1);
        const int phys = pt[lp];
        const int off = kvrow - lp * p.page;
        const size_t o = ((size_t)phys * p.page + off) * F + c;
        Load8<KT>::run(kbase + o, kf);
        Load8<KT>::run(vbase + o, vf);
        if (p.ks != nullptr) {
          const size_t so = layer_off + (size_t)phys * p.page + off;
          const float a = p.ks[so];
          const float bsc = p.vs[so];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kf[e] *= a;
            vf[e] *= bsc;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[j * KST + c + e] = kf[e];
        Vs[j * DH + c + e] = vf[e];
      }
    }
    __syncthreads();

    // logits: rows ty*RQ + i, kv columns tx + 16 * j of the tile
    float s[RQ][CS];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * RQ + i) * DH + d]);
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * KST + d]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv.x, a);
          a = fmaf(qv[i].y, kv.y, a);
          a = fmaf(qv[i].z, kv.z, a);
          a = fmaf(qv[i].w, kv.w, a);
          s[i][j] = a;
        }
      }
    }

    // online softmax per query row; a row's 16 lanes sit in one half-warp
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      bool ok[CS];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int kvrow = s0 + tx + 16 * j;
        ok[j] = qvalid[i] && kvrow <= qpos[i] &&
                (p.window <= 0 || kvrow > qpos[i] - p.window);
        s[i][j] = ok[j] ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += pj;
        Ps[(ty * RQ + i) * kBK + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's P values come from its own half-warp

    // acc += P @ V: output columns tx + 16 * c
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float pk[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pk[i] = Ps[(ty * RQ + i) * kBK + k];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float v = Vs[k * DH + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(pk[i], v, acc[i][c]);
      }
    }
  }

  float* ob = p.out + ((size_t)b * p.Hkv * G + (size_t)h * G) * DH;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = r0 + ty * RQ + i;
    if (r >= G) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CO; ++c) ob[(size_t)r * DH + tx + 16 * c] = acc[i][c] / den;
  }
}

template <typename QT, typename KT, int DH, int BQ>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto kern = ragged_paged_attention_kernel<QT, KT, DH, BQ>;
  const size_t smem = smem_floats<DH, BQ>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int G = p.group * p.T;
  dim3 grid(B, p.Hkv, (G + BQ - 1) / BQ);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT, int DH>
cudaError_t launch_bq(const Params& p, int B, cudaStream_t stream) {
  // decode rows (G = group) waste fewer lanes with 16-row query tiles
  if (p.group * p.T <= 16) return launch<QT, KT, DH, 16>(p, B, stream);
  return launch<QT, KT, DH, 64>(p, B, stream);
}

template <typename QT, typename KT>
cudaError_t launch_dh(const Params& p, int B, int dh, cudaStream_t stream) {
  if (dh == 128) return launch_bq<QT, KT, 128>(p, B, stream);
  if (dh == 64) return launch_bq<QT, KT, 64>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted.
int rpa_forward(const void* q, const void* ck, const void* cv, const void* ks,
                const void* vs, const void* seed_k, const void* seed_v,
                const void* page_table, const void* pos0, const void* q_lens,
                void* out, int B, int T, int Hkv, int group, int dh,
                int n_arena_pages, int page, int max_pages, int layer,
                int window, float scale, int q_dtype, int kv_dtype,
                void* stream) {
  Params p;
  p.q = q;
  p.ck = ck;
  p.cv = cv;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.seed_k = seed_k;
  p.seed_v = seed_v;
  p.page_table = static_cast<const int*>(page_table);
  p.pos0 = static_cast<const int*>(pos0);
  p.q_lens = static_cast<const int*>(q_lens);
  p.out = static_cast<float*>(out);
  p.T = T;
  p.Hkv = Hkv;
  p.group = group;
  p.n_arena_pages = n_arena_pages;
  p.page = page;
  p.max_pages = max_pages;
  p.layer = layer;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_dh<__nv_bfloat16, __nv_bfloat16>(p, B, dh, st);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_dh<float, float>(p, B, dh, st);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_dh<__nv_bfloat16, int8_t>(p, B, dh, st);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_dh<float, int8_t>(p, B, dh, st);
  return cudaErrorInvalidValue;
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
