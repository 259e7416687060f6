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
// (t >= q_lens[b]) write 0. Queries are read from [B, T, H, Dh] through
// their strides and the output is written as [B, T, H * Dh] f32.
//
// What bounds it on an H100 SXM, and what the design does about it:
// - Decode and verify rows read every live K/V byte of their context once
//   and do 4 * group flops per byte pair: bound by live K/V bytes over
//   3.35 TB/s. Eight rows x eight kv heads make 64 (row, kv head) pairs on
//   132 SMs, so each pair also splits its kv range into chunks of
//   split_len tokens (flash decoding; the wrapper's plan picks split_len
//   from static shapes only). Blocks whose split holds no position the
//   tile sees exit at once (every block of the tile derives the same live
//   range from pos0 / q_lens on the device); a tile with one live split
//   writes its output directly. Otherwise each live split writes partial
//   (m, l, acc); the last of them to finish, told by a counter that it
//   resets, merges the partials in split order, so the output is
//   bitwise the same from run to run. Within a block the four
//   warps take disjoint 16-token columns of each 64-token tile and are
//   merged in warp order at the end.
// - Long prefill chunks do O(T * ctx * Dh) flops over O(ctx * Dh) bytes:
//   bound by the tensor-core rate (989 TF/s bf16). A query tile is 16
//   positions x the group's query heads (64 rows for group 4), so every
//   K/V tile is read once for the whole GQA group, and Q.K^T and P.V run
//   as mma.sync.m16n8k16 bf16 -> f32 from ldmatrix fragments. P.V takes P
//   as bf16(P) + bf16(P - bf16(P)), two MMAs into one f32 accumulator, so
//   the product keeps ~16 bits of P (a single bf16 P errs by up to 2^-9
//   of a dominant weight). int8 K/V are exact in bf16: the k-scale
//   multiplies the logits after the product and the v-scale is folded
//   into P before the split, as the TPU kernel does.
// - K/V tiles are gathered through the page table into shared memory in
//   their stored type (bf16 or int8 + f32 scales) with 16-byte cp.async
//   in a two-stage ring: the next tile's copies are in flight while the
//   current one computes. cp.async (not a TMA box) because a 64-token
//   tile may span pages (any page size). A bf16 block at Dh 128 uses
//   ~87 KB of shared memory, so two blocks fit on an SM.
// - f32 queries (the f32 test models) keep exact f32 FMA tile math in the
//   same split, ring and fragment layout; only bf16 queries use MMAs.
// - The seeded current token is masked out of the tile products and added
//   in f32 from seed_k / seed_v: its logit is q . seed_k, computed once
//   per block, and its value row is added with the softmax weight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBN = 64;        // kv tokens per tile
constexpr int kStages = 2;     // cp.async ring depth
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Params {
  const void* q;          // [B, T, H, DH] QT with element strides below
  long long sqb, sqt, sqh;
  const void* ck;         // [L, n_arena_pages, page, Hkv * DH] KT
  const void* cv;
  const float* ks;        // [L, n_arena_pages, page] or null (non-int8)
  const float* vs;
  const void* seed_k;     // [B, Hkv * DH] QT or null (not seeded)
  const void* seed_v;
  const int* page_table;  // [B, max_pages]
  const int* pos0;        // [B]
  const int* q_lens;      // [B]
  float* out;             // [B, T, H * DH]
  float* part_acc;        // [B, Hkv, qtiles, splits, BM, DH] (splits > 1)
  float* part_ml;         // [B, Hkv, qtiles, splits, BM, 2]
  int* counters;          // [B * Hkv * qtiles], zero between launches
  int T, Hkv, group, n_arena_pages, page, max_pages, layer, window;
  int qtiles, splits, split_len;
  float scale;
};

template <typename QT, typename KT, int DH, int BM>
struct Cfg {
  static constexpr bool kMma = std::is_same<QT, __nv_bfloat16>::value;
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr int WN = BM == 16 ? 4 : 1;  // warps across kv columns
  static constexpr int CW = kBN / WN;          // kv columns per warp
  static constexpr int NT = CW / 8;            // 8-column S tiles per warp
  // shared rows padded by 16 bytes: ldmatrix rows fall in distinct banks
  static constexpr int QS = DH + 16 / (int)sizeof(QT);
  static constexpr int KS = DH + 16 / (int)sizeof(KT);
  static constexpr size_t q_bytes = (size_t)BM * QS * sizeof(QT);
  static constexpr size_t tile_bytes = (size_t)kBN * KS * sizeof(KT);
  static constexpr size_t stage_bytes =
      2 * tile_bytes + (kQuant ? 2 * kBN * sizeof(float) : 0);
  static constexpr size_t ring_bytes = kStages * stage_bytes;
  // bf16 queries on int8 pages: each landed tile is widened once into a
  // bf16 K/V tile (exact) that the MMA fragments are loaded from
  static constexpr int BS = DH + 8;
  static constexpr size_t conv_bytes =
      kMma && kQuant ? 2 * (size_t)kBN * BS * sizeof(__nv_bfloat16) : 0;
  // epilogue: each warp's [16, DH] acc and [16, 2] (m, l), over the ring
  static constexpr size_t epi_bytes = (4 * 16 * DH + 4 * 16 * 2) * 4;
  static constexpr size_t smem =
      q_bytes + BM * sizeof(float) +
      (ring_bytes + conv_bytes > epi_bytes ? ring_bytes + conv_bytes
                                           : epi_bytes);
  static_assert(BM == 16 || BM == 64, "query tile");
  static_assert(NT % 2 == 0, "S tiles pair into MMA k-steps");
};

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// 4 consecutive shared elements -> f32 (4-element aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

// Grid (qtiles * splits, Hkv, B). A block owns BM query rows of one
// (row b, kv head h) — row r = t * group + g, i.e. 64 / group positions
// times the group's heads (BM 64), or a decode / verify row's T * group
// rows padded to 16 (BM 16) — and the kv range of one split.
template <typename QT, typename KT, int DH, int BM>
__global__ void __launch_bounds__(kThreads, 2)
rpa_kernel(const Params p) {
  using C = Cfg<QT, KT, DH, BM>;
  constexpr int NT = C::NT, CW = C::CW, ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  QT* Qs = reinterpret_cast<QT*>(smem);
  float* seed_logit = reinterpret_cast<float*>(smem + C::q_bytes);
  unsigned char* ring = smem + C::q_bytes + BM * sizeof(float);
  float* epi = reinterpret_cast<float*>(ring);

  // the last query tiles (the most causal work) are scheduled first
  const int qt = p.qtiles - 1 - (int)blockIdx.x / p.splits;
  const int split = blockIdx.x % p.splits;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = p.group;
  const int G = p.T * group;
  const int F = p.Hkv * DH;
  const int r0 = qt * BM;
  const int qlen = p.q_lens[b];
  const int p0 = p.pos0[b];
  const bool seeded = p.seed_k != nullptr;

  // kv positions [kv_begin, kv_end) any valid query of the tile sees,
  // within the page table's reach (as the plain version's window)
  const int r_end = min(r0 + BM, G);
  const int t_lo = r0 / group;
  const int t_hi = min((r_end - 1) / group, qlen - 1);
  int kv_begin = 0, kv_end = 0;
  if (t_lo <= t_hi) {
    kv_end = min(p0 + t_hi + 1, p.max_pages * p.page);
    if (p.window > 0) kv_begin = max(0, p0 + t_lo + 1 - p.window);
  }
  // the splits that hold any of them, [first, first + live): every block
  // of the tile derives the same range, the others exit at once. One live
  // split writes the output itself; a tile with none (pad rows) is
  // written, as zeros, by split 0.
  const int first = kv_end > kv_begin ? kv_begin / p.split_len : 0;
  const int live = kv_end > kv_begin ? (kv_end - 1) / p.split_len - first + 1
                                     : 0;
  if (live == 0 ? split != 0 : (split < first || split >= first + live))
    return;
  const bool direct = live <= 1;
  // ... cut to this split's [split * split_len, (split + 1) * split_len)
  const int s_lo = split * p.split_len;
  kv_begin = max(kv_begin, s_lo);
  kv_end = min(kv_end, s_lo + p.split_len);
  const int tile0 = (kv_begin / kBN) * kBN;
  const int n_tiles = kv_end > kv_begin ? (kv_end - tile0 + kBN - 1) / kBN : 0;

  const int* pt = p.page_table + (size_t)b * p.max_pages;
  const size_t layer_tok = (size_t)p.layer * p.n_arena_pages * p.page;
  const KT* kbase = reinterpret_cast<const KT*>(p.ck) + layer_tok * F + h * DH;
  const KT* vbase = reinterpret_cast<const KT*>(p.cv) + layer_tok * F + h * DH;
  const QT* qbase = reinterpret_cast<const QT*>(p.q) + (size_t)b * p.sqb +
                    (size_t)h * group * p.sqh;

  // one 64-token K/V tile (and its scales) into ring stage st; rows outside
  // [kv_begin, kv_end) are zero-filled, never read from the arena
  auto load_tile = [&](int j, int st) {
    const int s0 = tile0 + j * kBN;
    unsigned char* base = ring + st * C::stage_bytes;
    KT* Kt = reinterpret_cast<KT*>(base);
    KT* Vt = reinterpret_cast<KT*>(base + C::tile_bytes);
    constexpr int EPC = 16 / (int)sizeof(KT);  // elements per 16 bytes
    constexpr int CPR = DH / EPC;              // 16-byte chunks per row
    for (int i = tid; i < kBN * CPR; i += kThreads) {
      const int row = i / CPR;
      const int c = (i % CPR) * EPC;
      const int kv = s0 + row;
      const bool ok = kv >= kv_begin && kv < kv_end;
      size_t off = 0;
      if (ok) {
        const int lp = kv / p.page;
        off = ((size_t)pt[lp] * p.page + (kv - lp * p.page)) * F + c;
      }
      cp_async16(Kt + row * C::KS + c, kbase + off, ok);
      cp_async16(Vt + row * C::KS + c, vbase + off, ok);
    }
    if constexpr (C::kQuant) {
      float* sc = reinterpret_cast<float*>(base + 2 * C::tile_bytes);
      const int row = tid % kBN;  // threads 0-63: k scales, 64-127: v
      const int kv = s0 + row;
      const bool ok = kv >= kv_begin && kv < kv_end;
      size_t so = 0;
      if (ok) {
        const int lp = kv / p.page;
        so = layer_tok + (size_t)pt[lp] * p.page + (kv - lp * p.page);
      }
      cp_async4(sc + tid, (tid < kBN ? p.ks : p.vs) + so, ok);
    }
  };

  // the thread's two query rows (MMA fragment rows lane/4 and lane/4 + 8)
  const int wrow = C::WN == 1 ? warp * 16 : 0;  // warp's first tile row
  const int wcol = C::WN == 1 ? 0 : warp * CW;  // warp's first tile column
  int qpos[2];
  bool qvalid[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r0 + wrow + lane / 4 + 8 * x;
    const int t = r / group;
    qvalid[x] = r < G && t < qlen;
    qpos[x] = p0 + t;
  }
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (n_tiles > 0) {
    // query tile -> shared, in the same cp.async group as the first tile
    constexpr int QEPC = 16 / (int)sizeof(QT);
    constexpr int QCPR = DH / QEPC;
    for (int i = tid; i < BM * QCPR; i += kThreads) {
      const int row = i / QCPR;
      const int c = (i % QCPR) * QEPC;
      const int r = r0 + row;
      const int t = r / group;
      const bool ok = r < G && t < qlen;
      const QT* src = qbase;
      if (ok) src += (size_t)t * p.sqt + (size_t)(r % group) * p.sqh + c;
      cp_async16(Qs + row * C::QS + c, src, ok);
    }
    load_tile(0, 0);
    cp_async_commit();
    // the seeded current token's logits, exact in f32 (T == 1: row = g)
    if (seeded && p0 >= kv_begin && p0 < kv_end) {
      const QT* sk =
          reinterpret_cast<const QT*>(p.seed_k) + (size_t)b * F + h * DH;
      for (int r = warp; r < BM; r += 4) {
        float dot = 0.f;
        if (r0 + r < G) {
          const QT* qr = qbase + (size_t)(r0 + r) * p.sqh;
          for (int d = lane; d < DH; d += 32)
            dot = fmaf(to_f32(qr[d]), to_f32(sk[d]), dot);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (lane == 0) seed_logit[r] = dot * p.scale;
      }
    }
  }

  uint32_t qf[C::kMma ? DH / 16 : 1][4];  // bf16 Q fragments (MMA path)
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(ring + C::ring_bytes);

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1, (j + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and the query tile) have landed
    __syncthreads();
    const int s0 = tile0 + j * kBN;
    const unsigned char* base = ring + (j % kStages) * C::stage_bytes;
    const KT* Kt = reinterpret_cast<const KT*>(base);
    const KT* Vt = reinterpret_cast<const KT*>(base + C::tile_bytes);
    const float* ksm = reinterpret_cast<const float*>(base + 2 * C::tile_bytes);
    const float* vsm = ksm + kBN;
    // the MMA operands: the bf16 tile as landed, or its widened int8 copy
    const __nv_bfloat16* Kb = reinterpret_cast<const __nv_bfloat16*>(Kt);
    const __nv_bfloat16* Vb = reinterpret_cast<const __nv_bfloat16*>(Vt);
    constexpr int BST = C::kQuant ? C::BS : C::KS;
    if constexpr (C::kMma && C::kQuant) {
      for (int i = tid; i < 2 * kBN * (DH / 8); i += kThreads) {
        const int v = i / (kBN * (DH / 8));
        const int row = (i / (DH / 8)) % kBN;
        const int c = (i % (DH / 8)) * 8;
        const uint2 u = *reinterpret_cast<const uint2*>(
            (v ? Vt : Kt) + row * C::KS + c);
        const int8_t* e8 = reinterpret_cast<const int8_t*>(&u);
        uint4 w;
        w.x = pack_bf16(e8[0], e8[1]);
        w.y = pack_bf16(e8[2], e8[3]);
        w.z = pack_bf16(e8[4], e8[5]);
        w.w = pack_bf16(e8[6], e8[7]);
        *reinterpret_cast<uint4*>(conv + (v * kBN + row) * C::BS + c) = w;
      }
      __syncthreads();
      Kb = conv;
      Vb = conv + kBN * C::BS;
    }

    // ---- S = Q K^T over the warp's CW columns: s[n][e] holds row
    // lane/4 + 8 * (e >> 1), column wcol + 8n + 2 (lane % 4) + (e & 1)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (C::kMma) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          ldmatrix_x4(qf[kk], Qs + (wrow + (lane & 15)) * C::QS + kk * 16 +
                                  (lane >> 4) * 8);
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t bf[4];
          ldmatrix_x4(bf, Kb + (wcol + n2 * 16 + (lane & 7) +
                                (lane >> 4) * 8) * BST +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * n2], qf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * n2 + 1], qf[kk], bf[2], bf[3]);
        }
      }
    } else {
      const float* qa =
          reinterpret_cast<const float*>(Qs) + (wrow + lane / 4) * C::QS;
      const float* qb = qa + 8 * C::QS;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const KT* kr = Kt + (wcol + n * 8 + 2 * (lane & 3) + par) * C::KS;
          float da = 0.f, db = 0.f;
#pragma unroll 2
          for (int d = 0; d < DH; d += 4) {
            const float4 kv = load4(kr + d);
            const float4 a = load4(qa + d);
            const float4 c = load4(qb + d);
            da = fmaf(a.x, kv.x, da);
            da = fmaf(a.y, kv.y, da);
            da = fmaf(a.z, kv.z, da);
            da = fmaf(a.w, kv.w, da);
            db = fmaf(c.x, kv.x, db);
            db = fmaf(c.y, kv.y, db);
            db = fmaf(c.z, kv.z, db);
            db = fmaf(c.w, kv.w, db);
          }
          s[n][par] = da;
          s[n][2 + par] = db;
        }
      }
    }

    // ---- mask, scale, online softmax (the TPU kernel's mask:
    // kv <= qpos & t < q_len & kv > qpos - window)
    const bool seed_here =
        seeded && p0 >= s0 + wcol && p0 < s0 + wcol + CW;  // warp-uniform
    // a tile that every valid query of the block sees whole needs no mask
    const bool whole = s0 + kBN - 1 <= p0 + t_lo &&
                       (p.window <= 0 || s0 > p0 + t_hi - p.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const int col = wcol + n * 8 + 2 * (lane & 3) + (e & 1);
        const int kv = s0 + col;
        const bool ok =
            qvalid[x] && (whole || (kv <= qpos[x] && (p.window <= 0 ||
                                                      kv > qpos[x] - p.window)));
        float v = s[n][e] * p.scale;
        if constexpr (C::kQuant) v *= ksm[col];
        if (seed_here && kv == p0) v = seed_logit[wrow + lane / 4 + 8 * x];
        v = ok ? v : kNegInf;
        s[n][e] = v;
        mx[x] = fmaxf(mx[x], v);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float m_new = fmaxf(m_r[x], mx[x]);
      const float alpha = __expf(m_r[x] - m_new);
      m_r[x] = m_new;
      l_r[x] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * x] *= alpha;
        acc[n][2 * x + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const float pe = s[n][e] > 0.5f * kNegInf
                             ? __expf(s[n][e] - m_r[x])
                             : 0.f;
        l_r[x] += pe;
        s[n][e] = pe;
      }
    }
    // the seeded column leaves the tile product; its weight goes to the
    // whole quad (each lane of a quad holds other output columns)
    float ps[2] = {0.f, 0.f};
    if (seed_here) {
      const int cs = p0 - s0 - wcol;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n * 8 + 2 * (lane & 3) + (e & 1) == cs) {
            ps[e >> 1] = s[n][e];
            s[n][e] = 0.f;
          }
        }
      }
      const int src = (lane & ~3) | ((cs & 7) >> 1);
      ps[0] = __shfl_sync(0xffffffffu, ps[0], src);
      ps[1] = __shfl_sync(0xffffffffu, ps[1], src);
    }

    // ---- acc += P V: acc[n][e] holds row lane/4 + 8 * (e >> 1), output
    // column 8n + 2 (lane % 4) + (e & 1)
    if constexpr (C::kMma) {
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // A regs: (n 2kk, rows lo/hi), ...
          const int n = 2 * kk + (i >> 1);
          const int e = 2 * (i & 1);
          float v0 = s[n][e], v1 = s[n][e + 1];
          if constexpr (C::kQuant) {
            const int col = wcol + n * 8 + 2 * (lane & 3);
            v0 *= vsm[col];
            v1 *= vsm[col + 1];
          }
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
          const float2 hf = __bfloat1622float2(hi);
          ahi[i] = *reinterpret_cast<const uint32_t*>(&hi);
          alo[i] = pack_bf16(v0 - hf.x, v1 - hf.y);
        }
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, Vb + (wcol + kk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * BST +
                                    n2 * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * n2], ahi, bf[0], bf[1]);
          mma_bf16(acc[2 * n2], alo, bf[0], bf[1]);
          mma_bf16(acc[2 * n2 + 1], ahi, bf[2], bf[3]);
          mma_bf16(acc[2 * n2 + 1], alo, bf[2], bf[3]);
        }
      }
    } else {
      // column c = 8n + 2q + par of the warp is held by quad lane q
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
#pragma unroll 1
          for (int q = 0; q < 4; ++q) {
            const int c = wcol + n * 8 + 2 * q + par;
            float pa = __shfl_sync(0xffffffffu, s[n][par], (lane & ~3) | q);
            float pb =
                __shfl_sync(0xffffffffu, s[n][2 + par], (lane & ~3) | q);
            if constexpr (C::kQuant) {
              pa *= vsm[c];
              pb *= vsm[c];
            }
            const KT* vr = Vt + c * C::KS + 2 * (lane & 3);
#pragma unroll
            for (int o = 0; o < ND; ++o) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float v = to_f32(vr[o * 8 + e]);
                acc[o][e] = fmaf(pa, v, acc[o][e]);
                acc[o][2 + e] = fmaf(pb, v, acc[o][2 + e]);
              }
            }
          }
        }
      }
    }
    if (seed_here) {  // the exact current value row, in f32
      const QT* sv = reinterpret_cast<const QT*>(p.seed_v) + (size_t)b * F +
                     h * DH + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const float v = to_f32(sv[n * 8 + par]);
          acc[n][par] = fmaf(ps[0], v, acc[n][par]);
          acc[n][2 + par] = fmaf(ps[1], v, acc[n][2 + par]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the epilogue's staging area

  // ---- epilogue: each warp's (m, l, acc) -> shared; rows combined in
  // warp order; written out (one split) or as this split's partial
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 1);
    l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 2);
  }
  {
    float* ew = epi + warp * 16 * DH;
    float* eml = epi + 4 * 16 * DH + warp * 32;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ew[(lane / 4 + 8 * (e >> 1)) * DH + n * 8 + 2 * (lane & 3) +
           (e & 1)] = acc[n][e];
    if ((lane & 3) == 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        eml[(lane / 4 + 8 * x) * 2] = m_r[x];
        eml[(lane / 4 + 8 * x) * 2 + 1] = l_r[x];
      }
    }
  }
  __syncthreads();

  const int H = p.Hkv * group;
  const size_t slot = ((size_t)b * p.Hkv + h) * p.qtiles + qt;
  for (int i = tid; i < BM * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i % DH;
    const int ra = r0 + r;
    if (ra >= G) continue;
    float m, l, a;
    if constexpr (C::WN == 1) {
      const int w = r / 16, rr = r % 16;
      m = epi[4 * 16 * DH + w * 32 + rr * 2];
      l = epi[4 * 16 * DH + w * 32 + rr * 2 + 1];
      a = epi[(w * 16 + rr) * DH + d];
    } else {
      m = kNegInf;
#pragma unroll
      for (int w = 0; w < 4; ++w) m = fmaxf(m, epi[4 * 16 * DH + w * 32 + r * 2]);
      l = 0.f;
      a = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float lw = epi[4 * 16 * DH + w * 32 + r * 2 + 1];
        if (lw > 0.f) {
          const float sc = expf(epi[4 * 16 * DH + w * 32 + r * 2] - m);
          l = fmaf(lw, sc, l);
          a = fmaf(epi[(w * 16 + r) * DH + d], sc, a);
        }
      }
    }
    if (direct) {
      const int t = ra / group, g = ra % group;
      p.out[((size_t)b * p.T + t) * H * DH + (size_t)(h * group + g) * DH +
            d] = l > 0.f ? a / l : 0.f;
    } else {
      const size_t pr = (slot * p.splits + split) * BM + r;
      if (d == 0) {
        p.part_ml[pr * 2] = m;
        p.part_ml[pr * 2 + 1] = l;
      }
      if (l > 0.f) p.part_acc[pr * DH + d] = a;
    }
  }
  if (direct) return;

  // ---- the last live split of this (b, h, query tile) to finish merges
  // the live partials in split order (the counter is reset for the next
  // launch)
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(p.counters + slot, 1);
    s_last = done == live - 1;
    if (s_last) p.counters[slot] = 0;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* ml = p.part_ml + slot * p.splits * BM * 2;
  const float* pa = p.part_acc + slot * p.splits * BM * DH;
  // each row's weight per split, exp(m_s - m) (0 where the split saw
  // nothing), and its total l, into shared memory [splits + 1][BM]
  float* wts = epi;
  for (int r = tid; r < BM; r += kThreads) {
    float m = kNegInf;
    for (int sp = first; sp < first + live; ++sp)
      m = fmaxf(m, __ldcg(ml + (sp * BM + r) * 2));
    float l = 0.f;
    for (int sp = first; sp < first + live; ++sp) {
      const float ls = __ldcg(ml + (sp * BM + r) * 2 + 1);
      const float w = ls > 0.f ? expf(__ldcg(ml + (sp * BM + r) * 2) - m)
                               : 0.f;
      wts[sp * BM + r] = w;
      l = fmaf(ls, w, l);
    }
    wts[p.splits * BM + r] = l;
  }
  __syncthreads();
  // acc = sum over splits in order; each thread's PER elements are
  // independent loads, so a split's reads are in flight together
  constexpr int PER = BM * DH / kThreads;
  float a[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) a[e] = 0.f;
  for (int sp = first; sp < first + live; ++sp) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * kThreads;
      const float w = wts[sp * BM + i / DH];
      if (w > 0.f)
        a[e] = fmaf(__ldcg(pa + (size_t)sp * BM * DH + i), w, a[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = tid + e * kThreads;
    const int r = i / DH;
    const int ra = r0 + r;
    if (ra >= G) continue;
    const float l = wts[p.splits * BM + r];
    const int t = ra / group, g = ra % group;
    p.out[((size_t)b * p.T + t) * H * DH + (size_t)(h * group + g) * DH +
          i % DH] = l > 0.f ? a[e] / l : 0.f;
  }
}

// occ == nullptr: launch. Otherwise report the instance's dynamic shared
// memory and resident blocks per SM into occ[0], occ[1] (no launch).
template <typename QT, typename KT, int DH, int BM>
cudaError_t launch(const Params& p, int B, cudaStream_t stream, int* occ) {
  auto kern = rpa_kernel<QT, KT, DH, BM>;
  constexpr size_t smem = Cfg<QT, KT, DH, BM>::smem;
  // set once per instance (the first call is eager, never under capture)
  static cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  if (occ != nullptr) {
    occ[0] = (int)smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ + 1, kern,
                                                         kThreads, smem);
  }
  dim3 grid(p.qtiles * p.splits, p.Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename KT, int DH>
cudaError_t launch_bm(const Params& p, int B, int bm, cudaStream_t stream,
                      int* occ) {
  if (bm == 16) return launch<QT, KT, DH, 16>(p, B, stream, occ);
  if (bm == 64) return launch<QT, KT, DH, 64>(p, B, stream, occ);
  return cudaErrorInvalidValue;
}

template <typename QT, typename KT>
cudaError_t launch_dh(const Params& p, int B, int dh, int bm,
                      cudaStream_t stream, int* occ) {
  if (dh == 128) return launch_bm<QT, KT, 128>(p, B, bm, stream, occ);
  if (dh == 64) return launch_bm<QT, KT, 64>(p, B, bm, stream, occ);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const Params& p, int B, int q_dtype, int kv_dtype,
                     int dh, int bm, cudaStream_t st, int* occ) {
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_dh<__nv_bfloat16, __nv_bfloat16>(p, B, dh, bm, st, occ);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_dh<__nv_bfloat16, int8_t>(p, B, dh, bm, st, occ);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_dh<float, float>(p, B, dh, bm, st, occ);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_dh<float, int8_t>(p, B, dh, bm, st, occ);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when the launch was accepted. The plan
// (bm, qtiles, splits, split_len) comes from the wrapper; part_acc,
// part_ml and counters may be null when splits == 1.
int rpa_forward(const void* q, const void* ck, const void* cv, const void* ks,
                const void* vs, const void* seed_k, const void* seed_v,
                const void* page_table, const void* pos0, const void* q_lens,
                void* out, void* part_acc, void* part_ml, void* counters,
                long long sqb, long long sqt, long long sqh, int B, int T,
                int Hkv, int group, int dh, int n_arena_pages, int page,
                int max_pages, int layer, int window, int bm, int qtiles,
                int splits, int split_len, float scale, int q_dtype,
                int kv_dtype, void* stream) {
  Params p;
  p.q = q;
  p.sqb = sqb;
  p.sqt = sqt;
  p.sqh = sqh;
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
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.counters = static_cast<int*>(counters);
  p.T = T;
  p.Hkv = Hkv;
  p.group = group;
  p.n_arena_pages = n_arena_pages;
  p.page = page;
  p.max_pages = max_pages;
  p.layer = layer;
  p.window = window;
  p.qtiles = qtiles;
  p.splits = splits;
  p.split_len = split_len;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || T == 0) return 0;
  // the merge keeps a weight per (split, row) in the epilogue's staging
  if (splits < 1 || qtiles < 1 || split_len % kBN != 0 ||
      (splits + 1) * bm > 4 * 16 * dh + 4 * 16 * 2 ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr ||
                      counters == nullptr)))
    return cudaErrorInvalidValue;
  return dispatch(p, B, q_dtype, kv_dtype, dh, bm, st, nullptr);
}

// Dynamic shared memory and resident blocks per SM of one kernel instance
// into out[0], out[1] (for the build report); returns a cudaError_t code.
int rpa_occupancy(int q_dtype, int kv_dtype, int dh, int bm, int* out) {
  return dispatch(Params{}, 1, q_dtype, kv_dtype, dh, bm, nullptr, out);
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
