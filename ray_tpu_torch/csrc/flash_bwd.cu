// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// softmax(q k^T * scale) v, the FlashAttention-2 recurrence.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (ray_tpu/ops/flash_attention.py, both launched by `_flash_bwd_impl`).
// Same function: with P = exp(s * scale - lse) recomputed from q, k and the
// forward's lse, and D = rowsum(dO * O) computed in f32 by the caller,
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - D) * scale;
//   dQ = dS K;    dK = dS^T Q
// with products in the input dtype (P rounded to the dO dtype before
// P^T dO, dS to the k/q dtype before its products) and f32 accumulation.
// Two kernels, as in the reference, and no atomics: every output row is
// written by exactly one block, so the results are deterministic.
//
// What bounds it.  At the GPT-2-small training call (bf16, causal,
// [32,12,1024,64]) dq must move 5 [B,N,S,H] tensors plus lse and D (254.8 MB,
// 76.1 us at 3.35 TB/s) and do 3 causal products (77.4 GFLOP, 78.2 us at
// 989 TFLOP/s); dkv moves 6 tensors plus lse and D (305.1 MB, 91.1 us) and
// does 4 products (103.2 GFLOP, 104.3 us).  Both sit on the line between
// memory and tensor cores: the design keeps the [S, S] scores, P and dS in
// registers, reads each streamed tile once per block from L2, and feeds
// the products to the tensor cores.
//
// Design (a first, simple kernel; wgmma, TMA and pipelining come later):
//   * dq kernel, query frame: one block of 4 warps per (batch*head, 64-row
//     query tile), looping over 64-key K/V tiles; each warp owns 16 query
//     rows.  s = Q K^T and dP = dO V^T land in the mma accumulator layout,
//     dS is formed in registers and reused as the A operand of dQ += dS K,
//     for which K is also staged transposed (as the forward stages V^T);
//   * dkv kernel, key frame: one block per (batch*head, 64-key tile),
//     looping over query tiles; each warp owns 16 key rows and computes
//     s^T = K Q^T directly, so P^T sits in registers as the A operand of
//     dV += P^T dO, then dP^T = V dO^T, dS^T = P^T * (dP^T - D) * scale and
//     dK += dS^T Q, with Q and dO staged both row-major and transposed.
//     No transposes happen in registers.  Query tiles are 64 rows, 32 at
//     head dim 128 (two [64, 128] f32 accumulators already take 128
//     registers a thread);
//   * bf16 runs every product on mma.sync m16n8k16 (f32 accumulate); f32
//     inputs use scalar FMAs in the same fragment layout, with P and dS
//     staged through a per-warp shared-memory tile, so f32 never rounds to
//     TF32;
//   * causal: dq never visits key tiles above the diagonal, dkv starts at
//     the first query tile that reaches its keys; heaviest tiles first;
//   * any S: tiles past S are zero-filled on load; query rows and key
//     columns past S get P = 0 (a zero-filled query with a zero lse would
//     otherwise give P = exp(0) = 1 and leak into dK/dV); rows past S are
//     not stored;
//   * every tensor is addressed through element strides for batch, head
//     and sequence with the head dimension contiguous, so head-major (bnsh)
//     views of a fused qkv projection and seq-major (bsnh) tensors are read
//     in place.
//
// Plain C entry points (no PyTorch headers): rt_flash_bwd_dq and
// rt_flash_bwd_dkv return the cudaError_t of the launch; the Python wrapper
// raises when it is nonzero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;    // rows a block owns (query rows or key rows)
constexpr int kDqKeys = 64;  // dq: keys per streamed K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct View {  // element strides of a [B, N, S, H] view, H contiguous
  long long b, n, s;
};

// dkv: queries per streamed Q/dO tile.
template <int HD>
struct DkvTile {
  static constexpr int kQ = HD >= 128 ? 32 : 64;
};

// Row pitch (elements) of a row-major [rows][HD] tile: rows stay 16-byte
// aligned and are staggered across banks.
template <typename T, int HD>
struct Pitch {
  static constexpr int kRow = sizeof(T) == 2 ? HD + 8 : HD + 4;
};

// Copy rows [row0, row0 + R) of a [S, HD] slab into shared memory with the
// given pitch, 16 bytes per thread per step; rows at or past S become zero.
template <typename T, int HD, int R>
__device__ __forceinline__ void load_rows(T* dst, int pitch, const T* src,
                                          long long ss, int row0, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

// The same rows stored transposed, dst[d][row] with pitch R + 8, so that a
// B operand whose reduction runs over rows reads two consecutive rows of one
// column as one 32-bit word.  bf16 only.
template <int HD, int R>
__device__ __forceinline__ void load_transposed(bf16* dst, const bf16* src,
                                                long long ss, int row0,
                                                int S) {
  constexpr int kPerRow = HD / 8;
  constexpr int kPitch = R + 8;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kPitch + r] = e[j];
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A.B for one m16n8k16 tile: A 16x16 bf16 row-major fragment (4 regs),
// B 16x8 bf16 column fragment (2 regs), D 16x8 f32 (4 regs).
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment layout of every [16, 8*NT] product below (that of the mma C
// operand): lane (g = lane / 4, t = lane % 4) holds, for n-tile j,
//   x[j][0..1] at row g,     columns 8j + 2t + {0, 1}
//   x[j][2..3] at row g + 8, the same columns.

// x = A B^T for the warp: A is 16 rows of a row-major shared tile, B is
// 8*NT rows of another; both [.., HD].  (s = Q K^T, dP = dO V^T, and in the
// key frame s^T = K Q^T, dP^T = V dO^T.)
template <typename T, int HD, int NT>
__device__ __forceinline__ void product_abt(float (&x)[NT][4], const T* a,
                                            int ap, const T* b, int bp) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const bf16* p0 = a + g * ap + kk * 16 + 2 * t;
      const bf16* p1 = p0 + 8 * ap;
      const uint32_t af[4] = {ld32(p0), ld32(p1), ld32(p0 + 8), ld32(p1 + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* br = b + (j * 8 + g) * bp + kk * 16 + 2 * t;
        const uint32_t bfr[2] = {ld32(br), ld32(br + 8)};
        mma_16816(x[j], af, bfr);
      }
    }
  } else {
    const float* ar0 = a + g * ap;
    const float* ar1 = ar0 + 8 * ap;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* br0 = b + (j * 8 + 2 * t) * bp;
      const float* br1 = br0 + bp;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(ar0 + d);
        const float4 x1 = *reinterpret_cast<const float4*>(ar1 + d);
        const float4 y0 = *reinterpret_cast<const float4*>(br0 + d);
        const float4 y1 = *reinterpret_cast<const float4*>(br1 + d);
        x[j][0] += x0.x * y0.x + x0.y * y0.y + x0.z * y0.z + x0.w * y0.w;
        x[j][1] += x0.x * y1.x + x0.y * y1.y + x0.z * y1.z + x0.w * y1.w;
        x[j][2] += x1.x * y0.x + x1.y * y0.y + x1.z * y0.z + x1.w * y0.w;
        x[j][3] += x1.x * y1.x + x1.y * y1.y + x1.z * y1.z + x1.w * y1.w;
      }
    }
  }
}

// acc[16, HD] += P[16, KT] . M[KT, HD] for the warp, P in the fragment
// layout above (rounded to T for bf16, as the reference rounds P and dS).
// bf16: M is staged transposed, mt[d][row] with pitch KT + 8, and P is
// reused in registers as the A operand.  f32: M is row-major with pitch
// mp, and P goes through the warp's shared scratch tile [16][KT + 4].
template <typename T, int HD, int KT>
__device__ __forceinline__ void accumulate_pm(float (&acc)[HD / 8][4],
                                              const float (&p)[KT / 8][4],
                                              const T* m, int mp,
                                              float* scratch) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(p[2 * kk][0], p[2 * kk][1]),
          pack_bf16(p[2 * kk][2], p[2 * kk][3]),
          pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const bf16* mr = m + (j * 8 + g) * mp + kk * 16 + 2 * t;
        const uint32_t bfr[2] = {ld32(mr), ld32(mr + 8)};
        mma_16816(acc[j], pa, bfr);
      }
    }
  } else {
    constexpr int kSp = KT + 4;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const int c = j * 8 + 2 * t;
      scratch[g * kSp + c] = p[j][0];
      scratch[g * kSp + c + 1] = p[j][1];
      scratch[(g + 8) * kSp + c] = p[j][2];
      scratch[(g + 8) * kSp + c + 1] = p[j][3];
    }
    __syncwarp();
    for (int kk = 0; kk < KT; ++kk) {
      const float p0 = scratch[g * kSp + kk], p1 = scratch[(g + 8) * kSp + kk];
      const float* mr = m + kk * mp + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(mr + j * 8);
        acc[j][0] += p0 * x.x;
        acc[j][1] += p0 * x.y;
        acc[j][2] += p1 * x.x;
        acc[j][3] += p1 * x.y;
      }
    }
    __syncwarp();  // the tile is read before the next call overwrites it
  }
}

// Store the warp's 16 accumulator rows (first row `row0`) of a [S, HD]
// slab; rows at or past S are skipped.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* base, long long ss, int row0,
                                           int S, const float (&acc)[HD / 8][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= S) continue;
    T* r = base + row * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float x = acc[j][2 * h], y = acc[j][2 * h + 1];
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(r + j * 8) =
            __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(r + j * 8) = make_float2(x, y);
    }
  }
}

// ------------------------------------------------------------------ dq

template <typename T, int HD>
struct DqSmem {
  static constexpr int kP = Pitch<T, HD>::kRow;
  // Q, dO, K, V row-major tiles; then bf16: K^T [HD][kDqKeys + 8], or f32:
  // one scratch tile [16][kDqKeys + 4] per warp.
  static constexpr size_t kTiles = (size_t)4 * kTile * kP * sizeof(T);
  static constexpr size_t kBytes =
      kTiles + (sizeof(T) == 2
                    ? (size_t)HD * (kDqKeys + 8) * sizeof(T)
                    : (size_t)kWarps * 16 * (kDqKeys + 4) * sizeof(float));
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int N, int S, View qv, View kv, View vv, View dov,
                        View dqv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kP = DqSmem<T, HD>::kP;
  constexpr int kNT = kDqKeys / 8;

  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kTile * kP;
  T* ks = dos + kTile * kP;
  T* vs = ks + kDqKeys * kP;
  unsigned char* tail = smem_raw + DqSmem<T, HD>::kTiles;
  T* kts = reinterpret_cast<T*>(tail);                  // bf16: K^T
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* scratch = reinterpret_cast<float*>(tail) +     // f32: per warp
                   warp * 16 * (kDqKeys + 4);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const T* kb = k + b * kv.b + n * kv.n;
  const T* vb = v + b * vv.b + n * vv.n;

  load_rows<T, HD, kTile>(qs, kP, q + b * qv.b + n * qv.n, qv.s, q0, S);
  load_rows<T, HD, kTile>(dos, kP, dout + b * dov.b + n * dov.n, dov.s, q0, S);

  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;  // the lane's query rows
  const float* lse_b = lse + (long long)bn * S;
  const float* del_b = delta + (long long)bn * S;
  const float l0 = row0 < S ? lse_b[row0] * kLog2e : 0.f;
  const float l1 = row1 < S ? lse_b[row1] * kLog2e : 0.f;
  const float d0 = row0 < S ? del_b[row0] : 0.f;
  const float d1 = row1 < S ? del_b[row1] : 0.f;
  const float scale_log2 = scale * kLog2e;

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_kt_all = (S + kDqKeys - 1) / kDqKeys;
  const int last_row = min(q0 + kTile, S) - 1;
  const int n_kt = causal ? min(n_kt_all, last_row / kDqKeys + 1) : n_kt_all;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kDqKeys;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, HD, kDqKeys>(ks, kP, kb, kv.s, k0, S);
    load_rows<T, HD, kDqKeys>(vs, kP, vb, vv.s, k0, S);
    if constexpr (kBf16) load_transposed<HD, kDqKeys>(kts, kb, kv.s, k0, S);
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
    product_abt<T, HD, kNT>(s, qs + wr * kP, kP, ks, kP);    // q k^T
    product_abt<T, HD, kNT>(dp, dos + wr * kP, kP, vs, kP);  // do v^T

    // ds = p * (dp - D) * scale, p = exp(s * scale - lse), masked to 0
    const bool need_mask = (causal && k0 + kDqKeys - 1 > q0) || k0 + kDqKeys > S;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = exp2f(s[j][e] * scale_log2 - (lo ? l0 : l1));
        if (need_mask) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = lo ? row0 : row1;
          if (col >= S || (causal && col > row)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - (lo ? d0 : d1)) * scale;
      }
    }

    // dq += ds k
    if constexpr (kBf16)
      accumulate_pm<T, HD, kDqKeys>(acc, s, kts, kDqKeys + 8, nullptr);
    else
      accumulate_pm<T, HD, kDqKeys>(acc, s, ks, kP, scratch);
  }
  store_rows<T, HD>(dq + b * dqv.b + n * dqv.n, dqv.s, q0 + wr, S, acc);
}

// ------------------------------------------------------------------ dkv

template <typename T, int HD>
struct DkvSmem {
  static constexpr int kP = Pitch<T, HD>::kRow;
  static constexpr int kQ = DkvTile<HD>::kQ;
  // K, V (the block's own keys) and Q, dO (streamed) row-major; then bf16:
  // Q^T and dO^T [HD][kQ + 8], or f32: one scratch tile [16][kQ + 4] per
  // warp; then lse and D of the query tile, f32 [kQ] each.
  static constexpr size_t kTiles = (size_t)(2 * kTile + 2 * kQ) * kP * sizeof(T);
  static constexpr size_t kExtra =
      sizeof(T) == 2 ? (size_t)2 * HD * (kQ + 8) * sizeof(T)
                     : (size_t)kWarps * 16 * (kQ + 4) * sizeof(float);
  static constexpr size_t kBytes = kTiles + kExtra + 2 * kQ * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int N, int S, View qv, View kv,
                         View vv, View dov, View dkv_, View dvv, int causal,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kP = DkvSmem<T, HD>::kP;
  constexpr int kQ = DkvSmem<T, HD>::kQ;
  constexpr int kNT = kQ / 8;

  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kTile * kP;
  T* qs = vs + kTile * kP;
  T* dos = qs + kQ * kP;
  unsigned char* extra = smem_raw + DkvSmem<T, HD>::kTiles;
  T* qts = reinterpret_cast<T*>(extra);                 // bf16: Q^T
  T* dots = qts + HD * (kQ + 8);                        // bf16: dO^T
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4, g = lane / 4;
  float* scratch = reinterpret_cast<float*>(extra) +    // f32: per warp
                   warp * 16 * (kQ + 4);
  float* lse_s = reinterpret_cast<float*>(extra + DkvSmem<T, HD>::kExtra);
  float* del_s = lse_s + kQ;

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int k0 = blockIdx.x * kTile;  // low key tiles see the most queries
  const T* qb = q + b * qv.b + n * qv.n;
  const T* dob = dout + b * dov.b + n * dov.n;
  const float* lse_b = lse + (long long)bn * S;
  const float* del_b = delta + (long long)bn * S;

  load_rows<T, HD, kTile>(ks, kP, k + b * kv.b + n * kv.n, kv.s, k0, S);
  load_rows<T, HD, kTile>(vs, kP, v + b * vv.b + n * vv.n, vv.s, k0, S);

  const int wr = warp * 16;
  const int key0 = k0 + wr + g, key1 = key0 + 8;  // the lane's key rows
  const float scale_log2 = scale * kLog2e;

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;
  }

  const int n_qt = (S + kQ - 1) / kQ;
  // causal: query tiles wholly before this key tile see none of its keys
  const int qt0 = causal ? k0 / kQ : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kQ;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_rows<T, HD, kQ>(qs, kP, qb, qv.s, q0, S);
    load_rows<T, HD, kQ>(dos, kP, dob, dov.s, q0, S);
    if constexpr (kBf16) {
      load_transposed<HD, kQ>(qts, qb, qv.s, q0, S);
      load_transposed<HD, kQ>(dots, dob, dov.s, q0, S);
    }
    for (int i = threadIdx.x; i < kQ; i += kThreads) {
      const bool in = q0 + i < S;
      lse_s[i] = in ? lse_b[q0 + i] * kLog2e : 0.f;
      del_s[i] = in ? del_b[q0 + i] : 0.f;
    }
    __syncthreads();

    // p^T = exp(s^T * scale - lse[query]); query columns past S and (causal)
    // queries before the key get p = 0.
    float s[kNT][4];
    product_abt<T, HD, kNT>(s, ks + wr * kP, kP, qs, kP);  // k q^T
    const bool need_mask = (causal && q0 < k0 + kTile - 1) || q0 + kQ > S;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        float p = exp2f(s[j][e] * scale_log2 - lse_s[c]);
        if (need_mask) {
          const int qi = q0 + c, key = e < 2 ? key0 : key1;
          if (qi >= S || (causal && key > qi)) p = 0.f;
        }
        s[j][e] = p;
      }
    }

    // dv += p^T do
    if constexpr (kBf16)
      accumulate_pm<T, HD, kQ>(acc_v, s, dots, kQ + 8, nullptr);
    else
      accumulate_pm<T, HD, kQ>(acc_v, s, dos, kP, scratch);

    // ds^T = p^T * (dp^T - D[query]) * scale, dp^T = v do^T
    float dp[kNT][4];
    product_abt<T, HD, kNT>(dp, vs + wr * kP, kP, dos, kP);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        s[j][e] = s[j][e] * (dp[j][e] - del_s[c]) * scale;
      }
    }

    // dk += ds^T q
    if constexpr (kBf16)
      accumulate_pm<T, HD, kQ>(acc_k, s, qts, kQ + 8, nullptr);
    else
      accumulate_pm<T, HD, kQ>(acc_k, s, qs, kP, scratch);
  }
  store_rows<T, HD>(dk + b * dkv_.b + n * dkv_.n, dkv_.s, k0 + wr, S, acc_k);
  store_rows<T, HD>(dv + b * dvv.b + n * dvv.n, dvv.s, k0 + wr, S, acc_v);
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, N, S;
  View qv, kv, vv, dov, dqv, dkv, dvv;
  int causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = DqSmem<T, HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.B * a.N);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.N, a.S, a.qv, a.kv, a.vv, a.dov,
      a.dqv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = DkvSmem<T, HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.B * a.N);
  flash_bwd_dkv_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.N, a.S, a.qv,
      a.kv, a.vv, a.dov, a.dkv, a.dvv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch_head_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16:
      return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32:
      return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64:
      return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDq>
cudaError_t dispatch(int dtype, int head_dim, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.S <= 0) return cudaSuccess;
  switch (dtype) {
    case 0:
      return dispatch_head_dim<float, kDq>(head_dim, a);
    case 1:
      return dispatch_head_dim<bf16, kDq>(head_dim, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; lse and delta
// are f32 [B*N, S], contiguous.
extern "C" cudaError_t rt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int dtype, int head_dim,
    int B, int N, int S, long long q_sb, long long q_sn, long long q_ss,
    long long k_sb, long long k_sn, long long k_ss, long long v_sb,
    long long v_sn, long long v_ss, long long do_sb, long long do_sn,
    long long do_ss, long long dq_sb, long long dq_sn, long long dq_ss,
    int causal, float sm_scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq;
  a.B = B; a.N = N; a.S = S;
  a.qv = View{q_sb, q_sn, q_ss};
  a.kv = View{k_sb, k_sn, k_ss};
  a.vv = View{v_sb, v_sn, v_ss};
  a.dov = View{do_sb, do_sn, do_ss};
  a.dqv = View{dq_sb, dq_sn, dq_ss};
  a.causal = causal; a.scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(dtype, head_dim, a);
}

extern "C" cudaError_t rt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int dtype,
    int head_dim, int B, int N, int S, long long q_sb, long long q_sn,
    long long q_ss, long long k_sb, long long k_sn, long long k_ss,
    long long v_sb, long long v_sn, long long v_ss, long long do_sb,
    long long do_sn, long long do_ss, long long dk_sb, long long dk_sn,
    long long dk_ss, long long dv_sb, long long dv_sn, long long dv_ss,
    int causal, float sm_scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  a.B = B; a.N = N; a.S = S;
  a.qv = View{q_sb, q_sn, q_ss};
  a.kv = View{k_sb, k_sn, k_ss};
  a.vv = View{v_sb, v_sn, v_ss};
  a.dov = View{do_sb, do_sn, do_ss};
  a.dkv = View{dk_sb, dk_sn, dk_ss};
  a.dvv = View{dv_sb, dv_sn, dv_ss};
  a.causal = causal; a.scale = sm_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(dtype, head_dim, a);
}

// Message for an error code, so the wrapper can raise with it.
extern "C" const char* rt_error_string(cudaError_t err) {
  return cudaGetErrorString(err);
}
