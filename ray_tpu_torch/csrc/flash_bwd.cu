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
// P^T dO, dS to the k/q dtype before its products) and f32 accumulation,
// for any sign of scale.  Two kernels, as in the reference, and no atomics:
// every output row is written by exactly one block, so the results are
// deterministic.
//
// What bounds it.  At the GPT-2-small training call (bf16, causal,
// [32,12,1024,64]) dq must move 5 [B,N,S,H] tensors plus lse and D (254.8 MB,
// 76.1 us at 3.35 TB/s) and do 3 causal products (77.4 GFLOP, 78.2 us at
// 989 TFLOP/s); dkv moves 6 tensors plus lse and D (305.1 MB, 91.1 us) and
// does 4 products (103.2 GFLOP, 104.3 us).  Both sit on the line between
// memory and tensor cores: the design keeps the [S, S] scores, P and dS in
// registers, reads each streamed tile once per block from L2, and feeds
// the products to the tensor cores.  At H=64 each score gets few flops, so
// the ALU work per score (the exponent, the mask, dS) bounds the tile.
//
// Two kernels of each; the dtype and head dim pick one, and nothing falls
// back from one to the other.
//
// bf16 at head dims 64 and 128, `flash_bwd_dq_kernel` and
// `flash_bwd_dkv_kernel`: the splash backward's design
// (csrc/splash_attention.cu) with the flash kernels' own function; the
// tile steps `dq_tile` and `dkv_tile` are shared with splash through
// csrc/hopper.cuh.  One block of three warpgroups: one producer thread
// issues 4-d TMA loads (maps over [B, N, S, H] with the caller's strides,
// so bnsh, bsnh and strided views of a fused qkv projection are read in
// place; rows past S arrive as zeros) into a 2-stage ring with full/empty
// mbarriers and gives its registers up (setmaxnreg 24), and two consumer
// warpgroups (setmaxnreg 240) run every product on wgmma from shared
// memory, with P and dS as register A operands and the operand a product
// reduces over rows of read through the transpose flag.
//   * dq, query frame: one block per (batch*head, 128-row query tile),
//     heaviest causal tiles first; Q and dO resident, 64-key K/V tiles
//     streamed up to the causal bound of the block's last row.  Each
//     consumer warpgroup owns 64 rows, skips the key tile past its own
//     diagonal and masks only the tile that crosses it and a ragged last
//     key tile;
//   * dk/dv, key frame: one block per (batch*head, 128-key tile), low key
//     tiles first; K and V resident, 64-row Q/dO tiles streamed from the
//     first that reaches the block's keys, each with its 64 entries of lse
//     and D (bulk copies, so the caller passes them in rows of S rounded up
//     to 64).  Each warpgroup owns 64 keys, skips a query tile wholly
//     before them, and masks only the tile that crosses its diagonal and a
//     query tile that runs past S: padded queries get p = 0 explicitly (a
//     zero-filled query with lse 0 would otherwise give p = 1 and leak into
//     dK/dV);
//   * rows at or past S are not stored.
//
// f32 at every head dim, and bf16 at head dims 16 and 32,
// `flash_bwd_dq_mma_kernel` and `flash_bwd_dkv_mma_kernel` (the first
// design):
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
//     columns past S get P = 0; rows past S are not stored;
//   * every tensor is addressed through element strides for batch, head
//     and sequence with the head dimension contiguous.
//
// Plain C entry points (no PyTorch headers): rt_flash_bwd_dq and
// rt_flash_bwd_dkv return the cudaError_t of the launch; the Python wrapper
// raises when it is nonzero.

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;    // rows a block owns (query rows or key rows)
constexpr int kDqKeys = 64;  // dq: keys per streamed K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Row stride of the f32 [B*N, *] lse and D both kernels read: S rounded up
// to a 64-query tile, so the bf16 dk/dv kernel's bulk copies of 64 entries
// stay inside a row and 16-byte aligned.
__host__ __device__ __forceinline__ int stats_stride(int S) {
  return (S + 63) / 64 * 64;
}

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

// ======================================================== mma.sync: dq

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
    flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int N, int S, View qv,
                            View kv, View vv, View dov, View dqv, int causal,
                            float scale) {
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
  const float* lse_b = lse + (long long)bn * stats_stride(S);
  const float* del_b = delta + (long long)bn * stats_stride(S);
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

// ======================================================= mma.sync: dkv

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
    flash_bwd_dkv_mma_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int N,
                             int S, View qv, View kv, View vv, View dov,
                             View dkv_, View dvv, int causal, float scale) {
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
  const float* lse_b = lse + (long long)bn * stats_stride(S);
  const float* del_b = delta + (long long)bn * stats_stride(S);

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

// ========================================================= wgmma: dq

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int N, int S, View dqv,
                        int causal, float scale) {
  using L = DqLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qdo_full = base + L::kBars;
  auto full = [=](int s) { return qdo_full + 8 * (1 + s); };
  auto empty = [=](int s) { return qdo_full + 8 * (1 + kStages + s); };

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 128;  // heaviest tiles first
  // key tiles up to the last key the block's last row sees
  const int n_kt = (causal ? min(q0 + 127, S - 1) : S - 1) / 64 + 1;

  init_ring_barriers(qdo_full);

  if (threadIdx.x < kWg) {
    // Producer: Q and dO once, then K and V of every key tile.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qdo_full, 2 * L::kQTile);
      for (int h = 0; h < HD / 64; ++h) {
        tma_load(base + h * L::kQBox, &tq, qdo_full, h * 64, q0, n, b);
        tma_load(base + L::kQTile + h * L::kQBox, &tdo, qdo_full, h * 64, q0,
                 n, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int stage = kt % kStages;
        mbar_wait(empty(stage), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(stage), 2 * L::kKTile);
        for (int h = 0; h < HD / 64; ++h) {
          tma_load(L::k_tile(base, stage) + h * L::kKBox, &tk, full(stage),
                   h * 64, kt * 64, n, b);
          tma_load(L::v_tile(base, stage) + h * L::kKBox, &tv, full(stage),
                   h * 64, kt * 64, n, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns query rows [r0, r0 + 64) of the tile.
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / kWg - 1;
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r0 = q0 + 64 * c;
    const int row0 = r0 + 16 * w + lane / 4, row1 = row0 + 8;
    const uint32_t q_rows = base + 64 * c * kRowBytes;
    const uint32_t do_rows = q_rows + L::kQTile;
    const long long st = (long long)bn * stats_stride(S);
    const float l0 = row0 < S ? lse[st + row0] * kLog2e : 0.f;
    const float l1 = row1 < S ? lse[st + row1] * kLog2e : 0.f;
    const float d0 = row0 < S ? delta[st + row0] : 0.f;
    const float d1 = row1 < S ? delta[st + row1] : 0.f;
    // the last key each of the thread's rows sees
    const int last0 = causal ? min(row0, S - 1) : S - 1;
    const int last1 = causal ? min(row1, S - 1) : S - 1;
    const float scale_log2 = scale * kLog2e;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(qdo_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int stage = kt % kStages, k0 = kt * 64;
      mbar_wait(full(stage), (kt / kStages) & 1);
      // causal: a key tile past the warpgroup's last row is all masked for
      // it; the tile on its diagonal and a ragged last tile are masked
      if (!causal || k0 <= r0 + 63)
        dq_tile<HD>(acc, q_rows, do_rows, L::k_tile(base, stage),
                    L::v_tile(base, stage), scale_log2, scale, l0, l1, d0,
                    d1, (causal && k0 + 63 > r0) || k0 + 64 > S, last0 - k0,
                    last1 - k0);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));  // the stage is free
    }
    store_bf16<HD>(dq + b * dqv.b + n * dqv.n, dqv.s, row0, S, acc);
  }
}

// ====================================================== wgmma: dk, dv

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
                         int S, View dkv_, View dvv, int causal, float scale) {
  using L = DkvLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(sm);
  const uint32_t kv_full = base + L::kBars;
  auto full = [=](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [=](int s) { return kv_full + 8 * (1 + kStages + s); };

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int k0 = blockIdx.x * 128;  // low key tiles see the most queries
  // causal: query tiles wholly before this key tile see none of its keys
  const int qt0 = causal ? k0 / 64 : 0, n_qt = (S + 63) / 64;

  init_ring_barriers(kv_full);

  if (threadIdx.x < kWg) {
    // Producer: K and V once, then Q, dO, lse and D of every query tile.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKTile);
      for (int h = 0; h < HD / 64; ++h) {
        tma_load(base + h * L::kKBox, &tk, kv_full, h * 64, k0, n, b);
        tma_load(base + L::kKTile + h * L::kKBox, &tv, kv_full, h * 64, k0,
                 n, b);
      }
      const long long st = (long long)bn * stats_stride(S);
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int i = qt - qt0, stage = i % kStages, q0 = qt * 64;
        mbar_wait(empty(stage), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(stage), 2 * L::kQTile + 512);
        for (int h = 0; h < HD / 64; ++h) {
          tma_load(L::q_tile(base, stage) + h * L::kQBox, &tq, full(stage),
                   h * 64, q0, n, b);
          tma_load(L::do_tile(base, stage) + h * L::kQBox, &tdo, full(stage),
                   h * 64, q0, n, b);
        }
        bulk_load(base + L::stats(stage), lse + st + q0, 256, full(stage));
        bulk_load(base + L::stats(stage) + 256, delta + st + q0, 256,
                  full(stage));
      }
    }
  } else {
    // Consumers: warpgroup c owns keys [kw, kw + 64) of the tile.
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / kWg - 1;
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int kw = k0 + 64 * c;
    const int key0 = kw + 16 * w + lane / 4, key1 = key0 + 8;
    const uint32_t k_rows = base + 64 * c * kRowBytes;
    const uint32_t v_rows = k_rows + L::kKTile;
    const float scale_log2 = scale * kLog2e;

    float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int i = qt - qt0, stage = i % kStages, q0 = qt * 64;
      mbar_wait(full(stage), (i / kStages) & 1);
      // causal: a query tile before the warpgroup's first key sees none of
      // its keys; query q sees key c iff q >= c, and queries at or past S
      // are padding
      if (!causal || q0 + 63 >= kw) {
        const float* lse_s =
            reinterpret_cast<const float*>(sm + L::stats(stage));
        dkv_tile<HD>(acc_k, acc_v, k_rows, v_rows, L::q_tile(base, stage),
                     L::do_tile(base, stage), lse_s, lse_s + 64, scale_log2,
                     scale, (causal && q0 < kw + 63) || q0 + 64 > S,
                     causal ? key0 - q0 : 0, causal ? key1 - q0 : 0,
                     S - 1 - q0);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));  // the stage is free
    }
    store_bf16<HD>(dk + b * dkv_.b + n * dkv_.n, dkv_.s, key0, S, acc_k);
    store_bf16<HD>(dv + b * dvv.b + n * dvv.n, dvv.s, key0, S, acc_v);
  }
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
cudaError_t launch_dq_mma(const Args& a) {
  const size_t smem = DqSmem<T, HD>::kBytes;
  cudaError_t err = set_smem(flash_bwd_dq_mma_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.B * a.N);
  flash_bwd_dq_mma_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.N, a.S, a.qv, a.kv, a.vv, a.dov,
      a.dqv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv_mma(const Args& a) {
  const size_t smem = DkvSmem<T, HD>::kBytes;
  cudaError_t err = set_smem(flash_bwd_dkv_mma_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.B * a.N);
  flash_bwd_dkv_mma_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.N, a.S, a.qv,
      a.kv, a.vv, a.dov, a.dkv, a.dvv, a.causal, a.scale);
  return cudaGetLastError();
}

// TMA maps of boxes of `rows` rows over one of the launch's bf16 tensors.
template <int HD>
cudaError_t map_of(CUtensorMap* m, const void* ptr, const Args& a, View v,
                   int rows) {
  return bf16_map(m, ptr, a.B, a.N, a.S, HD, v, rows);
}

template <int HD>
cudaError_t launch_dq_wgmma(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = map_of<HD>(&tq, a.q, a, a.qv, 128)) != cudaSuccess ||
      (err = map_of<HD>(&tk, a.k, a, a.kv, 64)) != cudaSuccess ||
      (err = map_of<HD>(&tv, a.v, a, a.vv, 64)) != cudaSuccess ||
      (err = map_of<HD>(&tdo, a.dout, a, a.dov, 128)) != cudaSuccess)
    return err;
  const size_t smem = DqLayout<HD>::kBytes;
  if ((err = set_smem(flash_bwd_dq_kernel<HD>, smem)) != cudaSuccess)
    return err;
  const dim3 grid((a.S + 127) / 128, a.B * a.N);
  flash_bwd_dq_kernel<HD><<<grid, kWsThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), a.N, a.S,
      a.dqv, a.causal, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_wgmma(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = map_of<HD>(&tq, a.q, a, a.qv, 64)) != cudaSuccess ||
      (err = map_of<HD>(&tk, a.k, a, a.kv, 128)) != cudaSuccess ||
      (err = map_of<HD>(&tv, a.v, a, a.vv, 128)) != cudaSuccess ||
      (err = map_of<HD>(&tdo, a.dout, a, a.dov, 64)) != cudaSuccess)
    return err;
  const size_t smem = DkvLayout<HD>::kBytes;
  if ((err = set_smem(flash_bwd_dkv_kernel<HD>, smem)) != cudaSuccess)
    return err;
  const dim3 grid((a.S + 127) / 128, a.B * a.N);
  flash_bwd_dkv_kernel<HD><<<grid, kWsThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.N, a.S, a.dkv, a.dvv, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD, bool kDq>
cudaError_t launch_mma(const Args& a) {
  return kDq ? launch_dq_mma<T, HD>(a) : launch_dkv_mma<T, HD>(a);
}

template <int HD, bool kDq>
cudaError_t launch_wgmma(const Args& a) {
  return kDq ? launch_dq_wgmma<HD>(a) : launch_dkv_wgmma<HD>(a);
}

// dtype 0 (f32) takes the mma.sync kernels at every head dim; dtype 1
// (bf16) the wgmma kernels at head dims 64 and 128, the mma.sync kernels
// at 16 and 32.
template <bool kDq>
cudaError_t dispatch(int dtype, int head_dim, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.S <= 0) return cudaSuccess;
  if (dtype == 0) {
    switch (head_dim) {
      case 16: return launch_mma<float, 16, kDq>(a);
      case 32: return launch_mma<float, 32, kDq>(a);
      case 64: return launch_mma<float, 64, kDq>(a);
      case 128: return launch_mma<float, 128, kDq>(a);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 16: return launch_mma<bf16, 16, kDq>(a);
      case 32: return launch_mma<bf16, 32, kDq>(a);
      case 64: return launch_wgmma<64, kDq>(a);
      case 128: return launch_wgmma<128, kDq>(a);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; lse and delta
// are f32 [B*N, S rounded up to 64], 16-byte aligned; the entries past S in
// each row are read and masked, so they must be finite (the wrapper pads
// with zeros).
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
