// Splash attention for Hopper (sm_90a): block-sparse attention driven by a
// mask's block map.  Forward (o and the logsumexp residual), dq, and dk/dv.
//
// Replaces the Pallas TPU kernels of JAX's splash module, which the repo
// reaches through `make_splash_kernel` (ray_tpu/autotune/dispatch.py):
// `flash_attention_kernel` (forward), `_flash_attention_dq_kernel` and
// `_flash_attention_dkv_kernel` (the unfused backward the repo runs), in
// jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py.
// Same function:
//   forward  online softmax over the listed kv blocks: m, l and the output
//            accumulator in f32, q.k^T in the input dtype with f32
//            accumulation; o = acc * (1 / l) in the q dtype and
//            logsumexp = m + log(l) in f32;
//   dq       p = exp(q.k^T - lse), ds = (do.v^T - di) * p,
//            dq += ds.k (ds rounded to the k dtype);
//   dk, dv   dv += p^T.do, dk += ds^T.q (p and ds rounded to the do dtype)
// with di = rowsum(o * do) in f32 computed by the caller.  q arrives
// pre-scaled and the kernels apply no scale.  Masked scores take the value
// -0.7 * FLT_MAX, as the reference does, not -inf.
//
// What makes them splash and not flash.  Nothing here is causal by
// construction.  A mask's block map (built on the host, see
// ops/splash_attention.py) lists for each map row its non-empty blocks as
// (block << 1) | full, ascending; each thread block reads its row of the
// map from device memory and loops only over the listed blocks:
//   * full blocks run unmasked;
//   * partial blocks evaluate the mask on index iotas, which for a causal
//     mask with offset `off` is `q_idx + off >= kv_idx`; a partial map
//     block is a short loop of compute tiles, and each tile is classified
//     by the same mask function (empty: skipped and never loaded, full: no
//     masking, else masked per element);
//   * empty blocks are never loaded.
// The trip counts are data: they are read from the map, never derived from
// the tile index.  The map's block (block_q, block_kv, multiples of 128 as
// in the reference) is a multiple of every compute tile, so the reference's
// block knobs are set at run time with one compiled kernel.
//
// What bounds them.  At the Llama-2-7B attention shape (bf16, causal
// [2,32,4096,128]) the forward does 274.9 GFLOP of causal products (278 us
// at 989 TFLOP/s) against 134 MB of q/k/v/o (40 us at 3.35 TB/s); dq does
// three products (412.3 GFLOP, 417 us) and dk/dv four (549.8 GFLOP,
// 556 us).  All three are bound by the tensor cores.
//
// In bf16 all three are warp-specialised wgmma kernels (FlashAttention-3's
// design; the building blocks are in csrc/hopper.cuh): a producer
// warpgroup whose one thread issues 4-d TMA loads into a 2-stage ring with
// full/empty mbarriers and then gives its registers up (setmaxnreg 24),
// and two consumer warpgroups (setmaxnreg 240) running every product on
// wgmma from shared memory, B read through the transpose flag where the
// product reduces over rows (so V, K, Q and dO are used as TMA wrote them),
// P and dS as register A operands.  The producer walks the map with the
// same `tile_kind` test as the consumers, so stage and phase stay in step
// without the two sides talking; empty tiles are neither loaded nor
// computed.  Every output is accumulated in registers and stored once: no
// atomics, so results are deterministic.
//   * forward `splash_fwd_kernel` (replaces `flash_attention_kernel`): one
//     block per (batch*head, 128-row query tile), late rows first; Q
//     resident, 128-key K and V tiles streamed; S = Q K^T, the online
//     softmax in registers, O += P V (the tile step is shared with the
//     flash forward, `fwd_tile`);
//   * dq `splash_dq_kernel` (replaces `_flash_attention_dq_kernel`): the
//     dk/dv design carried into the query frame.  One block per
//     (batch*head, 128-row query tile), late rows first; Q and dO resident,
//     64-key K and V tiles streamed; per tile S = Q K^T, dP = dO V^T,
//     P = exp2(S log2e - lse log2e) (0 where a partial tile masks it),
//     dS = P (dP - di), dQ += dS K with K read as the MN-major B operand
//     (no transposed copy of K).  Registers at H=128: dQ 64 + S 32 + dP 32
//     f32 and the packed dS 16.  The tile step is shared with the flash
//     dq, `dq_tile`;
//   * dk/dv `splash_dkv_kernel` (replaces `_flash_attention_dkv_kernel`;
//     FlashAttention-3's backward in the key frame, without dq): one block
//     per (batch*head, 128-key tile), lowest key tiles first; K and V
//     resident; 64-row Q and dO tiles with their lse and di streamed along
//     the transposed map.  Per tile: S^T = K Q^T, P^T = exp2(S^T log2e -
//     lse) (masked on partial tiles), dV += P^T dO, dP^T = V dO^T, dS^T =
//     P^T (dP^T - di), dK += dS^T Q (the tile step is shared with the
//     flash dk/dv, `dkv_tile`).
// All read q, k, v, do through 4-d TMA maps over [B, N, S, H] with the
// caller's strides and 128-byte swizzle (a tile of H=128 is two 64-column
// boxes), matched by the wgmma descriptors; the maps are encoded on the
// host for each launch.
//
// In f32 the three kernels keep the first, simple design (that of the
// flash kernels' f32 path, with the map in place of the causal test):
//   * forward and dq: one block of 4 warps per (batch*head, 64-row query
//     tile), streaming 64-key K/V tiles through shared memory; each warp
//     owns 16 query rows;
//   * dk/dv: one block per (batch*head, 64-key tile) in the key frame,
//     streaming query tiles of the transposed map (64 rows, 32 at head dim
//     128); a key tile whose map column lists no query block writes zeros;
//   * scalar FMAs in the mma C fragment layout (no TF32);
//   * q, k, v, do and the outputs are addressed through element strides
//     for batch, head and sequence with the head dimension contiguous.
// The dtype picks the kernel; nothing falls back from one to the other.
//
// Plain C entry points (no PyTorch headers): rt_splash_fwd,
// rt_splash_bwd_dq and rt_splash_bwd_dkv return the cudaError_t of the
// launch; the Python wrapper raises when it is nonzero.

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;   // f32: rows a block owns (query or key rows)
constexpr int kKeys = 64;   // f32 forward and dq, bf16 dq: keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

// A block map on the device.  `lists` is [heads, rows, 1 + cols]: per map
// row its count of non-empty blocks, then those blocks as
// (index << 1) | full.  The forward and dq read rows of query blocks
// listing kv blocks; dk/dv read the transposed table.
struct Map {
  const int* offsets;  // [heads] causal offset of each map head
  const int* lists;
  int heads;           // 1 (one map for every head) or N
  int row_block;       // the map block along the kernel's own frame
  int col_block;       // ... and along the streamed dimension
  int rows, cols;      // blocks along each
};

__device__ __forceinline__ const int* map_row(const Map& m, int head,
                                              int row) {
  const int h = m.heads == 1 ? 0 : head;
  return m.lists + ((long long)h * m.rows + row) * (1 + m.cols);
}

// Kind of a compute tile of rows [r0, r0 + R) and columns [c0, c0 + C)
// under the causal mask function `r + off >= c`: 0 empty, 1 partial,
// 2 full.  Rows are queries and columns keys.
__device__ __forceinline__ int tile_kind(int r0, int R, int c0, int C,
                                         int off) {
  if (r0 + R - 1 + off < c0) return 0;
  if (r0 + off >= c0 + C - 1) return 2;
  return 1;
}

// ================================================================= f32
// The first design, for f32 inputs: scalar FMAs.

// Query tiles of the f32 dk/dv kernel: 64 rows, 32 at head dim 128.
template <int HD>
struct DkvTile {
  static constexpr int kQ = HD >= 128 ? 32 : 64;
};

// Row pitch (floats) of a row-major [rows][HD] tile: rows stay 16-byte
// aligned and are staggered across banks.
template <int HD>
struct Pitch {
  static constexpr int kRow = HD + 4;
};

// Copy rows [row0, row0 + R) of a [S, HD] slab into shared memory with the
// given pitch, 16 bytes per thread per step; rows at or past S become zero.
template <int HD, int R>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* src, long long ss,
                                          int row0, int S) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

// Fragment layout of every [16, 8*NT] product below (that of the mma C
// operand): lane (g = lane / 4, t = lane % 4) holds, for n-tile j,
//   x[j][0..1] at row g,     columns 8j + 2t + {0, 1}
//   x[j][2..3] at row g + 8, the same columns.

// x = A B^T for the warp: A is 16 rows of a row-major shared tile, B is
// 8*NT rows of another; both [.., HD].
template <int HD, int NT>
__device__ __forceinline__ void product_abt(float (&x)[NT][4], const float* a,
                                            int ap, const float* b, int bp) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* ar0 = a + g * ap;
  const float* ar1 = ar0 + 8 * ap;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
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

// acc[16, HD] += P[16, KT] . M[KT, HD] for the warp, P in the fragment
// layout above, M row-major with pitch mp; P goes through the warp's
// shared scratch tile [16][KT + 4].
template <int HD, int KT>
__device__ __forceinline__ void accumulate_pm(float (&acc)[HD / 8][4],
                                              const float (&p)[KT / 8][4],
                                              const float* m, int mp,
                                              float* scratch) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
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

// Store the warp's 16 accumulator rows (first row `row0`) of a [S, HD]
// slab, each scaled by its row's factor; rows at or past S are skipped.
template <int HD>
__device__ __forceinline__ void store_rows(float* base, long long ss,
                                           int row0, int S,
                                           const float (&acc)[HD / 8][4],
                                           float f0 = 1.f, float f1 = 1.f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= S) continue;
    const float f = h ? f1 : f0;
    float* r = base + row * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(r + j * 8) =
          make_float2(acc[j][2 * h] * f, acc[j][2 * h + 1] * f);
  }
}

// Shared memory of the f32 query-frame kernels: the block's query-side
// tiles (Q for the forward; Q and dO for dq) and the streamed K and V
// row-major, then one scratch tile [16][kKeys + 4] per warp.
template <int HD, int kOwn>
struct QFrameSmem {
  static constexpr int kP = Pitch<HD>::kRow;
  static constexpr size_t kTiles = (size_t)(kOwn + 2) * kTile * kP * 4;
  static constexpr size_t kBytes =
      kTiles + (size_t)kWarps * 16 * (kKeys + 4) * 4;
};

// ---------------------------------------------------------- f32 forward

template <int HD>
__global__ void __launch_bounds__(kThreads)
    splash_fwd_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int N, int S, View qv,
                          View kv, View vv, View ov, Map map) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = QFrameSmem<HD, 1>;
  constexpr int kP = Smem::kP;
  constexpr int kNT = kKeys / 8;

  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kTile * kP;
  float* vs = ks + kKeys * kP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* scratch = reinterpret_cast<float*>(smem_raw + Smem::kTiles) +
                   warp * 16 * (kKeys + 4);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // late rows first
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* row = map_row(map, n, q0 / map.row_block);
  const int count = row[0];
  const float* kb = k + b * kv.b + n * kv.n;
  const float* vb = v + b * vv.b + n * vv.n;

  load_rows<HD, kTile>(qs, kP, q + b * qv.b + n * qv.n, qv.s, q0, S);

  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;  // the lane's query rows

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kMaskValue, m1 = kMaskValue;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;                // this lane's share of the sum

  for (int i = 0; i < count; ++i) {
    const int entry = row[1 + i];
    const int kstart = (entry >> 1) * map.col_block;
    for (int k0 = kstart; k0 < kstart + map.col_block; k0 += kKeys) {
      const int kind = (entry & 1) ? 2 : tile_kind(q0, kTile, k0, kKeys, off);
      if (kind == 0) continue;  // the same for every thread of the block
      __syncthreads();  // every warp is done with the previous K/V tile
      load_rows<HD, kKeys>(ks, kP, kb, kv.s, k0, S);
      load_rows<HD, kKeys>(vs, kP, vb, vv.s, k0, S);
      __syncthreads();

      float s[kNT][4];
      product_abt<HD, kNT>(s, qs + wr * kP, kP, ks, kP);  // q k^T

      // log2 domain; masked scores take the mask value itself (scaling it
      // by log2(e) would overflow to -inf)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * kLog2e;
          if (kind == 1) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            if ((e < 2 ? row0 : row1) + off < col) x = kMaskValue;
          }
          s[j][e] = x;
        }
      }

      // online softmax: the 4 lanes of a quad share a row
      float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[j][0] = exp2f(s[j][0] - mn0);
        s[j][1] = exp2f(s[j][1] - mn0);
        s[j][2] = exp2f(s[j][2] - mn1);
        s[j][3] = exp2f(s[j][3] - mn1);
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[j][0] *= alpha0;
        acc[j][1] *= alpha0;
        acc[j][2] *= alpha1;
        acc[j][3] *= alpha1;
      }

      accumulate_pm<HD, kKeys>(acc, s, vs, kP, scratch);  // += p v
    }
  }

  // o = acc * (1 / l), logsumexp = m + log(l)
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  store_rows<HD>(o + b * ov.b + n * ov.n, ov.s, q0 + wr, S, acc, 1.f / l0,
                 1.f / l1);
  if (t == 0) {
    float* lse_b = lse + (long long)bn * S;
    if (row0 < S) lse_b[row0] = (m0 + log2f(l0)) * kLn2;
    if (row1 < S) lse_b[row1] = (m1 + log2f(l1)) * kLn2;
  }
}

// -------------------------------------------------------------- f32 dq

template <int HD>
__global__ void __launch_bounds__(kThreads)
    splash_dq_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, float* __restrict__ dq,
                         int N, int S, View qv, View kv, View vv, View dov,
                         View dqv, Map map) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = QFrameSmem<HD, 2>;
  constexpr int kP = Smem::kP;
  constexpr int kNT = kKeys / 8;

  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kTile * kP;
  float* ks = dos + kTile * kP;
  float* vs = ks + kKeys * kP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* scratch = reinterpret_cast<float*>(smem_raw + Smem::kTiles) +
                   warp * 16 * (kKeys + 4);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // late rows first
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* row = map_row(map, n, q0 / map.row_block);
  const int count = row[0];
  const float* kb = k + b * kv.b + n * kv.n;
  const float* vb = v + b * vv.b + n * vv.n;

  load_rows<HD, kTile>(qs, kP, q + b * qv.b + n * qv.n, qv.s, q0, S);
  load_rows<HD, kTile>(dos, kP, dout + b * dov.b + n * dov.n, dov.s, q0, S);

  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;  // the lane's query rows
  const float* lse_b = lse + (long long)bn * S;
  const float* di_b = di + (long long)bn * S;
  const float l0 = row0 < S ? lse_b[row0] * kLog2e : 0.f;
  const float l1 = row1 < S ? lse_b[row1] * kLog2e : 0.f;
  const float d0 = row0 < S ? di_b[row0] : 0.f;
  const float d1 = row1 < S ? di_b[row1] : 0.f;

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < count; ++i) {
    const int entry = row[1 + i];
    const int kstart = (entry >> 1) * map.col_block;
    for (int k0 = kstart; k0 < kstart + map.col_block; k0 += kKeys) {
      const int kind = (entry & 1) ? 2 : tile_kind(q0, kTile, k0, kKeys, off);
      if (kind == 0) continue;  // the same for every thread of the block
      __syncthreads();  // every warp is done with the previous K/V tile
      load_rows<HD, kKeys>(ks, kP, kb, kv.s, k0, S);
      load_rows<HD, kKeys>(vs, kP, vb, vv.s, k0, S);
      __syncthreads();

      float s[kNT][4], dp[kNT][4];
      product_abt<HD, kNT>(s, qs + wr * kP, kP, ks, kP);    // q k^T
      product_abt<HD, kNT>(dp, dos + wr * kP, kP, vs, kP);  // do v^T

      // ds = (dp - di) * p, p = exp(qk - lse), 0 where masked
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          float p = exp2f(s[j][e] * kLog2e - (lo ? l0 : l1));
          if (kind == 1) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            if ((lo ? row0 : row1) + off < col) p = 0.f;
          }
          s[j][e] = (dp[j][e] - (lo ? d0 : d1)) * p;
        }
      }

      accumulate_pm<HD, kKeys>(acc, s, ks, kP, scratch);  // dq += ds k
    }
  }
  store_rows<HD>(dq + b * dqv.b + n * dqv.n, dqv.s, q0 + wr, S, acc);
}

// ------------------------------------------------------------ f32 dk, dv

template <int HD>
struct DkvSmem {
  static constexpr int kP = Pitch<HD>::kRow;
  static constexpr int kQ = DkvTile<HD>::kQ;
  // K, V (the block's own keys) and Q, dO (streamed) row-major; then one
  // scratch tile [16][kQ + 4] per warp; then lse and di of the query tile,
  // [kQ] each.
  static constexpr size_t kTiles = (size_t)(2 * kTile + 2 * kQ) * kP * 4;
  static constexpr size_t kExtra = (size_t)kWarps * 16 * (kQ + 4) * 4;
  static constexpr size_t kBytes = kTiles + kExtra + 2 * kQ * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    splash_dkv_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, float* __restrict__ dk,
                          float* __restrict__ dv, int N, int S, View qv,
                          View kv, View vv, View dov, View dkv_, View dvv,
                          Map map) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kP = DkvSmem<HD>::kP;
  constexpr int kQ = DkvSmem<HD>::kQ;
  constexpr int kNT = kQ / 8;

  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kTile * kP;
  float* qs = vs + kTile * kP;
  float* dos = qs + kQ * kP;
  unsigned char* extra = smem_raw + DkvSmem<HD>::kTiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4, g = lane / 4;
  float* scratch = reinterpret_cast<float*>(extra) + warp * 16 * (kQ + 4);
  float* lse_s = reinterpret_cast<float*>(extra + DkvSmem<HD>::kExtra);
  float* di_s = lse_s + kQ;

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int k0 = blockIdx.x * kTile;  // low key tiles see the most queries
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* col = map_row(map, n, k0 / map.row_block);
  const int count = col[0];
  const float* qb = q + b * qv.b + n * qv.n;
  const float* dob = dout + b * dov.b + n * dov.n;
  const float* lse_b = lse + (long long)bn * S;
  const float* di_b = di + (long long)bn * S;

  load_rows<HD, kTile>(ks, kP, k + b * kv.b + n * kv.n, kv.s, k0, S);
  load_rows<HD, kTile>(vs, kP, v + b * vv.b + n * vv.n, vv.s, k0, S);

  const int wr = warp * 16;
  const int key0 = k0 + wr + g, key1 = key0 + 8;  // the lane's key rows

  // Zero unless a listed query block reaches these keys: a key tile whose
  // column lists nothing stores zeros.
  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;
  }

  for (int i = 0; i < count; ++i) {
    const int entry = col[1 + i];
    const int qstart = (entry >> 1) * map.col_block;
    for (int q0 = qstart; q0 < qstart + map.col_block; q0 += kQ) {
      const int kind = (entry & 1) ? 2 : tile_kind(q0, kQ, k0, kTile, off);
      if (kind == 0) continue;  // the same for every thread of the block
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_rows<HD, kQ>(qs, kP, qb, qv.s, q0, S);
      load_rows<HD, kQ>(dos, kP, dob, dov.s, q0, S);
      for (int r = threadIdx.x; r < kQ; r += kThreads) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse_b[q0 + r] * kLog2e : 0.f;
        di_s[r] = in ? di_b[q0 + r] : 0.f;
      }
      __syncthreads();

      // p^T = exp(s^T - lse[query]), 0 where masked
      float s[kNT][4];
      product_abt<HD, kNT>(s, ks + wr * kP, kP, qs, kP);  // k q^T
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          float p = exp2f(s[j][e] * kLog2e - lse_s[c]);
          if (kind == 1 && q0 + c + off < (e < 2 ? key0 : key1)) p = 0.f;
          s[j][e] = p;
        }
      }

      accumulate_pm<HD, kQ>(acc_v, s, dos, kP, scratch);  // += p^T do

      // ds^T = (dp^T - di[query]) * p^T, dp^T = v do^T
      float dp[kNT][4];
      product_abt<HD, kNT>(dp, vs + wr * kP, kP, dos, kP);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          s[j][e] = (dp[j][e] - di_s[c]) * s[j][e];
        }
      }

      accumulate_pm<HD, kQ>(acc_k, s, qs, kP, scratch);  // += ds^T q
    }
  }
  store_rows<HD>(dk + b * dkv_.b + n * dkv_.n, dkv_.s, k0 + wr, S, acc_k);
  store_rows<HD>(dv + b * dvv.b + n * dvv.n, dvv.s, k0 + wr, S, acc_v);
}

// ================================================================ bf16
// wgmma, TMA and warp specialisation (helpers in hopper.cuh).

// --------------------------------------------------------- bf16 forward

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    splash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, float* __restrict__ lse, int N,
                      int S, View ov, Map map) {
  using L = FwdLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  auto full = [=](int s) { return q_full + 8 * (1 + s); };
  auto empty = [=](int s) { return q_full + 8 * (1 + kStages + s); };

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 128;  // late rows first
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* row = map_row(map, n, q0 / map.row_block);
  const int count = row[0];

  init_ring_barriers(q_full);

  if (threadIdx.x < kWg) {
    // Producer: one thread loads Q, then the K/V tile of every non-empty
    // 128-key compute tile of the map row, in the consumers' order.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQTile);
      for (int h = 0; h < HD / 64; ++h)
        tma_load(base + h * L::kQBox, &tq, q_full, h * 64, q0, n, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < count; ++i) {
        const int entry = row[1 + i];
        const int kstart = (entry >> 1) * map.col_block;
        for (int k0 = kstart; k0 < kstart + map.col_block; k0 += 128) {
          if (!(entry & 1) && tile_kind(q0, 128, k0, 128, off) == 0)
            continue;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), 2 * L::kKTile);
          for (int h = 0; h < HD / 64; ++h) {
            tma_load(L::k_tile(base, stage) + h * L::kKBox, &tk, full(stage),
                     h * 64, k0, n, b);
            tma_load(L::v_tile(base, stage) + h * L::kKBox, &tv, full(stage),
                     h * 64, k0, n, b);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns query rows [64c, 64c + 64) of the tile.
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / kWg - 1;
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * c + 16 * w + lane / 4;
    const uint32_t q_rows = base + 64 * c * kRowBytes;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    Softmax st{kMaskValue, kMaskValue, 0.f, 0.f};

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < count; ++i) {
      const int entry = row[1 + i];
      const int kstart = (entry >> 1) * map.col_block;
      for (int k0 = kstart; k0 < kstart + map.col_block; k0 += 128) {
        const int kind = (entry & 1) ? 2 : tile_kind(q0, 128, k0, 128, off);
        if (kind == 0) continue;
        mbar_wait(full(stage), phase);
        // row r sees key c iff r + off >= c
        fwd_tile<HD>(acc, st, q_rows, L::k_tile(base, stage),
                     L::v_tile(base, stage), kLog2e, kMaskValue, kind == 1,
                     row0 + off - k0, row0 + 8 + off - k0);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));  // the stage is free
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    fwd_store<HD>(o + b * ov.b + n * ov.n, ov.s, lse + (long long)bn * S,
                  row0, S, acc, st);
  }
}

// -------------------------------------------------------------- bf16 dq

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    splash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dq,
                     int N, int S, View dqv, Map map) {
  using L = DqLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qdo_full = base + L::kBars;
  auto full = [=](int s) { return qdo_full + 8 * (1 + s); };
  auto empty = [=](int s) { return qdo_full + 8 * (1 + kStages + s); };

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 128;  // late rows first
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* row = map_row(map, n, q0 / map.row_block);
  const int count = row[0];

  init_ring_barriers(qdo_full);

  if (threadIdx.x < kWg) {
    // Producer: Q and dO once, then K and V of every non-empty 64-key
    // compute tile of the map row.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qdo_full, 2 * L::kQTile);
      for (int h = 0; h < HD / 64; ++h) {
        tma_load(base + h * L::kQBox, &tq, qdo_full, h * 64, q0, n, b);
        tma_load(base + L::kQTile + h * L::kQBox, &tdo, qdo_full, h * 64, q0,
                 n, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < count; ++i) {
        const int entry = row[1 + i];
        const int kstart = (entry >> 1) * map.col_block;
        for (int k0 = kstart; k0 < kstart + map.col_block; k0 += kKeys) {
          if (!(entry & 1) && tile_kind(q0, 128, k0, kKeys, off) == 0)
            continue;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), 2 * L::kKTile);
          for (int h = 0; h < HD / 64; ++h) {
            tma_load(L::k_tile(base, stage) + h * L::kKBox, &tk, full(stage),
                     h * 64, k0, n, b);
            tma_load(L::v_tile(base, stage) + h * L::kKBox, &tv, full(stage),
                     h * 64, k0, n, b);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns query rows [64c, 64c + 64) of the tile.
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / kWg - 1;
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * c + 16 * w + lane / 4;
    const uint32_t q_rows = base + 64 * c * kRowBytes;
    const uint32_t do_rows = q_rows + L::kQTile;
    const float* lse_b = lse + (long long)bn * S;
    const float* di_b = di + (long long)bn * S;
    const float l0 = lse_b[row0] * kLog2e, l1 = lse_b[row0 + 8] * kLog2e;
    const float d0 = di_b[row0], d1 = di_b[row0 + 8];

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(qdo_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < count; ++i) {
      const int entry = row[1 + i];
      const int kstart = (entry >> 1) * map.col_block;
      for (int k0 = kstart; k0 < kstart + map.col_block; k0 += kKeys) {
        const int kind =
            (entry & 1) ? 2 : tile_kind(q0, 128, k0, kKeys, off);
        if (kind == 0) continue;
        mbar_wait(full(stage), phase);
        // row r sees key c iff r + off >= c
        dq_tile<HD>(acc, q_rows, do_rows, L::k_tile(base, stage),
                    L::v_tile(base, stage), kLog2e, 1.f, l0, l1, d0, d1,
                    kind == 1, row0 + off - k0, row0 + 8 + off - k0);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));  // the stage is free
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    store_bf16<HD>(dq + b * dqv.b + n * dqv.n, dqv.s, row0, S, acc);
  }
}

// ----------------------------------------------------------- bf16 dk, dv

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    splash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int N, int S, View dkv_,
                      View dvv, Map map) {
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
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* col = map_row(map, n, k0 / map.row_block);
  const int count = col[0];

  init_ring_barriers(kv_full);

  if (threadIdx.x < kWg) {
    // Producer: K and V once, then Q, dO, lse and di of every non-empty
    // 64-query compute tile of the transposed map's column.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKTile);
      for (int h = 0; h < HD / 64; ++h) {
        tma_load(base + h * L::kKBox, &tk, kv_full, h * 64, k0, n, b);
        tma_load(base + L::kKTile + h * L::kKBox, &tv, kv_full, h * 64, k0,
                 n, b);
      }
      const float* lse_b = lse + (long long)bn * S;
      const float* di_b = di + (long long)bn * S;
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < count; ++i) {
        const int entry = col[1 + i];
        const int qstart = (entry >> 1) * map.col_block;
        for (int q0 = qstart; q0 < qstart + map.col_block; q0 += 64) {
          if (!(entry & 1) && tile_kind(q0, 64, k0, 128, off) == 0) continue;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), 2 * L::kQTile + 512);
          for (int h = 0; h < HD / 64; ++h) {
            tma_load(L::q_tile(base, stage) + h * L::kQBox, &tq, full(stage),
                     h * 64, q0, n, b);
            tma_load(L::do_tile(base, stage) + h * L::kQBox, &tdo,
                     full(stage), h * 64, q0, n, b);
          }
          bulk_load(base + L::stats(stage), lse_b + q0, 256, full(stage));
          bulk_load(base + L::stats(stage) + 256, di_b + q0, 256,
                    full(stage));
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns keys [64c, 64c + 64) of the tile.
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / kWg - 1;
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int key0 = k0 + 64 * c + 16 * w + lane / 4;
    const uint32_t k_rows = base + 64 * c * kRowBytes;
    const uint32_t v_rows = k_rows + L::kKTile;

    // Zero unless a listed query block reaches these keys: a key tile
    // whose column lists nothing stores zeros.
    float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < count; ++i) {
      const int entry = col[1 + i];
      const int qstart = (entry >> 1) * map.col_block;
      for (int q0 = qstart; q0 < qstart + map.col_block; q0 += 64) {
        const int kind = (entry & 1) ? 2 : tile_kind(q0, 64, k0, 128, off);
        if (kind == 0) continue;
        mbar_wait(full(stage), phase);
        const float* lse_s =
            reinterpret_cast<const float*>(sm + L::stats(stage));
        // query q sees key c iff q + off >= c
        dkv_tile<HD>(acc_k, acc_v, k_rows, v_rows, L::q_tile(base, stage),
                     L::do_tile(base, stage), lse_s, lse_s + 64, kLog2e, 1.f,
                     kind == 1, key0 - off - q0, key0 + 8 - off - q0, 63);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));  // the stage is free
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    store_bf16<HD>(dk + b * dkv_.b + n * dkv_.n, dkv_.s, key0, S, acc_k);
    store_bf16<HD>(dv + b * dvv.b + n * dvv.n, dvv.s, key0, S, acc_v);
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B, N, S;
  View qv, kv, vv, dov, ov, dkv, dvv;
  Map map;
  cudaStream_t stream;
};

// A TMA map of boxes of `rows` rows over one of the launch's bf16 tensors.
template <int HD>
cudaError_t map_of(CUtensorMap* m, const void* ptr, const Args& a, View v,
                   int rows) {
  return bf16_map(m, ptr, a.B, a.N, a.S, HD, v, rows);
}

template <int HD>
cudaError_t launch_fwd_f32(const Args& a) {
  const size_t smem = QFrameSmem<HD, 1>::kBytes;
  cudaError_t err = set_smem(splash_fwd_f32_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kTile, a.B * a.N);
  splash_fwd_f32_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse_out,
      a.N, a.S, a.qv, a.kv, a.vv, a.ov, a.map);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fwd_bf16(const Args& a) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = map_of<HD>(&tq, a.q, a, a.qv, 128)) != cudaSuccess ||
      (err = map_of<HD>(&tk, a.k, a, a.kv, 128)) != cudaSuccess ||
      (err = map_of<HD>(&tv, a.v, a, a.vv, 128)) != cudaSuccess)
    return err;
  const size_t smem = FwdLayout<HD>::kBytes;
  if ((err = set_smem(splash_fwd_kernel<HD>, smem)) != cudaSuccess) return err;
  const dim3 grid(a.S / 128, a.B * a.N);
  splash_fwd_kernel<HD><<<grid, kWsThreads, smem, a.stream>>>(
      tq, tk, tv, static_cast<bf16*>(a.o), a.lse_out, a.N, a.S, a.ov, a.map);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_f32(const Args& a) {
  const size_t smem = QFrameSmem<HD, 2>::kBytes;
  cudaError_t err = set_smem(splash_dq_f32_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kTile, a.B * a.N);
  splash_dq_f32_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.di, static_cast<float*>(a.dq), a.N, a.S, a.qv, a.kv, a.vv,
      a.dov, a.ov, a.map);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_bf16(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = map_of<HD>(&tq, a.q, a, a.qv, 128)) != cudaSuccess ||
      (err = map_of<HD>(&tk, a.k, a, a.kv, kKeys)) != cudaSuccess ||
      (err = map_of<HD>(&tv, a.v, a, a.vv, kKeys)) != cudaSuccess ||
      (err = map_of<HD>(&tdo, a.dout, a, a.dov, 128)) != cudaSuccess)
    return err;
  const size_t smem = DqLayout<HD>::kBytes;
  if ((err = set_smem(splash_dq_kernel<HD>, smem)) != cudaSuccess) return err;
  const dim3 grid(a.S / 128, a.B * a.N);
  splash_dq_kernel<HD><<<grid, kWsThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.di, static_cast<bf16*>(a.dq), a.N, a.S, a.ov,
      a.map);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_f32(const Args& a) {
  const size_t smem = DkvSmem<HD>::kBytes;
  cudaError_t err = set_smem(splash_dkv_f32_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kTile, a.B * a.N);
  splash_dkv_f32_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.di, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.N,
      a.S, a.qv, a.kv, a.vv, a.dov, a.dkv, a.dvv, a.map);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_bf16(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = map_of<HD>(&tq, a.q, a, a.qv, 64)) != cudaSuccess ||
      (err = map_of<HD>(&tk, a.k, a, a.kv, 128)) != cudaSuccess ||
      (err = map_of<HD>(&tv, a.v, a, a.vv, 128)) != cudaSuccess ||
      (err = map_of<HD>(&tdo, a.dout, a, a.dov, 64)) != cudaSuccess)
    return err;
  const size_t smem = DkvLayout<HD>::kBytes;
  if ((err = set_smem(splash_dkv_kernel<HD>, smem)) != cudaSuccess) return err;
  const dim3 grid(a.S / 128, a.B * a.N);
  splash_dkv_kernel<HD><<<grid, kWsThreads, smem, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.di, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.N, a.S, a.dkv, a.dvv, a.map);
  return cudaGetLastError();
}

enum Kind { kFwd, kDq, kDkv };

template <int HD>
cudaError_t launch_f32(Kind kind, const Args& a) {
  switch (kind) {
    case kFwd: return launch_fwd_f32<HD>(a);
    case kDq: return launch_dq_f32<HD>(a);
    default: return launch_dkv_f32<HD>(a);
  }
}

template <int HD>
cudaError_t launch_bf16(Kind kind, const Args& a) {
  switch (kind) {
    case kFwd: return launch_fwd_bf16<HD>(a);
    case kDq: return launch_dq_bf16<HD>(a);
    default: return launch_dkv_bf16<HD>(a);
  }
}

// Shapes the kernels take: S a multiple of the 64-row tile, map blocks
// multiples of the compute tiles (128 rows in the frame of every bf16
// kernel, and 128 keys for the bf16 forward), head dim 64 or 128.  The
// dtype picks the kernel.
cudaError_t dispatch(Kind kind, int dtype, int head_dim, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.S <= 0) return cudaSuccess;
  if (a.S % kTile || a.map.row_block % kTile || a.map.col_block % kTile ||
      a.S % a.map.row_block || a.S % a.map.col_block ||
      (a.map.heads != 1 && a.map.heads != a.N))
    return cudaErrorInvalidValue;
  if (dtype == 1 &&
      (a.map.row_block % 128 || (kind == kFwd && a.map.col_block % 128)))
    return cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return launch_f32<64>(kind, a);
  if (dtype == 0 && head_dim == 128) return launch_f32<128>(kind, a);
  if (dtype == 1 && head_dim == 64) return launch_bf16<64>(kind, a);
  if (dtype == 1 && head_dim == 128) return launch_bf16<128>(kind, a);
  return cudaErrorInvalidValue;
}

Map make_map(const int* offsets, const int* lists, int heads, int row_block,
             int col_block, int S) {
  return Map{offsets, lists, heads, row_block, col_block, S / row_block,
             S / col_block};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  lse (and di)
// are f32 [B, N, S], contiguous.  `offsets` is int32 [map_heads] and
// `rows` int32 [map_heads, S / block_q, 1 + S / block_kv]: for each query
// block its count of non-empty kv blocks, then (kv block << 1) | full.
extern "C" cudaError_t rt_splash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* offsets, const int* rows, int dtype, int head_dim, int B,
    int N, int S, int map_heads, int block_q, int block_kv, long long q_sb,
    long long q_sn, long long q_ss, long long k_sb, long long k_sn,
    long long k_ss, long long v_sb, long long v_sn, long long v_ss,
    long long o_sb, long long o_sn, long long o_ss, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse_out = lse;
  a.B = B; a.N = N; a.S = S;
  a.qv = View{q_sb, q_sn, q_ss};
  a.kv = View{k_sb, k_sn, k_ss};
  a.vv = View{v_sb, v_sn, v_ss};
  a.ov = View{o_sb, o_sn, o_ss};
  a.map = make_map(offsets, rows, map_heads, block_q, block_kv, S);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kFwd, dtype, head_dim, a);
}

// As rt_splash_fwd; `di` = rowsum(o * do) f32 [B, N, S].
extern "C" cudaError_t rt_splash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, void* dq, const int* offsets,
    const int* rows, int dtype, int head_dim, int B, int N, int S,
    int map_heads, int block_q, int block_kv, long long q_sb, long long q_sn,
    long long q_ss, long long k_sb, long long k_sn, long long k_ss,
    long long v_sb, long long v_sn, long long v_ss, long long do_sb,
    long long do_sn, long long do_ss, long long dq_sb, long long dq_sn,
    long long dq_ss, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.di = di;
  a.dq = dq;
  a.B = B; a.N = N; a.S = S;
  a.qv = View{q_sb, q_sn, q_ss};
  a.kv = View{k_sb, k_sn, k_ss};
  a.vv = View{v_sb, v_sn, v_ss};
  a.dov = View{do_sb, do_sn, do_ss};
  a.ov = View{dq_sb, dq_sn, dq_ss};
  a.map = make_map(offsets, rows, map_heads, block_q, block_kv, S);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kDq, dtype, head_dim, a);
}

// As rt_splash_bwd_dq, with the transposed map: `cols` int32 [map_heads,
// S / block_kv, 1 + S / block_q], for each kv block its count of non-empty
// query blocks, then (query block << 1) | full.
extern "C" cudaError_t rt_splash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* di, void* dk, void* dv, const int* offsets,
    const int* cols, int dtype, int head_dim, int B, int N, int S,
    int map_heads, int block_q, int block_kv, long long q_sb, long long q_sn,
    long long q_ss, long long k_sb, long long k_sn, long long k_ss,
    long long v_sb, long long v_sn, long long v_ss, long long do_sb,
    long long do_sn, long long do_ss, long long dk_sb, long long dk_sn,
    long long dk_ss, long long dv_sb, long long dv_sn, long long dv_ss,
    void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.di = di;
  a.dk = dk; a.dv = dv;
  a.B = B; a.N = N; a.S = S;
  a.qv = View{q_sb, q_sn, q_ss};
  a.kv = View{k_sb, k_sn, k_ss};
  a.vv = View{v_sb, v_sn, v_ss};
  a.dov = View{do_sb, do_sn, do_ss};
  a.dkv = View{dk_sb, dk_sn, dk_ss};
  a.dvv = View{dv_sb, dv_sn, dv_ss};
  a.map = make_map(offsets, cols, map_heads, block_kv, block_q, S);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kDkv, dtype, head_dim, a);
}

// Message for an error code, so the wrapper can raise with it.
extern "C" const char* rt_error_string(cudaError_t err) {
  return cudaGetErrorString(err);
}
