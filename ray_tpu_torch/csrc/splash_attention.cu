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
// bf16 forward, `splash_fwd_kernel` (replaces `flash_attention_kernel`;
// bound 278 us at that shape), and bf16 dk/dv, `splash_dkv_kernel`
// (replaces `_flash_attention_dkv_kernel`; bound 556 us), are built on
// wgmma, TMA and warp specialisation.  Against the five limits of the
// first (mma.sync) design that they replace:
//   1. wgmma: every product is wgmma (m64nNk16, f32 accumulate), the only
//      instruction that reaches the tensor cores' full rate;
//   2. TMA ring: a producer warpgroup, one thread of which issues every
//      load (cp.async.bulk.tensor, completion on mbarriers), feeds a
//      2-stage ring of tiles in shared memory with full/empty barriers,
//      so the next tile lands while the consumers compute; the producer
//      gives its registers up (setmaxnreg.dec 24) to the two consumer
//      warpgroups (setmaxnreg.inc 240);
//   3. no transposes: wgmma reads a row-major B operand through its
//      transpose flag, so V (forward) and Q, dO (dk/dv) are used as TMA
//      wrote them;
//   4. larger tiles, no fragment reloads: 128 query rows (forward) or 128
//      keys (dk/dv) per block, two consumer warpgroups of 64 each, the
//      resident operand read by wgmma straight from shared memory;
//   5. registers: the accumulators (forward S and O, 64 + 64 f32 at
//      H=128; dk/dv dK and dV, 64 + 64, with S^T and dP^T 32 + 32) fit in
//      the consumers' 240 registers, so dk/dv streams 64-row query tiles
//      at both head dims.
// Forward: one block per (batch*head, 128-row query tile), late rows first.
// Q is loaded once; 128-key K and V tiles stream through the ring.
// S = Q K^T reads both from shared memory (K-major); P is rounded to bf16
// in registers and is the A operand of O += P V.  The online softmax (m, l
// in f32, exp2) stays in registers.  dk/dv (FlashAttention-3's backward in
// the key frame, without dq): one block per (batch*head, 128-key tile),
// lowest key tiles first; K and V stay resident; 64-row Q and dO tiles
// with their lse and di stream through the ring along the transposed map.
// Per tile: S^T = K Q^T, P^T = exp2(S^T log2e - lse) (masked on partial
// tiles), dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - di),
// dK += dS^T Q.  dK and dV are stored once in bf16: no atomics, so results
// are deterministic.  Both read q, k, v, do through 4-d TMA maps over
// [B, N, S, H] with the caller's strides and 128-byte swizzle (a tile of
// H=128 is two 64-column boxes), matched by the wgmma descriptors; the
// maps are encoded on the host for each launch.
//
// dq in both types, and the f32 forward and dk/dv: the first, simple
// design (the flash kernels' of csrc/flash_fwd.cu and csrc/flash_bwd.cu
// with the map in place of the causal test):
//   * forward and dq: one block of 4 warps per (batch*head, 64-row query
//     tile), streaming 64-key K/V tiles through shared memory; each warp
//     owns 16 query rows;
//   * dk/dv: one block per (batch*head, 64-key tile) in the key frame,
//     streaming query tiles of the transposed map (64 rows, 32 at head dim
//     128); a key tile whose map column lists no query block writes zeros;
//   * bf16 dq runs every product on mma.sync m16n8k16 (f32 accumulate),
//     the score fragment reused in registers as the next product's A
//     operand; f32 uses scalar FMAs in the same fragment layout (no TF32);
//   * q, k, v, do and the outputs are addressed through element strides
//     for batch, head and sequence with the head dimension contiguous.
// The dtype picks the kernel; nothing falls back from one to the other.
//
// Plain C entry points (no PyTorch headers): rt_splash_fwd,
// rt_splash_bwd_dq and rt_splash_bwd_dkv return the cudaError_t of the
// launch; the Python wrapper raises when it is nonzero.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;   // rows a block owns (query rows or key rows)
constexpr int kKeys = 64;   // forward and dq: keys per streamed K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

struct View {  // element strides of a [B, N, S, H] view, H contiguous
  long long b, n, s;
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ============================================================ mma.sync
// The first design: bf16 and f32 dq, f32 forward and dk/dv.

// Query tiles of the f32 dk/dv kernel: 64 rows, 32 at head dim 128.
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
// column as one 32-bit word.  bf16 only (K^T of the dq kernel).
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
// 8*NT rows of another; both [.., HD].
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
// layout above (rounded to T for bf16).  bf16: M is staged transposed,
// mt[d][row] with pitch KT + 8, and P is reused in registers as the A
// operand.  f32: M is row-major with pitch mp, and P goes through the
// warp's shared scratch tile [16][KT + 4].
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
// slab, each scaled by its row's factor; rows at or past S are skipped.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* base, long long ss, int row0,
                                           int S, const float (&acc)[HD / 8][4],
                                           float f0 = 1.f, float f1 = 1.f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= S) continue;
    const float f = h ? f1 : f0;
    T* r = base + row * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float x = acc[j][2 * h] * f, y = acc[j][2 * h + 1] * f;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(r + j * 8) =
            __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(r + j * 8) = make_float2(x, y);
    }
  }
}

// Shared memory of the query-frame kernels: the block's query-side tiles
// (Q for the forward; Q and dO for dq) and the streamed K and V row-major,
// then bf16: one transposed [HD][kKeys + 8] tile (K^T for dq), or f32: one
// scratch tile [16][kKeys + 4] per warp.
template <typename T, int HD, int kOwn>
struct QFrameSmem {
  static constexpr int kP = Pitch<T, HD>::kRow;
  static constexpr size_t kTiles = (size_t)(kOwn + 2) * kTile * kP * sizeof(T);
  static constexpr size_t kBytes =
      kTiles + (sizeof(T) == 2
                    ? (size_t)HD * (kKeys + 8) * sizeof(T)
                    : (size_t)kWarps * 16 * (kKeys + 4) * sizeof(float));
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
  using Smem = QFrameSmem<float, HD, 1>;
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

  load_rows<float, HD, kTile>(qs, kP, q + b * qv.b + n * qv.n, qv.s, q0, S);

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
      load_rows<float, HD, kKeys>(ks, kP, kb, kv.s, k0, S);
      load_rows<float, HD, kKeys>(vs, kP, vb, vv.s, k0, S);
      __syncthreads();

      float s[kNT][4];
      product_abt<float, HD, kNT>(s, qs + wr * kP, kP, ks, kP);  // q k^T

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

      accumulate_pm<float, HD, kKeys>(acc, s, vs, kP, scratch);  // += p v
    }
  }

  // o = acc * (1 / l), logsumexp = m + log(l)
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  store_rows<float, HD>(o + b * ov.b + n * ov.n, ov.s, q0 + wr, S, acc,
                        1.f / l0, 1.f / l1);
  if (t == 0) {
    float* lse_b = lse + (long long)bn * S;
    if (row0 < S) lse_b[row0] = (m0 + log2f(l0)) * kLn2;
    if (row1 < S) lse_b[row1] = (m1 + log2f(l1)) * kLn2;
  }
}

// ------------------------------------------------------------------ dq

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    splash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dq, int N,
                     int S, View qv, View kv, View vv, View dov, View dqv,
                     Map map) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = QFrameSmem<T, HD, 2>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kP = Smem::kP;
  constexpr int kNT = kKeys / 8;

  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kTile * kP;
  T* ks = dos + kTile * kP;
  T* vs = ks + kKeys * kP;
  unsigned char* tail = smem_raw + Smem::kTiles;
  T* kts = reinterpret_cast<T*>(tail);                  // bf16: K^T
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* scratch = reinterpret_cast<float*>(tail) +     // f32: per warp
                   warp * 16 * (kKeys + 4);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // late rows first
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* row = map_row(map, n, q0 / map.row_block);
  const int count = row[0];
  const T* kb = k + b * kv.b + n * kv.n;
  const T* vb = v + b * vv.b + n * vv.n;

  load_rows<T, HD, kTile>(qs, kP, q + b * qv.b + n * qv.n, qv.s, q0, S);
  load_rows<T, HD, kTile>(dos, kP, dout + b * dov.b + n * dov.n, dov.s, q0, S);

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
      load_rows<T, HD, kKeys>(ks, kP, kb, kv.s, k0, S);
      load_rows<T, HD, kKeys>(vs, kP, vb, vv.s, k0, S);
      if constexpr (kBf16) load_transposed<HD, kKeys>(kts, kb, kv.s, k0, S);
      __syncthreads();

      float s[kNT][4], dp[kNT][4];
      product_abt<T, HD, kNT>(s, qs + wr * kP, kP, ks, kP);    // q k^T
      product_abt<T, HD, kNT>(dp, dos + wr * kP, kP, vs, kP);  // do v^T

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

      // dq += ds k
      if constexpr (kBf16)
        accumulate_pm<T, HD, kKeys>(acc, s, kts, kKeys + 8, nullptr);
      else
        accumulate_pm<T, HD, kKeys>(acc, s, ks, kP, scratch);
    }
  }
  store_rows<T, HD>(dq + b * dqv.b + n * dqv.n, dqv.s, q0 + wr, S, acc);
}

// ------------------------------------------------------------ f32 dk, dv

template <int HD>
struct DkvSmem {
  static constexpr int kP = Pitch<float, HD>::kRow;
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

  load_rows<float, HD, kTile>(ks, kP, k + b * kv.b + n * kv.n, kv.s, k0, S);
  load_rows<float, HD, kTile>(vs, kP, v + b * vv.b + n * vv.n, vv.s, k0, S);

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
      load_rows<float, HD, kQ>(qs, kP, qb, qv.s, q0, S);
      load_rows<float, HD, kQ>(dos, kP, dob, dov.s, q0, S);
      for (int r = threadIdx.x; r < kQ; r += kThreads) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse_b[q0 + r] * kLog2e : 0.f;
        di_s[r] = in ? di_b[q0 + r] : 0.f;
      }
      __syncthreads();

      // p^T = exp(s^T - lse[query]), 0 where masked
      float s[kNT][4];
      product_abt<float, HD, kNT>(s, ks + wr * kP, kP, qs, kP);  // k q^T
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

      accumulate_pm<float, HD, kQ>(acc_v, s, dos, kP, scratch);  // += p^T do

      // ds^T = (dp^T - di[query]) * p^T, dp^T = v do^T
      float dp[kNT][4];
      product_abt<float, HD, kNT>(dp, vs + wr * kP, kP, dos, kP);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          s[j][e] = (dp[j][e] - di_s[c]) * s[j][e];
        }
      }

      accumulate_pm<float, HD, kQ>(acc_k, s, qs, kP, scratch);  // += ds^T q
    }
  }
  store_rows<float, HD>(dk + b * dkv_.b + n * dkv_.n, dkv_.s, k0 + wr, S,
                        acc_k);
  store_rows<float, HD>(dv + b * dvv.b + n * dvv.n, dvv.s, k0 + wr, S, acc_v);
}

// ============================================================ Hopper
// The bf16 forward and dk/dv: mbarriers, TMA, wgmma and setmaxnreg in
// inline PTX.

constexpr int kWg = 128;                // threads of a warpgroup
constexpr int kWsThreads = 3 * kWg;     // one producer, two consumers
constexpr int kConsumerWarps = 8;
constexpr int kStages = 2;              // depth of the TMA ring
constexpr int kRowBytes = 128;          // a swizzled box row: 64 bf16
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128*24 + 256*240
                                                        // <= 65536

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One box of a 4-d map (coordinates innermost first: column, row, head,
// batch) into shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int n, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(n), "r"(b)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving other reads or writes of wgmma registers
// across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle that
// the TMA writes: start address, leading and stride byte offsets.  K-major
// operands (rows of 128 bytes along the reduction): stride 1024 bytes per 8
// rows, leading offset unused; a 16-column step adds 32 bytes to the start.
// MN-major operands (the transposed B): stride 1024 bytes per 8 rows along
// the reduction, leading offset = the bytes from one 64-column box to the
// next.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

#define RT_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define RT_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define RT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RT_F16(d, i) RT_F4(d, i), RT_F4(d, i + 4), RT_F4(d, i + 8), \
                     RT_F4(d, i + 12)
#define RT_F32(d) RT_F16(d, 0), RT_F16(d, 16)
#define RT_F64(d) RT_F16(d, 0), RT_F16(d, 16), RT_F16(d, 32), RT_F16(d, 48)

// d[64 x N] = A[64 x 16] B[16 x N] (+ d unless `acc` is 0) for the
// warpgroup, A and B from shared memory, both K-major.  The accumulator
// layout (as mma.sync's C per warp w of the warpgroup): thread (g = lane /
// 4, t = lane % 4) holds d[4j + {0, 1}] at row 16w + g and d[4j + {2, 3}]
// at row 16w + g + 8, columns 8j + 2t + {0, 1}.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_F32(d)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RT_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RT_F64(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x N] += A[64 x 16] B[16 x N]: A in registers (mma.sync's A fragment
// per warp), B from shared memory MN-major (the transpose flag).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_t(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RT_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The A fragments of a [64 x 16 KT] product from a [64 x 16 KT] f32
// accumulator (rounded to bf16): k-step kk takes n-tiles 2kk and 2kk + 1.
template <int KT>
__device__ __forceinline__ void to_a_fragments(uint32_t (&a)[KT][4],
                                               const float (&x)[8 * KT]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Store a warpgroup's [64, HD] accumulator (this thread's rows r0 and
// r0 + 8 of the bf16 slab at `base`, row stride ss), each row scaled.
template <int HD>
__device__ __forceinline__ void store_bf16(bf16* base, long long ss, int r0,
                                           const float (&x)[HD / 2],
                                           float f0 = 1.f, float f1 = 1.f) {
  const int t = threadIdx.x % 4;
  bf16* p0 = base + r0 * ss + 2 * t;
  bf16* p1 = p0 + 8 * ss;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(p0 + 8 * j) =
        __floats2bfloat162_rn(x[4 * j] * f0, x[4 * j + 1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(p1 + 8 * j) =
        __floats2bfloat162_rn(x[4 * j + 2] * f1, x[4 * j + 3] * f1);
  }
}

// --------------------------------------------------------- bf16 forward

// Shared memory of the bf16 forward from a 1024-byte aligned base: Q
// [128][HD], then per stage K and V [128][HD], each tile HD / 64 boxes of
// [128 rows][128 bytes]; then the mbarriers q_full, full[kStages],
// empty[kStages].
template <int HD>
struct FwdLayout {
  static constexpr uint32_t kBox = 128 * kRowBytes;
  static constexpr uint32_t kTile = kBox * (HD / 64);
  static constexpr uint32_t kBars = kTile * (1 + 2 * kStages);
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

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
  auto k_tile = [=](int s) { return base + L::kTile * (1 + 2 * s); };
  auto v_tile = [=](int s) { return base + L::kTile * (2 + 2 * s); };
  auto full = [=](int s) { return q_full + 8 * (1 + s); };
  auto empty = [=](int s) { return q_full + 8 * (1 + kStages + s); };

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 128;  // late rows first
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* row = map_row(map, n, q0 / map.row_block);
  const int count = row[0];

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // Producer: one thread loads Q, then the K/V tile of every non-empty
    // 128-key compute tile of the map row, in the consumers' order.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int h = 0; h < HD / 64; ++h)
        tma_load(base + h * L::kBox, &tq, q_full, h * 64, q0, n, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < count; ++i) {
        const int entry = row[1 + i];
        const int kstart = (entry >> 1) * map.col_block;
        for (int k0 = kstart; k0 < kstart + map.col_block; k0 += 128) {
          if (!(entry & 1) && tile_kind(q0, 128, k0, 128, off) == 0)
            continue;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), 2 * L::kTile);
          for (int h = 0; h < HD / 64; ++h) {
            tma_load(k_tile(stage) + h * L::kBox, &tk, full(stage), h * 64,
                     k0, n, b);
            tma_load(v_tile(stage) + h * L::kBox, &tv, full(stage), h * 64,
                     k0, n, b);
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
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * c + 16 * w + g, row1 = row0 + 8;
    const uint32_t q_rows = base + 64 * c * kRowBytes;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = kMaskValue, m1 = kMaskValue;  // running max, log2 domain
    float l0 = 0.f, l1 = 0.f;                // this lane's share of the sum

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
        const uint32_t ks = k_tile(stage), vs = v_tile(stage);

        // s = q k^T, 16 head columns a step
        float s[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t col = (kk / 4) * L::kBox + (kk % 4) * 32;
          wgmma_ss(s, sw128_desc(q_rows + col, 16, 1024),
                   sw128_desc(ks + col, 16, 1024), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // log2 domain; masked scores take the mask value itself (scaling
        // it by log2(e) would overflow to -inf)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * kLog2e;
            if (kind == 1) {
              const int col = k0 + j * 8 + 2 * t + (e & 1);
              if ((e < 2 ? row0 : row1) + off < col) x = kMaskValue;
            }
            s[4 * j + e] = x;
          }
        }

        // online softmax: the 4 lanes of a quad share a row
        float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
        for (int j = 0; j < 16; ++j) {
          s[4 * j] = exp2f(s[4 * j] - mn0);
          s[4 * j + 1] = exp2f(s[4 * j + 1] - mn0);
          s[4 * j + 2] = exp2f(s[4 * j + 2] - mn1);
          s[4 * j + 3] = exp2f(s[4 * j + 3] - mn1);
          rs0 += s[4 * j] + s[4 * j + 1];
          rs1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = l0 * alpha0 + rs0;
        l1 = l1 * alpha1 + rs1;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[4 * j] *= alpha0;
          acc[4 * j + 1] *= alpha0;
          acc[4 * j + 2] *= alpha1;
          acc[4 * j + 3] *= alpha1;
        }

        // acc += p v: p in registers, v row-major read transposed
        uint32_t p[8][4];
        to_a_fragments<8>(p, s);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_rs_t(acc, p[kk],
                     sw128_desc(vs + kk * 16 * kRowBytes, L::kBox, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);

        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));  // the stage is free
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

    // o = acc * (1 / l), logsumexp = m + log(l)
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    store_bf16<HD>(o + b * ov.b + n * ov.n, ov.s, row0, acc, 1.f / l0,
                   1.f / l1);
    if (t == 0) {
      float* lse_b = lse + (long long)bn * S;
      lse_b[row0] = (m0 + log2f(l0)) * kLn2;
      lse_b[row1] = (m1 + log2f(l1)) * kLn2;
    }
  }
}

// ----------------------------------------------------------- bf16 dk, dv

// Shared memory of the bf16 dk/dv kernel from a 1024-byte aligned base: K
// and V [128][HD] (resident), then per stage Q and dO [64][HD], each tile
// HD / 64 swizzled boxes; then per stage lse and di of the query tile (f32
// [64] each); then the mbarriers kv_full, full[kStages], empty[kStages].
template <int HD>
struct DkvLayout {
  static constexpr uint32_t kKBox = 128 * kRowBytes;
  static constexpr uint32_t kKTile = kKBox * (HD / 64);
  static constexpr uint32_t kQBox = 64 * kRowBytes;
  static constexpr uint32_t kQTile = kQBox * (HD / 64);
  static constexpr uint32_t kRing = 2 * kKTile;
  static constexpr uint32_t kStats = kRing + 2 * kQTile * kStages;
  static constexpr uint32_t kBars = kStats + 512 * kStages;
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

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
  auto q_tile = [=](int s) { return base + L::kRing + 2 * L::kQTile * s; };
  auto do_tile = [=](int s) { return q_tile(s) + L::kQTile; };
  auto stats = [=](int s) { return L::kStats + 512 * s; };  // from base
  auto full = [=](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [=](int s) { return kv_full + 8 * (1 + kStages + s); };

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int k0 = blockIdx.x * 128;  // low key tiles see the most queries
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* col = map_row(map, n, k0 / map.row_block);
  const int count = col[0];

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

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
            tma_load(q_tile(stage) + h * L::kQBox, &tq, full(stage), h * 64,
                     q0, n, b);
            tma_load(do_tile(stage) + h * L::kQBox, &tdo, full(stage),
                     h * 64, q0, n, b);
          }
          bulk_load(base + stats(stage), lse_b + q0, 256, full(stage));
          bulk_load(base + stats(stage) + 256, di_b + q0, 256, full(stage));
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
    const int g = lane / 4, t = lane % 4;
    const int key0 = k0 + 64 * c + 16 * w + g, key1 = key0 + 8;
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
        const uint32_t qs = q_tile(stage), dos = do_tile(stage);
        const float* lse_s = reinterpret_cast<const float*>(sm + stats(stage));
        const float* di_s = lse_s + 64;

        // s^T = k q^T
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t kc = (kk / 4) * L::kKBox + (kk % 4) * 32;
          const uint32_t qc = (kk / 4) * L::kQBox + (kk % 4) * 32;
          wgmma_ss(s, sw128_desc(k_rows + kc, 16, 1024),
                   sw128_desc(qs + qc, 16, 1024), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // p^T = exp(s^T - lse[query]), 0 where masked
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + 2 * t + (e & 1);
            float p = exp2f(s[4 * j + e] * kLog2e - lse_s[qc] * kLog2e);
            if (kind == 1 && q0 + qc + off < (e < 2 ? key0 : key1)) p = 0.f;
            s[4 * j + e] = p;
          }
        }

        // dv += p^T do (do read transposed); dp^T = v do^T
        uint32_t pa[4][4];
        to_a_fragments<4>(pa, s);
        float dp[32];
        fence_regs(acc_v);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_t(acc_v, pa[kk],
                     sw128_desc(dos + kk * 16 * kRowBytes, L::kQBox, 1024));
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t kc = (kk / 4) * L::kKBox + (kk % 4) * 32;
          const uint32_t qc = (kk / 4) * L::kQBox + (kk % 4) * 32;
          wgmma_ss(dp, sw128_desc(v_rows + kc, 16, 1024),
                   sw128_desc(dos + qc, 16, 1024), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc_v);
        fence_regs(dp);

        // ds^T = (dp^T - di[query]) * p^T; dk += ds^T q (q read transposed)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + 2 * t + (e & 1);
            dp[4 * j + e] = (dp[4 * j + e] - di_s[qc]) * s[4 * j + e];
          }
        }
        uint32_t da[4][4];
        to_a_fragments<4>(da, dp);
        fence_regs(acc_k);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_t(acc_k, da[kk],
                     sw128_desc(qs + kk * 16 * kRowBytes, L::kQBox, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc_k);

        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));  // the stage is free
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    store_bf16<HD>(dk + b * dkv_.b + n * dkv_.n, dkv_.s, key0, acc_k);
    store_bf16<HD>(dv + b * dvv.b + n * dvv.n, dvv.s, key0, acc_v);
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

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once at run time, so the
// library links no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d TMA map over a bf16 [B, N, S, H] view with element strides `v` (H
// contiguous; base and byte strides 16-byte aligned, as the wrapper
// checks): boxes of 64 columns by `rows` rows, 128-byte swizzle.  A
// dimension of extent 1 is never stepped, so its stride, which a view may
// leave at any value, is replaced by a packed one.
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, const Args& a,
                     int H, View v, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)H, (cuuint64_t)a.S,
                              (cuuint64_t)a.N, (cuuint64_t)a.B};
  cuuint64_t strides[3] = {(cuuint64_t)v.s * 2, (cuuint64_t)v.n * 2,
                           (cuuint64_t)v.b * 2};
  if (a.N == 1) strides[1] = strides[0] * a.S;
  if (a.B == 1) strides[2] = strides[1] * a.N;
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_fwd_f32(const Args& a) {
  const size_t smem = QFrameSmem<float, HD, 1>::kBytes;
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
  if ((err = bf16_map(&tq, a.q, a, HD, a.qv, 128)) != cudaSuccess ||
      (err = bf16_map(&tk, a.k, a, HD, a.kv, 128)) != cudaSuccess ||
      (err = bf16_map(&tv, a.v, a, HD, a.vv, 128)) != cudaSuccess)
    return err;
  const size_t smem = FwdLayout<HD>::kBytes;
  if ((err = set_smem(splash_fwd_kernel<HD>, smem)) != cudaSuccess) return err;
  const dim3 grid(a.S / 128, a.B * a.N);
  splash_fwd_kernel<HD><<<grid, kWsThreads, smem, a.stream>>>(
      tq, tk, tv, static_cast<bf16*>(a.o), a.lse_out, a.N, a.S, a.ov, a.map);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = QFrameSmem<T, HD, 2>::kBytes;
  cudaError_t err = set_smem(splash_dq_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kTile, a.B * a.N);
  splash_dq_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dq), a.N, a.S, a.qv, a.kv, a.vv, a.dov, a.ov, a.map);
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
  if ((err = bf16_map(&tq, a.q, a, HD, a.qv, 64)) != cudaSuccess ||
      (err = bf16_map(&tk, a.k, a, HD, a.kv, 128)) != cudaSuccess ||
      (err = bf16_map(&tv, a.v, a, HD, a.vv, 128)) != cudaSuccess ||
      (err = bf16_map(&tdo, a.dout, a, HD, a.dov, 64)) != cudaSuccess)
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
    case kDq: return launch_dq<float, HD>(a);
    default: return launch_dkv_f32<HD>(a);
  }
}

template <int HD>
cudaError_t launch_bf16(Kind kind, const Args& a) {
  switch (kind) {
    case kFwd: return launch_fwd_bf16<HD>(a);
    case kDq: return launch_dq<bf16, HD>(a);
    default: return launch_dkv_bf16<HD>(a);
  }
}

// Shapes the kernels take: S a multiple of the 64-row tile, map blocks
// multiples of the compute tiles (128 rows in the frame of the bf16
// forward and dk/dv, and 128 keys for the bf16 forward), head dim 64 or
// 128.  The dtype picks the kernel.
cudaError_t dispatch(Kind kind, int dtype, int head_dim, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.S <= 0) return cudaSuccess;
  if (a.S % kTile || a.map.row_block % kTile || a.map.col_block % kTile ||
      a.S % a.map.row_block || a.S % a.map.col_block ||
      (a.map.heads != 1 && a.map.heads != a.N))
    return cudaErrorInvalidValue;
  if (dtype == 1 && kind != kDq &&
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
