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
//     block is a short loop of 64-wide compute tiles, and each tile is
//     classified by the same mask function (empty: skipped, full: no
//     masking, else masked per element);
//   * empty blocks are never loaded.
// The trip counts are data: they are read from the map, never derived from
// the tile index.  The map's block (block_q, block_kv, multiples of 128 as
// in the reference) is a multiple of the compute tile, so the reference's
// block knobs are set at run time with one compiled kernel.
//
// What bounds them.  At the Llama-2-7B attention shape (bf16, causal
// [2,32,4096,128]) the forward does 274.9 GFLOP of causal products (278 us
// at 989 TFLOP/s) against 134 MB of q/k/v/o (40 us at 3.35 TB/s); dq does
// three products (412.3 GFLOP, 417 us) and dk/dv four (549.8 GFLOP,
// 556 us).  All three are bound by the tensor cores: the design keeps the
// scores, p and ds in registers and feeds every product to mma.sync.
//
// Design (a first, simple kernel; wgmma, TMA and pipelining come later),
// the flash kernels' (csrc/flash_fwd.cu, csrc/flash_bwd.cu) with the map
// in place of the causal test:
//   * forward and dq: one block of 4 warps per (batch*head, 64-row query
//     tile), streaming 64-key K/V tiles through shared memory; each warp
//     owns 16 query rows;
//   * dk/dv: one block per (batch*head, 64-key tile) in the key frame,
//     streaming query tiles of the transposed map (64 rows, 32 at head dim
//     128); a key tile whose map column lists no query block writes zeros;
//   * bf16 runs every product on mma.sync m16n8k16 (f32 accumulate), the
//     score fragment reused in registers as the next product's A operand;
//     f32 uses scalar FMAs in the same fragment layout (no TF32);
//   * q, k, v, do and the outputs are addressed through element strides
//     for batch, head and sequence with the head dimension contiguous.
//
// Plain C entry points (no PyTorch headers): rt_splash_fwd,
// rt_splash_bwd_dq and rt_splash_bwd_dkv return the cudaError_t of the
// launch; the Python wrapper raises when it is nonzero.

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

// Query tiles of the dk/dv kernel: 64 rows, 32 at head dim 128.
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
// then bf16: one transposed [HD][kKeys + 8] tile (V^T for the forward, K^T
// for dq), or f32: one scratch tile [16][kKeys + 4] per warp.
template <typename T, int HD, int kOwn>
struct QFrameSmem {
  static constexpr int kP = Pitch<T, HD>::kRow;
  static constexpr size_t kTiles = (size_t)(kOwn + 2) * kTile * kP * sizeof(T);
  static constexpr size_t kBytes =
      kTiles + (sizeof(T) == 2
                    ? (size_t)HD * (kKeys + 8) * sizeof(T)
                    : (size_t)kWarps * 16 * (kKeys + 4) * sizeof(float));
};

// ------------------------------------------------------------------ forward

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    splash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int N, int S, View qv, View kv,
                      View vv, View ov, Map map) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Smem = QFrameSmem<T, HD, 1>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kP = Smem::kP;
  constexpr int kNT = kKeys / 8;

  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kTile * kP;
  T* vs = ks + kKeys * kP;
  unsigned char* tail = smem_raw + Smem::kTiles;
  T* vts = reinterpret_cast<T*>(tail);                  // bf16: V^T
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
      load_rows<T, HD, kKeys>(ks, kP, kb, kv.s, k0, S);
      if constexpr (kBf16)
        load_transposed<HD, kKeys>(vts, vb, vv.s, k0, S);
      else
        load_rows<T, HD, kKeys>(vs, kP, vb, vv.s, k0, S);
      __syncthreads();

      float s[kNT][4];
      product_abt<T, HD, kNT>(s, qs + wr * kP, kP, ks, kP);  // q k^T

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

      // acc += p v
      if constexpr (kBf16)
        accumulate_pm<T, HD, kKeys>(acc, s, vts, kKeys + 8, nullptr);
      else
        accumulate_pm<T, HD, kKeys>(acc, s, vs, kP, scratch);
    }
  }

  // o = acc * (1 / l), logsumexp = m + log(l)
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  store_rows<T, HD>(o + b * ov.b + n * ov.n, ov.s, q0 + wr, S, acc,
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

// ------------------------------------------------------------------ dk, dv

template <typename T, int HD>
struct DkvSmem {
  static constexpr int kP = Pitch<T, HD>::kRow;
  static constexpr int kQ = DkvTile<HD>::kQ;
  // K, V (the block's own keys) and Q, dO (streamed) row-major; then bf16:
  // Q^T and dO^T [HD][kQ + 8], or f32: one scratch tile [16][kQ + 4] per
  // warp; then lse and di of the query tile, f32 [kQ] each.
  static constexpr size_t kTiles = (size_t)(2 * kTile + 2 * kQ) * kP * sizeof(T);
  static constexpr size_t kExtra =
      sizeof(T) == 2 ? (size_t)2 * HD * (kQ + 8) * sizeof(T)
                     : (size_t)kWarps * 16 * (kQ + 4) * sizeof(float);
  static constexpr size_t kBytes = kTiles + kExtra + 2 * kQ * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    splash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, T* __restrict__ dk,
                      T* __restrict__ dv, int N, int S, View qv, View kv,
                      View vv, View dov, View dkv_, View dvv, Map map) {
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
  float* di_s = lse_s + kQ;

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int k0 = blockIdx.x * kTile;  // low key tiles see the most queries
  const int off = map.offsets[map.heads == 1 ? 0 : n];
  const int* col = map_row(map, n, k0 / map.row_block);
  const int count = col[0];
  const T* qb = q + b * qv.b + n * qv.n;
  const T* dob = dout + b * dov.b + n * dov.n;
  const float* lse_b = lse + (long long)bn * S;
  const float* di_b = di + (long long)bn * S;

  load_rows<T, HD, kTile>(ks, kP, k + b * kv.b + n * kv.n, kv.s, k0, S);
  load_rows<T, HD, kTile>(vs, kP, v + b * vv.b + n * vv.n, vv.s, k0, S);

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
      load_rows<T, HD, kQ>(qs, kP, qb, qv.s, q0, S);
      load_rows<T, HD, kQ>(dos, kP, dob, dov.s, q0, S);
      if constexpr (kBf16) {
        load_transposed<HD, kQ>(qts, qb, qv.s, q0, S);
        load_transposed<HD, kQ>(dots, dob, dov.s, q0, S);
      }
      for (int r = threadIdx.x; r < kQ; r += kThreads) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse_b[q0 + r] * kLog2e : 0.f;
        di_s[r] = in ? di_b[q0 + r] : 0.f;
      }
      __syncthreads();

      // p^T = exp(s^T - lse[query]), 0 where masked
      float s[kNT][4];
      product_abt<T, HD, kNT>(s, ks + wr * kP, kP, qs, kP);  // k q^T
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

      // dv += p^T do
      if constexpr (kBf16)
        accumulate_pm<T, HD, kQ>(acc_v, s, dots, kQ + 8, nullptr);
      else
        accumulate_pm<T, HD, kQ>(acc_v, s, dos, kP, scratch);

      // ds^T = (dp^T - di[query]) * p^T, dp^T = v do^T
      float dp[kNT][4];
      product_abt<T, HD, kNT>(dp, vs + wr * kP, kP, dos, kP);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          s[j][e] = (dp[j][e] - di_s[c]) * s[j][e];
        }
      }

      // dk += ds^T q
      if constexpr (kBf16)
        accumulate_pm<T, HD, kQ>(acc_k, s, qts, kQ + 8, nullptr);
      else
        accumulate_pm<T, HD, kQ>(acc_k, s, qs, kP, scratch);
    }
  }
  store_rows<T, HD>(dk + b * dkv_.b + n * dkv_.n, dkv_.s, k0 + wr, S, acc_k);
  store_rows<T, HD>(dv + b * dvv.b + n * dvv.n, dvv.s, k0 + wr, S, acc_v);
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

template <typename T, int HD>
cudaError_t launch_fwd(const Args& a) {
  const size_t smem = QFrameSmem<T, HD, 1>::kBytes;
  cudaError_t err = set_smem(splash_fwd_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kTile, a.B * a.N);
  splash_fwd_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse_out, a.N, a.S,
      a.qv, a.kv, a.vv, a.ov, a.map);
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

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = DkvSmem<T, HD>::kBytes;
  cudaError_t err = set_smem(splash_dkv_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kTile, a.B * a.N);
  splash_dkv_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.N, a.S, a.qv, a.kv,
      a.vv, a.dov, a.dkv, a.dvv, a.map);
  return cudaGetLastError();
}

enum Kind { kFwd, kDq, kDkv };

template <typename T, int HD>
cudaError_t launch(Kind kind, const Args& a) {
  switch (kind) {
    case kFwd: return launch_fwd<T, HD>(a);
    case kDq: return launch_dq<T, HD>(a);
    default: return launch_dkv<T, HD>(a);
  }
}

// Shapes the kernels take: S a multiple of the 64-row tile, map blocks
// multiples of the compute tiles, head dim 64 or 128.
cudaError_t dispatch(Kind kind, int dtype, int head_dim, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.S <= 0) return cudaSuccess;
  if (a.S % kTile || a.map.row_block % kTile || a.map.col_block % kTile ||
      a.S % a.map.row_block || a.S % a.map.col_block ||
      (a.map.heads != 1 && a.map.heads != a.N))
    return cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(kind, a);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(kind, a);
  if (dtype == 1 && head_dim == 64) return launch<bf16, 64>(kind, a);
  if (dtype == 1 && head_dim == 128) return launch<bf16, 128>(kind, a);
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
