// Hopper (sm_90a) building blocks shared by the warp-specialised kernels of
// csrc/flash_fwd.cu, csrc/flash_bwd.cu and csrc/splash_attention.cu:
// mbarriers, TMA loads and their tensor maps, wgmma with its shared-memory
// descriptors, setmaxnreg, the forward's tile of the online softmax that
// both forwards run, and the dq and dk/dv tiles that both backwards run.
//
// Each source that includes this header is its own library (one nvcc per
// source, see ops/_build.py), so everything here has internal linkage: it
// lives in the anonymous namespace of the including translation unit.
//
// The design these pieces serve (FlashAttention-3's): a block of three
// warpgroups.  One thread of the producer warpgroup issues every load
// (cp.async.bulk.tensor, completion on mbarriers) into a ring of kStages
// tiles in shared memory with full/empty barriers, then the producer gives
// its registers up (setmaxnreg.dec 24) to the two consumer warpgroups
// (setmaxnreg.inc 240), which run every product on wgmma (m64nNk16, f32
// accumulate) with operands read from shared memory in the 128-byte
// swizzle that the TMA writes.  wgmma reads a row-major B operand through
// its transpose flag, so no tile is ever transposed in shared memory.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kWg = 128;                // threads of a warpgroup
constexpr int kWsThreads = 3 * kWg;     // one producer, two consumers
constexpr int kConsumerWarps = 8;
constexpr int kStages = 2;              // depth of the TMA ring
constexpr int kRowBytes = 128;          // a swizzled box row: 64 bf16
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128*24 + 256*240
                                                        // <= 65536

struct View {  // element strides of a [B, N, S, H] view, H contiguous
  long long b, n, s;
};

// A compile-time flag passed by value, to pick a template instantiation
// from a uniform run-time test.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by one MUFU.EX2 (subnormal results flush to zero).  exp2f, short of
// fast-math, wraps the same instruction in a subnormal-handling sequence,
// and the softmax of these kernels is bound by its ALU work, not by the
// tensor cores.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

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

// Thread 0 of the block initialises the block's barriers: `first` with one
// arrival (the producer's expect_tx), then full[kStages] with one arrival
// each and empty[kStages] with one per consumer warp, 8 bytes apart.
__device__ __forceinline__ void init_ring_barriers(uint32_t first) {
  if (threadIdx.x == 0) {
    mbar_init(first, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(first + 8 * (1 + s), 1);
      mbar_init(first + 8 * (1 + kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ------------------------------------------------------------------- TMA

// One box of a 4-d map (coordinates innermost first: column, row, head,
// batch) into shared memory; its bytes complete on `bar`.  Rows past the
// map's extent arrive as zeros and count toward the bytes.
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

// ----------------------------------------------------------------- wgmma

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

// The start of 16-column step kk of a K-major tile of `box`-byte boxes.
__device__ __forceinline__ uint32_t k_step(uint32_t box, int kk) {
  return (kk / 4) * box + (kk % 4) * 32;
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

// Store a warpgroup's [64, HD] accumulator: this thread's rows r0 and
// r0 + 8 of the bf16 slab at `base` (row stride ss), each row scaled; rows
// at or past S are skipped.
template <int HD>
__device__ __forceinline__ void store_bf16(bf16* base, long long ss, int r0,
                                           int S, const float (&x)[HD / 2],
                                           float f0 = 1.f, float f1 = 1.f) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= S) continue;
    const float f = h ? f1 : f0;
    bf16* p = base + (r0 + 8 * h) * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          x[4 * j + 2 * h] * f, x[4 * j + 2 * h + 1] * f);
  }
}

// ------------------------------------------------------- the forward tile

// Shared memory of both bf16 forwards from a 1024-byte aligned base: Q
// [128][HD], then per stage K and V [128][HD], each tile HD / 64 boxes of
// [128 rows][128 bytes]; then the mbarriers q_full, full[kStages],
// empty[kStages].
template <int HD>
struct FwdLayout {
  static constexpr uint32_t kBox = 128 * kRowBytes;
  static constexpr uint32_t kTile = kBox * (HD / 64);
  static constexpr uint32_t kBars = kTile * (1 + 2 * kStages);
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
  static __device__ __forceinline__ uint32_t k_tile(uint32_t base, int s) {
    return base + kTile * (1 + 2 * s);
  }
  static __device__ __forceinline__ uint32_t v_tile(uint32_t base, int s) {
    return base + kTile * (2 + 2 * s);
  }
};

// Running statistics of a consumer thread's two query rows in the log2
// domain: max m and this lane's share of the sum l.
struct Softmax {
  float m0, m1, l0, l1;
};

// One 128-key tile of the forward for a consumer warpgroup whose 64 query
// rows start at `q_rows` in the Q tile: s = q k^T (both K-major from
// shared memory), the online softmax update in the log2 domain of
// x = s * scale_log2, then acc += p v with p rounded to bf16 in registers
// and v row-major read transposed.  When `need_mask`, the keys of the tile
// past lim0 (for the thread's row r0) or lim1 (row r0 + 8), counted from
// the tile's first key, take x = `mask_value`.  The softmax, not the
// tensor cores, bounds this loop, so it spends few instructions per score:
// the mask is one compare, and a tile that needs none (a uniform branch)
// pays nothing; s stays unscaled until the exponent (for scale_log2 > 0,
// max(s) scaled is the max of x), so p = 2^(x - m) is one FFMA and one
// MUFU.EX2.  For scale_log2 <= 0 (a flash call may pass any sm_scale)
// that does not hold: the caller sets kScaleFirst, s is scaled first and
// the rest runs on x with factor 1.
template <int HD, bool kScaleFirst = false>
__device__ __forceinline__ void fwd_tile(float (&acc)[HD / 2], Softmax& st,
                                         uint32_t q_rows, uint32_t ks,
                                         uint32_t vs, float scale_log2,
                                         float mask_value, bool need_mask,
                                         int lim0, int lim1) {
  using L = FwdLayout<HD>;
  const int t = threadIdx.x % 4;
  float s[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(s, sw128_desc(q_rows + k_step(L::kBox, kk), 16, 1024),
             sw128_desc(ks + k_step(L::kBox, kk), 16, 1024), kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  if constexpr (kScaleFirst) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
  }
  const float f = kScaleFirst ? 1.f : scale_log2;  // x = s * f
  const float raw_mask = kScaleFirst ? mask_value : mask_value / scale_log2;
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        if (col > (e < 2 ? lim0 : lim1)) s[4 * j + e] = raw_mask;
      }
    }
  }

  // online softmax: the 4 lanes of a quad share a row
  float mx0 = raw_mask, mx1 = raw_mask;
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
  const float mn0 = fmaxf(st.m0, mx0 * f);
  const float mn1 = fmaxf(st.m1, mx1 * f);
  const float alpha0 = ex2(st.m0 - mn0), alpha1 = ex2(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], f, -mn0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], f, -mn0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], f, -mn1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], f, -mn1));
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  st.l0 = st.l0 * alpha0 + rs0;
  st.l1 = st.l1 * alpha1 + rs1;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc[4 * j] *= alpha0;
    acc[4 * j + 1] *= alpha0;
    acc[4 * j + 2] *= alpha1;
    acc[4 * j + 3] *= alpha1;
  }

  uint32_t p[8][4];
  to_a_fragments<8>(p, s);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs_t(acc, p[kk], sw128_desc(vs + kk * 16 * kRowBytes, L::kBox, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// The forward's end for a consumer thread: o = acc / max(l, 1e-30) at rows
// r0 and r0 + 8 of the slab at `o` (row stride ss), and logsumexp = m +
// log(l) at the same rows of `lse`; rows at or past S are skipped.
template <int HD>
__device__ __forceinline__ void fwd_store(bf16* o, long long ss, float* lse,
                                          int r0, int S,
                                          const float (&acc)[HD / 2],
                                          Softmax st) {
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, sh);
    st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, sh);
  }
  st.l0 = fmaxf(st.l0, 1e-30f);
  st.l1 = fmaxf(st.l1, 1e-30f);
  store_bf16<HD>(o, ss, r0, S, acc, 1.f / st.l0, 1.f / st.l1);
  if (threadIdx.x % 4 == 0) {
    if (r0 < S) lse[r0] = (st.m0 + log2f(st.l0)) * kLn2;
    if (r0 + 8 < S) lse[r0 + 8] = (st.m1 + log2f(st.l1)) * kLn2;
  }
}

// ------------------------------------------------------ the backward tiles
//
// Both backwards recompute p = 2^(s * scale_log2 - lse * log2(e)) from the
// forward's lse and form ds = p * (dp - D) * scale, the reference's
// `(p * (dp - delta) * sm_scale).astype(k.dtype)`, as p * fma(dp, scale,
// -D * scale): one instruction per score beside the FFMA and MUFU.EX2 of
// p.  No row max is taken, so every sign of scale is right.  The splash
// kernels pass scale 1 (their q arrives pre-scaled) and scale_log2 =
// log2(e).  Masked scores get p = 0, on tiles that need a mask only (a
// uniform branch).

// Shared memory of both bf16 dq kernels from a 1024-byte aligned base: Q
// and dO [128][HD] (resident), then per stage K and V [64][HD], each tile
// HD / 64 swizzled boxes; then the mbarriers qdo_full, full[kStages],
// empty[kStages].
template <int HD>
struct DqLayout {
  static constexpr uint32_t kQBox = 128 * kRowBytes;
  static constexpr uint32_t kQTile = kQBox * (HD / 64);
  static constexpr uint32_t kKBox = 64 * kRowBytes;
  static constexpr uint32_t kKTile = kKBox * (HD / 64);
  static constexpr uint32_t kRing = 2 * kQTile;
  static constexpr uint32_t kBars = kRing + 2 * kKTile * kStages;
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
  static __device__ __forceinline__ uint32_t k_tile(uint32_t base, int s) {
    return base + kRing + 2 * kKTile * s;
  }
  static __device__ __forceinline__ uint32_t v_tile(uint32_t base, int s) {
    return k_tile(base, s) + kKTile;
  }
};

// One 64-key tile of dq for a consumer warpgroup whose 64 query rows start
// at `q_rows` in the Q tile and `do_rows` in the dO tile: s = q k^T and
// dp = do v^T in one wgmma group (all four K-major from shared memory);
// p from the thread's rows' l0 (row r0) and l1 (row r0 + 8), each the
// row's lse * log2(e); ds = p * (dp - D) * scale with the rows' D d0 and
// d1, rounded to bf16 in registers; then acc += ds k with k row-major read
// transposed.  When `need_mask`, the keys of the tile past lim0 (row r0) or
// lim1 (row r0 + 8), counted from the tile's first key, get p = 0.
template <int HD>
__device__ __forceinline__ void dq_tile(float (&acc)[HD / 2], uint32_t q_rows,
                                        uint32_t do_rows, uint32_t ks,
                                        uint32_t vs, float scale_log2,
                                        float scale, float l0, float l1,
                                        float d0, float d1, bool need_mask,
                                        int lim0, int lim1) {
  using L = DqLayout<HD>;
  const int t = threadIdx.x % 4;
  float s[32], dp[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(s, sw128_desc(q_rows + k_step(L::kQBox, kk), 16, 1024),
             sw128_desc(ks + k_step(L::kKBox, kk), 16, 1024), kk);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(dp, sw128_desc(do_rows + k_step(L::kQBox, kk), 16, 1024),
             sw128_desc(vs + k_step(L::kKBox, kk), 16, 1024), kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);

#pragma unroll
  for (int i = 0; i < 32; ++i)
    s[i] = ex2(fmaf(s[i], scale_log2, -(i % 4 < 2 ? l0 : l1)));
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (8 * (i / 4) + 2 * t + (i & 1) > (i % 4 < 2 ? lim0 : lim1))
        s[i] = 0.f;
  }
  const float nd0 = -d0 * scale, nd1 = -d1 * scale;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    dp[i] = s[i] * fmaf(dp[i], scale, i % 4 < 2 ? nd0 : nd1);

  uint32_t da[4][4];
  to_a_fragments<4>(da, dp);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_t(acc, da[kk],
               sw128_desc(ks + kk * 16 * kRowBytes, L::kKBox, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// Shared memory of both bf16 dk/dv kernels from a 1024-byte aligned base:
// K and V [128][HD] (resident), then per stage Q and dO [64][HD], each tile
// HD / 64 swizzled boxes; then per stage lse and D of the query tile (f32
// [64] each, `stats` bytes from the base); then the mbarriers kv_full,
// full[kStages], empty[kStages].
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
  static __device__ __forceinline__ uint32_t q_tile(uint32_t base, int s) {
    return base + kRing + 2 * kQTile * s;
  }
  static __device__ __forceinline__ uint32_t do_tile(uint32_t base, int s) {
    return q_tile(base, s) + kQTile;
  }
  static __device__ __forceinline__ uint32_t stats(int s) {
    return kStats + 512 * s;
  }
};

// One 64-query tile of dk and dv for a consumer warpgroup whose 64 keys
// start at `k_rows` in the K tile and `v_rows` in the V tile, with the
// query tile's Q at `qs`, dO at `dos` and its lse and D in shared memory:
// s^T = k q^T, p^T, then dv += p^T do and dp^T = v do^T in one wgmma group,
// ds^T = p^T * (dp^T - D) * scale, then dk += ds^T q (do and q row-major
// read transposed; p^T and ds^T rounded to bf16 in registers).  When
// `need_mask`, the queries of the tile before lo0 (the thread's key row
// r0) or lo1 (row r0 + 8), or past hi (every row), counted from the tile's
// first query, get p = 0.
template <int HD>
__device__ __forceinline__ void dkv_tile(float (&acc_k)[HD / 2],
                                         float (&acc_v)[HD / 2],
                                         uint32_t k_rows, uint32_t v_rows,
                                         uint32_t qs, uint32_t dos,
                                         const float* lse_s,
                                         const float* di_s, float scale_log2,
                                         float scale, bool need_mask,
                                         int lo0, int lo1, int hi) {
  using L = DkvLayout<HD>;
  const int t = threadIdx.x % 4;
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(s, sw128_desc(k_rows + k_step(L::kKBox, kk), 16, 1024),
             sw128_desc(qs + k_step(L::kQBox, kk), 16, 1024), kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = 8 * j + 2 * t + (e & 1);
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -lse_s[qc] * kLog2e));
    }
  }
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        if (qc < (e < 2 ? lo0 : lo1) || qc > hi) s[4 * j + e] = 0.f;
      }
    }
  }

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
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(dp, sw128_desc(v_rows + k_step(L::kKBox, kk), 16, 1024),
             sw128_desc(dos + k_step(L::kQBox, kk), 16, 1024), kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc_v);
  fence_regs(dp);

#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = 8 * j + 2 * t + (e & 1);
      dp[4 * j + e] =
          s[4 * j + e] * fmaf(dp[4 * j + e], scale, -di_s[qc] * scale);
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
}

// -------------------------------------------------------------- host side

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
// contiguous; base and byte strides 16-byte aligned, as the wrappers
// check): boxes of 64 columns by `rows` rows, 128-byte swizzle, rows past S
// read as zeros.  A dimension of extent 1 is never stepped, so its stride,
// which a view may leave at any value, is replaced by a packed one.
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int B, int N, int S,
                     int H, View v, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)N,
                              (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)v.s * 2, (cuuint64_t)v.n * 2,
                           (cuuint64_t)v.b * 2};
  if (N == 1) strides[1] = strides[0] * S;
  if (B == 1) strides[2] = strides[1] * N;
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
