// Flash-attention forward for Hopper (sm_90a): o and lse of softmax(q k^T) v.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ray_tpu/ops/flash_attention.py,
// launched by `_flash_fwd_impl`).  Same function: online softmax with a
// running max m, running sum l and an f32 output accumulator; products in
// the input dtype with f32 accumulation; scores scaled by sm_scale of any
// sign (in the log2 domain, scale_log2 = sm_scale * log2(e); the wgmma
// kernel runs its key loop compiled for the sign, see `fwd_tile` in
// csrc/hopper.cuh); mask value -1e30 applied to the scaled scores; causal
// masks col > row; keys at or past S are masked and rows at or past S are
// neither stored nor written to lse; finalize o = acc / max(l, 1e-30) and
// lse = m + log(l) as f32 [B*N, S].
//
// What bounds it.  At the GPT-2-small forward shape (bf16, causal,
// [4,12,1024,64]) the function must move 25.2 MB of q/k/v/o plus 0.2 MB of
// lse (7.6 us at 3.35 TB/s) and do 6.4 GFLOP of causal products (6.5 us at
// 989 TFLOP/s): memory and tensor-core bounds sit side by side, so the
// kernel must stream K/V once per query tile from L2, keep the [S, S]
// scores out of device memory, and feed the tensor cores.
//
// Two kernels; the dtype and head dim pick one, and nothing falls back
// from one to the other.
//
// bf16 at head dims 64 and 128, `flash_fwd_kernel`: the splash forward's
// design (csrc/splash_attention.cu, helpers in csrc/hopper.cuh) with the
// flash kernel's own function.  One block of three warpgroups per
// (batch*head, 128-row query tile), heaviest causal tiles first.  One
// producer thread loads Q once and streams 128-key K and V tiles through a
// 2-stage TMA ring (4-d maps over [B, N, S, H] with the caller's strides,
// so bnsh, bsnh and strided views of a fused qkv projection are read in
// place; rows past S arrive as zeros); two consumer warpgroups of 64 rows
// each run S = Q K^T (wgmma, both from shared memory) and O += P V (P from
// registers, V read through the transpose flag: no transposed copy).  The
// causal loop bound comes from the tile index, and only the diagonal tile
// and a ragged last tile are masked.  Registers: S 64 + O HD/2 f32 and the
// packed P 32 fit the consumers' 240; one block per SM (384 threads).
//
// f32 at every head dim, and bf16 at head dims 16 and 32,
// `flash_fwd_mma_kernel` (the first design):
//   * one thread block of 4 warps per (batch*head, 64-row query tile); the
//     TPU grid's sequential third dimension becomes a loop inside the block
//     over 64-key K/V tiles staged in shared memory;
//   * each warp owns 16 query rows.  For bf16 both products run on the
//     tensor cores with mma.sync m16n8k16 (f32 accumulate), and the score
//     fragment is reused in registers as the A operand of P.V (FA2 style);
//     f32 inputs use scalar FMAs in the same fragment layout (the tensor
//     cores would round f32 to TF32);
//   * causal key tiles wholly above the diagonal are never visited, and
//     query tiles are scheduled heaviest first;
//   * the ragged tail (S not a multiple of 64) is zero-filled on load and
//     masked, so any S works;
//   * q, k, v and o are addressed through element strides for batch, head
//     and sequence with the head dimension contiguous.
//
// Plain C entry point (no PyTorch headers): rt_flash_fwd returns the
// cudaError_t of the launch; the Python wrapper raises when it is nonzero.

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per block (4 warps x 16 rows)
constexpr int kBlockK = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kNT = kBlockK / 8;  // 8-key n-tiles of the score fragment
constexpr float kNegInf = -1e30f;

// ============================================================ wgmma

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, float* __restrict__ lse, int N,
                     int S, View ov, int causal, float scale_log2) {
  using L = FwdLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  auto full = [=](int s) { return q_full + 8 * (1 + s); };
  auto empty = [=](int s) { return q_full + 8 * (1 + kStages + s); };

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * 128;
  const int n_kt = causal ? qt + 1 : (S + 127) / 128;

  init_ring_barriers(q_full);

  if (threadIdx.x < kWg) {
    // Producer: one thread loads Q, then the K/V tile of every key tile up
    // to the causal bound, in the consumers' order.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int h = 0; h < HD / 64; ++h)
        tma_load(base + h * L::kBox, &tq, q_full, h * 64, q0, n, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int stage = kt % kStages;
        mbar_wait(empty(stage), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(stage), 2 * L::kTile);
        for (int h = 0; h < HD / 64; ++h) {
          tma_load(L::k_tile(base, stage) + h * L::kBox, &tk, full(stage),
                   h * 64, kt * 128, n, b);
          tma_load(L::v_tile(base, stage) + h * L::kBox, &tv, full(stage),
                   h * 64, kt * 128, n, b);
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
    // the last key each of the thread's rows sees
    const int last0 = causal ? min(row0, S - 1) : S - 1;
    const int last1 = causal ? min(row0 + 8, S - 1) : S - 1;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    Softmax st{kNegInf, kNegInf, 0.f, 0.f};

    mbar_wait(q_full, 0);
    // The key loop, compiled twice: a scale at or below zero needs the
    // scores scaled before the row max, and the sign is uniform, so the
    // loop for a positive scale stays free of it.
    auto key_loop = [&](auto scale_first) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int stage = kt % kStages, k0 = kt * 128;
        mbar_wait(full(stage), (kt / kStages) & 1);
        // the causal diagonal, and keys at or past S
        fwd_tile<HD, decltype(scale_first)::value>(
            acc, st, q_rows, L::k_tile(base, stage), L::v_tile(base, stage),
            scale_log2, kNegInf, (causal && kt == qt) || k0 + 128 > S,
            last0 - k0, last1 - k0);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));  // the stage is free
      }
    };
    if (scale_log2 > 0.f)
      key_loop(Flag<false>());
    else
      key_loop(Flag<true>());
    fwd_store<HD>(o + b * ov.b + n * ov.n, ov.s, lse + (long long)bn * S,
                  row0, S, acc, st);
  }
}

// ============================================================ mma.sync

// Shared-memory layout per dtype.  Row pitches keep every row 16-byte
// aligned (vector stores) and stagger rows across banks.
template <typename T, int HD>
struct Layout;

template <int HD>
struct Layout<bf16, HD> {
  static constexpr int kPitch = HD + 8;        // Q and K rows
  static constexpr int kVtPitch = kBlockK + 8; // V stored transposed [HD][keys]
  static constexpr size_t kBytes =
      (size_t)(2 * kBlockQ * kPitch + HD * kVtPitch) * sizeof(bf16);
};

template <int HD>
struct Layout<float, HD> {
  static constexpr int kPitch = HD + 4;        // Q, K and V rows
  static constexpr int kPPitch = kBlockK + 4;  // per-warp probability tile
  static constexpr size_t kBytes =
      (size_t)(3 * kBlockQ * kPitch + kWarps * 16 * kPPitch) * sizeof(float);
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

// V tile for the bf16 path, stored transposed (vt[d][key]) so that the B
// operand of P.V reads two consecutive keys of one column as one 32-bit word.
template <int HD>
__device__ __forceinline__ void load_v_transposed(bf16* vt, const bf16* src,
                                                  long long ss, int row0,
                                                  int S) {
  constexpr int kPerRow = HD / 8;
  constexpr int kPitch = Layout<bf16, HD>::kVtPitch;
  for (int i = threadIdx.x; i < kBlockK * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(c + j) * kPitch + r] = e[j];
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

// Fragment layout shared by both paths (that of the mma C operand): lane
// (g = lane / 4, t = lane % 4) of warp w holds, for every 8-column n-tile j,
//   x[j][0..1] at row w*16 + g,     columns 8j + 2t + {0, 1}
//   x[j][2..3] at row w*16 + g + 8, the same columns.

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int N, int S, View qv,
                         View kv, View vv, View ov, int causal,
                         float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kPitch = Layout<T, HD>::kPitch;
  constexpr int kDT = HD / 8;  // 8-column n-tiles of the output fragment

  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBlockQ * kPitch;
  T* vs = ks + kBlockK * kPitch;  // bf16: transposed [HD][kVtPitch]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * kBlockQ;

  const T* qb = q + b * qv.b + n * qv.n;
  const T* kb = k + b * kv.b + n * kv.n;
  const T* vb = v + b * vv.b + n * vv.n;

  load_rows<T, HD, kBlockQ>(qs, kPitch, qb, qv.s, q0, S);
  __syncthreads();

  const int wr = warp * 16;          // first row of this warp in the tile
  const int row0 = q0 + wr + g;      // the lane's two query rows
  const int row1 = row0 + 8;

  // bf16: the warp's Q rows as mma A fragments, loaded once.
  uint32_t qa[kBf16 ? HD / 16 : 1][4];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const bf16* p0 = qs + (wr + g) * kPitch + kk * 16 + 2 * t;
      const bf16* p1 = p0 + 8 * kPitch;
      qa[kk][0] = ld32(p0);
      qa[kk][1] = ld32(p1);
      qa[kk][2] = ld32(p0 + 8);
      qa[kk][3] = ld32(p1 + 8);
    }
  }

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the running sum

  const int n_kt_all = (S + kBlockK - 1) / kBlockK;
  const int last_row = min(q0 + kBlockQ, S) - 1;
  const int n_kt = causal ? min(n_kt_all, last_row / kBlockK + 1) : n_kt_all;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, HD, kBlockK>(ks, kPitch, kb, kv.s, k0, S);
    if constexpr (kBf16)
      load_v_transposed<HD>(vs, vb, vv.s, k0, S);
    else
      load_rows<T, HD, kBlockK>(vs, kPitch, vb, vv.s, k0, S);
    __syncthreads();

    // ---- scores s = q k^T for the warp's 16 rows x 64 keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const bf16* kr = ks + (j * 8 + g) * kPitch + 2 * t;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t bfrag[2] = {ld32(kr + kk * 16), ld32(kr + kk * 16 + 8)};
          mma_16816(s[j], qa[kk], bfrag);
        }
      }
    } else {
      const float* qr0 = reinterpret_cast<const float*>(qs) + (wr + g) * kPitch;
      const float* qr1 = qr0 + 8 * kPitch;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* kr0 =
            reinterpret_cast<const float*>(ks) + (j * 8 + 2 * t) * kPitch;
        const float* kr1 = kr0 + kPitch;
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
          const float4 x0 = *reinterpret_cast<const float4*>(qr0 + d);
          const float4 x1 = *reinterpret_cast<const float4*>(qr1 + d);
          const float4 y0 = *reinterpret_cast<const float4*>(kr0 + d);
          const float4 y1 = *reinterpret_cast<const float4*>(kr1 + d);
          s[j][0] += x0.x * y0.x + x0.y * y0.y + x0.z * y0.z + x0.w * y0.w;
          s[j][1] += x0.x * y1.x + x0.y * y1.y + x0.z * y1.z + x0.w * y1.w;
          s[j][2] += x1.x * y0.x + x1.y * y0.y + x1.z * y0.z + x1.w * y0.w;
          s[j][3] += x1.x * y1.x + x1.y * y1.y + x1.z * y1.z + x1.w * y1.w;
        }
      }
    }

    // ---- scale into the log2 domain; mask the causal diagonal and the tail
    const bool need_mask = (causal && k0 + kBlockK - 1 > q0) || k0 + kBlockK > S;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= S || (causal && col > row)) x = kNegInf;
        }
        s[j][e] = x;
      }
    }

    // ---- online softmax: the 4 lanes of a quad share a row
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
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
    for (int j = 0; j < kDT; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // ---- acc += p v  (p rounded to the input dtype, as the TPU kernel does)
    if constexpr (kBf16) {
      constexpr int kVtPitch = Layout<bf16, HD>::kVtPitch;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < kDT; ++j) {
          const bf16* vr = vs + (j * 8 + g) * kVtPitch + kk * 16 + 2 * t;
          uint32_t bfrag[2] = {ld32(vr), ld32(vr + 8)};
          mma_16816(acc[j], pa, bfrag);
        }
      }
    } else {
      constexpr int kPPitch = Layout<float, HD>::kPPitch;
      float* pw = reinterpret_cast<float*>(vs + kBlockK * kPitch) +
                  warp * 16 * kPPitch;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = j * 8 + 2 * t;
        pw[g * kPPitch + c] = s[j][0];
        pw[g * kPPitch + c + 1] = s[j][1];
        pw[(g + 8) * kPPitch + c] = s[j][2];
        pw[(g + 8) * kPPitch + c + 1] = s[j][3];
      }
      __syncwarp();
      const float* vsf = reinterpret_cast<const float*>(vs);
      for (int kk = 0; kk < kBlockK; ++kk) {
        const float p0 = pw[g * kPPitch + kk], p1 = pw[(g + 8) * kPPitch + kk];
        const float* vr = vsf + kk * kPitch + 2 * t;
#pragma unroll
        for (int j = 0; j < kDT; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(vr + j * 8);
          acc[j][0] += p0 * x.x;
          acc[j][1] += p0 * x.y;
          acc[j][2] += p1 * x.x;
          acc[j][3] += p1 * x.y;
        }
      }
      __syncwarp();  // the tile is read before the next one overwrites it
    }
  }

  // ---- finalize: o = acc / max(l, 1e-30), lse = m + log(l)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  T* ob = o + b * ov.b + n * ov.n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (row >= S) continue;
    const float inv = h ? inv1 : inv0;
    T* orow = ob + row * ov.s + 2 * t;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const float x = acc[j][2 * h] * inv, y = acc[j][2 * h + 1] * inv;
      if constexpr (kBf16)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(orow + j * 8) = make_float2(x, y);
    }
    if (t == 0)
      lse[(long long)bn * S + row] = (h ? m1 + log2f(l1) : m0 + log2f(l0)) * kLn2;
  }
}

// ================================================================ launch

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, N, S;
  View qv, kv, vv, ov;
  int causal;
  float scale_log2;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_mma(const Args& a) {
  const size_t smem = Layout<T, HD>::kBytes;
  cudaError_t err = set_smem(flash_fwd_mma_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.B * a.N);
  flash_fwd_mma_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.N, a.S, a.qv,
      a.kv, a.vv, a.ov, a.causal, a.scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_wgmma(const Args& a) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = bf16_map(&tq, a.q, a.B, a.N, a.S, HD, a.qv, 128)) !=
          cudaSuccess ||
      (err = bf16_map(&tk, a.k, a.B, a.N, a.S, HD, a.kv, 128)) !=
          cudaSuccess ||
      (err = bf16_map(&tv, a.v, a.B, a.N, a.S, HD, a.vv, 128)) != cudaSuccess)
    return err;
  const size_t smem = FwdLayout<HD>::kBytes;
  if ((err = set_smem(flash_fwd_kernel<HD>, smem)) != cudaSuccess) return err;
  const dim3 grid((a.S + 127) / 128, a.B * a.N);
  flash_fwd_kernel<HD><<<grid, kWsThreads, smem, a.stream>>>(
      tq, tk, tv, static_cast<bf16*>(a.o), a.lse, a.N, a.S, a.ov, a.causal,
      a.scale_log2);
  return cudaGetLastError();
}

// dtype 0 (f32) takes the mma.sync kernel at every head dim; dtype 1
// (bf16) the wgmma kernel at head dims 64 and 128, the mma.sync kernel at
// 16 and 32.
cudaError_t dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype == 0) {
    switch (head_dim) {
      case 16: return launch_mma<float, 16>(a);
      case 32: return launch_mma<float, 32>(a);
      case 64: return launch_mma<float, 64>(a);
      case 128: return launch_mma<float, 128>(a);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 16: return launch_mma<bf16, 16>(a);
      case 32: return launch_mma<bf16, 32>(a);
      case 64: return launch_wgmma<64>(a);
      case 128: return launch_wgmma<128>(a);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
extern "C" cudaError_t rt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, int dtype, int head_dim,
                            int B, int N, int S, long long q_sb, long long q_sn,
                            long long q_ss, long long k_sb, long long k_sn,
                            long long k_ss, long long v_sb, long long v_sn,
                            long long v_ss, long long o_sb, long long o_sn,
                            long long o_ss, int causal, float sm_scale,
                            void* stream) {
  if (B <= 0 || N <= 0 || S <= 0) return cudaSuccess;
  const Args a{q, k, v, o, lse, B, N, S,
               View{q_sb, q_sn, q_ss}, View{k_sb, k_sn, k_ss},
               View{v_sb, v_sn, v_ss}, View{o_sb, o_sn, o_ss},
               causal, sm_scale * kLog2e, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, head_dim, a);
}

// Message for an error code, so the wrapper can raise with it.
extern "C" const char* rt_error_string(cudaError_t err) {
  return cudaGetErrorString(err);
}
