// x-block gather-GEMM for Hopper (sm_90a): the contraction behind every 3^3
// sparse convolution over an x-block table (glenet_tpu_torch/ops/sparse.py,
// gather_gemm_xblocks_b), gather, tap selection, casts and product in one
// pass.
//
// Replaces no TPU kernel: glenet_tpu's contraction (glenet_tpu/ops/sparse.py
// gather_gemm_xblocks_b) is XLA-level jnp.  Its composition in PyTorch
// (ops/sparse.py gather_gemm_xblocks_plain, the plain version) is bound by its
// intermediates on this card: it writes and reads back three shifted copies of
// the features, a (B, 9, Vo, 3 Cin) gathered block, the per-tap operand picked
// from it and that operand's float32 copy, ~7 GB at a CenterPoint level-2 conv
// for a 38 MB output.
//
// Contract: features (B, V, Cin) f32, q / tbl (B, 9, Vo) int32, weights
// (27, Cin, Cout) f32 contiguous in (dz, dy)-major, dx-minor tap order, out
// (B, Vo, Cout) f32.  For output site o and (dz, dy) group g, tap d reads row
// q + m0 + ... + m(d-1) of the sample's features when bit d of tbl is set
// (bits 3 / 4 are m0 / m1) and zeros otherwise; out = sum over the 27 taps of
// that row times the tap's (Cin, Cout) weights.  With round_bf16 the operands
// are rounded to bf16 (round to nearest even, as torch's .to(bfloat16)) and
// multiplied on the tensor cores (mma.sync m16n8k16, f32 accumulators): the
// products are exact in f32 and the sums are f32, so only their order differs
// from the plain version.  Without it (the port's float32 switch) the same
// tiles feed f32 FMAs.
//
// What bounds it: bytes.  The features, q / tbl and the output once each: at
// a CenterPoint level-2 conv (Vo = 297000, Cin = Cout = 32) 38 + 21 + 38 MB,
// 29 us at 3.35 TB/s.  The design keeps every intermediate on chip:
//   - A block owns kTile = 128 output sites of one sample and every output
//     channel; each of its 8 warps owns 16 rows of the tile.
//   - For each of the 9 groups, in chunks of at most kChunk of the 3 Cin
//     columns (one chunk unless Cin > 64): the tile's q / tbl, then the
//     group's weights, read along Cout (coalesced), rounded and stored
//     transposed (Cout rows, K contiguous), zero-padded to the MMA depth of
//     16 and to the template's Cout; then each site's tap rows, 16-byte
//     loads when Cin % 4 == 0 (4-byte ones otherwise), kUnroll in flight a
//     thread (each thread one column unit of every few rows, so no
//     division a load), a missed tap or a row past V loading nothing,
//     rounded in registers and stored by the tbl bits into the A tile
//     (sites x K).  Rows are padded so that a row's stride is 4 (mod 8)
//     words: the fragment loads of a warp hit 32 distinct banks.  Then
//     each warp's MMAs over the chunk.
//   - After the 9 groups each warp writes its 16 x Cout sums once.
// The A tile is single-buffered: the latency of one block's gathers hides
// behind the MMAs and gathers of the other blocks resident on the SM.  At the
// level-2 shape above it takes 0.34 ms on an H100 SXM at 700 W, 9% of the
// byte bound (the plain version 6.1 ms): each site reads up to 27 rows of
// 4 Cin bytes from L2, and those reads' latency, not device memory, sets the
// pace.
//
// Plain C interface, loaded with ctypes.  Launches on the caller's stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 128;                 // output sites per block
constexpr int kWarps = kTile / 16;         // one m16 row block a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kGroups = 9;                 // (dz, dy) groups of 3 x taps
constexpr int kUnroll = 4;                 // gather loads in flight a thread

template <typename T>
struct Tile {
  // K columns staged at once, and the row pad in elements: bf16 rows of
  // kc + 8 elements are 4 (mod 8) words apart for any kc % 16 == 0
  static constexpr int kChunk = std::is_same<T, float>::value ? 96 : 192;
  static constexpr int kPad = std::is_same<T, float>::value ? 4 : 8;
};

__device__ __forceinline__ void put1(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void put1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void put4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void put4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// The features' row that tap d of a site reads, or -1 for none.
__device__ __forceinline__ int tap_row(int q, int t, int d, int v) {
  if (!((t >> d) & 1)) return -1;
  const int row = q + (d >= 1 ? (t >> 3) & 1 : 0) + (d >= 2 ? (t >> 4) & 1 : 0);
  return static_cast<unsigned>(row) < static_cast<unsigned>(v) ? row : -1;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The tile's rows of columns [k0, k0 + kw) of the group's K = 3 Cin: sA[r][c - k0].
// A thread owns one column unit (4 columns, or 1 without kVec4) of every
// rows-th row, so its tap and channel are worked out once a chunk and a
// load costs no division.
template <typename T, bool kVec4>
__device__ __forceinline__ void gather(T* sA, int lda, const int32_t* sQ, const int32_t* sT,
                                       const float* __restrict__ fb, int v, int cin, int k0,
                                       int kw) {
  constexpr int kW = kVec4 ? 4 : 1;
  const int upr = kw / kW;                 // units a row, <= kThreads
  const int rows = kThreads / upr;         // rows a pass
  const int r0 = threadIdx.x / upr;
  if (r0 >= rows) return;                  // the remainder of kThreads idles
  const int cu = threadIdx.x - r0 * upr;
  const int c = k0 + cu * kW;
  const int d = c / cin;
  const bool live = c < 3 * cin;           // the padding to the MMA depth is zero
  const float* col = fb + (c - d * cin);
  T* dst = sA + cu * kW;
  for (int rb = r0; rb < kTile; rb += rows * kUnroll) {
    float4 val[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      val[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int r = rb + j * rows;
      if (live && r < kTile) {
        const int row = tap_row(sQ[r], sT[r], d, v);
        if (row >= 0) {
          const float* src = col + static_cast<size_t>(row) * cin;
          if constexpr (kVec4) {
            val[j] = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            val[j].x = __ldg(src);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int r = rb + j * rows;
      if (r < kTile) {
        if constexpr (kVec4) {
          put4(dst + r * lda, val[j]);
        } else {
          put1(dst + r * lda, val[j].x);
        }
      }
    }
  }
}

// One warp's 16 rows times every column over a chunk of kw (a multiple of 16)
// columns.  acc[j] holds rows (g, g + 8) x columns (8 j + 2 t, 8 j + 2 t + 1),
// g = lane / 4 and t = lane % 4, the m16n8 accumulator layout of mma.sync.
template <int NT>
__device__ __forceinline__ void multiply(float (&acc)[NT][4], const __nv_bfloat16* sA,
                                         const __nv_bfloat16* sW, int lda, int kw) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ldw = lda >> 1;                                  // 32-bit words a row
  const uint32_t* a_lo = reinterpret_cast<const uint32_t*>(sA) +
                         ((threadIdx.x >> 5) * 16 + g) * ldw + t;
  const uint32_t* a_hi = a_lo + 8 * ldw;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(sW) + g * ldw + t;
  for (int ks = 0; ks < kw / 16; ++ks) {
    const int o = ks * 8;
    const uint32_t a0 = a_lo[o], a1 = a_hi[o], a2 = a_lo[o + 4], a3 = a_hi[o + 4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t* wj = w + j * 8 * ldw + o;
      mma_bf16(acc[j], a0, a1, a2, a3, wj[0], wj[4]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void multiply(float (&acc)[NT][4], const float* sA,
                                         const float* sW, int lda, int kw) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* a_lo = sA + ((threadIdx.x >> 5) * 16 + g) * lda;
  const float* a_hi = a_lo + 8 * lda;
  for (int k = 0; k < kw; ++k) {
    const float lo = a_lo[k], hi = a_hi[k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float w0 = sW[(j * 8 + 2 * t) * lda + k];
      const float w1 = sW[(j * 8 + 2 * t + 1) * lda + k];
      acc[j][0] = fmaf(lo, w0, acc[j][0]);
      acc[j][1] = fmaf(lo, w1, acc[j][1]);
      acc[j][2] = fmaf(hi, w0, acc[j][2]);
      acc[j][3] = fmaf(hi, w1, acc[j][3]);
    }
  }
}

// T: the operands' type in shared memory (bf16 or f32); NT: n8 tiles of the
// padded Cout (8 NT >= cout).  Grid (ceil(Vo / kTile), B).  The launch
// bounds keep 4 blocks resident a SM up to Cout 32 (64 registers), 3 at 64:
// the gathers' latency needs the blocks more than the accumulators need
// registers.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 4 : NT <= 8 ? 3 : 2) xblock_gemm_kernel(
    const float* __restrict__ feat, const int32_t* __restrict__ qs,
    const int32_t* __restrict__ tbls, const float* __restrict__ w, float* __restrict__ out,
    int v, int vo, int cin, int cout, int kc, bool vec4) {
  constexpr int NP = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sQ = reinterpret_cast<int32_t*>(smem);
  int32_t* sT = sQ + kTile;
  const int lda = kc + Tile<T>::kPad;
  T* sA = reinterpret_cast<T*>(smem + 2 * kTile * sizeof(int32_t));
  T* sW = sA + kTile * lda;

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * kTile;
  const int K = 3 * cin;
  const int Kp = (K + 15) & ~15;
  const float* fb = feat + static_cast<size_t>(b) * v * cin;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int g = 0; g < kGroups; ++g) {
    __syncthreads();                       // the last chunk's MMAs are done
    if (threadIdx.x < kTile) {
      const int o = o0 + threadIdx.x;
      const size_t at = (static_cast<size_t>(b) * kGroups + g) * vo + o;
      sQ[threadIdx.x] = o < vo ? __ldg(qs + at) : 0;
      sT[threadIdx.x] = o < vo ? __ldg(tbls + at) : 0;   // no hits: zeros
    }
    const float* wg = w + static_cast<size_t>(g) * K * cout;
    for (int k0 = 0; k0 < Kp; k0 += kc) {
      const int kw = min(kc, Kp - k0);
      if (k0 > 0) __syncthreads();
      for (int i = threadIdx.x; i < NP * kw; i += kThreads) {
        const int n = i % NP, kk = i / NP, k = k0 + kk;
        put1(sW + n * lda + kk, n < cout && k < K ? __ldg(wg + static_cast<size_t>(k) * cout + n)
                                                  : 0.f);
      }
      __syncthreads();                     // q / tbl and the weights staged
      if (vec4) {
        gather<T, true>(sA, lda, sQ, sT, fb, v, cin, k0, kw);
      } else {
        gather<T, false>(sA, lda, sQ, sT, fb, v, cin, k0, kw);
      }
      __syncthreads();                     // the A tile staged
      multiply<NT>(acc, sA, sW, lda, kw);
    }
  }

  const int lane = threadIdx.x & 31;
  const int r = o0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = r + 8 * h;
      if (o >= vo || n >= cout) continue;
      float* dst = out + (static_cast<size_t>(b) * vo + o) * cout + n;
      if ((cout & 1) == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        dst[0] = acc[j][2 * h];
        if (n + 1 < cout) dst[1] = acc[j][2 * h + 1];
      }
    }
  }
}

template <typename T, int NT>
int launch(const float* feat, const int32_t* q, const int32_t* tbl, const float* w,
           float* out, int b, int v, int vo, int cin, int cout, cudaStream_t stream) {
  const int kp = (3 * cin + 15) & ~15;
  const int kc = kp < Tile<T>::kChunk ? kp : Tile<T>::kChunk;
  const size_t smem = 2 * kTile * sizeof(int32_t) +
                      static_cast<size_t>(kTile + 8 * NT) * (kc + Tile<T>::kPad) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        xblock_gemm_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec4 = cin % 4 == 0 && (reinterpret_cast<uintptr_t>(feat) & 15) == 0;
  const dim3 grid((vo + kTile - 1) / kTile, b);
  xblock_gemm_kernel<T, NT><<<grid, kThreads, smem, stream>>>(feat, q, tbl, w, out, v, vo,
                                                               cin, cout, kc, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (B, Vo, Cout) = the x-block contraction of feat (B, V, Cin) over q / tbl
// (B, 9, Vo) with weights (27, Cin, Cout), all contiguous; bf16 operands when
// round_bf16, else f32.  Cout <= 128.
extern "C" int xblock_gemm(const void* feat, const void* q, const void* tbl, const void* w,
                           void* out, int b, int v, int vo, int cin, int cout,
                           int round_bf16, void* stream) {
  if (b == 0 || vo == 0) return 0;
  if (b < 0 || b > 65535 || v < 0 || vo < 0 || cin <= 0 || cout <= 0 || cout > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto f = static_cast<const float*>(feat);
  auto qi = static_cast<const int32_t*>(q);
  auto ti = static_cast<const int32_t*>(tbl);
  auto wf = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (!round_bf16) {         // the float32 switch: parity runs, not the main path
    return launch<float, 16>(f, qi, ti, wf, o, b, v, vo, cin, cout, s);
  }
  if (cout <= 16) return launch<__nv_bfloat16, 2>(f, qi, ti, wf, o, b, v, vo, cin, cout, s);
  if (cout <= 32) return launch<__nv_bfloat16, 4>(f, qi, ti, wf, o, b, v, vo, cin, cout, s);
  if (cout <= 64) return launch<__nv_bfloat16, 8>(f, qi, ti, wf, o, b, v, vo, cin, cout, s);
  return launch<__nv_bfloat16, 16>(f, qi, ti, wf, o, b, v, vo, cin, cout, s);
}
