// Coarse-theta bilinear interpolation in the dense layout: kernel 1's
// function, computed from full weight rows as one matrix product on the
// tensor cores.
//
// Replaces scripts/interp_kernel_proto.py: _fwd_kernel (reached through
// interp_pallas), a TPU layout prototype of interp_pallas.py's forward,
// whose (2 wp, hp) x (hp, events) product ran on the MXU.
//
// Per event, at the rounded coordinates (half to even):
//   uy[k] = max(0, 1 - |k - u_y|) for k < h (0 on the padding up to hp),
//   vx[j] likewise for j < w, each divided by max(sum, 1e-20) unless the
//   mode is `nonorm`;
//   out[c] = sum_j vx[j] * m[c * wp + j],  m = uy . thT^T,
// with thT the (2 wp, hp) transposed, zero-padded theta of the prototype.
// Only two cells of a row are not 0, so each weight comes from the axis's
// two taps (common.cuh: axis_taps), whose sum is the row's sum.
//
// What bounds it on an H100, and the design. The function's work is kernel
// 1's: 8 bytes in and 8 out per event, so its bound is set by bytes. The
// layout's (E, hp) x (hp, 2 wp) product is ~1 kFLOP per event at 16x16;
// on the CUDA cores it held the first port at 2% of that bound. Here it
// runs on the tensor cores with warp-level mma.sync (a 64-row wgmma tile
// is far wider than K = hp = 16, N = 2 wp = 32). One warp takes 16 events
// (an M tile) at a time:
//   - lanes 0-15 compute the y taps of the tile's events and lanes 16-31
//     the x taps, one coalesced load each (the next tile's is in flight);
//     shuffles hand every lane the taps of its fragment's two events (rows
//     g and g + 8), from which it builds its A fragment in registers;
//   - B is thT, staged in shared memory once per block (rows padded to
//     kp + 4 words, free of bank conflicts for the tf32 fragments). Up to
//     16 x 16 cells every warp keeps all of B's fragments in registers;
//     larger grids walk N in slices of 32 columns from shared memory;
//   - the contraction with vx is per event: each lane scales its
//     accumulator columns by its events' vx, sums over its N tiles, and the
//     four lanes of a quad reduce with __shfl_xor_sync.
// What bounds it now: the CUDA cores' share, ~17 warp instructions per
// event for the taps, the A fragments and the vx epilogue (more for dot3),
// against the dense product's 24 TF32 mma.sync per 16 events (`highest`).
// At 1.5M events it runs at ~12% of its byte bound and ~3x the two-tap
// gather of interp.cu (PERF.md): the dense layout's 16 x 32 products
// per event cost more than the 2 x 2 taps they stand for.
//
// Modes, as the prototype's on the MXU, on this card's matrix unit:
//   highest  3xTF32 with mma.sync.m16n8k8.tf32: hi = cvt.rna.tf32(x),
//            lo = tf32(x - hi), m = lo.hi + hi.lo + hi.hi. Within ~2^-21
//            of f32 per term: held to kernel 1 within 1e-6 x max |out|,
//            not bitwise (the TPU's Precision.HIGHEST was not f32 either);
//   dot3     m = hi(uy).hi(th) + hi(uy).lo(th) + lo(uy).hi(th), hi the bf16
//            rounding and lo = x - hi (the prototype's _dot3), in bf16
//            mma.sync.m16n8k16 with f32 sums. lo carries up to 16 bits, so
//            it goes in as two bf16 parts and each lo product is exact, as
//            in the plain version: five products;
//   bf16     weights and theta rounded to bf16, one bf16 product, f32 sums;
//   nonorm   as highest, without the normalization.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kNS = 4;             // n8 tiles per N slice: 32 columns
constexpr int kMaxSmem = 232448;  // one block's opt-in limit on sm_90

enum Mode { kHighest = 0, kDot3 = 1, kBf16 = 2, kNoNorm = 3 };

template <int M>
struct Cfg {
  static constexpr bool kTf32 = M == kHighest || M == kNoNorm;
  static constexpr int kK = kTf32 ? 8 : 16;  // K of one mma
  // the planes a value is split into: tf32 hi, lo; bf16 hi, lo1, lo2; bf16
  static constexpr int kP = M == kBf16 ? 1 : (M == kDot3 ? 3 : 2);
  static constexpr bool kNorm = M != kNoNorm;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float tf32_round(float x) {  // to nearest, ties away
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x as the mode's planes, each exact in the mma's input type
template <int M>
__device__ __forceinline__ void split(float x, float (&v)[Cfg<M>::kP]) {
  if constexpr (Cfg<M>::kTf32) {
    v[0] = tf32_round(x);
    v[1] = tf32_round(__fsub_rn(x, v[0]));
  } else if constexpr (M == kDot3) {
    v[0] = bf16_round(x);
    const float r = __fsub_rn(x, v[0]);  // exact, up to 16 bits
    v[1] = bf16_round(r);
    v[2] = bf16_round(__fsub_rn(r, v[1]));  // exact: r = v[1] + v[2]
  } else {
    v[0] = bf16_round(x);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// one fragment register per plane: the value x0 (tf32), or the pair x0, x1
// of consecutive k (bf16, x0 in the low half)
template <int M>
__device__ __forceinline__ void frag(float x0, float x1,
                                     uint32_t (&out)[Cfg<M>::kP]) {
  constexpr int P = Cfg<M>::kP;
  float v0[P];
  split<M>(x0, v0);
  if constexpr (Cfg<M>::kTf32) {
#pragma unroll
    for (int p = 0; p < P; ++p) out[p] = __float_as_uint(v0[p]);
  } else {
    float v1[P];
    split<M>(x1, v1);
#pragma unroll
    for (int p = 0; p < P; ++p) out[p] = pack_bf16(v0[p], v1[p]);
  }
}

// B fragment (k0 .. k0 + kK, n0 .. n0 + 8) from the shared thT (n, k),
// row stride S: b[p][r]
template <int M>
__device__ __forceinline__ void load_b(const float* thT, int S, int k0,
                                       int n0, int g, int t,
                                       uint32_t (&b)[Cfg<M>::kP][2]) {
  constexpr int P = Cfg<M>::kP;
  const float* row = thT + (n0 + g) * S + k0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t f[P];
    if constexpr (Cfg<M>::kTf32)
      frag<M>(row[t + 4 * r], 0.f, f);
    else
      frag<M>(row[2 * t + 8 * r], row[2 * t + 8 * r + 1], f);
#pragma unroll
    for (int p = 0; p < P; ++p) b[p][r] = f[p];
  }
}

// the dense weight of cell k from an event's two taps
__device__ __forceinline__ float cell(int k, int k0, float w0, float w1) {
  return k == k0 ? w0 : (k == k0 + 1 ? w1 : 0.f);
}

// A fragment (rows g, g + 8; k0 .. k0 + kK) from the y taps of the lane's
// two events: a[p][r]
template <int M>
__device__ __forceinline__ void build_a(int k0, int t, const int (&yk)[2],
                                        const float (&y0)[2],
                                        const float (&y1)[2],
                                        uint32_t (&a)[Cfg<M>::kP][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r & 1;  // event g or g + 8
    uint32_t f[Cfg<M>::kP];
    if constexpr (Cfg<M>::kTf32) {
      const int k = k0 + t + 4 * (r >> 1);
      frag<M>(cell(k, yk[i], y0[i], y1[i]), 0.f, f);
    } else {
      const int k = k0 + 2 * t + 8 * (r >> 1);
      frag<M>(cell(k, yk[i], y0[i], y1[i]), cell(k + 1, yk[i], y0[i], y1[i]), f);
    }
#pragma unroll
    for (int p = 0; p < Cfg<M>::kP; ++p) a[p][r] = f[p];
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += the mode's product of the split A and B, the small terms first
template <int M>
__device__ __forceinline__ void mma_mode(float (&c)[4],
                                         const uint32_t (&a)[Cfg<M>::kP][4],
                                         const uint32_t (&b)[Cfg<M>::kP][2]) {
  if constexpr (Cfg<M>::kTf32) {
    mma_tf32(c, a[1], b[0]);
    mma_tf32(c, a[0], b[1]);
    mma_tf32(c, a[0], b[0]);
  } else if constexpr (M == kDot3) {
    mma_bf16(c, a[2], b[0]);
    mma_bf16(c, a[1], b[0]);
    mma_bf16(c, a[0], b[2]);
    mma_bf16(c, a[0], b[1]);
    mma_bf16(c, a[0], b[0]);
  } else {
    mma_bf16(c, a[0], b[0]);
  }
}

// kWP: 0, or wp (8 or 16) where kp <= 16 too; then wp is known to the
// compiler and each warp keeps all of B in registers
template <int M, int kWP>
__global__ void __launch_bounds__(kThreads)
    interp_dense_kernel(const float* __restrict__ theta,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys, float* __restrict__ out,
                        long long n_events, int h, int w, int wp_arg, int kp,
                        float sy, float sx) {
  using C = Cfg<M>;
  constexpr int P = C::kP, KK = C::kK;
  constexpr bool kRegB = kWP > 0;
  constexpr int kRegKT = 16 / KK;  // K steps held in registers
  extern __shared__ float thT[];   // (2 wp, S), zero-padded
  const int wp = kRegB ? kWP : wp_arg;
  const int S = kp + 4;
  const int NT = wp / 4;  // n8 tiles: 2 wp / 8
  const int KT = kp / KK;
  for (int i = threadIdx.x; i < 2 * wp * S; i += blockDim.x) {
    const int n = i / S, k = i % S;
    const int c = n / wp, j = n % wp;
    thT[i] = (j < w && k < h) ? theta[(k * w + j) * 2 + c] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  uint32_t breg[kRegB ? kRegKT : 1][kRegB ? kNS : 1][P][2];
  if constexpr (kRegB) {
#pragma unroll
    for (int kt = 0; kt < kRegKT; ++kt)
#pragma unroll
      for (int s = 0; s < kNS; ++s) {
        if (kt < KT && s < NT) {
          load_b<M>(thT, S, kt * KK, s * 8, g, t, breg[kt][s]);
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) breg[kt][s][p][0] = breg[kt][s][p][1] = 0u;
        }
      }
  }

  const long long n_tiles = (n_events + 15) / 16;
  const long long stride = (long long)gridDim.x * kWarps;
  // lanes 0-15 load y and lanes 16-31 x of the tile's events; the next
  // tile's coordinate is in flight while this one is computed
  const bool is_x = lane >= 16;
  const float* src = is_x ? xs : ys;
  auto load = [&](long long tile) {
    const long long e = tile * 16 + (lane & 15);
    return tile < n_tiles && e < n_events ? __ldg(src + e) : 0.f;
  };
  long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  float next = load(tile);
  for (; tile < n_tiles; tile += stride) {
    const long long e0 = tile * 16;
    const float coord = next;
    next = load(tile + stride);
    const eincm::Taps tp =
        eincm::axis_taps(coord, is_x ? w : h, is_x ? sx : sy, C::kNorm);
    float w0 = tp.w0, w1 = tp.w1;
    if constexpr (M == kBf16) {
      w0 = bf16_round(w0);
      w1 = bf16_round(w1);
    }
    int yk[2], xk[2];
    float y0[2], y1[2], x0[2], x1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // events g and g + 8
      const int src = g + 8 * i;
      yk[i] = __shfl_sync(0xffffffffu, tp.k0, src);
      y0[i] = __shfl_sync(0xffffffffu, w0, src);
      y1[i] = __shfl_sync(0xffffffffu, w1, src);
      xk[i] = __shfl_sync(0xffffffffu, tp.k0, src + 16);
      x0[i] = __shfl_sync(0xffffffffu, w0, src + 16);
      x1[i] = __shfl_sync(0xffffffffu, w1, src + 16);
    }
    // out[event g + 8 i, channel c], this lane's share
    float o00 = 0.f, o01 = 0.f, o10 = 0.f, o11 = 0.f;
    for (int n0 = 0; n0 < NT; n0 += kNS) {
      float acc[kNS][4];
#pragma unroll
      for (int s = 0; s < kNS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
      if constexpr (kRegB) {  // one N slice, B from registers
#pragma unroll
        for (int kt = 0; kt < kRegKT; ++kt) {
          if (kt >= KT) break;
          uint32_t a[P][4];
          build_a<M>(kt * KK, t, yk, y0, y1, a);
#pragma unroll
          for (int s = 0; s < kNS; ++s) {
            if (s >= NT) break;
            mma_mode<M>(acc[s], a, breg[kt][s]);
          }
        }
      } else {
        for (int kt = 0; kt < KT; ++kt) {
          uint32_t a[P][4];
          build_a<M>(kt * KK, t, yk, y0, y1, a);
#pragma unroll
          for (int s = 0; s < kNS; ++s) {
            if (n0 + s >= NT) break;
            uint32_t b[P][2];
            load_b<M>(thT, S, kt * KK, (n0 + s) * 8, g, t, b);
            mma_mode<M>(acc[s], a, b);
          }
        }
      }
      // sum over this lane's columns of m[e, c wp + j] vx[e, j]; an N tile
      // lies in one channel, since wp is a multiple of 8
#pragma unroll
      for (int s = 0; s < kNS; ++s) {
        const int nt = n0 + s;
        if (nt >= NT) break;
        const bool c1 = nt * 8 >= wp;  // known to the compiler under kWP
        const int jb = nt * 8 - (c1 ? wp : 0) + 2 * t;
        float p0 = 0.f, p1 = 0.f;  // events g, g + 8
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = jb + q;
          p0 = __fadd_rn(p0, __fmul_rn(acc[s][q], cell(j, xk[0], x0[0], x1[0])));
          p1 = __fadd_rn(p1, __fmul_rn(acc[s][2 + q], cell(j, xk[1], x0[1], x1[1])));
        }
        if (c1) {
          o01 = __fadd_rn(o01, p0);
          o11 = __fadd_rn(o11, p1);
        } else {
          o00 = __fadd_rn(o00, p0);
          o10 = __fadd_rn(o10, p1);
        }
      }
    }
#pragma unroll
    for (int m = 1; m <= 2; m *= 2) {  // the four lanes of a quad
      o00 = __fadd_rn(o00, __shfl_xor_sync(0xffffffffu, o00, m));
      o01 = __fadd_rn(o01, __shfl_xor_sync(0xffffffffu, o01, m));
      o10 = __fadd_rn(o10, __shfl_xor_sync(0xffffffffu, o10, m));
      o11 = __fadd_rn(o11, __shfl_xor_sync(0xffffffffu, o11, m));
    }
    // lane t of a quad stores (event g + 8 (t >> 1), channel t & 1): the
    // warp writes the tile's 32 outputs in one coalesced run
    const float mine = t == 0 ? o00 : (t == 1 ? o01 : (t == 2 ? o10 : o11));
    const long long ev = e0 + g + 8 * (t >> 1);
    if (ev < n_events) out[ev * 2 + (t & 1)] = mine;
  }
}

template <int M, int kWP>
int launch(const float* theta, const float* xs, const float* ys, float* out,
           long long n_events, int h, int w, int kp, int wp, float sy,
           float sx, cudaStream_t stream) {
  const size_t smem = (size_t)2 * wp * (kp + 4) * 4;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        interp_dense_kernel<M, kWP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles = (n_events + 15) / 16;
  long long b = (tiles + kWarps - 1) / kWarps;
  if (b > kMaxBlocks) b = kMaxBlocks;
  interp_dense_kernel<M, kWP><<<b < 1 ? 1 : (int)b, kThreads, smem, stream>>>(
      theta, xs, ys, out, n_events, h, w, wp, kp, sy, sx);
  return (int)cudaGetLastError();
}

template <int M>
int launch_mode(const float* theta, const float* xs, const float* ys,
                float* out, long long n_events, int h, int w, int hp, int wp,
                float sy, float sx, cudaStream_t stream) {
  constexpr int KK = Cfg<M>::kK;
  const int kp = (hp + KK - 1) / KK * KK;  // K padded to whole mma steps
  if (kp <= 16 && wp == 8)
    return launch<M, 8>(theta, xs, ys, out, n_events, h, w, kp, wp, sy, sx,
                        stream);
  if (kp <= 16 && wp == 16)
    return launch<M, 16>(theta, xs, ys, out, n_events, h, w, kp, wp, sy, sx,
                         stream);
  return launch<M, 0>(theta, xs, ys, out, n_events, h, w, kp, wp, sy, sx,
                      stream);
}

}  // namespace

// (theta (h, w, 2), xs, ys (E,)) -> out (E, 2); hp, wp: h and w padded to a
// multiple of 8 (at least 8); mode: 0 highest, 1 dot3, 2 bf16, 3 nonorm
extern "C" int eincm_interp_dense(const float* theta, const float* xs,
                                  const float* ys, float* out,
                                  long long n_events, int h, int w, int hp,
                                  int wp, float sy, float sx, int mode,
                                  cudaStream_t stream) {
  if (hp % 8 || wp % 8 || hp < h || wp < w) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kHighest:
      return launch_mode<kHighest>(theta, xs, ys, out, n_events, h, w, hp, wp,
                                   sy, sx, stream);
    case kDot3:
      return launch_mode<kDot3>(theta, xs, ys, out, n_events, h, w, hp, wp,
                                sy, sx, stream);
    case kBf16:
      return launch_mode<kBf16>(theta, xs, ys, out, n_events, h, w, hp, wp,
                                sy, sx, stream);
    case kNoNorm:
      return launch_mode<kNoNorm>(theta, xs, ys, out, n_events, h, w, hp, wp,
                                  sy, sx, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
