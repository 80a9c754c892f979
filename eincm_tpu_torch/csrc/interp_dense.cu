// Coarse-theta bilinear interpolation in the dense layout: kernel 1's
// function, computed from full weight rows instead of two taps per axis.
//
// Replaces scripts/interp_kernel_proto.py: _fwd_kernel (reached through
// interp_pallas), a TPU layout prototype of interp_pallas.py's forward.
//
// Per event, at the rounded coordinates (half to even):
//   uy[k] = max(0, 1 - |k - u_y|) for k < h (0 on the padding up to hp),
//   vx[j] likewise for j < w, each divided by max(sum, 1e-20) unless the
//   mode is `nonorm`;
//   out[c] = sum_j vx[j] * sum_k thT[c * wp + j, k] * uy[k], c = 0, 1,
// with thT the (2 wp, hp) transposed, zero-padded theta of the prototype.
// Modes, as the prototype's:
//   highest  f32 products and sums. Each sum runs in index order with the
//            round-to-nearest intrinsics and the added terms are exact
//            zeros, so the result equals interp.cu's forward exactly;
//   dot3     m = hi(th).hi(uy) + hi(th).lo(uy) + lo(th).hi(uy), hi the
//            bf16 rounding and lo = x - hi (the prototype's _dot3);
//   bf16     weights and theta rounded to bf16, sums in f32;
//   nonorm   as highest, without the normalization.
//
// Layout: each block stages thT in shared memory once and walks a
// grid-stride range of events, one per thread; a thread keeps its uy row in
// shared memory (column tid of a (hp, blockDim) tile, free of bank
// conflicts) and computes vx[j] where it is used.
//
// What holds it back on an H100: its own arithmetic. The function's work,
// and so its bound, is kernel 1's (8 + 8 bytes per event), but this layout
// does ~2 * 2 wp * hp multiply-adds per event (1 kFLOP at 16x16) on the CUDA
// cores; tensor cores are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBlocks = 132 * 8;

enum Mode { kHighest = 0, kDot3 = 1, kBf16 = 2, kNoNorm = 3 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the triangle weight of cell k (< n) at u; NaN where u is NaN, as
// jnp.maximum propagates it
__device__ __forceinline__ float tri(int k, float u) {
  return isnan(u) ? u : eincm::tri_weight((float)k, u);
}

// u at the rounded coordinate (half to even), as kernel 1
__device__ __forceinline__ float axis_u(float coord, float scale) {
  return eincm::axis_u(rintf(coord), scale);
}

// sum_k a[k] * b[k] of the mode, k in index order
template <int M>
__device__ __forceinline__ float dot_row(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         int b_stride, int n) {
  if constexpr (M == kDot3) {
    float s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int k = 0; k < n; ++k) {
      const float x = a[k], y = b[k * b_stride];
      const float xh = bf16_round(x), yh = bf16_round(y);
      const float xl = __fsub_rn(x, xh), yl = __fsub_rn(y, yh);
      s1 = __fadd_rn(s1, __fmul_rn(xh, yh));
      s2 = __fadd_rn(s2, __fmul_rn(xh, yl));
      s3 = __fadd_rn(s3, __fmul_rn(xl, yh));
    }
    return __fadd_rn(__fadd_rn(s1, s2), s3);
  } else {
    float s = 0.f;
    for (int k = 0; k < n; ++k) {
      float x = a[k];
      if constexpr (M == kBf16) x = bf16_round(x);
      s = __fadd_rn(s, __fmul_rn(x, b[k * b_stride]));
    }
    return s;
  }
}

template <int M>
__global__ void interp_dense_kernel(const float* __restrict__ theta,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ ys,
                                    float* __restrict__ out,
                                    long long n_events, int h, int w, int hp,
                                    int wp, float sy, float sx) {
  constexpr bool kNorm = M != kNoNorm;
  extern __shared__ float smem[];
  float* thT = smem;                     // (2 wp, hp)
  float* uy = smem + 2 * wp * hp;        // (hp, blockDim), column tid
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * wp * hp; i += blockDim.x) {
    const int row = i / hp, k = i % hp;
    const int c = row / wp, j = row % wp;
    thT[i] = (j < w && k < h) ? theta[(k * w + j) * 2 + c] : 0.f;
  }
  __syncthreads();
  float* my_uy = uy + tid;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + tid; e < n_events;
       e += stride) {
    const float u_y = axis_u(ys[e], sy);
    const float u_x = axis_u(xs[e], sx);
    float sum_y = 0.f, sum_x = 0.f;
    for (int k = 0; k < hp; ++k) {
      const float v = k < h ? tri(k, u_y) : 0.f;
      my_uy[k * blockDim.x] = v;
      sum_y = __fadd_rn(sum_y, v);
    }
    for (int j = 0; j < w; ++j) sum_x = __fadd_rn(sum_x, tri(j, u_x));
    const float norm_y = fmaxf(sum_y, 1e-20f), norm_x = fmaxf(sum_x, 1e-20f);
    for (int k = 0; k < hp; ++k) {
      float v = my_uy[k * blockDim.x];
      if constexpr (kNorm) v = __fdiv_rn(v, norm_y);
      if constexpr (M == kBf16) v = bf16_round(v);
      my_uy[k * blockDim.x] = v;
    }
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < wp; ++j) {
      float v = j < w ? tri(j, u_x) : 0.f;
      if constexpr (kNorm) v = __fdiv_rn(v, norm_x);
      if constexpr (M == kBf16) v = bf16_round(v);
      const float m0 = dot_row<M>(thT + j * hp, my_uy, blockDim.x, hp);
      const float m1 = dot_row<M>(thT + (wp + j) * hp, my_uy, blockDim.x, hp);
      o0 = __fadd_rn(o0, __fmul_rn(m0, v));
      o1 = __fadd_rn(o1, __fmul_rn(m1, v));
    }
    out[e * 2] = o0;
    out[e * 2 + 1] = o1;
  }
}

template <int M>
int launch(const float* theta, const float* xs, const float* ys, float* out,
           long long n_events, int h, int w, int hp, int wp, float sy,
           float sx, cudaStream_t stream) {
  const size_t smem = ((size_t)2 * wp * hp + (size_t)hp * kThreads) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        interp_dense_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  long long b = (n_events + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  interp_dense_kernel<M><<<b < 1 ? 1 : (int)b, kThreads, smem, stream>>>(
      theta, xs, ys, out, n_events, h, w, hp, wp, sy, sx);
  return (int)cudaGetLastError();
}

}  // namespace

// (theta (h, w, 2), xs, ys (E,)) -> out (E, 2); hp, wp: h and w padded to a
// multiple of 8 (at least 8); mode: 0 highest, 1 dot3, 2 bf16, 3 nonorm
extern "C" int eincm_interp_dense(const float* theta, const float* xs,
                                  const float* ys, float* out,
                                  long long n_events, int h, int w, int hp,
                                  int wp, float sy, float sx, int mode,
                                  cudaStream_t stream) {
  switch (mode) {
    case kHighest:
      return launch<kHighest>(theta, xs, ys, out, n_events, h, w, hp, wp, sy,
                              sx, stream);
    case kDot3:
      return launch<kDot3>(theta, xs, ys, out, n_events, h, w, hp, wp, sy, sx,
                           stream);
    case kBf16:
      return launch<kBf16>(theta, xs, ys, out, n_events, h, w, hp, wp, sy, sx,
                           stream);
    case kNoNorm:
      return launch<kNoNorm>(theta, xs, ys, out, n_events, h, w, hp, wp, sy,
                             sx, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
