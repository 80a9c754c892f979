// Coarse-theta bilinear interpolation at rounded event coordinates.
//
// Replaces eincm_tpu/ops/interp_pallas.py: _fwd_kernel (reached through
// _interp_fwd) and _bwd_kernel (reached through _interp_bwd).
//
// Forward: out[e, c] = sum_{a,b} uy[e, a] * vx[e, b] * theta[ky_a, kx_b, c]
// with the scale-and-translate triangle weights of _axis_weights: at most two
// taps per axis, masked to [0, n) and divided by max(sum, 1e-20). Every f32
// operation of the weights and of the contraction is written with the
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs and the
// result is the plain PyTorch version's operation for operation.
//
// Backward: dtheta[h, w, c] = sum_e (vx[e, w] * g[e, c]) * uy[e, h]. Each
// block accumulates the whole (h, w, 2) grid in shared memory (2 KB at the
// solver's 16x16, 128 KB at the 128x128 gate), then adds its partial grid
// into the zeroed global output with one atomicAdd per nonzero entry.
//
// What bounds it on an H100: the forward reads 8 bytes and writes 8 bytes
// per event, with theta (2 KB) cached, so it is a memory-bound stream
// (30k events: ~0.5 MB, far below a launch's fixed cost). The backward is
// bounded by shared-memory atomics: events cluster on a few features, so
// many threads of a block hit the same few grid entries.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kBwdBlocks = 132 * 2;

struct Taps {
  int k0;    // first tap index (second is k0 + 1); clamped for safe reads
  float w0;  // normalized weight of tap k0 (0 when k0 is outside [0, n))
  float w1;  // normalized weight of tap k0 + 1
  bool in0, in1;
};

__device__ __forceinline__ Taps axis_taps(float coord, int n, float scale) {
  Taps t;
  t.k0 = 0;
  t.w0 = 0.f;
  t.w1 = 0.f;
  t.in0 = t.in1 = false;
  // rintf rounds half to even, as jnp.round does
  const float c = rintf(coord);
  const float u = __fsub_rn(__fmul_rn(__fadd_rn(c, 0.5f), scale), 0.5f);
  if (isnan(u)) {  // the reference's weights are NaN on every row
    t.w0 = t.w1 = u;
    return t;
  }
  // a coordinate with no tap in [0, n), +-inf included; tested in float
  // before any conversion to int
  if (!(u > -2.f && u < (float)n + 1.f)) return t;
  const float kf = floorf(u);
  const int k0 = (int)kf;
  float a = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(kf, u))));
  float b = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(__fadd_rn(kf, 1.f), u))));
  t.in0 = k0 >= 0 && k0 < n;
  t.in1 = k0 + 1 >= 0 && k0 + 1 < n;
  if (!t.in0) a = 0.f;
  if (!t.in1) b = 0.f;
  const float s = fmaxf(__fadd_rn(a, b), 1e-20f);
  t.w0 = __fdiv_rn(a, s);
  t.w1 = __fdiv_rn(b, s);
  t.k0 = k0;
  return t;
}

__device__ __forceinline__ int clamp_idx(int k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

__global__ void interp_fwd_kernel(const float* __restrict__ theta,
                                  const float* __restrict__ xs,
                                  const float* __restrict__ ys,
                                  float* __restrict__ out, long long n_events,
                                  int h, int w, float sy, float sx) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_events; e += stride) {
    const Taps ty = axis_taps(ys[e], h, sy);
    const Taps tx = axis_taps(xs[e], w, sx);
    const int y0 = clamp_idx(ty.k0, h), y1 = clamp_idx(ty.k0 + 1, h);
    const int x0 = clamp_idx(tx.k0, w), x1 = clamp_idx(tx.k0 + 1, w);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float t00 = __ldg(theta + (y0 * w + x0) * 2 + c);
      const float t10 = __ldg(theta + (y1 * w + x0) * 2 + c);
      const float t01 = __ldg(theta + (y0 * w + x1) * 2 + c);
      const float t11 = __ldg(theta + (y1 * w + x1) * 2 + c);
      // rows first (column x0, then x1), then columns: the reference order
      const float m0 = __fadd_rn(__fmul_rn(ty.w0, t00), __fmul_rn(ty.w1, t10));
      const float m1 = __fadd_rn(__fmul_rn(ty.w0, t01), __fmul_rn(ty.w1, t11));
      out[e * 2 + c] = __fadd_rn(__fmul_rn(m0, tx.w0), __fmul_rn(m1, tx.w1));
    }
  }
}

__device__ __forceinline__ void add_tap(float* acc, int w, int ky, int kx,
                                        float uy, float vx, float g0,
                                        float g1) {
  float* a = acc + (ky * w + kx) * 2;
  atomicAdd(a, __fmul_rn(__fmul_rn(vx, g0), uy));
  atomicAdd(a + 1, __fmul_rn(__fmul_rn(vx, g1), uy));
}

__global__ void interp_bwd_kernel(const float* __restrict__ g,
                                  const float* __restrict__ xs,
                                  const float* __restrict__ ys,
                                  float* __restrict__ dtheta,
                                  long long n_events, int h, int w, float sy,
                                  float sx) {
  extern __shared__ float acc[];
  const int m = h * w * 2;
  for (int i = threadIdx.x; i < m; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_events; e += stride) {
    const Taps ty = axis_taps(ys[e], h, sy);
    const Taps tx = axis_taps(xs[e], w, sx);
    const float g0 = g[e * 2], g1 = g[e * 2 + 1];
    const int y0 = clamp_idx(ty.k0, h), y1 = clamp_idx(ty.k0 + 1, h);
    const int x0 = clamp_idx(tx.k0, w), x1 = clamp_idx(tx.k0 + 1, w);
    // NaN weights poison the two taps the plain version gathers from
    const bool nan_y = isnan(ty.w0), nan_x = isnan(tx.w0);
    const bool iy0 = ty.in0 || nan_y, iy1 = ty.in1 || nan_y;
    const bool ix0 = tx.in0 || nan_x, ix1 = tx.in1 || nan_x;
    if (iy0 && ix0) add_tap(acc, w, y0, x0, ty.w0, tx.w0, g0, g1);
    if (iy1 && ix0) add_tap(acc, w, y1, x0, ty.w1, tx.w0, g0, g1);
    if (iy0 && ix1) add_tap(acc, w, y0, x1, ty.w0, tx.w1, g0, g1);
    if (iy1 && ix1) add_tap(acc, w, y1, x1, ty.w1, tx.w1, g0, g1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(dtheta + i, v);  // NaN != 0, so NaN propagates
  }
}

int grid_for(long long n, int max_blocks) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b > max_blocks) b = max_blocks;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

extern "C" int eincm_interp_fwd(const float* theta, const float* xs,
                                const float* ys, float* out,
                                long long n_events, int h, int w, float sy,
                                float sx, cudaStream_t stream) {
  interp_fwd_kernel<<<grid_for(n_events, kMaxBlocks), kThreads, 0, stream>>>(
      theta, xs, ys, out, n_events, h, w, sy, sx);
  return (int)cudaGetLastError();
}

extern "C" int eincm_interp_bwd(const float* g, const float* xs,
                                const float* ys, float* dtheta,
                                long long n_events, int h, int w, float sy,
                                float sx, cudaStream_t stream) {
  const size_t smem = (size_t)h * w * 2 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        interp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  interp_bwd_kernel<<<grid_for(n_events, kBwdBlocks), kThreads, smem,
                      stream>>>(g, xs, ys, dtheta, n_events, h, w, sy, sx);
  return (int)cudaGetLastError();
}
