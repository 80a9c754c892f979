// Fused warp + splat forward for ONE reference time: the IWE frame of the
// events warped to t_ref, without the warped coordinates ever reaching
// device memory.
//
// Replaces two TPU kernels of eincm_tpu/experimental/splat_fused.py:
//   - _fused_fwd_kernel (reached through fused_warp_splat_frame): the
//     per-event velocities (thx, thy) are inputs;
//   - _fully_fused_fwd_kernel (reached through fully_fused_warp_splat_frame):
//     each thread first samples the (h, w, 2) coarse theta at its event,
//     with kernel 1's own taps and operation order (common.cuh), at the
//     coordinate as given (not rounded again, as the TPU kernel).
//
// Per event: cx = xi - thx * (ts - t_ref), cy = yi - thy * (ts - t_ref),
// each product and difference rounded on its own (__fmul_rn, __fsub_rn), so
// the result is bitwise the port's displacement (ops/warp.py, two torch
// ops). Then the (2 hw + 1)^2 taps g(i - cy) g(j - cx) around (rint(cx),
// rint(cy)) go into the zeroed (H, W) frame with atomicAdd, with splat.cu's
// drop semantics: NaN, +-inf and far coordinates fail a float range test
// before any int conversion; off-sensor texels are skipped on every side.
// xi and yi are used as given: the callers pass rounded coordinates.
//
// The TPU kernels banded the rows of sorted events into a sliding VMEM
// accumulator, because the TPU has no fast scatter; Hopper scatters with
// atomics, so there are no bands, no sort and no validity flag to compute.
//
// What bounds it on an H100: global atomics on crowded texels, as splat.cu's
// forward. The HBM bound is 20 bytes per event read (12 for the fully
// fused kernel) plus the frame written once; the frame (1.2 MB at 480x640)
// stays in the 50 MB L2. One thread per event, grid-stride.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using eincm::axis_taps_at;
using eincm::gauss;
using eincm::sample_theta;
using eincm::Taps;
using eincm::window_hits;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <int HW>
__device__ __forceinline__ void splat_taps(float* __restrict__ frame, float cx,
                                           float cy, int H, int W) {
  const float rx = rintf(cx), ry = rintf(cy);  // half to even
  if (!window_hits(rx, ry, H, W, HW)) return;
  const int iy = (int)ry, ix = (int)rx;
  constexpr int kTaps = 2 * HW + 1;
  float gy[kTaps], gx[kTaps];
#pragma unroll
  for (int d = 0; d < kTaps; ++d) {
    gy[d] = gauss((ry + (float)(d - HW)) - cy);
    gx[d] = gauss((rx + (float)(d - HW)) - cx);
  }
#pragma unroll
  for (int a = 0; a < kTaps; ++a) {
    const int row = iy + a - HW;
    if (row < 0 || row >= H) continue;
#pragma unroll
    for (int b = 0; b < kTaps; ++b) {
      const int col = ix + b - HW;
      if (col < 0 || col >= W) continue;
      atomicAdd(frame + (long long)row * W + col, gy[a] * gx[b]);
    }
  }
}

// kInterp false: velocities from (thx, thy); true: sampled from theta.
template <int HW, bool kInterp>
__global__ void fused_kernel(const float* __restrict__ xi,
                             const float* __restrict__ yi,
                             const float* __restrict__ ts,
                             const float* __restrict__ thx,
                             const float* __restrict__ thy,
                             const float* __restrict__ theta,
                             float* __restrict__ frame, long long n_events,
                             float t_ref, int H, int W, int h, int w, float sy,
                             float sx) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_events; e += stride) {
    const float x = xi[e], y = yi[e];
    float vx, vy;
    if constexpr (kInterp) {
      const Taps ty = axis_taps_at(y, h, sy);
      const Taps tx = axis_taps_at(x, w, sx);
      vx = sample_theta(theta, ty, tx, h, w, 0);
      vy = sample_theta(theta, ty, tx, h, w, 1);
    } else {
      vx = thx[e];
      vy = thy[e];
    }
    const float dt = __fsub_rn(ts[e], t_ref);
    const float cx = __fsub_rn(x, __fmul_rn(vx, dt));
    const float cy = __fsub_rn(y, __fmul_rn(vy, dt));
    splat_taps<HW>(frame, cx, cy, H, W);
  }
}

int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

template <bool kInterp>
int launch(const float* xi, const float* yi, const float* ts, const float* thx,
           const float* thy, const float* theta, float* frame,
           long long n_events, float t_ref, int H, int W, int hw, int h, int w,
           float sy, float sx, cudaStream_t stream) {
  const int grid = grid_for(n_events);
#define EINCM_FUSED_CASE(HWV)                                             \
  case HWV:                                                              \
    fused_kernel<HWV, kInterp><<<grid, kThreads, 0, stream>>>(           \
        xi, yi, ts, thx, thy, theta, frame, n_events, t_ref, H, W, h, w, \
        sy, sx);                                                         \
    break;
  switch (hw) {  // window sizes 3 and 5, the only ones called
    EINCM_FUSED_CASE(1)
    EINCM_FUSED_CASE(2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EINCM_FUSED_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// kernel 7: (xi, yi, ts, thx, thy) (E,) -> frame (H, W), zeroed by the caller
extern "C" int eincm_fused_warp_splat(const float* xi, const float* yi,
                                      const float* ts, const float* thx,
                                      const float* thy, float* frame,
                                      long long n_events, float t_ref, int H,
                                      int W, int hw, cudaStream_t stream) {
  return launch<false>(xi, yi, ts, thx, thy, nullptr, frame, n_events, t_ref,
                       H, W, hw, 1, 1, 0.f, 0.f, stream);
}

// kernel 8: (xi, yi, ts) (E,), theta (h, w, 2) -> frame (H, W), zeroed
extern "C" int eincm_fully_fused_warp_splat(const float* xi, const float* yi,
                                            const float* ts,
                                            const float* theta, float* frame,
                                            long long n_events, float t_ref,
                                            int H, int W, int hw, int h, int w,
                                            float sy, float sx,
                                            cudaStream_t stream) {
  return launch<true>(xi, yi, ts, nullptr, nullptr, theta, frame, n_events,
                      t_ref, H, W, hw, h, w, sy, sx, stream);
}
