// Image of warped events (IWE) and its coordinate gradient, all reference
// times in one launch.
//
// Replaces four TPU kernels, which compute two functions:
//   - eincm_tpu/ops/splat_pallas.py: _splat_kernel (events_to_pdf_frame_pallas)
//     and _bwd_kernel (_bwd_pallas), the full-height splat;
//   - eincm_tpu/ops/splat_banded.py: _fwd_kernel (_banded_fwd_call) and
//     _bwd_kernel (_banded_bwd_call), the row/column-banded splat.
// The banding, the sliding accumulator and the candidate tree made up for the
// TPU's lack of a fast scatter; Hopper scatters with atomics, so none of it
// carries over and the events need no sort.
//
// Forward: frames[r, i, j] += g(i - y) g(j - x) for the 3x3 texels with
// |i - round(y)| <= 1 and |j - round(x)| <= 1 inside the sensor, where
// g(q) = exp(-q^2 / 2) / sqrt(2 pi). One thread per (ref, event) adds its 9
// taps with atomicAdd into the (R, H, W) output the wrapper zeroed. An event
// whose coordinate is not finite, or whose rounded window misses the sensor,
// adds nothing; the range is tested in float before any conversion to int.
//
// Backward: dwx = sum_j (sum_i u_i G[i, j]) v'_j and
//           dwy = sum_i (sum_j v_j G[i, j]) u'_i, with v' = q g(q);
// one thread per (ref, event) gathers its 9 texels of G. No atomics, so the
// backward is deterministic; non-finite results become 0.
//
// What bounds it on an H100: the forward is bound by atomic throughput on
// the frame, and synthetic events crowd onto a few hundred features, so many
// atomics hit the same texels; the frame (344 KB at 256x336, 1.2 MB at
// 480x640 per ref) stays in the 50 MB L2. The backward reads 8 bytes per
// event plus 9 texels from L2 and writes 8 bytes: a memory-bound gather.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gauss(float q) {
  // exp(-0.5 * q * q) * (1 / sqrt(2 pi)), the reference's operation order
  return expf((-0.5f * q) * q) * kInvSqrt2Pi;
}

// true when the rounded 3x3 window of (rx, ry) touches the sensor; false for
// NaN and +-inf, which fail every comparison or the bounds
__device__ __forceinline__ bool window_hits(float rx, float ry, int H, int W) {
  return ry >= -1.f && ry <= (float)H && rx >= -1.f && rx <= (float)W;
}

__global__ void splat_fwd_kernel(const float* __restrict__ wx,
                                 const float* __restrict__ wy,
                                 float* __restrict__ frames, long long n,
                                 long long n_events, int H, int W) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = wx[i], y = wy[i];
    const float rx = rintf(x), ry = rintf(y);  // half to even
    if (!window_hits(rx, ry, H, W)) continue;
    const int iy = (int)ry, ix = (int)rx;
    float* frame = frames + (i / n_events) * (long long)H * W;
    float gy[3], gx[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      gy[d] = gauss((ry + (float)(d - 1)) - y);
      gx[d] = gauss((rx + (float)(d - 1)) - x);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int row = iy + a - 1;
      if (row < 0 || row >= H) continue;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int col = ix + b - 1;
        if (col < 0 || col >= W) continue;
        atomicAdd(frame + (long long)row * W + col, gy[a] * gx[b]);
      }
    }
  }
}

__global__ void splat_bwd_kernel(const float* __restrict__ wx,
                                 const float* __restrict__ wy,
                                 const float* __restrict__ grad,
                                 float* __restrict__ dwx,
                                 float* __restrict__ dwy, long long n,
                                 long long n_events, int H, int W) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = wx[i], y = wy[i];
    const float rx = rintf(x), ry = rintf(y);
    float ox = 0.f, oy = 0.f;
    if (window_hits(rx, ry, H, W)) {
      const int iy = (int)ry, ix = (int)rx;
      const float* G = grad + (i / n_events) * (long long)H * W;
      float u[3], du[3], v[3], dv[3], t[3][3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int row = iy + d - 1, col = ix + d - 1;
        const bool rok = row >= 0 && row < H, cok = col >= 0 && col < W;
        const float qy = (ry + (float)(d - 1)) - y;
        const float qx = (rx + (float)(d - 1)) - x;
        const float gy = gauss(qy), gx = gauss(qx);
        u[d] = rok ? gy : 0.f;
        du[d] = rok ? qy * gy : 0.f;
        v[d] = cok ? gx : 0.f;
        dv[d] = cok ? qx * gx : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int row = iy + a - 1;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int col = ix + b - 1;
          t[a][b] = (row >= 0 && row < H && col >= 0 && col < W)
                        ? __ldg(G + (long long)row * W + col)
                        : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float m = u[0] * t[0][b] + u[1] * t[1][b] + u[2] * t[2][b];
        ox += m * dv[b];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float m = v[0] * t[a][0] + v[1] * t[a][1] + v[2] * t[a][2];
        oy += m * du[a];
      }
    }
    dwx[i] = isfinite(ox) ? ox : 0.f;
    dwy[i] = isfinite(oy) ? oy : 0.f;
  }
}

int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

extern "C" int eincm_splat_fwd(const float* wx, const float* wy,
                               float* frames, int n_refs, long long n_events,
                               int H, int W, cudaStream_t stream) {
  const long long n = (long long)n_refs * n_events;
  splat_fwd_kernel<<<grid_for(n), kThreads, 0, stream>>>(wx, wy, frames, n,
                                                         n_events, H, W);
  return (int)cudaGetLastError();
}

extern "C" int eincm_splat_bwd(const float* wx, const float* wy,
                               const float* grad, float* dwx, float* dwy,
                               int n_refs, long long n_events, int H, int W,
                               cudaStream_t stream) {
  const long long n = (long long)n_refs * n_events;
  splat_bwd_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      wx, wy, grad, dwx, dwy, n, n_events, H, W);
  return (int)cudaGetLastError();
}
