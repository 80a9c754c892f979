// Direct kernels: one thread per event, global atomics where events meet.
// They take the calls that the tuned float32 kernels of splat.cu and
// interp.cu do not:
//   - float64 tensors, which the JAX package keeps on its XLA path
//     (eincm_tpu/ops/warp.py:199-209, eincm_tpu/ops/splat.py:174-177, :347):
//     the splat forward and backward, and the coarse-theta interp forward
//     and backward;
//   - the wrap-compat splat (eincm_tpu/ops/splat.py:set_splat_wrap_compat,
//     which JAX also routes to XLA), in float32 or float64.
// The splat takes any window size (2 hw + 1 texels a side).
//
// Each kernel computes its plain version's function (ops/splat_kernel.py:
// splat_plain and its autograd gradient, ops/interp.py:
// interp_theta_at_events_plain and interp_bwd_plain) with the same
// operations in the tensors' own precision; only the order in which the
// atomics add differs. A float64 result is therefore within a few ulps of
// the plain version's, not bitwise it. They are simple by design: the
// solve's float32 path never launches them, and PERF.md has their times.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kInvSqrt2Pi = 0.3989422804014327;

__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double rint_(double x) { return rint(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// exp(-q^2 / 2) / sqrt(2 pi), the plain version's operation order
template <typename T>
__device__ __forceinline__ T gauss(T q) {
  return exp_((T(-0.5) * q) * q) * T(kInvSqrt2Pi);
}

// the rounded coordinates (half to even) of an event whose window of radius
// hw touches the rows [lo_r, H) and columns [lo_c, W): lo is 0, or -H and -W
// with the wrap. NaN and +-inf fail the test, which comes before any
// conversion to int.
template <typename T, bool kWrap>
__device__ __forceinline__ bool window_at(T x, T y, int H, int W, int hw,
                                          T& rx, T& ry) {
  rx = rint_(x);
  ry = rint_(y);
  const T lo_r = kWrap ? T(-H) : T(0), lo_c = kWrap ? T(-W) : T(0);
  return ry >= lo_r - T(hw) && ry <= T(H - 1 + hw) && rx >= lo_c - T(hw) &&
         rx <= T(W - 1 + hw);
}

// the texel of row (column) s, or -1 for one the splat drops; with the wrap
// s in [-n, -1] lands at n + s, as the reference's negative index does
template <bool kWrap>
__device__ __forceinline__ int texel(int s, int n) {
  if (s >= n || s < (kWrap ? -n : 0)) return -1;
  return s < 0 ? s + n : s;
}

// frames[ref] += g(i - y) g(j - x) over the event's window, one thread per
// (ref, event) in a grid-stride loop, one global atomicAdd per tap
template <typename T, bool kWrap>
__global__ void splat_direct_fwd_kernel(const T* __restrict__ wx,
                                        const T* __restrict__ wy,
                                        T* __restrict__ frames, long long n,
                                        long long n_events, int H, int W,
                                        int hw) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T x = wx[i], y = wy[i];
    T rx, ry;
    if (!window_at<T, kWrap>(x, y, H, W, hw, rx, ry)) continue;
    T* frame = frames + (i / n_events) * (long long)H * W;
    const int iy = (int)ry, ix = (int)rx;
    for (int a = -hw; a <= hw; ++a) {
      const int row = texel<kWrap>(iy + a, H);
      if (row < 0) continue;
      const T gy = gauss((ry + T(a)) - y);
      for (int b = -hw; b <= hw; ++b) {
        const int col = texel<kWrap>(ix + b, W);
        if (col < 0) continue;
        atomicAdd(frame + (long long)row * W + col, gy * gauss((rx + T(b)) - x));
      }
    }
  }
}

// (dwx, dwy) of each (ref, event) from its window of the cotangent G:
// dwx = sum_ij G[i, j] g(i - y) q_j g(q_j), q_j = j - x, and dwy alike;
// dropped texels count 0 and a non-finite result becomes 0, as in
// splat.cu's backward. No atomics.
template <typename T, bool kWrap>
__global__ void splat_direct_bwd_kernel(const T* __restrict__ wx,
                                        const T* __restrict__ wy,
                                        const T* __restrict__ grad,
                                        T* __restrict__ dwx, T* __restrict__ dwy,
                                        long long n, long long n_events, int H,
                                        int W, int hw) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T x = wx[i], y = wy[i];
    T rx, ry, ox = T(0), oy = T(0);
    if (window_at<T, kWrap>(x, y, H, W, hw, rx, ry)) {
      const T* G = grad + (i / n_events) * (long long)H * W;
      const int iy = (int)ry, ix = (int)rx;
      for (int a = -hw; a <= hw; ++a) {
        const int row = texel<kWrap>(iy + a, H);
        if (row < 0) continue;
        // the row's sums against g(q_j) and q_j g(q_j)
        T m = T(0), dm = T(0);
        for (int b = -hw; b <= hw; ++b) {
          const int col = texel<kWrap>(ix + b, W);
          if (col < 0) continue;
          const T qx = (rx + T(b)) - x;
          const T gx = gauss(qx);
          const T t = G[(long long)row * W + col];
          m += t * gx;
          dm += t * (qx * gx);
        }
        const T qy = (ry + T(a)) - y;
        const T gy = gauss(qy);
        ox += dm * gy;
        oy += m * (qy * gy);
      }
    }
    dwx[i] = isfinite(ox) ? ox : T(0);
    dwy[i] = isfinite(oy) ? oy : T(0);
  }
}

// ---- the coarse-theta interp in float64 ------------------------------------
//
// Every product and sum is written with a round-to-nearest intrinsic, as the
// plain version's separate operations round them, so that nvcc cannot
// contract one into an FMA. This matters beyond the last bit: at an event
// whose u is exactly -1 (or n) one triangle weight is 0 and the other is
// masked, and an FMA's residue of 1e-17 in u became a weight that the
// normalization raised to 1 (a whole cell's value instead of 0, seen on the
// card at 16x16 cells over 48 rows).

struct Taps {
  int k0, k1;  // clamped into [0, n)
  double w0, w1;
};

// ops/interp.py:_axis_taps at the rounded coordinate: triangle weights at
// u = (round(c) + 0.5) * scale - 0.5, masked to [0, n), divided by
// max(sum, 1e-20); NaN weights for a NaN u; indices clamped, a clamped tap
// carrying weight 0
__device__ __forceinline__ Taps axis_taps(double c, int n, double scale) {
  const double u = __dsub_rn(__dmul_rn(__dadd_rn(rint(c), 0.5), scale), 0.5);
  const double kf = floor(u);
  Taps t;
  // an infinite kf gives NaN weights that the mask then zeroes
  double w0 = fmax(0.0, __dsub_rn(1.0, fabs(__dsub_rn(kf, u))));
  double w1 = fmax(0.0, __dsub_rn(1.0, fabs(__dsub_rn(__dadd_rn(kf, 1.0), u))));
  if (!(kf >= 0.0 && kf < (double)n)) w0 = 0.0;
  if (!(kf + 1.0 >= 0.0 && kf + 1.0 < (double)n)) w1 = 0.0;
  const double s = fmax(__dadd_rn(w0, w1), 1e-20);
  t.w0 = isnan(u) ? u : w0 / s;
  t.w1 = isnan(u) ? u : w1 / s;
  const int k = isfinite(kf) ? (int)fmin(fmax(kf, -1.0), (double)n) : 0;
  t.k0 = min(max(k, 0), n - 1);
  t.k1 = min(max(k + 1, 0), n - 1);
  return t;
}

// out[e] = the bilinear sample of the (h, w, 2) theta at event e: rows
// first (column x0, then x1), then columns, the plain version's order
__global__ void interp_direct_fwd_kernel(const double* __restrict__ theta,
                                         const double* __restrict__ xs,
                                         const double* __restrict__ ys,
                                         double* __restrict__ out,
                                         long long n_events, int h, int w,
                                         double scale_y, double scale_x) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_events; e += stride) {
    const Taps ty = axis_taps(ys[e], h, scale_y);
    const Taps tx = axis_taps(xs[e], w, scale_x);
    for (int c = 0; c < 2; ++c) {
      const double m0 = __dadd_rn(__dmul_rn(ty.w0, theta[(ty.k0 * w + tx.k0) * 2 + c]),
                                  __dmul_rn(ty.w1, theta[(ty.k1 * w + tx.k0) * 2 + c]));
      const double m1 = __dadd_rn(__dmul_rn(ty.w0, theta[(ty.k0 * w + tx.k1) * 2 + c]),
                                  __dmul_rn(ty.w1, theta[(ty.k1 * w + tx.k1) * 2 + c]));
      out[2 * e + c] = __dadd_rn(__dmul_rn(m0, tx.w0), __dmul_rn(m1, tx.w1));
    }
  }
}

// dtheta (zeroed) += (vx g) uy at the four taps of each event, one global
// atomicAdd per tap and channel; a tap outside the grid adds its zero
// weight times g, as interp_bwd_plain does
__global__ void interp_direct_bwd_kernel(const double* __restrict__ g,
                                         const double* __restrict__ xs,
                                         const double* __restrict__ ys,
                                         double* __restrict__ dtheta,
                                         long long n_events, int h, int w,
                                         double scale_y, double scale_x) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_events; e += stride) {
    const Taps ty = axis_taps(ys[e], h, scale_y);
    const Taps tx = axis_taps(xs[e], w, scale_x);
    const double g0 = g[2 * e], g1 = g[2 * e + 1];
    const int xk[2] = {tx.k0, tx.k1}, yk[2] = {ty.k0, ty.k1};
    const double xw[2] = {tx.w0, tx.w1}, yw[2] = {ty.w0, ty.w1};
    for (int b = 0; b < 2; ++b) {
      const double c0 = __dmul_rn(xw[b], g0), c1 = __dmul_rn(xw[b], g1);
      for (int a = 0; a < 2; ++a) {
        double* cell = dtheta + (yk[a] * w + xk[b]) * 2;
        atomicAdd(cell, __dmul_rn(c0, yw[a]));
        atomicAdd(cell + 1, __dmul_rn(c1, yw[a]));
      }
    }
  }
}

bool bad_launch(int blocks, int threads) {
  return blocks < 1 || threads < 32 || threads > 1024 || threads % 32;
}

template <typename T, bool kWrap>
int splat_fwd(const void* wx, const void* wy, void* frames, long long n,
              long long n_events, int H, int W, int hw, int blocks, int threads,
              cudaStream_t stream) {
  splat_direct_fwd_kernel<T, kWrap><<<blocks, threads, 0, stream>>>(
      (const T*)wx, (const T*)wy, (T*)frames, n, n_events, H, W, hw);
  return (int)cudaGetLastError();
}

template <typename T, bool kWrap>
int splat_bwd(const void* wx, const void* wy, const void* grad, void* dwx,
              void* dwy, long long n, long long n_events, int H, int W, int hw,
              int blocks, int threads, cudaStream_t stream) {
  splat_direct_bwd_kernel<T, kWrap><<<blocks, threads, 0, stream>>>(
      (const T*)wx, (const T*)wy, (const T*)grad, (T*)dwx, (T*)dwy, n, n_events,
      H, W, hw);
  return (int)cudaGetLastError();
}

}  // namespace

// the (n_refs, H, W) frames, added into the zeroed `frames`, of (n_refs,
// n_events) coordinates; float64 with `f64`, else float32; `wrap`: the
// reference's negative-index wrap; windows of 2 hw + 1 texels a side
extern "C" int eincm_splat_direct_fwd(const void* wx, const void* wy,
                                      void* frames, int n_refs,
                                      long long n_events, int H, int W, int hw,
                                      int f64, int wrap, int blocks,
                                      int threads, cudaStream_t stream) {
  if (bad_launch(blocks, threads) || hw < 0 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_refs * n_events;
  if (f64)
    return wrap ? splat_fwd<double, true>(wx, wy, frames, n, n_events, H, W, hw,
                                          blocks, threads, stream)
                : splat_fwd<double, false>(wx, wy, frames, n, n_events, H, W,
                                           hw, blocks, threads, stream);
  return wrap ? splat_fwd<float, true>(wx, wy, frames, n, n_events, H, W, hw,
                                       blocks, threads, stream)
              : splat_fwd<float, false>(wx, wy, frames, n, n_events, H, W, hw,
                                        blocks, threads, stream);
}

// (dwx, dwy), each (n_refs, n_events), from the (n_refs, H, W) cotangent
extern "C" int eincm_splat_direct_bwd(const void* wx, const void* wy,
                                      const void* grad, void* dwx, void* dwy,
                                      int n_refs, long long n_events, int H,
                                      int W, int hw, int f64, int wrap,
                                      int blocks, int threads,
                                      cudaStream_t stream) {
  if (bad_launch(blocks, threads) || hw < 0 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_refs * n_events;
  if (f64)
    return wrap ? splat_bwd<double, true>(wx, wy, grad, dwx, dwy, n, n_events,
                                          H, W, hw, blocks, threads, stream)
                : splat_bwd<double, false>(wx, wy, grad, dwx, dwy, n, n_events,
                                           H, W, hw, blocks, threads, stream);
  return wrap ? splat_bwd<float, true>(wx, wy, grad, dwx, dwy, n, n_events, H,
                                       W, hw, blocks, threads, stream)
              : splat_bwd<float, false>(wx, wy, grad, dwx, dwy, n, n_events, H,
                                        W, hw, blocks, threads, stream);
}

// (n_events, 2) float64 samples of the (h, w, 2) float64 theta
extern "C" int eincm_interp_direct_fwd(const double* theta, const double* xs,
                                       const double* ys, double* out,
                                       long long n_events, int h, int w,
                                       double scale_y, double scale_x,
                                       int blocks, int threads,
                                       cudaStream_t stream) {
  if (bad_launch(blocks, threads) || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  interp_direct_fwd_kernel<<<blocks, threads, 0, stream>>>(
      theta, xs, ys, out, n_events, h, w, scale_y, scale_x);
  return (int)cudaGetLastError();
}

// the (h, w, 2) float64 dtheta, added into the zeroed `dtheta`, from the
// (n_events, 2) cotangent
extern "C" int eincm_interp_direct_bwd(const double* g, const double* xs,
                                       const double* ys, double* dtheta,
                                       long long n_events, int h, int w,
                                       double scale_y, double scale_x,
                                       int blocks, int threads,
                                       cudaStream_t stream) {
  if (bad_launch(blocks, threads) || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  interp_direct_bwd_kernel<<<blocks, threads, 0, stream>>>(
      g, xs, ys, dtheta, n_events, h, w, scale_y, scale_x);
  return (int)cudaGetLastError();
}
