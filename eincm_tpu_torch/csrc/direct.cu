// Direct kernels: the calls that the tuned float32 kernels of splat.cu and
// interp.cu do not take:
//   - float64 tensors, which the JAX package keeps on its XLA path
//     (eincm_tpu/ops/warp.py:199-209, eincm_tpu/ops/splat.py:174-177, :347):
//     the splat forward and backward, and the coarse-theta interp forward
//     and backward;
//   - the wrap-compat splat (eincm_tpu/ops/splat.py:set_splat_wrap_compat,
//     which JAX also routes to XLA), in float32 or float64.
// The splat takes any window size (2 hw + 1 texels a side) and any grid.
//
// Each kernel computes its plain version's function (ops/splat_kernel.py:
// splat_plain and its autograd gradient, ops/interp.py:
// interp_theta_at_events_plain and interp_bwd_plain) with the same
// operations in the tensors' own precision. The gathers (splat backward,
// interp forward) are one thread per event and write each result once. The
// two sums (splat forward, interp backward) are exact integer sums of
// rounded terms, rounded to T once, so every result is bitwise the same
// from run to run; the first designs added a global float atomic per term in
// the order the threads arrived (27M of them at DSEC for the splat, 12M
// onto 512 words for the interp backward, 4.1% and 1.2% of their bounds):
//   - the splat forward runs splat.cu's slab design (ops/splat_kernel.py:
//     plan_splat): block (ref, chunk, slab) queues the events of its chunk
//     whose window reaches its tile, adds their taps as fixed point into the
//     tile with integer shared-memory atomics, and adds the tile's nonzero
//     texels into exact sums in device memory; a finish rounds them. A
//     float32 tap is rounded to 2^-24 and a tile texel is 32 bits (a counter
//     that wraps carries 2^32 units into the texel's 64-bit sum), as in
//     splat.cu; a float64 tap is rounded to 2^-62 (pdf products are below
//     2^-5, so the rounding is below 1e-19 absolute), a tile texel is 64 bits
//     held as two 32-bit words (lo takes the tap's low half, hi its high
//     half and lo's carry), and its sum 128 bits (hi wrapping carries one
//     into the sum's high half). With the wrap,
//     a tap at row (column) s in [-n, -1] lands at n + s: an event's rows are
//     up to two runs of the frame, and a block tests both against its tile;
//     q is always computed from the coordinate as given.
//   - the interp backward runs exact.cuh's design in float64: one unit for
//     the launch from the largest finite |g|, 62-bit terms into 128-bit sums,
//     in a band of rows in shared memory (16 bytes a word: 8 KB at 16x16)
//     or straight into device memory (ops/interp.py:plan_interp chooses).
// The forward products keep the plain version's roundings (every product a
// round-to-nearest intrinsic, never an FMA; see below).

#include <cuda_runtime.h>
#include <math.h>

#include "exact.cuh"
#include "tile.cuh"

namespace {

namespace exact = eincm::exact;

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

// the rows (columns) [lo, hi] of a window touch [a0, a1) of an axis of n
// texels: directly, or with the wrap through their part in [-n, -1]
template <bool kWrap>
__device__ __forceinline__ bool span_hits(int lo, int hi, int n, int a0, int a1) {
  const int l = max(lo, 0), h = min(hi, n - 1);
  bool hit = l <= h && l < a1 && h >= a0;
  if (kWrap) {
    const int wl = max(lo, -n) + n, wh = min(hi, -1) + n;
    hit = hit || (wl <= wh && wl < a1 && wh >= a0);
  }
  return hit;
}

// true when a tap of the event's window lands in the tile [r0, r1) x [c0, c1)
template <typename T, bool kWrap>
__device__ __forceinline__ bool in_tile(T x, T y, int H, int W, int hw, int r0,
                                        int r1, int c0, int c1) {
  T rx, ry;
  if (!window_at<T, kWrap>(x, y, H, W, hw, rx, ry)) return false;
  const int iy = (int)ry, ix = (int)rx;
  return span_hits<kWrap>(iy - hw, iy + hw, H, r0, r1) &&
         span_hits<kWrap>(ix - hw, ix + hw, W, c0, c1);
}

// A tile texel and its sum in device memory, by precision. A tile is
// kWords arrays of 32-bit words in shared memory (native integer atomics;
// a 64-bit shared-memory atomic is slower), each of n_tile texels.
template <typename T>
struct SplatFixed;

template <>
struct SplatFixed<float> {
  static constexpr int kWords = 1;
  using Q = unsigned;  // units of 2^-24
  __device__ static Q quantize(float v) { return eincm::quantize(v); }
  // q into tile texel k; a counter that wraps carries 2^32 units into the
  // texel's 64-bit sum sums[i]
  __device__ static void tile_add(unsigned* tile, int, int k, Q q,
                                  unsigned long long* sums, long long, long long i) {
    const unsigned old = atomicAdd(tile + k, q);
    if (old + q < old) atomicAdd(sums + i, 1ull << 32);
  }
  __device__ static unsigned long long tile_value(const unsigned* tile, int, int k) {
    return tile[k];
  }
  __device__ static void add(unsigned long long* sums, long long, long long i,
                             unsigned long long v) {
    atomicAdd(sums + i, v);
  }
  __device__ static float value(const unsigned long long* sums, long long, long long i) {
    return __fmul_rn(__ull2float_rn(sums[i]), 1.f / eincm::kUnit);
  }
};

constexpr double kUnit64 = 4611686018427387904.0;  // 2^62

template <>
struct SplatFixed<double> {
  static constexpr int kWords = 2;  // a texel's 64 bits: lo, then hi words
  using Q = unsigned long long;  // units of 2^-62
  __device__ static Q quantize(double v) { return __double2ull_rn(__dmul_rn(v, kUnit64)); }
  // q's low 32 bits into lo, its high bits and lo's carry into hi; hi
  // wrapping carries 2^64 units: one into the sum's high half (sums[n + i])
  __device__ static void tile_add(unsigned* tile, int n_tile, int k, Q q,
                                  unsigned long long* sums, long long n, long long i) {
    const unsigned ql = (unsigned)q;
    const unsigned old = atomicAdd(tile + k, ql);
    const unsigned h = (unsigned)(q >> 32) + (old + ql < old ? 1u : 0u);
    if (h) {
      const unsigned oh = atomicAdd(tile + n_tile + k, h);
      if (oh + h < oh) atomicAdd(sums + n + i, 1ull);
    }
  }
  __device__ static unsigned long long tile_value(const unsigned* tile, int n_tile, int k) {
    return ((unsigned long long)tile[n_tile + k] << 32) | tile[k];
  }
  // a 64-bit value into the 128-bit sum (lo sums[i], hi sums[n + i])
  __device__ static void add(unsigned long long* sums, long long n, long long i,
                             unsigned long long v) {
    const unsigned long long old = atomicAdd(sums + i, v);
    if (old + v < old) atomicAdd(sums + n + i, 1ull);
  }
  __device__ static double value(const unsigned long long* sums, long long n, long long i) {
    return eincm::exact::u128_to_double(sums[n + i], sums[i], -62);
  }
};

struct SlabPlan {
  int tile_rows, tile_cols;  // rows and columns of one tile
  int row_slabs, col_slabs;
  int chunks;  // interleaved event chunks per ref
};

// the taps of one event that land in the tile, rounded and added into it
template <typename T, bool kWrap>
__device__ __forceinline__ void deposit(unsigned* tile, int n_tile,
                                        unsigned long long* sums, long long n_texels,
                                        long long frame0, T x, T y, int H, int W,
                                        int hw, int r0, int r1, int c0, int c1,
                                        int tc) {
  using F = SplatFixed<T>;
  T rx, ry;
  if (!window_at<T, kWrap>(x, y, H, W, hw, rx, ry)) return;
  const int iy = (int)ry, ix = (int)rx;
  for (int a = -hw; a <= hw; ++a) {
    const int row = texel<kWrap>(iy + a, H);
    if (row < r0 || row >= r1) continue;
    const T gy = gauss((ry + T(a)) - y);
    for (int b = -hw; b <= hw; ++b) {
      const int col = texel<kWrap>(ix + b, W);
      if (col < c0 || col >= c1) continue;
      const typename F::Q q = F::quantize(gy * gauss((rx + T(b)) - x));
      if (q)
        F::tile_add(tile, n_tile, (row - r0) * tc + (col - c0), q, sums, n_texels,
                    frame0 + (long long)row * W + col);
    }
  }
}

// the events a warp queues before it runs their taps, 32 at a time
constexpr int kQueue = 64;
// the slab kernel's static shared memory beside its tile
constexpr int kQueueBytes = 32 * kQueue * 4;

// Block (ref, chunk, row slab, col slab) of ops/splat_kernel.py:plan_splat:
// the frames' exact sums (zeroed) += the tile's texels
template <typename T, bool kWrap>
__global__ void __launch_bounds__(1024)
    splat_direct_fwd_kernel(const T* __restrict__ wx, const T* __restrict__ wy,
                            unsigned long long* __restrict__ sums,
                            long long n_texels, long long n_events, int H, int W,
                            int hw, SlabPlan p) {
  using F = SplatFixed<T>;
  extern __shared__ __align__(16) unsigned tile[];
  int blk = blockIdx.x;
  const int cs = blk % p.col_slabs;
  blk /= p.col_slabs;
  const int rs = blk % p.row_slabs;
  blk /= p.row_slabs;
  const int chunk = blk % p.chunks;
  const int ref = blk / p.chunks;
  const int r0 = rs * p.tile_rows, c0 = cs * p.tile_cols;
  const int r1 = min(r0 + p.tile_rows, H), c1 = min(c0 + p.tile_cols, W);
  const int tr = r1 - r0, tc = c1 - c0, n_tile = tr * tc;
  for (int i = threadIdx.x; i < F::kWords * n_tile; i += blockDim.x) tile[i] = 0u;
  __syncthreads();

  const T* xs = wx + (long long)ref * n_events;
  const T* ys = wy + (long long)ref * n_events;
  const long long frame0 = (long long)ref * H * W;
  // each warp queues the events of its loads that reach the tile (ballot
  // and prefix count) and runs their taps 32 at a time, every lane busy
  __shared__ int queues[32][kQueue];
  const int lane = threadIdx.x & 31;
  int* queue = queues[threadIdx.x >> 5];
  int queued = 0;  // the same in every lane
  constexpr int kUnroll = 2;
  const long long run = (long long)blockDim.x * kUnroll;
  for (long long base = chunk * run + (threadIdx.x & ~31); base < n_events;
       base += run * p.chunks) {  // the same trips in every lane of a warp
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + lane + (long long)u * blockDim.x;
      const bool hit = i < n_events &&
                       in_tile<T, kWrap>(__ldg(xs + i), __ldg(ys + i), H, W, hw, r0, r1, c0, c1);
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) queue[queued + __popc(m & ((1u << lane) - 1u))] = (int)i;
      queued += __popc(m);
      if (queued >= 32) {
        __syncwarp();
        const int e = queue[lane];
        __syncwarp();
        if (lane < queued - 32) queue[lane] = queue[32 + lane];
        __syncwarp();
        queued -= 32;
        deposit<T, kWrap>(tile, n_tile, sums, n_texels, frame0, __ldg(xs + e),
                          __ldg(ys + e), H, W, hw, r0, r1, c0, c1, tc);
      }
    }
  }
  __syncwarp();
  if (lane < queued) {
    const int e = queue[lane];
    deposit<T, kWrap>(tile, n_tile, sums, n_texels, frame0, __ldg(xs + e), __ldg(ys + e),
                      H, W, hw, r0, r1, c0, c1, tc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
    const unsigned long long v = F::tile_value(tile, n_tile, i);
    if (v) F::add(sums, n_texels, frame0 + (long long)(r0 + i / tc) * W + c0 + i % tc, v);
  }
}

// the frames from their sums, each rounded to T once
template <typename T>
__global__ void __launch_bounds__(256)
    splat_direct_finish_kernel(const unsigned long long* __restrict__ sums,
                               T* __restrict__ frames, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    frames[i] = SplatFixed<T>::value(sums, n, i);
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

// dtheta's exact sums += (vx g) uy at the four taps of each event, in one
// launch's unit (exact.cuh): into a band of rows in shared memory
// (kBanded; blockIdx.y the band), then into device memory, or straight
// there. A tap outside the grid adds its zero weight times g at its
// clamped cell, as interp_bwd_plain does (0 x inf is NaN there too).
template <bool kBanded>
__global__ void __launch_bounds__(512)
    interp_direct_bwd_kernel(const double* __restrict__ g,
                             const double* __restrict__ xs,
                             const double* __restrict__ ys, long long n_events,
                             int h, int w, double scale_y, double scale_x,
                             exact::Exact<double> x, int band_rows) {
  extern __shared__ __align__(16) unsigned long long band_sums[];
  exact::Band<double> band{nullptr, nullptr, 0, 0};
  if (kBanded) {
    const int r0 = blockIdx.y * band_rows;
    const int r1 = min(h, r0 + band_rows);
    band.w0 = 2LL * r0 * w;
    band.w1 = 2LL * r1 * w;
    band.lo = band_sums;
    band.hi = band_sums + (band.w1 - band.w0);
    exact::zero_band(band);
  }
  const int s = exact::launch_shift(x);  // its __syncthreads: the zeroed band too
  const double scale = exact::Fixed<double>::pow2(s);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_events; e += stride) {
    const Taps ty = axis_taps(__ldg(ys + e), h, scale_y);
    const Taps tx = axis_taps(__ldg(xs + e), w, scale_x);
    const double g0 = __ldg(g + 2 * e), g1 = __ldg(g + 2 * e + 1);
    const int xk[2] = {tx.k0, tx.k1}, yk[2] = {ty.k0, ty.k1};
    const double xw[2] = {tx.w0, tx.w1}, yw[2] = {ty.w0, ty.w1};
    long long word[8];
    double term[8];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const double c0 = __dmul_rn(xw[b], g0), c1 = __dmul_rn(xw[b], g1);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int k = 4 * b + 2 * a;
        word[k] = 2 * ((long long)yk[a] * w + xk[b]);
        word[k + 1] = word[k] + 1;
        term[k] = __dmul_rn(c0, yw[a]);
        term[k + 1] = __dmul_rn(c1, yw[a]);
      }
    }
    if (kBanded) {
      exact::band_terms(band, x.flags, word, term, scale);
    } else {
      exact::global_terms(x, word, term, scale);
    }
  }
  if (kBanded) {
    __syncthreads();
    exact::flush_band(band, x);
  }
}

bool bad_launch(int blocks, int threads) {
  return blocks < 1 || threads < 32 || threads > 1024 || threads % 32;
}

template <typename T, bool kWrap>
int splat_fwd(const void* wx, const void* wy, unsigned long long* sums,
              void* frames, long long n_texels, long long n_events, int H, int W,
              int hw, const SlabPlan& p, long long blocks, size_t smem,
              int threads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(splat_direct_fwd_kernel<T, kWrap>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a 64-bit sum per texel in float32, two in float64
  err = cudaMemsetAsync(sums, 0, (size_t)n_texels * 2 * sizeof(T), stream);
  if (err != cudaSuccess) return (int)err;
  splat_direct_fwd_kernel<T, kWrap><<<(int)blocks, threads, smem, stream>>>(
      (const T*)wx, (const T*)wy, sums, n_texels, n_events, H, W, hw, p);
  splat_direct_finish_kernel<T><<<exact::finish_blocks(n_texels), 256, 0, stream>>>(
      sums, (T*)frames, n_texels);
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

// the (n_refs, H, W) frames (written whole) of (n_refs, n_events)
// coordinates, float64 with `f64`, else float32, by the slab plan of
// ops/splat_kernel.py:plan_splat (its texel_bytes 8 with f64, else 4): a
// grid of n_refs x chunks x row_slabs x col_slabs blocks of `threads`
// threads, each with a tile of tile_rows x tile_cols texels; `sums`
// (scratch, zeroed here): n_refs H W 64-bit words, twice that with f64;
// `wrap`: the reference's negative-index wrap; windows of 2 hw + 1 texels
// a side
extern "C" int eincm_splat_direct_fwd(const void* wx, const void* wy,
                                      void* sums, void* frames, int n_refs,
                                      long long n_events, int H, int W, int hw,
                                      int f64, int wrap, int tile_rows,
                                      int tile_cols, int row_slabs,
                                      int col_slabs, int chunks, int threads,
                                      cudaStream_t stream) {
  const size_t texel = f64 ? 8 : 4;
  const size_t smem = ((size_t)tile_rows * tile_cols * texel + 15) / 16 * 16;
  const long long blocks = (long long)n_refs * chunks * row_slabs * col_slabs;
  if (bad_launch(1, threads) || hw < 0 || H < 1 || W < 1 || n_events > 0x7fffffffLL ||
      smem > (size_t)eincm::kMaxSmem - kQueueBytes - 1024 || blocks < 1 ||
      blocks > 0x7fffffffLL || (size_t)sums % 16 ||
      (long long)tile_rows * row_slabs < H || (long long)tile_cols * col_slabs < W)
    return (int)cudaErrorInvalidValue;
  const SlabPlan p{tile_rows, tile_cols, row_slabs, col_slabs, chunks};
  unsigned long long* s = static_cast<unsigned long long*>(sums);
  const long long n = (long long)n_refs * H * W;
  if (f64)
    return wrap ? splat_fwd<double, true>(wx, wy, s, frames, n, n_events, H, W, hw, p,
                                          blocks, smem, threads, stream)
                : splat_fwd<double, false>(wx, wy, s, frames, n, n_events, H, W, hw, p,
                                           blocks, smem, threads, stream);
  return wrap ? splat_fwd<float, true>(wx, wy, s, frames, n, n_events, H, W, hw, p,
                                       blocks, smem, threads, stream)
              : splat_fwd<float, false>(wx, wy, s, frames, n, n_events, H, W, hw, p,
                                        blocks, smem, threads, stream);
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

// the (h, w, 2) float64 dtheta (written whole) from the (n_events, 2)
// cotangent: exact.cuh's prep, the accumulation over `blocks` chunks x
// ceil(h / band_rows) bands of band_rows rows (0: no bands), the finish;
// `scratch`: exact.cuh's ExactLayout for 2 h w words, 16-byte aligned
extern "C" int eincm_interp_direct_bwd(const double* g, const double* xs,
                                       const double* ys, double* dtheta,
                                       void* scratch, long long n_events, int h,
                                       int w, double scale_y, double scale_x,
                                       int band_rows, int blocks, int threads,
                                       cudaStream_t stream) {
  const long long m = 2LL * h * w;
  const int bands = band_rows > 0 ? (h + band_rows - 1) / band_rows : 1;
  const size_t smem = band_rows > 0 ? 2 * sizeof(unsigned long long) * (size_t)band_rows * 2 * w : 0;
  if (bad_launch(blocks, threads) || threads > 512 || h < 1 || w < 1 || band_rows < 0 ||
      bands > 65535 || smem > (size_t)eincm::kMaxSmem - 1024 || (size_t)scratch % 16 ||
      n_events < 1)
    return (int)cudaErrorInvalidValue;
  const int prep = exact::prep_blocks(2 * n_events);
  const exact::Exact<double> x(scratch, m, prep);
  exact::exact_prep_kernel<double><<<prep, exact::kPrepThreads, 0, stream>>>(
      g, 2 * n_events, x);
  if (band_rows > 0) {
    cudaError_t err = cudaFuncSetAttribute(interp_direct_bwd_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    interp_direct_bwd_kernel<true><<<dim3(blocks, bands), threads, smem, stream>>>(
        g, xs, ys, n_events, h, w, scale_y, scale_x, x, band_rows);
  } else {
    interp_direct_bwd_kernel<false><<<blocks, threads, 0, stream>>>(
        g, xs, ys, n_events, h, w, scale_y, scale_x, x, 0);
  }
  exact::exact_finish_kernel<double><<<exact::finish_blocks(m), 256, 0, stream>>>(x, dtheta);
  return (int)cudaGetLastError();
}
