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
// interp forward) write each result once, with one statement sequence per
// event, so a result is bitwise the same for any launch and event order:
//   - the splat backward is bound by its instructions and its gathers, not
//     its bytes (32 an event and ref in float64). The first design, one
//     thread per event, ran an exponential per tap ((2 hw + 1)^2 + 2 hw + 1 of
//     them: 12 at window 3, 56 at window 7; in float64 each a long FP64
//     sequence), a 64-bit division per event for the ref, two texel tests
//     per tap and one scalar load per texel, at 22% of its bound in
//     float64 and 5% at window 7 in float32. Now (ops/splat_kernel.py:
//     plan_direct_bwd): a grid of its own per ref (blockIdx.y); 1 or 2
//     events a thread as one load per coordinate array (8 or 16 bytes for
//     two) and the same stores; the separable weights g(q) and q g(q) of an
//     event, 2 (2 hw + 1) exponentials, computed once and held in registers
//     (the exponentials take the first design's operands, so the same
//     values): hw 1 (window 3, every solve's) as a constant, any hw up to
//     4 (windows 1 to 9) in one instance whose loops run to 4 and stop at
//     the radius, a runtime loop above that; and where the whole window is
//     on the sensor (no tap dropped or wrapped), no texel tests, and a
//     row's texels read as the 16-byte vectors that hold them (float4 or
//     double2) where every row of G starts on 16 bytes. A slab variant
//     (G's rows in shared memory, each event queued to the block whose slab
//     holds its centre row) won only at windows 7 and 9 in float32, which
//     no configuration sets, and was left out (PERF.md);
//   - the interp forward (float64 at the rounded coordinates for the
//     float64 solve, float32 at the coordinates as given for kernel 8's
//     route: the two instances built) stages theta in shared memory as one 8- or
//     16-byte cell a tap where it fits, takes 1 or 2 events a thread (two
//     as one vector load of xs and of ys), writes one (x, y) vector store
//     an event, and divides a weight by its normalization only where the
//     quotient is not known (0 / s, a / 1, a / a: the same bits), so most
//     events divide nothing (ops/interp.py:plan_direct_interp).
// The two sums (splat forward, interp backward) are exact integer sums of
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
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return floor(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fmin_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
// one rounding each, never contracted into an FMA
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// 16 bytes of T: kN values as one float4 or double2, and two values (an
// interp sample) as one float2 or double2
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Two = float2;
  __device__ static void ldg(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static Two two(float a, float b) { return make_float2(a, b); }
};

template <>
struct Vec<double> {
  static constexpr int kN = 2;
  using Two = double2;
  __device__ static void ldg(const double* p, double* v) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = q.x, v[1] = q.y;
  }
  __device__ static void store(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
  __device__ static Two two(double a, double b) { return make_double2(a, b); }
};

// K values of T at p (aligned on K values, or on 16 bytes from 16 bytes
// on): 16-byte vectors, a float2, or one scalar
template <typename T, int K>
__device__ __forceinline__ void ldg_k(const T* p, T (&v)[K]) {
  if constexpr (K * sizeof(T) >= 16) {
#pragma unroll
    for (int i = 0; i < K; i += Vec<T>::kN) Vec<T>::ldg(p + i, v + i);
  } else if constexpr (K == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <typename T, int K>
__device__ __forceinline__ void store_k(T* p, const T (&v)[K]) {
  if constexpr (K * sizeof(T) >= 16) {
#pragma unroll
    for (int i = 0; i < K; i += Vec<T>::kN) Vec<T>::store(p + i, v + i);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

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

// ---- the splat backward ----------------------------------------------------
//
// (dwx, dwy) of each (ref, event) from its window of the cotangent G:
// dwx = sum_i g(q_i) sum_j G[i, j] q_j g(q_j), dwy = sum_i q_i g(q_i)
// sum_j G[i, j] g(q_j), q_j = j - x, q_i = i - y: a row's two sums over
// its columns first, then the rows, each sum an FMA chain in window order.
// Dropped texels count 0 (they are skipped) and a non-finite result becomes
// 0, as in splat.cu's backward. No atomics.

// G of one ref, read through the read-only cache
template <typename T>
struct GlobalRows {
  const T* __restrict__ g;
  int W;
  __device__ T at(int row, int col) const { return __ldg(g + (long long)row * W + col); }
  __device__ void vec(int row, int col, T* v) const {
    Vec<T>::ldg(g + (long long)row * W + col, v);
  }
};

// the `taps` texels of a row from column c0 on (taps = 2 HW + 1, or fewer
// with kUpTo), all on the sensor: as the 16-byte vectors that hold them
// where `rows16` (every row of G starts on 16 bytes) and they lie in the
// row, else one by one; the same values
template <typename T, int HW, bool kUpTo>
__device__ __forceinline__ void row_texels(const GlobalRows<T>& src, int row, int c0, int W,
                                           bool rows16, int taps, T (&t)[2 * HW + 1]) {
  constexpr int kTaps = 2 * HW + 1, kN = Vec<T>::kN;
  constexpr int kVecs = (kTaps + 2 * kN - 2) / kN;  // for any c0 % kN
  const int left = c0 & ~(kN - 1), o = c0 - left;
  const int vecs = kUpTo ? (o + taps + kN - 1) / kN : kVecs;
  if (rows16 && left + vecs * kN <= W) {
    T p[kVecs * kN] = {};
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
      if (v < vecs) src.vec(row, left + v * kN, p + v * kN);
#pragma unroll
    for (int b = 0; b < kTaps; ++b) {
      if (b >= taps) break;
      T x = p[b];
#pragma unroll
      for (int k = 1; k < kN; ++k)
        if (o == k) x = p[b + k];
      t[b] = x;
    }
  } else {
#pragma unroll
    for (int b = 0; b < kTaps; ++b)
      if (b < taps) t[b] = src.at(row, c0 + b);
  }
}

// one event with a window of 2 r + 1 texels a side, r = HW, or with kUpTo
// the radius hw <= HW given at run time (the loops run to HW and skip the
// taps past r): the 2 (2 r + 1) exponentials once, in registers
template <typename T, bool kWrap, int HW, bool kUpTo>
__device__ __forceinline__ void bwd_event(const GlobalRows<T>& src, T x, T y, int H, int W,
                                          int hw, bool rows16, T& dx, T& dy) {
  constexpr int kTaps = 2 * HW + 1;
  const int r = kUpTo ? hw : HW, taps = 2 * r + 1;
  T rx, ry, ox = T(0), oy = T(0);
  if (window_at<T, kWrap>(x, y, H, W, r, rx, ry)) {
    const int iy = (int)ry, ix = (int)rx;
    T gx[kTaps], dgx[kTaps], gy[kTaps], dgy[kTaps];
#pragma unroll
    for (int d = 0; d < kTaps; ++d) {
      if (d >= taps) break;
      const T qx = (rx + T(d - r)) - x, qy = (ry + T(d - r)) - y;
      gx[d] = gauss(qx);
      dgx[d] = mul_rn(qx, gx[d]);
      gy[d] = gauss(qy);
      dgy[d] = mul_rn(qy, gy[d]);
    }
    if (iy >= r && iy + r < H && ix >= r && ix + r < W) {
      // the whole window on the sensor: no texel dropped or wrapped
#pragma unroll
      for (int a = 0; a < kTaps; ++a) {
        if (a >= taps) break;
        T t[kTaps];
        row_texels<T, HW, kUpTo>(src, iy + a - r, ix - r, W, rows16, taps, t);
        T m = T(0), dm = T(0);
#pragma unroll
        for (int b = 0; b < kTaps; ++b) {
          if (b >= taps) break;
          m = fma_(t[b], gx[b], m);
          dm = fma_(t[b], dgx[b], dm);
        }
        ox = fma_(dm, gy[a], ox);
        oy = fma_(m, dgy[a], oy);
      }
    } else {
#pragma unroll
      for (int a = 0; a < kTaps; ++a) {
        if (a >= taps) break;
        const int row = texel<kWrap>(iy + a - r, H);
        if (row < 0) continue;
        T m = T(0), dm = T(0);
#pragma unroll
        for (int b = 0; b < kTaps; ++b) {
          if (b >= taps) break;
          const int col = texel<kWrap>(ix + b - r, W);
          if (col < 0) continue;
          const T t = src.at(row, col);
          m = fma_(t, gx[b], m);
          dm = fma_(t, dgx[b], dm);
        }
        ox = fma_(dm, gy[a], ox);
        oy = fma_(m, dgy[a], oy);
      }
    }
  }
  dx = isfinite(ox) ? ox : T(0);
  dy = isfinite(oy) ? oy : T(0);
}

// the same sums at a radius hw above kMaxHw (windows 11 and up, which no
// shipped configuration sets): a runtime loop that computes a column's
// weights again in every row, as the first design did, with the same values
template <typename T, bool kWrap>
__device__ __forceinline__ void bwd_event_any(const GlobalRows<T>& src, T x, T y, int H,
                                              int W, int hw, T& dx, T& dy) {
  T rx, ry, ox = T(0), oy = T(0);
  if (window_at<T, kWrap>(x, y, H, W, hw, rx, ry)) {
    const int iy = (int)ry, ix = (int)rx;
    for (int a = -hw; a <= hw; ++a) {
      const int row = texel<kWrap>(iy + a, H);
      if (row < 0) continue;
      T m = T(0), dm = T(0);
      for (int b = -hw; b <= hw; ++b) {
        const int col = texel<kWrap>(ix + b, W);
        if (col < 0) continue;
        const T qx = (rx + T(b)) - x;
        const T gx = gauss(qx);
        const T t = src.at(row, col);
        m = fma_(t, gx, m);
        dm = fma_(t, mul_rn(qx, gx), dm);
      }
      const T qy = (ry + T(a)) - y;
      const T gy = gauss(qy);
      ox = fma_(dm, gy, ox);
      oy = fma_(m, mul_rn(qy, gy), oy);
    }
  }
  dx = isfinite(ox) ? ox : T(0);
  dy = isfinite(oy) ? oy : T(0);
}

// The radii built: hw 1 as a constant (window 3, every solve's), any hw up
// to kMaxHw (windows up to 9) in one instance with the radius at run time,
// and bwd_event_any above that (HW < 0)
constexpr int kMaxHw = 4;

template <typename T, bool kWrap, int HW, bool kUpTo>
__device__ __forceinline__ void bwd_one(const GlobalRows<T>& src, T x, T y, int H, int W,
                                        int hw, bool rows16, T& dx, T& dy) {
  if constexpr (HW >= 0) {
    bwd_event<T, kWrap, HW, kUpTo>(src, x, y, H, W, hw, rows16, dx, dy);
  } else {
    bwd_event_any<T, kWrap>(src, x, y, H, W, hw, dx, dy);
  }
}

// The gather kernel: blockIdx.y is the ref; a thread takes K events in a
// row, grid-stride within its ref, as one load per coordinate array and one
// store per gradient array where `vec` says that every ref's arrays start
// on K values (16 bytes from 16 on).
template <typename T, bool kWrap, int HW, bool kUpTo, int K>
__global__ void __launch_bounds__(256)
    splat_direct_bwd_kernel(const T* __restrict__ wx, const T* __restrict__ wy,
                            const T* __restrict__ grad, T* __restrict__ dwx,
                            T* __restrict__ dwy, long long n_events, int H, int W,
                            int hw, int vec, int rows16) {
  const long long ref = blockIdx.y, off = ref * n_events;
  const GlobalRows<T> src{grad + ref * H * W, W};
  const T* xs = wx + off;
  const T* ys = wy + off;
  T* ox = dwx + off;
  T* oy = dwy + off;
  const long long stride = (long long)K * gridDim.x * blockDim.x;
  for (long long e = K * ((long long)blockIdx.x * blockDim.x + threadIdx.x); e < n_events;
       e += stride) {
    if (vec && e + K <= n_events) {
      T x[K], y[K], dx[K], dy[K];
      ldg_k<T, K>(xs + e, x);
      ldg_k<T, K>(ys + e, y);
#pragma unroll
      for (int k = 0; k < K; ++k)
        bwd_one<T, kWrap, HW, kUpTo>(src, x[k], y[k], H, W, hw, rows16, dx[k], dy[k]);
      store_k<T, K>(ox + e, dx);
      store_k<T, K>(oy + e, dy);
    } else {
      for (long long i = e; i < min(e + K, n_events); ++i)
        bwd_one<T, kWrap, HW, kUpTo>(src, __ldg(xs + i), __ldg(ys + i), H, W, hw, rows16,
                                     ox[i], oy[i]);
    }
  }
}

// ---- the coarse-theta interp -----------------------------------------------
//
// Every product and sum is written with a round-to-nearest intrinsic, as the
// plain version's separate operations round them, so that nvcc cannot
// contract one into an FMA. This matters beyond the last bit: at an event
// whose u is exactly -1 (or n) one triangle weight is 0 and the other is
// masked, and an FMA's residue of 1e-17 in u became a weight that the
// normalization raised to 1 (a whole cell's value instead of 0, seen on the
// card at 16x16 cells over 48 rows).

template <typename T>
struct TapsOf {
  int k0, k1;  // clamped into [0, n)
  T w0, w1;
};
using Taps = TapsOf<double>;

// a / s in the bits of a correctly rounded division, for a in [0, 1] and
// s = max(a + b, 1e-20) > 0, without dividing where the quotient is known:
// 0 / s = 0, a / 1 = a, a / a = 1. Both weights of an event inside the grid
// sum to 1, so most events divide nothing.
template <typename T>
__device__ __forceinline__ T weight_over(T a, T s) {
  if (a == T(0)) return T(0);
  if (s == T(1)) return a;
  if (s == a) return T(1);
  return div_rn(a, s);
}

// ops/interp.py:_axis_taps at the coordinate, rounded (half to even) with
// kRound or as given: triangle weights at u = (c + 0.5) * scale - 0.5,
// masked to [0, n), divided by max(sum, 1e-20); NaN weights for a NaN u;
// indices clamped, a clamped tap carrying weight 0
template <typename T, bool kRound>
__device__ __forceinline__ TapsOf<T> axis_taps_of(T c, int n, T scale) {
  const T u = sub_rn(mul_rn(add_rn(kRound ? rint_(c) : c, T(0.5)), scale), T(0.5));
  const T kf = floor_(u);
  TapsOf<T> t;
  // an infinite kf gives NaN weights that the mask then zeroes
  T w0 = fmax_(T(0), sub_rn(T(1), fabs_(sub_rn(kf, u))));
  T w1 = fmax_(T(0), sub_rn(T(1), fabs_(sub_rn(add_rn(kf, T(1)), u))));
  if (!(kf >= T(0) && kf < T(n))) w0 = T(0);
  if (!(kf + T(1) >= T(0) && kf + T(1) < T(n))) w1 = T(0);
  const T s = fmax_(add_rn(w0, w1), T(1e-20));
  t.w0 = isnan(u) ? u : weight_over(w0, s);
  t.w1 = isnan(u) ? u : weight_over(w1, s);
  const int k = isfinite(kf) ? (int)fmin_(fmax_(kf, T(-1)), T(n)) : 0;
  t.k0 = min(max(k, 0), n - 1);
  t.k1 = min(max(k + 1, 0), n - 1);
  return t;
}

// the float64 taps at the rounded coordinate, as the backward takes them
__device__ __forceinline__ Taps axis_taps(double c, int n, double scale) {
  return axis_taps_of<double, true>(c, n, scale);
}

// cell i of the (h, w, 2) theta: one vector from a copy in shared memory
// (kStaged), else two gathers from device memory
template <typename T, bool kStaged>
__device__ __forceinline__ typename Vec<T>::Two cell(const T* th, int i) {
  if constexpr (kStaged) return reinterpret_cast<const typename Vec<T>::Two*>(th)[i];
  return Vec<T>::two(__ldg(th + 2 * i), __ldg(th + 2 * i + 1));
}

// both channels of the bilinear sample of theta at (x, y): rows first
// (column x0, then x1), then columns, the plain version's order
template <typename T, bool kRound, bool kStaged>
__device__ __forceinline__ typename Vec<T>::Two sample(const T* th, T x, T y, int h, int w,
                                                       T sy, T sx) {
  const TapsOf<T> ty = axis_taps_of<T, kRound>(y, h, sy);
  const TapsOf<T> tx = axis_taps_of<T, kRound>(x, w, sx);
  const auto t00 = cell<T, kStaged>(th, ty.k0 * w + tx.k0);
  const auto t10 = cell<T, kStaged>(th, ty.k1 * w + tx.k0);
  const auto t01 = cell<T, kStaged>(th, ty.k0 * w + tx.k1);
  const auto t11 = cell<T, kStaged>(th, ty.k1 * w + tx.k1);
  const T a0 = add_rn(mul_rn(ty.w0, t00.x), mul_rn(ty.w1, t10.x));
  const T a1 = add_rn(mul_rn(ty.w0, t01.x), mul_rn(ty.w1, t11.x));
  const T b0 = add_rn(mul_rn(ty.w0, t00.y), mul_rn(ty.w1, t10.y));
  const T b1 = add_rn(mul_rn(ty.w0, t01.y), mul_rn(ty.w1, t11.y));
  return Vec<T>::two(add_rn(mul_rn(a0, tx.w0), mul_rn(a1, tx.w1)),
                     add_rn(mul_rn(b0, tx.w0), mul_rn(b1, tx.w1)));
}

// out[e] = the bilinear sample of the (h, w, 2) theta at event e, one
// vector store an event; a thread takes K events in a row, grid-stride, as
// one load per coordinate array where `vec` (xs and ys on 16 bytes). The
// thread's first events are read before theta is staged, so that the two
// round trips to device memory overlap (kernel 1's finding).
template <typename T, bool kRound, bool kStaged, int K>
__global__ void __launch_bounds__(256)
    interp_direct_fwd_kernel(const T* __restrict__ theta, const T* __restrict__ xs,
                             const T* __restrict__ ys, T* __restrict__ out,
                             long long n_events, int h, int w, T sy, T sx, int vec) {
  using Two = typename Vec<T>::Two;
  extern __shared__ __align__(16) unsigned char staged_bytes[];
  const long long stride = (long long)K * gridDim.x * blockDim.x;
  long long e = K * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  T x[K], y[K];
  auto load = [&](long long e0) {
    if (vec && e0 + K <= n_events) {
      ldg_k<T, K>(xs + e0, x);
      ldg_k<T, K>(ys + e0, y);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        x[k] = e0 + k < n_events ? __ldg(xs + e0 + k) : T(0);
        y[k] = e0 + k < n_events ? __ldg(ys + e0 + k) : T(0);
      }
    }
  };
  if (e < n_events) load(e);
  const T* th = theta;
  if constexpr (kStaged) {
    T* staged = reinterpret_cast<T*>(staged_bytes);
    for (int i = threadIdx.x; i < 2 * h * w; i += blockDim.x) staged[i] = __ldg(theta + i);
    __syncthreads();
    th = staged;
  }
  for (bool first = true; e < n_events; e += stride, first = false) {
    if (!first) load(e);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (e + k < n_events)
        reinterpret_cast<Two*>(out)[e + k] = sample<T, kRound, kStaged>(th, x[k], y[k], h, w,
                                                                         sy, sx);
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

// the backward's arguments, as the entry point takes them
struct BwdArgs {
  const void *wx, *wy, *grad;
  void *dwx, *dwy;
  int n_refs;
  long long n_events;
  int H, W, hw;
  int per_thread, vec, blocks, threads;
  cudaStream_t stream;
};

// every row of G on 16 bytes: its base, and W values of T a multiple of 16
template <typename T>
bool rows_on_16(const void* grad, int W) {
  return (size_t)grad % 16 == 0 && ((size_t)W * sizeof(T)) % 16 == 0;
}

template <typename T, bool kWrap, int HW, bool kUpTo>
int bwd_gather(const BwdArgs& a) {
  const dim3 grid(a.blocks, a.n_refs);
  const int rows16 = rows_on_16<T>(a.grad, a.W);
#define EINCM_BWD_GATHER(K)                                                             \
  splat_direct_bwd_kernel<T, kWrap, HW, kUpTo, K><<<grid, a.threads, 0, a.stream>>>(  \
      (const T*)a.wx, (const T*)a.wy, (const T*)a.grad, (T*)a.dwx, (T*)a.dwy,            \
      a.n_events, a.H, a.W, a.hw, a.vec, rows16)
  switch (a.per_thread) {
    case 1: EINCM_BWD_GATHER(1); break;
    case 2: EINCM_BWD_GATHER(2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef EINCM_BWD_GATHER
  return (int)cudaGetLastError();
}

template <typename T, bool kWrap>
int splat_bwd(const BwdArgs& a) {
  if (a.hw == 1) return bwd_gather<T, kWrap, 1, false>(a);
  if (a.hw <= kMaxHw) return bwd_gather<T, kWrap, kMaxHw, true>(a);
  return bwd_gather<T, kWrap, -1, false>(a);
}

template <typename T, bool kRound>
int interp_fwd(const void* theta, const void* xs, const void* ys, void* out,
               long long n_events, int h, int w, double scale_y, double scale_x,
               int staged, int per_thread, int vec, int blocks, int threads,
               cudaStream_t stream) {
  const size_t smem = staged ? 2 * sizeof(T) * (size_t)h * w : 0;
  const T sy = (T)scale_y, sx = (T)scale_x;
#define EINCM_INTERP_FWD(S, K)                                                          \
  interp_direct_fwd_kernel<T, kRound, S, K><<<blocks, threads, smem, stream>>>(         \
      (const T*)theta, (const T*)xs, (const T*)ys, (T*)out, n_events, h, w, sy, sx, vec)
  if (per_thread == 1) {
    if (staged) EINCM_INTERP_FWD(true, 1); else EINCM_INTERP_FWD(false, 1);
  } else if constexpr (sizeof(T) == 4) {  // two events a thread: float32 only
    if (per_thread != 2) return (int)cudaErrorInvalidValue;
    if (staged) EINCM_INTERP_FWD(true, 2); else EINCM_INTERP_FWD(false, 2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef EINCM_INTERP_FWD
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

// (dwx, dwy), each (n_refs, n_events), from the (n_refs, H, W) cotangent,
// float64 with `f64`, else float32, by ops/splat_kernel.py:plan_direct_bwd:
// a grid of blocks x n_refs blocks of `threads` threads, per_thread events
// a thread; `vec`: every ref's four arrays start on 16 bytes and on
// per_thread values
extern "C" int eincm_splat_direct_bwd(const void* wx, const void* wy,
                                      const void* grad, void* dwx, void* dwy,
                                      int n_refs, long long n_events, int H,
                                      int W, int hw, int f64, int wrap,
                                      int per_thread, int vec, int blocks,
                                      int threads, cudaStream_t stream) {
  const size_t t = f64 ? 8 : 4;
  const bool aligned = (size_t)wx % 16 == 0 && (size_t)wy % 16 == 0 && (size_t)dwx % 16 == 0 &&
                       (size_t)dwy % 16 == 0 && (n_refs == 1 || n_events % per_thread == 0 ||
                                                 ((size_t)n_events * t) % 16 == 0);
  if (bad_launch(blocks, threads) || threads > 256 || hw < 0 || H < 1 || W < 1 ||
      n_refs < 1 || n_refs > 65535 || n_events < 1 || (vec && !aligned))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{wx, wy, grad, dwx, dwy, n_refs, n_events, H, W,
                  hw, per_thread, vec, blocks, threads, stream};
  if (f64) return wrap ? splat_bwd<double, true>(a) : splat_bwd<double, false>(a);
  return wrap ? splat_bwd<float, true>(a) : splat_bwd<float, false>(a);
}

// (n_events, 2) samples of the (h, w, 2) theta by ops/interp.py:
// plan_direct_interp: float64 at the coordinates rounded (half to even)
// (`f64` and `round`; the float64 solve), or float32 at the coordinates as
// given (neither; kernel 8's route); blocks x threads threads, per_thread
// events a thread (2 in float32 only; `vec`: xs and ys on 16 bytes), theta
// copied to shared memory with `staged`; `out` on 16 bytes
extern "C" int eincm_interp_direct_fwd(const void* theta, const void* xs,
                                       const void* ys, void* out,
                                       long long n_events, int h, int w,
                                       double scale_y, double scale_x, int f64,
                                       int round, int staged, int per_thread,
                                       int vec, int blocks, int threads,
                                       cudaStream_t stream) {
  const size_t t = f64 ? 8 : 4;
  if (bad_launch(blocks, threads) || threads > 256 || h < 1 || w < 1 || n_events < 1 ||
      !f64 != !round || (size_t)out % (2 * t) ||
      (staged && 2 * t * (size_t)h * w > 48 * 1024) ||
      (vec && ((size_t)xs % 16 || (size_t)ys % 16)))
    return (int)cudaErrorInvalidValue;
  if (f64)
    return interp_fwd<double, true>(theta, xs, ys, out, n_events, h, w, scale_y, scale_x,
                                    staged, per_thread, vec, blocks, threads, stream);
  return interp_fwd<float, false>(theta, xs, ys, out, n_events, h, w, scale_y, scale_x,
                                  staged, per_thread, vec, blocks, threads, stream);
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
