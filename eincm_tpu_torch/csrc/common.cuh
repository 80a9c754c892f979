// Device code shared by the port's kernels, so that every kernel samples the
// coarse theta and splats an event with the same f32 operations:
//   - axis_u / tri_weight / axis_taps / axis_taps_at / clamp_idx /
//     sample_theta: the bilinear scale-and-translate sample, as
//     interp_dense.cu takes it (axis_taps);
//   - weight_over / taps_of / taps_of_at / cell / sample2: the same sample
//     without the divisions whose quotient is known, and with theta read
//     from shared memory or gathered, as interp.cu (kernels 1 and 2) and
//     fused.cu (kernel 8) take it;
//   - gauss / window_hits: the IWE splat taps of splat.cu and fused.cu.
// Every f32 operation whose rounding matters is written with a
// round-to-nearest intrinsic, so nvcc cannot contract it into an FMA.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace eincm {

constexpr float kInvSqrt2Pi = 0.3989422804014327f;

struct Taps {
  int k0;    // first tap index (second is k0 + 1); unclamped
  float w0;  // normalized weight of tap k0 (0 when k0 is outside [0, n))
  float w1;  // normalized weight of tap k0 + 1
  bool in0, in1;
};

// The place of sensor coordinate c on an axis of coarse cells:
// u = (c + 0.5) * scale - 0.5, scale = cells / sensor pixels.
__device__ __forceinline__ float axis_u(float c, float scale) {
  return __fsub_rn(__fmul_rn(__fadd_rn(c, 0.5f), scale), 0.5f);
}

// The triangle weight max(0, 1 - |k - u|) of cell k at u (0 for a NaN u).
__device__ __forceinline__ float tri_weight(float k, float u) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(k, u))));
}

// The two triangle taps of one axis of n coarse cells at the sensor
// coordinate c, used as given: tri_weight at axis_u(c), masked to [0, n)
// and, with norm, divided by max(sum, 1e-20). Every other cell's weight is
// an exact 0, so the sum is the one over all n cells in any order.
__device__ __forceinline__ Taps axis_taps_at(float c, int n, float scale,
                                             bool norm = true) {
  Taps t;
  t.k0 = 0;
  t.w0 = 0.f;
  t.w1 = 0.f;
  t.in0 = t.in1 = false;
  const float u = axis_u(c, scale);
  if (isnan(u)) {  // the reference's weights are NaN on every row
    t.w0 = t.w1 = u;
    return t;
  }
  // a coordinate with no tap in [0, n), +-inf included; tested in float
  // before any conversion to int
  if (!(u > -2.f && u < (float)n + 1.f)) return t;
  const float kf = floorf(u);
  const int k0 = (int)kf;
  float a = tri_weight(kf, u);
  float b = tri_weight(__fadd_rn(kf, 1.f), u);
  t.in0 = k0 >= 0 && k0 < n;
  t.in1 = k0 + 1 >= 0 && k0 + 1 < n;
  if (!t.in0) a = 0.f;
  if (!t.in1) b = 0.f;
  t.k0 = k0;
  if (!norm) {
    t.w0 = a;
    t.w1 = b;
    return t;
  }
  const float s = fmaxf(__fadd_rn(a, b), 1e-20f);
  t.w0 = __fdiv_rn(a, s);
  t.w1 = __fdiv_rn(b, s);
  return t;
}

// The taps at the rounded coordinate (half to even, as jnp.round): the
// production interp's sample point.
__device__ __forceinline__ Taps axis_taps(float coord, int n, float scale,
                                          bool norm = true) {
  return axis_taps_at(rintf(coord), n, scale, norm);
}

// a / s in the same bits as __fdiv_rn(a, s) for a >= 0, s > 0, without the
// division where the quotient is known: 0 / s = 0, a / 1 = a, a / a = 1.
__device__ __forceinline__ float weight_over(float a, float s) {
  if (a == 0.f) return 0.f;
  if (s == 1.f) return a;
  if (s == a) return 1.f;
  return __fdiv_rn(a, s);
}

// axis_taps_at, bit for bit, with the two divisions of its normalization
// taken by weight_over. An IEEE division is ~10 instructions, and a warp
// takes its slow path as soon as one lane divides a zero, which a tap
// outside the grid does (every event at 1x1). With both taps inside, the
// triangle weights are 1 - d and d and their sum rounds to 1; with one tap
// inside the sum is that tap's weight. So the division itself is left to
// what neither case covers.
__device__ __forceinline__ Taps taps_of_at(float c, int n, float scale) {
  Taps t = axis_taps_at(c, n, scale, /*norm=*/false);
  if (isnan(t.w0)) return t;  // a NaN coordinate: NaN weights
  const float s = fmaxf(__fadd_rn(t.w0, t.w1), 1e-20f);
  t.w0 = weight_over(t.w0, s);
  t.w1 = weight_over(t.w1, s);
  return t;
}

// taps_of_at at the rounded coordinate: axis_taps, bit for bit.
__device__ __forceinline__ Taps taps_of(float coord, int n, float scale) {
  return taps_of_at(rintf(coord), n, scale);
}

__device__ __forceinline__ int clamp_idx(int k, int n) {
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// Channel c of the (h, w, 2) theta at the taps (ty, tx): rows first
// (column x0, then x1), then columns, the reference's order.
__device__ __forceinline__ float sample_theta(const float* __restrict__ theta,
                                              const Taps& ty, const Taps& tx,
                                              int h, int w, int c) {
  const int y0 = clamp_idx(ty.k0, h), y1 = clamp_idx(ty.k0 + 1, h);
  const int x0 = clamp_idx(tx.k0, w), x1 = clamp_idx(tx.k0 + 1, w);
  const float t00 = __ldg(theta + (y0 * w + x0) * 2 + c);
  const float t10 = __ldg(theta + (y1 * w + x0) * 2 + c);
  const float t01 = __ldg(theta + (y0 * w + x1) * 2 + c);
  const float t11 = __ldg(theta + (y1 * w + x1) * 2 + c);
  const float m0 = __fadd_rn(__fmul_rn(ty.w0, t00), __fmul_rn(ty.w1, t10));
  const float m1 = __fadd_rn(__fmul_rn(ty.w0, t01), __fmul_rn(ty.w1, t11));
  return __fadd_rn(__fmul_rn(m0, tx.w0), __fmul_rn(m1, tx.w1));
}

// Cell i of the (h, w, 2) theta: one float2 from a copy in shared memory
// (kStaged), else two gathers from device memory.
template <bool kStaged>
__device__ __forceinline__ float2 cell(const float* th, int i) {
  if (kStaged) return reinterpret_cast<const float2*>(th)[i];
  return make_float2(__ldg(th + 2 * i), __ldg(th + 2 * i + 1));
}

// Both channels of the (h, w, 2) theta at the taps (ty, tx): rows first
// (column x0, then x1), then columns, sample_theta's operations.
template <bool kStaged>
__device__ __forceinline__ void sample2(const float* th, const Taps& ty,
                                        const Taps& tx, int h, int w,
                                        float& o0, float& o1) {
  const int y0 = clamp_idx(ty.k0, h), y1 = clamp_idx(ty.k0 + 1, h);
  const int x0 = clamp_idx(tx.k0, w), x1 = clamp_idx(tx.k0 + 1, w);
  const float2 t00 = cell<kStaged>(th, y0 * w + x0);
  const float2 t10 = cell<kStaged>(th, y1 * w + x0);
  const float2 t01 = cell<kStaged>(th, y0 * w + x1);
  const float2 t11 = cell<kStaged>(th, y1 * w + x1);
  const float a0 = __fadd_rn(__fmul_rn(ty.w0, t00.x), __fmul_rn(ty.w1, t10.x));
  const float a1 = __fadd_rn(__fmul_rn(ty.w0, t01.x), __fmul_rn(ty.w1, t11.x));
  const float b0 = __fadd_rn(__fmul_rn(ty.w0, t00.y), __fmul_rn(ty.w1, t10.y));
  const float b1 = __fadd_rn(__fmul_rn(ty.w0, t01.y), __fmul_rn(ty.w1, t11.y));
  o0 = __fadd_rn(__fmul_rn(a0, tx.w0), __fmul_rn(a1, tx.w1));
  o1 = __fadd_rn(__fmul_rn(b0, tx.w0), __fmul_rn(b1, tx.w1));
}

__device__ __forceinline__ float gauss(float q) {
  // exp(-0.5 * q * q) * (1 / sqrt(2 pi)), the reference's operation order
  return expf((-0.5f * q) * q) * kInvSqrt2Pi;
}

// true when the rounded (2 hw + 1)^2 window of (rx, ry) touches the sensor;
// false for NaN and +-inf, which fail every comparison or the bounds
__device__ __forceinline__ bool window_hits(float rx, float ry, int H, int W,
                                            int hw) {
  return ry >= (float)-hw && ry <= (float)(H - 1 + hw) && rx >= (float)-hw &&
         rx <= (float)(W - 1 + hw);
}

}  // namespace eincm
