// Coarse-theta bilinear interpolation at rounded event coordinates.
//
// Replaces eincm_tpu/ops/interp_pallas.py: _fwd_kernel (reached through
// _interp_fwd) and _bwd_kernel (reached through _interp_bwd).
//
// Forward: out[e, c] = sum_{a,b} uy[e, a] * vx[e, b] * theta[ky_a, kx_b, c]
// with the scale-and-translate triangle weights of _axis_weights
// (common.cuh: axis_taps): at most two taps per axis, masked to [0, n) and
// divided by max(sum, 1e-20). Every f32 operation of the weights and of the
// contraction is written with the round-to-nearest intrinsics, so nvcc
// cannot contract them into FMAs and the result is the plain PyTorch
// version's operation for operation (bitwise on finite events).
//
// Backward: dtheta[h, w, c] = sum_e (vx[e, w] * g[e, c]) * uy[e, h].
//
// The events of a call are cut by ops/interp.py:plan_interp: a scalar head,
// groups of four events whose xs and ys are 16-byte aligned (one float4 load
// each; the (E, 2) array as two float4, four float2 or eight scalars, as its
// own alignment allows), a scalar tail. Thread (block b, thread t) takes
// groups b T + t, b T + t + B T, ... and the same scalar events, so the
// partition, and with it every sum below, is fixed by the plan.
//
// What bounds them on an H100, and the designs (every time, and the runs
// behind each statement, in PERF.md):
//   - The forward moves 16 bytes per event and is bound by instructions,
//     not bytes: ~120 per event by a count of the code. The largest share
//     was the weights' normalization, four IEEE divisions per event: ~10
//     instructions each, and a slow path that a whole warp takes when one
//     lane divides an exact 0, which every tap outside the grid does (so
//     the same bytes took 30% longer at 1x1 than at 16x16). taps_of
//     (common.cuh) takes the quotients that are known (0 / s, a / 1, a / a)
//     without dividing, bit for bit the same, for both kernels. Beyond that: four
//     events per thread (two float4 loads, the eight interleaved outputs as
//     two float4 stores) from 2^17 events on, one event per thread below
//     (at 30k events the launch is one wave and a thread's four events in a
//     row only lengthen it; its first event is read before theta is
//     staged); theta read from a copy in shared memory as one float2 per
//     tap up to 64x64 cells, by eight __ldg gathers above; one trip per
//     thread.
//   - The backward was bound by its launch (two blocks of 256 threads per
//     SM, whatever the event count) and by contention on its float
//     shared-memory atomics, which grows as the grid shrinks (512 words at
//     16x16, 2 at 1x1). Three kernels now, chosen by the grid's size:
//     * registers (h, w in {1, 2, 4}): no atomics. Each thread keeps the
//       whole (h, w, 2) partial gradient in registers and adds each event's
//       taps with predicated adds; the lanes of a warp are summed by a
//       __shfl_xor_sync butterfly, the warps of a block in warp order;
//     * fixed point (other grids up to 16x16): each block takes a
//       power-of-two unit from the largest finite |g| of its own events (a
//       first walk; the second re-reads the events from cache), so that
//       |term| <= 2^30 units, and adds round(term / unit) into a 64-bit sum
//       kept as two 32-bit words in shared memory with native integer
//       atomics: the eight low-word atomics of an event are issued before
//       any result is read, and the high word moves only on a carry (a few
//       terms in a hundred). The sums of a block are exact, whatever the
//       order. A term that is not finite sets a flag (NaN, +inf, -inf)
//       beside its word, and the flags decide the word as the float sum
//       would. The unit follows the largest |g| of the block whether or not
//       that event has a tap on the grid. What is left is the rate of
//       shared-memory atomics (12M of them at 1.5M events), which float
//       atomics with the same launch reach within a quarter at these grids;
//     * exact (above 16x16, where few events share a word and a partial
//       grid per block, summed by one block, costs more than it saves; and
//       at any grid, up to the sensor's own size): one unit for the whole
//       launch from a first kernel's maxima of |g| (exact.cuh), the terms
//       added exactly into a band of rows of the grid in shared memory and
//       the band's nonzero words into 64-bit sums in device memory, with
//       integer atomics; a band re-reads the events; a third kernel rounds
//       each sum to f32 once. The bands are as many as the grid needs to
//       fit a block (one up to about 120x120 cells); without bands
//       (kBanded false) every term goes to device memory, which beats
//       three or more bands (ops/interp.py:plan_interp chooses).
//       It replaces a float-atomic kernel, whose sums rounded in the
//       order the threads arrived.
//     The first two are one launch with no zeroed output: each block writes
//     its partial grid as f32 to scratch, and the last block to arrive (a
//     __threadfence and a ticket it resets) sums the partials in a fixed
//     order (plan.slices interleaved slices of the blocks, each in block
//     order, then the slices in order) and writes dtheta whole. On the same
//     inputs every mode's result is bitwise the same from run to run; the
//     exact mode's also for every plan and event order. The last block's
//     sum is a chain of round trips to L2, so a thread of it takes four
//     words at a time and keeps eight loads in flight.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "exact.cuh"
#include "tile.cuh"

namespace {

using eincm::clamp_idx;
using eincm::sample2;
using eincm::Taps;
using eincm::taps_of;
namespace exact = eincm::exact;

constexpr int kMaxThreads = 1024;
constexpr int kWideThreads = 512;  // kernels that may need > 64 registers
constexpr float kFltMax = 3.402823466e+38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnitBits = 30;  // |term| <= 2^30 units of a block's fixed point

// The events of one call, as ops/interp.py:plan_interp cuts them.
struct Events {
  const float* xs;
  const float* ys;
  long long n;       // events
  long long head;    // scalar events before the first group
  long long groups;  // runs of 4 events with 16-byte aligned xs and ys
  int vec;           // the (E, 2) array in a group: 4 float4, 2 float2, 1 scalar
};

// eight floats of the (E, 2) array at a group's first event
__device__ __forceinline__ void load8(const float* p, int vec, float v[8]) {
  if (vec == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else if (vec == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p) + k);
      v[2 * k] = a.x, v[2 * k + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(p + k);
  }
}

__device__ __forceinline__ void store8(float* p, int vec, const float v[8]) {
  if (vec == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if (vec == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      reinterpret_cast<float2*>(p)[k] = make_float2(v[2 * k], v[2 * k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = v[k];
  }
}

// the scalar event number s of a call: the head, then the tail
__device__ __forceinline__ long long scalar_event(const Events& ev,
                                                  long long s) {
  return s < ev.head ? s : s + 4 * ev.groups;
}

// A thread's first scalar event, read before it is needed so that its
// round trip to device memory overlaps what comes between (most calls of
// one-by-one plans are one trip).
struct FirstEvent {
  bool have;
  float x, y, g0, g1;
};

__device__ __forceinline__ FirstEvent first_event(const Events& ev,
                                                  const float* __restrict__ g) {
  FirstEvent p;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  p.have = tid < ev.n - 4 * ev.groups;
  p.x = p.y = p.g0 = p.g1 = 0.f;
  if (p.have) {
    const long long e = scalar_event(ev, tid);
    p.x = __ldg(ev.xs + e), p.y = __ldg(ev.ys + e);
    p.g0 = __ldg(g + 2 * e), p.g1 = __ldg(g + 2 * e + 1);
  }
  return p;
}

// f(x, y, g0, g1) for every event of this thread, groups first
template <class F>
__device__ __forceinline__ void for_each_event(const Events& ev,
                                               const float* __restrict__ g,
                                               const FirstEvent& first, F f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long q = tid; q < ev.groups; q += stride) {
    const long long e0 = ev.head + 4 * q;
    const float4 x = __ldg(reinterpret_cast<const float4*>(ev.xs + e0));
    const float4 y = __ldg(reinterpret_cast<const float4*>(ev.ys + e0));
    float gv[8];
    load8(g + 2 * e0, ev.vec, gv);
    f(x.x, y.x, gv[0], gv[1]);
    f(x.y, y.y, gv[2], gv[3]);
    f(x.z, y.z, gv[4], gv[5]);
    f(x.w, y.w, gv[6], gv[7]);
  }
  if (first.have) f(first.x, first.y, first.g0, first.g1);
  const long long n_scalar = ev.n - 4 * ev.groups;
  for (long long s = tid + stride; s < n_scalar; s += stride) {
    const long long e = scalar_event(ev, s);
    f(__ldg(ev.xs + e), __ldg(ev.ys + e), __ldg(g + 2 * e),
      __ldg(g + 2 * e + 1));
  }
}

// ---- forward ---------------------------------------------------------------

template <bool kStaged>
__global__ void __launch_bounds__(kWideThreads)
    interp_fwd_kernel(const float* __restrict__ theta, Events ev,
                      float* __restrict__ out, int h, int w, float sy,
                      float sx) {
  extern __shared__ __align__(16) float staged[];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_scalar = ev.n - 4 * ev.groups;
  // the thread's first scalar event is read before theta is staged, so that
  // the two round trips to device memory overlap: at 30k events a thread
  // has one event and the kernel is that chain (doing the same for the
  // first group made the 1.5M-event time worse)
  float x1 = 0.f, y1 = 0.f;
  if (tid < n_scalar) {
    x1 = __ldg(ev.xs + scalar_event(ev, tid));
    y1 = __ldg(ev.ys + scalar_event(ev, tid));
  }
  const float* th = theta;
  if (kStaged) {
    for (int i = threadIdx.x; i < h * w * 2; i += blockDim.x)
      staged[i] = __ldg(theta + i);
    __syncthreads();
    th = staged;
  }
  for (long long q = tid; q < ev.groups; q += stride) {
    const long long e0 = ev.head + 4 * q;
    const float4 x = __ldg(reinterpret_cast<const float4*>(ev.xs + e0));
    const float4 y = __ldg(reinterpret_cast<const float4*>(ev.ys + e0));
    const float xv[4] = {x.x, x.y, x.z, x.w}, yv[4] = {y.x, y.y, y.z, y.w};
    float o[8];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sample2<kStaged>(th, taps_of(yv[k], h, sy), taps_of(xv[k], w, sx), h,
                       w, o[2 * k], o[2 * k + 1]);
    store8(out + 2 * e0, ev.vec, o);
  }
  for (long long s = tid; s < n_scalar; s += stride) {
    const long long e = scalar_event(ev, s);
    if (s != tid) x1 = __ldg(ev.xs + e), y1 = __ldg(ev.ys + e);
    sample2<kStaged>(th, taps_of(y1, h, sy), taps_of(x1, w, sx), h, w,
                     out[2 * e], out[2 * e + 1]);
  }
}

// ---- backward ---------------------------------------------------------------

struct Bwd {
  const float* g;   // (E, 2) cotangent
  float* dtheta;    // (h, w, 2), written whole by the last block
  float* partials;  // (blocks, 2 h w) scratch, one partial grid per block
  unsigned* ticket;  // 0 between launches
  int h, w;
  float sy, sx;
  int slices;  // interleaved slices of the blocks in the last block's sum
};

// The taps of one event and which of them count: a tap outside [0, n) adds
// nothing; a NaN weight poisons the two taps the plain version gathers.
struct EventTaps {
  int y0, y1, x0, x1;
  float uy0, uy1, vx0, vx1;
  bool iy0, iy1, ix0, ix1;
};

__device__ __forceinline__ EventTaps event_taps(float x, float y, int h, int w,
                                                float sy, float sx) {
  const Taps ty = taps_of(y, h, sy), tx = taps_of(x, w, sx);
  EventTaps t;
  t.y0 = clamp_idx(ty.k0, h), t.y1 = clamp_idx(ty.k0 + 1, h);
  t.x0 = clamp_idx(tx.k0, w), t.x1 = clamp_idx(tx.k0 + 1, w);
  t.uy0 = ty.w0, t.uy1 = ty.w1, t.vx0 = tx.w0, t.vx1 = tx.w1;
  const bool nan_y = isnan(ty.w0), nan_x = isnan(tx.w0);
  t.iy0 = ty.in0 || nan_y, t.iy1 = ty.in1 || nan_y;
  t.ix0 = tx.in0 || nan_x, t.ix1 = tx.in1 || nan_x;
  return t;
}

// true, in every thread, in the last block of the grid to get here; what
// the block's threads wrote before is then visible to that block
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();  // the block's writes, ordered before thread 0's fence
  if (threadIdx.x == 0) {
    __threadfence();  // cumulative: the whole block's writes
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  return last;
}

// dtheta = the sum of the blocks' partial grids in a fixed order: slice s
// sums blocks s, s + slices, ... in order, then the slices are summed in
// order. A thread of a slice takes four words at a time (one where m is
// not a multiple of 4) and keeps eight loads in flight: the sum is a chain
// of round trips to L2, and at 30k events it is a fifth of the kernel.
// Needs slices <= blocks and slices * (m / 4 or m) <= blockDim. Called by
// every thread of one block; resets the ticket.
template <class V>
__device__ __forceinline__ void sum_partials_as(const Bwd& a, int m,
                                                float* red) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int lanes = m / kW;  // threads of one slice
  const int s = threadIdx.x / lanes, i = threadIdx.x % lanes;
  if (s < a.slices) {
    const V* p = reinterpret_cast<const V*>(a.partials) + i;
    V v = __ldcg(p + (long long)s * lanes);
    float* vf = reinterpret_cast<float*>(&v);
    for (int b = s + a.slices; b < (int)gridDim.x; b += 8 * a.slices) {
      V part[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int bk = b + k * a.slices;
        if (bk < (int)gridDim.x) part[k] = __ldcg(p + (long long)bk * lanes);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (b + k * a.slices < (int)gridDim.x) {
          const float* pf = reinterpret_cast<const float*>(&part[k]);
#pragma unroll
          for (int c = 0; c < kW; ++c) vf[c] = __fadd_rn(vf[c], pf[c]);
        }
      }
    }
    reinterpret_cast<V*>(red)[s * lanes + i] = v;
  }
}

__device__ __forceinline__ void sum_partials(const Bwd& a, int m) {
  __shared__ __align__(16) float red[4 * kMaxThreads];
  if (m % 4 == 0) {
    sum_partials_as<float4>(a, m, red);
  } else {
    sum_partials_as<float>(a, m, red);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    float v = red[i];
    for (int k = 1; k < a.slices; ++k) v = __fadd_rn(v, red[k * m + i]);
    a.dtheta[i] = v;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

// Coarse grids: the partial gradient in registers, no atomics.
template <int GH, int GW>
__global__ void __launch_bounds__(kWideThreads)
    interp_bwd_reg_kernel(Events ev, Bwd a) {
  constexpr int M = GH * GW * 2;
  static_assert(M <= 32, "one register per word of the grid");
  float acc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = 0.f;
  for_each_event(ev, a.g, first_event(ev, a.g), [&](float x, float y, float g0, float g1) {
    const EventTaps t = event_taps(x, y, GH, GW, a.sy, a.sx);
    // the cell of each tap on its axis, -1 for a tap that adds nothing
    const int xa = t.ix0 ? t.x0 : -1, xb = t.ix1 ? t.x1 : -1;
    const int ya = t.iy0 ? t.y0 : -1, yb = t.iy1 ? t.y1 : -1;
    // columns first: (vx * g) for the column's tap, if it has one
    float c0[GW], c1[GW];
#pragma unroll
    for (int i = 0; i < GW; ++i) {
      const float vx = xa == i ? t.vx0 : t.vx1;
      c0[i] = __fmul_rn(vx, g0);
      c1[i] = __fmul_rn(vx, g1);
    }
#pragma unroll
    for (int j = 0; j < GH; ++j) {
      const float uy = ya == j ? t.uy0 : t.uy1;
#pragma unroll
      for (int i = 0; i < GW; ++i) {
        // a cell no tap of the event lands on gets an exact 0
        const bool on = (ya == j || yb == j) && (xa == i || xb == i);
        const int k = (j * GW + i) * 2;
        acc[k] = __fadd_rn(acc[k], on ? __fmul_rn(c0[i], uy) : 0.f);
        acc[k + 1] = __fadd_rn(acc[k + 1], on ? __fmul_rn(c1[i], uy) : 0.f);
      }
    }
  });
  // lanes by a butterfly (every lane ends with the same sum), warps in order
  __shared__ float warp_sums[32 * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off; off >>= 1)
      v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
    if (lane == 0) warp_sums[warp * M + i] = v;
  }
  __syncthreads();
  if (threadIdx.x < M) {
    float v = warp_sums[threadIdx.x];
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k)
      v = __fadd_rn(v, warp_sums[k * M + threadIdx.x]);
    a.partials[(long long)blockIdx.x * M + threadIdx.x] = v;
  }
  if (last_block(a.ticket)) sum_partials(a, M);
}

// A block's fixed-point grid in shared memory: word i is the 64-bit sum
// (hi[i], lo[i]) and a flag byte (1 +inf, 2 -inf, 4 NaN).
struct FixedGrid {
  unsigned* lo;
  unsigned* hi;
  unsigned* flags;
  float scale;  // terms are rounded to multiples of 1 / scale
};

// The eight terms of one event (4 taps x 2 channels) into the grid. All the
// low-word atomics are issued before any of their results is read, so that
// their round trips to shared memory overlap; the high word moves only on
// a carry, and a term that is not finite only sets its flag.
__device__ __forceinline__ void fixed_event(const FixedGrid& f,
                                            const EventTaps& t, int w, float g0,
                                            float g1) {
  const bool on[4] = {t.iy0 && t.ix0, t.iy1 && t.ix0, t.iy0 && t.ix1,
                      t.iy1 && t.ix1};
  const int cell_idx[4] = {t.y0 * w + t.x0, t.y1 * w + t.x0, t.y0 * w + t.x1,
                           t.y1 * w + t.x1};
  const float c0[2] = {__fmul_rn(t.vx0, g0), __fmul_rn(t.vx1, g0)};
  const float c1[2] = {__fmul_rn(t.vx0, g1), __fmul_rn(t.vx1, g1)};
  const float uy[2] = {t.uy0, t.uy1};
  int q[8];
  unsigned old[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int tap = k >> 1;
    const float term = __fmul_rn((k & 1) ? c1[tap >> 1] : c0[tap >> 1], uy[tap & 1]);
    const int i = 2 * cell_idx[tap] + (k & 1);
    q[k] = 0;
    if (on[tap]) {
      if (fabsf(term) <= kFltMax) {
        q[k] = __float2int_rn(__fmul_rn(term, f.scale));
        if (q[k]) old[k] = atomicAdd(f.lo + i, (unsigned)q[k]);
      } else {
        const unsigned bits = isnan(term) ? 4u : (term > 0.f ? 1u : 2u);
        atomicOr(f.flags + (i >> 2), bits << ((i & 3) * 8));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (q[k]) {
      const unsigned u = (unsigned)q[k];
      const int up = (q[k] < 0 ? -1 : 0) + (old[k] + u < old[k] ? 1 : 0);
      if (up) atomicAdd(f.hi + 2 * cell_idx[k >> 1] + (k & 1), (unsigned)up);
    }
  }
}

// Up to 16x16: a block's sums in 64-bit fixed point on integer atomics.
__global__ void __launch_bounds__(kMaxThreads)
    interp_bwd_fixed_kernel(Events ev, Bwd a) {
  extern __shared__ __align__(16) unsigned sums[];
  const int m = a.h * a.w * 2;
  unsigned* lo = sums;
  unsigned* hi = sums + m;
  unsigned* flags = sums + 2 * m;  // a byte per word: 1 +inf, 2 -inf, 4 NaN
  const FirstEvent first = first_event(ev, a.g);
  for (int i = threadIdx.x; i < 2 * m + (m + 3) / 4; i += blockDim.x)
    sums[i] = 0u;

  // first walk: the largest finite |g| of the block's events
  float gmax = 0.f;
  if (first.have) {
    if (fabsf(first.g0) <= kFltMax) gmax = fabsf(first.g0);
    if (fabsf(first.g1) <= kFltMax) gmax = fmaxf(gmax, fabsf(first.g1));
  }
  {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long q = tid; q < ev.groups; q += stride) {
      float gv[8];
      load8(a.g + 2 * (ev.head + 4 * q), ev.vec, gv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float av = fabsf(gv[k]);
        if (av <= kFltMax) gmax = fmaxf(gmax, av);
      }
    }
    const long long n_scalar = ev.n - 4 * ev.groups;
    for (long long s = tid + stride; s < n_scalar; s += stride) {
      const long long e = scalar_event(ev, s);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float av = fabsf(__ldg(a.g + 2 * e + k));
        if (av <= kFltMax) gmax = fmaxf(gmax, av);
      }
    }
  }
  __shared__ float warp_max[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off; off >>= 1)
    gmax = fmaxf(gmax, __shfl_xor_sync(kFull, gmax, off));
  if (lane == 0) warp_max[warp] = gmax;
  __syncthreads();  // the zeroed sums too
  gmax = warp_max[lane < (int)(blockDim.x >> 5) ? lane : 0];
#pragma unroll
  for (int off = 16; off; off >>= 1)
    gmax = fmaxf(gmax, __shfl_xor_sync(kFull, gmax, off));
  // the unit 2^-s with gmax * 2^s in [2^29, 2^30): exact to scale by
  const int expo = (int)(__float_as_uint(gmax) >> 23) - 127;
  const int s = min(kUnitBits - 1 - expo, 126);
  const float scale = __uint_as_float((unsigned)(127 + s) << 23);
  const float unit = __uint_as_float((unsigned)(127 - s) << 23);

  // second walk: the taps
  const FixedGrid f{lo, hi, flags, scale};
  for_each_event(ev, a.g, first, [&](float x, float y, float g0, float g1) {
    fixed_event(f, event_taps(x, y, a.h, a.w, a.sy, a.sx), a.w, g0, g1);
  });
  __syncthreads();

  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const long long sum =
        (long long)(((unsigned long long)hi[i] << 32) | (unsigned long long)lo[i]);
    float v = __fmul_rn(__ll2float_rn(sum), unit);
    const unsigned f = (flags[i >> 2] >> ((i & 3) * 8)) & 7u;
    if (f) v = (f & 4u) || (f & 3u) == 3u ? NAN : (f & 1u ? INFINITY : -INFINITY);
    a.partials[(long long)blockIdx.x * m + i] = v;
  }
  if (last_block(a.ticket)) sum_partials(a, m);
}

// Above 16x16: one unit for the whole launch (exact.cuh), terms added
// exactly into a band of rows of the grid in shared memory (kBanded), the
// band's nonzero words then into the 64-bit sums in device memory; or
// straight into those sums (kBanded false). Block (chunk, band) walks its
// chunk's events; blockIdx.y is the band.
template <bool kBanded>
__global__ void __launch_bounds__(kMaxThreads)
    interp_bwd_exact_kernel(Events ev, Bwd a, exact::Exact<float> x,
                            int band_rows) {
  extern __shared__ __align__(16) unsigned band_sums[];
  const long long row_words = 2LL * a.w;
  exact::Band<float> band{nullptr, nullptr, 0, 0};
  if (kBanded) {
    const int r0 = blockIdx.y * band_rows;
    const int r1 = min(a.h, r0 + band_rows);
    band.w0 = r0 * row_words;
    band.w1 = r1 * row_words;
    band.lo = band_sums;
    band.hi = band_sums + (band.w1 - band.w0);
    exact::zero_band(band);
  }
  const FirstEvent first = first_event(ev, a.g);
  const int s = exact::launch_shift(x);  // its __syncthreads: the zeroed band too
  const float scale = exact::Fixed<float>::pow2(s);
  for_each_event(ev, a.g, first, [&](float x_, float y_, float g0, float g1) {
    const EventTaps t = event_taps(x_, y_, a.h, a.w, a.sy, a.sx);
    const bool on[4] = {t.iy0 && t.ix0, t.iy1 && t.ix0, t.iy0 && t.ix1,
                        t.iy1 && t.ix1};
    const long long cell_idx[4] = {(long long)t.y0 * a.w + t.x0, (long long)t.y1 * a.w + t.x0,
                                   (long long)t.y0 * a.w + t.x1, (long long)t.y1 * a.w + t.x1};
    const float c0[2] = {__fmul_rn(t.vx0, g0), __fmul_rn(t.vx1, g0)};
    const float c1[2] = {__fmul_rn(t.vx0, g1), __fmul_rn(t.vx1, g1)};
    const float uy[2] = {t.uy0, t.uy1};
    long long word[8];
    float term[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int tap = k >> 1;
      term[k] = __fmul_rn((k & 1) ? c1[tap >> 1] : c0[tap >> 1], uy[tap & 1]);
      word[k] = on[tap] ? 2 * cell_idx[tap] + (k & 1) : -1;
    }
    if (kBanded) {
      exact::band_terms(band, x.flags, word, term, scale);
    } else {
      exact::global_terms(x, word, term, scale);
    }
  });
  if (kBanded) {
    __syncthreads();
    exact::flush_band(band, x);
  }
}

template <int GH, int GW>
void launch_reg(const Events& ev, const Bwd& a, int blocks, int threads,
                cudaStream_t stream) {
  interp_bwd_reg_kernel<GH, GW><<<blocks, threads, 0, stream>>>(ev, a);
}

bool bad_launch(int blocks, int threads, int max_threads) {
  return blocks < 1 || threads < 32 || threads > max_threads || threads % 32;
}

}  // namespace

// blocks x threads over the plan's head, groups and tail; theta read from a
// shared-memory copy where `staged`
extern "C" int eincm_interp_fwd(const float* theta, const float* xs,
                                const float* ys, float* out,
                                long long n_events, long long head,
                                long long groups, int vec, int h, int w,
                                float sy, float sx, int staged, int blocks,
                                int threads, cudaStream_t stream) {
  if (bad_launch(blocks, threads, kWideThreads)) return (int)cudaErrorInvalidValue;
  const Events ev{xs, ys, n_events, head, groups, vec};
  if (staged) {
    const size_t smem = (size_t)h * w * 2 * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    interp_fwd_kernel<true><<<blocks, threads, smem, stream>>>(theta, ev, out,
                                                              h, w, sy, sx);
  } else {
    interp_fwd_kernel<false><<<blocks, threads, 0, stream>>>(theta, ev, out, h,
                                                            w, sy, sx);
  }
  return (int)cudaGetLastError();
}

// mode 0: registers (h, w in {1, 2, 4}), 1: fixed point with a unit per
// block (partials summed by the last block in a fixed order)
extern "C" int eincm_interp_bwd(const float* g, const float* xs,
                                const float* ys, float* dtheta,
                                float* partials, unsigned* ticket,
                                long long n_events, long long head,
                                long long groups, int vec, int h, int w,
                                float sy, float sx, int mode, int blocks,
                                int threads, int slices,
                                cudaStream_t stream) {
  const Events ev{xs, ys, n_events, head, groups, vec};
  const Bwd a{g, dtheta, partials, ticket, h, w, sy, sx, slices};
  const int m = h * w * 2;
  if (slices < 1 || slices > blocks || slices * (m % 4 ? m : m / 4) > threads)
    return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    if (bad_launch(blocks, threads, kWideThreads)) return (int)cudaErrorInvalidValue;
    switch (h * 8 + w) {
      case 1 * 8 + 1: launch_reg<1, 1>(ev, a, blocks, threads, stream); break;
      case 1 * 8 + 2: launch_reg<1, 2>(ev, a, blocks, threads, stream); break;
      case 1 * 8 + 4: launch_reg<1, 4>(ev, a, blocks, threads, stream); break;
      case 2 * 8 + 1: launch_reg<2, 1>(ev, a, blocks, threads, stream); break;
      case 2 * 8 + 2: launch_reg<2, 2>(ev, a, blocks, threads, stream); break;
      case 2 * 8 + 4: launch_reg<2, 4>(ev, a, blocks, threads, stream); break;
      case 4 * 8 + 1: launch_reg<4, 1>(ev, a, blocks, threads, stream); break;
      case 4 * 8 + 2: launch_reg<4, 2>(ev, a, blocks, threads, stream); break;
      case 4 * 8 + 4: launch_reg<4, 4>(ev, a, blocks, threads, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  if (bad_launch(blocks, threads, kMaxThreads) || mode != 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned) * (2 * (size_t)m + (m + 3) / 4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        interp_bwd_fixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  interp_bwd_fixed_kernel<<<blocks, threads, smem, stream>>>(ev, a);
  return (int)cudaGetLastError();
}

// The exact kernel of any grid: the prep (zeroed sums, partial maxima of
// |g|), the accumulation over `blocks` chunks x ceil(h / band_rows) bands
// of band_rows rows each (band_rows 0: no bands, every term into device
// memory), and the finish into dtheta (written whole). `scratch`:
// exact.cuh's ExactLayout for 2 h w words, 16-byte aligned.
extern "C" int eincm_interp_bwd_exact(const float* g, const float* xs,
                                      const float* ys, float* dtheta,
                                      void* scratch, long long n_events,
                                      long long head, long long groups,
                                      int vec, int h, int w, float sy,
                                      float sx, int band_rows, int blocks,
                                      int threads, cudaStream_t stream) {
  const long long m = 2LL * h * w;
  const int bands = band_rows > 0 ? (h + band_rows - 1) / band_rows : 1;
  const size_t smem = band_rows > 0 ? sizeof(unsigned) * 2 * (size_t)band_rows * 2 * w : 0;
  if (bad_launch(blocks, threads, kMaxThreads) || h < 1 || w < 1 || band_rows < 0 ||
      bands > 65535 || smem > (size_t)eincm::kMaxSmem - 1024 ||
      (size_t)scratch % 16 || n_events < 1)
    return (int)cudaErrorInvalidValue;
  const Events ev{xs, ys, n_events, head, groups, vec};
  const Bwd a{g, dtheta, nullptr, nullptr, h, w, sy, sx, 1};
  const int prep = exact::prep_blocks(2 * n_events);
  const exact::Exact<float> x(scratch, m, prep);
  exact::exact_prep_kernel<float><<<prep, exact::kPrepThreads, 0, stream>>>(
      g, 2 * n_events, x);
  if (band_rows > 0) {
    cudaError_t err = cudaFuncSetAttribute(interp_bwd_exact_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    interp_bwd_exact_kernel<true><<<dim3(blocks, bands), threads, smem, stream>>>(
        ev, a, x, band_rows);
  } else {
    interp_bwd_exact_kernel<false><<<blocks, threads, 0, stream>>>(ev, a, x, 0);
  }
  exact::exact_finish_kernel<float><<<exact::finish_blocks(m), 256, 0, stream>>>(x, dtheta);
  return (int)cudaGetLastError();
}
