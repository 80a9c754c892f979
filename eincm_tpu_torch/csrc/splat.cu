// Image of warped events (IWE) and its coordinate gradient, all reference
// times in one launch each.
//
// Replaces four TPU kernels, which compute two functions:
//   - eincm_tpu/ops/splat_pallas.py: _splat_kernel (events_to_pdf_frame_pallas)
//     and _bwd_kernel (_bwd_pallas), the full-height splat;
//   - eincm_tpu/ops/splat_banded.py: _fwd_kernel (_banded_fwd_call) and
//     _bwd_kernel (_banded_bwd_call), the row/column-banded splat.
//
// Forward: frames[r, i, j] += g(i - y) g(j - x) for the (2 HW + 1)^2 texels
// with |i - round(y)| <= HW and |j - round(x)| <= HW inside the sensor,
// where g(q) = exp(-q^2 / 2) / sqrt(2 pi) and HW = window_size // 2 (1 or 2:
// windows 3 and 5, the only ones built; every kernel is a template on HW).
// An event whose coordinate is not finite, or whose rounded window misses
// the sensor, adds nothing; the range is tested in float before any
// conversion to int.
//
// What bounds the forward on an H100, and the design. One global
// atomicAdd per tap (27M at 1.5M events x 2 refs) ran at ~70G per second
// in L2, with uniform and with crowded events alike: 2% of the HBM bound.
// Now every tap lands in shared memory. The frame of each ref is cut into
// slabs of whole rows (and, for a row wider than one tile, of columns),
// each small enough for one block's shared memory, and the events of a ref
// into interleaved chunks; the plan (ops/splat_kernel.py:plan_splat)
// fixes both. Block (ref, chunk, slab) zeroes its tile, walks its chunk's
// events with coalesced loads (sibling slabs read the same events, mostly
// from L2), adds the taps that fall in its slab, and adds the tile's
// nonzero texels once into a zeroed 64-bit fixed-point copy of the frames
// in device memory; a second kernel rounds each of its sums to f32 once.
// No sort, no global atomic per tap. Every sum is exact in integers, so the
// frames are bitwise the same from run to run and for every plan: float
// reductions of the tiles (float4 atomicAdd, as this kernel first did)
// rounded in the order the blocks arrived, and a solve of a few hundred
// launches carried those last bits to AEEs that differed by 0.05 px from
// run to run. Three findings on the card (PERF.md) shaped it:
//   - a float atomicAdd on shared memory is a compare-and-swap loop, so a
//     texel is a 32-bit fixed-point sum in units of 2^-24 kept with native
//     integer atomics: each tap is rounded to 2^-24 (<= 3e-8), the sums in a
//     tile are exact, and a counter that wraps carries 2^32 units (256.0)
//     into the frame's sum with one global atomic (at most one per ~1600
//     taps of a texel);
//   - most events of a chunk miss a block's slab, and a warp that ran the
//     taps for whichever lanes hit ran them for nearly every event, once
//     per slab: each warp queues the events that hit (ballot and prefix
//     count into a 64-entry queue in shared memory) and runs the taps 32 at
//     a time;
//   - chunks are interleaved runs of blockDim x 2 events, so time- or
//     row-sorted events reach every slab of every chunk.
// What is left: the walk (slabs x 8 bytes per event and ref from L2, a
// range test and a ballot each), the tile's zeroing and scan (which set
// the time at 30k events), and the shared atomics.
//
// Backward: dwx = sum_j (sum_i u_i G[i, j]) v'_j and
//           dwy = sum_i (sum_j v_j G[i, j]) u'_i, with v' = q g(q),
// over the event's window of the cotangent frame G; off-sensor texels
// count 0, non-finite results become 0. No atomics: every event is written
// once, and a result is bitwise the same from run to run and from kernel to
// kernel (one statement sequence per event, bwd_event).
//
// What bounds the backward on an H100, and the design (PERF.md has the
// times and the runs). It moves 16 bytes per event and gathers 9 texels of
// 4 bytes (25 with a 5x5 window), and is bound by neither the bytes nor, alone, the gathers'
// sectors: with the events sorted by texel, so that a warp's lanes read the
// same few sectors, it is a quarter to a third faster (0.040 against 0.056
// ms at 1.5M events x 2 refs), and the rest is its instruction stream (6
// expf, the windows' bounds, a 64-bit division per event for the ref) and
// the L1's rate of divergent 4-byte loads. Holding the frame in the shared
// memory of a thread block cluster, a slab of rows per block, was built and
// measured and is gone: a load from a sibling block's shared memory
// (ld.shared::cluster) that is not coalesced costs as much as the L2
// sector it replaces (~65G a second over the card; 0.44 ms on unsorted
// events), and sorted events, which read their own block's slab, still
// paid for loading the frame per cluster (0.059 against the gather's
// 0.043 ms). So the gathers stay in L1 and L2, and the work around them is
// cut. Two kernels, chosen by ops/splat_kernel.py:plan_splat_bwd by the
// event count alone:
//   - gather (few events, where the time is the launch's): one thread per
//     (ref, event) over all refs, as before;
//   - stream (from 2^19 events per ref): a grid of its own per ref (no
//     division), four events in a row per thread as one float4 load per
//     coordinate array and one float4 store per gradient array, and a
//     row's 2 HW + 1 texels as the HW + 1 aligned 8-byte pairs that hold
//     them (six gathers per event instead of nine, fifteen instead of 25)
//     where the frame's rows start on 8 bytes and the window's columns are
//     on the sensor.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

using eincm::gauss;
using eincm::kMaxSmem;
using eincm::kUnit;
using eincm::quantize;
using eincm::window_hits;

// events each thread loads at once: more spill at the 64 registers of
// a 1024-thread block and run slower (PERF.md)
constexpr int kUnroll = 2;
// of one block's shared memory (tile.cuh: kMaxSmem) each warp of a block of
// up to 1024 threads keeps a queue of kQueue events
constexpr int kQueue = 64;
constexpr int kQueueBytes = 32 * kQueue * 8;
// x + 1.5 * 2^23 holds rint(x) (half to even) in its low mantissa bits for
// |x| < 2^22
constexpr float kRound = 12582912.f;
constexpr unsigned kRoundBits = 0x4B400000u;

// a texel of the frames while the blocks add into them: a 64-bit sum in
// units of 2^-24, exact whatever the order of the adds; a tile counter that
// wraps carries 2^32 units
using Sum = unsigned long long;
constexpr Sum kCarrySum = 1ull << 32;

struct SlabPlan {
  int tile_rows, tile_cols;  // rows and columns of one tile
  int row_slabs, col_slabs;
  int chunks;  // interleaved event chunks per ref
};

struct Center {
  float rx, ry;  // the rounded coordinates (half to even)
  int ix, iy;
};

// the rounded coordinates of an event, by the magic number, after a float
// range test that NaN, +-inf and far coordinates fail (so |x| < 2^22); true
// when its window of radius HW touches the sensor
template <int HW>
__device__ __forceinline__ bool center(float x, float y, int H, int W,
                                       Center& c) {
  if (!(x > -4.f && x < (float)W + 4.f && y > -4.f && y < (float)H + 4.f))
    return false;
  const float sx = __fadd_rn(x, kRound), sy = __fadd_rn(y, kRound);
  c.rx = __fsub_rn(sx, kRound);
  c.ry = __fsub_rn(sy, kRound);
  c.ix = (int)(__float_as_uint(sx) - kRoundBits);
  c.iy = (int)(__float_as_uint(sy) - kRoundBits);
  return window_hits(c.rx, c.ry, H, W, HW);
}

// true when a tap of the event falls in the tile [r0, r1) x [c0, c1): its
// window reaches HW rows and columns past its center, so an event up to HW
// rows outside a slab still has taps in it. This halo and deposit's own row
// and column test are all that the radius changes in the slab partition;
// ops/splat_kernel.py:plan_splat cuts whole slabs and needs no halo.
template <int HW>
__device__ __forceinline__ bool in_tile(float x, float y, int H, int W, int r0,
                                        int r1, int c0, int c1) {
  Center c;
  return center<HW>(x, y, H, W, c) && c.iy + HW >= r0 && c.iy - HW < r1 &&
         c.ix + HW >= c0 && c.ix - HW < c1;
}

// the taps of one event that fall in the tile, added into it with integer
// shared-memory atomics (a float atomicAdd on shared memory is a
// compare-and-swap loop), each g(i - y) g(j - x) rounded to 2^-24
template <int HW>
__device__ __forceinline__ void deposit(unsigned* tile, Sum* frame, float x,
                                        float y, int H, int W, int r0, int r1,
                                        int c0, int c1, int tc) {
  Center c;
  if (!center<HW>(x, y, H, W, c)) return;
  constexpr int kTaps = 2 * HW + 1;
  float gy[kTaps], gx[kTaps];
#pragma unroll
  for (int d = 0; d < kTaps; ++d) {
    gy[d] = gauss((c.ry + (float)(d - HW)) - y);
    gx[d] = gauss((c.rx + (float)(d - HW)) - x);
  }
#pragma unroll
  for (int a = 0; a < kTaps; ++a) {
    const int row = c.iy + a - HW;
    if (row < r0 || row >= r1) continue;
#pragma unroll
    for (int b = 0; b < kTaps; ++b) {
      const int col = c.ix + b - HW;
      if (col < c0 || col >= c1) continue;
      const unsigned q = quantize(gy[a] * gx[b]);
      const unsigned old = atomicAdd(tile + (row - r0) * tc + (col - c0), q);
      if (old + q < old)  // at most once per ~1600 taps of a texel
        atomicAdd(frame + (long long)row * W + col, kCarrySum);
    }
  }
}

// n texels of the tile (shared, from src) added into the frames' sums
// (global, dst); zeros skipped
__device__ __forceinline__ void add_tile(Sum* __restrict__ dst,
                                         const unsigned* src, long long n) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned v = src[i];
    if (v) atomicAdd(dst + i, (Sum)v);
  }
}

template <int HW>
__global__ void __launch_bounds__(1024)
    splat_fwd_slab_kernel(const float* __restrict__ wx,
                          const float* __restrict__ wy,
                          Sum* __restrict__ frames, long long n_events,
                          int H, int W, SlabPlan p) {
  extern __shared__ __align__(16) unsigned tile[];  // + up to 3 spare texels
  // block = ((ref * chunks + chunk) * row_slabs + row slab) * col_slabs +
  // col slab: the slabs of one chunk are neighbours, so they run together
  // and share the chunk's loads in L2
  int b = blockIdx.x;
  const int cs = b % p.col_slabs;
  b /= p.col_slabs;
  const int rs = b % p.row_slabs;
  b /= p.row_slabs;
  const int chunk = b % p.chunks;
  const int ref = b / p.chunks;
  const int r0 = rs * p.tile_rows, c0 = cs * p.tile_cols;
  const int r1 = min(r0 + p.tile_rows, H), c1 = min(c0 + p.tile_cols, W);
  const int tr = r1 - r0, tc = c1 - c0;
  for (int i = threadIdx.x; i < (tr * tc + 3) / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // chunk c takes the runs of blockDim x kUnroll events numbered c,
  // c + chunks, ...: time- or row-sorted events spread over every slab
  const float* xs = wx + (long long)ref * n_events;
  const float* ys = wy + (long long)ref * n_events;
  Sum* frame = frames + (long long)ref * H * W;
  // Most events of a chunk miss the slab. A warp that ran the taps of
  // whichever lanes hit would run them for every event, so each warp first
  // queues the events that hit (ballot and prefix count) and runs the taps
  // 32 at a time, every lane busy.
  __shared__ float2 queues[32][kQueue];
  const int lane = threadIdx.x & 31;
  float2* queue = queues[threadIdx.x >> 5];
  int queued = 0;  // the same in every lane
  const long long run = (long long)blockDim.x * kUnroll;
  for (long long base = chunk * run + (threadIdx.x & ~31); base < n_events;
       base += run * p.chunks) {  // the same trips in every lane of a warp
    float x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + lane + (long long)u * blockDim.x;
      x[u] = i < n_events ? __ldg(xs + i) : NAN;  // NaN deposits nothing
      y[u] = i < n_events ? __ldg(ys + i) : NAN;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool hit = in_tile<HW>(x[u], y[u], H, W, r0, r1, c0, c1);
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) queue[queued + __popc(m & ((1u << lane) - 1u))] = make_float2(x[u], y[u]);
      queued += __popc(m);
      if (queued >= 32) {
        __syncwarp();
        const float2 e = queue[lane];
        __syncwarp();
        if (lane < queued - 32) queue[lane] = queue[32 + lane];
        __syncwarp();
        queued -= 32;
        deposit<HW>(tile, frame, e.x, e.y, H, W, r0, r1, c0, c1, tc);
      }
    }
  }
  __syncwarp();
  if (lane < queued) {
    const float2 e = queue[lane];
    deposit<HW>(tile, frame, e.x, e.y, H, W, r0, r1, c0, c1, tc);
  }
  __syncthreads();

  if (tc == W) {  // whole rows: the tile is one run of the frame
    add_tile(frame + (long long)r0 * W, tile, (long long)tr * W);
  } else {
    for (int r = 0; r < tr; ++r)
      add_tile(frame + (long long)(r0 + r) * W + c0, tile + r * tc, tc);
  }
}

// the frames from their sums: each rounded to f32 once (2^-24 scales it
// exactly), two texels per thread and trip where the buffers allow
__global__ void __launch_bounds__(256)
    splat_fwd_finish_kernel(const Sum* __restrict__ sums,
                            float* __restrict__ frames, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long pairs = ((size_t)frames % 8 == 0) ? n / 2 : 0;
  for (long long i = tid; i < pairs; i += stride) {
    const ulonglong2 v = reinterpret_cast<const ulonglong2*>(sums)[i];
    reinterpret_cast<float2*>(frames)[i] =
        make_float2(__fmul_rn(__ull2float_rn(v.x), 1.f / kUnit),
                    __fmul_rn(__ull2float_rn(v.y), 1.f / kUnit));
  }
  for (long long i = 2 * pairs + tid; i < n; i += stride)
    frames[i] = __fmul_rn(__ull2float_rn(sums[i]), 1.f / kUnit);
}

// ---- backward ----------------------------------------------------------------

// (dwx, dwy) of one event from its (2 HW + 1)^2 window of the (H, W)
// cotangent frame G: one statement sequence for both kernels, so that they
// give the same bits. With kPairs (W even and G on 8 bytes) a row's 2 HW + 1
// texels come as the HW + 1 aligned pairs that hold them, where the window's
// columns are all on the sensor: 8-byte gathers instead of 4-byte ones, the
// same values.
template <bool kPairs, int HW>
__device__ __forceinline__ void bwd_event(const float* __restrict__ G, float x,
                                          float y, int H, int W, float& dx,
                                          float& dy) {
  constexpr int kTaps = 2 * HW + 1;
  const float rx = rintf(x), ry = rintf(y);
  float ox = 0.f, oy = 0.f;
  if (window_hits(rx, ry, H, W, HW)) {
    const int iy = (int)ry, ix = (int)rx;
    float u[kTaps], du[kTaps], v[kTaps], dv[kTaps], t[kTaps][kTaps];
#pragma unroll
    for (int d = 0; d < kTaps; ++d) {
      const int row = iy + d - HW, col = ix + d - HW;
      const bool rok = row >= 0 && row < H, cok = col >= 0 && col < W;
      const float qy = (ry + (float)(d - HW)) - y;
      const float qx = (rx + (float)(d - HW)) - x;
      const float gy = gauss(qy), gx = gauss(qx);
      u[d] = rok ? gy : 0.f;
      du[d] = rok ? qy * gy : 0.f;
      v[d] = cok ? gx : 0.f;
      dv[d] = cok ? qx * gx : 0.f;
    }
#pragma unroll
    for (int a = 0; a < kTaps; ++a) {
      const int row = iy + a - HW;
      const int left = (ix - HW) & ~1;  // the even column at or before ix - HW
      if (kPairs && ix >= HW && left + kTaps < W) {
#pragma unroll
        for (int b = 0; b < kTaps; ++b) t[a][b] = 0.f;
        if (row >= 0 && row < H) {
          const float2* pair = reinterpret_cast<const float2*>(G + row * W + left);
          float p[kTaps + 1];
#pragma unroll
          for (int k = 0; k <= HW; ++k) {
            const float2 q = __ldg(pair + k);
            p[2 * k] = q.x;
            p[2 * k + 1] = q.y;
          }
          const bool odd = (ix - HW) & 1;
#pragma unroll
          for (int b = 0; b < kTaps; ++b) t[a][b] = odd ? p[b + 1] : p[b];
        }
        continue;
      }
#pragma unroll
      for (int b = 0; b < kTaps; ++b) {
        const int col = ix + b - HW;
        t[a][b] = (row >= 0 && row < H && col >= 0 && col < W)
                      ? __ldg(G + row * W + col)
                      : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kTaps; ++b) {
      float m = u[0] * t[0][b];
#pragma unroll
      for (int a = 1; a < kTaps; ++a) m += u[a] * t[a][b];
      ox += m * dv[b];
    }
#pragma unroll
    for (int a = 0; a < kTaps; ++a) {
      float m = v[0] * t[a][0];
#pragma unroll
      for (int b = 1; b < kTaps; ++b) m += v[b] * t[a][b];
      oy += m * du[a];
    }
  }
  dx = isfinite(ox) ? ox : 0.f;
  dy = isfinite(oy) ? oy : 0.f;
}

// The gather kernel: one thread per (ref, event) in a grid-stride loop over
// all refs' events.
template <int HW>
__global__ void splat_bwd_kernel(const float* __restrict__ wx,
                                 const float* __restrict__ wy,
                                 const float* __restrict__ grad,
                                 float* __restrict__ dwx,
                                 float* __restrict__ dwy, long long n,
                                 long long n_events, int H, int W) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float* G = grad + (i / n_events) * (long long)H * W;
    bwd_event<false, HW>(G, wx[i], wy[i], H, W, dwx[i], dwy[i]);
  }
}

// The stream kernel: blockIdx.y is the ref, and a thread takes four events
// in a row, as one float4 load per coordinate array and one float4 store
// per gradient array where `vec` says they start on 16 bytes, so that the
// gathers of four windows are in flight together.
template <bool kPairs, int HW>
__global__ void __launch_bounds__(512)
    splat_bwd_stream_kernel(const float* __restrict__ wx,
                            const float* __restrict__ wy,
                            const float* __restrict__ grad,
                            float* __restrict__ dwx, float* __restrict__ dwy,
                            long long n_events, int H, int W, int vec) {
  const long long ref = blockIdx.y;
  const float* xs = wx + ref * n_events;
  const float* ys = wy + ref * n_events;
  float* ox = dwx + ref * n_events;
  float* oy = dwy + ref * n_events;
  const float* G = grad + ref * H * W;
  const long long stride = 4LL * gridDim.x * blockDim.x;
  for (long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       e < n_events; e += stride) {
    if (vec && e + 3 < n_events) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(xs + e));
      const float4 y = __ldg(reinterpret_cast<const float4*>(ys + e));
      float4 dx, dy;
      bwd_event<kPairs, HW>(G, x.x, y.x, H, W, dx.x, dy.x);
      bwd_event<kPairs, HW>(G, x.y, y.y, H, W, dx.y, dy.y);
      bwd_event<kPairs, HW>(G, x.z, y.z, H, W, dx.z, dy.z);
      bwd_event<kPairs, HW>(G, x.w, y.w, H, W, dx.w, dy.w);
      *reinterpret_cast<float4*>(ox + e) = dx;
      *reinterpret_cast<float4*>(oy + e) = dy;
    } else {
      for (long long i = e; i < min(e + 4, n_events); ++i)
        bwd_event<kPairs, HW>(G, __ldg(xs + i), __ldg(ys + i), H, W, ox[i], oy[i]);
    }
  }
}

template <int HW>
int splat_fwd(const float* wx, const float* wy, Sum* sums, float* frames,
              long long n_texels, long long n_events, int H, int W,
              const SlabPlan& p, long long blocks, long long smem, int threads,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      splat_fwd_slab_kernel<HW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem - kQueueBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(sums, 0, (size_t)n_texels * sizeof(Sum), stream);
  if (err != cudaSuccess) return (int)err;
  splat_fwd_slab_kernel<HW><<<(int)blocks, threads, (size_t)smem, stream>>>(
      wx, wy, sums, n_events, H, W, p);
  const long long finish = (n_texels / 2 + 255) / 256;
  splat_fwd_finish_kernel<<<(int)(finish < 4096 ? (finish > 0 ? finish : 1) : 4096), 256, 0,
                            stream>>>(sums, frames, n_texels);
  return (int)cudaGetLastError();
}

template <int HW>
int splat_bwd(const float* wx, const float* wy, const float* grad, float* dwx,
              float* dwy, int n_refs, long long n_events, int H, int W,
              int stream_kernel, int blocks, int threads, int vec,
              cudaStream_t stream) {
  // a row's texels in aligned pairs: every row of every ref on 8 bytes
  const bool pairs = W % 2 == 0 && (size_t)grad % 8 == 0;
  if (stream_kernel && pairs)
    splat_bwd_stream_kernel<true, HW><<<dim3(blocks, n_refs), threads, 0, stream>>>(
        wx, wy, grad, dwx, dwy, n_events, H, W, vec);
  else if (stream_kernel)
    splat_bwd_stream_kernel<false, HW><<<dim3(blocks, n_refs), threads, 0, stream>>>(
        wx, wy, grad, dwx, dwy, n_events, H, W, vec);
  else
    splat_bwd_kernel<HW><<<blocks, threads, 0, stream>>>(
        wx, wy, grad, dwx, dwy, (long long)n_refs * n_events, n_events, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// the frames of all refs (written whole), from the slab plan of
// ops/splat_kernel.py: a grid of n_refs x chunks x row_slabs x col_slabs
// blocks of `threads` threads, each with a tile of tile_rows x tile_cols
// texels, adds into `sums` (n_refs x H x W 64-bit words of scratch, zeroed
// here); windows of 2 hw + 1 texels a side (hw 1 or 2)
extern "C" int eincm_splat_fwd(const float* wx, const float* wy, void* sums,
                               float* frames, int n_refs, long long n_events,
                               int H, int W, int hw, int tile_rows,
                               int tile_cols, int row_slabs, int col_slabs,
                               int chunks, int threads, cudaStream_t stream) {
  const long long smem = ((long long)tile_rows * tile_cols + 3) / 4 * 16;
  const long long blocks = (long long)n_refs * chunks * row_slabs * col_slabs;
  if (smem > kMaxSmem - kQueueBytes || blocks < 1 || blocks > 0x7fffffffLL ||
      threads < 32 || threads > 1024 || threads % 32 || (size_t)sums % 16)
    return (int)cudaErrorInvalidValue;
  const SlabPlan p{tile_rows, tile_cols, row_slabs, col_slabs, chunks};
  const long long n = (long long)n_refs * H * W;
  Sum* s = static_cast<Sum*>(sums);
  if (hw == 1)
    return splat_fwd<1>(wx, wy, s, frames, n, n_events, H, W, p, blocks, smem, threads,
                        stream);
  if (hw == 2)
    return splat_fwd<2>(wx, wy, s, frames, n, n_events, H, W, p, blocks, smem, threads,
                        stream);
  return (int)cudaErrorInvalidValue;
}

// the gather kernel: one thread per (ref, event) in a grid-stride loop of
// `blocks` x `threads`; with `stream`, the stream kernel: a grid of `blocks`
// x n_refs blocks, four events per thread (`vec`: as float4s); windows of
// 2 hw + 1 texels a side (hw 1 or 2)
extern "C" int eincm_splat_bwd(const float* wx, const float* wy,
                               const float* grad, float* dwx, float* dwy,
                               int n_refs, long long n_events, int H, int W,
                               int hw, int stream_kernel, int blocks,
                               int threads, int vec, cudaStream_t stream) {
  if (blocks < 1 || threads < 32 || threads % 32 || n_refs > 65535 ||
      threads > (stream_kernel ? 512 : 1024) || (long long)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (hw == 1)
    return splat_bwd<1>(wx, wy, grad, dwx, dwy, n_refs, n_events, H, W,
                        stream_kernel, blocks, threads, vec, stream);
  if (hw == 2)
    return splat_bwd<2>(wx, wy, grad, dwx, dwy, n_refs, n_events, H, W,
                        stream_kernel, blocks, threads, vec, stream);
  return (int)cudaErrorInvalidValue;
}
