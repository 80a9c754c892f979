// Image of warped events (IWE) and its coordinate gradient, all reference
// times in one launch each.
//
// Replaces four TPU kernels, which compute two functions:
//   - eincm_tpu/ops/splat_pallas.py: _splat_kernel (events_to_pdf_frame_pallas)
//     and _bwd_kernel (_bwd_pallas), the full-height splat;
//   - eincm_tpu/ops/splat_banded.py: _fwd_kernel (_banded_fwd_call) and
//     _bwd_kernel (_banded_bwd_call), the row/column-banded splat.
//
// Forward: frames[r, i, j] += g(i - y) g(j - x) for the 3x3 texels with
// |i - round(y)| <= 1 and |j - round(x)| <= 1 inside the sensor, where
// g(q) = exp(-q^2 / 2) / sqrt(2 pi). An event whose coordinate is not
// finite, or whose rounded window misses the sensor, adds nothing; the range
// is tested in float before any conversion to int.
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
// from L2), adds the taps that fall in its slab, and adds the tile into the
// zeroed frame once, as float4 reductions (atomicAdd on float4) that skip
// zeros. No sort, no global atomic per tap. Three findings on the card
// (PERF.md) shaped it:
//   - a float atomicAdd on shared memory is a compare-and-swap loop, so a
//     texel is a 32-bit fixed-point sum in units of 2^-24 kept with native
//     integer atomics: each tap is rounded to 2^-24 (<= 3e-8), the sums in a
//     tile are exact, and a counter that wraps carries 256.0 into the frame
//     with one global atomic (at most one per ~1600 taps of a texel);
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
//           dwy = sum_i (sum_j v_j G[i, j]) u'_i, with v' = q g(q);
// one thread per (ref, event) gathers its 9 texels of G. No atomics, so the
// backward is deterministic; non-finite results become 0. It reads 8 bytes
// per event plus 9 texels from L2 and writes 8 bytes: a memory-bound gather.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using eincm::gauss;
using eincm::window_hits;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
// events each thread loads at once: more spill at the 64 registers of
// a 1024-thread block and run slower (PERF.md)
constexpr int kUnroll = 2;
// one block's shared memory on sm_90 (its opt-in limit), of which each warp
// of a block of up to 1024 threads keeps a queue of kQueue events
constexpr int kMaxSmem = 232448;
constexpr int kQueue = 64;
constexpr int kQueueBytes = 32 * kQueue * 8;
// a tile texel is a 32-bit fixed-point sum in units of 2^-24; a counter
// that wraps carries 2^32 units = 256.0 into the frame in device memory
constexpr float kUnit = 16777216.f;  // 2^24
constexpr float kCarry = 256.f;
// x + 1.5 * 2^23 holds rint(x) (half to even) in its low mantissa bits for
// |x| < 2^22; x + 2^23 holds rint(x) for 0 <= x < 2^23
constexpr float kRound = 12582912.f;
constexpr unsigned kRoundBits = 0x4B400000u;
constexpr float kUint = 8388608.f;
constexpr unsigned kUintBits = 0x4B000000u;

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
// range test that NaN, +-inf and far coordinates fail (so |x| < 2^22)
__device__ __forceinline__ bool center(float x, float y, int H, int W,
                                       Center& c) {
  if (!(x > -4.f && x < (float)W + 4.f && y > -4.f && y < (float)H + 4.f))
    return false;
  const float sx = __fadd_rn(x, kRound), sy = __fadd_rn(y, kRound);
  c.rx = __fsub_rn(sx, kRound);
  c.ry = __fsub_rn(sy, kRound);
  c.ix = (int)(__float_as_uint(sx) - kRoundBits);
  c.iy = (int)(__float_as_uint(sy) - kRoundBits);
  return window_hits(c.rx, c.ry, H, W, 1);
}

// true when a tap of the event falls in the tile [r0, r1) x [c0, c1)
__device__ __forceinline__ bool in_tile(float x, float y, int H, int W, int r0,
                                        int r1, int c0, int c1) {
  Center c;
  return center(x, y, H, W, c) && c.iy + 1 >= r0 && c.iy - 1 < r1 &&
         c.ix + 1 >= c0 && c.ix - 1 < c1;
}

// the taps of one event that fall in the tile, added into it with integer
// shared-memory atomics (a float atomicAdd on shared memory is a
// compare-and-swap loop), each g(i - y) g(j - x) rounded to 2^-24
__device__ __forceinline__ void deposit(unsigned* tile, float* frame, float x,
                                        float y, int H, int W, int r0, int r1,
                                        int c0, int c1, int tc) {
  Center c;
  if (!center(x, y, H, W, c)) return;
  float gy[3], gx[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    gy[d] = gauss((c.ry + (float)(d - 1)) - y);
    gx[d] = gauss((c.rx + (float)(d - 1)) - x);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int row = c.iy + a - 1;
    if (row < r0 || row >= r1) continue;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int col = c.ix + b - 1;
      if (col < c0 || col >= c1) continue;
      const unsigned q =
          __float_as_uint(__fadd_rn((gy[a] * gx[b]) * kUnit, kUint)) - kUintBits;
      const unsigned old = atomicAdd(tile + (row - r0) * tc + (col - c0), q);
      if (old + q < old)  // at most once per ~1600 taps of a texel
        atomicAdd(frame + (long long)row * W + col, kCarry);
    }
  }
}

__device__ __forceinline__ float texel(unsigned v) {
  return __uint2float_rn(v) * (1.f / kUnit);
}

// n texels of the tile (shared, from src) added into dst (global): head
// and tail one by one, the aligned body as float4 reductions (read as uint4
// where src is aligned with dst); zeros skipped
__device__ __forceinline__ void write_back(float* __restrict__ dst,
                                           const unsigned* src, long long n) {
  const int head = (int)((4 - ((size_t)dst / 4) % 4) % 4);
  const long long lead = head < n ? head : n;
  const long long n4 = (n - lead) / 4;
  for (long long i = threadIdx.x; i < lead; i += blockDim.x)
    if (src[i]) atomicAdd(dst + i, texel(src[i]));
  float4* body = reinterpret_cast<float4*>(dst + lead);
  const bool aligned = ((size_t)(src + lead) % 16) == 0;
  for (long long v = threadIdx.x; v < n4; v += blockDim.x) {
    uint4 t;
    if (aligned) {
      t = reinterpret_cast<const uint4*>(src + lead)[v];
    } else {
      const unsigned* s = src + lead + 4 * v;
      t = make_uint4(s[0], s[1], s[2], s[3]);
    }
    if (t.x | t.y | t.z | t.w)
      atomicAdd(body + v, make_float4(texel(t.x), texel(t.y), texel(t.z), texel(t.w)));
  }
  for (long long i = lead + 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    if (src[i]) atomicAdd(dst + i, texel(src[i]));
}

__global__ void __launch_bounds__(1024)
    splat_fwd_slab_kernel(const float* __restrict__ wx,
                          const float* __restrict__ wy,
                          float* __restrict__ frames, long long n_events,
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
  float* frame = frames + (long long)ref * H * W;
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
      const bool hit = in_tile(x[u], y[u], H, W, r0, r1, c0, c1);
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
        deposit(tile, frame, e.x, e.y, H, W, r0, r1, c0, c1, tc);
      }
    }
  }
  __syncwarp();
  if (lane < queued) {
    const float2 e = queue[lane];
    deposit(tile, frame, e.x, e.y, H, W, r0, r1, c0, c1, tc);
  }
  __syncthreads();

  if (tc == W) {  // whole rows: the tile is one run of the frame
    write_back(frame + (long long)r0 * W, tile, (long long)tr * W);
  } else {
    for (int r = 0; r < tr; ++r)
      write_back(frame + (long long)(r0 + r) * W + c0, tile + r * tc, tc);
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
    if (window_hits(rx, ry, H, W, 1)) {
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

// the frames of all refs, added into the zeroed `frames`, from the slab
// plan of ops/splat_kernel.py: a grid of n_refs x chunks x row_slabs x
// col_slabs blocks of `threads` threads, each with a tile of tile_rows x
// tile_cols texels
extern "C" int eincm_splat_fwd(const float* wx, const float* wy,
                               float* frames, int n_refs, long long n_events,
                               int H, int W, int tile_rows, int tile_cols,
                               int row_slabs, int col_slabs, int chunks,
                               int threads, cudaStream_t stream) {
  const long long smem = ((long long)tile_rows * tile_cols + 3) / 4 * 16;
  const long long blocks = (long long)n_refs * chunks * row_slabs * col_slabs;
  if (smem > kMaxSmem - kQueueBytes || blocks < 1 || blocks > 0x7fffffffLL ||
      threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      splat_fwd_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem - kQueueBytes);
  if (err != cudaSuccess) return (int)err;
  const SlabPlan p{tile_rows, tile_cols, row_slabs, col_slabs, chunks};
  splat_fwd_slab_kernel<<<(int)blocks, threads, (size_t)smem, stream>>>(
      wx, wy, frames, n_events, H, W, p);
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
