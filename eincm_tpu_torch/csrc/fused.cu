// Fused warp + splat forward for ONE reference time: the IWE frame of the
// events warped to t_ref, without the warped coordinates ever reaching
// device memory.
//
// Replaces two TPU kernels of eincm_tpu/experimental/splat_fused.py:
//   - _fused_fwd_kernel (reached through fused_warp_splat_frame): the
//     per-event velocities (thx, thy) are inputs (kernel 7);
//   - _fully_fused_fwd_kernel (reached through fully_fused_warp_splat_frame):
//     each thread first samples the (h, w, 2) coarse theta at its event,
//     with kernel 1's own taps and operation order (common.cuh: taps_of_at,
//     sample2), at the coordinate as given (not rounded again, as the TPU
//     kernel) (kernel 8).
//
// Per event: cx = xi - thx * (ts - t_ref), cy = yi - thy * (ts - t_ref),
// each product and difference rounded on its own (__fmul_rn, __fsub_rn), so
// the result is bitwise the port's displacement (ops/warp.py, two torch
// ops). Then the (2 hw + 1)^2 taps g(i - cy) g(j - cx) around (rint(cx),
// rint(cy)) go into the zeroed (H, W) frame, with splat.cu's drop
// semantics: NaN, +-inf and far coordinates fail a float range test before
// any int conversion; off-sensor texels are skipped on every side. xi and
// yi are used as given: the callers pass rounded coordinates.
//
// The TPU kernels banded the rows of sorted events into a sliding VMEM
// accumulator, because the TPU has no fast scatter; Hopper scatters with
// atomics, so there are no bands of sorted events, no sort and no validity
// flag to compute.
//
// What bounds them on an H100, and the designs (PERF.md has the times and
// the runs). The scatter kernel (fused_kernel: one thread per event,
// grid-stride) adds every tap with a global float atomicAdd, which runs at
// 65-85G a second in L2: nothing at 30k events (270k taps), 0.16-0.21 ms at
// 1.5M. Both kernels 7 and 8 take it where events are few, and the cluster
// kernel (fused_cluster_kernel) where they are many; each has its own
// crossover (experimental/splat_fused.py:plan_fused chooses by the event
// count alone). The two kernels are templates on where (vx, vy) comes from
// (kInterp): kernel 7 loads it, kernel 8 samples theta; everything after
// the velocity is one body.
//   - A thread block cluster of S blocks holds the whole (H, W) frame in
//     its distributed shared memory as 32-bit fixed-point texels (tile.cuh:
//     units of 2^-24, native integer atomics), block r the rows [r
//     tile_rows, (r + 1) tile_rows). The events are cut into S sections,
//     one per block, and a section into runs of which cluster c takes runs
//     c, c + chunks, ... Each event is read, given its velocity (kernel 7:
//     two loads; kernel 8: theta staged in shared memory, no division whose
//     quotient is known) and warped once.
//   - Adding each tap straight into the owner's tile with a remote atomic
//     (atom.shared::cluster) was built first and measured: a remote atomic
//     costs what a global one does (0.23 ms at 1.5M unsorted events, the
//     scatter kernel's time), and only events sorted by row, whose taps
//     land in their own block's tile, gained (0.060 ms). So an event
//     travels instead of its taps. A run is a round: a block adds the taps
//     that fall on its own rows at once, and sends the warped coordinate (8
//     bytes, one st.shared::cluster) to each other block that owns rows of
//     the window, into the queue it has there; the slot comes from a
//     counter in the sender's own shared memory, one atomic per warp and
//     destination (__match_any_sync), so nothing remote returns a value.
//     After a cluster barrier each block reads how many events each sibling
//     sent it and adds their taps on its own rows with local atomics; a
//     second barrier, and the counters are reset. A window on the edge of
//     two slabs goes to both owners, each adding its own rows.
//   - A queue holds 1.5 to 2 times a sibling's even share of a round; an
//     event that finds it full is added into the sibling's tile by remote
//     atomics, which is slow and right. The plan takes the fewest rounds
//     whose queues fit beside the tile, the same number of events in each.
//   - The atomic returns the texel's old value, from which the thread sees
//     a counter wrap and carries 256.0 into the frame in device memory (at
//     most once per ~1600 taps of a texel); all of an event's atomics are
//     issued before the first result is looked at. At the end each block
//     adds its tile into the zeroed frame once, as float4 reductions that
//     skip zeros. A frame too large for one cluster is cut into bands of
//     rows, and a cluster of each band walks every event of its chunk.
// What is left at 1.5M events: the shared-memory atomics (kernel 8
// 0.065-0.076 ms, kernel 7 0.056-0.065, with row-sorted events, which send
// nothing), and the sends (0.09-0.10 and 0.08-0.09 ms with unsorted ones);
// per cluster the tile's zeroing and write-back and two barriers a round,
// which is why few events stay on the scatter kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "tile.cuh"

namespace {

namespace cg = cooperative_groups;

using eincm::add_cluster;
using eincm::gauss;
using eincm::kCarry;
using eincm::kMaxSmem;
using eincm::load_cluster;
using eincm::map_rank;
using eincm::quantize;
using eincm::sample2;
using eincm::shared_address;
using eincm::Slabs;
using eincm::store_cluster;
using eincm::taps_of_at;
using eincm::window_hits;
using eincm::write_back;

constexpr int kMaxCluster = 8;  // the portable limit of blocks in a cluster
constexpr unsigned kFull = 0xffffffffu;

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

// The scatter kernel: one thread per event, grid-stride, every tap a global
// atomicAdd. kInterp false (kernel 7 where events are few): velocities from
// (thx, thy); true (kernel 8 where events are few): sampled from theta.
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
      sample2<false>(theta, taps_of_at(y, h, sy), taps_of_at(x, w, sx), h, w,
                     vx, vy);
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

// The taps of one warped event on the rows [c0, c1) of the frame, added into
// the tiles of a cluster that holds the frame's rows from row0 on
// (slabs.row_address counts from row0): each tap is one integer atomic on
// the shared memory of the block that owns its row, rounded to 2^-24. All
// of an event's atomics are issued before the first old value is looked
// at; a counter that wrapped carries 256.0 into the frame in device memory.
template <int HW>
__device__ __forceinline__ void cluster_taps(const Slabs& slabs,
                                             float* __restrict__ frame,
                                             float cx, float cy, int H, int W,
                                             int row0, int c0, int c1) {
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
  unsigned wrapped = 0u;  // bit a * kTaps + b: that tap's counter wrapped
#pragma unroll
  for (int a = 0; a < kTaps; ++a) {
    const int row = iy + a - HW;
    if (row < c0 || row >= c1) continue;
    const unsigned line = slabs.row_address(row - row0);
#pragma unroll
    for (int b = 0; b < kTaps; ++b) {
      const int col = ix + b - HW;
      if (col < 0 || col >= W) continue;
      const unsigned q = quantize(gy[a] * gx[b]);
      const unsigned old = add_cluster(line + 4u * (unsigned)col, q);
      wrapped |= (old + q < old ? 1u : 0u) << (a * kTaps + b);
    }
  }
  while (wrapped) {  // at most once per ~1600 taps of a texel
    const int tap = __ffs(wrapped) - 1;
    wrapped &= wrapped - 1u;
    atomicAdd(frame + (long long)(iy + tap / kTaps - HW) * W +
                  (ix + tap % kTaps - HW),
              kCarry);
  }
}

struct FusedPlan {
  int cluster;     // blocks of a cluster: together they hold a band's rows
  int tile_rows;   // rows of the frame in each block's tile
  int bands;       // bands of cluster x tile_rows rows that cover the frame
  int chunks;      // clusters per band: chunks of the events
  int staged;      // theta read from a copy in shared memory (kernel 8)
  int per_thread;  // events each thread warps in a round
  int queue;       // entries of each (sender, owner) queue
};

// Kernels 7 (kInterp false: velocities loaded from thx, thy) and 8 (kInterp
// true: sampled from theta, staged in shared memory with kStaged); see the
// head of the file. Nothing but the velocity differs.
template <int HW, bool kInterp, bool kStaged>
__global__ void __launch_bounds__(1024)
    fused_cluster_kernel(const float* __restrict__ xi,
                         const float* __restrict__ yi,
                         const float* __restrict__ ts,
                         const float* __restrict__ thx,
                         const float* __restrict__ thy,
                         const float* __restrict__ theta,
                         float* __restrict__ frame, long long n_events,
                         float t_ref, int H, int W, int h, int w, float sy,
                         float sx, FusedPlan p, unsigned magic) {
  static_assert(kInterp || !kStaged, "kernel 7 stages no theta");
  // the tile, the inbox (a queue per sender), then kernel 8's staged theta
  extern __shared__ __align__(16) unsigned tile[];
  __shared__ unsigned sent[kMaxCluster];  // events queued for each sibling
  __shared__ unsigned received[kMaxCluster];  // events in this block's inbox, by sender
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int cid = blockIdx.x / p.cluster;
  const int band = cid % p.bands, chunk = cid / p.bands;
  const int row0 = min(band * p.cluster * p.tile_rows, H);
  const int row1 = min(row0 + p.cluster * p.tile_rows, H);
  const int r0 = min(row0 + rank * p.tile_rows, row1);
  const int r1 = min(r0 + p.tile_rows, row1);
  const int texels = (r1 - r0) * W;
  const int tile_words = (p.tile_rows * W + 3) / 4 * 4;
  float2* inbox = reinterpret_cast<float2*>(tile + tile_words);
  for (int i = threadIdx.x; i < (texels + 3) / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);
  const float* th = theta;
  if (kStaged) {
    float* staged = reinterpret_cast<float*>(inbox + p.cluster * p.queue);
    for (int i = threadIdx.x; i < h * w * 2; i += blockDim.x)
      staged[i] = __ldg(theta + i);
    th = staged;
  }
  if (threadIdx.x < kMaxCluster) sent[threadIdx.x] = 0u;
  // every tile of the cluster is zeroed before a sibling adds into it
  cluster.sync();

  const Slabs slabs{shared_address(tile), p.tile_rows, W, magic};
  const unsigned my_queue =
      shared_address(inbox) + 8u * (unsigned)(rank * p.queue);
  const long long section = (n_events + p.cluster - 1) / p.cluster;
  const long long s0 = min(rank * section, n_events);
  const long long s1 = min(s0 + section, n_events);
  const long long run = (long long)blockDim.x * p.per_thread;
  // the same rounds in every block of the cluster
  for (long long base = chunk * run; base < section; base += run * p.chunks) {
    // warp this round's events; add the taps on this block's own rows, and
    // send the warped event to every other block that owns rows of its
    // window
    for (int u = 0; u < p.per_thread; ++u) {
      const long long e = s0 + base + (long long)u * blockDim.x + threadIdx.x;
      float cx = 0.f, cy = 0.f;
      int o_lo = 0, o_hi = -1;  // the owners of the window's rows
      if (e < s1) {
        const float x = __ldg(xi + e), y = __ldg(yi + e);
        float vx, vy;
        if constexpr (kInterp) {
          sample2<kStaged>(th, taps_of_at(y, h, sy), taps_of_at(x, w, sx), h, w,
                           vx, vy);
        } else {
          vx = __ldg(thx + e);
          vy = __ldg(thy + e);
        }
        const float dt = __fsub_rn(__ldg(ts + e), t_ref);
        cx = __fsub_rn(x, __fmul_rn(vx, dt));
        cy = __fsub_rn(y, __fmul_rn(vy, dt));
        const float rx = rintf(cx), ry = rintf(cy);
        if (window_hits(rx, ry, H, W, HW)) {
          const int lo = max((int)ry - HW, row0), hi = min((int)ry + HW, row1 - 1);
          if (lo <= hi) {
            o_lo = (int)slabs.owner(lo - row0);
            o_hi = (int)slabs.owner(hi - row0);
          }
        }
      }
      for (int k = 0; __any_sync(kFull, o_lo + k <= o_hi); ++k) {
        const int o = o_lo + k;
        const bool active = o <= o_hi;
        if (active && o == rank)
          cluster_taps<HW>(slabs, frame, cx, cy, H, W, row0, r0, r1);
        // the lanes of the warp that send to one sibling take a run of
        // slots in the queue this block has there
        const bool remote = active && o != rank;
        const unsigned peers = __match_any_sync(kFull, remote ? o : -1);
        const int leader = __ffs(peers) - 1;
        unsigned slot = 0u;
        if (remote && lane == leader) slot = atomicAdd(&sent[o], __popc(peers));
        slot = __shfl_sync(kFull, slot, leader) +
               __popc(peers & ((1u << lane) - 1u));
        if (remote) {
          if (slot < (unsigned)p.queue) {
            store_cluster(map_rank(my_queue + 8u * slot, (unsigned)o), cx, cy);
          } else {  // the queue is full: straight into the sibling's tile
            const int q0 = row0 + o * p.tile_rows;
            cluster_taps<HW>(slabs, frame, cx, cy, H, W, row0, q0,
                             min(q0 + p.tile_rows, row1));
          }
        }
      }
    }
    // every sibling's events are in this block's inbox
    cluster.sync();
    if (threadIdx.x < p.cluster)
      received[threadIdx.x] =
          (int)threadIdx.x == rank
              ? 0u
              : min(load_cluster(map_rank(shared_address(&sent[rank]), threadIdx.x)),
                    (unsigned)p.queue);
    __syncthreads();
    unsigned total = 0u;
    for (int s = 0; s < p.cluster; ++s) total += received[s];
    for (unsigned i = threadIdx.x; i < total; i += blockDim.x) {
      int s = 0;
      unsigned j = i;
      while (j >= received[s]) j -= received[s++];
      const float2 c = inbox[s * p.queue + (int)j];
      cluster_taps<HW>(slabs, frame, c.x, c.y, H, W, row0, r0, r1);
    }
    // the inbox is read, and every sibling has read this block's counts
    cluster.sync();
    if (threadIdx.x < kMaxCluster) sent[threadIdx.x] = 0u;
    __syncthreads();
  }
  // after a round's second barrier no block touches a sibling's memory
  if (texels > 0) write_back(frame + (long long)r0 * W, tile, texels);
}

using ClusterKernel = void (*)(const float*, const float*, const float*,
                               const float*, const float*, const float*,
                               float*, long long, float, int, int, int, int,
                               float, float, FusedPlan, unsigned);

// window sizes 3 and 5, the only ones called; kernel 7 stages nothing
ClusterKernel cluster_kernel(int hw, bool interp, int staged) {
  if (hw == 1) {
    if (!interp) return staged ? nullptr : fused_cluster_kernel<1, false, false>;
    return staged ? fused_cluster_kernel<1, true, true> : fused_cluster_kernel<1, true, false>;
  }
  if (hw == 2) {
    if (!interp) return staged ? nullptr : fused_cluster_kernel<2, false, false>;
    return staged ? fused_cluster_kernel<2, true, true> : fused_cluster_kernel<2, true, false>;
  }
  return nullptr;
}

// the kernel and its shared memory for a plan that fits, else nullptr
ClusterKernel fitted(int H, int W, int hw, bool interp, int h, int w,
                     const FusedPlan& p, int threads, long long* smem) {
  const long long tile = ((long long)p.tile_rows * W + 3) / 4 * 16;
  *smem = tile + 8LL * p.cluster * p.queue + (p.staged ? (long long)h * w * 8 : 0);
  const bool ok =
      p.cluster >= 1 && p.cluster <= kMaxCluster && p.tile_rows >= 1 &&
      p.tile_rows < 65536 && H < 65536 && p.bands >= 1 && p.chunks >= 1 &&
      (long long)p.bands * p.cluster * p.tile_rows >= H && p.per_thread >= 1 &&
      p.queue >= 0 && *smem <= kMaxSmem - 128 && threads >= 32 &&
      threads <= 1024 && threads % 32 == 0;
  if (!ok) return nullptr;
  ClusterKernel kernel = cluster_kernel(hw, interp, p.staged);
  if (kernel != nullptr &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)*smem) != cudaSuccess)
    return nullptr;
  return kernel;
}

// the scatter kernel for window sizes 3 and 5, the only ones called
template <bool kInterp>
int scatter(const float* xi, const float* yi, const float* ts, const float* thx,
            const float* thy, const float* theta, float* frame,
            long long n_events, float t_ref, int H, int W, int hw, int h, int w,
            float sy, float sx, int blocks, int threads, cudaStream_t stream) {
  if (blocks < 1 || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (hw == 1)
    fused_kernel<1, kInterp><<<blocks, threads, 0, stream>>>(
        xi, yi, ts, thx, thy, theta, frame, n_events, t_ref, H, W, h, w, sy, sx);
  else if (hw == 2)
    fused_kernel<2, kInterp><<<blocks, threads, 0, stream>>>(
        xi, yi, ts, thx, thy, theta, frame, n_events, t_ref, H, W, h, w, sy, sx);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Either kernel of either source, from a plan of experimental/splat_fused.py:
// plan_fused: with `cluster` 0 the scatter kernel in `chunks` blocks of
// `threads`; else a grid of chunks x bands clusters of `cluster` blocks.
// theta == nullptr: kernel 7, the velocities from (thx, thy).
int launch(const float* xi, const float* yi, const float* ts, const float* thx,
           const float* thy, const float* theta, float* frame,
           long long n_events, float t_ref, int H, int W, int hw, int h, int w,
           float sy, float sx, int cluster, int tile_rows, int bands,
           int chunks, int threads, int staged, int per_thread, int queue,
           cudaStream_t stream) {
  const bool interp = theta != nullptr;
  if (cluster == 0)
    return interp ? scatter<true>(xi, yi, ts, thx, thy, theta, frame, n_events,
                                  t_ref, H, W, hw, h, w, sy, sx, chunks, threads,
                                  stream)
                  : scatter<false>(xi, yi, ts, thx, thy, theta, frame, n_events,
                                   t_ref, H, W, hw, h, w, sy, sx, chunks, threads,
                                   stream);
  const FusedPlan p{cluster, tile_rows, bands, chunks, staged, per_thread, queue};
  long long smem;
  ClusterKernel kernel = fitted(H, W, hw, interp, h, w, p, threads, &smem);
  const long long blocks = (long long)chunks * bands * cluster;
  if (kernel == nullptr || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  eincm::ClusterLaunch config(blocks, threads, (size_t)smem, cluster, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &config.config, kernel, xi, yi, ts, thx, thy, theta, frame, n_events, t_ref,
      H, W, h, w, sy, sx, p, eincm::div_magic(tile_rows));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// kernel 7: (xi, yi, ts, thx, thy) (E,) -> frame (H, W), zeroed by the
// caller, from a plan of experimental/splat_fused.py:plan_fused (no theta,
// nothing staged): the cluster kernel, or with `cluster` 0 the scatter
// kernel in `chunks` blocks
extern "C" int eincm_fused_warp_splat(
    const float* xi, const float* yi, const float* ts, const float* thx,
    const float* thy, float* frame, long long n_events, float t_ref, int H,
    int W, int hw, int cluster, int tile_rows, int bands, int chunks,
    int threads, int per_thread, int queue, cudaStream_t stream) {
  return launch(xi, yi, ts, thx, thy, nullptr, frame, n_events, t_ref, H, W, hw,
                0, 0, 0.f, 0.f, cluster, tile_rows, bands, chunks, threads, 0,
                per_thread, queue, stream);
}

// kernel 8: (xi, yi, ts) (E,), theta (h, w, 2) -> frame (H, W), zeroed by
// the caller, from the plan of experimental/splat_fused.py:plan_fused: a
// grid of chunks x bands clusters of `cluster` blocks of `threads` threads,
// or, with `cluster` 0, the scatter kernel in `chunks` blocks
extern "C" int eincm_fully_fused_warp_splat(
    const float* xi, const float* yi, const float* ts, const float* theta,
    float* frame, long long n_events, float t_ref, int H, int W, int hw, int h,
    int w, float sy, float sx, int cluster, int tile_rows, int bands,
    int chunks, int threads, int staged, int per_thread, int queue,
    cudaStream_t stream) {
  if (theta == nullptr) return (int)cudaErrorInvalidValue;
  return launch(xi, yi, ts, nullptr, nullptr, theta, frame, n_events, t_ref, H,
                W, hw, h, w, sy, sx, cluster, tile_rows, bands, chunks, threads,
                staged, per_thread, queue, stream);
}

// the clusters of that launch (kernel 8 with `interp`, else kernel 7) that
// the card runs at once, or -cudaError_t
extern "C" int eincm_fused_active_clusters(int H, int W, int hw, int interp,
                                           int h, int w, int cluster,
                                           int tile_rows, int threads,
                                           int staged, int queue) {
  const int bands = (H + cluster * tile_rows - 1) / (cluster * tile_rows);
  const FusedPlan p{cluster, tile_rows, bands, 1, staged, 1, queue};
  long long smem;
  ClusterKernel kernel = fitted(H, W, hw, interp != 0, h, w, p, threads, &smem);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  eincm::ClusterLaunch config(cluster, threads, (size_t)smem, cluster, nullptr);
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &config.config);
  return err != cudaSuccess ? -(int)err : clusters;
}
