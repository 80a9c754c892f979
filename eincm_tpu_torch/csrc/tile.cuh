// Shared-memory tiles of the IWE, for splat.cu and fused.cu:
//   - the 32-bit fixed-point texel (units of 2^-24, native integer atomics;
//     a float atomicAdd on shared memory is a compare-and-swap loop) and the
//     tile's write-back into the frame in device memory;
//   - a thread block cluster's distributed shared memory: the blocks of a
//     cluster cut one frame into slabs of whole rows, block r holds rows
//     [r tile_rows, (r + 1) tile_rows), and any block reaches any row, or a
//     sibling's queue, through its owner's shared memory (mapa, then ld /
//     st / atom .shared::cluster).

#pragma once

#include <cuda_runtime.h>

namespace eincm {

// one block's shared memory on sm_90 (its opt-in limit)
constexpr int kMaxSmem = 232448;
// a tile texel is a 32-bit fixed-point sum in units of 2^-24; a counter
// that wraps carries 2^32 units = 256.0 into the frame in device memory
constexpr float kUnit = 16777216.f;  // 2^24
constexpr float kCarry = 256.f;
// x + 2^23 holds rint(x) in its low mantissa bits for 0 <= x < 2^23
constexpr float kUint = 8388608.f;
constexpr unsigned kUintBits = 0x4B000000u;

// v in units of 2^-24, rounded to nearest, for 0 <= v < 0.5
__device__ __forceinline__ unsigned quantize(float v) {
  return __float_as_uint(__fadd_rn(v * kUnit, kUint)) - kUintBits;
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

// ---- a cluster's slabs -------------------------------------------------------

// ceil(2^32 / d) for 2 <= d < 2^16: __umulhi(n, magic) == n / d for n < 2^16
inline unsigned div_magic(int d) {
  return (unsigned)((0x100000000ULL + (unsigned)d - 1) / (unsigned)d);
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the shared::cluster address, in block `rank` of the cluster, of what lies
// at the shared::cta address `local` in this block (every block of a kernel
// lays its shared memory out the same way)
__device__ __forceinline__ unsigned map_rank(unsigned local, unsigned rank) {
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// The rows of one frame over the blocks of a cluster: block r of the
// cluster holds rows [r tile_rows, (r + 1) tile_rows) of `width` texels of 4
// bytes at `base`, its own shared-memory address, the same in every block.
struct Slabs {
  unsigned base;  // shared::cta address of this block's slab
  int tile_rows, width;
  unsigned magic;  // div_magic(tile_rows); unused when tile_rows == 1

  // the block that owns row `row` (0 <= row < rows held by the cluster)
  __device__ __forceinline__ unsigned owner(int row) const {
    return tile_rows == 1 ? (unsigned)row : __umulhi((unsigned)row, magic);
  }

  // the shared::cluster address of that row, in the block that owns it
  __device__ __forceinline__ unsigned row_address(int row) const {
    const unsigned o = owner(row);
    return map_rank(
        base + ((unsigned)row - o * (unsigned)tile_rows) * (unsigned)width * 4u, o);
  }
};

// the texel's value before the add
__device__ __forceinline__ unsigned add_cluster(unsigned address, unsigned q) {
  unsigned old;
  asm volatile("atom.shared::cluster.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "r"(address), "r"(q)
               : "memory");
  return old;
}

__device__ __forceinline__ void store_cluster(unsigned address, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(address), "f"(a),
               "f"(b)
               : "memory");
}

__device__ __forceinline__ unsigned load_cluster(unsigned address) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(address) : "memory");
  return v;
}

// the launch configuration of a kernel in clusters of `cluster` blocks, for
// cudaLaunchKernelEx and cudaOccupancyMaxActiveClusters
struct ClusterLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  ClusterLaunch(long long blocks, int threads, size_t smem, int cluster,
                cudaStream_t stream) {
    config = cudaLaunchConfig_t{};
    config.gridDim = dim3((unsigned)blocks);
    config.blockDim = dim3((unsigned)threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    attribute.id = cudaLaunchAttributeClusterDimension;
    attribute.val.clusterDim.x = (unsigned)cluster;
    attribute.val.clusterDim.y = 1;
    attribute.val.clusterDim.z = 1;
    config.attrs = &attribute;
    config.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;  // config points into this
};

}  // namespace eincm
