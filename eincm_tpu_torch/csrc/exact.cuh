// Exact, order-free sums of rounded terms, for the gradients that many
// threads add into one grid: kernel 2 above 16x16 (interp.cu) and kernel 2
// in float64 (direct.cu).
//
// One launch's terms share one unit, 2^-s, taken from the largest finite
// |g| of the whole cotangent (a max does not depend on the order it is
// taken in): |g| 2^s lies in [2^(B-1), 2^B), B = 30 for float and 62 for
// double, and every term (a product of g and two weights in [0, 1]) is
// rounded once to an integer q with |q| <= 2^B. Integer sums are exact
// whatever their order, so the result is bitwise the same from run to run,
// for every launch plan and every order of the events. Each sum is rounded
// to T once, by exact_finish_kernel.
//
//   float:  q fits an int; a word of the grid in device memory is one
//           64-bit two's complement sum (the true sum fits: |q| <= 2^30 and
//           fewer than 2^33 terms);
//   double: q fits a long long; a word is a 128-bit two's complement sum,
//           kept as two 64-bit halves (lo in sums[0, m), hi in sums[m, 2m))
//           with the carry out of lo added into hi.
//
// A block may first add its terms into a band of the grid in shared memory,
// each word two halves of T's integer width (lo, hi) with native integer
// atomics: all eight low-half atomics of an event are issued before any of
// their results is read, and the high half moves only on a carry or for a
// negative term. The band's nonzero words are then added into device memory
// with one (float) or two (double) 64-bit integer atomics each. A term that
// is not finite sets a flag byte of its word in device memory (1 +inf,
// 2 -inf, 4 NaN), which decides the word as the float sum would.
//
// Scratch (one buffer, `ExactLayout`): the sums, the flags, one partial max
// per block of exact_prep_kernel (which also zeroes the sums and flags, so
// no memset is needed), and the shift s that the accumulating kernel
// writes for the finish.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace eincm {
namespace exact {

constexpr int kPrepBlocks = 264;  // the most partial maxima (two per SM)
constexpr int kPrepThreads = 512;
constexpr unsigned kFullMask = 0xffffffffu;

template <class T>
struct Fixed;

template <>
struct Fixed<float> {
  using Half = unsigned;  // one half of a shared-memory word
  using Q = int;
  static constexpr int kBits = 30;
  static constexpr int kMaxShift = 126;
  static constexpr int kGlobalHalves = 1;  // 64-bit words per grid word
  __device__ static float max_finite() { return FLT_MAX; }
  // the shift s of the unit 2^-s for the largest finite |g| `gmax`
  __device__ static int shift(float gmax) {
    const int expo = (int)(__float_as_uint(gmax) >> 23) - 127;
    return min(kBits - 1 - expo, kMaxShift);
  }
  __device__ static float pow2(int s) {  // 2^s, -126 <= s <= 127
    return __uint_as_float((unsigned)(127 + s) << 23);
  }
  __device__ static Q quantize(float term, float scale) {
    return __float2int_rn(__fmul_rn(term, scale));
  }
};

template <>
struct Fixed<double> {
  using Half = unsigned long long;
  using Q = long long;
  static constexpr int kBits = 62;
  static constexpr int kMaxShift = 1022;
  static constexpr int kGlobalHalves = 2;
  __device__ static double max_finite() { return DBL_MAX; }
  __device__ static int shift(double gmax) {
    const int expo =
        (int)((unsigned long long)__double_as_longlong(gmax) >> 52) - 1023;
    return min(kBits - 1 - expo, kMaxShift);
  }
  __device__ static double pow2(int s) {  // 2^s, -1022 <= s <= 1023
    return __longlong_as_double((long long)(1023 + s) << 52);
  }
  __device__ static Q quantize(double term, double scale) {
    return __double2ll_rn(__dmul_rn(term, scale));
  }
};

// Where each part of the scratch lies, for m words of the grid.
struct ExactLayout {
  size_t flags, maxima, shift, bytes;
  __host__ __device__ ExactLayout(long long m, int halves, int t_bytes) {
    const size_t sums = (size_t)8 * halves * m;
    flags = (sums + 15) / 16 * 16;
    maxima = flags + ((size_t)4 * ((m + 3) / 4) + 15) / 16 * 16;
    shift = maxima + ((size_t)t_bytes * kPrepBlocks + 15) / 16 * 16;
    bytes = shift + 16;
  }
};

template <class T>
struct Exact {
  unsigned long long* sums;  // m (float) or 2 m (double: lo, then hi) words
  unsigned* flags;           // a byte per word
  T* maxima;                 // exact_prep_kernel's partial maxima
  int n_maxima;
  int* shift;                // s, written by one block of the accumulation
  long long m;

  __host__ Exact(void* scratch, long long words, int n_max)
      : n_maxima(n_max), m(words) {
    const ExactLayout l(words, Fixed<T>::kGlobalHalves, sizeof(T));
    char* base = static_cast<char*>(scratch);
    sums = reinterpret_cast<unsigned long long*>(base);
    flags = reinterpret_cast<unsigned*>(base + l.flags);
    maxima = reinterpret_cast<T*>(base + l.maxima);
    shift = reinterpret_cast<int*>(base + l.shift);
  }
};

// the prep kernel's block count for n values of g
inline int prep_blocks(long long n) {
  const long long b = (n + 4LL * kPrepThreads - 1) / (4LL * kPrepThreads);
  return (int)(b < 1 ? 1 : (b > kPrepBlocks ? kPrepBlocks : b));
}

template <class T>
__device__ __forceinline__ T block_max(T v) {
  __shared__ T warp_max[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmax(v, __shfl_xor_sync(kFullMask, v, off));
  __syncthreads();  // warp_max may still be read by a previous call
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = warp_max[lane < (int)(blockDim.x >> 5) ? lane : 0];
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmax(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// Zero the sums and flags; maxima[b] = the largest finite |g| of block b's
// share of the n values of g.
template <class T>
__global__ void __launch_bounds__(kPrepThreads)
    exact_prep_kernel(const T* __restrict__ g, long long n, Exact<T> a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_sums = Fixed<T>::kGlobalHalves * a.m;
  for (long long i = tid; i < n_sums; i += stride) a.sums[i] = 0ull;
  for (long long i = tid; i < (a.m + 3) / 4; i += stride) a.flags[i] = 0u;
  T m = T(0);
  for (long long i = tid; i < n; i += stride) {
    const T v = fabs(__ldg(g + i));
    if (v <= Fixed<T>::max_finite()) m = fmax(m, v);
  }
  m = block_max(m);
  if (threadIdx.x == 0) a.maxima[blockIdx.x] = m;
}

// The launch's shift s, the same in every block (called by every thread);
// one block records it for the finish.
template <class T>
__device__ __forceinline__ int launch_shift(const Exact<T>& a) {
  T m = T(0);
  for (int i = threadIdx.x; i < a.n_maxima; i += blockDim.x) m = fmax(m, __ldcg(static_cast<const T*>(a.maxima) + i));
  const int s = Fixed<T>::shift(block_max(m));
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *a.shift = s;
  return s;
}

__device__ __forceinline__ void set_flag(unsigned* flags, long long word, bool nan,
                                         bool pos) {
  const unsigned bits = nan ? 4u : (pos ? 1u : 2u);
  atomicOr(flags + (word >> 2), bits << ((word & 3) * 8));
}

// A band of the grid in shared memory: words [w0, w1), halves lo and hi.
template <class T>
struct Band {
  typename Fixed<T>::Half* lo;
  typename Fixed<T>::Half* hi;
  long long w0, w1;
};

// The eight terms of one event (word < 0: no term) into the band: the low
// halves' atomics first, then the carries.
template <class T>
__device__ __forceinline__ void band_terms(const Band<T>& b, unsigned* flags,
                                           const long long word[8],
                                           const T term[8], T scale) {
  using F = Fixed<T>;
  using H = typename F::Half;
  typename F::Q q[8];
  H old[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    q[k] = 0;
    if (word[k] >= b.w0 && word[k] < b.w1) {
      if (fabs(term[k]) <= F::max_finite()) {
        q[k] = F::quantize(term[k], scale);
        if (q[k]) old[k] = atomicAdd(b.lo + (word[k] - b.w0), (H)q[k]);
      } else {
        set_flag(flags, word[k], isnan(term[k]), term[k] > T(0));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (q[k]) {
      const H u = (H)q[k];
      const H up = (q[k] < 0 ? ~(H)0 : (H)0) + (old[k] + u < old[k] ? (H)1 : (H)0);
      if (up) atomicAdd(b.hi + (word[k] - b.w0), up);
    }
  }
}

// The eight terms of one event straight into the sums in device memory.
template <class T>
__device__ __forceinline__ void global_terms(const Exact<T>& a,
                                             const long long word[8],
                                             const T term[8], T scale) {
  using F = Fixed<T>;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (word[k] < 0) continue;
    if (!(fabs(term[k]) <= F::max_finite())) {
      set_flag(a.flags, word[k], isnan(term[k]), term[k] > T(0));
      continue;
    }
    const long long q = (long long)F::quantize(term[k], scale);
    if (!q) continue;
    const unsigned long long u = (unsigned long long)q;
    const unsigned long long old = atomicAdd(a.sums + word[k], u);
    if (F::kGlobalHalves == 2) {
      const unsigned long long up =
          (q < 0 ? ~0ull : 0ull) + (old + u < old ? 1ull : 0ull);
      if (up) atomicAdd(a.sums + a.m + word[k], up);
    }
  }
}

// Zero a band's halves (called by every thread; a __syncthreads must follow).
template <class T>
__device__ __forceinline__ void zero_band(const Band<T>& b) {
  const long long n = b.w1 - b.w0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) b.lo[i] = 0, b.hi[i] = 0;
}

// The band's nonzero words added into the sums in device memory (after a
// __syncthreads).
template <class T>
__device__ __forceinline__ void flush_band(const Band<T>& b, const Exact<T>& a) {
  const long long n = b.w1 - b.w0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    if (Fixed<T>::kGlobalHalves == 1) {
      const unsigned long long s =
          ((unsigned long long)b.hi[i] << 32) | (unsigned long long)b.lo[i];
      if (s) atomicAdd(a.sums + b.w0 + i, s);
    } else {
      const unsigned long long lo = b.lo[i], hi = b.hi[i];
      if (lo | hi) {
        const unsigned long long old = atomicAdd(a.sums + b.w0 + i, lo);
        const unsigned long long up = hi + (old + lo < old ? 1ull : 0ull);
        if (up) atomicAdd(a.sums + a.m + b.w0 + i, up);
      }
    }
  }
}

// (hi, lo), an unsigned 128-bit integer, times 2^e, rounded to nearest
// even once: its top 64 bits with a sticky bit for the rest, then the
// exact scaling.
__device__ __forceinline__ double u128_to_double(unsigned long long hi,
                                                 unsigned long long lo, int e) {
  if (!hi) return ldexp(__ull2double_rn(lo), e);
  const int lz = __clzll((long long)hi);
  const unsigned long long top = lz ? (hi << lz) | (lo >> (64 - lz)) : hi;
  const unsigned long long rest = lz ? lo << lz : lo;
  return ldexp(__ull2double_rn(top | (rest ? 1ull : 0ull)), 64 - lz + e);
}

// A signed 128-bit (hi, lo) times 2^e, rounded once.
__device__ __forceinline__ double i128_to_double(unsigned long long hi,
                                                 unsigned long long lo, int e) {
  if ((long long)hi >= 0) return u128_to_double(hi, lo, e);
  const unsigned long long nlo = ~lo + 1ull;
  const unsigned long long nhi = ~hi + (nlo == 0ull ? 1ull : 0ull);
  return -u128_to_double(nhi, nlo, e);
}

__device__ __forceinline__ float sum_to(const Exact<float>& a, long long i, int s) {
  return __fmul_rn(__ll2float_rn((long long)a.sums[i]), Fixed<float>::pow2(-s));
}

__device__ __forceinline__ double sum_to(const Exact<double>& a, long long i, int s) {
  return i128_to_double(a.sums[a.m + i], a.sums[i], -s);
}

// out[i] = sum i in units of 2^-s, rounded to T once; the flags decide the
// words that got a term that is not finite.
template <class T>
__global__ void __launch_bounds__(256)
    exact_finish_kernel(Exact<T> a, T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int s = *a.shift;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.m;
       i += stride) {
    T v = sum_to(a, i, s);
    const unsigned f = (a.flags[i >> 2] >> ((i & 3) * 8)) & 7u;
    if (f) v = (f & 4u) || (f & 3u) == 3u ? T(NAN) : (f & 1u ? T(INFINITY) : T(-INFINITY));
    out[i] = v;
  }
}

// The finish's launch over m words.
inline int finish_blocks(long long m) {
  const long long b = (m + 255) / 256;
  return (int)(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

}  // namespace exact
}  // namespace eincm
