// Helpers shared by edge_attention_fwd.cu (K1) and edge_attention_bwd.cu (K2).
//
// Layout of the work. A node row of H*D elements is cut into vector lanes of
// VEC consecutive elements (one load or store of at most 16 bytes each);
// a warp holds 32 such lanes, one row chunk. VEC divides the head dim D (a
// power of two <= 32), so a head's D / VEC lanes sit in one warp and its sums
// are __shfl_xor trees over them. A block of kWarps warps owns one (graph,
// node, chunk) and splits that node's edge list into kWarps contiguous
// slices, one per warp; the warps' partial sums are combined through shared
// memory in warp order, so every sum has a fixed order and no atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace di {

constexpr float kClip = 5.0f;
constexpr float kEps = 1e-6f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float clip(float x) { return fminf(fmaxf(x, -kClip), kClip); }
__device__ __forceinline__ bool inside_clip(float x) { return x > -kClip && x < kClip; }

template <int Bytes>
struct Raw;
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

// Accesses of VEC elements are split into pieces of at most 16 bytes.
template <typename T, int VEC>
constexpr int kPiece = (sizeof(T) * VEC <= 16) ? VEC : 16 / (int)sizeof(T);

// VEC consecutive elements at p, as float32.
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  constexpr int P = kPiece<T, VEC>;
  using R = typename Raw<(int)sizeof(T) * P>::type;
#pragma unroll
  for (int c = 0; c < VEC; c += P) {
    const R raw = *reinterpret_cast<const R*>(p + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < P; ++i) out[c + i] = to_f32(e[i]);
  }
}

// x rounded to T once and written as VEC consecutive elements at p.
template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&x)[VEC]) {
  constexpr int P = kPiece<T, VEC>;
  using R = typename Raw<(int)sizeof(T) * P>::type;
#pragma unroll
  for (int c = 0; c < VEC; c += P) {
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < P; ++i) e[i] = from_f32<T>(x[c + i]);
    *reinterpret_cast<R*>(p + c) = raw;
  }
}

// Sum over a head: this lane's VEC elements, then the head's `head_lanes`
// lanes (a power of two). Every lane of the warp must call it.
template <int VEC>
__device__ __forceinline__ float head_sum(const float (&x)[VEC], int head_lanes) {
  float s = x[0];
#pragma unroll
  for (int i = 1; i < VEC; ++i) s += x[i];
  for (int step = head_lanes >> 1; step > 0; step >>= 1) s += __shfl_xor_sync(kFull, s, step);
  return s;
}

// This warp's contiguous slice [s0, s1) of the items [beg, end).
__device__ __forceinline__ void warp_slice(int beg, int end, int& s0, int& s1) {
  const int warp = threadIdx.x >> 5;
  const int count = end - beg;
  const int per = (count + kWarps - 1) / kWarps;
  s0 = beg + min(count, warp * per);
  s1 = beg + min(count, warp * per + per);
}

// Sums every warp's `acc` in warp order (0, 1, ..., kWarps - 1) into warp
// 0's `acc`; `scratch` holds kWarps * N * 32 floats of shared memory. Every
// thread of the block must call it.
template <int N>
__device__ __forceinline__ void combine_warps(float (&acc)[N], float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) scratch[(warp * N + i) * 32 + lane] = acc[i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = scratch[i * 32 + lane];
      for (int w = 1; w < kWarps; ++w) s += scratch[(w * N + i) * 32 + lane];
      acc[i] = s;
    }
  }
}

inline bool aligned_to(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Elements per vector lane: the widest VEC (at most 16 bytes of T) that
// divides the head dim, still leaves a row of >= 32 lanes where the row is
// that wide, and suits the alignment of every pointer (T arrays in `tp`,
// float32 arrays in `fp`; null pointers pass).
template <typename T, size_t NT, size_t NF>
int pick_vec(int hd, int head_dim, const void* const (&tp)[NT], const void* const (&fp)[NF]) {
  int vec = 16 / (int)sizeof(T);
  for (; vec > 1; vec >>= 1) {
    if (vec > head_dim || hd / vec < 32) continue;
    bool ok = true;
    const size_t tb = sizeof(T) * vec < 16 ? sizeof(T) * vec : 16;
    const size_t fb = 4 * vec < 16 ? 4 * vec : 16;
    for (const void* p : tp) ok = ok && aligned_to(p, tb);
    for (const void* p : fp) ok = ok && aligned_to(p, fb);
    if (ok) break;
  }
  return vec;
}

// Calls f(std::integral_constant<int, VEC>) for the runtime `vec` (1, 2, 4,
// or 8 where T is 2 bytes wide) and returns its result.
template <typename T, typename F>
int dispatch_vec(int vec, F&& f) {
  switch (vec) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    default:
      if constexpr (sizeof(T) == 2) {
        return f(std::integral_constant<int, 8>{});
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
  }
}

}  // namespace di
