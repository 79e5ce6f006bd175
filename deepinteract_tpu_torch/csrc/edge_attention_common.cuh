// Helpers shared by edge_attention_fwd.cu (K1) and edge_attention_bwd.cu (K2).
//
// Layout of the work. A node row of H*D elements is cut into vector lanes of
// VEC consecutive elements (one load or store of at most 16 bytes each);
// VEC is a power of two that divides the head dim D, so a lane's elements
// belong to one head. A head's D / VEC lanes are summed in one of two
// layouts (head_layout), whichever holds the head inside one block:
//   warp heads: the head's lanes, padded to the next power of two P <= 32,
//   sit in one warp, which holds 32 / P whole heads (a "row chunk"); a
//   head's sum is a __shfl_xor tree over its P lanes, the padding lanes
//   adding zeros. A block of kWarps warps owns one (graph, node, chunk)
//   and splits that node's edge list into kWarps contiguous slices, one per
//   warp; the warps' partial sums are combined through shared memory in
//   warp order.
//   block heads (P > 32: D > 32 * VEC): a block of kThreads threads owns one
//   (graph, node, head), each thread ITEMS single elements of the head
//   (thread t: elements t, t + kThreads, ...). The block walks the node's
//   edges a few at a time; a head's sum is each thread's partial sum, a
//   __shfl_xor tree in each warp, then the warps' sums in warp order
//   through shared memory (block_sum).
// Every sum has a fixed order and there are no atomics, so both layouts are
// deterministic from run to run.

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
// lanes (a power of two, padding included). Every lane of the warp must call
// it; every lane of a head gets the same value.
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

// Sums each x[i] over the whole block; every thread gets the same value, in
// a fixed order (lanes by a __shfl_xor tree, then warps 0, 1, ...).
// `red` holds kWarps * N floats of shared memory. Every thread of the block
// must call it.
template <int N>
__device__ __forceinline__ void block_sum(float (&x)[N], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int step = 16; step > 0; step >>= 1) x[i] += __shfl_xor_sync(kFull, x[i], step);
    if (lane == 0) red[warp * N + i] = x[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = red[i];
    for (int w = 1; w < kWarps; ++w) s += red[w * N + i];
    x[i] = s;
  }
  __syncthreads();  // `red` may be written again
}

// Where a lane of the warp-heads layout sits: its head, the offset of its
// first element in the row, whether it holds elements (padding lanes and
// lanes past the last head do not), and whether it is its head's first lane.
struct WarpLane {
  int head;
  int off;
  bool active;
  bool leader;
};

template <int VEC>
__device__ __forceinline__ WarpLane warp_lane(int chunk, int heads, int head_dim,
                                              int head_lanes) {
  const int lane = threadIdx.x & 31;
  const int j = lane % head_lanes;
  WarpLane w;
  w.head = chunk * (32 / head_lanes) + lane / head_lanes;
  w.off = w.head * head_dim + j * VEC;
  w.active = w.head < heads && j * VEC < head_dim;
  w.leader = w.active && j == 0;
  return w;
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
    if (head_dim % vec != 0 || hd / vec < 32) continue;
    bool ok = true;
    const size_t tb = sizeof(T) * vec < 16 ? sizeof(T) * vec : 16;
    const size_t fb = 4 * vec < 16 ? 4 * vec : 16;
    for (const void* p : tp) ok = ok && aligned_to(p, tb);
    for (const void* p : fp) ok = ok && aligned_to(p, fb);
    if (ok) break;
  }
  return vec;
}

// How a kernel that sums over heads lays them out (see the top of this file).
// items == 0: warp heads, VEC = vec, head_lanes = P, grid.x = nodes * chunks.
// items > 0: block heads, ITEMS = items (a power of two, kThreads * items >=
// D), grid.x = nodes * heads.
struct HeadLayout {
  int vec;
  int head_lanes;
  int chunks;
  int items;
};

constexpr int kMaxItems = 16;  // block heads take D <= kThreads * kMaxItems = 4096

template <typename T, size_t NT, size_t NF>
HeadLayout head_layout(int heads, int head_dim, const void* const (&tp)[NT],
                       const void* const (&fp)[NF]) {
  const int vec = pick_vec<T>(heads * head_dim, head_dim, tp, fp);
  int lanes = 1;
  while (lanes < head_dim / vec) lanes <<= 1;
  if (lanes <= 32) {
    const int per_chunk = 32 / lanes;
    return {vec, lanes, (heads + per_chunk - 1) / per_chunk, 0};
  }
  int items = 1;
  while (items * kThreads < head_dim) items <<= 1;
  return {1, 0, heads, items};
}

// Calls f(std::integral_constant<int, ITEMS>) for the runtime `items` (1, 2,
// 4, 8 or 16) and returns its result.
template <typename F>
int dispatch_items(int items, F&& f) {
  switch (items) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 16:
      return f(std::integral_constant<int, 16>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
