// Fused scatter-mode edge-attention forward (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in deepinteract_tpu/ops/pallas_attention.py
// (launched by `_pallas_forward`). For edge e = (i, k) of graph b, with
// dst = nbr[b, e] and lanes (h, d):
//   s      = clip(k[i] * q[dst] / sqrt(D), +-5) * pe[e]
//   w_h    = exp(clip(sum_{d in h} s, +-5)) * mask[e]
//   h[dst] = sum_e w * v[i] / (sum_e w + 1e-6),   z[dst] = sum_e w
//   e_out  = s * mask[e]
// q/k/v/pe are float32 or bfloat16 (read as stored, computed in float32);
// h and z are float32, e_out is in the input dtype.
//
// Bound: bytes. Every element is touched once and there are ~2 flops per
// byte. At B=1, N=256, K=20, H*D=128, float32: pe in 2.62 MB, e_out out
// 2.62 MB, q/k/v in and h/z out 0.66 MB, indices and mask 0.04 MB: ~5.9 MB,
// ~1.8 us at 3.35 TB/s.
//
// Design. The TPU kernel turns the scatter into one-hot [EB, N] matmuls on
// the MXU and accumulates over a sequential edge-block grid in VMEM; both
// exist for the TPU and are not carried over. Here the scatter becomes a
// gather by destination over an in-edge CSR (in_ptr [B, N+1], in_eid
// [B, N*K]: each destination's edge ids in ascending order), built once per
// encode by a stable sort of nbr (ops/cuda_attention.in_edge_csr) and
// shared by every GT layer and by K2. So no block searches for its edges:
// the work is linear in the edges, where a scan of nbr per node was
// O(N^2 K).
//   Heads of up to 32 vector lanes (edge_attention_common.cuh's warp heads;
//   the flagship's D=32 and every D <= 32 * VEC): one block of 8 warps per
//   (graph, destination, row chunk of whole heads). Each warp takes a
//   contiguous slice of the destination's in-edges (about K/8 of them),
//   loads their ids in one coalesced read and broadcasts them with
//   __shfl_sync, and keeps four edges' gathers of k[src], v[src] and pe[e]
//   in flight at once: vector loads of up to 16 bytes per lane, q[dst] in
//   registers. It writes e_out[e] (each edge has exactly one destination, so
//   every e_out element is written exactly once), sums a head over its lanes
//   with __shfl_xor, and accumulates w*v and w in float32 registers. The
//   eight partial sums are combined in warp order through shared memory.
//   Eight slices give a flagship graph (N=256) 2,048 warps, enough for the
//   132 SMs, and a node's latency chain is one round of gathers.
//   Wider heads (block heads, D up to 4096): one block per (graph,
//   destination, head), its threads across the head's elements, walking the
//   in-edges two at a time (one where a thread holds 8 or more elements);
//   each edge's head sum goes through block_sum. This layout exists for
//   head dims the JAX package runs but the flagship does not use.
// Every sum has a fixed order (ascending edge id within a slice, slices in
// order): no atomics, deterministic from run to run. A destination with no
// in-edges ends with h = 0 and z = 0. Every nbr entry must lie in [0, N)
// (padded nodes point at themselves): then every edge is in exactly one
// slice.

#include "edge_attention_common.cuh"

namespace {

using namespace di;

constexpr int kUnroll = 4;  // a warp's in-edges in flight
template <int ITEMS>
constexpr int kUnrollBlock = ITEMS >= 8 ? 1 : 2;  // a block's in-edges in flight

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) edge_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ pe, const int32_t* __restrict__ in_ptr,
    const int32_t* __restrict__ in_eid, const float* __restrict__ mask,
    float* __restrict__ h_out, T* __restrict__ e_out, float* __restrict__ z_out,
    int num_nodes, int knn, int heads, int head_dim, int head_lanes, int chunks,
    float inv_sqrt_d) {
  __shared__ float scratch[kWarps * (VEC + 1) * 32];

  const int chunk = blockIdx.x % chunks;
  const int dst = blockIdx.x / chunks;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int hd = heads * head_dim;
  const WarpLane wl = warp_lane<VEC>(chunk, heads, head_dim, head_lanes);
  const int off = wl.off;  // first element of this lane
  const bool active = wl.active;

  const int64_t node_row0 = (int64_t)b * num_nodes;
  const int64_t edge_row0 = (int64_t)b * num_nodes * knn;
  const int32_t* ptr = in_ptr + (int64_t)b * (num_nodes + 1);
  int s0, s1;
  warp_slice(ptr[dst], ptr[dst + 1], s0, s1);

  float qv[VEC] = {};
  if (active) load_vec(q + (node_row0 + dst) * hd + off, qv);
  float acc[VEC + 1] = {};  // sum of w * v, then sum of w

  for (int base = s0; base < s1; base += 32) {
    const int cnt = min(32, s1 - base);  // warp-uniform
    const int mine = lane < cnt ? in_eid[edge_row0 + base + lane] : 0;
    for (int j = 0; j < cnt; j += kUnroll) {
      int eid[kUnroll];
      float m[kUnroll], kv[kUnroll][VEC], vv[kUnroll][VEC], pv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        eid[u] = __shfl_sync(kFull, mine, (j + u) & 31);
        m[u] = 0.0f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) kv[u][i] = vv[u][i] = pv[u][i] = 0.0f;
        if (j + u < cnt) {
          m[u] = mask[edge_row0 + eid[u]];
          if (active) {
            const int64_t src_off = (node_row0 + eid[u] / knn) * hd + off;
            load_vec(k + src_off, kv[u]);
            load_vec(v + src_off, vv[u]);
            load_vec(pe + (edge_row0 + eid[u]) * hd + off, pv[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u >= cnt) break;  // warp-uniform: the shuffles stay converged
        float s[VEC], out[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s[i] = clip(kv[u][i] * qv[i] * inv_sqrt_d) * pv[u][i];
          out[i] = s[i] * m[u];
        }
        if (active) store_vec(e_out + (edge_row0 + eid[u]) * hd + off, out);
        const float w = expf(clip(head_sum(s, head_lanes))) * m[u];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += w * vv[u][i];
        acc[VEC] += w;
      }
    }
  }

  combine_warps(acc, scratch);
  if ((threadIdx.x >> 5) == 0 && active) {
    float hv[VEC], zv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      hv[i] = acc[i] / (acc[VEC] + kEps);
      zv[i] = acc[VEC];
    }
    store_vec(h_out + (node_row0 + dst) * hd + off, hv);
    store_vec(z_out + (node_row0 + dst) * hd + off, zv);
  }
}

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kThreads) edge_attention_fwd_block_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ pe, const int32_t* __restrict__ in_ptr,
    const int32_t* __restrict__ in_eid, const float* __restrict__ mask,
    float* __restrict__ h_out, T* __restrict__ e_out, float* __restrict__ z_out,
    int num_nodes, int knn, int heads, int head_dim, float inv_sqrt_d) {
  constexpr int U = kUnrollBlock<ITEMS>;
  __shared__ float red[kWarps * U];

  const int head = blockIdx.x % heads;
  const int dst = blockIdx.x / heads;
  const int b = blockIdx.y;
  const int hd = heads * head_dim;
  const int64_t node_row0 = (int64_t)b * num_nodes;
  const int64_t edge_row0 = (int64_t)b * num_nodes * knn;
  const int32_t* ptr = in_ptr + (int64_t)b * (num_nodes + 1);
  const int beg = ptr[dst], end = ptr[dst + 1];
  const int tid = threadIdx.x;
  const int base = head * head_dim + tid;  // element i of this thread: base + i * kThreads

  float qv[ITEMS], acc[ITEMS] = {};
  float zsum = 0.0f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool own = tid + i * kThreads < head_dim;
    qv[i] = own ? to_f32(q[(node_row0 + dst) * hd + base + i * kThreads]) : 0.0f;
  }

  for (int e0 = beg; e0 < end; e0 += U) {
    float m[U], part[U], vv[U][ITEMS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      m[u] = part[u] = 0.0f;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) vv[u][i] = 0.0f;
      if (e0 + u < end) {  // block-uniform
        const int eid = in_eid[edge_row0 + e0 + u];
        m[u] = mask[edge_row0 + eid];
        const int64_t src_off = (node_row0 + eid / knn) * hd + base;
        const int64_t edge_off = (edge_row0 + eid) * hd + base;
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          if (tid + i * kThreads >= head_dim) break;
          const float s = clip(to_f32(k[src_off + i * kThreads]) * qv[i] * inv_sqrt_d) *
                          to_f32(pe[edge_off + i * kThreads]);
          e_out[edge_off + i * kThreads] = from_f32<T>(s * m[u]);
          part[u] += s;
          vv[u][i] = to_f32(v[src_off + i * kThreads]);
        }
      }
    }
    block_sum(part, red);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e0 + u >= end) break;
      const float w = expf(clip(part[u])) * m[u];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) acc[i] += w * vv[u][i];
      zsum += w;
    }
  }

#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (tid + i * kThreads >= head_dim) break;
    const int64_t at = (node_row0 + dst) * hd + base + i * kThreads;
    h_out[at] = acc[i] / (zsum + kEps);
    z_out[at] = zsum;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pe, const void* in_ptr,
           const void* in_eid, const void* mask, void* h, void* e_out, void* z, int batch,
           int num_nodes, int knn, int heads, int head_dim, cudaStream_t stream) {
  const void* const tp[] = {q, k, v, pe, e_out};
  const void* const fp[] = {h, z};
  const HeadLayout lay = head_layout<T>(heads, head_dim, tp, fp);
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)head_dim));
  const dim3 grid(num_nodes * lay.chunks, batch);
  const auto qp = static_cast<const T*>(q), kp = static_cast<const T*>(k),
             vp = static_cast<const T*>(v), pep = static_cast<const T*>(pe);
  const auto ptr = static_cast<const int32_t*>(in_ptr), eid = static_cast<const int32_t*>(in_eid);
  const auto mp = static_cast<const float*>(mask);
  const auto hp = static_cast<float*>(h), zp = static_cast<float*>(z);
  const auto ep = static_cast<T*>(e_out);
  if (lay.items > 0) {
    return dispatch_items(lay.items, [&](auto ic) {
      constexpr int ITEMS = decltype(ic)::value;
      edge_attention_fwd_block_kernel<T, ITEMS><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, pep, ptr, eid, mp, hp, ep, zp, num_nodes, knn, heads, head_dim,
          inv_sqrt_d);
      return static_cast<int>(cudaGetLastError());
    });
  }
  return dispatch_vec<T>(lay.vec, [&](auto vc) {
    constexpr int VEC = decltype(vc)::value;
    edge_attention_fwd_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, pep, ptr, eid, mp, hp, ep, zp, num_nodes, knn, heads, head_dim,
        lay.head_lanes, lay.chunks, inv_sqrt_d);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Plain C entry point (loaded with ctypes). Layouts, all contiguous:
// q/k/v [B, N, H*D], pe and e_out [B, N*K, H*D] (float32 if is_bf16 == 0,
// else bfloat16), in_ptr [B, N+1] and in_eid [B, N*K] int32 (the in-edge
// CSR), mask [B, N*K] float32, h and z [B, N, H*D] float32. Requires
// head_dim <= 4096 (the wrapper checks H*D <= 4096).
// Returns cudaGetLastError() after the launch.
extern "C" int di_edge_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* pe, const void* in_ptr, const void* in_eid,
                                     const void* mask, void* h, void* e_out, void* z,
                                     int batch, int num_nodes, int knn, int heads,
                                     int head_dim, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, pe, in_ptr, in_eid, mask, h, e_out, z, batch,
                                 num_nodes, knn, heads, head_dim, s);
  }
  return launch<float>(q, k, v, pe, in_ptr, in_eid, mask, h, e_out, z, batch, num_nodes,
                       knn, heads, head_dim, s);
}

extern "C" const char* di_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
