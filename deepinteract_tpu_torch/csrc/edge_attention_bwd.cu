// Fused scatter-mode edge-attention backward (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in
// deepinteract_tpu/ops/pallas_attention.py (launched by `_pallas_backward`).
// It is the gradient of edge_attention_fwd.cu's (h, e_out) with respect to
// (q, k, v, pe), from the forward's residuals h and z. For edge e = (i, k)
// of graph b, with dst = nbr[b, e], src = i and lanes (h, d), it recomputes
//   a = k[src] * q[dst] / sqrt(D),  c = clip(a, +-5),  s = c * pe[e]
//   sum_pre_h = sum_{d in h} s,     w_h = exp(clip(sum_pre_h, +-5)) * mask[e]
// and forms
//   dnum = dh[dst] / (z[dst] + 1e-6),  dZ_h = -sum_{d in h} h[dst] * dnum
//   dw_h = sum_{d in h} dnum * v[src] + dZ_h
//   dsum_h = dw_h * w_h * 1{|sum_pre_h| < 5},  ds = dsum_h + de[e] * mask[e]
//   dpe[e] = ds * c,  da = ds * pe[e] * 1{|a| < 5} / sqrt(D)
//   dq[dst] += da * k[src],  dk[src] += da * q[dst],  dv[src] += w * dnum
// The clip masks are strict, as in the TPU kernel. q/k/v/pe/de are float32
// or bfloat16 (read as stored, computed in float32); h, z and dh are
// float32; dq/dk/dv/dpe are written in the input dtype. de may be null
// (a zero edge cotangent): then it is not read at all.
//
// Bound: bytes. Every element is touched once and there are ~3 flops per
// byte. At B=1, N=256, K=20, H*D=128, float32: pe and de in 5.24 MB, dpe
// out 2.62 MB, q/k/v/h/z/dh in and dq/dk/dv out 1.18 MB, indices and mask
// 0.04 MB: 9.08 MB, ~2.7 us at 3.35 TB/s.
//
// Design. The TPU kernel forms every scatter as a transposed one-hot
// matmul and accumulates dq/dk/dv in output blocks revisited by a
// sequential edge-block grid; neither carries over. Here the work splits
// by who owns the sum, so no block writes another block's output and no
// atomics are needed. Pass A sums over heads and uses
// edge_attention_common.cuh's head layouts: for heads of up to 32 vector
// lanes (warp heads), one block of 8 warps per (graph, node, row chunk of
// whole heads), the node's edges split into 8 contiguous slices, four
// edges' loads in flight per warp (two at 8 elements per lane, where each
// edge holds six rows), slices combined in warp order; for wider heads
// (block heads, D up to 4096), one block per (graph, node, head) walking
// the edges two at a time (one at 8 or more elements a thread), each
// edge's three head sums through block_sum. Pass B sums over no head, so
// it cuts the row into plain 32-lane chunks of VEC-element lanes, whatever
// the head dim.
//   Pass A, per source node i. Its K out-edges are contiguous rows of pe,
//   de, nbr and mask. Each warp walks its slots, gathers q, h, z and dh at
//   dst, recomputes a, c, s, sum_pre and w, writes dpe[e], adds da * q[dst]
//   and w * dnum into dk[i] and dv[i], and writes the per-(edge, head)
//   scalar dsum [B, N*K, H] float32 (80 KB at the shape above). dk[i] and
//   dv[i] are written once, after the combine.
//   Pass B, per destination, over the in-edge CSR that K1 walks (built
//   once per encode). For each in-edge it reloads k[src], pe[e], de[e] and
//   dsum[e, h], recomputes a (the same float32 product as pass A, so the
//   same clip mask) and da, and sums da * k[src] into dq[dst]. So no
//   H*D-wide per-edge dq share goes through memory: pass B re-reads pe and
//   de (L2-resident after pass A) instead of writing and re-reading a
//   float32 scratch of the same size.
// Sum orders are fixed by slot, edge id and warp: the kernel is
// deterministic from run to run. A destination without in-edges has z = 0
// and a finite 1/(z + eps) = 1e6, but no edge reads its dnum, so it
// contributes nothing, and its dq is 0; masked (padded) edges have w = 0
// and ds = 0, so dpe = 0.

#include "edge_attention_common.cuh"

namespace {

using namespace di;

template <int VEC>
constexpr int kUnrollSrc = VEC >= 8 ? 2 : 4;
constexpr int kUnrollDst = 4;
template <int ITEMS>
constexpr int kUnrollBlock = ITEMS >= 8 ? 1 : 2;

template <typename T, int VEC, bool kHasDe>
__global__ void __launch_bounds__(kThreads) edge_attention_bwd_src_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ pe, const int32_t* __restrict__ nbr,
    const float* __restrict__ mask, const float* __restrict__ h,
    const float* __restrict__ z, const float* __restrict__ dh,
    const T* __restrict__ de, T* __restrict__ dk, T* __restrict__ dv,
    T* __restrict__ dpe, float* __restrict__ dsum, int num_nodes, int knn, int heads,
    int head_dim, int head_lanes, int chunks, float inv_sqrt_d) {
  constexpr int U = kUnrollSrc<VEC>;
  __shared__ float scratch[kWarps * 2 * VEC * 32];

  const int chunk = blockIdx.x % chunks;
  const int src = blockIdx.x / chunks;
  const int b = blockIdx.y;
  const int hd = heads * head_dim;
  const WarpLane wl = warp_lane<VEC>(chunk, heads, head_dim, head_lanes);
  const int off = wl.off;
  const bool active = wl.active;
  const bool head_leader = wl.leader;
  const int head = wl.head;

  const int64_t node_row0 = (int64_t)b * num_nodes;
  const int64_t edge_row0 = (int64_t)b * num_nodes * knn + (int64_t)src * knn;
  const int64_t src_off = (node_row0 + src) * hd + off;

  float kv[VEC] = {}, vv[VEC] = {};
  if (active) {
    load_vec(k + src_off, kv);
    load_vec(v + src_off, vv);
  }
  float acc[2 * VEC] = {};  // dk, then dv

  int s0, s1;
  warp_slice(0, knn, s0, s1);
  for (int slot = s0; slot < s1; slot += U) {
    float m[U], zd[U], qd[U][VEC], hdst[U][VEC], dhd[U][VEC], pv[U][VEC], dev[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      m[u] = 0.0f;
      zd[u] = 0.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) qd[u][i] = hdst[u][i] = dhd[u][i] = pv[u][i] = dev[u][i] = 0.0f;
      if (slot + u < s1) {
        const int64_t edge = edge_row0 + slot + u;
        m[u] = mask[edge];
        if (active) {
          const int64_t dst_off = (node_row0 + nbr[edge]) * hd + off;
          load_vec(q + dst_off, qd[u]);
          load_vec(h + dst_off, hdst[u]);
          load_vec(dh + dst_off, dhd[u]);
          zd[u] = z[dst_off];
          load_vec(pe + edge * hd + off, pv[u]);
          if (kHasDe) load_vec(de + edge * hd + off, dev[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (slot + u >= s1) break;  // warp-uniform: the shuffles stay converged
      const int64_t edge = edge_row0 + slot + u;
      const float rz = 1.0f / (zd[u] + kEps);
      float a[VEC], c[VEC], sp[VEC], dnum[VEC], hdn[VEC], dnv[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a[i] = kv[i] * qd[u][i] * inv_sqrt_d;
        c[i] = clip(a[i]);
        sp[i] = c[i] * pv[u][i];
        dnum[i] = dhd[u][i] * rz;
        hdn[i] = hdst[u][i] * dnum[i];
        dnv[i] = dnum[i] * vv[i];
      }
      const float sum_pre = head_sum(sp, head_lanes);
      const float w = expf(clip(sum_pre)) * m[u];
      const float dz = -head_sum(hdn, head_lanes);
      const float dw = head_sum(dnv, head_lanes) + dz;
      const float ds_head = inside_clip(sum_pre) ? dw * w : 0.0f;
      float dpe_v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float ds = ds_head;
        if (kHasDe) ds += dev[u][i] * m[u];
        dpe_v[i] = ds * c[i];
        const float da = inside_clip(a[i]) ? ds * pv[u][i] * inv_sqrt_d : 0.0f;
        acc[i] += da * qd[u][i];
        acc[VEC + i] += w * dnum[i];
      }
      if (active) store_vec(dpe + edge * hd + off, dpe_v);
      if (head_leader) dsum[edge * heads + head] = ds_head;
    }
  }

  combine_warps(acc, scratch);
  if ((threadIdx.x >> 5) == 0 && active) {
    float dkv[VEC], dvv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dkv[i] = acc[i];
      dvv[i] = acc[VEC + i];
    }
    store_vec(dk + src_off, dkv);
    store_vec(dv + src_off, dvv);
  }
}

template <typename T, int ITEMS, bool kHasDe>
__global__ void __launch_bounds__(kThreads) edge_attention_bwd_src_block_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ pe, const int32_t* __restrict__ nbr,
    const float* __restrict__ mask, const float* __restrict__ h,
    const float* __restrict__ z, const float* __restrict__ dh,
    const T* __restrict__ de, T* __restrict__ dk, T* __restrict__ dv,
    T* __restrict__ dpe, float* __restrict__ dsum, int num_nodes, int knn, int heads,
    int head_dim, float inv_sqrt_d) {
  constexpr int U = kUnrollBlock<ITEMS>;
  __shared__ float red[kWarps * 3 * U];

  const int head = blockIdx.x % heads;
  const int src = blockIdx.x / heads;
  const int b = blockIdx.y;
  const int hd = heads * head_dim;
  const int tid = threadIdx.x;
  const int base = head * head_dim + tid;  // element i of this thread: base + i * kThreads
  const int64_t node_row0 = (int64_t)b * num_nodes;
  const int64_t edge_row0 = (int64_t)b * num_nodes * knn + (int64_t)src * knn;
  const int64_t src_off = (node_row0 + src) * hd + base;

  float kv[ITEMS], vv[ITEMS], dkv[ITEMS] = {}, dvv[ITEMS] = {};
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool own = tid + i * kThreads < head_dim;
    kv[i] = own ? to_f32(k[src_off + i * kThreads]) : 0.0f;
    vv[i] = own ? to_f32(v[src_off + i * kThreads]) : 0.0f;
  }

  for (int slot = 0; slot < knn; slot += U) {
    // Per edge u: the head sums of s, h * dnum and dnum * v (sums[3u..3u+2]).
    float m[U], sums[3 * U], qd[U][ITEMS], pv[U][ITEMS], dnum[U][ITEMS], dev[U][ITEMS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      m[u] = sums[3 * u] = sums[3 * u + 1] = sums[3 * u + 2] = 0.0f;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) qd[u][i] = pv[u][i] = dnum[u][i] = dev[u][i] = 0.0f;
      if (slot + u < knn) {  // block-uniform
        const int64_t edge = edge_row0 + slot + u;
        m[u] = mask[edge];
        const int64_t dst_off = (node_row0 + nbr[edge]) * hd + base;
        const float rz = 1.0f / (z[dst_off - tid] + kEps);
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          if (tid + i * kThreads >= head_dim) break;
          qd[u][i] = to_f32(q[dst_off + i * kThreads]);
          pv[u][i] = to_f32(pe[edge * hd + base + i * kThreads]);
          if (kHasDe) dev[u][i] = to_f32(de[edge * hd + base + i * kThreads]);
          dnum[u][i] = dh[dst_off + i * kThreads] * rz;
          sums[3 * u] += clip(kv[i] * qd[u][i] * inv_sqrt_d) * pv[u][i];
          sums[3 * u + 1] += h[dst_off + i * kThreads] * dnum[u][i];
          sums[3 * u + 2] += dnum[u][i] * vv[i];
        }
      }
    }
    block_sum(sums, red);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (slot + u >= knn) break;
      const int64_t edge = edge_row0 + slot + u;
      const float sum_pre = sums[3 * u];
      const float w = expf(clip(sum_pre)) * m[u];
      const float dw = sums[3 * u + 2] - sums[3 * u + 1];
      const float ds_head = inside_clip(sum_pre) ? dw * w : 0.0f;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (tid + i * kThreads >= head_dim) break;
        const float a = kv[i] * qd[u][i] * inv_sqrt_d;
        float ds = ds_head;
        if (kHasDe) ds += dev[u][i] * m[u];
        dpe[edge * hd + base + i * kThreads] = from_f32<T>(ds * clip(a));
        const float da = inside_clip(a) ? ds * pv[u][i] * inv_sqrt_d : 0.0f;
        dkv[i] += da * qd[u][i];
        dvv[i] += w * dnum[u][i];
      }
      if (threadIdx.x == 0) dsum[edge * heads + head] = ds_head;
    }
  }

#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (tid + i * kThreads >= head_dim) break;
    dk[src_off + i * kThreads] = from_f32<T>(dkv[i]);
    dv[src_off + i * kThreads] = from_f32<T>(dvv[i]);
  }
}

template <typename T, int VEC, bool kHasDe>
__global__ void __launch_bounds__(kThreads) edge_attention_bwd_dst_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ pe,
    const int32_t* __restrict__ in_ptr, const int32_t* __restrict__ in_eid,
    const float* __restrict__ mask, const float* __restrict__ dsum,
    const T* __restrict__ de, T* __restrict__ dq, int num_nodes, int knn, int heads,
    int head_dim, int chunks, float inv_sqrt_d) {
  __shared__ float scratch[kWarps * VEC * 32];

  const int chunk = blockIdx.x % chunks;
  const int dst = blockIdx.x / chunks;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int hd = heads * head_dim;
  const int off = (chunk * 32 + lane) * VEC;  // a plain row chunk: VEC divides head_dim
  const bool active = off < hd;
  const int head = off / head_dim;

  const int64_t node_row0 = (int64_t)b * num_nodes;
  const int64_t edge_row0 = (int64_t)b * num_nodes * knn;
  const int32_t* ptr = in_ptr + (int64_t)b * (num_nodes + 1);
  int s0, s1;
  warp_slice(ptr[dst], ptr[dst + 1], s0, s1);

  float qv[VEC] = {};
  if (active) load_vec(q + (node_row0 + dst) * hd + off, qv);
  float acc[VEC] = {};

  for (int base = s0; base < s1; base += 32) {
    const int cnt = min(32, s1 - base);  // warp-uniform
    const int mine = lane < cnt ? in_eid[edge_row0 + base + lane] : 0;
    for (int j = 0; j < cnt; j += kUnrollDst) {
      float m[kUnrollDst], dsh[kUnrollDst], kv[kUnrollDst][VEC], pv[kUnrollDst][VEC],
          dev[kUnrollDst][VEC];
#pragma unroll
      for (int u = 0; u < kUnrollDst; ++u) {
        const int eid = __shfl_sync(kFull, mine, (j + u) & 31);
        m[u] = dsh[u] = 0.0f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) kv[u][i] = pv[u][i] = dev[u][i] = 0.0f;
        if (j + u < cnt && active) {
          const int64_t edge = edge_row0 + eid;
          m[u] = mask[edge];
          dsh[u] = dsum[edge * heads + head];
          load_vec(k + (node_row0 + eid / knn) * hd + off, kv[u]);
          load_vec(pe + edge * hd + off, pv[u]);
          if (kHasDe) load_vec(de + edge * hd + off, dev[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnrollDst; ++u) {
        if (j + u >= cnt) break;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          // The same float32 product as pass A's a, so the same clip mask.
          const float a = kv[u][i] * qv[i] * inv_sqrt_d;
          float ds = dsh[u];
          if (kHasDe) ds += dev[u][i] * m[u];
          const float da = inside_clip(a) ? ds * pv[u][i] * inv_sqrt_d : 0.0f;
          acc[i] += da * kv[u][i];
        }
      }
    }
  }

  combine_warps(acc, scratch);
  if ((threadIdx.x >> 5) == 0 && active) store_vec(dq + (node_row0 + dst) * hd + off, acc);
}

template <typename T, bool kHasDe>
int launch_passes(const void* q, const void* k, const void* v, const void* pe,
                  const void* nbr, const void* mask, const void* in_ptr, const void* in_eid,
                  const void* h, const void* z, const void* dh, const void* de, void* dq,
                  void* dk, void* dv, void* dpe, void* dsum, int batch, int num_nodes, int knn,
                  int heads, int head_dim, cudaStream_t stream) {
  const int hd = heads * head_dim;
  const void* const tp[] = {q, k, v, pe, de, dq, dk, dv, dpe};
  const void* const fp[] = {h, z, dh};
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)head_dim));
  const auto qp = static_cast<const T*>(q), kp = static_cast<const T*>(k),
             vp = static_cast<const T*>(v), pep = static_cast<const T*>(pe),
             dep = static_cast<const T*>(de);
  const auto nbrp = static_cast<const int32_t*>(nbr), ptr = static_cast<const int32_t*>(in_ptr),
             eid = static_cast<const int32_t*>(in_eid);
  const auto mp = static_cast<const float*>(mask), hp = static_cast<const float*>(h),
             zp = static_cast<const float*>(z), dhp = static_cast<const float*>(dh);
  const auto dqp = static_cast<T*>(dq), dkp = static_cast<T*>(dk), dvp = static_cast<T*>(dv),
             dpep = static_cast<T*>(dpe);
  const auto dsp = static_cast<float*>(dsum);

  // Pass A, in the head layout.
  const HeadLayout lay = head_layout<T>(heads, head_dim, tp, fp);
  const dim3 grid_a(num_nodes * lay.chunks, batch);
  const int err = lay.items > 0
      ? dispatch_items(lay.items, [&](auto ic) {
          constexpr int ITEMS = decltype(ic)::value;
          edge_attention_bwd_src_block_kernel<T, ITEMS, kHasDe><<<grid_a, kThreads, 0, stream>>>(
              qp, kp, vp, pep, nbrp, mp, hp, zp, dhp, dep, dkp, dvp, dpep, dsp, num_nodes, knn,
              heads, head_dim, inv_sqrt_d);
          return static_cast<int>(cudaGetLastError());
        })
      : dispatch_vec<T>(lay.vec, [&](auto vc) {
          constexpr int VEC = decltype(vc)::value;
          edge_attention_bwd_src_kernel<T, VEC, kHasDe><<<grid_a, kThreads, 0, stream>>>(
              qp, kp, vp, pep, nbrp, mp, hp, zp, dhp, dep, dkp, dvp, dpep, dsp, num_nodes, knn,
              heads, head_dim, lay.head_lanes, lay.chunks, inv_sqrt_d);
          return static_cast<int>(cudaGetLastError());
        });
  if (err != 0) return err;

  // Pass B, in plain row chunks.
  const int vec = pick_vec<T>(hd, head_dim, tp, fp);
  const int chunks = (hd / vec + 31) / 32;
  const dim3 grid_b(num_nodes * chunks, batch);
  return dispatch_vec<T>(vec, [&](auto vc) {
    constexpr int VEC = decltype(vc)::value;
    edge_attention_bwd_dst_kernel<T, VEC, kHasDe><<<grid_b, kThreads, 0, stream>>>(
        qp, kp, pep, ptr, eid, mp, dsp, dep, dqp, num_nodes, knn, heads, head_dim, chunks,
        inv_sqrt_d);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pe, const void* nbr,
           const void* mask, const void* in_ptr, const void* in_eid, const void* h,
           const void* z, const void* dh, const void* de, void* dq, void* dk, void* dv,
           void* dpe, void* dsum, int batch, int num_nodes, int knn, int heads, int head_dim,
           cudaStream_t stream) {
  if (de != nullptr) {
    return launch_passes<T, true>(q, k, v, pe, nbr, mask, in_ptr, in_eid, h, z, dh, de, dq,
                                  dk, dv, dpe, dsum, batch, num_nodes, knn, heads, head_dim,
                                  stream);
  }
  return launch_passes<T, false>(q, k, v, pe, nbr, mask, in_ptr, in_eid, h, z, dh, de, dq, dk,
                                 dv, dpe, dsum, batch, num_nodes, knn, heads, head_dim, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Layouts, all contiguous:
// q/k/v and dq/dk/dv [B, N, H*D], pe/de/dpe [B, N*K, H*D] (float32 if
// is_bf16 == 0, else bfloat16), nbr [B, N*K] int32, mask [B, N*K] float32,
// in_ptr [B, N+1] and in_eid [B, N*K] int32 (the in-edge CSR), h, z and dh
// [B, N, H*D] float32, dsum [B, N*K, H] float32 (written by pass A, read by
// pass B). de may be null. Requires head_dim <= 4096 (the wrapper checks
// H*D <= 4096). Launches pass A then pass B on `stream` and
// returns the first cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int di_edge_attention_bwd(const void* q, const void* k, const void* v,
                                     const void* pe, const void* nbr, const void* mask,
                                     const void* in_ptr, const void* in_eid, const void* h,
                                     const void* z, const void* dh, const void* de, void* dq,
                                     void* dk, void* dv, void* dpe, void* dsum, int batch,
                                     int num_nodes, int knn, int heads, int head_dim,
                                     int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, pe, nbr, mask, in_ptr, in_eid, h, z, dh, de, dq, dk,
                                 dv, dpe, dsum, batch, num_nodes, knn, heads, head_dim, s);
  }
  return launch<float>(q, k, v, pe, nbr, mask, in_ptr, in_eid, h, z, dh, de, dq, dk, dv, dpe,
                       dsum, batch, num_nodes, knn, heads, head_dim, s);
}

extern "C" const char* di_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
