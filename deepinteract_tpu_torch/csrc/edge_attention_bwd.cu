// Fused scatter-mode edge-attention backward for Hopper (sm_90a).
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
//   ds   = dw_h * w_h * 1{|sum_pre_h| < 5} + de[e] * mask[e]
//   dpe[e] = ds * c,  da = ds * pe[e] * 1{|a| < 5} / sqrt(D)
//   dq[dst] += da * k[src],  dk[src] += da * q[dst],  dv[src] += w * dnum
// The clip masks are strict, as in the TPU kernel. q/k/v/pe/de are float32
// or bfloat16 (read as stored, computed in float32); h, z and dh are
// float32; dq/dk/dv/dpe are written in the input dtype. de may be null
// (a zero edge cotangent): then it is not read at all.
//
// Bound: bytes. Every element is touched once and there are ~3 flops per
// byte. At B=1, N=256, K=20, H*D=128, float32: pe and de in 5.24 MB, dpe
// out 2.62 MB, q/k/v/h/z/dh in and dq/dk/dv out 1.18 MB, nbr and mask
// 0.04 MB: 9.08 MB, ~2.7 us at 3.35 TB/s. This design adds a float32
// scratch g of one row per edge (written once, read once: another
// 5.24 MB, a cost of the design and not of the work) and pass B scans the
// whole nbr list per node, as the forward does.
//
// Design. The TPU kernel forms every scatter as a transposed one-hot
// matmul and accumulates dq/dk/dv in output blocks revisited by a
// sequential edge-block grid; neither carries over. Here the work splits
// by who owns the sum, so no block writes another block's output and no
// atomics are needed:
//   Pass A, one block per (graph, source node i), H*D lanes (rounded up to
//   a warp multiple). The K out-edges of i are contiguous rows of pe, de,
//   nbr and mask. Per edge, in slot order, the block gathers q, h, z and dh
//   at dst, recomputes a, c, s, sum_pre and w (head sums by __shfl_xor over
//   the D lanes of a head, which sit in one warp), writes dpe[e], adds
//   da * q[dst] and w * dnum into dk[i] and dv[i] in float32 registers,
//   and writes the per-edge dq share g[e] = da * k[i]. dk[i] and dv[i] are
//   written once at the end.
//   Pass B, one block per (graph, destination node): the block picks its
//   in-edges from the nbr list with a ballot and a prefix count, in
//   ascending edge-id order (the same walk as the forward kernel), and sums
//   their g rows into dq. A node without in-edges gets dq = 0.
// Sum orders are fixed by slot and edge ids: the kernel is deterministic
// from run to run. A destination without in-edges has z = 0 and a finite
// 1/(z + eps) = 1e6, but no edge reads its dnum, so it contributes
// nothing; masked (padded) edges have w = 0 and ds = 0, so dpe = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kClip = 5.0f;
constexpr float kEps = 1e-6f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float clip(float x) { return fminf(fmaxf(x, -kClip), kClip); }
__device__ __forceinline__ bool inside_clip(float x) { return x > -kClip && x < kClip; }

// Sum over the head_dim lanes of a head (a power of two <= 32, so a head's
// lanes sit in one warp). Every lane of the warp must call it.
__device__ __forceinline__ float head_sum(float x, int head_dim) {
  for (int step = head_dim >> 1; step > 0; step >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, step);
  return x;
}

template <typename T, bool kHasDe>
__global__ void edge_attention_bwd_src_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ pe, const int32_t* __restrict__ nbr,
    const float* __restrict__ mask, const float* __restrict__ h,
    const float* __restrict__ z, const float* __restrict__ dh,
    const T* __restrict__ de, T* __restrict__ dk, T* __restrict__ dv,
    T* __restrict__ dpe, float* __restrict__ g, int num_nodes, int knn,
    int hd, int head_dim, float inv_sqrt_d) {
  const int src = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool active = tid < hd;

  const int64_t node_row0 = (int64_t)b * num_nodes;
  const int64_t edge_row0 = (int64_t)b * num_nodes * knn + (int64_t)src * knn;
  const int64_t src_off = (node_row0 + src) * hd + tid;

  const float kv = active ? to_f32(k[src_off]) : 0.0f;
  const float vv = active ? to_f32(v[src_off]) : 0.0f;
  float dk_acc = 0.0f;
  float dv_acc = 0.0f;

  for (int slot = 0; slot < knn; ++slot) {
    const int64_t edge = edge_row0 + slot;
    const int dst = nbr[edge];
    const float m = mask[edge];
    const int64_t dst_off = (node_row0 + dst) * hd + tid;
    const int64_t e_off = edge * hd + tid;
    float qd = 0.0f, hdst = 0.0f, dnum = 0.0f, pv = 0.0f;
    if (active) {
      qd = to_f32(q[dst_off]);
      hdst = h[dst_off];
      dnum = dh[dst_off] * (1.0f / (z[dst_off] + kEps));
      pv = to_f32(pe[e_off]);
    }
    const float a = kv * qd * inv_sqrt_d;
    const float c = clip(a);
    const float sum_pre = head_sum(c * pv, head_dim);
    const float w = expf(clip(sum_pre)) * m;
    const float dz = -head_sum(hdst * dnum, head_dim);
    const float dw = head_sum(dnum * vv, head_dim) + dz;
    float ds = inside_clip(sum_pre) ? dw * w : 0.0f;
    if (kHasDe && active) ds += to_f32(de[e_off]) * m;
    const float da = inside_clip(a) ? ds * pv * inv_sqrt_d : 0.0f;
    dk_acc += da * qd;
    dv_acc += w * dnum;
    if (active) {
      store(&dpe[e_off], ds * c);
      g[e_off] = da * kv;
    }
  }

  if (active) {
    store(&dk[src_off], dk_acc);
    store(&dv[src_off], dv_acc);
  }
}

template <typename T>
__global__ void edge_attention_bwd_dst_kernel(
    const int32_t* __restrict__ nbr, const float* __restrict__ g,
    T* __restrict__ dq, int num_nodes, int knn, int hd) {
  __shared__ int32_t picked[kMaxThreads];
  __shared__ int32_t warp_hits[kMaxThreads / 32];

  const int dst = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = blockDim.x >> 5;
  const bool active = tid < hd;

  const int num_edges = num_nodes * knn;
  const int32_t* nbr_b = nbr + (int64_t)b * num_edges;
  const int64_t edge_row0 = (int64_t)b * num_edges;
  float acc = 0.0f;

  for (int chunk = 0; chunk < num_edges; chunk += blockDim.x) {
    const int e = chunk + tid;
    const bool hit = e < num_edges && nbr_b[e] == dst;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0;
    int total = 0;
    for (int w = 0; w < num_warps; ++w) {
      const int c = warp_hits[w];
      offset += (w < warp) ? c : 0;
      total += c;
    }
    if (hit) picked[offset + __popc(ballot & ((1u << lane) - 1u))] = e;
    __syncthreads();
    if (active) {
      for (int j = 0; j < total; ++j) acc += g[(edge_row0 + picked[j]) * hd + tid];
    }
    __syncthreads();  // `picked` and `warp_hits` are rewritten next chunk
  }

  if (active) store(&dq[((int64_t)b * num_nodes + dst) * hd + tid], acc);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pe,
           const void* nbr, const void* mask, const void* h, const void* z,
           const void* dh, const void* de, void* dq, void* dk, void* dv,
           void* dpe, void* g, int batch, int num_nodes, int knn, int heads,
           int head_dim, cudaStream_t stream) {
  const int hd = heads * head_dim;
  const int threads = (hd + 31) / 32 * 32;
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)head_dim));
  const dim3 grid(num_nodes, batch);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* pet = static_cast<const T*>(pe);
  const int32_t* nbrt = static_cast<const int32_t*>(nbr);
  const float* maskt = static_cast<const float*>(mask);
  const float* ht = static_cast<const float*>(h);
  const float* zt = static_cast<const float*>(z);
  const float* dht = static_cast<const float*>(dh);
  float* gt = static_cast<float*>(g);
  if (de != nullptr) {
    edge_attention_bwd_src_kernel<T, true><<<grid, threads, 0, stream>>>(
        qt, kt, vt, pet, nbrt, maskt, ht, zt, dht, static_cast<const T*>(de),
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dpe), gt,
        num_nodes, knn, hd, head_dim, inv_sqrt_d);
  } else {
    edge_attention_bwd_src_kernel<T, false><<<grid, threads, 0, stream>>>(
        qt, kt, vt, pet, nbrt, maskt, ht, zt, dht, nullptr,
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dpe), gt,
        num_nodes, knn, hd, head_dim, inv_sqrt_d);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_attention_bwd_dst_kernel<T><<<grid, threads, 0, stream>>>(
      nbrt, gt, static_cast<T*>(dq), num_nodes, knn, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Layouts, all contiguous:
// q/k/v and dq/dk/dv [B, N, H*D], pe/de/dpe [B, N*K, H*D] (float32 if
// is_bf16 == 0, else bfloat16), nbr [B, N*K] int32, mask [B, N*K] float32,
// h, z and dh [B, N, H*D] float32, g [B, N*K, H*D] float32 scratch. de may
// be null. Requires H*D <= 1024 and head_dim a power of two <= 32 (the
// wrapper checks). Launches pass A then pass B on `stream` and returns the
// first cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int di_edge_attention_bwd(
    const void* q, const void* k, const void* v, const void* pe,
    const void* nbr, const void* mask, const void* h, const void* z,
    const void* dh, const void* de, void* dq, void* dk, void* dv, void* dpe,
    void* g, int batch, int num_nodes, int knn, int heads, int head_dim,
    int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, pe, nbr, mask, h, z, dh, de, dq, dk,
                                 dv, dpe, g, batch, num_nodes, knn, heads,
                                 head_dim, s);
  }
  return launch<float>(q, k, v, pe, nbr, mask, h, z, dh, de, dq, dk, dv, dpe,
                       g, batch, num_nodes, knn, heads, head_dim, s);
}

extern "C" const char* di_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
