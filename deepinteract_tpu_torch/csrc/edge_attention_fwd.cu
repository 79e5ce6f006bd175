// Fused scatter-mode edge-attention forward for Hopper (sm_90a).
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
// 2.62 MB, q/k/v in and h/z out 0.66 MB, nbr and mask 0.04 MB: ~5.9 MB,
// ~1.8 us at 3.35 TB/s. This simple design does not reach it: every block
// scans the whole nbr list (O(N^2 K) compares in N*K/blockDim barrier-
// separated chunks) and walks its in-edges one after another. An in-edge
// CSR built once per encode would remove the scan.
//
// Design. The TPU kernel turns the scatter into one-hot [EB, N] matmuls on
// the MXU and accumulates over a sequential edge-block grid in VMEM; both
// exist for the TPU and are not carried over. Here one thread block owns
// one (graph, destination node) and H*D lanes (rounded up to a warp
// multiple): lane (h, d) holds q[dst, h, d]. The block walks the graph's
// nbr list (N*K int32, L2-resident) in chunks of blockDim edges, picks the
// edges whose destination is its node with a ballot and a prefix count,
// and compacts their ids into shared memory in ascending edge-id order.
// For each picked edge it loads k[src], v[src] and pe[e] (coalesced rows
// of H*D), writes e_out[e] (each edge has exactly one destination, so
// every e_out element is written exactly once), reduces the per-head sum
// over D lanes with __shfl_xor (D is a power of two <= 32, so a head's
// lanes sit in one warp), and accumulates w*v and w in float32 registers.
// The sum order is fixed by the edge ids: no atomics, deterministic from
// run to run. A destination with no in-edges ends with h = 0 and z = 0.

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

template <typename T>
__global__ void edge_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ pe, const int32_t* __restrict__ nbr,
    const float* __restrict__ mask, float* __restrict__ h_out,
    T* __restrict__ e_out, float* __restrict__ z_out,
    int num_nodes, int knn, int hd, int head_dim, float inv_sqrt_d) {
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
  const float* mask_b = mask + (int64_t)b * num_edges;
  const int64_t node_row0 = (int64_t)b * num_nodes;   // first node row of graph b
  const int64_t edge_row0 = (int64_t)b * num_edges;   // first edge row of graph b

  const float qv = active ? to_f32(q[(node_row0 + dst) * hd + tid]) : 0.0f;
  float acc = 0.0f;
  float z = 0.0f;

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

    // `total` is the same in every thread, so the loop (and the shuffles
    // in it) run converged.
    for (int j = 0; j < total; ++j) {
      const int eid = picked[j];
      const int64_t src_row = node_row0 + eid / knn;
      const float m = mask_b[eid];
      float s = 0.0f;
      float vv = 0.0f;
      if (active) {
        const float kv = to_f32(k[src_row * hd + tid]);
        vv = to_f32(v[src_row * hd + tid]);
        const float pv = to_f32(pe[(edge_row0 + eid) * hd + tid]);
        s = clip(kv * qv * inv_sqrt_d) * pv;
        store(&e_out[(edge_row0 + eid) * hd + tid], s * m);
      }
      float head_sum = s;
      for (int step = head_dim >> 1; step > 0; step >>= 1)
        head_sum += __shfl_xor_sync(0xffffffffu, head_sum, step);
      const float w = expf(clip(head_sum)) * m;
      acc += w * vv;
      z += w;
    }
    __syncthreads();  // `picked` and `warp_hits` are rewritten next chunk
  }

  if (active) {
    h_out[(node_row0 + dst) * hd + tid] = acc / (z + kEps);
    z_out[(node_row0 + dst) * hd + tid] = z;
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* pe,
            const void* nbr, const void* mask, void* h, void* e_out, void* z,
            int batch, int num_nodes, int knn, int heads, int head_dim,
            cudaStream_t stream) {
  const int hd = heads * head_dim;
  const int threads = (hd + 31) / 32 * 32;
  const float inv_sqrt_d = (float)(1.0 / sqrt((double)head_dim));
  edge_attention_fwd_kernel<T><<<dim3(num_nodes, batch), threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(pe), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(mask), static_cast<float*>(h),
      static_cast<T*>(e_out), static_cast<float*>(z),
      num_nodes, knn, hd, head_dim, inv_sqrt_d);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Layouts, all contiguous:
// q/k/v [B, N, H*D], pe and e_out [B, N*K, H*D] (float32 if is_bf16 == 0,
// else bfloat16), nbr [B, N*K] int32, mask [B, N*K] float32, h and z
// [B, N, H*D] float32. Requires H*D <= 1024 and head_dim a power of two
// <= 32 (the wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int di_edge_attention_fwd(
    const void* q, const void* k, const void* v, const void* pe,
    const void* nbr, const void* mask, void* h, void* e_out, void* z,
    int batch, int num_nodes, int knn, int heads, int head_dim, int is_bf16,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(q, k, v, pe, nbr, mask, h, e_out, z, batch,
                          num_nodes, knn, heads, head_dim, s);
  } else {
    launch<float>(q, k, v, pe, nbr, mask, h, e_out, z, batch, num_nodes, knn,
                  heads, head_dim, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* di_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
