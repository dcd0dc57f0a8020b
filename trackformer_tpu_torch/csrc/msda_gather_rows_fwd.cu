// Weighted gather of precomputed rows: multi-scale deformable attention once
// the corner indices and folded weights exist, for Hopper (sm_90a).
//
// Replaces trackformer_tpu/ops/msda_pallas.py::_msda_kernel (public
// ms_deform_attn_pallas; no route of ms_deform_attn calls it):
//
//   out[b, q, :] = sum_k w[b, q, k] * value[b, idx[b, q, k], :],
//
// b = item * M + head, K = levels * points * 4 corners. The wrapper builds
// idx and w outside (corner_indices_weights: bilinear weight * attention
// weight * in-bounds mask, indices clipped into the table), exactly as the
// TPU wrapper does, and hands the kernel a head-major float32 table.
//
// The TPU kernel runs one program per (item, head) with the whole table in
// VMEM and serializes the K dynamic row slices of a query on the sublane
// port. This card gathers natively: one warp per (item * head, query); the
// warp loads 32 indices and weights at a time with one coalesced read each
// and passes them round by shuffle; lanes hold the channels (lane, lane +
// 32, ...), so a row is read by neighbouring lanes at neighbouring
// addresses and each sum stays in a float32 register.
//
// What bounds it: bytes. Unlike msda_fwd.cu it reads 8 bytes of index and
// weight per gathered row of D * 4 bytes on top of the table, which the
// precomputed form makes compulsory traffic.
#include "msda_common.cuh"

// idx, w (B, Lq, K) int32 / f32; value (B, S, D) f32; out (B, Lq, D) f32.
// blockDim.x = 32 * warps, gridDim = (ceil(Lq / warps), B).
__global__ void msda_gather_rows_fwd_kernel(const int* __restrict__ idx,
                                            const float* __restrict__ w,
                                            const float* __restrict__ value,
                                            float* __restrict__ out, int s,
                                            int lq, int k, int d) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= lq) return;  // whole warps leave: no barrier follows
  const size_t b = blockIdx.y;
  const int* idx_q = idx + (b * lq + q) * k;
  const float* w_q = w + (b * lq + q) * k;
  const float* table = value + b * s * d;
  float* out_q = out + (b * lq + q) * d;

  for (int c0 = 0; c0 < d; c0 += 64) {
    const int ca = c0 + lane, cb = c0 + 32 + lane;
    float acc_a = 0.f, acc_b = 0.f;
    for (int k0 = 0; k0 < k; k0 += 32) {
      const bool have = k0 + lane < k;
      const int my_idx = have ? __ldg(idx_q + k0 + lane) : 0;
      const float my_w = have ? __ldg(w_q + k0 + lane) : 0.f;
      const int kn = min(32, k - k0);
      for (int j = 0; j < kn; ++j) {
        const int row = __shfl_sync(0xffffffffu, my_idx, j);
        const float wt = __shfl_sync(0xffffffffu, my_w, j);
        const float* src = table + (size_t)row * d;
        if (ca < d) acc_a += wt * __ldg(src + ca);
        if (cb < d) acc_b += wt * __ldg(src + cb);
      }
    }
    if (ca < d) out_q[ca] = acc_a;
    if (cb < d) out_q[cb] = acc_b;
  }
}

// Plain C entry point, loaded with ctypes. `b` = items * heads. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int msda_gather_rows_fwd(const void* idx, const void* w,
                                    const void* value, void* out, int b, int s,
                                    int lq, int k, int d, int warps,
                                    void* stream) {
  if (b < 1 || b > 65535 || s < 1 || lq < 0 || k < 1 || d < 1 || warps < 1 ||
      warps > 32)
    return (int)cudaErrorInvalidValue;
  if (lq == 0) return (int)cudaGetLastError();
  const dim3 grid((lq + warps - 1) / warps, b);
  msda_gather_rows_fwd_kernel<<<grid, 32 * warps, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(value), static_cast<float*>(out), s, lq, k,
      d);
  return (int)cudaGetLastError();
}
