// Exact multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
//   * trackformer_tpu/ops/msda_patch.py::_kernel_v5 (the encoder's fused
//     all-levels patch walk, Lq == S);
//   * trackformer_tpu/ops/msda_dense.py::_kernel (v1, one level as a
//     generated-LHS matmul, used for the decoder's mid level).
// Both exist only because Mosaic has no usable large dynamic gather. Hopper
// gathers natively, so this is the bilinear corner gather of the original
// CUDA op over a given set of levels, with grid_sample semantics
// (align_corners=False, zero padding):
//
//   out[n, q, m, :] = sum_{l, p, corner} attn[n, q, m, l, p]
//                     * bilinear(corner) * value[n, start_l + y * W_l + x, m, :]
//
// What bounds it on this card: random-access corner reads. The flagship
// encoder call (Lq = S = 22,323, M = 8, L = 4, P = 4) takes about 2.86M
// samples x 4 corners, each a 72-byte bf16 row of D = 36 channels, against
// a few FMAs per value read.
//
// What this simple design does about it: one block per (batch item, tile of
// queries) and one thread per channel of the M*D row, so the corner rows of
// all heads for one (query, level, point) are read by neighbouring threads
// at neighbouring addresses (coalesced, channel-contiguous), and each sum
// stays in an f32 register. Values are read one element at a time: D = 36
// bf16 values is not a multiple of 8, so 16-byte vector loads would straddle
// the rows of two heads. Shared-memory value tiles, TMA and wgmma are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#define MSDA_MAX_LEVELS 16

struct LevelMeta {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// value (N, S, M*D); loc (N, Lq, M, L, P, 2) f32 in [0, 1] as (x, y);
// attn (N, Lq, M, L, P) f32; out (N, Lq, M*D) in O: the value type, or f32
// for a caller that adds the result to other levels' sums before it rounds.
// blockDim.x == M*D, gridDim = (ceil(Lq / q_per_block), N).
template <typename T, typename O>
__global__ void msda_fwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                O* __restrict__ out, LevelMeta meta, int s,
                                int lq, int m, int l, int p, int d,
                                int q_per_block) {
  const int md = m * d;
  const int c = threadIdx.x;
  if (c >= md) return;
  const int head = c / d;
  const int n = blockIdx.y;
  const int q_begin = blockIdx.x * q_per_block;
  const int q_end = min(q_begin + q_per_block, lq);
  const T* v_item = value + (size_t)n * s * md + c;

  for (int q = q_begin; q < q_end; ++q) {
    // first (level, point) sample of this (n, q, head)
    const size_t k0 = (((size_t)n * lq + q) * m + head) * (size_t)(l * p);
    float acc = 0.f;
    for (int lv = 0; lv < l; ++lv) {
      const int h = meta.h[lv];
      const int w = meta.w[lv];
      const T* v_lvl = v_item + (size_t)meta.start[lv] * md;
      for (int pt = 0; pt < p; ++pt) {
        const size_t k = k0 + (size_t)lv * p + pt;
        const float a = __ldg(attn + k);
        // clamping keeps the int conversion defined for any input and
        // leaves every in-range corner as it was
        const float x = fminf(fmaxf(__ldg(loc + 2 * k) * w - 0.5f, -2.f),
                              (float)w + 1.f);
        const float y = fminf(fmaxf(__ldg(loc + 2 * k + 1) * h - 0.5f, -2.f),
                              (float)h + 1.f);
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float dx = x - x0f;
        const float dy = y - y0f;
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        const bool x0_ok = x0 >= 0 && x0 < w;
        const bool x1_ok = x0 + 1 >= 0 && x0 + 1 < w;
        const bool y0_ok = y0 >= 0 && y0 < h;
        const bool y1_ok = y0 + 1 >= 0 && y0 + 1 < h;
        float sample = 0.f;
        if (y0_ok && x0_ok)
          sample += (1.f - dx) * (1.f - dy) *
                    to_f32(v_lvl[(size_t)(y0 * w + x0) * md]);
        if (y0_ok && x1_ok)
          sample += dx * (1.f - dy) *
                    to_f32(v_lvl[(size_t)(y0 * w + x0 + 1) * md]);
        if (y1_ok && x0_ok)
          sample += (1.f - dx) * dy *
                    to_f32(v_lvl[(size_t)((y0 + 1) * w + x0) * md]);
        if (y1_ok && x1_ok)
          sample += dx * dy *
                    to_f32(v_lvl[(size_t)((y0 + 1) * w + x0 + 1) * md]);
        acc += a * sample;
      }
    }
    store_from_f32(out + ((size_t)n * lq + q) * md + c, acc);
  }
}

// Plain C entry point, loaded with ctypes. shapes_hw is a host array of
// 2*l ints ((H_0, W_0), ...); the levels lie back to back along S. Launches
// on `stream` and returns cudaGetLastError() (0 on success). `out_is_f32`
// asks for the f32 sums of bf16 values unrounded (f32 values always give f32).
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn,
                        void* out, int n, int s, int lq, int m, int l, int p,
                        int d, const int* shapes_hw, int value_is_bf16,
                        int out_is_f32, int q_per_block, void* stream) {
  if (l < 1 || l > MSDA_MAX_LEVELS || m < 1 || d < 1 || m * d > 1024 ||
      p < 1 || q_per_block < 1 || n < 1 || n > 65535 || lq < 0)
    return (int)cudaErrorInvalidValue;
  LevelMeta meta;
  int start = 0;
  for (int i = 0; i < l; ++i) {
    meta.h[i] = shapes_hw[2 * i];
    meta.w[i] = shapes_hw[2 * i + 1];
    meta.start[i] = start;
    start += meta.h[i] * meta.w[i];
  }
  if (start != s) return (int)cudaErrorInvalidValue;
  if (lq == 0) return (int)cudaGetLastError();
  const dim3 grid((lq + q_per_block - 1) / q_per_block, n);
  const dim3 block(m * d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_is_bf16 && out_is_f32) {
    msda_fwd_kernel<__nv_bfloat16, float><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value),
        static_cast<const float*>(loc), static_cast<const float*>(attn),
        static_cast<float*>(out), meta, s, lq, m, l, p, d, q_per_block);
  } else if (value_is_bf16) {
    msda_fwd_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value),
        static_cast<const float*>(loc), static_cast<const float*>(attn),
        static_cast<__nv_bfloat16*>(out), meta, s, lq, m, l, p, d,
        q_per_block);
  } else {
    msda_fwd_kernel<float, float><<<grid, block, 0, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(attn), static_cast<float*>(out), meta, s,
        lq, m, l, p, d, q_per_block);
  }
  return (int)cudaGetLastError();
}
