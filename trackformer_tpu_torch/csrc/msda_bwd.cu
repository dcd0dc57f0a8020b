// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel here: every Pallas MSDA forward sits
// in a jax.custom_vjp whose backward differentiates the XLA gather
// formulation (trackformer_tpu/ops/msda_dense.py::_bwd over
// _level_out_gather, trackformer_tpu/ops/msda_patch.py::_msda_patch_bwd), a
// scatter-add into the value gradient. This is that backward written for
// the card, the counterpart of the forward in msda_fwd.cu:
//
//   grad_value[n, corner, m, :] += w_corner * attn * grad_out[n, q, m, :]
//   grad_attn[n, q, m, l, p]     = sum_d grad_out_d * bilinear(value)_d
//   grad_loc[n, q, m, l, p]      = attn * (W_l * sum_d grad_out_d * d/dx,
//                                          H_l * sum_d grad_out_d * d/dy)
//
// with grid_sample semantics (align_corners=False, zero padding): a corner
// out of range has zero weight and takes no gradient, but still enters the
// x/y derivatives of its in-range neighbours with value 0, as the `valid`
// mask of the gather formulation does; floor() passes no gradient. All
// arithmetic is float32 (the JAX backward rounds the corner weights to the
// value type in bf16; this kernel does not).
//
// What bounds it on this card: the float32 atomics into grad_value. Raster
// order encoder queries hit the same value rows from neighbouring warps, so
// the atomics contend in L2; the bytes (grad_out, value, loc, attn read,
// grad_value read-modify-written, grad_loc and grad_attn written) are a
// small share of the time.
//
// What this simple design does about it: one warp per (query, head), lanes
// over the head's D channels (lane, lane + 32, ...), so a head's corner row
// is read, and its atomics are sent, by neighbouring lanes at neighbouring
// addresses, and the three sums over D are warp shuffles. All levels of a
// call run in one launch. grad_value accumulates in a float32 buffer that
// the caller zeroes and casts; the order of the atomics changes from run to
// run, so grad_value differs in its last bits between runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#define MSDA_MAX_LEVELS 16
#define MSDA_BWD_KMAX 4  // channels per lane: D <= 32 * MSDA_BWD_KMAX

struct LevelMeta {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grad_out (N, Lq, M*D) in TG; value (N, S, M*D) in TV; loc
// (N, Lq, M, L, P, 2) f32; attn (N, Lq, M, L, P) f32; grad_value
// (N, S, M*D) f32, zeroed by the caller; grad_loc, grad_attn as loc, attn.
// blockDim.x a multiple of 32; gridDim = (ceil(Lq*M / warps per block), N).
template <typename TV, typename TG>
__global__ void msda_bwd_kernel(const TG* __restrict__ grad_out,
                                const TV* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                float* __restrict__ grad_value,
                                float* __restrict__ grad_loc,
                                float* __restrict__ grad_attn, LevelMeta meta,
                                int s, int lq, int m, int l, int p, int d) {
  const int lane = threadIdx.x & 31;
  const int warps_per_block = blockDim.x >> 5;
  const long long pair =
      (long long)blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  if (pair >= (long long)lq * m) return;  // the whole warp leaves together
  const int n = blockIdx.y;
  const int q = (int)(pair / m);
  const int head = (int)(pair % m);
  const int md = m * d;

  float g[MSDA_BWD_KMAX];
  const TG* g_row = grad_out + ((size_t)n * lq + q) * md + head * d;
#pragma unroll
  for (int k = 0; k < MSDA_BWD_KMAX; ++k) {
    const int c = lane + 32 * k;
    g[k] = c < d ? to_f32(g_row[c]) : 0.f;
  }
  const size_t item = (size_t)n * s * md + head * d;
  const TV* v_item = value + item;
  float* gv_item = grad_value + item;
  const size_t k0 = (((size_t)n * lq + q) * m + head) * (size_t)(l * p);

  for (int lv = 0; lv < l; ++lv) {
    const int h = meta.h[lv];
    const int w = meta.w[lv];
    const size_t lvl_off = (size_t)meta.start[lv] * md;
    for (int pt = 0; pt < p; ++pt) {
      const size_t k = k0 + (size_t)lv * p + pt;
      const float a = __ldg(attn + k);
      // The product and the difference are rounded one after the other (no
      // fused multiply-add): the location gradient jumps where floor()
      // does, so the cell must be the one the plain version finds. The
      // clamp keeps the int conversion defined for any input; a clamped
      // sample has no corner in range, so all its gradients are zero.
      const float x = fminf(
          fmaxf(__fsub_rn(__fmul_rn(__ldg(loc + 2 * k), (float)w), 0.5f),
                -2.f),
          (float)w + 1.f);
      const float y = fminf(
          fmaxf(__fsub_rn(__fmul_rn(__ldg(loc + 2 * k + 1), (float)h), 0.5f),
                -2.f),
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
      const bool ok00 = y0_ok && x0_ok, ok10 = y0_ok && x1_ok;
      const bool ok01 = y1_ok && x0_ok, ok11 = y1_ok && x1_ok;
      const float w00 = (1.f - dx) * (1.f - dy), w10 = dx * (1.f - dy);
      const float w01 = (1.f - dx) * dy, w11 = dx * dy;
      // signed: a corner out of range may index before the level's start
      const long long i00 =
          (long long)lvl_off + (long long)(y0 * w + x0) * md;
      const long long i10 = i00 + md;
      const long long i01 = i00 + (long long)w * md;
      const long long i11 = i01 + md;

      float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
      for (int kk = 0; kk < MSDA_BWD_KMAX; ++kk) {
        const int c = lane + 32 * kk;
        if (c < d) {
          const float v00 = ok00 ? to_f32(v_item[i00 + c]) : 0.f;
          const float v10 = ok10 ? to_f32(v_item[i10 + c]) : 0.f;
          const float v01 = ok01 ? to_f32(v_item[i01 + c]) : 0.f;
          const float v11 = ok11 ? to_f32(v_item[i11 + c]) : 0.f;
          const float gk = g[kk];
          s_attn += gk * (w00 * v00 + w10 * v10 + w01 * v01 + w11 * v11);
          s_x += gk * ((1.f - dy) * (v10 - v00) + dy * (v11 - v01));
          s_y += gk * ((1.f - dx) * (v01 - v00) + dx * (v11 - v10));
          const float ga = a * gk;
          if (ok00) atomicAdd(gv_item + i00 + c, w00 * ga);
          if (ok10) atomicAdd(gv_item + i10 + c, w10 * ga);
          if (ok01) atomicAdd(gv_item + i01 + c, w01 * ga);
          if (ok11) atomicAdd(gv_item + i11 + c, w11 * ga);
        }
      }
      s_attn = warp_sum(s_attn);
      s_x = warp_sum(s_x);
      s_y = warp_sum(s_y);
      if (lane == 0) {
        grad_attn[k] = s_attn;
        grad_loc[2 * k] = (float)w * a * s_x;
        grad_loc[2 * k + 1] = (float)h * a * s_y;
      }
    }
  }
}

// Plain C entry point, loaded with ctypes. shapes_hw is a host array of
// 2*l ints ((H_0, W_0), ...); the levels lie back to back along S. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int msda_bwd(const void* grad_out, const void* value,
                        const void* loc, const void* attn, void* grad_value,
                        void* grad_loc, void* grad_attn, int n, int s, int lq,
                        int m, int l, int p, int d, const int* shapes_hw,
                        int value_is_bf16, int grad_is_bf16,
                        int warps_per_block, void* stream) {
  if (l < 1 || l > MSDA_MAX_LEVELS || m < 1 || d < 1 ||
      d > 32 * MSDA_BWD_KMAX || p < 1 || warps_per_block < 1 ||
      warps_per_block > 32 || n < 1 || n > 65535 || lq < 0)
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
  const long long pairs = (long long)lq * m;
  const dim3 grid((unsigned)((pairs + warps_per_block - 1) / warps_per_block),
                  n);
  const dim3 block(32 * warps_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lo = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(attn);
  float* gv = static_cast<float*>(grad_value);
  float* gl = static_cast<float*>(grad_loc);
  float* ga = static_cast<float*>(grad_attn);
#define MSDA_BWD_LAUNCH(TV, TG)                                             \
  msda_bwd_kernel<TV, TG><<<grid, block, 0, st>>>(                          \
      static_cast<const TG*>(grad_out), static_cast<const TV*>(value), lo,  \
      at, gv, gl, ga, meta, s, lq, m, l, p, d)
  if (value_is_bf16 && grad_is_bf16) {
    MSDA_BWD_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  } else if (value_is_bf16) {
    MSDA_BWD_LAUNCH(__nv_bfloat16, float);
  } else if (grad_is_bf16) {
    MSDA_BWD_LAUNCH(float, __nv_bfloat16);
  } else {
    MSDA_BWD_LAUNCH(float, float);
  }
#undef MSDA_BWD_LAUNCH
  return (int)cudaGetLastError();
}
