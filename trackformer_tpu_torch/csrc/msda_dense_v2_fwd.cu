// One level of multi-scale deformable attention with row-band skipping, for
// Hopper (sm_90a).
//
// Replaces trackformer_tpu/ops/msda_dense.py::_kernel_v2 (reached through
// _dense_level_pallas_v2_fwd, route PALLAS_SKIP_IMPL="v2"): one level's
// contribution as bilinear hat weights times values,
//
//   out[n, q, m, :] = sum_p attn[n, q, m, p] * sum_{r, c} hat(y_p - r)
//                     * hat(x_p - c) * value[n, r * W + c, m, :],
//   hat(t) = max(0, 1 - |t|),  x = loc_x * W - 0.5,  y = loc_y * H - 0.5,
//
// where a tile of consecutive queries only meets the value rows between
// floor(min y) - 1 and floor(max y) + 1 over the tile's heads and points
// (the TPU kernel's skip bound), so every other row is never read. Encoder
// queries are the level's tokens in raster order and sample near
// themselves, so the band is a few rows; scattered queries widen it up to
// the whole level and the kernel stays right.
//
// The TPU kernel builds a dense (queries, cells) hat tile per row tile and
// multiplies it with the values on the matrix unit, skipping (q-tile,
// row-tile) pairs by prefetched flags. On this card the hat's support is
// walked directly: per point at most 2 x 2 cells are non-zero.
//
// What bounds it: bytes. The gather kernel (msda_fwd.cu) reads every corner
// row from L1/L2 with scalar loads, because D = 36 bf16 channels are not
// 16-byte aligned. Here a block stages the band's rows for ONE head into
// shared memory with the widest aligned loads the layout allows (8 bytes
// for D = 36 bf16, 16 for float32), in chunks of whole rows, and all
// corner reads then hit shared memory.
//
// Design: one block per (head, tile of TQ consecutive queries, item), heads
// fastest so that the eight blocks that read neighbouring slices of the
// same rows run together. The block (1) loads its head's (x, y, attn) into
// shared memory and reduces min/max y over all heads of the tile, (2) walks
// the band in chunks of `rows_per_chunk` rows: stage, then every
// (query, channel) adds its points' corners that lie in the chunk into a
// float32 tile in shared memory, (3) writes the tile once. Weights and sums
// are float32 (the TPU kernel rounds each cell's summed weight to the value
// type before its product). Queries past Lq are masked, not padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <float.h>
#include <stddef.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared memory: [values chunk: rows_per_chunk * W * D of T, padded to 16 B]
// [out tile: TQ * D f32][x, y, attn: 3 * TQ * P f32][reduction: 64 f32].
// value_l (N, H*W, M*D) in T; loc (N, Lq, M, P, 2) f32; attn (N, Lq, M, P)
// f32; out (N, Lq, M*D) f32; band (N, ceil(Lq / TQ), 2) int32 or null:
// each tile's inclusive row band clipped to the level (lo > hi: empty).
// U is the staging word; gridDim = (M, ceil(Lq / TQ), N).
template <typename T, typename U>
__global__ void msda_dense_v2_fwd_kernel(
    const T* __restrict__ value_l, const float* __restrict__ loc,
    const float* __restrict__ attn, float* __restrict__ out,
    int* __restrict__ band, int h, int w, int lq, int m, int p, int d, int tq,
    int rows_per_chunk, int chunk_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* vs = reinterpret_cast<T*>(smem);
  float* out_s = reinterpret_cast<float*>(smem + chunk_bytes);
  float* qx = out_s + (size_t)tq * d;
  float* qy = qx + (size_t)tq * p;
  float* qa = qy + (size_t)tq * p;
  float* red = qa + (size_t)tq * p;

  const int head = blockIdx.x;
  const int tile = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int md = m * d;
  const int q_begin = tile * tq;
  const int nq = min(tq, lq - q_begin);

  // (1) this head's samples, and the tile's y range over all heads
  float ymin = FLT_MAX, ymax = -FLT_MAX;
  const int mp = m * p;
  for (int i = tid; i < nq * mp; i += nthreads) {
    const int ql = i / mp;
    const int rem = i - ql * mp;
    const int hd = rem / p;
    const size_t k = ((size_t)n * lq + q_begin + ql) * mp + rem;
    // a product and a difference rounded one after the other (no fused
    // multiply-add), so that the band is the one the plain version
    // computes; clamped like the gather kernel: the int conversions stay
    // defined and every in-range corner is left as it was
    const float y = fminf(
        fmaxf(__fsub_rn(__fmul_rn(__ldg(loc + 2 * k + 1), (float)h), 0.5f),
              -2.f),
        (float)h + 1.f);
    ymin = fminf(ymin, y);
    ymax = fmaxf(ymax, y);
    if (hd == head) {
      const int pt = rem - hd * p;
      qx[ql * p + pt] = fminf(
          fmaxf(__fsub_rn(__fmul_rn(__ldg(loc + 2 * k), (float)w), 0.5f),
                -2.f),
          (float)w + 1.f);
      qy[ql * p + pt] = y;
      qa[ql * p + pt] = __ldg(attn + k);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
    ymax = fmaxf(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
  }
  const int nwarps = (nthreads + 31) >> 5;
  if ((tid & 31) == 0) {
    red[tid >> 5] = ymin;
    red[32 + (tid >> 5)] = ymax;
  }
  for (int i = tid; i < nq * d; i += nthreads) out_s[i] = 0.f;
  __syncthreads();
  for (int i = 0; i < nwarps; ++i) {
    ymin = fminf(ymin, red[i]);
    ymax = fmaxf(ymax, red[32 + i]);
  }
  const int r_lo = max(0, (int)floorf(ymin) - 1);
  const int r_hi = min(h - 1, (int)floorf(ymax) + 1);
  if (band != nullptr && head == 0 && tid == 0) {
    int* b = band + 2 * ((size_t)n * gridDim.y + tile);
    b[0] = r_lo;
    b[1] = r_hi;
  }

  // (2) walk the band in chunks of whole rows
  const int upc = d * (int)sizeof(T) / (int)sizeof(U);  // words per cell
  for (int r0 = r_lo; r0 <= r_hi; r0 += rows_per_chunk) {
    const int r1 = min(r0 + rows_per_chunk, r_hi + 1);
    __syncthreads();  // the previous chunk is consumed
    const int cells = (r1 - r0) * w;
    const T* src = value_l + ((size_t)n * h * w + (size_t)r0 * w) * md +
                   head * d;
    U* dst = reinterpret_cast<U*>(vs);
    for (int i = tid; i < cells * upc; i += nthreads) {
      const int cell = i / upc;
      const int u = i - cell * upc;
      dst[i] = reinterpret_cast<const U*>(src + (size_t)cell * md)[u];
    }
    __syncthreads();
    for (int i = tid; i < nq * d; i += nthreads) {
      const int ql = i / d;
      const int c = i - ql * d;
      float acc = 0.f;
      for (int pt = 0; pt < p; ++pt) {
        const float y = qy[ql * p + pt];
        const int y0 = (int)floorf(y);
        if (y0 + 1 < r0 || y0 >= r1) continue;
        const float x = qx[ql * p + pt];
        const int x0 = (int)floorf(x);
        const float a = qa[ql * p + pt];
#pragma unroll
        for (int cy = 0; cy < 2; ++cy) {
          const int ry = y0 + cy;
          if (ry < r0 || ry >= r1) continue;
          const float wy = a * (1.f - fabsf(y - (float)ry));
          const T* row = vs + (size_t)(ry - r0) * w * d + c;
#pragma unroll
          for (int cx = 0; cx < 2; ++cx) {
            const int rx = x0 + cx;
            if (rx < 0 || rx >= w) continue;
            acc += wy * (1.f - fabsf(x - (float)rx)) *
                   to_f32(row[(size_t)rx * d]);
          }
        }
      }
      out_s[i] += acc;
    }
  }

  // (3) one write per (query, channel); each thread wrote its own entries
  for (int i = tid; i < nq * d; i += nthreads) {
    const int ql = i / d;
    const int c = i - ql * d;
    out[((size_t)n * lq + q_begin + ql) * md + head * d + c] = out_s[i];
  }
}

template <typename T, typename U>
static int launch_v2(const void* value_l, const void* loc, const void* attn,
                     void* out, void* band, int n, int h, int w, int lq, int m,
                     int p, int d, int tq, int rows_per_chunk, int chunk_bytes,
                     size_t smem_bytes, int threads, cudaStream_t st) {
  auto kernel = msda_dense_v2_fwd_kernel<T, U>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(m, (lq + tq - 1) / tq, n);
  kernel<<<grid, threads, smem_bytes, st>>>(
      static_cast<const T*>(value_l), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<float*>(out),
      static_cast<int*>(band), h, w, lq, m, p, d, tq, rows_per_chunk,
      chunk_bytes);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes. `chunk_budget_bytes` is the
// shared memory to spend on staged value rows (at least one row is always
// staged); `band` may be null. Launches on `stream` and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a shape the
// kernel does not take (a single row of one head over 160 KB).
extern "C" int msda_dense_v2_fwd(const void* value_l, const void* loc,
                                 const void* attn, void* out, void* band,
                                 int n, int h, int w, int lq, int m, int p,
                                 int d, int value_is_bf16, int tq,
                                 int chunk_budget_bytes, int threads,
                                 void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || lq < 0 || m < 1 || m > 65535 ||
      p < 1 || d < 1 || tq < 1 || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (lq == 0) return (int)cudaGetLastError();
  if ((lq + tq - 1) / tq > 65535) return (int)cudaErrorInvalidValue;
  const int es = value_is_bf16 ? 2 : 4;
  const size_t row_bytes = (size_t)w * d * es;
  if (row_bytes > 160 * 1024) return (int)cudaErrorInvalidValue;
  int rows = (int)((size_t)chunk_budget_bytes / row_bytes);
  rows = rows < 1 ? 1 : (rows > h ? h : rows);
  const int chunk_bytes = (int)((rows * row_bytes + 15) / 16 * 16);
  const size_t smem_bytes = (size_t)chunk_bytes +
                            sizeof(float) * ((size_t)tq * d +
                                             3 * (size_t)tq * p + 64);
  if (smem_bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  // widest staging word that every head's slice of every cell is aligned to
  const size_t slice = (size_t)d * es, stride = (size_t)m * d * es;
  const uintptr_t base = reinterpret_cast<uintptr_t>(value_l);
  int word = 16;
  while (word > es &&
         (slice % word != 0 || stride % word != 0 || base % word != 0))
    word /= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define V2_LAUNCH(T, U)                                                     \
  return launch_v2<T, U>(value_l, loc, attn, out, band, n, h, w, lq, m, p,  \
                         d, tq, rows, chunk_bytes, smem_bytes, threads, st)
  if (value_is_bf16) {
    if (word == 16) V2_LAUNCH(__nv_bfloat16, uint4);
    if (word == 8) V2_LAUNCH(__nv_bfloat16, uint2);
    if (word == 4) V2_LAUNCH(__nv_bfloat16, uint32_t);
    V2_LAUNCH(__nv_bfloat16, uint16_t);
  }
  if (word == 16) V2_LAUNCH(float, uint4);
  if (word == 8) V2_LAUNCH(float, uint2);
  V2_LAUNCH(float, uint32_t);
#undef V2_LAUNCH
}
