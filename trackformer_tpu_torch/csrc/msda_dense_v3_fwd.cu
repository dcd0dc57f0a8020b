// One level of multi-scale deformable attention over spatially sorted query
// tiles, each with its row band and one column window, for Hopper (sm_90a).
//
// Replaces trackformer_tpu/ops/msda_dense.py::_kernel_v3 (reached through
// _dense_level_pallas_v3_fwd, public dense_level_pallas_v3; no route of
// ms_deform_attn calls it):
//
//   out[n, q, m, :] = sum_p attn[n, q, m, p] * sum_{r, c} hat(y_p - r)
//                     * hat(x_p - c) * value[n, r * W + c, m, :],
//   hat(t) = max(0, 1 - |t|),  x = loc_x * W - 0.5,  y = loc_y * H - 0.5.
//
// Queries are tiled in the order of a permutation `perm` that sorts them by
// their mean sample position on a raster of 8 x 8-cell buckets
// (spatial_sort_perm), so a tile is compact in both axes. A tile meets the
// rows floor(min y) - 1 .. floor(max y) + 1 (the block-skipping kernel's
// band) and the columns left = max(0, floor(min x)) .. right =
// min(W - 1, floor(max x) + 1). When right - left + 1 <= CW the tile "fits":
// it is computed on ONE window of CW columns that starts at
// xstart = min(left, W - CW); otherwise on the full width. Both give the same
// numbers. (The TPU kernel aligns xstart down to a multiple of 8 for its
// compiler's sake; here the window only has to hold every occupied column.)
//
// On this card: one block per (head, q-tile, item), as the first design of
// the block-skipping kernel, which staged whole rows of the band; this one
// stages only the window's columns of each row, so a fitting tile moves
// CW / W of the band's bytes. The permutation is applied by index (loc / attn read at
// perm[q], out written at perm[q]). The TPU kernel leaves the pipelining to
// its grid; this one stages a chunk of rows, waits, sums, and goes on (the
// double-buffered walk is msda_dense_v4_fwd.cu's). Bound by bytes; copies
// are cp.async words of 8 bytes for D = 36 bfloat16 (see msda_common.cuh).
#include "msda_common.cuh"

using namespace msda;

// Shared memory: [value chunk: `chunk_bytes`][out tile: TQ * D f32]
// [x, y, attn: 3 * TQ * P f32][reduction: 128 f32][query index: TQ int].
// value_l (N, H*W, M*D) in T; loc (N, Lq, M, P, 2) f32; attn (N, Lq, M, P)
// f32; perm (N, Lq) int64; out (N, Lq, M*D) f32; windows
// (N, ceil(Lq / TQ), 4) int32 or null: each tile's [row lo, row hi, xstart,
// fits] (row lo > row hi: empty band).
// gridDim = (M, ceil(Lq / TQ), N).
template <typename T, int WORD>
__global__ void msda_dense_v3_fwd_kernel(
    const T* __restrict__ value_l, const float* __restrict__ loc,
    const float* __restrict__ attn, const long long* __restrict__ perm,
    float* __restrict__ out, int* __restrict__ windows, int h, int w, int lq,
    int m, int p, int d, int tq, int cw, int rows_window, int rows_full,
    int chunk_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* vs = reinterpret_cast<T*>(smem);
  float* out_s = reinterpret_cast<float*>(smem + chunk_bytes);
  float* qx = out_s + (size_t)tq * d;
  float* qy = qx + (size_t)tq * p;
  float* qa = qy + (size_t)tq * p;
  float* red = qa + (size_t)tq * p;
  int* qidx = reinterpret_cast<int*>(red + 128);

  const int head = blockIdx.x;
  const int tile = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int md = m * d;
  const int q_begin = tile * tq;
  const int nq = min(tq, lq - q_begin);

  for (int j = tid; j < nq; j += nthreads)
    qidx[j] = (int)perm[(size_t)n * lq + q_begin + j];
  for (int i = tid; i < nq * d; i += nthreads) out_s[i] = 0.f;
  __syncthreads();
  float xmin, xmax, ymin, ymax;
  load_tile_samples(loc, attn, qidx, n, lq, m, p, h, w, head, nq, 1, 0, qx,
                    qy, qa, red, xmin, xmax, ymin, ymax);
  const int r_lo = max(0, (int)floorf(ymin) - 1);
  const int r_hi = min(h - 1, (int)floorf(ymax) + 1);
  const int left = max(0, (int)floorf(xmin));
  const int right = min(w - 1, (int)floorf(xmax) + 1);
  const int fits = right - left + 1 <= cw;
  const int xstart = fits ? min(left, w - cw) : 0;
  if (windows != nullptr && head == 0 && tid == 0) {
    int* o = windows + 4 * ((size_t)n * gridDim.y + tile);
    o[0] = r_lo;
    o[1] = r_hi;
    o[2] = xstart;
    o[3] = fits;
  }

  const int c0 = xstart;
  const int c1 = fits ? xstart + cw : w;
  const int rows = fits ? rows_window : rows_full;
  const T* level = value_l + (size_t)n * h * w * md + head * d;
  for (int r0 = r_lo; r0 <= r_hi; r0 += rows) {
    const int r1 = min(r0 + rows, r_hi + 1);
    __syncthreads();  // the previous chunk is consumed
    stage_window<T, WORD>(vs, level, w, md, d, r0, r1, c0, c1, tid, nthreads);
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();
    for (int i = tid; i < nq * d; i += nthreads) {
      const int ql = i / d;
      const int c = i - ql * d;
      out_s[i] += window_sum(vs + c, d, r0, r1, c0, c1, qx + ql * p,
                             qy + ql * p, qa + ql * p, p);
    }
  }

  for (int i = tid; i < nq * d; i += nthreads) {
    const int ql = i / d;
    const int c = i - ql * d;
    out[((size_t)n * lq + qidx[ql]) * md + head * d + c] = out_s[i];
  }
}

template <typename T, int WORD>
static int launch_v3(const void* value_l, const void* loc, const void* attn,
                     const void* perm, void* out, void* windows, int n, int h,
                     int w, int lq, int m, int p, int d, int tq, int cw,
                     int rows_window, int rows_full, int chunk_bytes,
                     size_t smem_bytes, int threads, cudaStream_t st) {
  auto kernel = msda_dense_v3_fwd_kernel<T, WORD>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(m, (lq + tq - 1) / tq, n);
  kernel<<<grid, threads, smem_bytes, st>>>(
      static_cast<const T*>(value_l), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const long long*>(perm),
      static_cast<float*>(out), static_cast<int*>(windows), h, w, lq, m, p, d,
      tq, cw, rows_window, rows_full, chunk_bytes);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes. `cw` is the window width in
// columns (clipped to W here); `windows` may be null; `chunk_budget_bytes`
// is the shared memory to spend on staged rows (at least one row is always
// staged). Launches on `stream` and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int msda_dense_v3_fwd(const void* value_l, const void* loc,
                                 const void* attn, const void* perm,
                                 void* out, void* windows, int n, int h, int w,
                                 int lq, int m, int p, int d,
                                 int value_is_bf16, int tq, int cw,
                                 int chunk_budget_bytes, int threads,
                                 void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || lq < 0 || m < 1 || m > 65535 ||
      p < 1 || d < 1 || tq < 1 || cw < 1 || perm == nullptr || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (lq == 0) return (int)cudaGetLastError();
  if ((lq + tq - 1) / tq > 65535) return (int)cudaErrorInvalidValue;
  const int es = value_is_bf16 ? 2 : 4;
  if (cw > w) cw = w;
  const size_t full_row = (size_t)w * d * es, win_row = (size_t)cw * d * es;
  if (full_row > 160 * 1024) return (int)cudaErrorInvalidValue;
  int rows_full = (int)((size_t)chunk_budget_bytes / full_row);
  rows_full = rows_full < 1 ? 1 : (rows_full > h ? h : rows_full);
  int rows_window = (int)((size_t)chunk_budget_bytes / win_row);
  rows_window = rows_window < 1 ? 1 : (rows_window > h ? h : rows_window);
  size_t chunk = rows_full * full_row;
  if (rows_window * win_row > chunk) chunk = rows_window * win_row;
  const int chunk_bytes = (int)((chunk + 15) / 16 * 16);
  const size_t smem_bytes =
      (size_t)chunk_bytes +
      sizeof(float) * ((size_t)tq * d + 3 * (size_t)tq * p + 128) +
      sizeof(int) * (size_t)tq;
  if (smem_bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int word = staging_word(value_l, m, d, es);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define V3_LAUNCH(T, WORD)                                                    \
  return launch_v3<T, WORD>(value_l, loc, attn, perm, out, windows, n, h, w, \
                            lq, m, p, d, tq, cw, rows_window, rows_full,     \
                            chunk_bytes, smem_bytes, threads, st)
  if (value_is_bf16) {
    if (word == 16) V3_LAUNCH(__nv_bfloat16, 16);
    if (word == 8) V3_LAUNCH(__nv_bfloat16, 8);
    if (word == 4) V3_LAUNCH(__nv_bfloat16, 4);
    V3_LAUNCH(__nv_bfloat16, 2);
  }
  if (word == 16) V3_LAUNCH(float, 16);
  if (word == 8) V3_LAUNCH(float, 8);
  V3_LAUNCH(float, 4);
#undef V3_LAUNCH
}
