// One level of multi-scale deformable attention as a walk over each query
// tile's own rectangle of cells, for Hopper (sm_90a).
//
// Replaces trackformer_tpu/ops/msda_dense.py::_kernel_v4 (reached through
// _dense_level_pallas_v4_fwd: dense_level_pallas_v4 and
// dense_level_pallas_v4p; routes PALLAS_SKIP_IMPL="v4" and MSDA_DEC_SKIP=1):
//
//   out[n, q, m, :] = sum_p attn[n, q, m, p] * sum_{r, c} hat(y_p - r)
//                     * hat(x_p - c) * value[n, r * W + c, m, :],
//   hat(t) = max(0, 1 - |t|),  x = loc_x * W - 0.5,  y = loc_y * H - 0.5.
//
// The TPU kernel grids over (item, q-tile) only. A tile of TQ queries, taken
// in the order of an optional permutation `perm` (a spatial sort), meets
// only the rows floor(min y) - 1 .. floor(max y) + 1 and the columns
// floor(min x) .. floor(max x) + 1 of the level (min / max over the tile's
// heads and points, clipped into the level); it walks that row range with
// hand-written double-buffered DMA and, per row tile, the range of CW-wide
// column chunks. Every cell column belongs to exactly one chunk, so a
// bilinear support that straddles two chunks is summed once per corner.
// Rows and columns outside the ranges are never read.
//
// What differs on this card. The TPU kernel stages all heads of a value
// tile (2 x 1024 x 384 bf16 = 1.5 MB of VMEM); a block here has 227 KB, so a
// block serves ONE head of a tile (grid = head x q-tile x item, heads
// fastest so the blocks that read neighbouring slices of the same cells run
// together) and stages that head's slice of a window of `rows_per_stage`
// rows x at most CW columns. The dense hat tile times values on the matrix
// unit becomes a walk of each point's 2 x 2 support in shared memory. The
// tile's ranges are reduced by the kernel itself from the samples it loads
// (the TPU wrapper computes them outside and prefetches them as scalars);
// the range arithmetic is rounded in two steps so that it equals the plain
// version's (ops/msda_dense.py: v4_ranges). The permutation is applied by
// index (loc / attn read at perm[q], out written at perm[q]): no sorted
// copies and no unsort pass. Chunks are clipped to the occupied columns.
//
// What bounds it: bytes (each sampled channel costs about 10 flops against
// a value read). Copies are asynchronous (cp.async, two stages in flight:
// the next window loads while this one is summed) in the widest word a
// head's D channels align to: 8 bytes for D = 36 bfloat16, since a head's
// row of 72 bytes at offset cell * 576 + m * 72 is never 16-byte aligned,
// which also rules out TMA on this layout.
#include "msda_common.cuh"

using namespace msda;

// Shared memory: [2 stages of `stage_bytes`][out tile: TQ * D f32]
// [x, y, attn: 3 * TQ * P f32][reduction: 128 f32][query index: TQ int].
// value_l (N, H*W, M*D) in T; loc (N, Lq, M, P, 2) f32; attn (N, Lq, M, P)
// f32; perm (N, Lq) int64 or null; out (N, Lq, M*D) f32; ranges
// (N, ceil(Lq / TQ), 4) int32 or null: each tile's inclusive [row lo, row
// hi, column lo, column hi] as walked (row lo > row hi: empty walk).
// cw == 0: no column chunks, every row is walked at full width.
// gridDim = (M, ceil(Lq / TQ), N).
template <typename T, int WORD>
__global__ void msda_dense_v4_fwd_kernel(
    const T* __restrict__ value_l, const float* __restrict__ loc,
    const float* __restrict__ attn, const long long* __restrict__ perm,
    float* __restrict__ out, int* __restrict__ ranges, int h, int w, int lq,
    int m, int p, int d, int tq, int cw, int rows_per_stage,
    int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* out_s = reinterpret_cast<float*>(smem + 2 * (size_t)stage_bytes);
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

  // (1) the tile's queries, this head's samples, the tile's ranges
  for (int j = tid; j < nq; j += nthreads)
    qidx[j] = perm != nullptr ? (int)perm[(size_t)n * lq + q_begin + j]
                              : q_begin + j;
  for (int i = tid; i < nq * d; i += nthreads) out_s[i] = 0.f;
  __syncthreads();
  float xmin, xmax, ymin, ymax;
  load_tile_samples(loc, attn, qidx, n, lq, m, p, h, w, head, nq, 1, 0, qx,
                    qy, qa, red, xmin, xmax, ymin, ymax);
  const int r_lo = min(max((int)floorf(ymin) - 1, 0), h - 1);
  const int r_hi = min((int)floorf(ymax) + 1, h - 1);
  int c_lo = min(max((int)floorf(xmin), 0), w - 1);
  int c_hi = min(max((int)floorf(xmax) + 1, 0), w - 1);
  if (cw == 0) {
    c_lo = 0;
    c_hi = w - 1;
    cw = w;
  }
  if (ranges != nullptr && head == 0 && tid == 0) {
    int* r = ranges + 4 * ((size_t)n * gridDim.y + tile);
    r[0] = r_lo;
    r[1] = r_hi;
    r[2] = c_lo;
    r[3] = c_hi;
  }

  // (2) the walk: column chunks outermost, row stages inside, flattened so
  // that the next window loads while this one is summed
  const int n_rs =
      r_lo <= r_hi ? (r_hi - r_lo + rows_per_stage) / rows_per_stage : 0;
  const int ch_lo = c_lo / cw;
  const int total = n_rs * (c_hi / cw - ch_lo + 1);
  const T* level = value_l + (size_t)n * h * w * md + head * d;

  auto window = [&](int t, int& r0, int& r1, int& c0, int& c1) {
    const int ch = ch_lo + t / n_rs;
    r0 = r_lo + (t % n_rs) * rows_per_stage;
    r1 = min(r0 + rows_per_stage, r_hi + 1);
    c0 = max(ch * cw, c_lo);
    c1 = min((ch + 1) * cw, c_hi + 1);
  };
  auto prefetch = [&](int t) {
    int r0, r1, c0, c1;
    window(t, r0, r1, c0, c1);
    T* dst = reinterpret_cast<T*>(smem + (size_t)(t & 1) * stage_bytes);
    stage_window<T, WORD>(dst, level, w, md, d, r0, r1, c0, c1, tid,
                          nthreads);
  };

  if (total > 0) prefetch(0);
  cp_async_commit();
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) prefetch(t + 1);
    cp_async_commit();
    cp_async_wait(1);  // all but the newest group: window t has landed
    __syncthreads();
    int r0, r1, c0, c1;
    window(t, r0, r1, c0, c1);
    const T* win =
        reinterpret_cast<const T*>(smem + (size_t)(t & 1) * stage_bytes);
    for (int i = tid; i < nq * d; i += nthreads) {
      const int ql = i / d;
      const int c = i - ql * d;
      out_s[i] += window_sum(win + c, d, r0, r1, c0, c1, qx + ql * p,
                             qy + ql * p, qa + ql * p, p);
    }
    __syncthreads();  // window t is consumed before its stage is refilled
  }
  cp_async_wait(0);

  // (3) one write per (query, channel), at the query's own index
  for (int i = tid; i < nq * d; i += nthreads) {
    const int ql = i / d;
    const int c = i - ql * d;
    out[((size_t)n * lq + qidx[ql]) * md + head * d + c] = out_s[i];
  }
}

template <typename T, int WORD>
static int launch_v4(const void* value_l, const void* loc, const void* attn,
                     const void* perm, void* out, void* ranges, int n, int h,
                     int w, int lq, int m, int p, int d, int tq, int cw,
                     int rows, int stage_bytes, size_t smem_bytes,
                     int threads, cudaStream_t st) {
  auto kernel = msda_dense_v4_fwd_kernel<T, WORD>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(m, (lq + tq - 1) / tq, n);
  kernel<<<grid, threads, smem_bytes, st>>>(
      static_cast<const T*>(value_l), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const long long*>(perm),
      static_cast<float*>(out), static_cast<int*>(ranges), h, w, lq, m, p, d,
      tq, cw, rows, stage_bytes);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes. `cw` is the chunk width in
// columns, 0 for a pure row walk at full width; `perm` and `ranges` may be
// null; `stage_budget_bytes` is the shared memory to spend on each of the
// two stages (at least one row of a window is always staged). Launches on
// `stream` and returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int msda_dense_v4_fwd(const void* value_l, const void* loc,
                                 const void* attn, const void* perm,
                                 void* out, void* ranges, int n, int h, int w,
                                 int lq, int m, int p, int d,
                                 int value_is_bf16, int tq, int cw,
                                 int stage_budget_bytes, int threads,
                                 void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || lq < 0 || m < 1 || m > 65535 ||
      p < 1 || d < 1 || tq < 1 || cw < 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (lq == 0) return (int)cudaGetLastError();
  if ((lq + tq - 1) / tq > 65535) return (int)cudaErrorInvalidValue;
  const int es = value_is_bf16 ? 2 : 4;
  const int cols = (cw == 0 || cw > w) ? w : cw;
  const size_t row_bytes = (size_t)cols * d * es;
  if (row_bytes > 96 * 1024) return (int)cudaErrorInvalidValue;
  int rows = (int)((size_t)stage_budget_bytes / row_bytes);
  rows = rows < 1 ? 1 : (rows > h ? h : rows);
  const int stage_bytes = (int)((rows * row_bytes + 15) / 16 * 16);
  const size_t smem_bytes =
      2 * (size_t)stage_bytes +
      sizeof(float) * ((size_t)tq * d + 3 * (size_t)tq * p + 128) +
      sizeof(int) * (size_t)tq;
  if (smem_bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int word = staging_word(value_l, m, d, es);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define V4_LAUNCH(T, WORD)                                                   \
  return launch_v4<T, WORD>(value_l, loc, attn, perm, out, ranges, n, h, w, \
                            lq, m, p, d, tq, cw, rows, stage_bytes,         \
                            smem_bytes, threads, st)
  if (value_is_bf16) {
    if (word == 16) V4_LAUNCH(__nv_bfloat16, 16);
    if (word == 8) V4_LAUNCH(__nv_bfloat16, 8);
    if (word == 4) V4_LAUNCH(__nv_bfloat16, 4);
    V4_LAUNCH(__nv_bfloat16, 2);
  }
  if (word == 16) V4_LAUNCH(float, 16);
  if (word == 8) V4_LAUNCH(float, 8);
  V4_LAUNCH(float, 4);
#undef V4_LAUNCH
}
