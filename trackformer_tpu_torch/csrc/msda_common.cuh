// Device helpers shared by the tile-walking MSDA forward kernels
// (msda_dense_v4_fwd.cu, msda_dense_v3_fwd.cu, msda_patch_v6_fwd.cu,
// msda_gather_rows_fwd.cu) and the MSDA backward (msda_bwd.cu: to_f32,
// cell_coord). Only __device__ code and small host helpers; the
// build key of a source that includes this header hashes it too
// (ops/cuda_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <float.h>
#include <stddef.h>
#include <stdint.h>

namespace msda {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Cell coordinate of a normalized location: loc * size - 0.5 as a product
// and a difference rounded one after the other (no fused multiply-add), so
// that floor() finds the cell the plain version finds for a sample on a
// cell border. Clamped to [-2, size + 1]: the int conversions stay defined
// for any input and every in-range corner is left as it was.
__device__ __forceinline__ float cell_coord(float loc, int size) {
  return fminf(fmaxf(__fsub_rn(__fmul_rn(loc, (float)size), 0.5f), -2.f),
               (float)size + 1.f);
}

// ---- asynchronous global -> shared copies (cp.async, Ampere and later) ----

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most `pending` of this thread's committed groups are in
// flight (the instruction takes an immediate).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// Stages one head's slice of a rectangle of cells, rows [r0, r1) x columns
// [c0, c1) of an (H, W) level stored as (H * W, M * D), into shared memory
// as (r1 - r0, c1 - c0, D), with cp.async in words of WORD bytes. `level`
// points at the level's first cell of this item, already offset to the
// head's first channel. WORD must divide D * sizeof(T) and the addresses
// (the entry points pick it so). The caller commits and waits.
template <typename T, int WORD>
__device__ __forceinline__ void stage_window_async(
    T* dst, const T* level, int w, int md, int d, int r0, int r1, int c0,
    int c1, int tid, int nthreads) {
  const int wpc = d * (int)sizeof(T) / WORD;  // words per cell
  const int cols = c1 - c0;
  const int words = (r1 - r0) * cols * wpc;
  unsigned char* out = reinterpret_cast<unsigned char*>(dst);
  for (int i = tid; i < words; i += nthreads) {
    const int cell = i / wpc;
    const int u = i - cell * wpc;
    const int r = cell / cols;
    const int c = cell - r * cols;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        level + ((size_t)(r0 + r) * w + c0 + c) * md);
    cp_async<WORD>(out + (size_t)i * WORD, src + (size_t)u * WORD);
  }
}

// The same copy with plain loads of single elements, for a layout that no
// cp.async word fits (2-byte alignment).
template <typename T>
__device__ __forceinline__ void stage_window_sync(
    T* dst, const T* level, int w, int md, int d, int r0, int r1, int c0,
    int c1, int tid, int nthreads) {
  const int cols = c1 - c0;
  const int elems = (r1 - r0) * cols * d;
  for (int i = tid; i < elems; i += nthreads) {
    const int cell = i / d;
    const int u = i - cell * d;
    const int r = cell / cols;
    const int c = cell - r * cols;
    dst[i] = level[((size_t)(r0 + r) * w + c0 + c) * md + u];
  }
}

template <typename T, int WORD>
__device__ __forceinline__ void stage_window(
    T* dst, const T* level, int w, int md, int d, int r0, int r1, int c0,
    int c1, int tid, int nthreads) {
  if constexpr (WORD >= 4)
    stage_window_async<T, WORD>(dst, level, w, md, d, r0, r1, c0, c1, tid,
                                nthreads);
  else
    stage_window_sync<T>(dst, level, w, md, d, r0, r1, c0, c1, tid,
                         nthreads);
}

// One channel's sum over a query's `p` points of the bilinear corners that
// lie inside the staged window rows [r0, r1) x columns [c0, c1) (and so
// inside the level). `win` is the window as (r1 - r0, c1 - c0, D), already
// offset to the channel; qx, qy, qa are the query's points in cell
// coordinates with their weights. Every cell belongs to one window of a
// walk, so a support that straddles two windows is summed once per corner.
template <typename T>
__device__ __forceinline__ float window_sum(const T* win, int d, int r0,
                                            int r1, int c0, int c1,
                                            const float* qx, const float* qy,
                                            const float* qa, int p) {
  const int cols = c1 - c0;
  float acc = 0.f;
  for (int pt = 0; pt < p; ++pt) {
    const float y = qy[pt];
    const int y0 = (int)floorf(y);
    if (y0 + 1 < r0 || y0 >= r1) continue;
    const float x = qx[pt];
    const int x0 = (int)floorf(x);
    if (x0 + 1 < c0 || x0 >= c1) continue;
    const float a = qa[pt];
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      const int ry = y0 + cy;
      if (ry < r0 || ry >= r1) continue;
      const float wy = a * (1.f - fabsf(y - (float)ry));
      const T* row = win + (size_t)(ry - r0) * cols * d;
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int rx = x0 + cx;
        if (rx < c0 || rx >= c1) continue;
        acc += wy * (1.f - fabsf(x - (float)rx)) *
               to_f32(row[(size_t)(rx - c0) * d]);
      }
    }
  }
  return acc;
}

// Block-wide minimum and maximum of two values per thread; `red` holds 128
// floats of shared memory. Every thread gets the results. One barrier
// inside; the caller must not reuse `red` before its next barrier.
__device__ __forceinline__ void block_min_max2(float& amin, float& amax,
                                               float& bmin, float& bmax,
                                               float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amin = fminf(amin, __shfl_xor_sync(0xffffffffu, amin, off));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    bmin = fminf(bmin, __shfl_xor_sync(0xffffffffu, bmin, off));
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
  }
  const int tid = threadIdx.x;
  const int nwarps = (blockDim.x + 31) >> 5;
  if ((tid & 31) == 0) {
    red[tid >> 5] = amin;
    red[32 + (tid >> 5)] = amax;
    red[64 + (tid >> 5)] = bmin;
    red[96 + (tid >> 5)] = bmax;
  }
  __syncthreads();
  for (int i = 0; i < nwarps; ++i) {
    amin = fminf(amin, red[i]);
    amax = fmaxf(amax, red[32 + i]);
    bmin = fminf(bmin, red[64 + i]);
    bmax = fmaxf(bmax, red[96 + i]);
  }
}

// Loads one head's samples of a tile of `nq` queries of one level into
// shared memory (qx, qy, qa as (nq, P), cell coordinates and weights) and
// reduces the tile's min / max x and y over ALL heads and points. loc is
// (N, Lq, M, P, 2) and attn (N, Lq, M, P) of that level, or with
// `lstride` > 1 one level `lvl` of (N, Lq, M, L, P, 2) / (N, Lq, M, L, P).
// `qidx` (shared, nq ints) names each tile slot's query. One barrier
// inside.
__device__ __forceinline__ void load_tile_samples(
    const float* __restrict__ loc, const float* __restrict__ attn,
    const int* qidx, int n, int lq, int m, int p, int h, int w, int head,
    int nq, int lstride, int lvl, float* qx, float* qy, float* qa, float* red,
    float& xmin, float& xmax, float& ymin, float& ymax) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int mp = m * p;
  xmin = ymin = FLT_MAX;
  xmax = ymax = -FLT_MAX;
  for (int i = tid; i < nq * mp; i += nthreads) {
    const int ql = i / mp;
    const int rem = i - ql * mp;
    const int hd = rem / p;
    const int pt = rem - hd * p;
    const size_t k =
        ((((size_t)n * lq + qidx[ql]) * m + hd) * lstride + lvl) * p + pt;
    const float x = cell_coord(__ldg(loc + 2 * k), w);
    const float y = cell_coord(__ldg(loc + 2 * k + 1), h);
    xmin = fminf(xmin, x);
    xmax = fmaxf(xmax, x);
    ymin = fminf(ymin, y);
    ymax = fmaxf(ymax, y);
    if (hd == head) {
      qx[ql * p + pt] = x;
      qy[ql * p + pt] = y;
      qa[ql * p + pt] = __ldg(attn + k);
    }
  }
  block_min_max2(xmin, xmax, ymin, ymax, red);
}

// Widest word of {16, 8, 4, 2 (bf16) or 4 (f32)} bytes that every head's
// slice of every cell is aligned to.
static inline int staging_word(const void* base, int m, int d, int es) {
  const size_t slice = (size_t)d * es, stride = (size_t)m * d * es;
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  int word = 16;
  while (word > es &&
         (slice % word != 0 || stride % word != 0 || b % word != 0))
    word /= 2;
  return word;
}

}  // namespace msda
