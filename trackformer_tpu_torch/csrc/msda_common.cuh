// Device helpers shared by the MSDA kernels: the walk
// (msda_dense_v4_fwd.cu: cell_coord, cp.async, block_min_max2), the gather
// forward (msda_fwd.cu: cell_coord), the MSDA backward (msda_bwd.cu: to_f32,
// cell_coord) and the precomputed-rows gather (msda_gather_rows_fwd.cu).
// Only __device__ code; the build key of a source that includes this header
// hashes it too (ops/cuda_build.py).
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

}  // namespace msda
