// Multi-scale deformable attention as a weighted gather of precomputed
// rows, for Hopper (sm_90a): the corner build and the gather.
//
// Replaces trackformer_tpu/ops/msda_pallas.py::_msda_kernel (public
// ms_deform_attn_pallas; no route of ms_deform_attn calls it):
//
//   out[n, q, m, :] = sum_k w[b, q, k] * value[n, idx[b, q, k], m, :],
//
// b = n * M + m, K = levels * points * 4 corners in (level, point, corner)
// order. The corner build (msda_corners_fwd) makes idx (int32) and the
// folded weights w (float32: bilinear weight * in-bounds mask * attention
// weight) in that layout from the locations and weights, with the JAX
// wrapper's arithmetic (_corner_indices_weights); the gather
// (msda_gather_rows_fwd) reads the (N, S, M, D) value where it lies, in its
// own dtype (bf16 widened in registers is exact, as the TPU wrapper's
// astype(float32)), sums in float32 and writes the value dtype.
//
// The TPU kernel runs one program per (item, head) with the whole table in
// VMEM and serializes the K dynamic row slices of a query on the sublane
// port. This card gathers natively; what bounds it here: at the encoder
// call (K = 64, 8 heads, D = 36) the compulsory bytes are 8 per corner of
// index and weight plus the touched rows and the output, but the kernel
// reads 11.4 M rows of 72 bytes (bf16), each named by ~64 corners, and a
// row is too narrow for 16-byte words. The design:
//  * lanes over (corner, word), not over channels: a head row is `words`
//    words of 16, 8, 4 or 2 bytes (the host's plan, gather_plan: the widest
//    that divides the row and the value pointer's alignment); G groups of
//    `words` lanes, lane (g, j) loading word j of its group's rows, so one
//    load instruction of the warp reads G rows (D = 36 bf16: nine 8-byte
//    words, three rows in 27 lanes); each lane keeps float32 sums of its
//    word's elements. A row of more than 32 words takes passes of 32;
//  * a warp takes Q consecutive queries of one (item, head), and a block
//    `warps` such warps side by side, so that the rows neighbouring queries
//    share (the encoder's queries are tokens in level order) are L1 hits.
//    Q = G when the call fills the card that way: each group sums one
//    query's corners in order, the JAX kernel's order. Otherwise (the
//    decoder's 650 queries) Q = 1: the G groups split the query's corners
//    into chunks of a multiple of 4 and one shuffle reduction adds them, a
//    channel's sum being ((s_0 + s_1) + ...) + s_{G-1}, s_g the fused
//    multiply-add chain over chunk g in order;
//  * the index stream, 73 % of the bound's bytes, comes in 16-byte
//    cp.async copies that bypass L1 (it is read once; L1 is kept for the
//    rows) into the warp's buffer in shared memory, whose wait the other
//    warps' gathers hide.
// Measured (PERF.md, section 6): with every corner on one row the kernel is
// barely faster than on the real call, so misses do not bound it; the L1
// does, between two costs: every lane of a row's group receives the
// corner's index and weight, and a load instruction touches the lines of
// its G rows. Fewer lanes a row (several words a lane) cut the first and
// raised the second, and were slower.
// TMA is of no use: rows are gathered one at a time, and every other
// 72-byte bf16 head row starts 8 bytes off a 16-byte boundary.
//
// The corner build: one thread per (item * head, query, level, point)
// sample, in the output's order, so that each thread writes its four
// corners' indices and weights as one 16-byte store each. It rounds as the
// plain version does (corner_operands_plain): no fused multiply-add
// (__fmul_rn / __fsub_rn), and for bf16 locations a round to bf16 after
// every step, the level size rounded to bf16 first as JAX converts a
// Python int; the last product in float32 where either operand is float32
// (JAX's promotion). Bit for bit equal to the plain version for every
// location whose cell coordinate lies within +-2^63, where the plain
// version's int64 conversion is defined.
#include "msda_common.cuh"

namespace {

constexpr int kMaxLevels = 64;

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One step of the corner arithmetic in the locations' dtype: float32
// results are kept, bf16 results rounded to bf16.
template <bool BF16>
__device__ __forceinline__ float step(float v) {
  return BF16 ? round_bf16(v) : v;
}

// x0 (the cell to the left or above) and the fraction dx of one coordinate
// of a normalized location on a level of `size` cells: x = loc * size -
// 0.5 as a product and a difference rounded one after the other.
template <bool BF16>
__device__ __forceinline__ void coord(float loc, int size, int& x0, float& dx) {
  const float sz = BF16 ? round_bf16((float)size) : (float)size;
  const float x = step<BF16>(__fsub_rn(step<BF16>(__fmul_rn(loc, sz)), 0.5f));
  const float fl = floorf(x);
  dx = step<BF16>(__fsub_rn(x, fl));
  // clamped for the int conversion: every corner of a coordinate beyond
  // [-2, size + 1] is out of range and clipped to the same index either way
  x0 = (int)fminf(fmaxf(fl, -2.f), (float)size + 1.f);
}

template <typename TL, typename TA>
__global__ void __launch_bounds__(256)
    corners_kernel(const TL* __restrict__ loc, const TA* __restrict__ attn,
                   int4* __restrict__ idx, float4* __restrict__ wout,
                   const Levels lv, int n, int lq, int m, int l, int p) {
  constexpr bool kLocBf16 = sizeof(TL) == 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)n * m * lq * l * p;
  if (t >= total) return;
  // t in the output's order: ((b * lq + q) * l + lvl) * p + pt
  const int pt = (int)(t % p);
  long long r = t / p;
  const int lvl = (int)(r % l);
  r /= l;
  const int q = (int)(r % lq);
  const int b = (int)(r / lq);
  const int ni = b / m, mi = b % m;
  const long long sample =
      ((((long long)ni * lq + q) * m + mi) * l + lvl) * p + pt;
  const int h = lv.h[lvl], w = lv.w[lvl];
  int x0, y0;
  float dx, dy;
  coord<kLocBf16>(msda::to_f32(loc[2 * sample]), w, x0, dx);
  coord<kLocBf16>(msda::to_f32(loc[2 * sample + 1]), h, y0, dy);
  const float a = msda::to_f32(attn[sample]);
  const float wx[2] = {step<kLocBf16>(__fsub_rn(1.f, dx)), dx};
  const float wy[2] = {step<kLocBf16>(__fsub_rn(1.f, dy)), dy};
  int ci[4];
  float cw[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // (0, 0), (1, 0), (0, 1), (1, 1)
    const int cx = c & 1, cy = c >> 1;
    const int ix = x0 + cx, iy = y0 + cy;
    const bool valid = ix >= 0 && ix < w && iy >= 0 && iy < h;
    ci[c] = lv.start[lvl] + min(max(iy, 0), h - 1) * w +
            min(max(ix, 0), w - 1);
    float v = step<kLocBf16>(__fmul_rn(wx[cx], wy[cy]));
    v = step<kLocBf16>(__fmul_rn(v, valid ? 1.f : 0.f));
    v = __fmul_rn(v, a);
    // both bf16: the product is bf16 (exact in float32, rounded once)
    cw[c] = (kLocBf16 && sizeof(TA) == 2) ? round_bf16(v) : v;
  }
  idx[t] = make_int4(ci[0], ci[1], ci[2], ci[3]);
  wout[t] = make_float4(cw[0], cw[1], cw[2], cw[3]);
}

// ---- the gather ----

// 16-byte copy global -> shared that skips L1: the index stream is read
// once, and L1 is kept for the rows
__device__ __forceinline__ void cp_async_cg16(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// A word of WB bytes as 32-bit units (a 2-byte word in the low half of one)
template <int WB>
struct Word {
  static constexpr int kUnits = WB >= 4 ? WB / 4 : 1;
  unsigned u[kUnits];
  __device__ __forceinline__ void load(const void* p) {
    if constexpr (WB == 16) {
      const uint4 v = __ldg(static_cast<const uint4*>(p));
      u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
    } else if constexpr (WB == 8) {
      const uint2 v = __ldg(static_cast<const uint2*>(p));
      u[0] = v.x, u[1] = v.y;
    } else if constexpr (WB == 4) {
      u[0] = __ldg(static_cast<const unsigned*>(p));
    } else {
      u[0] = __ldg(static_cast<const unsigned short*>(p));
    }
  }
  __device__ __forceinline__ void store(void* p) const {
    if constexpr (WB == 16) {
      *static_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    } else if constexpr (WB == 8) {
      *static_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else if constexpr (WB == 4) {
      *static_cast<unsigned*>(p) = u[0];
    } else {
      *static_cast<unsigned short*>(p) = (unsigned short)u[0];
    }
  }
};

// element e of a word of V elements, widened to float32 (exact)
template <typename V, int WB>
__device__ __forceinline__ float element(const Word<WB>& w, int e) {
  if constexpr (sizeof(V) == 4) {
    return __uint_as_float(w.u[e]);
  } else {
    const unsigned v = w.u[e >> 1];
    return __uint_as_float((e & 1) ? (v & 0xffff0000u) : (v << 16));
  }
}

template <typename V, int WB>
__device__ __forceinline__ void pack(Word<WB>& w, const float* f) {
  constexpr int E = WB / (int)sizeof(V);
  if constexpr (sizeof(V) == 4) {
#pragma unroll
    for (int e = 0; e < E; ++e) w.u[e] = __float_as_uint(f[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[e]));
      const unsigned hi =
          e + 1 < E ? __bfloat16_as_ushort(__float2bfloat16_rn(f[e + 1])) : 0u;
      w.u[e >> 1] = lo | (hi << 16);
    }
  }
}

// idx, w (B, Lq, K) int32 / f32, B = N * M; value (N, S, M, D) and out
// (N, Lq, M, D) of V. blockDim.x = 32 * warps; gridDim = (query tiles, B).
// Warp w of block x takes the Q consecutive queries (x * warps + w) * Q +
// [0, Q); its G lane groups are r = G / Q groups per query, group g on
// query g / r and on corners [(g % r) * chunk, (g % r + 1) * chunk) of it,
// chunk a multiple of 4. Dynamic shared memory: per warp the Q queries' K
// ints + K floats, `stride` bytes apart.
template <typename V, int WB>
__global__ void __launch_bounds__(256)
    gather_rows_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                       const V* __restrict__ value, V* __restrict__ out, int s,
                       int m, int lq, int k, int d, int qstep, int chunk,
                       int passes) {
  constexpr int E = WB / (int)sizeof(V);
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * warps + warp) * qstep;
  if (q0 >= lq) return;  // whole warps leave: no barrier follows
  const int words = d / E;
  const int lanes = min(words, 32);
  const int g = lane / lanes, jl = lane % lanes;
  const int groups = 32 / lanes, r = groups / qstep;
  const int gq = g / r, gc = g - gq * r;  // query of the warp, chunk
  const int b = blockIdx.y, ni = b / m, mi = b % m;
  const long long md = (long long)m * d;  // elements from cell to cell
  const unsigned row_bytes = (unsigned)(md * (long long)sizeof(V));
  const V* table = value + ((long long)ni * s * m + mi) * d;
  V* out_b = out + ((long long)ni * lq * m + mi) * d;
  // a query's buffer: K ints, K floats, 16 bytes more so that the groups'
  // reads of their queries fall in different banks
  const int stride = 8 * k + 16;
  unsigned char* buf = smem + (size_t)warp * qstep * stride;

  // the warp's queries' indices and weights, 16 bytes a copy (K is a
  // multiple of 4)
  for (int qq = 0; qq < qstep && q0 + qq < lq; ++qq) {
    const long long row = ((long long)b * lq + q0 + qq) * k;
    for (int v = lane; v < k / 2; v += 32) {
      const void* src = v < k / 4 ? (const void*)(idx + row + 4 * v)
                                  : (const void*)(w + row + 4 * (v - k / 4));
      cp_async_cg16(buf + qq * stride + 16 * v, src);
    }
  }
  msda::cp_async_commit();
  msda::cp_async_wait(0);
  __syncwarp();

  const int q = q0 + gq;
  const int* si = reinterpret_cast<const int*>(buf + gq * stride);
  const float* sw = reinterpret_cast<const float*>(si + k);
  const int c_lo = min(k, gc * chunk), c_hi = min(k, c_lo + chunk);
  for (int pass = 0; pass < passes; ++pass) {
    const int j = jl + pass * lanes;
    const bool on = g < groups && j < words && q < lq;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    if (on) {
      const unsigned char* col =
          reinterpret_cast<const unsigned char*>(table + (long long)j * E);
#pragma unroll 2
      for (int c = c_lo; c < c_hi; c += 4) {
        // four 4-byte reads each, not one 16-byte read: faster at the
        // encoder call (PERF.md, section 6)
        const int4 r4 = make_int4(si[c], si[c + 1], si[c + 2], si[c + 3]);
        const float4 w4 = make_float4(sw[c], sw[c + 1], sw[c + 2], sw[c + 3]);
        Word<WB> x[4];
        x[0].load(col + (unsigned long long)(unsigned)r4.x * row_bytes);
        x[1].load(col + (unsigned long long)(unsigned)r4.y * row_bytes);
        x[2].load(col + (unsigned long long)(unsigned)r4.z * row_bytes);
        x[3].load(col + (unsigned long long)(unsigned)r4.w * row_bytes);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acc[e] = fmaf(w4.x, element<V, WB>(x[0], e), acc[e]);
          acc[e] = fmaf(w4.y, element<V, WB>(x[1], e), acc[e]);
          acc[e] = fmaf(w4.z, element<V, WB>(x[2], e), acc[e]);
          acc[e] = fmaf(w4.w, element<V, WB>(x[3], e), acc[e]);
        }
      }
    }
    // the first group of a query adds its other groups' sums, in order
    for (int rr = 1; rr < r; ++rr) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float o = __shfl_down_sync(0xffffffffu, acc[e], rr * lanes);
        if (gc == 0) acc[e] += o;
      }
    }
    if (on && gc == 0) {
      Word<WB> word;
      pack<V, WB>(word, acc);
      word.store(out_b + q * md + (long long)j * E);
    }
  }
}

template <typename V, int WB>
cudaError_t launch_gather(const void* idx, const void* w, const void* value,
                          void* out, int b, int s, int m, int lq, int k, int d,
                          int qstep, int chunk, int passes, int warps,
                          int smem_bytes, int grid_x, cudaStream_t stream) {
  const dim3 grid(grid_x, b);
  gather_rows_kernel<V, WB><<<grid, 32 * warps, smem_bytes, stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const V*>(value), static_cast<V*>(out), s, m, lq, k, d,
      qstep, chunk, passes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments it does not take.

// loc (N, Lq, M, L, P, 2), attn (N, Lq, M, L, P), each float32 or bf16 (the
// flags); hw the L levels' (H, W); idx, w (N * M, Lq, L * P * 4) int32 /
// float32, 16-byte aligned.
extern "C" int msda_corners_fwd(const void* loc, const void* attn, void* idx,
                                void* w, int n, int lq, int m, int l, int p,
                                const int* hw, int loc_bf16, int attn_bf16,
                                void* stream) {
  if (n < 1 || lq < 0 || m < 1 || l < 1 || l > kMaxLevels || p < 1 ||
      (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  int start = 0;
  for (int i = 0; i < l; ++i) {
    lv.h[i] = hw[2 * i], lv.w[i] = hw[2 * i + 1], lv.start[i] = start;
    if (lv.h[i] < 1 || lv.w[i] < 1) return (int)cudaErrorInvalidValue;
    start += lv.h[i] * lv.w[i];
  }
  const long long total = (long long)n * m * lq * l * p;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CORNERS(TL, TA)                                                     \
  corners_kernel<TL, TA><<<(unsigned)blocks, threads, 0, st>>>(             \
      static_cast<const TL*>(loc), static_cast<const TA*>(attn),            \
      static_cast<int4*>(idx), static_cast<float4*>(w), lv, n, lq, m, l, p)
  if (loc_bf16 && attn_bf16) CORNERS(__nv_bfloat16, __nv_bfloat16);
  else if (loc_bf16) CORNERS(__nv_bfloat16, float);
  else if (attn_bf16) CORNERS(float, __nv_bfloat16);
  else CORNERS(float, float);
#undef CORNERS
  return (int)cudaGetLastError();
}

// idx, w (N * M, Lq, K) int32 / float32, 16-byte aligned, K a multiple of
// 4, indices in [0, S); value (N, S, M, D) and out (N, Lq, M, D), float32
// or bf16 (value_bf16); the plan's word, queries a warp, corners a lane
// group, passes, warps a block, shared bytes and query tiles, which the
// entry point checks against the row, the pointers and the queries.
extern "C" int msda_gather_rows_fwd(const void* idx, const void* w,
                                    const void* value, void* out, int n, int s,
                                    int m, int lq, int k, int d, int value_bf16,
                                    int word, int qstep, int chunk, int passes,
                                    int warps, int smem_bytes, int grid_x,
                                    void* stream) {
  const int es = value_bf16 ? 2 : 4;
  const long long b = (long long)n * m;
  if (n < 1 || m < 1 || b > 65535 || s < 1 || lq < 0 || k < 4 || k % 4 ||
      d < 1 || warps < 1 || warps > 8 || grid_x < 1)
    return (int)cudaErrorInvalidValue;
  if (!(word == 16 || word == 8 || word == 4 || word == 2) || word < es ||
      (d * es) % word ||
      (reinterpret_cast<uintptr_t>(value) | reinterpret_cast<uintptr_t>(out)) %
          word ||
      (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorInvalidValue;
  const int words = d * es / word, lanes = words < 32 ? words : 32;
  const int groups = 32 / lanes;
  if (qstep < 1 || groups % qstep) return (int)cudaErrorInvalidValue;
  const int per_group = (k + groups / qstep - 1) / (groups / qstep);
  if (chunk != (per_group + 3) / 4 * 4 ||
      passes != (words + lanes - 1) / lanes ||
      smem_bytes != warps * qstep * (8 * k + 16) || smem_bytes > 48 * 1024 ||
      (long long)grid_x * warps * qstep < lq)
    return (int)cudaErrorInvalidValue;
  if (lq == 0) return (int)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
#define GATHER(V, WB)                                                       \
  rc = launch_gather<V, WB>(idx, w, value, out, (int)b, s, m, lq, k, d,     \
                            qstep, chunk, passes, warps, smem_bytes, grid_x, \
                            st)
  if (value_bf16) {
    switch (word) {
      case 16: GATHER(__nv_bfloat16, 16); break;
      case 8: GATHER(__nv_bfloat16, 8); break;
      case 4: GATHER(__nv_bfloat16, 4); break;
      default: GATHER(__nv_bfloat16, 2); break;
    }
  } else {
    switch (word) {
      case 16: GATHER(float, 16); break;
      case 8: GATHER(float, 8); break;
      default: GATHER(float, 4); break;
    }
  }
#undef GATHER
  return (int)rc;
}
