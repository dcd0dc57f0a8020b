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
// What bounds it on this card: the number of reduction instructions into
// grad_value, not how often they collide. The first design (a warp per
// query and head, one scalar float32 atomicAdd per channel and corner) sent
// 822.9 M scalar atomics at the training step's encoder call and ran every
// call at 316-358 G atomics/s, whether a cell took 21 hits (level 0) or
// 1,308 (level 3); the bytes (grad_out, value, loc, attn read, grad_value
// read-modify-written, grad_loc and grad_attn written) are a small share.
//
// What this design does about it, both cutting that count:
//  * 16-byte vector reductions. A head's row of D float32 gradients lies at
//    cell * M * D + m * D; when D is a multiple of 4 (and the pointers are
//    aligned) a lane owns 4 consecutive channels and sends them as one
//    float4 atomicAdd on global memory (sm_90): a row of D = 36 is 9
//    operations, not 36. A group of D / 4 consecutive lanes serves one
//    sample, so consecutive lanes send consecutive 16-byte pieces of a row,
//    and a warp serves 32 / (D / 4) samples at once (3 for D = 36). Any other
//    D takes the same layout with one channel per lane and scalar atomics.
//  * Pre-reduction in shared memory. A block serves one (item, head) and a
//    run of queries. For the levels the host's plan picks (ops/msda.py:
//    bwd_plan: the coarse levels, whose head slices fit the block's shared
//    memory and take several hits per cell from one block), the block sums
//    its corner terms in a float32 copy of the head's slice and flushes it
//    once at its end with the vector reductions, skipping pieces that
//    stayed zero. Corners on the other levels go straight to global memory.
//    Each group of lanes takes its own run of the block's samples, so that
//    the block's groups work on many places of a level at once.
// What the card showed (H100 80GB HBM3, 700 W; PERF.md): the training
// step's encoder call takes 1.77 ms in bf16 against 2.29 for the first
// design, each single-level call 0.46-0.49 against 0.64-0.70, with 7.8x
// fewer reductions into global memory. The shared pre-reduction does not
// pay on sm_90: there is no float add on shared memory (atomicAdd there
// compiles to a compare-and-swap loop, here a 128-bit one for a lane's 4
// channels), while a float4 reduction on global memory is one instruction
// that does not wait for an answer. On a single level it breaks even; in
// the encoder call it costs up to 7 % against the same kernel with no
// level planned.
// The per-sample sums for grad_attn and grad_loc are sums over the group's
// lanes by shuffle. All levels of a call run in one launch. grad_value
// accumulates in a float32 buffer that the caller zeroes and casts; the
// order of the atomics changes from run to run, so grad_value differs in
// its last bits between runs.
#include "msda_common.cuh"

#include <stdint.h>

#define MSDA_MAX_LEVELS 16
#define MSDA_BWD_MAX_THREADS 1024
#define MSDA_BWD_MAX_SMEM 232448  // dynamic shared memory a block may use
#define MSDA_BWD_MAX_D 128

struct LevelMeta {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  // float offset of the level's accumulator in shared memory, -1 for none
  int soff[MSDA_MAX_LEVELS];
};

// VW consecutive channels as float32; with VW == 4 `p` is aligned to 4
// elements (16 bytes for float32, 8 for bfloat16).
template <int VW>
__device__ __forceinline__ void load_chunk(const float* p, float* o) {
  if constexpr (VW == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) o[e] = p[e];
  }
}
template <int VW>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* o) {
  if constexpr (VW == 4) {
    // a bfloat16 is the high half of a float32: element 0 is the low half
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(u.x << 16);
    o[1] = __uint_as_float(u.x & 0xffff0000u);
    o[2] = __uint_as_float(u.y << 16);
    o[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) o[e] = msda::to_f32(p[e]);
  }
}

__device__ __forceinline__ unsigned long long pack2(float a, float b) {
  return (unsigned long long)__float_as_uint(a) |
         ((unsigned long long)__float_as_uint(b) << 32);
}
__device__ __forceinline__ float lo_f(unsigned long long v) {
  return __uint_as_float((unsigned)v);
}
__device__ __forceinline__ float hi_f(unsigned long long v) {
  return __uint_as_float((unsigned)(v >> 32));
}

// Adds VW terms to VW consecutive floats of shared memory. sm_90 has no
// float add on shared memory: atomicAdd there is a compare-and-swap loop.
// With VW == 4 the loop swaps all four floats at once (a 128-bit
// compare-and-swap, `p` 16-byte aligned): a quarter of the round trips of
// four scalar loops.
template <int VW>
__device__ __forceinline__ void smem_add(float* p, const float* t) {
  if constexpr (VW == 4) {
    const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
    const float4 first = *reinterpret_cast<const float4*>(p);
    unsigned long long clo = pack2(first.x, first.y);
    unsigned long long chi = pack2(first.z, first.w);
    while (true) {
      const unsigned long long nlo =
          pack2(lo_f(clo) + t[0], hi_f(clo) + t[1]);
      const unsigned long long nhi =
          pack2(lo_f(chi) + t[2], hi_f(chi) + t[3]);
      unsigned long long rlo, rhi;
      asm volatile(
          "{\n\t.reg .b128 c, n, r;\n\t"
          "mov.b128 c, {%2, %3};\n\t"
          "mov.b128 n, {%4, %5};\n\t"
          "atom.shared.cas.b128 r, [%6], c, n;\n\t"
          "mov.b128 {%0, %1}, r;\n\t}"
          : "=l"(rlo), "=l"(rhi)
          : "l"(clo), "l"(chi), "l"(nlo), "l"(nhi), "r"(addr)
          : "memory");
      if (rlo == clo && rhi == chi) break;
      clo = rlo;
      chi = rhi;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) atomicAdd(p + e, t[e]);
  }
}

// One corner's VW terms: into the block's accumulator when the level has
// one (`sdst`), else into grad_value at `gdst`.
template <int VW>
__device__ __forceinline__ void add_corner(float* sdst, float* gdst,
                                           const float* t) {
  if (sdst != nullptr) {
    smem_add<VW>(sdst, t);
  } else if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(gdst),
              make_float4(t[0], t[1], t[2], t[3]));
  } else {
#pragma unroll
    for (int e = 0; e < VW; ++e) atomicAdd(gdst + e, t[e]);
  }
}

// grad_out (N, Lq, M*D) in TG; value (N, S, M*D) in TV; loc
// (N, Lq, M, L, P, 2) f32; attn (N, Lq, M, L, P) f32; grad_value
// (N, S, M*D) f32, zeroed by the caller; grad_loc, grad_attn as loc, attn.
// gridDim = (ceil(Lq / qpb), M, N): a block per run of `qpb` queries of one
// head of one item; blockDim.x a multiple of 32; `smem_floats` floats of
// dynamic shared memory hold the accumulators of the levels with soff >= 0.
template <typename TV, typename TG, int VW>
__global__ void __launch_bounds__(MSDA_BWD_MAX_THREADS)
    msda_bwd_kernel(const TG* __restrict__ grad_out,
                    const TV* __restrict__ value,
                    const float* __restrict__ loc,
                    const float* __restrict__ attn,
                    float* __restrict__ grad_value,
                    float* __restrict__ grad_loc,
                    float* __restrict__ grad_attn, LevelMeta meta, int s,
                    int lq, int m, int l, int p, int d, int qpb,
                    int smem_floats) {
  extern __shared__ float4 smem_f4[];
  float* acc = reinterpret_cast<float*>(smem_f4);
  constexpr int KMAX = VW == 4 ? 1 : MSDA_BWD_MAX_D / 32;  // chunks a lane
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const int q0 = blockIdx.x * qpb;
  const int nq = min(qpb, lq - q0);
  const int md = m * d;
  const int lp = l * p;
  const size_t item = (size_t)n * s * md + (size_t)head * d;
  const TV* v_item = value + item;
  float* gv_item = grad_value + item;

  for (int i = tid; i < smem_floats; i += nthreads) acc[i] = 0.f;
  if (smem_floats > 0) __syncthreads();

  // lanes: groups of `gs` consecutive lanes, one sample per group, lane `ci`
  // of a group owning chunks ci, ci + gs, ... of VW channels
  const int chunks = d / VW;
  const int gs = min(chunks, 32);
  const int groups = 32 / gs;
  const int lane = tid & 31;
  const int group = lane / gs;
  const int ci = lane - group * gs;
  // the block's samples, (query, level, point) in that order; each group
  // takes a run of `per` of them, so that the block's groups work on as
  // many places of a level at once and collide less in shared memory
  const int total = nq * lp;
  const int gid = (tid >> 5) * groups + group;
  const int per = (total + (nthreads >> 5) * groups - 1) /
                  ((nthreads >> 5) * groups);

  for (int i = 0; i < per; ++i) {  // the same count in every lane
    const int t = gid * per + i;
    const bool live = group < groups && t < total;
    float s_attn = 0.f, s_x = 0.f, s_y = 0.f, a = 0.f;
    size_t k = 0;
    int h = 0, w = 0;
    if (live) {
      const int ql = t / lp;
      const int r = t - ql * lp;
      const int lv = r / p;
      const int q = q0 + ql;
      k = (((size_t)n * lq + q) * m + head) * lp + r;
      h = meta.h[lv];
      w = meta.w[lv];
      a = __ldg(attn + k);
      // product, then difference, no fused multiply-add: the location
      // gradient jumps where floor() does, so the cell must be the one the
      // plain version finds; a clamped sample has no corner in range
      const float x = msda::cell_coord(__ldg(loc + 2 * k), w);
      const float y = msda::cell_coord(__ldg(loc + 2 * k + 1), h);
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
      const bool ok[4] = {y0_ok && x0_ok, y0_ok && x1_ok, y1_ok && x0_ok,
                          y1_ok && x1_ok};
      const float wc[4] = {(1.f - dx) * (1.f - dy), dx * (1.f - dy),
                           (1.f - dx) * dy, dx * dy};
      // signed: a corner out of range may lie before the level's start
      const int c00 = y0 * w + x0;
      const int cell[4] = {c00, c00 + 1, c00 + w, c00 + w + 1};
      const TV* v_lvl = v_item + (size_t)meta.start[lv] * md;
      float* g_lvl = gv_item + (size_t)meta.start[lv] * md;
      float* s_lvl = meta.soff[lv] >= 0 ? acc + meta.soff[lv] : nullptr;
      const TG* g_row = grad_out + ((size_t)n * lq + q) * md + head * d;
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) {
        const int c = ci + gs * kk;
        if (c >= chunks) break;
        const int ch = c * VW;
        float g[VW], v[4][VW];
        load_chunk<VW>(g_row + ch, g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (ok[j]) {
            load_chunk<VW>(v_lvl + (ptrdiff_t)cell[j] * md + ch, v[j]);
          } else {
#pragma unroll
            for (int e = 0; e < VW; ++e) v[j][e] = 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          s_attn += g[e] * (wc[0] * v[0][e] + wc[1] * v[1][e] +
                            wc[2] * v[2][e] + wc[3] * v[3][e]);
          s_x += g[e] * ((1.f - dy) * (v[1][e] - v[0][e]) +
                         dy * (v[3][e] - v[2][e]));
          s_y += g[e] * ((1.f - dx) * (v[2][e] - v[0][e]) +
                         dx * (v[3][e] - v[1][e]));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!ok[j]) continue;
          float term[VW];
#pragma unroll
          for (int e = 0; e < VW; ++e) term[e] = wc[j] * (a * g[e]);
          add_corner<VW>(s_lvl ? s_lvl + cell[j] * d + ch : nullptr,
                         g_lvl + (size_t)cell[j] * md + ch, term);
        }
      }
    }
    // sums over the group's lanes: lane ci adds lane ci + off of its group
    // (positions past the group count as zero), so lane 0 ends with all
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oa = __shfl_down_sync(0xffffffffu, s_attn, off);
      const float ox = __shfl_down_sync(0xffffffffu, s_x, off);
      const float oy = __shfl_down_sync(0xffffffffu, s_y, off);
      if (ci + off < gs) {
        s_attn += oa;
        s_x += ox;
        s_y += oy;
      }
    }
    if (live && ci == 0) {
      grad_attn[k] = s_attn;
      grad_loc[2 * k] = (float)w * a * s_x;
      grad_loc[2 * k + 1] = (float)h * a * s_y;
    }
  }

  if (smem_floats == 0) return;
  __syncthreads();
  // the flush: each piece of VW channels that took a term, once
  for (int lv = 0; lv < l; ++lv) {
    const int so = meta.soff[lv];
    if (so < 0) continue;
    const int pieces = meta.h[lv] * meta.w[lv] * chunks;
    float* g_lvl = gv_item + (size_t)meta.start[lv] * md;
    for (int i = tid; i < pieces; i += nthreads) {
      const int cell = i / chunks;
      const int ch = (i - cell * chunks) * VW;
      const float* src = acc + so + cell * d + ch;
      float* dst = g_lvl + (size_t)cell * md + ch;
      if constexpr (VW == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
          atomicAdd(reinterpret_cast<float4*>(dst), v);
      } else {
        if (*src != 0.f) atomicAdd(dst, *src);
      }
    }
  }
}

struct BwdArgs {
  const void* grad_out;
  const void* value;
  const float* loc;
  const float* attn;
  float* grad_value;
  float* grad_loc;
  float* grad_attn;
  LevelMeta meta;
  int n, s, lq, m, l, p, d, qpb, smem_bytes, threads;
  cudaStream_t stream;
};

template <typename TV, typename TG, int VW>
static int launch_bwd(const BwdArgs& a) {
  const cudaError_t rc = cudaFuncSetAttribute(
      msda_bwd_kernel<TV, TG, VW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)((a.lq + (long long)a.qpb - 1) / a.qpb),
                  (unsigned)a.m, (unsigned)a.n);
  msda_bwd_kernel<TV, TG, VW><<<grid, a.threads, a.smem_bytes, a.stream>>>(
      static_cast<const TG*>(a.grad_out), static_cast<const TV*>(a.value),
      a.loc, a.attn, a.grad_value, a.grad_loc, a.grad_attn, a.meta, a.s,
      a.lq, a.m, a.l, a.p, a.d, a.qpb, a.smem_bytes / 4);
  return (int)cudaGetLastError();
}

template <int VW>
static int dispatch(const BwdArgs& a, int value_is_bf16, int grad_is_bf16) {
  if (value_is_bf16 && grad_is_bf16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16, VW>(a);
  if (value_is_bf16) return launch_bwd<__nv_bfloat16, float, VW>(a);
  if (grad_is_bf16) return launch_bwd<float, __nv_bfloat16, VW>(a);
  return launch_bwd<float, float, VW>(a);
}

// Plain C entry point, loaded with ctypes. shapes_hw is a host array of
// 2*l ints ((H_0, W_0), ...); the levels lie back to back along S. The
// host's plan (ops/msda.py:bwd_plan): `smem_levels`, a bit per level summed
// in shared memory, `smem_bytes` their float32 head slices laid end to end
// (checked here), `queries_per_block`, `threads` a block, and `vector`, the
// 16-byte path, which needs D % 4 == 0 and aligned pointers (checked
// here). Launches on `stream` and returns cudaGetLastError() (0 on
// success) or the error of a refused call.
extern "C" int msda_bwd(const void* grad_out, const void* value,
                        const void* loc, const void* attn, void* grad_value,
                        void* grad_loc, void* grad_attn, int n, int s, int lq,
                        int m, int l, int p, int d, const int* shapes_hw,
                        int value_is_bf16, int grad_is_bf16, int smem_levels,
                        int queries_per_block, int smem_bytes, int vector,
                        int threads, void* stream) {
  if (l < 1 || l > MSDA_MAX_LEVELS || m < 1 || m > 65535 || d < 1 ||
      d > MSDA_BWD_MAX_D || p < 1 || n < 1 || n > 65535 || lq < 0 ||
      threads < 32 || threads > MSDA_BWD_MAX_THREADS || threads % 32 != 0 ||
      queries_per_block < 1 ||
      (long long)queries_per_block * l * p > 0x7fffffffLL ||
      smem_levels < 0 || smem_levels >= (1 << l) || smem_bytes < 0 ||
      smem_bytes > MSDA_BWD_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  int start = 0;
  long long floats = 0;
  for (int i = 0; i < l; ++i) {
    a.meta.h[i] = shapes_hw[2 * i];
    a.meta.w[i] = shapes_hw[2 * i + 1];
    a.meta.start[i] = start;
    start += a.meta.h[i] * a.meta.w[i];
    a.meta.soff[i] = -1;
    if (smem_levels & (1 << i)) {
      a.meta.soff[i] = (int)floats;
      floats += (long long)a.meta.h[i] * a.meta.w[i] * d;
    }
  }
  if (start != s || floats * 4 != smem_bytes)
    return (int)cudaErrorInvalidValue;
  const int es_v = value_is_bf16 ? 2 : 4;
  const int es_g = grad_is_bf16 ? 2 : 4;
  if (vector && (d % 4 != 0 || (uintptr_t)value % (4 * es_v) != 0 ||
                 (uintptr_t)grad_out % (4 * es_g) != 0 ||
                 (uintptr_t)grad_value % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  if (lq == 0) return (int)cudaGetLastError();
  a.grad_out = grad_out;
  a.value = value;
  a.loc = static_cast<const float*>(loc);
  a.attn = static_cast<const float*>(attn);
  a.grad_value = static_cast<float*>(grad_value);
  a.grad_loc = static_cast<float*>(grad_loc);
  a.grad_attn = static_cast<float*>(grad_attn);
  a.n = n;
  a.s = s;
  a.lq = lq;
  a.m = m;
  a.l = l;
  a.p = p;
  a.d = d;
  a.qpb = queries_per_block;
  a.smem_bytes = smem_bytes;
  a.threads = threads;
  a.stream = static_cast<cudaStream_t>(stream);
  return vector ? dispatch<4>(a, value_is_bf16, grad_is_bf16)
                : dispatch<1>(a, value_is_bf16, grad_is_bf16);
}
