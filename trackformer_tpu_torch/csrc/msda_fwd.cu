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
// What bounds it on this card. The first design (a thread per channel of the
// M * D row, 4 queries a block) was bound by instructions and latency, not
// bytes: every one of a head's D = 36 threads loaded each sample's location
// and weight and redid its cell arithmetic and in-range tests (102.9 M
// evaluations and 308.6 M loads at the flagship encoder call, Lq = S =
// 22,323, M = 8, L = 4, P = 4, where its 2.86 M samples need them once),
// read values one 2-byte element per thread (411.4 M loads), and its warps
// straddled two heads that sample different cells. It took 0.50 ms there,
// while the weighted gather of precomputed rows (msda_gather_rows_fwd.cu, a
// warp per query and head) read twice the bytes per row in 0.38 ms. Below
// that lies the corner traffic through L2: the value table (12.9 MB in bf16)
// stays in the 50 MB L2, but 11.4 M corner rows of 72 B (about 1.2 GB in
// 32-byte sectors) must come through it, about 0.2 ms, against the 0.018 ms
// HBM bound that counts each input once.
//
// What this design does about it:
//  * A warp per (item, query, head); a block holds neighbouring queries of
//    one head, whose corners share L1 lines (encoder queries are raster
//    tokens). Each lane takes one (level, point) sample, with coalesced loads
//    of its location and weight, and computes once: the cell coordinate
//    (msda::cell_coord), the four corner rows and four folded weights,
//    attention x bilinear x in range.
//  * Word-sized row loads. The lanes form groups of D * sizeof(T) / WORD, each
//    group on one sample's corner rows at a time, whose rows and weights it
//    takes from the sample's lane by shuffle: bf16 D = 36 is 9 lanes of 8
//    bytes and 3 samples a step, float32 9 lanes of 16 bytes. A lane issues
//    the loads of two samples' eight corner rows before it uses any. The walk
//    has no branch: a corner off its level is read like the others (the row
//    of the level's nearest cell, as the plain version reads it) at weight 0.
//  * Each lane sums its channels in float32 registers; a tree of shuffles
//    adds the groups, the output is rounded once and each lane stores its
//    word. A row that is not a whole number of aligned 8-byte words takes one
//    channel a lane (groups of min(D, 32) lanes, passes of 32 channels). The
//    host picks the word and the warps per block (ops/msda.py:fwd_plan).
// What bounds this design: instructions and latency per sample, no longer
// the value reads. With every sample on one cell, so that every corner row
// is an L1 hit, the encoder call takes 1 % less time in bf16, a decoder
// call with scattered samples about a quarter less (`ms_one_cell` of
// `chip_smoke.py --phases msda --old-msda-fwd`; H100 80GB HBM3, 700 W); the
// multiply-adds and the bf16 unpacking of 36 channels x 4 corners are the
// floor of the instruction count.
#include "msda_common.cuh"

#define MSDA_MAX_LEVELS 16
#define MSDA_FWD_MAX_WARPS 8  // warps per block
// samples a group loads before it sums them (one for 8-element words, whose
// eight rows in flight would not fit the registers: ptxas spilled them)
#define MSDA_FWD_UNROLL 2

struct LevelMeta {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// bfloat16 is the high half of a float32: element 0 is the low half
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// VW consecutive elements as float32; `p` is aligned to VW elements.
template <int VW>
__device__ __forceinline__ void load_words(const float* p, float* o) {
  if constexpr (VW == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else if constexpr (VW == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = __ldg(p);
  }
}
template <int VW>
__device__ __forceinline__ void load_words(const __nv_bfloat16* p, float* o) {
  if constexpr (VW == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf16_lo(w[i]);
      o[2 * i + 1] = bf16_hi(w[i]);
    }
  } else if constexpr (VW == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = bf16_lo(u.x);
    o[1] = bf16_hi(u.x);
    o[2] = bf16_lo(u.y);
    o[3] = bf16_hi(u.y);
  } else {
    o[0] = bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

template <int VW>
__device__ __forceinline__ void store_words(float* p, const float* v) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VW; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}
template <int VW>
__device__ __forceinline__ void store_words(__nv_bfloat16* p, const float* v) {
  if constexpr (VW == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else if constexpr (VW == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else {
    *p = __float2bfloat16(v[0]);
  }
}

// value (N, S, M*D) in T; loc (N, Lq, M, L, P, 2) f32 as (x, y) in [0, 1];
// attn (N, Lq, M, L, P) f32; out (N, Lq, M*D) in O: the value type, or f32
// for a caller that adds the result to other levels' sums before it rounds.
// A lane loads VW elements of a head row at a time (VW == 1: one channel).
// gridDim = (tiles >= ceil(Lq / warps), M, N), the host's plan,
// blockDim.x = 32 * warps: warp w of block (x, head, n) serves query
// x * warps + w of that head and item.
template <typename T, typename O, int VW>
__global__ void __launch_bounds__(MSDA_FWD_MAX_WARPS * 32, 3)
    msda_fwd_kernel(const T* __restrict__ value,
                    const float* __restrict__ loc,
                    const float* __restrict__ attn, O* __restrict__ out,
                    LevelMeta meta, int s, int lq, int m, int l, int p,
                    int d) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int UNROLL = VW >= 8 ? 1 : MSDA_FWD_UNROLL;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= lq) return;  // whole warps leave: no barrier follows
  const int head = blockIdx.y;
  const int n = blockIdx.z;
  const int md = m * d;
  const int lp = l * p;
  const size_t item_q_head = ((size_t)n * lq + q) * m + head;
  const T* v_head = value + (size_t)n * s * md + (size_t)head * d;
  const float* loc_q = loc + item_q_head * lp * 2;
  const float* attn_q = attn + item_q_head * lp;
  O* out_q = out + item_q_head * d;

  // lanes: `groups` groups of `gs` consecutive lanes, each group on one
  // corner row at a time, lane `ci` of a group on word ci of the pass
  const int chunks = d / VW;
  const int gs = min(chunks, 32);
  const int groups = 32 / gs;
  const int group = lane / gs;
  const int ci = lane - group * gs;

  for (int c0 = 0; c0 < chunks; c0 += gs) {  // one pass unless chunks > 32
    const int chunk = c0 + ci;
    // every lane loads, so that the walk has no branch: a lane past the
    // row's last word reads that word, and its sums are never stored
    const T* v_word = v_head + (size_t)min(chunk, chunks - 1) * VW;
    float acc[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[e] = 0.f;

    for (int j0 = 0; j0 < lp; j0 += 32) {  // one pass unless L * P > 32
      // this lane's sample: its four corner rows, counted from the item's
      // first cell, and folded weights (corners 00, 10, 01, 11 as (x, y));
      // a corner off the level has weight 0 and the row of the level's
      // nearest cell, as in the plain version; a lane past the last sample
      // has weight 0 on row 0
      int row[4] = {0, 0, 0, 0};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      const int j = j0 + lane;
      if (j < lp) {
        const int lv = j / p;
        const int h = meta.h[lv];
        const int w = meta.w[lv];
        const float a = __ldg(attn_q + j);
        const float x = msda::cell_coord(__ldg(loc_q + 2 * j), w);
        const float y = msda::cell_coord(__ldg(loc_q + 2 * j + 1), h);
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float dx = x - x0f;
        const float dy = y - y0f;
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cx = x0 + (c & 1);
          const int cy = y0 + (c >> 1);
          const bool ok = cx >= 0 && cx < w && cy >= 0 && cy < h;
          const float b =
              ((c & 1) ? dx : 1.f - dx) * ((c >> 1) ? dy : 1.f - dy);
          wt[c] = ok ? a * b : 0.f;
          row[c] = meta.start[lv] + min(max(cy, 0), h - 1) * w +
                   min(max(cx, 0), w - 1);
        }
      }
      const int ns = min(32, lp - j0);
      // group g takes the pass's samples g, g + groups, ...; UNROLL of them
      // (4 * UNROLL corner rows) are in flight before any is summed
      for (int t0 = 0; t0 < ns; t0 += groups * UNROLL) {
        float ww[UNROLL][4];
        float v[UNROLL][4][VW];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int src = t0 + u * groups + group;
          const bool live = src < ns;  // else src & 31 names another sample
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = __shfl_sync(FULL, row[c], src & 31);
            const float w = __shfl_sync(FULL, wt[c], src & 31);
            ww[u][c] = live ? w : 0.f;
            load_words<VW>(v_word + (size_t)r * md, v[u][c]);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[e] += ww[u][c] * v[u][c][e];
      }
    }
    // the groups' sums, a tree over the groups: group g adds group g + off
    // at step off, so group 0 ends with all
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      for (int off = 1; off < groups; off <<= 1) {
        const float o = __shfl_down_sync(FULL, acc[e], off * gs);
        if ((group & (2 * off - 1)) == 0 && group + off < groups) acc[e] += o;
      }
    }
    if (group == 0 && chunk < chunks)
      store_words<VW>(out_q + (size_t)chunk * VW, acc);
  }
}

struct FwdArgs {
  const void* value;
  const float* loc;
  const float* attn;
  void* out;
  LevelMeta meta;
  int n, s, lq, m, l, p, d, warps;
  dim3 grid;
  cudaStream_t stream;
};

template <typename T, typename O, int VW>
static void launch(const FwdArgs& a) {
  msda_fwd_kernel<T, O, VW><<<a.grid, 32 * a.warps, 0, a.stream>>>(
      static_cast<const T*>(a.value), a.loc, a.attn, static_cast<O*>(a.out),
      a.meta, a.s, a.lq, a.m, a.l, a.p, a.d);
}

// the word a lane loads, as VW elements: VW1, VW2 or a single channel
template <typename T, typename O, int VW1, int VW2>
static void launch_words(const FwdArgs& a, int vw) {
  if (vw == VW1)
    launch<T, O, VW1>(a);
  else if (vw == VW2)
    launch<T, O, VW2>(a);
  else
    launch<T, O, 1>(a);
}

// Plain C entry point, loaded with ctypes. shapes_hw is a host array of
// 2*l ints ((H_0, W_0), ...); the levels lie back to back along S. The
// host's plan (ops/msda.py:fwd_plan): `word`, the bytes a lane loads of a
// head row (16 or 8; 0 for one channel a lane), which must divide the row
// and the value pointer's alignment (checked here), `warps` per block and
// the grid (grid_x query tiles, grid_y = m heads, grid_z = n items; refused
// unless it covers every query). `out_is_f32` asks for the f32 sums of
// bf16 values unrounded (f32 values always give f32). Launches on `stream`
// and returns cudaGetLastError() (0 on success) or the error of a refused
// call.
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn,
                        void* out, int n, int s, int lq, int m, int l, int p,
                        int d, const int* shapes_hw, int value_is_bf16,
                        int out_is_f32, int word, int warps, int grid_x,
                        int grid_y, int grid_z, void* stream) {
  if (l < 1 || l > MSDA_MAX_LEVELS || m < 1 || d < 1 || m * d > 1024 ||
      p < 1 || n < 1 || n > 65535 || lq < 0 || warps < 1 ||
      warps > MSDA_FWD_MAX_WARPS || (word != 0 && word != 8 && word != 16) ||
      grid_y != m || grid_z != n || grid_x < 0 ||
      (long long)grid_x * warps < lq)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  int start = 0;
  for (int i = 0; i < l; ++i) {
    a.meta.h[i] = shapes_hw[2 * i];
    a.meta.w[i] = shapes_hw[2 * i + 1];
    a.meta.start[i] = start;
    start += a.meta.h[i] * a.meta.w[i];
  }
  if (start != s) return (int)cudaErrorInvalidValue;
  const int es = value_is_bf16 ? 2 : 4;
  const int es_out = (value_is_bf16 && !out_is_f32) ? 2 : 4;
  const int vw = word ? word / es : 1;
  if (word && ((d * es) % word != 0 || (uintptr_t)value % word != 0 ||
               (uintptr_t)out % (vw * es_out > 16 ? 16 : vw * es_out) != 0))
    return (int)cudaErrorMisalignedAddress;
  if (lq == 0) return (int)cudaGetLastError();
  a.value = value;
  a.loc = static_cast<const float*>(loc);
  a.attn = static_cast<const float*>(attn);
  a.out = out;
  a.n = n;
  a.s = s;
  a.lq = lq;
  a.m = m;
  a.l = l;
  a.p = p;
  a.d = d;
  a.warps = warps;
  a.grid = dim3((unsigned)grid_x, (unsigned)grid_y, (unsigned)grid_z);
  a.stream = static_cast<cudaStream_t>(stream);
  if (value_is_bf16 && out_is_f32)
    launch_words<__nv_bfloat16, float, 8, 4>(a, vw);
  else if (value_is_bf16)
    launch_words<__nv_bfloat16, __nv_bfloat16, 8, 4>(a, vw);
  else
    launch_words<float, float, 4, 2>(a, vw);
  return (int)cudaGetLastError();
}
