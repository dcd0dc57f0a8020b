// All-levels multi-scale deformable attention for the encoder self-pattern
// (queries are the level tokens, Lq == S) as one flat walk over value
// chunks, for Hopper (sm_90a).
//
// Replaces trackformer_tpu/ops/msda_patch.py::_kernel_v6 (reached through
// _msda_patch_v6_fwd, public msda_patch_v6; no route of ms_deform_attn
// calls it):
//
//   out[n, q, m, :] = sum_{l, p} attn[n, q, m, l, p] * sum_{r, c}
//                     hat(y - r) * hat(x - c) * value[n, start_l + r * W_l + c, m, :],
//   hat(t) = max(0, 1 - |t|),  x = loc_x * W_l - 0.5,  y = loc_y * H_l - 0.5.
//
// Queries are tiled in the static snake-bucket order `perm`
// (snake_bucket_perm: tokens of all levels sorted by image position), so a
// tile of TQ queries samples a compact rectangle of every level. The
// wrapper precomputes (v6_walk), for every tile, ONE flat list of the
// PH x PW-cell chunks that the tile's rectangles cover on all levels, as
// codes (level << 20 | chunk row << 10 | chunk column), and its length.
// The kernel runs a single loop over the list: decode by shift and mask,
// keep an NSLOTS-deep ring of chunk copies in flight, and for each chunk
// that has landed add, for every query of the tile, the corners of that
// level's samples that fall inside the chunk.
//
// What differs on this card. The TPU kernel re-tiles the values into
// patch-major chunks (one block transpose per level) and stages all heads
// of 4 chunks of 16 x 64 cells (4 x 1024 x 384 bf16 = 3 MB of VMEM). A
// block here has 227 KB: it serves ONE head of a tile (grid = head x q-tile
// x item) and copies that head's slice of a chunk straight from the raster
// layout, cell by cell, so no re-tiled copy of the values exists; the
// card's default chunk is 8 x 32 cells (18 KB a slot in bfloat16, four
// slots). Edge chunks are clipped to the level. The row-strip separable hat
// build and the dot per chunk become a walk of each sample's 2 x 2 support
// in the staged chunk. The permutation is applied by index.
//
// What bounds it: bytes; copies are cp.async words of 8 bytes for D = 36
// bfloat16 (see msda_common.cuh), NSLOTS - 1 chunks ahead of the sums.
#include "msda_common.cuh"

using namespace msda;

#define V6_MAX_LEVELS 16

struct V6Levels {
  int h[V6_MAX_LEVELS];
  int w[V6_MAX_LEVELS];
  int start[V6_MAX_LEVELS];
};

// Shared memory: [NSLOTS chunks of `slot_bytes`][out tile: TQ * D f32]
// [x, y, attn: 3 * L * TQ * P f32, level-major][query index: TQ int].
// value (N, S, M*D) in T; loc (N, S, M, L, P, 2) f32; attn (N, S, M, L, P)
// f32; perm (S) int32; codes (N, nQ, MAXC) int32; totals (N, nQ) int32;
// out (N, S, M*D) f32. gridDim = (M, nQ = ceil(S / TQ), N).
template <typename T, int WORD>
__global__ void msda_patch_v6_fwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const int* __restrict__ perm,
    const int* __restrict__ codes, const int* __restrict__ totals,
    float* __restrict__ out, V6Levels meta, int s, int m, int l, int p, int d,
    int tq, int ph, int pw, int nslots, int maxc, int slot_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* out_s = reinterpret_cast<float*>(smem + (size_t)nslots * slot_bytes);
  float* qx = out_s + (size_t)tq * d;
  float* qy = qx + (size_t)l * tq * p;
  float* qa = qy + (size_t)l * tq * p;
  int* qidx = reinterpret_cast<int*>(qa + (size_t)l * tq * p);

  const int head = blockIdx.x;
  const int tile = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int md = m * d;
  const int q_begin = tile * tq;
  const int nq = min(tq, s - q_begin);

  // (1) the tile's queries and this head's samples of every level
  for (int j = tid; j < nq; j += nthreads) qidx[j] = perm[q_begin + j];
  for (int i = tid; i < nq * d; i += nthreads) out_s[i] = 0.f;
  __syncthreads();
  const int lp = l * p;
  for (int i = tid; i < nq * lp; i += nthreads) {
    const int ql = i / lp;
    const int rem = i - ql * lp;
    const int lvl = rem / p;
    const int pt = rem - lvl * p;
    const size_t k = (((size_t)n * s + qidx[ql]) * m + head) * lp + rem;
    const int o = (lvl * tq + ql) * p + pt;
    qx[o] = cell_coord(__ldg(loc + 2 * k), meta.w[lvl]);
    qy[o] = cell_coord(__ldg(loc + 2 * k + 1), meta.h[lvl]);
    qa[o] = __ldg(attn + k);
  }

  // (2) one loop over the tile's flat chunk list
  const int* code = codes + ((size_t)n * gridDim.y + tile) * maxc;
  const int total = totals[(size_t)n * gridDim.y + tile];
  const T* item = value + (size_t)n * s * md + head * d;

  auto chunk = [&](int j, int& lvl, int& r0, int& r1, int& c0, int& c1) {
    const int cd = __ldg(code + j);
    lvl = cd >> 20;
    r0 = ((cd >> 10) & 1023) * ph;
    c0 = (cd & 1023) * pw;
    r1 = min(r0 + ph, meta.h[lvl]);
    c1 = min(c0 + pw, meta.w[lvl]);
  };
  auto prefetch = [&](int j) {
    int lvl, r0, r1, c0, c1;
    chunk(j, lvl, r0, r1, c0, c1);
    T* dst =
        reinterpret_cast<T*>(smem + (size_t)(j % nslots) * slot_bytes);
    stage_window<T, WORD>(dst, item + (size_t)meta.start[lvl] * md,
                          meta.w[lvl], md, d, r0, r1, c0, c1, tid, nthreads);
  };

  for (int j = 0; j < nslots - 1; ++j) {
    if (j < total) prefetch(j);
    cp_async_commit();
  }
  for (int j = 0; j < total; ++j) {
    if (j + nslots - 1 < total) prefetch(j + nslots - 1);
    cp_async_commit();
    cp_async_wait(nslots - 1);  // chunk j has landed
    __syncthreads();            // (and, at j = 0, the samples are written)
    int lvl, r0, r1, c0, c1;
    chunk(j, lvl, r0, r1, c0, c1);
    const T* win =
        reinterpret_cast<const T*>(smem + (size_t)(j % nslots) * slot_bytes);
    for (int i = tid; i < nq * d; i += nthreads) {
      const int ql = i / d;
      const int c = i - ql * d;
      const int o = (lvl * tq + ql) * p;
      out_s[i] += window_sum(win + c, d, r0, r1, c0, c1, qx + o, qy + o,
                             qa + o, p);
    }
    __syncthreads();  // chunk j is consumed before its slot is refilled
  }
  cp_async_wait(0);

  // (3) one write per (query, channel), at the query's own index
  for (int i = tid; i < nq * d; i += nthreads) {
    const int ql = i / d;
    const int c = i - ql * d;
    out[((size_t)n * s + qidx[ql]) * md + head * d + c] = out_s[i];
  }
}

template <typename T, int WORD>
static int launch_v6(const void* value, const void* loc, const void* attn,
                     const void* perm, const void* codes, const void* totals,
                     void* out, const V6Levels& meta, int n, int s, int m,
                     int l, int p, int d, int tq, int ph, int pw, int nslots,
                     int maxc, int slot_bytes, size_t smem_bytes, int threads,
                     cudaStream_t st) {
  auto kernel = msda_patch_v6_fwd_kernel<T, WORD>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(m, (s + tq - 1) / tq, n);
  kernel<<<grid, threads, smem_bytes, st>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const int*>(perm),
      static_cast<const int*>(codes), static_cast<const int*>(totals),
      static_cast<float*>(out), meta, s, m, l, p, d, tq, ph, pw, nslots, maxc,
      slot_bytes);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes. shapes_hw is a host array of
// 2 * l ints ((H_0, W_0), ...); the levels lie back to back along S;
// `maxc` is the row length of `codes`. Launches on `stream` and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a shape the
// kernel does not take (a chunk grid past the code's 10 bits per axis
// included).
extern "C" int msda_patch_v6_fwd(const void* value, const void* loc,
                                 const void* attn, const void* perm,
                                 const void* codes, const void* totals,
                                 void* out, int n, int s, int m, int l, int p,
                                 int d, const int* shapes_hw,
                                 int value_is_bf16, int tq, int ph, int pw,
                                 int nslots, int maxc, int threads,
                                 void* stream) {
  if (n < 1 || n > 65535 || s < 1 || m < 1 || m > 65535 || l < 1 ||
      l > V6_MAX_LEVELS || p < 1 || d < 1 || tq < 1 || ph < 1 || pw < 1 ||
      nslots < 2 || nslots > 8 || maxc < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if ((s + tq - 1) / tq > 65535) return (int)cudaErrorInvalidValue;
  V6Levels meta;
  int start = 0;
  for (int i = 0; i < l; ++i) {
    meta.h[i] = shapes_hw[2 * i];
    meta.w[i] = shapes_hw[2 * i + 1];
    meta.start[i] = start;
    if (meta.h[i] < 1 || meta.w[i] < 1 ||
        (meta.h[i] + ph - 1) / ph > 1024 || (meta.w[i] + pw - 1) / pw > 1024)
      return (int)cudaErrorInvalidValue;
    start += meta.h[i] * meta.w[i];
  }
  if (start != s) return (int)cudaErrorInvalidValue;
  const int es = value_is_bf16 ? 2 : 4;
  const int slot_bytes = (int)(((size_t)ph * pw * d * es + 15) / 16 * 16);
  const size_t smem_bytes =
      (size_t)nslots * slot_bytes +
      sizeof(float) * ((size_t)tq * d + 3 * (size_t)l * tq * p) +
      sizeof(int) * (size_t)tq;
  if (smem_bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int word = staging_word(value, m, d, es);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define V6_LAUNCH(T, WORD)                                                   \
  return launch_v6<T, WORD>(value, loc, attn, perm, codes, totals, out,     \
                            meta, n, s, m, l, p, d, tq, ph, pw, nslots,     \
                            maxc, slot_bytes, smem_bytes, threads, st)
  if (value_is_bf16) {
    if (word == 16) V6_LAUNCH(__nv_bfloat16, 16);
    if (word == 8) V6_LAUNCH(__nv_bfloat16, 8);
    if (word == 4) V6_LAUNCH(__nv_bfloat16, 4);
    V6_LAUNCH(__nv_bfloat16, 2);
  }
  if (word == 16) V6_LAUNCH(float, 16);
  if (word == 8) V6_LAUNCH(float, 8);
  V6_LAUNCH(float, 4);
#undef V6_LAUNCH
}
