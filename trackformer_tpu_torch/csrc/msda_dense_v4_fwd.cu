// Multi-scale deformable attention as a walk over each query tile's own
// occupied windows of cells, for Hopper (sm_90a): the range-walking, the
// block-skipping and the sorted x-windowed level kernels and the all-levels
// flat-walk kernel, one engine, one kernel and one C entry point.
//
// Replaces, in trackformer_tpu/ops/:
//  - msda_dense.py::_kernel_v4 (:356, reached through the pallas_call of
//    _dense_level_pallas_v4_fwd at :539: dense_level_pallas_v4 and
//    dense_level_pallas_v4p; routes PALLAS_SKIP_IMPL="v4" and
//    MSDA_DEC_SKIP=1);
//  - msda_dense.py::_kernel_v2 (:68, through _dense_level_pallas_v2_fwd at
//    :199; route PALLAS_SKIP_IMPL="v2");
//  - msda_dense.py::_kernel_v3 (:270, through _dense_level_pallas_v3_fwd at
//    :653: dense_level_pallas_v3; no route);
//  - msda_patch.py::_kernel_v6 (:411, through _msda_patch_v6_fwd at :625:
//    msda_patch_v6; no route).
// All compute
//
//   out[n, q, m, :] = sum_{l, p} attn[n, q, m, l, p] * sum_{r, c}
//                     hat(y - r) * hat(x - c) * value[n, start_l + r * W_l + c, m, :],
//   hat(t) = max(0, 1 - |t|),  x = loc_x * W_l - 0.5,  y = loc_y * H_l - 0.5,
//
// summed in float32 into a float32 output, over one level (v2, v3, v4) or
// all levels of the encoder's self-pattern, whose queries are the level
// tokens (v6). They differ in what the TPU kernel reads:
//  - v4 grids over (item, q-tile). A tile of TQ queries, taken in the order
//    of an optional permutation `perm` (a spatial sort), meets only the rows
//    floor(min y) - 1 .. floor(max y) + 1 and the columns floor(min x) ..
//    floor(max x) + 1 of the level (over the tile's heads and points,
//    clipped into the level); it walks that row range with double-buffered
//    DMA and, per row tile, the range of CW-wide column chunks. This kernel
//    reports these bounds (`ranges`, as ops/msda_dense.py: v4_ranges
//    computes them for its tile) and reads no cell outside them.
//  - v2 builds a dense (queries, cells) hat tile per row tile of a tile of
//    consecutive queries and multiplies it with the values on the matrix
//    unit, skipping the rows outside the tile's band; here it is v4's walk
//    at the full width in query order, with the band (`band`, as
//    v2_row_band gives it, clipped to the level) written out.
//  - v3 sorts the queries, keeps v2's row band and computes a tile on one
//    window of CW columns when its occupied columns fit, else on the full
//    width. That choice changes only what the TPU stages; this walk stages
//    only occupied windows either way: v3 is v4's walk in a spatial sort
//    and CW-column chunks, with each tile's [row lo, row hi, xstart, fits]
//    (`windows`, as v3_windows gives them) written out.
//  - v6 tiles the tokens in the static snake-bucket order (snake_bucket_perm,
//    one int32 permutation shared by every item) and walks a precomputed
//    flat list of the value chunks each tile covers on all levels. Here a
//    block runs the walk below once per level, each on that level's own
//    window grid, its samples read in place through the level's stride, and
//    keeps each query's sums in registers across the levels: one launch,
//    no list (no window leaves the tile's occupied cells, so no cell
//    outside the list's chunks is read).
//
// What bounds it on this card: bytes (0.010-0.026 ms an encoder level of
// the flagship, 0.022 ms the encoder call over all levels, 0.0015 ms the
// decoder's 100x168 level; each sampled channel costs about 10 flops
// against a value read). The first designs, a thread per (query, channel)
// walking every window or chunk of the range, reached 1-8 % of that. What
// this design does about each of their costs:
//  1. Per-sample work redone D x windows times: now once per sample, into a
//     corner table of folded weights and (window, cell) keys.
//  2. Every window of the range staged whether or not a sample of the head
//     landed in it: the corners mark their windows, a block-wide scan ranks
//     the occupied ones, and only those are staged, each clipped to the
//     cells this head's corners reach. The windows are small where the
//     samples are sparse (the decoder's scattered queries: 1 x 4 cells, 56
//     a stage in bfloat16) and larger where they are dense (3 x 16 cells on
//     the encoder levels, whole rows at the full width).
//  3. Too few blocks to fill the card: the host's plan (ops/msda_dense.py:
//     walk_plan, levels_plan) takes the largest tile of 192, 96, 48 or 24
//     queries that still gives two blocks an SM.
//  4. Every head block re-read all M * P samples of its tile to reduce the
//     tile's range: each block reads only its head's; the bounds over all
//     heads, which only the reported `ranges` / `band` / `windows` need,
//     come from the M head blocks launched as one cluster, through
//     distributed shared memory.
//  5. A float32 output tile in shared memory updated with += every window:
//     each query is owned by one lane group that keeps its D sums in
//     registers across the walk (and across the levels) and writes them
//     once, at perm[q]; the windows are walked by stages of several.
//  6. Staging with plain loads and no overlap, or a ring of whole chunks:
//     cp.async, two stages in flight.
//  7. v6's flat chunk list built in tensor code before every call: the
//     block finds its own windows.
//
// A block serves one head of a tile of `tq` queries of one item (grid =
// head x tile x item, heads fastest, so that the blocks that read
// neighbouring slices of the same cells run together). For each pass over
// a head row (below) and each level, the block:
//
//  (1) loads this head's samples of the tile at this level once, one thread
//      a sample, and computes once per sample its cell coordinates
//      (msda::cell_coord, rounded in two steps), its four corner cells and
//      their folded attention x bilinear weights: a corner table of 4 P
//      entries a query. The level is cut into windows of wr rows x wc
//      columns on a fixed grid (wc divides the walk's column chunk, so a
//      window lies in one chunk); each corner in the level belongs to
//      exactly one window, so a support that straddles windows or chunks is
//      summed once per corner. Each corner marks its window occupied.
//      Off-level corners are left out (the plain version gives them weight
//      0).
//  (2) reduces the tile's min / max cell coordinates: its own head's in the
//      block; over all heads, only where the caller asks for the tile's
//      bounds (one level only), through distributed shared memory: the M
//      head blocks of a tile are launched as one thread-block cluster, each
//      publishes its four partials and block 0 of the cluster reads them
//      all. No block reads another head's samples.
//  (3) ranks the occupied windows with a block-wide scan (a counting sort
//      of the windows), and each query's owner thread rewrites its 4 P
//      corners as (window rank, cell in window) and sorts them by rank.
//  (4) walks only the occupied windows, `wps` of them a stage, two stages
//      in flight (cp.async: the next stage loads while this one is summed),
//      each window clipped to the corners of this head, in the widest word
//      the layout allows (8 bytes for D = 36 bfloat16: a head's 72-byte row
//      at cell * 576 + m * 72 is never 16-byte aligned, which also rules out
//      TMA on a single head's row).
//  (5) sums each query in registers: the block's lanes form groups of
//      min(32, words) lanes, a word being the widest width of 16, 8, 4 or 2
//      bytes that the row and the pointer align to; lane ci of a group
//      holds word ci of the row, and a row of more than 32 words takes
//      ceil(words / 32) passes, pass k over words 32 k .. 32 k + 31 (each
//      pass stages only its slice of the row and repeats (1)-(3): no path
//      makes such a row, and the register sums stay those of one pass).
//      Group g owns the queries g, g + G, ... (at most KMAX of them) and
//      keeps a cursor into each one's sorted corners, so that per stage it
//      takes exactly its queries' corners in that stage, reads their words
//      from shared memory and adds them. Each (query, channel) is written
//      once, at the query's own index (perm[q] for a permuted tile), after
//      the last level of its pass.
//
// The kernel is compiled for three blocks an SM (at most 85 registers a
// thread): the phases of a block wait on each other, and a third block
// hides more of that than the registers a two-block build would keep. The
// levels and the passes are runtime loops, compiled only into the
// instantiations that take them: the build makes 35 instantiations (value
// type x word x queries a group for one level in one pass, and value type x
// word with the loops).
#include <cooperative_groups.h>
#include <limits.h>

#include "msda_common.cuh"

namespace msda {
namespace walk {

constexpr int THREADS = 256;
// sentinel key of a corner off the level: sorts after every window
constexpr int NO_CORNER = INT_MAX;
// the most levels of one launch, and of words in a pass over a head row
constexpr int MAX_LEVELS = 8;
constexpr int PASS_WORDS = 32;

// One level of a launch, from the host's plan (ops/msda_dense.py:
// walk_plan, one a level).
struct Level {
  int h, w;    // rows and columns of cells
  int start;   // its first cell in an item's value table
  int wr, wc;  // rows and columns of a window
  int wps;     // windows a stage
};

// A level's windows, ceil(h / wr) * ceil(w / wc), and a stage of its wps
// windows of wr * wc cells, a pass's `row_bytes` each, 16-byte aligned.
__host__ __device__ __forceinline__ int level_windows(const Level& lv) {
  return ((lv.h + lv.wr - 1) / lv.wr) * ((lv.w + lv.wc - 1) / lv.wc);
}
__host__ __device__ __forceinline__ long long level_stage_bytes(
    const Level& lv, int row_bytes) {
  return ((long long)lv.wps * lv.wr * lv.wc * row_bytes + 15) / 16 * 16;
}

// The host's plan for one launch.
struct Plan {
  int tq;           // queries a tile
  int nl;           // levels
  int cells;        // cells of an item's value table, all levels
  int passes;       // passes over a head row
  int stage_bytes;  // the largest level's stage
  int nwin;         // the largest level's windows
  Level lv[MAX_LEVELS];
};

// Shared memory of a block: [2 stages][corners: tq * (4P + 1) of (key,
// weight) int2][window flag / rank: nwin int]
// [occupied windows in order: nwin int][query index: tq int]
// [reduction: 128 f32][scan and bounds: 64 int]; the largest level's
// stage and windows, reused from level to level.
static inline size_t smem_bytes(const Plan& pl, int p) {
  const size_t ls = 4 * (size_t)p + 1;
  return 2 * (size_t)pl.stage_bytes + 8 * (size_t)pl.tq * ls +
         4 * (2 * (size_t)pl.nwin + pl.tq + 128 + 64);
}

// VW = WORD / sizeof(T) elements of a staged row at `p`, as float32.
template <typename T, int WORD>
__device__ __forceinline__ void smem_words(const unsigned char* p, float* o) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (WORD == 16) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    } else if constexpr (WORD == 8) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      o[0] = v.x; o[1] = v.y;
    } else {
      o[0] = *reinterpret_cast<const float*>(p);
    }
  } else {
    // bfloat16 is the high half of a float32: element 0 is the low half
    if constexpr (WORD == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = __uint_as_float(w[i] << 16);
        o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else if constexpr (WORD == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      o[0] = __uint_as_float(u.x << 16);
      o[1] = __uint_as_float(u.x & 0xffff0000u);
      o[2] = __uint_as_float(u.y << 16);
      o[3] = __uint_as_float(u.y & 0xffff0000u);
    } else if constexpr (WORD == 4) {
      const unsigned u = *reinterpret_cast<const unsigned*>(p);
      o[0] = __uint_as_float(u << 16);
      o[1] = __uint_as_float(u & 0xffff0000u);
    } else {
      o[0] = __uint_as_float(
          (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
    }
  }
}

// One word global -> shared: cp.async from 4 bytes up, else a plain copy.
template <int WORD>
__device__ __forceinline__ void copy_word(unsigned char* dst,
                                          const unsigned char* src) {
  if constexpr (WORD >= 4)
    cp_async<WORD>(dst, src);
  else
    *reinterpret_cast<unsigned short*>(dst) =
        *reinterpret_cast<const unsigned short*>(src);
}

// Ranks the flagged windows: `flag_rank` holds 0 / 1 per window and on
// return the rank of each flagged one among them (in window order); `occ`
// gets the flagged windows in order. `scratch` is 33 ints. Returns their
// count to every thread. Barriers inside; the results are visible on
// return.
__device__ __forceinline__ int rank_windows(int* flag_rank, int* occ,
                                            int nwin, int* scratch) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (nwin + blockDim.x - 1) / blockDim.x;
  const int beg = min(tid * per, nwin);
  const int end = min(beg + per, nwin);
  int cnt = 0;
  for (int i = beg; i < end; ++i) cnt += flag_rank[i];
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < nwarps ? scratch[lane] : 0;
    int v = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    scratch[lane] = v - own;
    if (lane == 31) scratch[32] = v;
  }
  __syncthreads();
  int r = scratch[warp] + incl - cnt;
  for (int i = beg; i < end; ++i) {
    if (flag_rank[i]) {
      flag_rank[i] = r;
      occ[r] = i;
      ++r;
    }
  }
  const int total = scratch[32];
  __syncthreads();
  return total;
}

// A corner's key as (window rank, cell) from (window, cell).
__device__ __forceinline__ int ranked(int key, const int* rank) {
  return key == NO_CORNER ? key : (rank[key >> 16] << 16) | (key & 0xffff);
}

// The corners of one query sorted by key in registers: a bitonic network
// over SORT_NET slots, the slots past `count` held by sentinels.
constexpr int SORT_NET = 16;
__device__ __forceinline__ void sort_corners_net(int2* cl, int count,
                                                 const int* rank) {
  int2 e[SORT_NET];
#pragma unroll
  for (int i = 0; i < SORT_NET; ++i) {
    e[i] = i < count ? cl[i] : make_int2(NO_CORNER, 0);
    e[i].x = ranked(e[i].x, rank);
  }
#pragma unroll
  for (int k = 2; k <= SORT_NET; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < SORT_NET; ++i) {
        const int l = i ^ j;
        if (l > i && ((e[i].x > e[l].x) == ((i & k) == 0))) {
          const int2 t = e[i];
          e[i] = e[l];
          e[l] = t;
        }
      }
#pragma unroll
  for (int i = 0; i < SORT_NET; ++i)
    if (i < count) cl[i] = e[i];
}

// The same for any count: an insertion sort in shared memory.
__device__ __forceinline__ void sort_corners_insertion(int2* cl, int count,
                                                       const int* rank) {
  for (int e = 0; e < count; ++e) {
    int2 x = cl[e];
    x.x = ranked(x.x, rank);
    int i = e - 1;
    while (i >= 0 && cl[i].x > x.x) {
      cl[i + 1] = cl[i];
      --i;
    }
    cl[i + 1] = x;
  }
}

// The walk. value (N, cells, M*D) in T, the levels back to back; loc (N,
// Lq, M, L, P, 2) f32; attn (N, Lq, M, L, P) f32; the tiles' query order:
// `perm` (N, Lq) int64, else `perm_shared` (Lq) int32 for every item, else
// none; out (N, Lq, M*D) f32. The tile's bounds of a one-level launch,
// written only by a launch as clusters of the M head blocks (null
// otherwise): `ranges` (N, tiles, 4) int32, each tile's inclusive [row lo,
// row hi, column lo, column hi] as v4_ranges gives them (cw == 0: the full
// width); `band` (N, tiles, 2) int32, the row band as v2_row_band gives
// it, clipped to the level; `windows` (N, tiles, 4) int32, [row lo, row
// hi, xstart, fits] as v3_windows gives them for a window of cw columns.
// gridDim = (M, tiles, N), blockDim = THREADS. WORD: the bytes a lane
// reads of a head row at a time (divides D * sizeof(T)); KMAX: the most
// queries a lane group owns. MULTI: the loops over levels and passes, for
// launches of several levels or of rows wider than a warp; without it the
// kernel walks level 0 in one pass, its level's fields at fixed offsets of
// the plan (no loop keeps them, or what a loop hoists, in registers).
template <typename T, int WORD, int KMAX, bool MULTI>
__global__ void __launch_bounds__(THREADS, 3)
    walk_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn,
                const long long* __restrict__ perm,
                const int* __restrict__ perm_shared, float* __restrict__ out,
                int* __restrict__ ranges, int* __restrict__ band,
                int* __restrict__ windows, int lq, int m, int p, int d,
                int cw, Plan pl) {
  constexpr int VW = WORD / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int ls = 4 * p + 1;  // a query's corners and a sentinel
  // a corner: (key, weight as int bits), read and moved as one word
  int2* cor = reinterpret_cast<int2*>(smem + 2 * (size_t)pl.stage_bytes);
  int* rank = reinterpret_cast<int*>(cor + (size_t)pl.tq * ls);
  int* occ = rank + pl.nwin;
  int* qidx = occ + pl.nwin;
  float* red = reinterpret_cast<float*>(qidx + pl.tq);
  int* scratch = reinterpret_cast<int*>(red + 128);
  float* part = reinterpret_cast<float*>(scratch + 40);

  const int head = blockIdx.x;
  const int tile = blockIdx.y;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int md = m * d;
  const int q_begin = tile * pl.tq;
  const int nq = min(pl.tq, lq - q_begin);
  const int nl = MULTI ? pl.nl : 1;
  const int passes = MULTI ? pl.passes : 1;

  for (int j = tid; j < nq; j += nthreads) {
    const int q = q_begin + j;
    qidx[j] = perm != nullptr          ? (int)perm[(size_t)n * lq + q]
              : perm_shared != nullptr ? perm_shared[q]
                                       : q;
    cor[j * ls + 4 * p] = make_int2(NO_CORNER, 0);
  }

  // the lanes: groups of `lanes` lanes, lane `ci` of a group on word ci of
  // a pass's slice of a head row, both to stage the windows and to walk
  // them
  const int es = (int)sizeof(T);
  const int words = d * es / WORD;           // words a head row
  const int lanes = min(words, PASS_WORDS);  // lanes a group
  const int row_bytes = lanes * WORD;        // a pass's slice, staged
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int gpw = 32 / lanes;
  const int gi = lane / lanes;
  const int ci = lane - gi * lanes;
  const int groups = nwarps * gpw;
  const int g = warp * gpw + gi;
  const unsigned char* item = reinterpret_cast<const unsigned char*>(
      value + (size_t)n * pl.cells * md + (size_t)head * d);

  for (int pass = 0; pass < passes; ++pass) {
    const int wi = pass * PASS_WORDS + ci;  // this lane's word of the row
    const bool active = gi < gpw && (!MULTI || wi < words);
    float acc[KMAX][VW];
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[k][e] = 0.f;

    for (int lvl = 0; lvl < nl; ++lvl) {
      const Level& lv = pl.lv[MULTI ? lvl : 0];
      const int h = lv.h, w = lv.w;
      const int wr = lv.wr, wc = lv.wc;
      const int wps = lv.wps, nwin = level_windows(lv);
      const int stage_bytes = (int)level_stage_bytes(lv, row_bytes);
      const int n_cb = (w + wc - 1) / wc;
      // the previous level's corners and windows are read
      if (lvl > 0 || pass > 0) __syncthreads();
      for (int i = tid; i < nwin; i += nthreads) rank[i] = 0;
      __syncthreads();

      // (1) this head's samples at this level, once each: corners,
      // weights, windows
      float xmin = FLT_MAX, xmax = -FLT_MAX, ymin = FLT_MAX, ymax = -FLT_MAX;
      for (int i = tid; i < nq * p; i += nthreads) {
        const int j = i / p;
        const int pt = i - j * p;
        const size_t k =
            ((((size_t)n * lq + qidx[j]) * m + head) * nl + lvl) * p + pt;
        const float x = cell_coord(__ldg(loc + 2 * k), w);
        const float y = cell_coord(__ldg(loc + 2 * k + 1), h);
        const float a = __ldg(attn + k);
        xmin = fminf(xmin, x);
        xmax = fmaxf(xmax, x);
        ymin = fminf(ymin, y);
        ymax = fmaxf(ymax, y);
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float dx = x - x0f;
        const float dy = y - y0f;
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        int2* cl = cor + j * ls + 4 * pt;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cx = x0 + (c & 1);
          const int cy = y0 + (c >> 1);
          if (cx >= 0 && cx < w && cy >= 0 && cy < h) {
            const int win = (cy / wr) * n_cb + cx / wc;
            rank[win] = 1;
            cl[c] = make_int2(
                (win << 16) | ((cy % wr) * wc + cx % wc),
                __float_as_int(a * ((c & 1) ? dx : 1.f - dx) *
                               ((c >> 1) ? dy : 1.f - dy)));
          } else {
            cl[c] = make_int2(NO_CORNER, 0);
          }
        }
      }
      block_min_max2(xmin, xmax, ymin, ymax, red);  // one barrier

      // (2) the tile's bounds over all heads, where the caller asks for
      // them (a one-level launch: once)
      if ((ranges != nullptr || band != nullptr || windows != nullptr) &&
          pass == 0) {
        namespace cg = cooperative_groups;
        cg::cluster_group cluster = cg::this_cluster();
        if (tid == 0) {
          part[0] = xmin;
          part[1] = xmax;
          part[2] = ymin;
          part[3] = ymax;
        }
        cluster.sync();
        if (cluster.block_rank() == 0 && tid == 0) {
          float b[4] = {FLT_MAX, -FLT_MAX, FLT_MAX, -FLT_MAX};
          for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
            const float* o = cluster.map_shared_rank(part, r);
            b[0] = fminf(b[0], o[0]);
            b[1] = fmaxf(b[1], o[1]);
            b[2] = fminf(b[2], o[2]);
            b[3] = fmaxf(b[3], o[3]);
          }
          const size_t t = (size_t)n * gridDim.y + tile;
          if (ranges != nullptr) {
            int* r = ranges + 4 * t;
            r[0] = min(max((int)floorf(b[2]) - 1, 0), h - 1);
            r[1] = min((int)floorf(b[3]) + 1, h - 1);
            r[2] = cw == 0 ? 0 : min(max((int)floorf(b[0]), 0), w - 1);
            r[3] = cw == 0 ? w - 1 : min(max((int)floorf(b[1]) + 1, 0), w - 1);
          }
          if (band != nullptr) {
            band[2 * t] = max(0, (int)floorf(b[2]) - 1);
            band[2 * t + 1] = min(h - 1, (int)floorf(b[3]) + 1);
          }
          if (windows != nullptr) {
            // v3_windows' clipping: rows lo into [0, h], left into
            // [0, w + 1], right into [-1, w - 1]
            int* r = windows + 4 * t;
            const int cwc = min(cw, w);
            const int left = min(max((int)floorf(b[0]), 0), w + 1);
            const int right = min(max((int)floorf(b[1]) + 1, -1), w - 1);
            const bool fits = right - left + 1 <= cwc;
            r[0] = min(max((int)floorf(b[2]) - 1, 0), h);
            r[1] = min(max((int)floorf(b[3]) + 1, -1), h - 1);
            r[2] = fits ? min(left, w - cwc) : 0;
            r[3] = fits ? 1 : 0;
          }
        }
        cluster.sync();  // no block leaves while block 0 reads its partials
      }

      // (3) the occupied windows in order, and the cells this head's
      // corners reach: every staged window is clipped to them
      const int n_occ = rank_windows(rank, occ, nwin, scratch);
      const int br0 = max((int)floorf(ymin), 0);
      const int br1 = min((int)floorf(ymax) + 1, h - 1);
      const int bc0 = max((int)floorf(xmin), 0);
      const int bc1 = min((int)floorf(xmax) + 1, w - 1);

      const unsigned char* level =
          item + (size_t)lv.start * md * es + wi * WORD;
      const int n_stages = (n_occ + wps - 1) / wps;
      const int cells_win = wr * wc;
      // stage s holds the occupied windows of ranks [s * wps, (s + 1) *
      // wps), each as (wr, wc, lanes words) of this pass: the lane groups
      // take its cells in turn (those outside this head's corners are
      // left), a word a lane
      auto prefetch = [&](int s) {
        if (!active) return;
        unsigned char* dst = smem + (size_t)(s & 1) * stage_bytes + ci * WORD;
        for (int i = g; i < wps * cells_win; i += groups) {
          const int slot = i / cells_win;
          const int rk = s * wps + slot;
          if (rk >= n_occ) break;  // i only grows
          const int cell = i - slot * cells_win;
          const int rr = cell / wc;
          const int win = occ[rk];
          const int rs = win / n_cb;
          const int r = rs * wr + rr;
          const int c = (win - rs * n_cb) * wc + cell - rr * wc;
          if (r < br0 || r > br1 || c < bc0 || c > bc1) continue;
          copy_word<WORD>(dst + (size_t)i * row_bytes,
                          level + ((size_t)r * w + c) * md * es);
        }
      };
      if (n_stages > 0) prefetch(0);
      cp_async_commit();

      // each query's corners as (window rank, cell), sorted by rank by the
      // owner thread (off-level corners last): in registers by a sorting
      // network where 4 P <= 16, else an insertion sort in place
      for (int j = tid; j < nq; j += nthreads) {
        int2* cl = cor + j * ls;
        if (4 * p <= SORT_NET)
          sort_corners_net(cl, 4 * p, rank);
        else
          sort_corners_insertion(cl, 4 * p, rank);
      }

      // (4), (5) the walk: group g sums the queries it owns
      int cur[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) cur[k] = 0;
      for (int s = 0; s < n_stages; ++s) {
        if (s + 1 < n_stages) prefetch(s + 1);
        cp_async_commit();
        cp_async_wait(1);  // all but the newest group: stage s has landed
        __syncthreads();   // (the first time also: the corners are sorted)
        if (active) {
          const unsigned char* stg = smem + (size_t)(s & 1) * stage_bytes;
          const int base = s * wps;
          const int limit = (base + wps) << 16;
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            const int j = g + k * groups;
            if (j < nq) {
              // the next corner is loaded while this one is summed; the
              // sentinel after the last stops the walk before it is passed
              const int2* cl = cor + j * ls;
              int c = cur[k];
              int2 e = cl[c];
              while (e.x < limit) {
                const int2 next = cl[c + 1];
                const int cell =
                    ((e.x >> 16) - base) * cells_win + (e.x & 0xffff);
                float v[VW];
                smem_words<T, WORD>(
                    stg + (size_t)cell * row_bytes + ci * WORD, v);
                const float wt = __int_as_float(e.y);
#pragma unroll
                for (int u = 0; u < VW; ++u) acc[k][u] += wt * v[u];
                e = next;
                ++c;
              }
              cur[k] = c;
            }
          }
        }
        __syncthreads();  // stage s is consumed before it is refilled
      }
      cp_async_wait(0);
    }

    // one write per (query, channel), at the query's own index
    if (active) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int j = g + k * groups;
        if (j < nq) {
          float* o = out + ((size_t)n * lq + qidx[j]) * md +
                     (size_t)head * d + wi * VW;
#pragma unroll
          for (int e = 0; e < VW; ++e) o[e] = acc[k][e];
        }
      }
    }
  }
}

// Launches the walk on (M, ceil(Lq / tq), N) blocks, as clusters of the M
// head blocks when the tile's bounds are asked for; returns the launch's
// error or cudaGetLastError().
template <typename T, int WORD, int KMAX, bool MULTI>
static int launch_walk(const void* value, const float* loc, const float* attn,
                       const long long* perm, const int* perm_shared,
                       float* out, int* ranges, int* band, int* windows,
                       int n, int lq, int m, int p, int d, int cw,
                       const Plan& pl, size_t smem, cudaStream_t st) {
  auto kernel = walk_kernel<T, WORD, KMAX, MULTI>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m, (lq + pl.tq - 1) / pl.tq, n);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = m;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs =
      (ranges != nullptr || band != nullptr || windows != nullptr) ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(value), loc,
                           attn, perm, perm_shared, out, ranges, band,
                           windows, lq, m, p, d, cw, pl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instantiations: one a (type, word, queries a group) for a launch of
// one level in one pass, and one a (type, word) with the loops (8 queries
// a group: any tile the lanes can own) for every other launch.
template <typename T, int WORD>
static int launch_kmax(int kmax, bool multi, const void* value,
                       const float* loc,
                       const float* attn, const long long* perm,
                       const int* perm_shared, float* out, int* ranges,
                       int* band, int* windows, int n, int lq, int m, int p,
                       int d, int cw, const Plan& pl, size_t smem,
                       cudaStream_t st) {
#define WALK_K(K, MULTI)                                                  \
  return launch_walk<T, WORD, K, MULTI>(value, loc, attn, perm,           \
                                        perm_shared, out, ranges, band,   \
                                        windows, n, lq, m, p, d, cw, pl,  \
                                        smem, st)
  if (multi) WALK_K(8, true);
  if (kmax == 1) WALK_K(1, false);
  if (kmax == 2) WALK_K(2, false);
  if (kmax == 4) WALK_K(4, false);
  WALK_K(8, false);
#undef WALK_K
}

}  // namespace walk
}  // namespace msda

// Plain C entry point of all four kernels, loaded with ctypes. value (N,
// cells, M*D) in bf16 or f32, the `nl` levels back to back; loc (N, Lq, M,
// nl, P, 2) f32; attn (N, Lq, M, nl, P) f32; the tiles' query order: perm
// (N, Lq) int64, or perm_shared (Lq) int32 for every item, or neither
// (query order); out (N, Lq, M*D) f32. `levels` is a host array of nl x 5
// ints, each level's (h, w, wr, wc, wps). The bounds of a one-level launch,
// each null or (N, ceil(Lq / tq), k) int32: ranges (k = 4) each tile's
// inclusive [row lo, row hi, column lo, column hi] (row lo > row hi: an
// empty walk); band (k = 2) each tile's inclusive row band clipped to the
// level (lo > hi: empty); windows (k = 4) each tile's [row lo, row hi,
// xstart, fits] for a window of `cw` columns. `cw` is the chunk width in
// columns, 0 for the full width. tq, kmax, word and the levels' windows
// are the host's plan (ops/msda_dense.py: walk_plan, levels_plan). Kernel
// v4 / v4p is this launch with `ranges`, v2 with no perm, cw 0 and `band`,
// v3 with `windows`, v6 with all levels and `perm_shared`. Launches on
// `stream` and returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a plan or shape the kernel does not take,
// cudaErrorMisalignedAddress for a word that the value pointer or a head's
// row does not align to.
extern "C" int msda_walk_fwd(const void* value, const void* loc,
                             const void* attn, const void* perm,
                             const void* perm_shared, void* out,
                             void* ranges, void* band, void* windows, int n,
                             int lq, int m, int p, int d, int value_is_bf16,
                             int nl, const int* levels, int cw, int tq,
                             int kmax, int word, void* stream) {
  using namespace msda::walk;
  const int es = value_is_bf16 ? 2 : 4;
  const bool bounds =
      ranges != nullptr || band != nullptr || windows != nullptr;
  if (n < 1 || n > 65535 || lq < 0 || m < 1 || p < 1 || d < 1 || cw < 0 ||
      tq < 1 || nl < 1 || nl > MAX_LEVELS || levels == nullptr ||
      (perm != nullptr && perm_shared != nullptr) ||
      (kmax != 1 && kmax != 2 && kmax != 4 && kmax != 8))
    return (int)cudaErrorInvalidValue;
  // bounds of one level, from clusters of the M head blocks: at most 8,
  // the portable size
  if (bounds && (nl != 1 || m > 8)) return (int)cudaErrorInvalidValue;
  if (windows != nullptr && cw < 1) return (int)cudaErrorInvalidValue;
  if ((word != 2 && word != 4 && word != 8 && word != 16) || word < es ||
      (d * es) % word != 0 || d * es / word > PASS_WORDS * PASS_WORDS)
    return (int)cudaErrorInvalidValue;
  if (((size_t)m * d * es) % word != 0 ||
      reinterpret_cast<uintptr_t>(value) % word != 0)
    return (int)cudaErrorMisalignedAddress;
  const int words = d * es / word;
  const int lanes = words < PASS_WORDS ? words : PASS_WORDS;
  const int groups = (THREADS / 32) * (32 / lanes);
  if (tq > groups * kmax) return (int)cudaErrorInvalidValue;
  Plan pl = {};
  pl.tq = tq;
  pl.nl = nl;
  pl.passes = (words + PASS_WORDS - 1) / PASS_WORDS;
  long long cells = 0;
  for (int i = 0; i < nl; ++i) {
    Level& lv = pl.lv[i];
    lv.h = levels[5 * i];
    lv.w = levels[5 * i + 1];
    lv.wr = levels[5 * i + 2];
    lv.wc = levels[5 * i + 3];
    lv.wps = levels[5 * i + 4];
    if (lv.h < 1 || lv.w < 1 || lv.wr < 1 || lv.wc < 1 || lv.wc > lv.w ||
        lv.wps < 1)
      return (int)cudaErrorInvalidValue;
    // a corner's key is (window << 16 | cell): both must fit
    if ((long long)lv.wr * lv.wc > 65536 ||
        (long long)((lv.h + lv.wr - 1) / lv.wr) * ((lv.w + lv.wc - 1) / lv.wc) +
                lv.wps >= 32768)
      return (int)cudaErrorInvalidValue;
    const int nwin = level_windows(lv);
    const long long stage = level_stage_bytes(lv, lanes * word);
    if (stage > 227 * 1024) return (int)cudaErrorInvalidValue;
    lv.start = (int)cells;
    cells += (long long)lv.h * lv.w;
    if (cells > INT_MAX) return (int)cudaErrorInvalidValue;
    pl.stage_bytes = stage > pl.stage_bytes ? (int)stage : pl.stage_bytes;
    pl.nwin = nwin > pl.nwin ? nwin : pl.nwin;
  }
  pl.cells = (int)cells;
  const size_t smem = smem_bytes(pl, p);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (lq == 0) return (int)cudaGetLastError();
  if ((lq + tq - 1) / tq > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lo = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(attn);
  const long long* pm = static_cast<const long long*>(perm);
  const int* ps = static_cast<const int*>(perm_shared);
  float* o = static_cast<float*>(out);
  int* rg = static_cast<int*>(ranges);
  int* bd = static_cast<int*>(band);
  int* wn = static_cast<int*>(windows);
  const bool multi = nl > 1 || pl.passes > 1;
#define WALK_W(T, WORD)                                                    \
  return launch_kmax<T, WORD>(kmax, multi, value, lo, at, pm, ps, o, rg,   \
                              bd, wn, n, lq, m, p, d, cw, pl, smem, st)
  if (value_is_bf16) {
    if (word == 16) WALK_W(__nv_bfloat16, 16);
    if (word == 8) WALK_W(__nv_bfloat16, 8);
    if (word == 4) WALK_W(__nv_bfloat16, 4);
    WALK_W(__nv_bfloat16, 2);
  }
  if (word == 16) WALK_W(float, 16);
  if (word == 8) WALK_W(float, 8);
  WALK_W(float, 4);
#undef WALK_W
}
