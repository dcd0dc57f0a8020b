// One windowed-encoder layer over every window of a call, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel trackformer_tpu/ops/window_attn.py::_kernel
// (called through _fused_window_layer). For every window of the call (NW
// windows of WS tokens, WS = 64 at window side 8 or 256 at side 16, C
// channels, 8 heads of DH = C / 8):
//
//   q, k = (x + pos) Wq + bq, (x + pos) Wk + bk;   v = x Wv + bv
//   a    = softmax(q k^T / sqrt(DH) with excluded keys at float32 min) v
//   x1   = LayerNorm(x + (a Wo + bo))
//   out  = LayerNorm(x1 + (relu(x1 W1 + b1) W2 + b2))
//
// with the JAX package's rounding: every product accumulates in f32, is
// rounded to the compute type T, and only then gets its bias added in T;
// x + pos is rounded to T; logits and softmax are f32, the probabilities
// are rounded to T before they multiply v; residual sums are rounded to T;
// LayerNorm takes f32 statistics as E[x^2] - E[x]^2 with eps 1e-6. Which
// keys are excluded (slots past a level's edge, and the un-masking of
// fully-padded windows) is decided by the caller.
//
// Every kernel is a template on C, instantiated at the two widths the
// models take: C = 288 (8 heads of 36, the flagship) and C = 256 (8 heads
// of 32, the single-frame Deformable DETR family); the two that see the
// window (the bf16 attention and the float32 layer) also on WS, at 64 and
// 256. The entry points take C (and WS) and refuse any other. The product
// tiles follow C (128 x C or 64 x C, warp tiles C / 4 wide); the
// attention's head segments stay 40 wide.
//
// What bounds it on this card: arithmetic. At the fast mode's B = 8 call
// (NW = 3,040, R = NW * 64 = 194,560 tokens) the five products are 359
// GFLOP of bf16 and the attention 14, against ~2.4 GB of traffic for the
// intermediates below: above the H100's ~295 FLOP/byte ridge. Measured,
// the product stages are bound neither by device memory nor by their
// slabs' barriers: mma.sync fed through shared memory holds them near 200
// TFLOP/s whatever the tile (PERF.md, the window layer's finding).
//
// Design (bf16, the main path). Of the layer only the attention needs the
// window; the four projections and the FFN are per token. So they run as
// five kernels over all R tokens, and only `window_layer_attn` is per
// window. The intermediates go through device memory (ops/window_attn.py
// allocates them): q|k|v (R x 3C), the attention output (R x C), x1
// (R x C) and the FFN hidden (R x ff).
//
//   window_layer_qkv      R x C -> R x 3C, tiles of 128 x C (q, k or
//                         v); the q and k tiles take round(x + pos), formed
//                         in shared memory as each slab lands (no x + pos
//                         buffer), the v tiles take x.
//   window_layer_attn     a block of 4 warps per (window, head, 64 query
//                         rows): k and v of the head's WS keys and q of
//                         the block's rows in shared memory (d_head 36 or
//                         32 padded to 40 with zeros), a warp per 16 query
//                         rows against every key, the logits, softmax and
//                         probabilities in registers (the accumulator of
//                         q k^T is the A operand of p v, as in
//                         FlashAttention-2; WS / 8 key tiles a warp).
//   window_layer_proj_ln  a Wo, tiles of 64 whole rows; epilogue + bo, + x,
//                         then LayerNorm 1 a warp per row -> x1.
//   window_layer_ffn1     x1 W1, tiles of 128 x 128; relu(+ b1) -> h.
//   window_layer_ffn2_ln  h W2 (K = ff), as proj_ln with + b2, + x1,
//                         LayerNorm 2 -> out.
//
// The four product stages share one GEMM core (`Gemm`, `gemm_main`): 8 or
// 16 warps, each owning a register tile; K walked in slabs of 32 through a
// 4-deep cp.async ring in dynamic shared memory with one __syncthreads per
// slab; operands through ldmatrix (.trans for the row-major (in, out)
// weights), products through mma.sync m16n8k16 bf16 -> f32. The epilogues
// start from the accumulator registers and leave through a staging tile in
// the drained ring, with 16-byte stores. Shared rows are padded by 16
// bytes so that the 8 rows an ldmatrix phase reads fall in distinct banks.
// `window_layer_occupancy` reports the blocks per SM the card grants.
//
// float32 (the reference path): one block per (window, 64 query rows),
// scalar FMAs (`window_layer_f32`): each block projects k and v of the
// window's WS keys a head at a time, so a window of 256 tokens projects
// them four times over; its q|k|v weights in the per-head layout padded to
// DHP (48 at d_head 36, 32 at d_head 32) that
// ops/window_attn.py:padded_qkv makes.
//
// wgmma, TMA, a persistent tile scheduler, the FFN with h kept on chip and
// the window-16 attention without its four-fold k / v staging are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <float.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int QT = 64;                   // query rows of a block (per window)
constexpr int NH = 8;                    // heads
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float LN_EPS = 1e-6f;

// the sizes that follow d_model C
template <int C>
struct Width {
  static_assert(C % (NH * 4) == 0 && C % 32 == 0, "d_model");
  static constexpr int DH = C / NH;                  // d_head
  static constexpr int DHP = (DH + 15) / 16 * 16;    // padded (float32)
  static constexpr int QK_LD = NH * 2 * DHP;  // packed q|k of all heads
  static constexpr int V_LD = NH * DHP;       // packed v of all heads
  static constexpr int PACK_LD = QK_LD + V_LD;
  static constexpr int CT = C / 16;           // 16-wide column tiles of C
};

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }
// an f32 value rounded to bf16, read back as f32
__device__ __forceinline__ float rnd_bf(float v) { return to_f(to_bf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm over C of each of the QT rows of src (row stride lds) into dst
// (row stride ldd; shared or global), one warp per row
template <int C, typename T>
__device__ __forceinline__ void layer_norm_rows(const T* src, int lds,
                                                const T* g, const T* b,
                                                T* dst, int ldd) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < QT; r += WARPS) {
    float v[C / 32];
    float s = 0.f;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      v[i] = to_f(src[r * lds + lane + 32 * i]);
      s += v[i];
      s2 += v[i] * v[i];
    }
    const float mean = warp_sum(s) / C;
    const float var = warp_sum(s2) / C - mean * mean;
    const float inv = rsqrtf(var + LN_EPS);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      const float y = (v[i] - mean) * inv * to_f(g[c]) + to_f(b[c]);
      if constexpr (sizeof(T) == 2) {
        dst[r * ldd + c] = to_bf(y);
      } else {
        dst[r * ldd + c] = y;
      }
    }
  }
}

// softmax of each of the QT rows of the QT x WS f32 logits (row stride WS)
// into probabilities of type T (row stride ldp; in place where sPm is
// sS), one warp per row, WS / 32 columns per lane
template <int WS, typename T>
__device__ __forceinline__ void softmax_rows(const float* sS, T* sPm,
                                             int ldp) {
  constexpr int PER = WS / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < QT; r += WARPS) {
    float v[PER];
    float m = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = sS[r * WS + lane + 32 * i];
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = expf(v[i] - m);
      s += v[i];
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if constexpr (sizeof(T) == 2) {
        sPm[r * ldp + lane + 32 * i] = to_bf(v[i] / s);
      } else {
        sPm[r * ldp + lane + 32 * i] = v[i] / s;
      }
    }
  }
}

// ===========================================================================
// bfloat16: token-tiled tensor-core stages
// ===========================================================================

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and register i holds this lane's pair of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col), f32 d. The
// fragments: lane = 4 g + t holds A rows g, g + 8 at columns 2t, 2t + 1
// (registers 0, 1) and 2t + 8, 2t + 9 (registers 2, 3); B rows (k) 2t,
// 2t + 1 (register 0) and 2t + 8, 2t + 9 (register 1) of column g; d rows
// g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16, packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void store_bf2(bf16* p, float lo, float hi) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ float2 load_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

constexpr int BK = 32;                   // depth of a slab
constexpr int SPAD = 8;                  // 16 bytes of padding per row
constexpr int LDAS = BK + SPAD;          // shared row stride of an A slab

// A tile of BM x BN outputs, WM x WN warps, a STAGES-deep ring, at least
// MINB blocks per SM (the register cap); with POS a second A buffer per
// stage holds the slab of pos, added to x in place
template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MINB_,
          bool POS_>
struct Gemm {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr bool POS = POS_;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;    // its mma tiles
  static_assert(WTM % 16 == 0 && WTN % 8 == 0, "warp tile");
  static constexpr int LDBS = BN + SPAD;
  static constexpr int A_EL = BM * LDAS;
  static constexpr int B_EL = BK * LDBS;
  static constexpr int STAGE_EL = (POS ? 2 : 1) * A_EL + B_EL;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_EL * sizeof(bf16);
};

// slab k0 .. k0 + 31 of rows row0 .. row0 + BM - 1 of A (and P) and of the
// BN columns of B into stage st. Rows past `rows` repeat the last row (the
// epilogues store none of them). Thread i copies chunks i, i +
// THREADS, ...
template <class G>
__device__ __forceinline__ void load_stage(bf16* st, const bf16* A,
                                           const bf16* P, int lda, int row0,
                                           int rows, const bf16* B, int ldb,
                                           int k0) {
  bf16* sa = st;
  bf16* sp = st + G::A_EL;
  bf16* sb = st + (G::POS ? 2 : 1) * G::A_EL;
  for (int i = threadIdx.x; i < G::BM * (BK / 8); i += G::THREADS) {
    const int r = i / (BK / 8);
    const int c = (i % (BK / 8)) * 8;
    const size_t off = (size_t)min(row0 + r, rows - 1) * lda + k0 + c;
    cp_async16(sa + r * LDAS + c, A + off);
    if (G::POS && P != nullptr) cp_async16(sp + r * LDAS + c, P + off);
  }
  constexpr int CPR = G::BN / 8;
  for (int i = threadIdx.x; i < BK * CPR; i += G::THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    cp_async16(sb + r * G::LDBS + c, B + (size_t)(k0 + r) * ldb + c);
  }
}

// A := round(A + P) over this thread's own chunks of stage st (the ones it
// copied, so its own wait_group is enough)
template <class G>
__device__ __forceinline__ void add_pos(bf16* st) {
  bf16* sa = st;
  const bf16* sp = st + G::A_EL;
  for (int i = threadIdx.x; i < G::BM * (BK / 8); i += G::THREADS) {
    const int at = (i / (BK / 8)) * LDAS + (i % (BK / 8)) * 8;
    uint4 xa = *reinterpret_cast<const uint4*>(sa + at);
    const uint4 pa = *reinterpret_cast<const uint4*>(sp + at);
    bf16* xe = reinterpret_cast<bf16*>(&xa);
    const bf16* pe = reinterpret_cast<const bf16*>(&pa);
#pragma unroll
    for (int j = 0; j < 8; ++j) xe[j] = to_bf(to_f(xe[j]) + to_f(pe[j]));
    *reinterpret_cast<uint4*>(sa + at) = xa;
  }
}

template <class G>
__device__ __forceinline__ void compute_slab(
    float (&acc)[G::MT][G::NT][4], const bf16* st, int wm0, int wn0,
    int lane) {
  const bf16* sa = st;
  const bf16* sb = st + (G::POS ? 2 : 1) * G::A_EL;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[G::MT][4];
    uint32_t b[G::NT][2];
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
      ldsm_x4(a[i], sa + (wm0 + 16 * i + (lane & 15)) * LDAS + kk +
                        (lane >> 4) * 8);
    const bf16* brow = sb + (kk + (lane & 15)) * G::LDBS + wn0;
#pragma unroll
    for (int p = 0; p < G::NT / 2; ++p) {
      uint32_t r[4];
      ldsm_x4_t(r, brow + 16 * p + (lane >> 4) * 8);
      b[2 * p][0] = r[0];
      b[2 * p][1] = r[1];
      b[2 * p + 1][0] = r[2];
      b[2 * p + 1][1] = r[3];
    }
    if constexpr (G::NT % 2 == 1) {
      uint32_t r[2];
      ldsm_x2_t(r, brow + 16 * (G::NT / 2));
      b[G::NT - 1][0] = r[0];
      b[G::NT - 1][1] = r[1];
    }
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
        mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// acc = A[row0 .. row0 + BM) (K columns, row-major lda; with P, round(A +
// P)) B (K x BN, row-major ldb, already at the tile's first column), f32.
// Ends with every copy landed and every thread past its last read of smem.
template <class G>
__device__ __forceinline__ void gemm_main(float (&acc)[G::MT][G::NT][4],
                                          const bf16* A, const bf16* P,
                                          int lda, int row0, int rows,
                                          const bf16* B, int ldb, int K,
                                          bf16* smem) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm0 = (warp / G::WN) * G::WTM;
  const int wn0 = (warp % G::WN) * G::WTN;
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < nk)
      load_stage<G>(smem + s * G::STAGE_EL, A, P, lda, row0, rows, B, ldb,
                    s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // slab kt has landed for this thread's copies ...
    cp_async_wait<G::STAGES - 2>();
    bf16* st = smem + (kt % G::STAGES) * G::STAGE_EL;
    if (G::POS && P != nullptr) add_pos<G>(st);
    // ... and for every thread's; every warp is done with slab kt - 1,
    // whose buffer the next copy refills
    __syncthreads();
    const int nxt = kt + G::STAGES - 1;
    if (nxt < nk)
      load_stage<G>(smem + (nxt % G::STAGES) * G::STAGE_EL, A, P, lda, row0,
                    rows, B, ldb, nxt * BK);
    cp_async_commit();
    compute_slab<G>(acc, st, wm0, wn0, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The tile's outputs epi(column, acc, acc') -> a pair, rounded to bf16 into
// a staging tile (BM x (BN + 8)) over the drained ring, then written to out
// (rows, ldo) at (row0, col0) with 16-byte stores, a row's BN columns by
// neighbouring threads
template <class G, typename Epi>
__device__ __forceinline__ void store_tile(const float (&acc)[G::MT][G::NT][4],
                                           bf16* smem, bf16* out, int ldo,
                                           int row0, int col0, int rows,
                                           Epi epi) {
  constexpr int LD = G::BN + SPAD;
  static_assert(G::BM * LD <= G::STAGES * G::STAGE_EL, "staging fits");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rbase = (warp / G::WN) * G::WTM + (lane >> 2);
  const int cbase = (warp % G::WN) * G::WTN + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < G::NT; ++j) {
    const int c = cbase + 8 * j;
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = epi(col0 + c, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        store_bf2(smem + (rbase + 16 * i + 8 * h) * LD + c, v.x, v.y);
      }
  }
  __syncthreads();
  constexpr int CPR = G::BN / 8;
  for (int i = threadIdx.x; i < G::BM * CPR; i += G::THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * ldo + col0 + c) =
          *reinterpret_cast<const uint4*>(smem + r * LD + c);
  }
}

// ---- stage 1: q|k|v --------------------------------------------------------

// 128 x C: the three column tiles q, k, v; 16 warps of 32 x C / 4, one
// block per SM
template <int C>
using GQkv = Gemm<128, C, 4, 4, 4, 1, true>;
static_assert((2 * 288) % GQkv<288>::BN == 0,
              "no q|k tile straddles column 2C = 576");
static_assert((2 * 256) % GQkv<256>::BN == 0,
              "no q|k tile straddles column 2C = 512");

// x, pos: (rows, C); w: (C, 3C) = in_proj_weight^T, columns q | k | v of
// all heads; b: (3C); out: (rows, 3C) = rnd(rnd(acc) + b). Grid
// (3, ceil(rows / 128)): the column tiles of a row tile run side by side,
// so that its rows are read from memory once and then from L2.
template <int C>
__global__ void __launch_bounds__(GQkv<C>::THREADS, GQkv<C>::MINB)
    window_layer_qkv_kernel(const bf16* __restrict__ x,
                            const bf16* __restrict__ pos,
                            const bf16* __restrict__ w,
                            const bf16* __restrict__ b, bf16* __restrict__ out,
                            int rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  typedef GQkv<C> G;
  const int row0 = blockIdx.y * G::BM;
  const int col0 = blockIdx.x * G::BN;
  float acc[G::MT][G::NT][4];
  gemm_main<G>(acc, x, col0 < 2 * C ? pos : nullptr, C, row0, rows,
               w + col0, 3 * C, C, smem);
  store_tile<G>(acc, smem, out, 3 * C, row0, col0, rows,
                [&](int c, float a0, float a1) {
                  const float2 bias = load_bf2(b + c);
                  return make_float2(rnd_bf(a0) + bias.x,
                                     rnd_bf(a1) + bias.y);
                });
}

// ---- stage 2: attention ---------------------------------------------------

// each head's q, k and v segment in shared memory, d_head padded to 40
// with zeros: 272-byte rows (17 16-byte units, odd: the 8 rows an ldmatrix
// phase reads fall in distinct banks) at both widths
constexpr int AT_SEG = 40;
constexpr int AT_LD = 3 * AT_SEG + 16;   // q | k | v | 16
constexpr int AT_THREADS = 128;          // a warp per 16 query rows

// shared bytes of the attention's block: WS rows of q | k | v | pad (q
// filled only at the block's own rows)
template <int WS>
constexpr size_t attn_smem_bytes() {
  return (size_t)WS * AT_LD * sizeof(bf16);
}

// qkv: (NW * WS, 3C) from stage 1; kp: (NW, WS) uint8, 1 = exclude the
// key; out: (NW * WS, C), head h at columns DH h .. DH h + DH - 1. Block
// per (window, head, QT query rows): blockIdx.x = (window * 8 + head) *
// (WS / QT) + tile, so that the tiles of a head run side by side and read
// its k and v from L2.
template <int C, int WS>
__global__ void __launch_bounds__(AT_THREADS)
    window_layer_attn_kernel(const bf16* __restrict__ qkv,
                             const uint8_t* __restrict__ kp,
                             bf16* __restrict__ out) {
  constexpr int DH = Width<C>::DH;
  static_assert(DH % 4 == 0 && DH <= AT_SEG, "d_head fits its segment");
  static_assert(WS % QT == 0 && QT == 16 * (AT_THREADS / 32), "tiles");
  constexpr int NQT = WS / QT;           // query tiles of a window
  constexpr int NKT = WS / 8;            // 8-wide key tiles
  constexpr int WORDS = DH / 4;          // 8-byte words of a head segment
  constexpr int PADW = (AT_SEG - DH) / 4;
  constexpr int DH8 = (DH + 7) / 8 * 8;  // columns the products read
  constexpr int KS = (DH + 15) / 16;     // k steps of q k^T
  constexpr int NTO = (DH + 7) / 8;      // 8-wide column tiles of p v
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s = reinterpret_cast<bf16*>(smem_raw);
  __shared__ bool excluded[WS];
  const int win = blockIdx.x / (NH * NQT);
  const int h = (blockIdx.x / NQT) % NH;
  const int qrow0 = (blockIdx.x % NQT) * QT;
  const int tid = threadIdx.x;
  const bf16* src = qkv + (size_t)win * WS * 3 * C + h * DH;
  // the padding of each head segment, d_head .. 39: zeros, which the
  // logits' last k step reads at d_head 36 (its A columns 36 .. 39 are
  // q's)
  for (int i = tid; i < WS * 3 * PADW; i += AT_THREADS) {
    const int r = i / (3 * PADW);
    const int seg = (i / PADW) % 3;
    *reinterpret_cast<uint2*>(s + r * AT_LD + seg * AT_SEG + DH +
                              4 * (i % PADW)) = make_uint2(0u, 0u);
  }
  // k and v of the head: WS rows x 2 segments x DH / 4 words of 8 bytes (a
  // head starts 2 DH bytes after the last: 8-byte aligned only at DH 36)
  for (int i = tid; i < WS * 2 * WORDS; i += AT_THREADS) {
    const int r = i / (2 * WORDS);
    const int seg = 1 + (i % (2 * WORDS)) / WORDS;
    const int w = i % WORDS;
    cp_async8(s + r * AT_LD + seg * AT_SEG + 4 * w,
              src + (size_t)r * 3 * C + seg * C + 4 * w);
  }
  // q of the block's QT rows
  for (int i = tid; i < QT * WORDS; i += AT_THREADS) {
    const int r = qrow0 + i / WORDS;
    const int w = i % WORDS;
    cp_async8(s + r * AT_LD + 4 * w, src + (size_t)r * 3 * C + 4 * w);
  }
  cp_async_commit();
  for (int i = tid; i < WS; i += AT_THREADS)
    excluded[i] = kp[(size_t)win * WS + i] != 0;
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int q0 = qrow0 + 16 * warp;
  // logits of rows q0 + g, q0 + g + 8 against the WS keys, NKT tiles of 8
  float sc[NKT][4];
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, s + (q0 + (lane & 15)) * AT_LD + 16 * ks + (lane >> 4) * 8);
    if (16 * ks + 8 >= DH8) {  // columns 40 .. 47 lie in the next segment
      a[2] = 0u;
      a[3] = 0u;
    }
#pragma unroll
    for (int p = 0; p < NKT / 2; ++p) {
      uint32_t kb[4];
      ldsm_x4(kb, s + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * AT_LD +
                      AT_SEG + 16 * ks + ((lane >> 3) & 1) * 8);
      mma_bf16(sc[2 * p], a, kb[0], kb[1]);
      mma_bf16(sc[2 * p + 1], a, kb[2], kb[3]);
    }
  }
  const float scale = 1.f / sqrtf((float)DH);
  float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      sc[j][e] = excluded[key] ? -FLT_MAX : sc[j][e] * scale;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = expf(sc[j][e] - mx[e >> 1]);
      sum[e >> 1] += sc[j][e];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
  }
  // p v: the probabilities, rounded to bf16, are the A operand straight
  // from the logits' registers (key tiles 2 ks and 2 ks + 1)
  float o[NTO][4];
#pragma unroll
  for (int j = 0; j < NTO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NKT / 2; ++ks) {
    uint32_t a[4];
    a[0] = pack_bf2(sc[2 * ks][0] / sum[0], sc[2 * ks][1] / sum[0]);
    a[1] = pack_bf2(sc[2 * ks][2] / sum[1], sc[2 * ks][3] / sum[1]);
    a[2] = pack_bf2(sc[2 * ks + 1][0] / sum[0], sc[2 * ks + 1][1] / sum[0]);
    a[3] = pack_bf2(sc[2 * ks + 1][2] / sum[1], sc[2 * ks + 1][3] / sum[1]);
    const bf16* vrow = s + (16 * ks + (lane & 15)) * AT_LD + 2 * AT_SEG;
#pragma unroll
    for (int p = 0; p < NTO / 2; ++p) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vrow + 16 * p + (lane >> 4) * 8);
      mma_bf16(o[2 * p], a, vb[0], vb[1]);
      mma_bf16(o[2 * p + 1], a, vb[2], vb[3]);
    }
    if constexpr (NTO % 2 == 1) {
      uint32_t vb[2];
      ldsm_x2_t(vb, vrow + 16 * (NTO / 2));
      mma_bf16(o[NTO - 1], a, vb[0], vb[1]);
    }
  }
  const size_t row = (size_t)win * WS + q0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    const int c = 8 * j + 2 * t;
    if (c < DH) {
      bf16* dst = out + row * C + h * DH + c;
      store_bf2(dst, o[j][0], o[j][1]);
      store_bf2(dst + 8 * C, o[j][2], o[j][3]);
    }
  }
}

// ---- stages 3 and 5: a product of whole rows, residual, LayerNorm ---------

// 64 whole rows; 8 warps of 32 x C / 4, two blocks per SM
template <int C>
using GRow = Gemm<64, C, 2, 4, 4, 2, false>;

// out = LayerNorm(res + rnd(rnd(A W) + b)) over the BM rows of this block:
// A (rows, K), W (K, C), res and out (rows, C)
template <int C>
__device__ __forceinline__ void row_product_ln(
    const bf16* A, int K, const bf16* w, const bf16* b, const bf16* res,
    const bf16* g, const bf16* be, bf16* out, int rows, bf16* smem) {
  typedef GRow<C> G;
  constexpr int LDST = C + SPAD;         // staging tile of the epilogue
  static_assert(G::BM * LDST <= G::STAGES * G::STAGE_EL,
                "the staging tile fits the ring");
  const int row0 = blockIdx.x * G::BM;
  float acc[G::MT][G::NT][4];
  gemm_main<G>(acc, A, nullptr, K, row0, rows, w, C, K, smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  {  // y = rnd(res + rnd(rnd(acc) + b)) into the staging tile, over the
     // drained ring; rows past `rows` read the last row
    const int rbase = (warp / G::WN) * G::WTM + (lane >> 2);
    const int cbase = (warp % G::WN) * G::WTN + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < G::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rbase + 16 * i + 8 * h;
        const bf16* rrow = res + (size_t)min(row0 + r, rows - 1) * C;
#pragma unroll
        for (int j = 0; j < G::NT; ++j) {
          const int c = cbase + 8 * j;
          const float2 bias = load_bf2(b + c);
          const float2 rv = load_bf2(rrow + c);
          store_bf2(smem + r * LDST + c,
                    rv.x + rnd_bf(rnd_bf(acc[i][j][2 * h]) + bias.x),
                    rv.y + rnd_bf(rnd_bf(acc[i][j][2 * h + 1]) + bias.y));
        }
      }
  }
  __syncthreads();
  // LayerNorm a warp per row, C / 32 columns a lane, in place
  for (int r = warp; r < G::BM; r += G::THREADS / 32) {
    bf16* row = smem + r * LDST;
    float v[C / 32];
    float s = 0.f;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      v[i] = to_f(row[lane + 32 * i]);
      s += v[i];
      s2 += v[i] * v[i];
    }
    const float mean = warp_sum(s) / C;
    const float var = warp_sum(s2) / C - mean * mean;
    const float inv = rsqrtf(var + LN_EPS);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      row[c] = to_bf((v[i] - mean) * inv * to_f(g[c]) + to_f(be[c]));
    }
  }
  __syncthreads();
  // the tile's rows are contiguous in `out`: 16-byte stores
  const int n_rows = min(G::BM, rows - row0);
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row0 * C);
  for (int i = threadIdx.x; i < n_rows * (C / 8); i += G::THREADS)
    dst[i] = *reinterpret_cast<const uint4*>(smem + (i / (C / 8)) * LDST +
                                             (i % (C / 8)) * 8);
}

// x1 = LayerNorm1(x + rnd(rnd(a Wo) + bo)); a, x, x1: (rows, C). Grid
// ceil(rows / 64).
template <int C>
__global__ void __launch_bounds__(GRow<C>::THREADS, GRow<C>::MINB)
    window_layer_proj_ln_kernel(const bf16* __restrict__ a,
                                const bf16* __restrict__ wo,
                                const bf16* __restrict__ bo,
                                const bf16* __restrict__ x,
                                const bf16* __restrict__ g1,
                                const bf16* __restrict__ be1,
                                bf16* __restrict__ x1, int rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  row_product_ln<C>(a, C, wo, bo, x, g1, be1, x1, rows,
                 reinterpret_cast<bf16*>(smem_raw));
}

// out = LayerNorm2(x1 + rnd(rnd(h W2) + b2)); h: (rows, ff). Grid
// ceil(rows / 64).
template <int C>
__global__ void __launch_bounds__(GRow<C>::THREADS, GRow<C>::MINB)
    window_layer_ffn2_ln_kernel(const bf16* __restrict__ hid,
                                const bf16* __restrict__ w2,
                                const bf16* __restrict__ b2,
                                const bf16* __restrict__ x1,
                                const bf16* __restrict__ g2,
                                const bf16* __restrict__ be2,
                                bf16* __restrict__ out, int rows, int ff) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  row_product_ln<C>(hid, ff, w2, b2, x1, g2, be2, out, rows,
                 reinterpret_cast<bf16*>(smem_raw));
}

// ---- stage 4: FFN up-projection ------------------------------------------

// 128 x 128; 8 warps of 64 x 32, two blocks per SM
typedef Gemm<128, 128, 2, 4, 4, 2, false> GFfn;

// h = relu(rnd(rnd(x1 W1) + b1)); x1: (rows, C), w1: (C, ff), h: (rows,
// ff). Grid (ff / 128, ceil(rows / 128)), column tiles side by side.
template <int C>
__global__ void __launch_bounds__(GFfn::THREADS, GFfn::MINB)
    window_layer_ffn1_kernel(const bf16* __restrict__ x1,
                             const bf16* __restrict__ w1,
                             const bf16* __restrict__ b1,
                             bf16* __restrict__ hid, int rows, int ff) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  typedef GFfn G;
  const int row0 = blockIdx.y * G::BM;
  const int col0 = blockIdx.x * G::BN;
  float acc[G::MT][G::NT][4];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  gemm_main<G>(acc, x1, nullptr, C, row0, rows, w1 + col0, ff, C, smem);
  store_tile<G>(acc, smem, hid, ff, row0, col0, rows,
                [&](int c, float a0, float a1) {
                  const float2 bias = load_bf2(b1 + c);
                  return make_float2(
                      fmaxf(rnd_bf(rnd_bf(a0) + bias.x), 0.f),
                      fmaxf(rnd_bf(rnd_bf(a1) + bias.y), 0.f));
                });
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool misaligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
}

// ===========================================================================
// float32: scalar FMAs
// ===========================================================================

constexpr int FC = 64;                   // FFN hidden chunk

// QT x (16 NJ) output of A (QT x k_len, element (r, k) from a(r, k)) B
// (k_len x 16 NJ, row-major ldb, or column-major when B_COL): thread (rg,
// cg) computes rows 4 rg .. 4 rg + 3 of the columns cg, cg + 16, ...;
// epi(row, col, sum) once per element
template <int NJ, bool B_COL, typename LoadA, typename Epi>
__device__ __forceinline__ void gemm_scalar(LoadA a_at, const float* B,
                                            int ldb, int k_len, Epi epi) {
  static_assert(QT == 4 * (THREADS / 16), "a thread per 4 rows x 16 cols");
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < k_len; ++k) {
    float a[4];
    float b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_at(rg * 4 + i, k);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = B_COL ? B[(size_t)(cg + 16 * j) * ldb + k]
                   : B[(size_t)k * ldb + cg + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) epi(rg * 4 + i, cg + 16 * j, acc[i][j]);
}

// an A operand read from rows of stride ld (shared or global)
struct RowsA {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return p[r * ld + k];
  }
};

// x + pos of rows of stride C, summed as read (no rounding in float32)
struct SumA {
  const float* x;
  const float* pos;
  int ld;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return x[r * ld + k] + pos[r * ld + k];
  }
};

// shared floats of the float32 block: the attention's q (QT x DHP), k and
// v (WS x DHP each) and logits (QT x WS), then, over the same memory, the
// FFN's x1 and x1 + ffn (QT x C each) and hidden chunk (QT x FC)
template <int C, int WS>
constexpr size_t f32_smem_bytes() {
  constexpr size_t attn =
      (size_t)QT * Width<C>::DHP + 2 * (size_t)WS * Width<C>::DHP + QT * WS;
  constexpr size_t ffn = 2 * (size_t)QT * C + QT * FC;
  return (attn > ffn ? attn : ffn) * sizeof(float);
}

// x, pos, out: (NW, WS, C); kp: (NW, WS) uint8, 1 = exclude the key;
// wqkv (C, PACK_LD), bqkv (PACK_LD): the q and k columns of each head side
// by side, then the v columns of all heads, each head padded to DHP; wo
// (C, C); w1 (C, ff); w2 (ff, C): row-major (in, out). One block per
// (window, QT query rows): blockIdx.x = window * (WS / QT) + tile; no
// rounding between the steps.
template <int C, int WS>
__global__ void __launch_bounds__(THREADS, 1)
    window_layer_f32(const float* __restrict__ x,
                     const float* __restrict__ pos,
                     const uint8_t* __restrict__ kp,
                     const float* __restrict__ wqkv,
                     const float* __restrict__ bqkv,
                     const float* __restrict__ wo, const float* __restrict__ bo,
                     const float* __restrict__ g1,
                     const float* __restrict__ be1,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ g2,
                     const float* __restrict__ be2, float* out, int ff) {
  constexpr int DH = Width<C>::DH, DHP = Width<C>::DHP;
  constexpr int QK_LD = Width<C>::QK_LD, PACK_LD = Width<C>::PACK_LD;
  constexpr int CT = Width<C>::CT;
  constexpr int NQT = WS / QT;
  static_assert(WS % QT == 0 && WS % 32 == 0, "window");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ bool excluded[WS];
  float* sQ = reinterpret_cast<float*>(smem);  // one head's q (QT x DHP)
  float* sK = sQ + QT * DHP;              // its k, v over the window's keys
  float* sV = sK + WS * DHP;
  float* sS = sV + WS * DHP;              // logits, then probabilities
  float* sP = reinterpret_cast<float*>(smem);  // x + attn, then x1
  float* sX = sP + QT * C;                // x1 + ffn
  float* sH = sX + QT * C;                // FFN hidden chunk (QT x FC)

  const int win = blockIdx.x / NQT;
  const size_t wbase = (size_t)win * WS * C;
  const size_t tbase = wbase + (size_t)(blockIdx.x % NQT) * QT * C;
  const float* xt = x + tbase;
  // the attention output (QT x C) is staged in the block's rows of `out`
  float* o_t = out + tbase;
  for (int i = threadIdx.x; i < WS; i += THREADS)
    excluded[i] = kp[(size_t)win * WS + i] != 0;

  const float inv_scale = 1.f / sqrtf((float)DH);
  for (int h = 0; h < NH; ++h) {
    const int qc = h * 2 * DHP;           // the head's q columns, then k
    gemm_scalar<DHP / 16, false>(
        SumA{xt, pos + tbase, C}, wqkv + qc, PACK_LD, C,
        [&](int r, int c, float a) { sQ[r * DHP + c] = a + bqkv[qc + c]; });
    for (int k0 = 0; k0 < WS; k0 += QT) {
      const size_t kb = wbase + (size_t)k0 * C;
      gemm_scalar<DHP / 16, false>(
          SumA{x + kb, pos + kb, C}, wqkv + qc + DHP, PACK_LD, C,
          [&](int r, int c, float a) {
            sK[(k0 + r) * DHP + c] = a + bqkv[qc + DHP + c];
          });
      gemm_scalar<DHP / 16, false>(
          RowsA{x + kb, C}, wqkv + QK_LD + h * DHP, PACK_LD, C,
          [&](int r, int c, float a) {
            sV[(k0 + r) * DHP + c] = a + bqkv[QK_LD + h * DHP + c];
          });
    }
    __syncthreads();
    for (int k0 = 0; k0 < WS; k0 += QT)
      gemm_scalar<QT / 16, true>(RowsA{sQ, DHP}, sK + k0 * DHP, DHP, DHP,
                                 [&](int r, int c, float a) {
                                   sS[r * WS + k0 + c] =
                                       excluded[k0 + c] ? -FLT_MAX
                                                        : a * inv_scale;
                                 });
    __syncthreads();
    softmax_rows<WS>(sS, sS, WS);
    __syncthreads();
    gemm_scalar<DHP / 16, false>(RowsA{sS, WS}, sV, DHP, WS,
                                 [&](int r, int c, float a) {
                                   if (c < DH) o_t[r * C + h * DH + c] = a;
                                 });
    __syncthreads();
  }

  gemm_scalar<CT, false>(RowsA{o_t, C}, wo, C, C, [&](int r, int c, float a) {
    sP[r * C + c] = xt[r * C + c] + (a + bo[c]);
  });
  __syncthreads();
  layer_norm_rows<C>(sP, C, g1, be1, sP, C);
  __syncthreads();

  // FFN: thread (rg, cg) holds rows 4 rg.. of columns cg, cg + 16, ...
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;
  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
  for (int chunk = 0; chunk < ff; chunk += FC) {
    gemm_scalar<FC / 16, false>(RowsA{sP, C}, w1 + chunk, ff, C,
                                [&](int r, int c, float a) {
                                  sH[r * FC + c] =
                                      fmaxf(a + b1[chunk + c], 0.f);
                                });
    __syncthreads();
    for (int k = 0; k < FC; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sH[(rg * 4 + i) * FC + k];
      const float* w2k = w2 + (size_t)(chunk + k) * C + cg;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float b = w2k[16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int r = rg * 4 + i;
      const int c = cg + 16 * j;
      sX[r * C + c] = sP[r * C + c] + (acc[i][j] + b2[c]);
    }
  __syncthreads();
  layer_norm_rows<C>(sX, C, g2, be2, o_t, C);
}

// the launches of each stage at width C, called by the C entry points
// below once they have checked the arguments

template <int C>
int launch_qkv(const void* x, const void* pos, const void* w, const void* b,
               void* out, int rows, cudaStream_t stream) {
  typedef GQkv<C> G;
  int err = set_smem(window_layer_qkv_kernel<C>, G::SMEM);
  if (err) return err;
  if ((rows + G::BM - 1) / G::BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(3 * C / G::BN, (rows + G::BM - 1) / G::BM);
  window_layer_qkv_kernel<C><<<grid, G::THREADS, G::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(pos),
      static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), rows);
  return (int)cudaGetLastError();
}

template <int C, int WS>
int launch_attn(const void* qkv, const void* kp, void* out, int nw,
                cudaStream_t stream) {
  int err = set_smem(window_layer_attn_kernel<C, WS>, attn_smem_bytes<WS>());
  if (err) return err;
  window_layer_attn_kernel<C, WS>
      <<<nw * NH * (WS / QT), AT_THREADS, attn_smem_bytes<WS>(), stream>>>(
          static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(kp),
          static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

template <int C>
int launch_proj_ln(const void* a, const void* wo, const void* bo,
                   const void* x, const void* g1, const void* be1, void* x1,
                   int rows, cudaStream_t stream) {
  typedef GRow<C> G;
  int err = set_smem(window_layer_proj_ln_kernel<C>, G::SMEM);
  if (err) return err;
  window_layer_proj_ln_kernel<C><<<(rows + G::BM - 1) / G::BM, G::THREADS,
                                   G::SMEM, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(bo), static_cast<const bf16*>(x),
      static_cast<const bf16*>(g1), static_cast<const bf16*>(be1),
      static_cast<bf16*>(x1), rows);
  return (int)cudaGetLastError();
}

template <int C>
int launch_ffn1(const void* x1, const void* w1, const void* b1, void* hid,
                int rows, int ff, cudaStream_t stream) {
  typedef GFfn G;
  int err = set_smem(window_layer_ffn1_kernel<C>, G::SMEM);
  if (err) return err;
  if ((rows + G::BM - 1) / G::BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(ff / G::BN, (rows + G::BM - 1) / G::BM);
  window_layer_ffn1_kernel<C><<<grid, G::THREADS, G::SMEM, stream>>>(
      static_cast<const bf16*>(x1), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<bf16*>(hid), rows, ff);
  return (int)cudaGetLastError();
}

template <int C>
int launch_ffn2_ln(const void* hid, const void* w2, const void* b2,
                   const void* x1, const void* g2, const void* be2, void* out,
                   int rows, int ff, cudaStream_t stream) {
  typedef GRow<C> G;
  int err = set_smem(window_layer_ffn2_ln_kernel<C>, G::SMEM);
  if (err) return err;
  window_layer_ffn2_ln_kernel<C><<<(rows + G::BM - 1) / G::BM, G::THREADS,
                                   G::SMEM, stream>>>(
      static_cast<const bf16*>(hid), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(x1),
      static_cast<const bf16*>(g2), static_cast<const bf16*>(be2),
      static_cast<bf16*>(out), rows, ff);
  return (int)cudaGetLastError();
}

template <int C, int WS>
int occupancy(int stage, int* blocks, int* smem_bytes) {
  int err = 0;
  size_t smem = 0;
  const void* fn = nullptr;
  int threads = 0;
  switch (stage) {
    case 0:
      threads = GQkv<C>::THREADS;
      smem = GQkv<C>::SMEM;
      err = set_smem(window_layer_qkv_kernel<C>, smem);
      fn = (const void*)window_layer_qkv_kernel<C>;
      break;
    case 1:
      threads = AT_THREADS;
      smem = attn_smem_bytes<WS>();
      err = set_smem(window_layer_attn_kernel<C, WS>, smem);
      fn = (const void*)window_layer_attn_kernel<C, WS>;
      break;
    case 2:
      threads = GRow<C>::THREADS;
      smem = GRow<C>::SMEM;
      err = set_smem(window_layer_proj_ln_kernel<C>, smem);
      fn = (const void*)window_layer_proj_ln_kernel<C>;
      break;
    case 3:
      threads = GFfn::THREADS;
      smem = GFfn::SMEM;
      err = set_smem(window_layer_ffn1_kernel<C>, smem);
      fn = (const void*)window_layer_ffn1_kernel<C>;
      break;
    case 4:
      threads = GRow<C>::THREADS;
      smem = GRow<C>::SMEM;
      err = set_smem(window_layer_ffn2_ln_kernel<C>, smem);
      fn = (const void*)window_layer_ffn2_ln_kernel<C>;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            threads, smem);
}

template <int C, int WS>
int launch_f32(const void* x, const void* pos, const void* kp,
               const void* wqkv, const void* bqkv, const void* wo,
               const void* bo, const void* g1, const void* be1,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* g2, const void* be2, void* out, int nw, int ff,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<C, WS>();
  int err = set_smem(window_layer_f32<C, WS>, smem);
  if (err) return err;
  window_layer_f32<C, WS><<<nw * (WS / QT), THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(pos),
      static_cast<const uint8_t*>(kp), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(wo),
      static_cast<const float*>(bo), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2),
      static_cast<const float*>(be2), static_cast<float*>(out), ff);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); shapes as in the kernels'
// comments, at d_model c, which is 288 or 256, and windows of ws tokens,
// 64 or 256 (else cudaErrorInvalidValue). Every bf16 operand is 16-byte
// aligned and row-major.

#define WINDOW_LAYER_AT_WIDTH(c, call)                 \
  switch (c) {                                         \
    case 288: {                                        \
      constexpr int C_ = 288;                          \
      return call;                                     \
    }                                                  \
    case 256: {                                        \
      constexpr int C_ = 256;                          \
      return call;                                     \
    }                                                  \
    default:                                           \
      return (int)cudaErrorInvalidValue;               \
  }

// `call` at width c (C_) and window ws (WS_)
#define WINDOW_LAYER_AT(c, ws, call)                   \
  switch (ws) {                                        \
    case 64: {                                         \
      constexpr int WS_ = 64;                          \
      WINDOW_LAYER_AT_WIDTH(c, call)                   \
    }                                                  \
    case 256: {                                        \
      constexpr int WS_ = 256;                         \
      WINDOW_LAYER_AT_WIDTH(c, call)                   \
    }                                                  \
    default:                                           \
      return (int)cudaErrorInvalidValue;               \
  }

extern "C" int window_layer_qkv(const void* x, const void* pos,
                                const void* w, const void* b, void* out,
                                int rows, int c, void* stream) {
  if (rows <= 0) return rows < 0 ? (int)cudaErrorInvalidValue : 0;
  if (misaligned16({x, pos, w, b, out}))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_LAYER_AT_WIDTH(c, launch_qkv<C_>(x, pos, w, b, out, rows, st))
}

extern "C" int window_layer_attn(const void* qkv, const void* kp, void* out,
                                 int nw, int ws, int c, void* stream) {
  if (nw <= 0) return nw < 0 ? (int)cudaErrorInvalidValue : 0;
  if (misaligned16({qkv, out})) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_LAYER_AT(c, ws, (launch_attn<C_, WS_>(qkv, kp, out, nw, st)))
}

extern "C" int window_layer_proj_ln(const void* a, const void* wo,
                                    const void* bo, const void* x,
                                    const void* g1, const void* be1,
                                    void* x1, int rows, int c,
                                    void* stream) {
  if (rows <= 0) return rows < 0 ? (int)cudaErrorInvalidValue : 0;
  if (misaligned16({a, wo, bo, x, x1})) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_LAYER_AT_WIDTH(
      c, launch_proj_ln<C_>(a, wo, bo, x, g1, be1, x1, rows, st))
}

extern "C" int window_layer_ffn1(const void* x1, const void* w1,
                                 const void* b1, void* hid, int rows, int ff,
                                 int c, void* stream) {
  if (rows < 0 || ff <= 0 || ff % GFfn::BN) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (misaligned16({x1, w1, b1, hid})) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_LAYER_AT_WIDTH(c, launch_ffn1<C_>(x1, w1, b1, hid, rows, ff, st))
}

extern "C" int window_layer_ffn2_ln(const void* hid, const void* w2,
                                    const void* b2, const void* x1,
                                    const void* g2, const void* be2,
                                    void* out, int rows, int ff, int c,
                                    void* stream) {
  if (rows < 0 || ff <= 0 || ff % BK) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (misaligned16({hid, w2, b2, x1, out}))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_LAYER_AT_WIDTH(
      c, launch_ffn2_ln<C_>(hid, w2, b2, x1, g2, be2, out, rows, ff, st))
}

// blocks per SM that the card grants stage `stage` (0 qkv, 1 attn, 2
// proj_ln, 3 ffn1, 4 ffn2_ln) at d_model c and windows of ws tokens into
// *blocks, and its dynamic shared bytes into *smem_bytes
extern "C" int window_layer_occupancy(int stage, int c, int ws, int* blocks,
                                      int* smem_bytes) {
  WINDOW_LAYER_AT(c, ws, (occupancy<C_, WS_>(stage, blocks, smem_bytes)))
}

// The float32 layer, one block per (window, 64 query rows)
// (window_layer_f32): x, pos, out (nw, ws, c), kp (nw, ws) uint8, the
// weights as in the kernel's comment; the fixed sizes given for the entry
// point to check.
extern "C" int window_layer_f32_fwd(const void* x, const void* pos,
                                    const void* kp, const void* wqkv,
                                    const void* bqkv, const void* wo,
                                    const void* bo, const void* g1,
                                    const void* be1, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* g2,
                                    const void* be2, void* out, int nw,
                                    int ws, int c, int n_heads, int ff,
                                    void* stream) {
  if (n_heads != NH || ff < FC || ff % FC != 0 || nw < 0)
    return (int)cudaErrorInvalidValue;
  if (nw == 0) return (int)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WINDOW_LAYER_AT(
      c, ws,
      (launch_f32<C_, WS_>(x, pos, kp, wqkv, bqkv, wo, bo, g1, be1, w1, b1,
                           w2, b2, g2, be2, out, nw, ff, st)))
}
