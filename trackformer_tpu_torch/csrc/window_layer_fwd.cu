// One whole windowed-encoder layer, fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel trackformer_tpu/ops/window_attn.py::_kernel
// (called through _fused_window_layer). For every 8x8 window of the call
// (NW windows of WS = 64 tokens, C = 288 channels, 8 heads of 36):
//
//   q, k = (x + pos) Wq + bq, (x + pos) Wk + bk;   v = x Wv + bv
//   a    = softmax(q k^T / 6 with excluded keys at float32 min) v
//   x1   = LayerNorm(x + (a Wo + bo))
//   out  = LayerNorm(x1 + (relu(x1 W1 + b1) W2 + b2))
//
// with the JAX package's rounding: every product accumulates in f32, is
// rounded to the compute type T, and only then gets its bias added in T;
// logits and softmax are f32, the probabilities are rounded to T before
// they multiply v; LayerNorm takes f32 statistics as E[x^2] - E[x]^2 with
// eps 1e-6. Which keys are excluded (slots past a level's edge, and the
// un-masking of fully-padded windows) is decided by the caller.
//
// What bounds it on this card: arithmetic. At the flagship's B = 1 call
// (NW = 380) the four projections and the FFN are ~45 GFLOP of bf16 matrix
// products against ~44 MB of compulsory traffic, far above the H100's
// ~295 FLOP/byte ridge.
//
// Design. One block of 8 warps per window, the window's activations in
// shared memory. The TPU kernel's two tricks for its MXU (head-masked
// full-width products, several windows per tile with cross-window blocks
// masked) do not carry over: attention is computed per window and per head,
// with d_head 36 zero-padded to 48 so that it tiles by 16. The wrapper
// (ops/window_attn.py) packs the weights as (in, out) matrices, the q|k
// columns of each head side by side and then the v columns of all heads,
// each head zero-padded to 48.
//
//   * bf16 (the main path): products on the tensor cores through WMMA
//     16x16x16 fragments. The 1.84 MB of weights stream from global memory
//     through shared memory in slabs of 32 rows, double-buffered with
//     cp.async so that the next slab loads while the warps multiply the
//     current one, and each slab serves all 8 warps; every warp keeps the
//     f32 sums of its output tiles in registers across the slabs. v is
//     computed once for all heads; the FFN's hidden width is walked in
//     chunks of 128 with its output sums held in registers throughout.
//   * f32 (the float32 reference path): the same steps with scalar FMAs
//     and weights read through L1/L2; the attention output is staged in
//     the output buffer, so that the f32 activations fit the 227 KB of
//     shared memory a block may use.
//
// wgmma, TMA and several windows per block are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <float.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WS = 64;                   // tokens per window
constexpr int C = 288;                   // d_model
constexpr int NH = 8;                    // heads
constexpr int DH = 36;                   // d_head
constexpr int DHP = 48;                  // d_head padded to a multiple of 16
constexpr int QK_LD = NH * 2 * DHP;      // packed q|k columns of all heads
constexpr int V_LD = NH * DHP;           // packed v columns of all heads
constexpr int PACK_LD = QK_LD + V_LD;    // columns of the packed q|k|v
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CT = C / 16;               // 16-wide column tiles of C
constexpr float LN_EPS = 1e-6f;

typedef __nv_bfloat16 bf16;

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

// LayerNorm over C of each of the 64 rows of src (row stride lds) into dst
// (row stride ldd; shared or global), one warp per row
template <typename T>
__device__ __forceinline__ void layer_norm_rows(const T* src, int lds,
                                                const T* g, const T* b,
                                                T* dst, int ldd) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < WS; r += WARPS) {
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

// softmax of each row of the 64 x 64 f32 logits into probabilities of
// type T (row stride ldp; one warp per row, two columns per lane)
template <typename T>
__device__ __forceinline__ void softmax_rows(const float* sS, T* sPm,
                                             int ldp) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < WS; r += WARPS) {
    const float v0 = sS[r * WS + lane];
    const float v1 = sS[r * WS + lane + 32];
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = expf(v0 - m);
    const float e1 = expf(v1 - m);
    const float s = warp_sum(e0 + e1);
    if constexpr (sizeof(T) == 2) {
      sPm[r * ldp + lane] = to_bf(e0 / s);
      sPm[r * ldp + lane + 32] = to_bf(e1 / s);
    } else {
      sPm[r * ldp + lane] = e0 / s;
      sPm[r * ldp + lane + 32] = e1 / s;
    }
  }
}

// ===========================================================================
// bfloat16: tensor cores
// ===========================================================================

namespace wm = nvcuda::wmma;
typedef wm::fragment<wm::accumulator, 16, 16, 16, float> Acc;
typedef wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> FragA;

constexpr int KS = 32;                   // rows of B per staged slab
constexpr int FCB = 128;                 // FFN hidden chunk
// Shared-memory row strides: each row padded by 8 elements (16 bytes), so
// that the rows of a 16 x 16 fragment fall in distinct banks (an unpadded
// stride that is a multiple of 128 bytes puts them all in the same ones)
constexpr int PAD = 8;
constexpr int LDX = C + PAD;             // x, x + pos, attention output
constexpr int LDV = V_LD + PAD;          // v of all heads
constexpr int LDQ = DHP + PAD;           // q, k of one head
constexpr int LDP = WS + PAD;            // probabilities
constexpr int LDH = FCB + PAD;           // FFN hidden chunk

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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

// rows row0 .. row0 + KS - 1 of B (global, row-major ldb), N columns, into
// buf (KS x N, row stride N + PAD), 16 bytes per cp.async
template <int N>
__device__ __forceinline__ void load_slab(bf16* buf, const bf16* B, int ldb,
                                          int row0) {
  constexpr int CPR = N / 8;             // 16-byte chunks per row
  for (int i = threadIdx.x; i < KS * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c8 = (i % CPR) * 8;
    cp_async16(buf + r * (N + PAD) + c8, B + (size_t)(row0 + r) * ldb + c8);
  }
}

// acc += A (64 x k_len, shared, row-major lda) B (k_len x N, global,
// row-major ldb) for this warp's output tiles t = warp + 8 i (i < N / 32),
// tile t at rows 16 (t / (N / 16)), columns 16 (t % (N / 16)). B streams
// through sB (2 x KS x (N + PAD)) in slabs of KS rows, double-buffered.
// Ends with
// every thread past its last read of sB and of A.
template <int N>
__device__ __forceinline__ void mma_staged(Acc* acc, const bf16* A, int lda,
                                           const bf16* B, int ldb,
                                           int k_len, bf16* sB) {
  constexpr int NT = N / 32;
  constexpr int NJ = N / 16;
  const int warp = threadIdx.x / 32;
  constexpr int SLAB = KS * (N + PAD);
  const int n_slabs = k_len / KS;
  load_slab<N>(sB, B, ldb, 0);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    const bf16* cur = sB + (s & 1) * SLAB;
    // slab s has landed for every thread, and every warp is done with
    // slab s - 1, whose buffer the next load refills
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < n_slabs) {
      load_slab<N>(sB + ((s + 1) & 1) * SLAB, B, ldb, (s + 1) * KS);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int t = warp + WARPS * i;
        FragA a;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(a, A + (t / NJ) * 16 * lda + s * KS + kk, lda);
        wm::load_matrix_sync(b, cur + kk * (N + PAD) + (t % NJ) * 16,
                             N + PAD);
        wm::mma_sync(acc[i], a, b, acc[i]);
      }
    }
  }
  __syncthreads();
}

// epi(row, col, sum) for every element of this warp's tiles (as in
// mma_staged), through the warp's 16 x 16 f32 staging tile
template <int N, typename Epi>
__device__ __forceinline__ void store_acc(Acc* acc, float* stage, Epi epi) {
  constexpr int NJ = N / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const int t = warp + WARPS * i;
    wm::store_matrix_sync(st, acc[i], 16, wm::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      epi((t / NJ) * 16 + e / 16, (t % NJ) * 16 + e % 16, st[e]);
    __syncwarp();
  }
}

template <int N>
__device__ __forceinline__ void zero(Acc* acc) {
#pragma unroll
  for (int i = 0; i < N / 32; ++i) wm::fill_fragment(acc[i], 0.f);
}

// A (64 x k_len) B (k_len x 16 NJ) with both operands in shared memory (B
// column-major when B_COL), the output tiles spread over the warps; epi
// as in store_acc. For the small per-head products of attention.
template <int NJ, bool B_COL, typename Epi>
__device__ __forceinline__ void mma_shared(const bf16* A, int lda,
                                           const bf16* B, int ldb, int k_len,
                                           float* stage, Epi epi) {
  typedef typename std::conditional<B_COL, wm::col_major,
                                    wm::row_major>::type BLayout;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* st = stage + warp * 256;
  for (int t = warp; t < 4 * NJ; t += WARPS) {
    const int tm = t / NJ;
    const int tn = t % NJ;
    Acc acc;
    wm::fill_fragment(acc, 0.f);
    for (int k = 0; k < k_len; k += 16) {
      FragA a;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, BLayout> b;
      wm::load_matrix_sync(a, A + tm * 16 * lda + k, lda);
      if constexpr (B_COL) {
        wm::load_matrix_sync(b, B + tn * 16 * ldb + k, ldb);
      } else {
        wm::load_matrix_sync(b, B + k * ldb + tn * 16, ldb);
      }
      wm::mma_sync(acc, a, b, acc);
    }
    wm::store_matrix_sync(st, acc, 16, wm::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      epi(tm * 16 + e / 16, tn * 16 + e % 16, st[e]);
    __syncwarp();
  }
}

constexpr size_t bf16_smem_bytes() {
  return (2 * WS * LDX + WS * LDV + 4 * WS * LDQ + WS * LDP + 2 * KS * LDX) *
             sizeof(bf16)                        // sX sP sV sQ sK sPm sB
         + WS * LDH * sizeof(bf16)               // sS (f32) / FFN chunk
         + WARPS * 256 * sizeof(float);          // WMMA staging
}

// x, pos, out: (NW, WS, C); kp: (NW, WS) uint8, 1 = exclude the key;
// wqkv (C, PACK_LD), bqkv (PACK_LD); wo (C, C); w1 (C, ff); w2 (ff, C):
// row-major (in, out). One block per window. x and pos 16-byte aligned.
__global__ void __launch_bounds__(THREADS, 1)
    window_layer_bf16(const bf16* __restrict__ x, const bf16* __restrict__ pos,
                      const uint8_t* __restrict__ kp,
                      const bf16* __restrict__ wqkv,
                      const bf16* __restrict__ bqkv,
                      const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                      const bf16* __restrict__ g1, const bf16* __restrict__ be1,
                      const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                      const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                      const bf16* __restrict__ g2, const bf16* __restrict__ be2,
                      bf16* out, int ff) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ bool excluded[WS];
  bf16* sX = reinterpret_cast<bf16*>(smem);  // x; later x1 + ffn
  bf16* sP = sX + WS * LDX;               // x + pos; later x + attn, x1
  bf16* sV = sP + WS * LDX;               // v of all heads; later attn
  bf16* sQ = sV + WS * LDV;               // q, k of two heads (64 x DHP)
  bf16* sK = sQ + 2 * WS * LDQ;
  bf16* sPm = sK + 2 * WS * LDQ;          // probabilities (64 x 64)
  bf16* sB = sPm + WS * LDP;              // weight slabs (2 x KS x <= LDX)
  bf16* sH = sB + 2 * KS * LDX;           // FFN hidden chunk (64 x FCB)
  float* sS = reinterpret_cast<float*>(sH);  // logits (64 x 64), before
  float* stage = reinterpret_cast<float*>(sH + WS * LDH);

  const size_t base = (size_t)blockIdx.x * WS * C;
  // the attention output is staged in this window's rows of `out`
  bf16* o_win = out + base;
  {
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
    const uint4* pv = reinterpret_cast<const uint4*>(pos + base);
    for (int i = threadIdx.x; i < WS * C / 8; i += THREADS) {
      const uint4 xa = xv[i];
      const uint4 pa = pv[i];
      const int at = (i / (C / 8)) * LDX + (i % (C / 8)) * 8;
      *reinterpret_cast<uint4*>(sX + at) = xa;
      const bf16* xe = reinterpret_cast<const bf16*>(&xa);
      const bf16* pe = reinterpret_cast<const bf16*>(&pa);
      uint4 qa;
      bf16* qe = reinterpret_cast<bf16*>(&qa);
#pragma unroll
      for (int j = 0; j < 8; ++j) qe[j] = to_bf(to_f(xe[j]) + to_f(pe[j]));
      *reinterpret_cast<uint4*>(sP + at) = qa;
    }
  }
  if (threadIdx.x < WS)
    excluded[threadIdx.x] = kp[(size_t)blockIdx.x * WS + threadIdx.x] != 0;

  // v of all heads, in two halves of 4 heads
  for (int half = 0; half < 2; ++half) {
    constexpr int N = V_LD / 2;
    Acc acc[N / 32];
    zero<N>(acc);
    mma_staged<N>(acc, sX, LDX, wqkv + QK_LD + half * N, PACK_LD, C, sB);
    store_acc<N>(acc, stage, [&](int r, int c, float a) {
      const int col = half * N + c;
      sV[r * LDV + col] = to_bf(rnd_bf(a) + to_f(bqkv[QK_LD + col]));
    });
  }

  const float inv_scale = 1.f / sqrtf((float)DH);
  for (int h0 = 0; h0 < NH; h0 += 2) {
    {  // q|k of heads h0 and h0 + 1: one product, 4 x 48 columns
      constexpr int N = 4 * DHP;
      Acc acc[N / 32];
      zero<N>(acc);
      mma_staged<N>(acc, sP, LDX, wqkv + h0 * 2 * DHP, PACK_LD, C, sB);
      store_acc<N>(acc, stage, [&](int r, int c, float a) {
        const bf16 v = to_bf(rnd_bf(a) + to_f(bqkv[h0 * 2 * DHP + c]));
        const int hh = c / (2 * DHP);
        const int cc = c % (2 * DHP);
        if (cc < DHP) {
          sQ[(hh * WS + r) * LDQ + cc] = v;
        } else {
          sK[(hh * WS + r) * LDQ + cc - DHP] = v;
        }
      });
    }
    __syncthreads();
    for (int hh = 0; hh < 2; ++hh) {
      const int h = h0 + hh;
      mma_shared<WS / 16, true>(sQ + hh * WS * LDQ, LDQ, sK + hh * WS * LDQ,
                                LDQ, DHP, stage, [&](int r, int c, float a) {
                                  sS[r * WS + c] =
                                      excluded[c] ? -FLT_MAX : a * inv_scale;
                                });
      __syncthreads();
      softmax_rows(sS, sPm, LDP);
      __syncthreads();
      mma_shared<DHP / 16, false>(sPm, LDP, sV + h * DHP, LDV, WS, stage,
                                  [&](int r, int c, float a) {
                                    if (c < DH)
                                      o_win[r * C + h * DH + c] = to_bf(a);
                                  });
      __syncthreads();
    }
  }

  // the attention output into shared memory, over v
  bf16* sO = sV;
  for (int i = threadIdx.x; i < WS * C / 8; i += THREADS)
    *reinterpret_cast<uint4*>(sO + (i / (C / 8)) * LDX + (i % (C / 8)) * 8) =
        reinterpret_cast<const uint4*>(o_win)[i];
  __syncthreads();

  // out projection, residual, LayerNorm 1 -> x1 in sP
  {
    Acc acc[C / 32];
    zero<C>(acc);
    mma_staged<C>(acc, sO, LDX, wo, C, C, sB);
    store_acc<C>(acc, stage, [&](int r, int c, float a) {
      const float v = rnd_bf(rnd_bf(a) + to_f(bo[c]));
      sP[r * LDX + c] = to_bf(to_f(sX[r * LDX + c]) + v);
    });
  }
  __syncthreads();
  layer_norm_rows(sP, LDX, g1, be1, sP, LDX);
  __syncthreads();

  // FFN over hidden chunks; residual -> sX; LayerNorm 2 -> out
  Acc acc2[C / 32];
  zero<C>(acc2);
  for (int chunk = 0; chunk < ff; chunk += FCB) {
    {
      Acc acc1[FCB / 32];
      zero<FCB>(acc1);
      mma_staged<FCB>(acc1, sP, LDX, w1 + chunk, ff, C, sB);
      store_acc<FCB>(acc1, stage, [&](int r, int c, float a) {
        const float hv = rnd_bf(rnd_bf(a) + to_f(b1[chunk + c]));
        sH[r * LDH + c] = to_bf(fmaxf(hv, 0.f));
      });
    }
    __syncthreads();
    mma_staged<C>(acc2, sH, LDH, w2 + (size_t)chunk * C, C, FCB, sB);
  }
  store_acc<C>(acc2, stage, [&](int r, int c, float a) {
    const float v = rnd_bf(rnd_bf(a) + to_f(b2[c]));
    sX[r * LDX + c] = to_bf(to_f(sP[r * LDX + c]) + v);
  });
  __syncthreads();
  layer_norm_rows(sX, LDX, g2, be2, o_win, C);
}

// ===========================================================================
// float32: scalar FMAs
// ===========================================================================

constexpr int FC = 64;                   // FFN hidden chunk

// 64 x (16 NJ) output of A (64 x k_len, row-major lda) B (k_len x 16 NJ,
// row-major ldb, or column-major when B_COL): thread (rg, cg) computes
// rows 4 rg .. 4 rg + 3 of the columns cg, cg + 16, ...; epi(row, col, sum)
// once per element
template <int NJ, bool B_COL, typename Epi>
__device__ __forceinline__ void gemm_scalar(const float* A, int lda,
                                            const float* B, int ldb,
                                            int k_len, Epi epi) {
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
    for (int i = 0; i < 4; ++i) a[i] = A[(rg * 4 + i) * lda + k];
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

constexpr size_t f32_smem_bytes() {
  return (2 * WS * C + 3 * WS * DHP + 2 * WS * WS) * sizeof(float);
}

// as window_layer_bf16, in float32 (no rounding between the steps)
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
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ bool excluded[WS];
  float* sX = reinterpret_cast<float*>(smem);  // x; later x1 + ffn
  float* sP = sX + WS * C;                // x + pos; later x + attn, x1
  float* sQ = sP + WS * C;                // one head's q, k, v (64 x DHP)
  float* sK = sQ + WS * DHP;
  float* sV = sK + WS * DHP;
  float* sPm = sV + WS * DHP;             // probabilities (64 x 64)
  float* sS = sPm + WS * WS;              // logits (64 x 64)
  float* sH = sS;                         // FFN hidden chunk (64 x FC)

  const size_t base = (size_t)blockIdx.x * WS * C;
  // the attention output (64 x C) is staged in this window's rows of `out`
  float* o_win = out + base;
  for (int i = threadIdx.x; i < WS * C; i += THREADS) {
    sX[i] = x[base + i];
    sP[i] = x[base + i] + pos[base + i];
  }
  if (threadIdx.x < WS)
    excluded[threadIdx.x] = kp[(size_t)blockIdx.x * WS + threadIdx.x] != 0;
  __syncthreads();

  const float inv_scale = 1.f / sqrtf((float)DH);
  for (int h = 0; h < NH; ++h) {
    gemm_scalar<2 * DHP / 16, false>(
        sP, C, wqkv + h * 2 * DHP, PACK_LD, C, [&](int r, int c, float a) {
          const float v = a + bqkv[h * 2 * DHP + c];
          if (c < DHP) {
            sQ[r * DHP + c] = v;
          } else {
            sK[r * DHP + c - DHP] = v;
          }
        });
    gemm_scalar<DHP / 16, false>(
        sX, C, wqkv + QK_LD + h * DHP, PACK_LD, C,
        [&](int r, int c, float a) {
          sV[r * DHP + c] = a + bqkv[QK_LD + h * DHP + c];
        });
    __syncthreads();
    gemm_scalar<WS / 16, true>(sQ, DHP, sK, DHP, DHP,
                               [&](int r, int c, float a) {
                                 sS[r * WS + c] =
                                     excluded[c] ? -FLT_MAX : a * inv_scale;
                               });
    __syncthreads();
    softmax_rows(sS, sPm, WS);
    __syncthreads();
    gemm_scalar<DHP / 16, false>(sPm, WS, sV, DHP, WS,
                                 [&](int r, int c, float a) {
                                   if (c < DH) o_win[r * C + h * DH + c] = a;
                                 });
    __syncthreads();
  }

  gemm_scalar<CT, false>(o_win, C, wo, C, C, [&](int r, int c, float a) {
    sP[r * C + c] = sX[r * C + c] + (a + bo[c]);
  });
  __syncthreads();
  layer_norm_rows(sP, C, g1, be1, sP, C);
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
    gemm_scalar<FC / 16, false>(sP, C, w1 + chunk, ff, C,
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
  layer_norm_rows(sX, C, g2, be2, o_win, C);
}

template <typename T, typename K>
int launch(K kernel, size_t smem, const void* x, const void* pos,
           const void* kp, const void* wqkv, const void* bqkv, const void* wo,
           const void* bo, const void* g1, const void* be1, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* g2,
           const void* be2, void* out, int nw, int ff, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nw, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(pos),
      static_cast<const uint8_t*>(kp), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wo),
      static_cast<const T*>(bo), static_cast<const T*>(g1),
      static_cast<const T*>(be1), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<const T*>(g2),
      static_cast<const T*>(be2), static_cast<T*>(out), ff);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes: shapes as in window_layer_bf16,
// with the fixed sizes given for the kernel to check. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int window_layer_fwd(const void* x, const void* pos, const void* kp,
                                const void* wqkv, const void* bqkv,
                                const void* wo, const void* bo, const void* g1,
                                const void* be1, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* g2, const void* be2, void* out,
                                int nw, int ws, int c, int n_heads, int ff,
                                int is_bf16, void* stream) {
  if (ws != WS || c != C || n_heads != NH || ff < FCB || ff % FCB != 0 ||
      nw < 0)
    return (int)cudaErrorInvalidValue;
  if (nw == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(pos) |
         reinterpret_cast<uintptr_t>(out)) % 16)
      return (int)cudaErrorMisalignedAddress;
    return launch<bf16>(window_layer_bf16, bf16_smem_bytes(), x, pos, kp,
                        wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                        out, nw, ff, st);
  }
  return launch<float>(window_layer_f32, f32_smem_bytes(), x, pos, kp, wqkv,
                       bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, out,
                       nw, ff, st);
}
