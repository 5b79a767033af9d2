// Fused small-MLP forward for Hopper (sm_90a), f32 throughout.
//
// Replaces the TPU kernel reagent_tpu/ops/fused_mlp.py::fused_mlp_forward
// (its pallas_call at :75): y = act_L(... act_1(x . W_1 + b_1) ... . W_L + b_L)
// for policy scoring (the act step of the online loops and evaluate_policy),
// the trainers' q_values and the evaluation, OPE, imitation and surrogate
// forwards.  Two routes; fused_mlp_resident says which a call takes.
//
// Resident: one launch (every net whose layers, biases and two activation
// buffers fit in the 227 KB a block may opt into; the act step's needs
// ~38 KB).  At the act step (one row, 4 -> 128 -> 64 -> 2) the work is ~36 KB
// of weights and ~18 KFLOP, nanoseconds on this card: the kernel's time is
// its launch and the round trips of its loads.  So one block a tile of at
// most MAX_TILE_ROWS rows issues every load of the launch at its start,
// before any arithmetic, as cp.async copies: the tile's rows of x, then per
// layer its weights and its bias, one commit group per layer.  Copies are 16
// bytes where the pointer, the stride and the width allow it (the row's last
// copy cut to its bytes, the rest of the 16 zero-filled), else 4.  Each copy
// loop, and each layer's loop over its outputs, walks rows and columns by
// compare-and-subtract from a start the host planned (Walk): no thread
// divides.  Layer l waits only for its own group (cp.async.wait_group), so
// later layers' weights land while earlier ones compute, and nothing inside
// the layer loop reads device memory.  Each weight keeps its source layout
// in shared memory: [n][k] for the W^T view of [out, in] (sk == 1:
// nn.Linear's and the trainer's layout, the main path) and [k][n] for JAX's
// [in, out].  Row pitches are an odd number of 16-byte units, so the 16-byte
// copies stay aligned and a quarter warp's 16-byte reads of eight [n][k]
// rows (or eight activation rows) fall in eight distinct bank groups; [k][n]
// rows are read one float per thread along n, free of conflicts at any
// pitch.  A sum reads its terms KB at a time, the next KB in flight while the
// current ones are summed.  While the grid would leave SMs idle, a block
// takes fewer rows than the caller's tile: enough for one output of the
// widest layer a thread.
//
// Streamed: L launches, one a layer (nets past 227 KB: the q_values,
// evaluation, NNTrainer, imitator-gate and Bayes-by-backprop nets, 0.5-1 MB
// of weights, 32 to 4,096+ rows).  What bounds them is f32 fmas at large
// batches (the gate at [4096, 128 -> 512 -> 256 -> 8] is 1.63 GFLOP, 24 us at
// 67 TFLOP/s, against 0.8 MB of weights) and the latency of the loads and
// launches at small ones.  Each launch is a register-blocked tile product
// (mlp_layer_kernel) with the bias and the activation in its epilogue: each
// weight tile comes into shared memory once a block and serves BM rows, not
// one tile of 16 rows as a block that stages the whole net would, and each
// thread holds an RM x RN block of outputs, so one 16-byte shared read of h
// and one of W feed 4 RN and 4 RM fmas (12 reads for 128 fmas at 8 x 4;
// one-float reads of both operands for each fma cap a loop near an eighth
// of the fma rate).  Tiles are copied by cp.async, 16 bytes along whichever
// of k and n is contiguous (4 bytes for a pointer or stride that is not
// 16-byte aligned: input widths of 6, 10 and 137 occur), into a ring of
// stages with the next tiles in flight.  The host picks each layer's tile
// from its shape (launch_layer): the largest whose grid covers every SM, so
// that small batches spread over the SMs in tiles of 16 x 8 to 32 x 32
// instead of one block doing the whole net.  A layer of at most 16 outputs
// (the nets' last: 8, 4 or 1) takes tiles of 16 rows by N rounded up to 4,
// 8 or 16, one output a thread: each output is a chain of K dependent fmas
// that no tiling shortens (no split-K), so small tiles that spread the rows
// over the SMs serve it best.  Hidden activations go through the caller's
// workspace (fused_mlp_workspace_floats; 16 MB at [4096, 512]: they stay in
// the 50 MB L2).
//
// Both routes sum each output the same way: acc = 0, acc = fmaf(h[k], W(k, n),
// acc) for k in order, then act(acc + b[n]) in registers.  No split-K, no
// tensor cores (TF32 rounds the operands), no atomics: results do not depend
// on the route, the tile or the layout, and repeat bit for bit.  Rows past
// the batch are masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, bound with ctypes; returns cudaGetLastError() (0 on
// success).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int MAX_LAYERS = 16;
constexpr int MAX_TILE_ROWS = 16;
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block may opt into

enum Act { ACT_LINEAR = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };

__device__ __forceinline__ float act_fwd(float z, int act) {
  switch (act) {
    case ACT_RELU: return z > 0.f ? z : 0.f;
    case ACT_LEAKY: return z > 0.f ? z : 0.01f * z;
    case ACT_TANH: return tanhf(z);
    default: return z;
  }
}

// Thread t's share of `units` items a row, THREADS threads at a time: it
// starts at row (t * magic) >> 16 (t / units, exact for t < 256) and item
// t - row * units, then steps step_i rows and step_u items, carrying a row
// when the item passes units.  Planned by the host: no thread divides.
struct Walk {
  int units, magic, step_i, step_u;
};

struct Layer {
  const float* W;  // W(k, n) = W[k * sk + n * sn]
  long long sk, sn;
  const float* b;  // [out], contiguous
  int in, out, act;
  // the resident route, planned by the host: W's shared-memory copy at
  // smem + w_off with row pitch ldw ([n][k] if sk == 1, else [k][n]), the
  // bias at smem + b_off; w_vec / b_vec: 16-byte copies; the walks of the
  // two copies and of the layer's outputs (rows x out)
  int w_off, ldw, b_off, w_vec, b_vec;
  Walk w_walk, b_walk, o_walk;
};

struct Net {
  Layer layer[MAX_LAYERS];
  int L;
};

// ------------------------------------------------------------ resident route

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
// 16 bytes from global to shared memory, the last 16 - bytes of them zero.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Wait until at most `pending` (0..N) of this thread's newest groups are in
// flight: wait_group takes an immediate.
template <int N>
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  if constexpr (N == 0) {
    cp_async_wait<0>();
  } else {
    if (pending >= N) cp_async_wait<N>();
    else cp_async_wait_upto<N - 1>(pending);
  }
}

static_assert(THREADS <= 256, "Walk's start is exact for thread indices below 256");
constexpr int KB = 16;  // k per block of shared-memory reads in a layer's sums

// Row pitch in floats of `cols` columns: an odd number of 16-byte units.
inline int pitch_of(int cols) {
  const int units = (cols + 3) >> 2;
  return 4 * (units | 1);
}

// Issue the copies of a rows x cols matrix, element (i, j) at
// src[i * s_row + j * s_col], to dst[i * ld + j], along the walk `wk` of its
// copy units.  VEC: 16 bytes along j (s_col == 1, s_row a multiple of 4, src
// and dst 16-byte aligned: the host checks), the row's last copy cut to its
// bytes; else 4 bytes.
template <bool VEC>
__device__ __forceinline__ void copy_async(float* dst, int ld, const float* src,
                                           long long s_row, long long s_col, int rows,
                                           int cols, const Walk& wk) {
  int i = (threadIdx.x * wk.magic) >> 16;
  int u = threadIdx.x - i * wk.units;
  while (i < rows) {
    if (VEC) {
      const int j = u << 2;
      cp_async16(dst + i * ld + j, src + i * s_row + j, 4 * min(4, cols - j));
    } else {
      cp_async4(dst + i * ld + u, src + i * s_row + u * s_col);
    }
    i += wk.step_i;
    u += wk.step_u;
    if (u >= wk.units) { u -= wk.units; ++i; }
  }
}

__device__ __forceinline__ void copy_matrix_async(bool vec, float* dst, int ld,
                                                  const float* src, long long s_row,
                                                  long long s_col, int rows, int cols,
                                                  const Walk& wk) {
  if (vec) copy_async<true>(dst, ld, src, s_row, s_col, rows, cols, wk);
  else copy_async<false>(dst, ld, src, s_row, s_col, rows, cols, wk);
}

// KB terms of a row's sum from shared memory: h[k..k+KB) by 16-byte reads,
// W(k.., n) along k by 16-byte reads (NK, w the row of n) or one float a k
// (w the column of n, pitch ldw).
template <bool NK>
__device__ __forceinline__ void load_block(const float* hr, const float* w, int ldw, int k,
                                           float (&hs)[KB], float (&ws)[KB]) {
#pragma unroll
  for (int q = 0; q < KB / 4; ++q) {
    const float4 hv = *reinterpret_cast<const float4*>(hr + k + 4 * q);
    hs[4 * q] = hv.x; hs[4 * q + 1] = hv.y; hs[4 * q + 2] = hv.z; hs[4 * q + 3] = hv.w;
    if (NK) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k + 4 * q);
      ws[4 * q] = wv.x; ws[4 * q + 1] = wv.y; ws[4 * q + 2] = wv.z; ws[4 * q + 3] = wv.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) ws[4 * q + e] = w[(k + 4 * q + e) * ldw];
    }
  }
}

// One layer from shared memory: out[r][n] = act(sum_k h[r][k] W(k, n) + b[n])
// for the tile's rows, each output a chain of fmaf over k in order.  NK: W
// kept [n][k] (16-byte reads along k), else [k][n] (one float along n).
template <bool NK>
__device__ __forceinline__ void layer_resident(const float* w, int ldw, const float* bias,
                                               const float* h, int ldh, int in, int out,
                                               int act, int rows, float* o, float* y,
                                               const Walk& wk) {
  int r = (threadIdx.x * wk.magic) >> 16;
  int n = threadIdx.x - r * out;
  const int k_blocks = in & ~(KB - 1);
  while (r < rows) {
    const float* hr = h + r * ldh;
    const float* wn = NK ? w + n * ldw : w + n;
    float acc = 0.f;
    int k = 0;
    if (k_blocks) {
      // the next block's reads are in flight while this block's FMAs run
      float hs[KB], ws[KB];
      load_block<NK>(hr, wn, ldw, 0, hs, ws);
      for (; k < k_blocks; k += KB) {
        float hn[KB], wv[KB];
        const bool more = k + KB < k_blocks;
        if (more) load_block<NK>(hr, wn, ldw, k + KB, hn, wv);
#pragma unroll
        for (int e = 0; e < KB; ++e) acc = fmaf(hs[e], ws[e], acc);
        if (more) {
#pragma unroll
          for (int e = 0; e < KB; ++e) { hs[e] = hn[e]; ws[e] = wv[e]; }
        }
      }
    }
    if (NK) {
      const float* wr = wn;
      for (; k + 4 <= in; k += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hr + k);
        const float4 wv = *reinterpret_cast<const float4*>(wr + k);
        acc = fmaf(hv.x, wv.x, acc);
        acc = fmaf(hv.y, wv.y, acc);
        acc = fmaf(hv.z, wv.z, acc);
        acc = fmaf(hv.w, wv.w, acc);
      }
      for (; k < in; ++k) acc = fmaf(hr[k], wr[k], acc);
    } else {
      const float* wc = wn;
      for (; k + 4 <= in; k += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hr + k);
        acc = fmaf(hv.x, wc[k * ldw], acc);
        acc = fmaf(hv.y, wc[(k + 1) * ldw], acc);
        acc = fmaf(hv.z, wc[(k + 2) * ldw], acc);
        acc = fmaf(hv.w, wc[(k + 3) * ldw], acc);
      }
      for (; k < in; ++k) acc = fmaf(hr[k], wc[k * ldw], acc);
    }
    const float v = act_fwd(acc + bias[n], act);
    if (y) y[(long long)r * out + n] = v;
    else o[r * ldh + n] = v;
    r += wk.step_i;
    n += wk.step_u;
    if (n >= out) { n -= out; ++r; }
  }
}

__global__ void __launch_bounds__(THREADS)
fused_mlp_resident_kernel(const float* __restrict__ x, float* __restrict__ y, int B,
                          int tile_rows, int ldh, int h_off, int x_vec, Walk x_walk,
                          Net net) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, B - row0);
  float* h = smem + h_off;               // [tile_rows, ldh]
  float* o = h + tile_rows * ldh;        // [tile_rows, ldh]

  // Every load of the launch, before any arithmetic: one group per layer,
  // the tile's x rows in the first.
  const int d0 = net.layer[0].in;
  copy_matrix_async(x_vec, h, ldh, x + (long long)row0 * d0, d0, 1, rows, d0, x_walk);
  for (int l = 0; l < net.L; ++l) {
    const Layer& ly = net.layer[l];
    const bool nk = ly.sk == 1;
    copy_matrix_async(ly.w_vec, smem + ly.w_off, ly.ldw, ly.W, nk ? ly.sn : ly.sk,
               nk ? ly.sk : ly.sn, nk ? ly.out : ly.in, nk ? ly.in : ly.out, ly.w_walk);
    copy_matrix_async(ly.b_vec, smem + ly.b_off, 0, ly.b, 0, 1, 1, ly.out, ly.b_walk);
    cp_async_commit();
  }

  for (int l = 0; l < net.L; ++l) {
    const Layer& ly = net.layer[l];
    cp_async_wait_upto<MAX_LAYERS - 1>(net.L - 1 - l);
    __syncthreads();  // layer l's group from every thread, and h, are in
    float* yl = l == net.L - 1 ? y + (long long)row0 * ly.out : nullptr;
    if (ly.sk == 1)
      layer_resident<true>(smem + ly.w_off, ly.ldw, smem + ly.b_off, h, ldh, ly.in, ly.out,
                           ly.act, rows, o, yl, ly.o_walk);
    else
      layer_resident<false>(smem + ly.w_off, ly.ldw, smem + ly.b_off, h, ldh, ly.in, ly.out,
                            ly.act, rows, o, yl, ly.o_walk);
    float* t = h; h = o; o = t;
  }
}

// ------------------------------------------------------------ streamed route

// One layer of the streamed route: out = act(h . W + b), h [M, K] at row
// pitch ldh (k contiguous), W(k, n) = W[k * sk + n * sn], out [M, N] at row
// pitch ldo.  h_vec / w_vec: 16-byte copies (the host checks alignment).
struct LayerGemm {
  const float* h;
  const float* W;
  const float* b;
  float* out;
  long long ldh, sk, sn, ldo;
  int M, K, N, act, h_vec, w_vec;
};

// 4 bytes from global to shared memory, or 4 zeros where bytes is 0.
__device__ __forceinline__ void cp_async4z(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

// Start the copy of a ROWS x COLS tile, element (r, c) at src[r * s_row +
// c * s_col], to dst[r * PITCH + c]; rows past rows_ok and columns past
// cols_ok are zero-filled.  vec: 16 bytes along c (s_col == 1), the last
// unit of a row cut to its bytes; else 4 bytes.
template <int ROWS, int COLS, int PITCH, int NT>
__device__ __forceinline__ void tile_async(float* dst, const float* src, long long s_row,
                                           long long s_col, int rows_ok, int cols_ok,
                                           bool vec) {
  if (vec) {
    constexpr int UNITS = ROWS * COLS / 4;
#pragma unroll
    for (int q = 0; q < (UNITS + NT - 1) / NT; ++q) {
      const int u = threadIdx.x + q * NT;
      if (UNITS % NT == 0 || u < UNITS) {
        const int r = u / (COLS / 4), c = (u % (COLS / 4)) * 4;
        const int n = r < rows_ok ? max(0, min(4, cols_ok - c)) : 0;
        cp_async16(dst + r * PITCH + c, n ? src + r * s_row + c : src, 4 * n);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < (ROWS * COLS + NT - 1) / NT; ++q) {
      const int e = threadIdx.x + q * NT;
      if ((ROWS * COLS) % NT == 0 || e < ROWS * COLS) {
        const int r = e / COLS, c = e % COLS;
        const bool ok = r < rows_ok && c < cols_ok;
        cp_async4z(dst + r * PITCH + c, ok ? src + r * s_row + c * s_col : src, ok ? 4 : 0);
      }
    }
  }
}

// One layer as a register-blocked tile product: a BM x BN tile of out a
// block, each thread an RM x RN block of outputs in registers, FK deep,
// STAGES shared-memory stages in a cp.async ring (STAGES - 1 tiles in
// flight while one is summed).  h's tile sits [m][k] in shared memory, W's
// [n][k] (NK: the W^T view of [out, in], sk == 1, and any other strides) or
// [k][n] (JAX's [in, out], sn == 1); every pitch is an odd number of
// 16-byte units.  A thread reads, for each 4 k, one 16-byte h[m][k..k+3]
// per row and one 16-byte W per column ([n][k]) or per 4 k and 4 columns
// ([k][n]): 12 reads for 128 fmas at 8 x 4.  Thread (ty, tx) holds rows
// ty + i * TY and columns tx + j * TX (or 4 tx + j on [k][n] at RN % 4 == 0),
// so a quarter warp's reads fall in distinct bank groups or broadcast.
// Each output is acc = 0, fmaf(h[k], W(k, n), acc) for k ascending (the
// last stage's valid k only, no zero-filled terms), then act(acc + b[n]):
// the resident route's and the earlier staging kernel's sum, bit for bit.
template <int BM, int BN, int RM, int RN, int FK, int STAGES, bool NK>
__global__ void __launch_bounds__((BM / RM) * (BN / RN))
mlp_layer_kernel(const LayerGemm g) {
  constexpr int NT = (BM / RM) * (BN / RN);
  constexpr int TX = BN / RN, TY = BM / RM;
  constexpr bool B4 = !NK && RN % 4 == 0;  // [k][n]: 16-byte reads of 4 columns
  constexpr int PA = FK + 4;               // h rows [m][k]
  constexpr int PB = NK ? FK + 4 : BN + 4; // W rows [n][k] or [k][n]
  constexpr int SA = BM * PA, SB = NK ? BN * PB : FK * PB;
  // [m][k] and [n][k] rows at an odd number of 16-byte units; a warp reads
  // one [k][n] row at a time
  static_assert(STAGES >= 2 && FK % 4 == 0 && BN % 4 == 0 && (PA / 4) % 2 == 1 &&
                (NK ? (PB / 4) % 2 == 1 : PB % 4 == 0), "16-byte rows");
  __shared__ __align__(16) float As[STAGES][SA];
  __shared__ __align__(16) float Bs[STAGES][SB];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = g.M, N = g.N, K = g.K;
  const float* __restrict__ h = g.h + (long long)m0 * g.ldh;
  const float* __restrict__ W = g.W + (long long)n0 * g.sn;

  auto load = [&](int t, int s) {
    const int k0 = t * FK;
    tile_async<BM, FK, PA, NT>(As[s], h + k0, g.ldh, 1, M - m0, K - k0, g.h_vec);
    if constexpr (NK)
      tile_async<BN, FK, PB, NT>(Bs[s], W + (long long)k0 * g.sk, g.sn, g.sk, N - n0, K - k0,
                                 g.w_vec);
    else
      tile_async<FK, BN, PB, NT>(Bs[s], W + (long long)k0 * g.sk, g.sk, g.sn, K - k0, N - n0,
                                 g.w_vec);
  };
  auto col = [&](int j) { return B4 ? tx * RN + j : tx + j * TX; };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int nk = (K + FK - 1) / FK;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nk) load(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t is in from every thread; stage (t - 1) % STAGES is free
    if (t + STAGES - 1 < nk) load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* as = As[t % STAGES];
    const float* bs = Bs[t % STAGES];
    const int kv = min(FK, K - t * FK);
    if (kv == FK) {
#pragma unroll
      for (int k = 0; k < FK; k += 4) {
        float4 a[RM];
        float b[4][RN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          a[i] = *reinterpret_cast<const float4*>(as + (ty + i * TY) * PA + k);
        if constexpr (NK) {
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(bs + col(j) * PB + k);
            b[0][j] = v.x; b[1][j] = v.y; b[2][j] = v.z; b[3][j] = v.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (B4) {
#pragma unroll
              for (int p = 0; p < RN / 4; ++p) {
                const float4 v =
                    *reinterpret_cast<const float4*>(bs + (k + e) * PB + tx * RN + 4 * p);
                b[e][4 * p] = v.x; b[e][4 * p + 1] = v.y;
                b[e][4 * p + 2] = v.z; b[e][4 * p + 3] = v.w;
              }
            } else {
#pragma unroll
              for (int j = 0; j < RN; ++j) b[e][j] = bs[(k + e) * PB + col(j)];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            acc[i][j] = fmaf(a[i].x, b[0][j], acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[1][j], acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[2][j], acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[3][j], acc[i][j]);
          }
        }
      }
    } else {  // the last, partial tile: its valid k only
      for (int k = 0; k < kv; ++k) {
        float a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = as[(ty + i * TY) * PA + k];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = NK ? bs[col(j) * PB + k] : bs[k * PB + col(j)];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the trailing groups are empty)

#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int n = n0 + col(j);
    if (n >= N) continue;
    const float bn = g.b[n];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = m0 + ty + i * TY;
      if (m < M) g.out[(long long)m * g.ldo + n] = act_fwd(acc[i][j] + bn, g.act);
    }
  }
}

// A wide layer's tile, BM x BN: largest first; a layer takes the first
// whose grid covers every SM, or the last.  128 x 64 (8 x 4 a thread, 16
// deep, three stages), 64 x 64 (4 x 4), 32 x 32 (2 x 2, 32 deep, four), 16 x
// 16 and 16 x 8 (1 x 1, 32 deep, three: more stages in flight did not
// shorten a small batch's layers on the card).
struct TileShape {
  int bm, bn;
};
constexpr TileShape WIDE_TILES[] = {{128, 64}, {64, 64}, {32, 32}, {16, 16}, {16, 8}};
// Narrow layers (N <= 16: the nets' last layers, 8, 4 or 1 outputs): 16
// rows by N rounded up to 4, 8 or 16 columns, one output a thread: many
// small blocks a layer, few lanes on columns past N.
constexpr int NARROW_N = 16;

template <int BM, int BN, int RM, int RN, int FK, int STAGES>
cudaError_t launch_layer(const LayerGemm& g, bool nk, cudaStream_t s) {
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.N + BN - 1) / BN));
  const int threads = (BM / RM) * (BN / RN);
  if (nk) mlp_layer_kernel<BM, BN, RM, RN, FK, STAGES, true><<<grid, threads, 0, s>>>(g);
  else mlp_layer_kernel<BM, BN, RM, RN, FK, STAGES, false><<<grid, threads, 0, s>>>(g);
  return cudaGetLastError();
}

int sm_count();

cudaError_t launch_layer(const LayerGemm& g, bool nk, cudaStream_t s) {
  if (g.N <= 4) return launch_layer<16, 4, 1, 1, 32, 3>(g, nk, s);
  if (g.N <= 8) return launch_layer<16, 8, 1, 1, 32, 3>(g, nk, s);
  if (g.N <= NARROW_N) return launch_layer<16, 16, 1, 1, 32, 3>(g, nk, s);
  const int count = sizeof(WIDE_TILES) / sizeof(WIDE_TILES[0]);
  int pick = count - 1;
  for (int i = 0; i < count; ++i) {
    const TileShape& t = WIDE_TILES[i];
    if ((long long)((g.M + t.bm - 1) / t.bm) * ((g.N + t.bn - 1) / t.bn) >= sm_count()) {
      pick = i;
      break;
    }
  }
  if ((g.N + WIDE_TILES[pick].bn - 1) / WIDE_TILES[pick].bn > 65535) return cudaErrorInvalidValue;
  switch (pick) {
    case 0: return launch_layer<128, 64, 8, 4, 16, 3>(g, nk, s);
    case 1: return launch_layer<64, 64, 4, 4, 16, 3>(g, nk, s);
    case 2: return launch_layer<32, 32, 2, 2, 32, 4>(g, nk, s);
    case 3: return launch_layer<16, 16, 1, 1, 32, 3>(g, nk, s);
    default: return launch_layer<16, 8, 1, 1, 32, 3>(g, nk, s);
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

Walk walk_of(int units) {
  return Walk{units, (65536 + units - 1) / units, THREADS / units, THREADS % units};
}

int copy_units(bool vec, int cols) { return vec ? (cols + 3) / 4 : cols; }

inline long long round4(long long n) { return (n + 3) & ~3LL; }

// The streamed route's row pitch of a hidden activation: the widest hidden
// width rounded up to 4 floats.
long long hidden_pitch(int L, const int* dims) {
  long long w = 0;
  for (int i = 1; i < L; ++i) w = std::max(w, round4(dims[i]));
  return w;
}

int sm_count() {  // of the current device, read once per process
  static int n = 0;
  if (n < 1) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 1;
  }
  return n;
}

// The resident route's plan at B rows: its tile (fewer rows a block than
// the caller's tile_rows while the grid would leave SMs idle: rows enough
// for one output of the widest layer a thread, or B spread over every SM,
// whichever is more; results do not depend on the tile), each layer's
// weight and bias offsets and pitch, then the two activation buffers (at
// h_off, pitch ldh).  Returns the shared-memory bytes it needs, or 0 where
// they pass MAX_SMEM and the launch takes the streamed route.
long long plan_resident(Net& net, const int* dims, int B, int tile_rows, int maxw, int& tile,
                        int& ldh, int& h_off) {
  int max_out = 1;
  for (int i = 1; i <= net.L; ++i) max_out = std::max(max_out, dims[i]);
  tile = std::min(tile_rows, std::max(std::max(1, THREADS / max_out), cdiv(B, sm_count())));
  long long off = 0;
  for (int l = 0; l < net.L; ++l) {
    Layer& ly = net.layer[l];
    const bool nk = ly.sk == 1;
    const int rows = nk ? ly.out : ly.in, cols = nk ? ly.in : ly.out;
    const long long s_row = nk ? ly.sn : ly.sk, s_col = nk ? ly.sk : ly.sn;
    ly.ldw = pitch_of(cols);
    ly.w_off = (int)off;
    off += (long long)rows * ly.ldw;
    ly.b_off = (int)off;
    off += 4LL * ((ly.out + 3) / 4);
    ly.w_vec = s_col == 1 && s_row % 4 == 0 && aligned16(ly.W);
    ly.b_vec = aligned16(ly.b);
    ly.w_walk = walk_of(copy_units(ly.w_vec, cols));
    ly.b_walk = walk_of(copy_units(ly.b_vec, ly.out));
    ly.o_walk = walk_of(ly.out);
    if (off > MAX_SMEM) return 0;  // does not fit; offsets stay in int
  }
  ldh = pitch_of(maxw);
  h_off = (int)off;
  off += 2LL * tile * ldh;
  return 4 * off <= MAX_SMEM ? 4 * off : 0;
}

bool make_net(Net& net, int L, const int* dims, const int* acts, void* const* Ws,
              const long long* w_strides, void* const* bs, int& maxw) {
  if (L < 1 || L > MAX_LAYERS) return false;
  net.L = L;
  maxw = 0;
  for (int i = 0; i < L; ++i) {
    if (dims[i] < 1 || dims[i + 1] < 1) return false;
    net.layer[i] = Layer{(const float*)Ws[i], w_strides[2 * i], w_strides[2 * i + 1],
                         (const float*)bs[i], dims[i], dims[i + 1], acts[i]};
    maxw = dims[i] > maxw ? dims[i] : maxw;
    maxw = dims[i + 1] > maxw ? dims[i + 1] : maxw;
  }
  return true;
}

template <typename K>
cudaError_t opt_in(K kernel, bool& done) {  // once per process: allow up to 227 KB
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

extern "C" {

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// 1 if a launch of these layers at B rows and this tile_rows takes the
// resident route, 0 if it takes the streamed one, -1 on invalid arguments.
// The weights' and biases' alignment does not change the route.
int fused_mlp_resident(int L, const int* dims, const long long* w_strides, int B,
                       int tile_rows) {
  void* const none[MAX_LAYERS] = {};
  const int acts[MAX_LAYERS] = {};
  Net net;
  int maxw = 0, tile = 0, ldh = 0, h_off = 0;
  if (B < 1 || tile_rows < 1 || tile_rows > MAX_TILE_ROWS ||
      !make_net(net, L, dims, acts, none, w_strides, none, maxw))
    return -1;
  return plan_resident(net, dims, B, tile_rows, maxw, tile, ldh, h_off) ? 1 : 0;
}

// Floats of device workspace a launch of these layers at B rows and this
// tile_rows needs: 0 on the resident route and for one layer, else room for
// one or two layers' outputs at the hidden widths' largest row pitch; -1 on
// invalid arguments.
long long fused_mlp_workspace_floats(int L, const int* dims, const long long* w_strides, int B,
                                     int tile_rows) {
  const int route = fused_mlp_resident(L, dims, w_strides, B, tile_rows);
  if (route < 0) return -1;
  return route == 1 || L == 1 ? 0 : (L > 2 ? 2LL : 1LL) * B * hidden_pitch(L, dims);
}

// x [B, dims[0]] contiguous -> y [B, dims[L]] contiguous.  Layer i reads
// Ws[i] with strides (w_strides[2i], w_strides[2i+1]) for (k, n) and the
// contiguous bias bs[i] [dims[i+1]].  At most tile_rows (1..16) rows a
// block on the resident route; fused_mlp_resident says which route a launch
// takes.  workspace: fused_mlp_workspace_floats floats, 16-byte aligned (or
// null where that is 0).
int fused_mlp_forward(int L, const int* dims, const int* acts,
                      void* const* Ws, const long long* w_strides,
                      void* const* bs, const void* x, int B, int tile_rows,
                      void* y, void* workspace, void* stream) {
  Net net;
  int maxw = 0;
  if (B < 1 || tile_rows < 1 || tile_rows > MAX_TILE_ROWS ||
      !make_net(net, L, dims, acts, Ws, w_strides, bs, maxw))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int tile = 0, ldh = 0, h_off = 0;
  const long long resident = plan_resident(net, dims, B, tile_rows, maxw, tile, ldh, h_off);
  if (resident) {
    static bool opted_in = false;
    const cudaError_t e = opt_in(fused_mlp_resident_kernel, opted_in);
    if (e != cudaSuccess) return (int)e;
    const int x_vec = dims[0] % 4 == 0 && aligned16(x);
    fused_mlp_resident_kernel<<<cdiv(B, tile), THREADS, (size_t)resident, s>>>(
        (const float*)x, (float*)y, B, tile, ldh, h_off, x_vec,
        walk_of(copy_units(x_vec, dims[0])), net);
    return (int)cudaGetLastError();
  }
  // the streamed route: one launch a layer, hidden activations in the
  // caller's workspace at a row pitch of a multiple of 4 floats
  if (L > 1 && (!workspace || !aligned16(workspace))) return (int)cudaErrorInvalidValue;
  const long long half = (long long)B * hidden_pitch(L, dims);
  const float* h = (const float*)x;
  long long ld_in = dims[0];
  int h_vec = dims[0] % 4 == 0 && aligned16(x);
  for (int l = 0; l < L; ++l) {
    const Layer& ly = net.layer[l];
    const bool last = l == L - 1;
    float* out = last ? (float*)y : (float*)workspace + (l % 2) * half;
    const long long ldo = last ? ly.out : round4(ly.out);
    const bool nk = ly.sk == 1;
    const int w_vec = nk ? (ly.out == 1 || ly.sn % 4 == 0) && aligned16(ly.W)
                         : ly.sn == 1 && (ly.in == 1 || ly.sk % 4 == 0) && aligned16(ly.W);
    const LayerGemm g{h, ly.W, ly.b, out, ld_in, ly.sk, ly.sn, ldo,
                      B, ly.in, ly.out, ly.act, h_vec, w_vec};
    const cudaError_t e = launch_layer(g, nk, s);
    if (e != cudaSuccess) return (int)e;
    h = out;
    ld_in = ldo;
    h_vec = 1;  // the workspace: 16-byte aligned rows
  }
  return (int)cudaSuccess;
}

}  // extern "C"
