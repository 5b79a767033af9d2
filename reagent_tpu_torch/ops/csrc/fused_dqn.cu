// Fused DQN update for Hopper (sm_90a): f32 throughout, or (K1's
// matmul_dtype / save_dtype options) with bf16 matrix products on the tensor
// cores and bf16 saved activations.
//
// Replaces the two TPU kernels that each run a whole DQN training step:
//   K1  reagent_tpu/ops/fused_dqn_offline.py::make_fused_dqn_offline_kernel
//       -> C entry fused_dqn_offline_update (batch split into 256-row chunks)
//   K2  reagent_tpu/ops/fused_dqn.py::make_fused_dqn_train_kernel
//       tensor interface -> C entry fused_dqn_update; packed interface
//       (packed=, :164-176) -> C entry fused_dqn_update_packed, which reads
//       raw PackedReplayBuffer rows in place: the observation columns through
//       the rows' stride, the action, reward and terminal columns per row, the
//       one-hot as |a - j| < 0.5, nt = 1 - terminal, and no mask.
//
// K2 is one launch per update (k2_one_launch_kernel), the TPU kernel's own
// shape: that kernel keeps the whole update in VMEM.  At the online shapes
// (4 -> 128 -> 64 -> 2, B = 512) the update is 44 MFLOP, 0.00067 ms at the
// card's f32 rate, so what bounds it is launch latency and the serial chain
// of small dependent products, not operations or bytes.  Design:
//   * G blocks of R = ceil(B / G) batch rows (R = 8 where ceil(B / 8)
//     blocks can be co-resident).  Each block stages both nets' W and b into
//     dynamic shared memory (16-byte loads, several in flight a thread; rows
//     at an odd pitch so a warp reading a column hits distinct banks) with
//     its obs and nobs rows;
//   * it runs its rows through the online net over obs (every layer's output
//     kept), the online net over nobs (double-Q only) and the target net over
//     nobs, each layer one product in shared memory with the bias and
//     activation fused in; then the TD rows (penalty, first-index argmax, y,
//     err, dL/dq, per-row metric terms); then dz back through the layers
//     (OLD weights, in shared memory), writing each layer's input and dz rows
//     to a workspace;
//   * one grid-wide barrier (cooperative launch, cooperative_groups grid
//     sync; every block co-resident by construction).  Then the blocks, and
//     as many more as there are tiles of the gradient (up to what the card
//     holds at once), share out TN x TK tiles of each layer's [dW | db]: each
//     entry is one fma chain over all B rows in order, staged through shared
//     memory, which is the launch sequence's order, so both routes give the
//     same gradient bit for bit (the f32 Adam trajectories part where |g| is
//     at rounding level, so the order matters at K2's tolerances).  Each
//     thread applies Adam, the parameter write and the polyak blend to its
//     entry in place; every block read the old weights before the barrier.
//     Block 0 sums the row blocks' metric terms in block order.
// Shapes whose weights and one block's rows exceed the 227 KB of shared
// memory, or whose blocks cannot all be co-resident, take the launch
// sequence below (16 launches single-Q, 19 double-Q); the entry decides from
// the shapes and the device before any launch and reports the count.
//
// K1 (and K2 where the one launch does not fit) is a fixed sequence of
// launches on the caller's stream:
//   (a) per layer, a shared-memory-tiled GEMM  h = act(x . W^T + b)  for the
//       online net over obs (outputs saved for the backward), the online net
//       over nobs (double-Q only) and the target net over nobs;
//   (b) one row-wise kernel: penalty, first-index argmax, y, err, dL/dq and
//       per-block partial metric sums;
//   (c) per layer, last to first: the weight AND bias gradients as one split-K
//       GEMM  [dW | db] = dz^T . [h_prev | 1]  into a [chunks, out, in+1]
//       workspace, then dh = dz . W with the activation-gradient epilogue
//       (it needs the old W, so it runs before the layer's Adam), then
//   (d) one elementwise kernel that sums the chunks in fixed order and applies
//       Adam, the parameter write and the polyak blend, in place;
//   and a one-block kernel that finishes the metrics row.
// No atomics in any value path, in either design: the result repeats bit for
// bit from run to run.
//
// Bound of K1: f32 operations (about 5 * B * sum(in*out) multiply-adds, no
// tensor cores at this precision) against a few MB of traffic.  Its GEMM is a
// plain 64x64x16 tile with a 4x4 register block per thread.
//
// K1 with matmul_dtype=bfloat16 (reagent_tpu/ops/fused_dqn_offline.py:71-72,
// :96-100) -> C entry fused_dqn_offline_update_bf16.  Every product rounds
// BOTH operands to bf16 and accumulates in f32: mma_gemm_kernel converts each
// tile to bf16 (round to nearest even) as it stages it in shared memory and
// multiplies 16x16x16 fragments with nvcuda::wmma (mma.sync HMMA, bf16 in,
// f32 accumulators); four warps share a 64x64x32 tile, each owning a 32x32
// corner, and the accumulators pass through shared memory to the same fused
// epilogues as the f32 kernel.  Master weights, Adam moments, the polyak
// blend, q, the TD rows and dz between layers stay f32.  The bias gradient is
// summed from the unrounded f32 dz by bias_grad_kernel (the ones column of
// the split-K GEMM would sum bf16-rounded dz), in fixed order.  With
// save_dtype=bfloat16 the saved layer outputs are stored as bf16 (half the
// workspace), the first-layer weight gradient reads the observation rounded
// to bf16, and the activation gradient is taken from the rounded h; q, the
// last layer's output, is never rounded.  All four (matmul, save) pairs run.
// At the tensor cores' bf16 rate the update's operations and its bytes (the
// batch, and eight parameter sets read and written) each take only
// microseconds, so this first design, one launch per product with scalar
// staging loads, is far from either bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, bound with ctypes; every entry returns cudaGetLastError()
// after each launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

namespace {

using namespace nvcuda;

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int GEMM_THREADS = 256;
// tensor-core GEMM: a TM x TN x MMA_TK tile, four warps, each a 32x32 corner
constexpr int MMA_TK = 32;
constexpr int MMA_LDK = MMA_TK + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int MMA_LDC = TN + 8;       // floats
constexpr int MMA_THREADS = 128;
constexpr int BIAS_GRAD_ROWS = 8;
constexpr int ROW_THREADS = 256;
constexpr int EW_THREADS = 256;
constexpr int OFFLINE_CHUNK_ROWS = 256;
constexpr float NOT_POSSIBLE = -1e9f;

enum Act { ACT_LINEAR = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };
enum Epi { EPI_BIAS_ACT = 0, EPI_ACT_GRAD = 1, EPI_SPLITK = 2 };

__device__ __forceinline__ float act_fwd(float z, int act) {
  switch (act) {
    case ACT_RELU: return z > 0.f ? z : 0.f;
    case ACT_LEAKY: return z > 0.f ? z : 0.01f * z;
    case ACT_TANH: return tanhf(z);
    default: return z;
  }
}

// Derivative from the layer OUTPUT h: relu/leaky_relu keep the sign of z,
// tanh' = 1 - h^2.
__device__ __forceinline__ float act_grad_from_h(float h, int act) {
  switch (act) {
    case ACT_RELU: return h > 0.f ? 1.f : 0.f;
    case ACT_LEAKY: return h > 0.f ? 1.f : 0.01f;
    case ACT_TANH: return 1.f - h * h;
    default: return 1.f;
  }
}

// A strided matrix in device memory: element (i, j) at p[i*s0 + j*s1], held
// as float or (bf16 != 0) as __nv_bfloat16.
struct Operand {
  const void* p;
  long long s0, s1;
  int bf16;
};

// The element type is a template argument, not a run-time flag: a branch
// around each load would keep a thread's loads of one tile from being in
// flight together.
template <bool BF16>
__device__ __forceinline__ float load_at(const void* p, long long i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One product, as the host describes it to either GEMM kernel:
// C[m, n] = sum_k A(m, k) * B(k, n) over k in each block's split-K chunk.
// ones_col: column N-1 of B is a virtual column of ones (gives the bias
// gradient beside the weight gradient; f32 kernel only).
// round_b: B is rounded to bf16 and back as it is loaded (f32 kernel: the
// observation as save_dtype=bfloat16 keeps it).
// Epilogues: EPI_BIAS_ACT  v = act(acc + aux[n]); C[m,n] = v, C16[m,n] = bf16(v)
//                          (either output may be null)
//            EPI_ACT_GRAD  C[m,n] = acc * act'(aux[m,n])   (aux = saved h)
//            EPI_SPLITK    C[z, m, n] = acc                 (z = chunk)
// H16 (a template argument of the kernels): the saved activation this
// product reads is bf16.  Which operand that is follows from the epilogue: A
// under EPI_BIAS_ACT (a hidden layer's input), B under EPI_SPLITK (h_prev),
// aux under EPI_ACT_GRAD; every other operand is float.
struct GemmArgs {
  Operand A;            // (m, k)
  Operand B;            // (k, n)
  int ones_col, round_b;
  float* C;
  __nv_bfloat16* C16;
  int ldc;              // row stride of C (N, or fan_in + 1 under EPI_SPLITK)
  int M, N, K, kchunk;
  const void* aux;      // bias [N] (f32) or saved h [M, N] (f32 or bf16)
  int aux_bf16, act;
};

// f32 products: shared-memory tiles, a 4x4 register block per thread.
// MIXED = false is the all-float32 update (K2, and K1 without options): float
// operands, C alone, row stride N.  MIXED = true serves float32 products
// beside bf16 saved activations: typed loads (H16), round_b, C16 and ldc.
// The two are one body with compile-time branches, so that the all-float32
// instantiation carries none of the other's selects and null checks.
template <int EPI, bool MIXED, bool H16>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const void* __restrict__ Ap, long long sam, long long sak,
            const void* __restrict__ Bp, long long sbk, long long sbn,
            int ones_col, float* __restrict__ C, int M, int N, int K,
            int kchunk, const void* __restrict__ aux, int act,
            int round_b, __nv_bfloat16* __restrict__ C16, int ldc) {
  constexpr bool A16 = H16 && EPI == EPI_BIAS_ACT;
  constexpr bool B16 = H16 && EPI == EPI_SPLITK;
  constexpr bool AUX16 = H16 && EPI == EPI_ACT_GRAD;
  __shared__ float As[TK][TM + 1];
  __shared__ float Bs[TK][TN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += TK) {
#pragma unroll
    for (int r = 0; r < (TM * TK) / GEMM_THREADS; ++r) {
      const int idx = tid + r * GEMM_THREADS;
      int mm, kk;
      if (sak == 1) { kk = idx % TK; mm = idx / TK; }   // k contiguous
      else          { mm = idx % TM; kk = idx / TM; }   // m contiguous
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < kend) ? load_at<A16>(Ap, gm * sam + gk * sak) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (TN * TK) / GEMM_THREADS; ++r) {
      const int idx = tid + r * GEMM_THREADS;
      int nn, kk;
      if (sbn == 1) { nn = idx % TN; kk = idx / TN; }   // n contiguous
      else          { kk = idx % TK; nn = idx / TK; }   // k contiguous
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < kend)
        v = (ones_col && gn == N - 1) ? 1.f : load_at<B16>(Bp, gk * sbk + gn * sbn);
      if (MIXED) v = round_b ? round_bf16(v) : v;
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int ld = MIXED ? ldc : N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i;
      const int n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      const long long o = (long long)m * ld + n;
      if (EPI == EPI_BIAS_ACT) {
        const float v = act_fwd(acc[i][j] + static_cast<const float*>(aux)[n], act);
        if (!MIXED || C) C[o] = v;
        if (MIXED && C16) C16[o] = __float2bfloat16_rn(v);
      } else if (EPI == EPI_ACT_GRAD) {
        C[o] = acc[i][j] * act_grad_from_h(load_at<AUX16>(aux, o), act);
      } else {
        C[(long long)blockIdx.z * M * ld + o] = acc[i][j];
      }
    }
  }
}

// bf16 products on the tensor cores, f32 accumulation.  Both operands are
// rounded to bf16 (nearest even) as the tile is staged; tails are zero-filled,
// so no dimension has to be a multiple of the fragment.  As is [m][k] and Bs
// is [n][k], k contiguous: row-major A and column-major B fragments.
template <int EPI, bool H16>
__global__ void __launch_bounds__(MMA_THREADS)
mma_gemm_kernel(const void* __restrict__ Ap, long long sam, long long sak,
                const void* __restrict__ Bp, long long sbk, long long sbn,
                float* __restrict__ C, int M, int N, int K, int kchunk,
                const void* __restrict__ aux, int act,
                __nv_bfloat16* __restrict__ C16, int ldc) {
  constexpr bool A16 = H16 && EPI == EPI_BIAS_ACT;
  constexpr bool B16 = H16 && EPI == EPI_SPLITK;
  constexpr bool AUX16 = H16 && EPI == EPI_ACT_GRAD;
  __shared__ __align__(32) unsigned short As_raw[TM * MMA_LDK];
  __shared__ __align__(32) unsigned short Bs_raw[TN * MMA_LDK];
  __shared__ __align__(32) float Cs[TM * MMA_LDC];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(As_raw);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(Bs_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = kbeg; k0 < kend; k0 += MMA_TK) {
#pragma unroll
    for (int r = 0; r < (TM * MMA_TK) / MMA_THREADS; ++r) {
      const int idx = tid + r * MMA_THREADS;
      int mm, kk;
      if (sak == 1) { kk = idx % MMA_TK; mm = idx / MMA_TK; }   // k contiguous
      else          { mm = idx % TM; kk = idx / TM; }           // m contiguous
      const int gm = m0 + mm, gk = k0 + kk;
      const float v = (gm < M && gk < kend)
                          ? load_at<A16>(Ap, gm * sam + gk * sak) : 0.f;
      As[mm * MMA_LDK + kk] = __float2bfloat16_rn(v);
    }
#pragma unroll
    for (int r = 0; r < (TN * MMA_TK) / MMA_THREADS; ++r) {
      const int idx = tid + r * MMA_THREADS;
      int nn, kk;
      if (sbn == 1) { nn = idx % TN; kk = idx / TN; }           // n contiguous
      else          { kk = idx % MMA_TK; nn = idx / MMA_TK; }   // k contiguous
      const int gn = n0 + nn, gk = k0 + kk;
      const float v = (gn < N && gk < kend)
                          ? load_at<B16>(Bp, gk * sbk + gn * sbn) : 0.f;
      Bs[nn * MMA_LDK + kk] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MMA_TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * MMA_LDK + kk, MMA_LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn + 16 * j) * MMA_LDK + kk, MMA_LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * MMA_LDC + wn + 16 * j, acc[i][j],
                              MMA_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < TM * TN; idx += MMA_THREADS) {
    const int mm = idx / TN, nn = idx % TN;
    const int m = m0 + mm, n = n0 + nn;
    if (m >= M || n >= N) continue;
    const float sum = Cs[mm * MMA_LDC + nn];
    const long long o = (long long)m * ldc + n;
    if (EPI == EPI_BIAS_ACT) {
      const float v = act_fwd(sum + static_cast<const float*>(aux)[n], act);
      if (C) C[o] = v;
      if (C16) C16[o] = __float2bfloat16_rn(v);
    } else if (EPI == EPI_ACT_GRAD) {
      C[o] = sum * act_grad_from_h(load_at<AUX16>(aux, o), act);
    } else {
      C[(long long)blockIdx.z * M * ldc + o] = sum;
    }
  }
}

// The bias gradient of one split-K chunk from the UNROUNDED f32 dz:
// grad[z, n, cols-1] = sum over the chunk's rows m of dz[m, n], rows strided
// over BIAS_GRAD_ROWS threads and those partial sums added in fixed order.
__global__ void __launch_bounds__(32 * BIAS_GRAD_ROWS)
bias_grad_kernel(const float* __restrict__ dz, float* __restrict__ grad, int B,
                 int out, int cols, int chunk_rows) {
  __shared__ float red[BIAS_GRAD_ROWS][33];
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + tx;
  const int z = blockIdx.y;
  const int mbeg = z * chunk_rows;
  const int mend = min(B, mbeg + chunk_rows);
  float s = 0.f;
  if (n < out)
    for (int m = mbeg + ty; m < mend; m += BIAS_GRAD_ROWS) s += dz[(long long)m * out + n];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && n < out) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < BIAS_GRAD_ROWS; ++i) t += red[i][tx];
    grad[((long long)z * out + n) * cols + cols - 1] = t;
  }
}

// Where an update reads its batch.  Tensor interface (rows == nullptr):
// obs/nobs [B, D] (ld = D), act and mask [B, A], rew and nt [B, 1].
// Packed interface: obs/nobs point at the observation column of the raw
// replay rows (ld = row width); action, reward and terminal are columns of
// the same rows, and every next action is possible.
struct BatchIn {
  const float* obs;
  const float* nobs;
  long long obs_ld, nobs_ld;
  const float* act;
  const float* rew;
  const float* nt;
  const float* mask;
  const float* rows;
  long long rows_ld;
  int act_col, rew_col, term_col;
};

__device__ __forceinline__ float penalty_at(const BatchIn& in, long long r, int a) {
  return in.rows ? 0.f : NOT_POSSIBLE * (1.f - in.mask[r + a]);
}

__device__ __forceinline__ float action_at(const BatchIn& in, int m, long long r, int a) {
  if (!in.rows) return in.act[r + a];
  const float code = in.rows[m * in.rows_ld + in.act_col];
  return fabsf((float)a - code) < 0.5f ? 1.f : 0.f;
}

// One thread per row.  sel_q is q_online(nobs) for double-Q, else q_target.
__global__ void __launch_bounds__(ROW_THREADS)
td_rows_kernel(const float* __restrict__ q, const float* __restrict__ sel_q,
               const float* __restrict__ qt, BatchIn in, float* __restrict__ dz,
               float* __restrict__ partials, int B, int A, float gamma,
               float two_over_b) {
  __shared__ float red[4][ROW_THREADS];
  const int tid = threadIdx.x;
  const int m = blockIdx.x * ROW_THREADS + tid;
  float s_err2 = 0.f, s_q = 0.f, s_qtaken = 0.f, s_r = 0.f;
  if (m < B) {
    const long long r = (long long)m * A;
    const float rew = in.rows ? in.rows[m * in.rows_ld + in.rew_col] : in.rew[m];
    const float nt = in.rows ? 1.f - in.rows[m * in.rows_ld + in.term_col] : in.nt[m];
    int best = 0;
    float best_v = sel_q[r] + penalty_at(in, r, 0);
    for (int a = 1; a < A; ++a) {
      const float v = sel_q[r + a] + penalty_at(in, r, a);
      if (v > best_v) { best_v = v; best = a; }  // first index wins ties
    }
    const float next_sel = qt[r + best] + penalty_at(in, r, best);
    const float y = rew + gamma * next_sel * nt;
    float q_taken = 0.f, q_sum = 0.f;
    for (int a = 0; a < A; ++a) {
      q_taken += q[r + a] * action_at(in, m, r, a);
      q_sum += q[r + a];
    }
    const float err = q_taken - y;
    const float g = two_over_b * err;
    for (int a = 0; a < A; ++a) dz[r + a] = g * action_at(in, m, r, a);
    s_err2 = err * err;
    s_q = q_sum;
    s_qtaken = q_taken;
    s_r = rew;
  }
  red[0][tid] = s_err2;
  red[1][tid] = s_q;
  red[2][tid] = s_qtaken;
  red[3][tid] = s_r;
  __syncthreads();
  for (int s = ROW_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s)
#pragma unroll
      for (int k = 0; k < 4; ++k) red[k][tid] += red[k][tid + s];
    __syncthreads();
  }
  if (tid < 4) partials[blockIdx.x * 4 + tid] = red[tid][0];
}

__global__ void metrics_kernel(const float* __restrict__ partials, int nblocks,
                               int B, int A, float* __restrict__ metrics) {
  const int k = threadIdx.x;
  if (k >= 4) return;
  float s = 0.f;
  for (int i = 0; i < nblocks; ++i) s += partials[i * 4 + k];
  const float denom = (k == 1) ? (float)B * (float)A : (float)B;
  metrics[k] = s / denom;
}

struct AdamConsts {
  float tau, one_minus_tau, b1, one_minus_b1, b2, one_minus_b2;
};

// Element i of the [out, in+1] gradient: column < in is W, column in is b.
__global__ void __launch_bounds__(EW_THREADS)
adam_polyak_kernel(float* __restrict__ W, float* __restrict__ b,
                   float* __restrict__ Wt, float* __restrict__ bt,
                   float* __restrict__ mW, float* __restrict__ mb,
                   float* __restrict__ vW, float* __restrict__ vb,
                   const float* __restrict__ grad_chunks, int nchunks,
                   int out, int in, const float* __restrict__ lr_t_p,
                   const float* __restrict__ eps_t_p, AdamConsts c) {
  const int cols = in + 1;
  const long long total = (long long)out * cols;
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= total) return;
  float g = 0.f;
  for (int z = 0; z < nchunks; ++z) g += grad_chunks[z * total + i];  // fixed order
  const int n = (int)(i / cols);
  const int j = (int)(i % cols);
  float *p, *pt, *m, *v;
  long long o;
  if (j < in) { p = W; pt = Wt; m = mW; v = vW; o = (long long)n * in + j; }
  else        { p = b; pt = bt; m = mb; v = vb; o = n; }
  const float lr_t = *lr_t_p;
  const float eps_t = *eps_t_p;
  const float m_n = c.b1 * m[o] + c.one_minus_b1 * g;
  const float v_n = c.b2 * v[o] + c.one_minus_b2 * g * g;
  const float p_n = p[o] - lr_t * m_n / (sqrtf(v_n) + eps_t);
  m[o] = m_n;
  v[o] = v_n;
  p[o] = p_n;
  pt[o] = c.tau * p_n + c.one_minus_tau * pt[o];
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Which of K1's options an update runs with.
struct Precision {
  int matmul_bf16;  // products on the tensor cores, operands rounded to bf16
  int save_bf16;    // saved layer outputs (and the saved observation) in bf16
};

struct Layout {
  // float offsets into the workspace, each a multiple of 4 (16 bytes)
  long long h[17];   // saved online outputs over obs, layers 1..L (h[L] = q);
                     // under save_bf16 layers 1..L-1 hold bf16, q stays f32
  long long tmp0, tmp1, qn, qt, dz0, dz1, grad, partials, total;
  int nchunks, chunk_rows, maxw, nrowblocks;
};

constexpr int MAX_LAYERS = 16;

bool make_layout(int L, const int* dims, int B, int offline, int save_bf16, Layout* lay) {
  if (L < 1 || L > MAX_LAYERS || B < 1) return false;
  lay->chunk_rows = offline ? OFFLINE_CHUNK_ROWS : B;
  lay->nchunks = cdiv(B, lay->chunk_rows);
  lay->nrowblocks = cdiv(B, ROW_THREADS);
  int maxw = 0;
  for (int i = 0; i <= L; ++i) maxw = dims[i] > maxw ? dims[i] : maxw;
  lay->maxw = maxw;
  long long off = 0;
  auto take = [&off](long long floats) {
    const long long at = off;
    off += (floats + 3) / 4 * 4;
    return at;
  };
  lay->h[0] = -1;  // obs itself
  for (int i = 1; i <= L; ++i) {
    const long long n = (long long)B * dims[i];
    lay->h[i] = take(save_bf16 && i < L ? (n + 1) / 2 : n);
  }
  const int A = dims[L];
  lay->tmp0 = take((long long)B * maxw);
  lay->tmp1 = take((long long)B * maxw);
  lay->qn = take((long long)B * A);
  lay->qt = take((long long)B * A);
  lay->dz0 = take((long long)B * maxw);
  lay->dz1 = take((long long)B * maxw);
  long long g = 0;
  for (int i = 0; i < L; ++i) {
    const long long s = (long long)lay->nchunks * dims[i + 1] * (dims[i] + 1);
    g = s > g ? s : g;
  }
  lay->grad = take(g);
  lay->partials = take((long long)lay->nrowblocks * 4);
  lay->total = off;
  return true;
}

template <int EPI>
cudaError_t gemm(cudaStream_t st, const GemmArgs& g, int nchunks, int tensor_cores) {
  dim3 grid(cdiv(g.N, TN), cdiv(g.M, TM), nchunks);
  const bool h16 = g.A.bf16 || g.B.bf16 || g.aux_bf16;
#define MMA_ARGS                                                              \
  g.A.p, g.A.s0, g.A.s1, g.B.p, g.B.s0, g.B.s1, g.C, g.M, g.N, g.K, g.kchunk, \
      g.aux, g.act, g.C16, g.ldc
#define FMA_ARGS                                                                  \
  g.A.p, g.A.s0, g.A.s1, g.B.p, g.B.s0, g.B.s1, g.ones_col, g.C, g.M, g.N, g.K,  \
      g.kchunk, g.aux, g.act, g.round_b, g.C16, g.ldc
  if (tensor_cores) {
    if (h16) mma_gemm_kernel<EPI, true><<<grid, MMA_THREADS, 0, st>>>(MMA_ARGS);
    else mma_gemm_kernel<EPI, false><<<grid, MMA_THREADS, 0, st>>>(MMA_ARGS);
  } else {
    const bool mixed = h16 || g.round_b || g.C16 || g.ldc != g.N;
    if (!mixed) gemm_kernel<EPI, false, false><<<grid, GEMM_THREADS, 0, st>>>(FMA_ARGS);
    else if (h16) gemm_kernel<EPI, true, true><<<grid, GEMM_THREADS, 0, st>>>(FMA_ARGS);
    else gemm_kernel<EPI, true, false><<<grid, GEMM_THREADS, 0, st>>>(FMA_ARGS);
  }
#undef MMA_ARGS
#undef FMA_ARGS
  return cudaGetLastError();
}

#define CHECK(expr)                          \
  do {                                       \
    cudaError_t e_ = (expr);                 \
    if (e_ != cudaSuccess) return (int)e_;   \
    ++*n_launches;                           \
  } while (0)

// Forward x [B, dims[0]] through L layers; layer i writes its output
// (contiguous) to outs[i] as f32 and/or to outs16[i] as bf16, and the next
// layer reads the f32 copy where there is one.
int forward(cudaStream_t st, Operand x, float* const* Ws, float* const* bs,
            const int* dims, const int* acts, int L, int B, float* const* outs,
            __nv_bfloat16* const* outs16, int tensor_cores, int* n_launches) {
  Operand in = x;
  for (int i = 0; i < L; ++i) {
    const int K = dims[i], N = dims[i + 1];
    GemmArgs g{};
    g.A = in;
    g.B = Operand{Ws[i], 1, K, 0};
    g.C = outs[i];
    g.C16 = outs16 ? outs16[i] : nullptr;
    g.ldc = N;
    g.M = B; g.N = N; g.K = K; g.kchunk = K;
    g.aux = bs[i];
    g.act = acts[i];
    CHECK(gemm<EPI_BIAS_ACT>(st, g, 1, tensor_cores));
    in = g.C ? Operand{g.C, N, 1, 0} : Operand{g.C16, N, 1, 1};
  }
  return 0;
}

int run_update(int L, const int* dims, const int* acts, int B, int double_q,
               const float* consts, void* const* params, const BatchIn& in,
               const float* lr_t, const float* eps_t, float* metrics, float* ws,
               int* n_launches, cudaStream_t st, int offline, Precision pr) {
  *n_launches = 0;
  Layout lay;
  if (!make_layout(L, dims, B, offline, pr.save_bf16, &lay))
    return (int)cudaErrorInvalidValue;
  float* const* P = reinterpret_cast<float* const*>(params);
  float* const* W = P;
  float* const* b = P + L;
  float* const* Wt = P + 2 * L;
  float* const* bt = P + 3 * L;
  float* const* mW = P + 4 * L;
  float* const* mb = P + 5 * L;
  float* const* vW = P + 6 * L;
  float* const* vb = P + 7 * L;
  const int A = dims[L];
  const float gamma = consts[0];
  const AdamConsts ac{consts[1], consts[2], consts[3], consts[4], consts[5], consts[6]};
  const float two_over_b = consts[7];
  const int tc = pr.matmul_bf16;

  // (a) forwards.  The online net's outputs over obs are saved for the
  // backward: as f32 in the h regions, or under save_bf16 as bf16 there (the
  // next layer then reads that copy, which is what it would round to, when
  // the products are bf16, and an f32 copy in tmp when they are f32).
  float* tmp[MAX_LAYERS];
  for (int i = 0; i < L; ++i) tmp[i] = ws + ((i % 2) ? lay.tmp1 : lay.tmp0);
  float* h32[MAX_LAYERS];
  __nv_bfloat16* h16[MAX_LAYERS];
  for (int i = 0; i < L; ++i) {
    if (pr.save_bf16 && i < L - 1) {
      h16[i] = reinterpret_cast<__nv_bfloat16*>(ws + lay.h[i + 1]);
      h32[i] = tc ? nullptr : tmp[i];
    } else {
      h16[i] = nullptr;
      h32[i] = ws + lay.h[i + 1];
    }
  }
  int e = forward(st, Operand{in.obs, in.obs_ld, 1, 0}, W, b, dims, acts, L, B, h32,
                  h16, tc, n_launches);
  if (e) return e;
  const Operand nobs{in.nobs, in.nobs_ld, 1, 0};
  if (double_q) {
    tmp[L - 1] = ws + lay.qn;
    e = forward(st, nobs, W, b, dims, acts, L, B, tmp, nullptr, tc, n_launches);
    if (e) return e;
  }
  tmp[L - 1] = ws + lay.qt;
  e = forward(st, nobs, Wt, bt, dims, acts, L, B, tmp, nullptr, tc, n_launches);
  if (e) return e;

  // (b) TD rows
  const float* q = ws + lay.h[L];
  const float* sel_q = double_q ? ws + lay.qn : ws + lay.qt;
  float* dz = ws + lay.dz0;
  float* dz_next = ws + lay.dz1;
  td_rows_kernel<<<lay.nrowblocks, ROW_THREADS, 0, st>>>(
      q, sel_q, ws + lay.qt, in, dz, ws + lay.partials, B, A, gamma, two_over_b);
  CHECK(cudaGetLastError());

  // (c) + (d) backward and update, last layer first
  float* grad = ws + lay.grad;
  for (int i = L - 1; i >= 0; --i) {
    const int fan_in = dims[i], out = dims[i + 1];
    // the saved input of layer i: the observation, or layer i-1's output
    Operand h_prev{in.obs, in.obs_ld, 1, 0};
    if (i > 0) {
      if (pr.save_bf16) h_prev = Operand{h16[i - 1], fan_in, 1, 1};
      else h_prev = Operand{h32[i - 1], fan_in, 1, 0};
    }
    // [dW | db][n, j] = sum_m dz[m, n] * [h_prev | 1][m, j].  On the tensor
    // cores the GEMM gives dW alone and db comes from the f32 dz.
    GemmArgs gw{};
    gw.A = Operand{dz, 1, out, 0};
    gw.B = h_prev;
    gw.ones_col = !tc;
    gw.round_b = pr.save_bf16 && i == 0;
    gw.C = grad;
    gw.ldc = fan_in + 1;
    gw.M = out; gw.N = tc ? fan_in : fan_in + 1; gw.K = B; gw.kchunk = lay.chunk_rows;
    CHECK(gemm<EPI_SPLITK>(st, gw, lay.nchunks, tc));
    if (tc) {
      bias_grad_kernel<<<dim3(cdiv(out, 32), lay.nchunks), 32 * BIAS_GRAD_ROWS, 0, st>>>(
          dz, grad, B, out, fan_in + 1, lay.chunk_rows);
      CHECK(cudaGetLastError());
    }
    if (i > 0) {
      // dz_prev[m, j] = (sum_n dz[m, n] * W[n, j]) * act'(h_prev[m, j])
      GemmArgs gh{};
      gh.A = Operand{dz, out, 1, 0};
      gh.B = Operand{W[i], fan_in, 1, 0};
      gh.C = dz_next;
      gh.ldc = fan_in;
      gh.M = B; gh.N = fan_in; gh.K = out; gh.kchunk = out;
      gh.aux = h_prev.p;
      gh.aux_bf16 = h_prev.bf16;
      gh.act = acts[i - 1];
      CHECK(gemm<EPI_ACT_GRAD>(st, gh, 1, tc));
    }
    const long long total = (long long)out * (fan_in + 1);
    adam_polyak_kernel<<<cdiv(total, EW_THREADS), EW_THREADS, 0, st>>>(
        W[i], b[i], Wt[i], bt[i], mW[i], mb[i], vW[i], vb[i], grad,
        lay.nchunks, out, fan_in, lr_t, eps_t, ac);
    CHECK(cudaGetLastError());
    float* t = dz; dz = dz_next; dz_next = t;
  }

  metrics_kernel<<<1, 32, 0, st>>>(ws + lay.partials, lay.nrowblocks, B, A, metrics);
  CHECK(cudaGetLastError());
  return 0;
}

BatchIn tensor_batch(int D, const void* obs, const void* nobs, const void* act,
                     const void* rew, const void* nt, const void* mask) {
  BatchIn in{};
  in.obs = (const float*)obs;
  in.nobs = (const float*)nobs;
  in.obs_ld = in.nobs_ld = D;
  in.act = (const float*)act;
  in.rew = (const float*)rew;
  in.nt = (const float*)nt;
  in.mask = (const float*)mask;
  return in;
}

// ----------------------------------------------------------------------------
// K2 in one launch: blocks of R batch rows, each holding both nets' weights
// in shared memory, then one grid-wide barrier, then the weight-gradient
// tiles and Adam (see the header).

constexpr int ONE_THREADS = 256;
constexpr int ONE_ROWS = 8;     // rows a block takes when the grid can hold B / 8 blocks
constexpr int ONE_PLAN_TRIES = 8;

// Shared-memory matrices have an odd row pitch: a warp reading a column of
// them (16 or 32 rows at one k) then hits distinct banks.
__host__ __device__ __forceinline__ int pitch_of(int n) { return n | 1; }

// Float offsets into a block's dynamic shared memory.
struct OneLayout {
  int w[MAX_LAYERS], b[MAX_LAYERS];    // online W [out][pitch(in)], b [out]
  int wt[MAX_LAYERS], bt[MAX_LAYERS];  // the target net's, alike
  int h[MAX_LAYERS + 1];               // h[0]: the block's obs rows; h[i]: the online
                                       // net's layer i-1 output over them (h[L] = q)
  int nx, s0, s1, qn, qt, rowv;        // nobs rows, two scratch buffers (forward
                                       // ping-pong, then dz), q over nobs, per-row sums
};

struct OneArgs {
  int L, B, R, double_q;
  int G_rows, G;                // blocks with batch rows; all blocks (the rest only
                                // take weight-gradient tiles after the barrier)
  int smem_floats;              // dynamic shared memory of a block
  int dims[MAX_LAYERS + 1];
  int acts[MAX_LAYERS];
  long long hg[MAX_LAYERS];     // workspace: layer i's input over the batch [B, in]
  long long dzg[MAX_LAYERS];    // workspace: dL/dz of layer i [B, out]
  long long mg;                 // workspace: [G_rows, 4] metric sums
  float* prm[8 * MAX_LAYERS];   // params8: W, b, Wt, bt, mW, mb, vW, vb (L each)
  BatchIn in;
  const float* lr_t;
  const float* eps_t;
  float* metrics;
  float* ws;
  float gamma, two_over_b;
  AdamConsts ac;
  OneLayout sm;
};

// After the barrier the [out, in + 1] gradient [dW | db] of each layer is cut
// into tiles of TN x TK entries (TK = in + 1 up to 32, a power of two; TN =
// ONE_THREADS / TK), one entry per thread.
__host__ __device__ __forceinline__ int tile_k_bits(int in) {
  int b = 0;
  while ((1 << b) < in + 1 && b < 5) ++b;
  return b;
}

__host__ __device__ __forceinline__ int layer_tiles(int in, int out) {
  const int kb = tile_k_bits(in);
  const int tk = 1 << kb, tn = ONE_THREADS >> kb;
  return ((in + 1 + tk - 1) / tk) * ((out + tn - 1) / tn);
}

// The shared-memory layout for blocks of R rows; returns its size in floats.
long long one_layout(int L, const int* dims, int R, OneLayout* s) {
  long long off = 0;
  auto take = [&off](long long floats) {
    const long long at = off;
    off += floats;
    return (int)at;
  };
  for (int i = 0; i < L; ++i) {
    s->w[i] = take((long long)dims[i + 1] * pitch_of(dims[i]));
    s->b[i] = take(dims[i + 1]);
  }
  for (int i = 0; i < L; ++i) {
    s->wt[i] = take((long long)dims[i + 1] * pitch_of(dims[i]));
    s->bt[i] = take(dims[i + 1]);
  }
  int maxw = 0;
  for (int i = 1; i <= L; ++i) maxw = dims[i] > maxw ? dims[i] : maxw;
  for (int i = 0; i <= L; ++i) s->h[i] = take((long long)R * pitch_of(dims[i]));
  s->nx = take((long long)R * pitch_of(dims[0]));
  s->s0 = take((long long)R * pitch_of(maxw));
  s->s1 = take((long long)R * pitch_of(maxw));
  s->qn = take((long long)R * pitch_of(dims[L]));
  s->qt = take((long long)R * pitch_of(dims[L]));
  s->rowv = take(4LL * R);
  // after the barrier the whole region stages gradient tiles, at least 64 rows
  constexpr long long stage_min = 64LL * (ONE_THREADS / 2 + 2);
  return off > stage_min ? off : stage_min;
}

// Loads a thread keeps in flight while it fills shared memory: a load from
// L2 takes hundreds of cycles, and a loop that stores each value before it
// issues the next load pays that once per element.
constexpr int IN_FLIGHT = 8;

// dst[e] = value_at(e) for e < n, IN_FLIGHT loads per thread at a time.
template <class F>
__device__ __forceinline__ void fill(float* dst, int n, F value_at) {
  for (int e0 = threadIdx.x; e0 < n; e0 += IN_FLIGHT * ONE_THREADS) {
    float v[IN_FLIGHT];
#pragma unroll
    for (int j = 0; j < IN_FLIGHT; ++j) {
      const int e = e0 + j * ONE_THREADS;
      v[j] = e < n ? value_at(e) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < IN_FLIGHT; ++j) {
      const int e = e0 + j * ONE_THREADS;
      if (e < n) dst[e] = v[j];
    }
  }
}

// rows x cols of a contiguous matrix in device memory into shared memory at
// row pitch `pitch`, with 16-byte loads (IN_FLIGHT / 2 at a time) where the
// source is 16-byte aligned.
__device__ __forceinline__ void stage(float* dst, int pitch, const float* src, int rows, int cols) {
  constexpr int V = IN_FLIGHT / 2;
  const int total = rows * cols;
  int done = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    const int n4 = total / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int q0 = threadIdx.x; q0 < n4; q0 += V * ONE_THREADS) {
      float4 v[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (q0 + j * ONE_THREADS < n4) v[j] = s4[q0 + j * ONE_THREADS];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int q = q0 + j * ONE_THREADS;
        if (q < n4) {
          const float vals[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
          int r = (4 * q) / cols, c = (4 * q) % cols;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            dst[r * pitch + c] = vals[t];
            if (++c == cols) { c = 0; ++r; }
          }
        }
      }
    }
    done = 4 * n4;
  }
  for (int e = done + threadIdx.x; e < total; e += ONE_THREADS)
    dst[(e / cols) * pitch + e % cols] = src[e];
}

// C(m, n) = sum_k A[m*sam + k*sak] * Bm[k*sbk + n*sbn] for m < M, n < N, both
// operands in shared memory; epi(m, n, sum) stores each result.  The block's
// threads form a TY x TX grid (TX = 2^txb); each owns MI x NJ outputs of a
// tile, m = m0 + ty + TY*i and n = n0 + tx + TX*j.  Rows and columns past the
// edge read row/column 0 and are not stored.
template <int MI, int NJ, class Epi>
__device__ __forceinline__ void product_tiles(const float* __restrict__ A, int sam, int sak,
                                              const float* __restrict__ Bm, int sbk, int sbn,
                                              int M, int N, int K, int txb, Epi epi) {
  const int TX = 1 << txb, TY = ONE_THREADS >> txb;
  const int tx = threadIdx.x & (TX - 1), ty = threadIdx.x >> txb;
  for (int m0 = 0; m0 < M; m0 += MI * TY) {
    for (int n0 = 0; n0 < N; n0 += NJ * TX) {
      int ao[MI], bo[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int m = m0 + ty + TY * i;
        ao[i] = (m < M ? m : 0) * sam;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + tx + TX * j;
        bo[j] = (n < N ? n : 0) * sbn;
      }
      float acc[MI][NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float a[MI], b[NJ];
#pragma unroll
        for (int i = 0; i < MI; ++i) a[i] = A[ao[i] + k * sak];
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = Bm[bo[j] + k * sbk];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int m = m0 + ty + TY * i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = n0 + tx + TX * j;
          if (m < M && n < N) epi(m, n, acc[i][j]);
        }
      }
    }
  }
}

// The product above with each thread's MI x NJ block chosen from the outputs
// per thread (up to 4 x 4) and TX from N, so that few outputs go idle.
template <class Epi>
__device__ __forceinline__ void product(const float* A, int sam, int sak, const float* Bm,
                                        int sbk, int sbn, int M, int N, int K, Epi epi) {
  const int per = (M * N + ONE_THREADS - 1) / ONE_THREADS;
  const int nj = (per >= 4 && N >= 4) ? 4 : ((per >= 2 && N >= 2) ? 2 : 1);
  const int mi = per >= 4 * nj ? 4 : (per >= 2 * nj ? 2 : 1);
  int txb = 0;
  while ((nj << txb) < N && txb < 8) ++txb;
#define ONE_PRODUCT(I, J) \
  product_tiles<I, J>(A, sam, sak, Bm, sbk, sbn, M, N, K, txb, epi)
  if (mi == 4) {
    if (nj == 4) ONE_PRODUCT(4, 4); else if (nj == 2) ONE_PRODUCT(4, 2); else ONE_PRODUCT(4, 1);
  } else if (mi == 2) {
    if (nj == 4) ONE_PRODUCT(2, 4); else if (nj == 2) ONE_PRODUCT(2, 2); else ONE_PRODUCT(2, 1);
  } else {
    if (nj == 4) ONE_PRODUCT(1, 4); else if (nj == 2) ONE_PRODUCT(1, 2); else ONE_PRODUCT(1, 1);
  }
#undef ONE_PRODUCT
}

// y[m][n] = act(sum_k x[m][k] * W[n][k] + b[n]) for the block's M rows.
__device__ __forceinline__ void dense_rows(const float* x, int px, const float* W, int pw,
                                           const float* b, float* y, int py, int M, int N,
                                           int K, int act) {
  product(x, px, 1, W, 1, pw, M, N, K,
          [=](int m, int n, float s) { y[m * py + n] = act_fwd(s + b[n], act); });
}

// Adam, the parameter write and the polyak blend of entry o, gradient g.
__device__ __forceinline__ void adam_entry(float* p, float* pt, float* m, float* v, long long o,
                                           float g, float lr_t, float eps_t,
                                           const AdamConsts& c) {
  const float m_n = c.b1 * m[o] + c.one_minus_b1 * g;
  const float v_n = c.b2 * v[o] + c.one_minus_b2 * g * g;
  const float p_n = p[o] - lr_t * m_n / (sqrtf(v_n) + eps_t);
  m[o] = m_n;
  v[o] = v_n;
  p[o] = p_n;
  pt[o] = c.tau * p_n + c.one_minus_tau * pt[o];
}

__global__ void __launch_bounds__(ONE_THREADS)
k2_one_launch_kernel(const OneArgs a) {
  extern __shared__ float sm[];
  __shared__ int dims[MAX_LAYERS + 1], acts[MAX_LAYERS], hoff[MAX_LAYERS + 1];
  __shared__ int woff[MAX_LAYERS], boff[MAX_LAYERS], wtoff[MAX_LAYERS], btoff[MAX_LAYERS];
  const int tid = threadIdx.x, g = blockIdx.x;
  const int L = a.L, R = a.R;
  if (tid <= L) {
    dims[tid] = a.dims[tid];
    hoff[tid] = a.sm.h[tid];
  }
  if (tid < L) {
    acts[tid] = a.acts[tid];
    woff[tid] = a.sm.w[tid];
    boff[tid] = a.sm.b[tid];
    wtoff[tid] = a.sm.wt[tid];
    btoff[tid] = a.sm.bt[tid];
  }
  const BatchIn in = a.in;
  const int r0 = g * R;
  const int Rb = min(R, a.B - r0);   // this block's rows
  const int D = a.dims[0], A = a.dims[L];
  const int nx = a.sm.nx, s0 = a.sm.s0, s1 = a.sm.s1, qn = a.sm.qn, qt = a.sm.qt;
  const int rowv = a.sm.rowv;

  float* ws = a.ws;
  float* dz = sm + s0;
  float* dz_next = sm + s1;
  if (g < a.G_rows) {  // rows
    // (0) both nets' weights and the block's obs and nobs rows into shared memory
    for (int i = 0; i < L; ++i) {
      const int N = a.dims[i + 1], K = a.dims[i];
      stage(sm + a.sm.w[i], pitch_of(K), a.prm[i], N, K);
      stage(sm + a.sm.b[i], N, a.prm[L + i], 1, N);
      stage(sm + a.sm.wt[i], pitch_of(K), a.prm[2 * L + i], N, K);
      stage(sm + a.sm.bt[i], N, a.prm[3 * L + i], 1, N);
    }
    const int px = pitch_of(D);
    for (int e = tid; e < Rb * D; e += ONE_THREADS) {
      const int r = e / D, c = e % D;
      sm[a.sm.h[0] + r * px + c] = in.obs[(long long)(r0 + r) * in.obs_ld + c];
      sm[nx + r * px + c] = in.nobs[(long long)(r0 + r) * in.nobs_ld + c];
    }
    __syncthreads();

    // (1) the online net over obs, every layer's output kept for the backward
    for (int i = 0; i < L; ++i) {
      dense_rows(sm + hoff[i], pitch_of(dims[i]), sm + woff[i], pitch_of(dims[i]), sm + boff[i],
                 sm + hoff[i + 1], pitch_of(dims[i + 1]), Rb, dims[i + 1], dims[i], acts[i]);
      __syncthreads();
    }
    // (2) the online net over nobs (double-Q), then the target net over nobs
    for (int net = a.double_q ? 0 : 1; net < 2; ++net) {
      const int* w = net ? wtoff : woff;
      const int* b = net ? btoff : boff;
      const float* x = sm + nx;
      int pin = px;
      for (int i = 0; i < L; ++i) {
        float* y = sm + (i == L - 1 ? (net ? qt : qn) : ((i & 1) ? s1 : s0));
        const int py = pitch_of(dims[i + 1]);
        dense_rows(x, pin, sm + w[i], pitch_of(dims[i]), sm + b[i], y, py, Rb, dims[i + 1],
                   dims[i], acts[i]);
        __syncthreads();
        x = y;
        pin = py;
      }
    }

    // (3) TD rows: penalty, first-index argmax, y, err, dL/dq (into s0) and the
    // per-row terms of the metrics
    const int pa = pitch_of(A);
    const float* q = sm + hoff[L];
    const float* q_t = sm + qt;
    const float* sel_q = a.double_q ? sm + qn : q_t;
    for (int r = tid; r < Rb; r += ONE_THREADS) {
      const int m = r0 + r;
      const long long gr = (long long)m * A;
      const float rew = in.rows ? in.rows[m * in.rows_ld + in.rew_col] : in.rew[m];
      const float nt = in.rows ? 1.f - in.rows[m * in.rows_ld + in.term_col] : in.nt[m];
      int best = 0;
      float best_v = sel_q[r * pa] + penalty_at(in, gr, 0);
      for (int j = 1; j < A; ++j) {
        const float v = sel_q[r * pa + j] + penalty_at(in, gr, j);
        if (v > best_v) { best_v = v; best = j; }  // first index wins ties
      }
      const float y = rew + a.gamma * (q_t[r * pa + best] + penalty_at(in, gr, best)) * nt;
      float q_taken = 0.f, q_sum = 0.f;
      for (int j = 0; j < A; ++j) {
        q_taken += q[r * pa + j] * action_at(in, m, gr, j);
        q_sum += q[r * pa + j];
      }
      const float err = q_taken - y;
      const float gs = a.two_over_b * err;
      for (int j = 0; j < A; ++j) dz[r * pa + j] = gs * action_at(in, m, gr, j);
      sm[rowv + r] = err * err;
      sm[rowv + R + r] = q_sum;
      sm[rowv + 2 * R + r] = q_taken;
      sm[rowv + 3 * R + r] = rew;
    }
    __syncthreads();
    if (tid < 4) {
      float t = 0.f;
      for (int r = 0; r < Rb; ++r) t += sm[rowv + tid * R + r];
      ws[a.mg + g * 4 + tid] = t;
    }

    // (4) the backward over the block's rows, last layer first: each layer's
    // input and dz rows into the workspace for the weight gradient, and dz
    // through the OLD weights (still in shared memory) times act'
    for (int i = L - 1; i >= 0; --i) {
      const int N = dims[i + 1], K = dims[i];
      const int pz = pitch_of(N), ph = pitch_of(K);
      const float* hp = sm + hoff[i];
      const float* dzc = dz;
      for (int e = tid; e < Rb * N; e += ONE_THREADS)
        ws[a.dzg[i] + (long long)r0 * N + e] = dzc[(e / N) * pz + e % N];
      for (int e = tid; e < Rb * K; e += ONE_THREADS)
        ws[a.hg[i] + (long long)r0 * K + e] = hp[(e / K) * ph + e % K];
      if (i > 0) {
        const int act = acts[i - 1];
        float* dn = dz_next;
        product(dzc, pz, 1, sm + woff[i], pitch_of(K), 1, Rb, K, N,
                [=](int m, int n, float s) {
                  dn[m * ph + n] = s * act_grad_from_h(hp[m * ph + n], act);
                });
      }
      __syncthreads();
      float* t = dz; dz = dz_next; dz_next = t;
    }
  }  // rows

  // (5) after the barrier every block has read the old weights and written its
  // rows; the blocks share out tiles of each layer's [dW | db] (entry (n, j) =
  // sum over all B rows IN ORDER of dz[r, n] * [h | 1][r, j], the launch
  // sequence's order) and apply Adam and the polyak blend to their entries
  cooperative_groups::this_grid().sync();
  const float lr_t = *a.lr_t, eps_t = *a.eps_t;
  const AdamConsts c = a.ac;
  const int B = a.B, G = a.G;
  int first = 0;  // the layer's first tile in the numbering over all layers
  for (int i = 0; i < L; ++i) {
    const int N = dims[i + 1], K = dims[i];
    const int kb = tile_k_bits(K), TK = 1 << kb, TN = ONE_THREADS >> kb;
    const int ktiles = (K + 1 + TK - 1) / TK;
    const int tiles = layer_tiles(K, N);
    const int rc_max = min(B, a.smem_floats / (TN + TK));
    float* dz_s = sm;
    float* h_s = sm + rc_max * TN;
    const float* DZ = ws + a.dzg[i];
    const float* H = ws + a.hg[i];
    const int nn = tid >> kb, kk = tid & (TK - 1);
    for (int u = ((g - first) % G + G) % G; u < tiles; u += G) {
      const int n0 = (u / ktiles) * TN, k0 = (u % ktiles) * TK;
      const int n = n0 + nn, k = k0 + kk;
      float acc = 0.f;
      for (int c0 = 0; c0 < B; c0 += rc_max) {
        const int rc = min(rc_max, B - c0);
        __syncthreads();  // the previous chunk is used up
        fill(dz_s, rc * TN, [=](int e) {
          const int nj = n0 + (e & (TN - 1));
          return nj < N ? __ldcg(DZ + (long long)(c0 + e / TN) * N + nj) : 0.f;
        });
        fill(h_s, rc * TK, [=](int e) {
          const int kj = k0 + (e & (TK - 1));
          return kj < K ? __ldcg(H + (long long)(c0 + (e >> kb)) * K + kj)
                        : (kj == K ? 1.f : 0.f);
        });
        __syncthreads();
#pragma unroll 8
        for (int r = 0; r < rc; ++r) acc = fmaf(dz_s[r * TN + nn], h_s[r * TK + kk], acc);
      }
      if (n < N && k < K)
        adam_entry(a.prm[i], a.prm[2 * L + i], a.prm[4 * L + i], a.prm[6 * L + i],
                   (long long)n * K + k, acc, lr_t, eps_t, c);
      else if (n < N && k == K)
        adam_entry(a.prm[L + i], a.prm[3 * L + i], a.prm[5 * L + i], a.prm[7 * L + i], n, acc,
                   lr_t, eps_t, c);
    }
    first += tiles;
  }
  if (g == 0 && tid < 4) {
    float s = 0.f;
    for (int z = 0; z < a.G_rows; ++z) s += __ldcg(ws + a.mg + z * 4 + tid);
    const float denom = (tid == 1) ? (float)B * (float)A : (float)B;
    a.metrics[tid] = s / denom;
  }
}

// What the host knows of a device, read once.
struct OneDevice {
  int ready, sms, cooperative;
  size_t max_dynamic;  // dynamic shared memory a block of the kernel may take
};
constexpr int MAX_DEVICES = 64;
OneDevice one_devices[MAX_DEVICES];

struct OnePlan {
  int fits, R, G_rows, G, smem_floats;
  OneLayout sm;
};

cudaError_t one_device(OneDevice** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  OneDevice* d = &one_devices[dev];
  if (!d->ready) {
    int optin = 0;
    cudaFuncAttributes fa;
    if ((e = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (e = cudaDeviceGetAttribute(&d->cooperative, cudaDevAttrCooperativeLaunch, dev)) ||
        (e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (e = cudaFuncGetAttributes(&fa, (const void*)k2_one_launch_kernel)))
      return e;
    d->max_dynamic = (size_t)optin - fa.sharedSizeBytes;
    e = cudaFuncSetAttribute((const void*)k2_one_launch_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)d->max_dynamic);
    if (e != cudaSuccess) return e;
    d->ready = 1;
  }
  *out = d;
  return cudaSuccess;
}

// Whether K2 at these shapes runs as one launch on the current device, and
// how: R = 8 rows a block where the grid of ceil(B / 8) blocks can be
// co-resident, else as many rows as make it so, and as many more blocks as
// there are weight-gradient tiles (up to what the card holds at once).  The
// shapes and the device alone decide, before any launch.
cudaError_t plan_one_launch(int L, const int* dims, int B, OnePlan* plan) {
  plan->fits = 0;
  if (L < 1 || L > MAX_LAYERS || B < 1) return cudaSuccess;
  OneDevice* d = nullptr;
  cudaError_t e = one_device(&d);
  if (e != cudaSuccess) return e;
  if (!d->cooperative) return cudaSuccess;
  int tiles = 0;
  for (int i = 0; i < L; ++i) tiles += layer_tiles(dims[i], dims[i + 1]);
  int R = B < ONE_ROWS ? B : ONE_ROWS;
  for (int t = 0; t < ONE_PLAN_TRIES; ++t) {
    const long long floats = one_layout(L, dims, R, &plan->sm);
    if (floats * 4 > (long long)d->max_dynamic) return cudaSuccess;  // weights + rows too large
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k2_one_launch_kernel, ONE_THREADS,
                                                      (size_t)floats * 4);
    if (e != cudaSuccess) return e;
    const long long max_blocks = (long long)per_sm * d->sms;
    if (max_blocks < 1) return cudaSuccess;
    const int G = cdiv(B, R);
    if (G <= max_blocks) {
      plan->G_rows = G;
      plan->R = cdiv(B, G);  // the same G blocks, rows spread evenly
      plan->smem_floats = (int)one_layout(L, dims, plan->R, &plan->sm);
      plan->G = (int)(tiles < max_blocks ? (tiles > G ? tiles : G) : max_blocks);
      plan->fits = 1;
      return cudaSuccess;
    }
    R = cdiv(B, max_blocks);
  }
  return cudaSuccess;
}

// The one-launch workspace: every layer's input and dz over the batch, then
// the row blocks' metric sums; returns its size in floats.
long long one_workspace(int L, const int* dims, int B, int G_rows, OneArgs* a) {
  long long off = 0;
  for (int i = 0; i < L; ++i) {
    a->hg[i] = off;
    off += ((long long)B * dims[i] + 3) / 4 * 4;
    a->dzg[i] = off;
    off += ((long long)B * dims[i + 1] + 3) / 4 * 4;
  }
  a->mg = off;
  return off + 4LL * G_rows;
}

// K2: one launch where the shapes allow it, else run_update's sequence.
int k2_update(int L, const int* dims, const int* acts, int B, int double_q, const float* consts,
              void* const* params, const BatchIn& in, const float* lr_t, const float* eps_t,
              float* metrics, float* ws, int* n_launches, cudaStream_t st) {
  *n_launches = 0;
  OnePlan plan;
  cudaError_t e = plan_one_launch(L, dims, B, &plan);
  if (e != cudaSuccess) return (int)e;
  if (!plan.fits)
    return run_update(L, dims, acts, B, double_q, consts, params, in, lr_t, eps_t, metrics, ws,
                      n_launches, st, 0, Precision{0, 0});
  OneArgs a{};
  a.L = L; a.B = B; a.R = plan.R; a.double_q = double_q;
  a.G_rows = plan.G_rows; a.G = plan.G; a.smem_floats = plan.smem_floats;
  for (int i = 0; i <= L; ++i) a.dims[i] = dims[i];
  for (int i = 0; i < L; ++i) a.acts[i] = acts[i];
  one_workspace(L, dims, B, plan.G_rows, &a);
  for (int i = 0; i < 8 * L; ++i) a.prm[i] = static_cast<float*>(params[i]);
  a.in = in;
  a.lr_t = lr_t;
  a.eps_t = eps_t;
  a.metrics = metrics;
  a.ws = ws;
  a.gamma = consts[0];
  a.ac = AdamConsts{consts[1], consts[2], consts[3], consts[4], consts[5], consts[6]};
  a.two_over_b = consts[7];
  a.sm = plan.sm;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)k2_one_launch_kernel, dim3(plan.G),
                                  dim3(ONE_THREADS), args, (size_t)plan.smem_floats * 4, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *n_launches = 1;
  return 0;
}

}  // namespace

extern "C" {

// Workspace size (in floats) the wrapper allocates for one update.
long long fused_dqn_workspace_floats(int L, const int* dims, int B, int offline,
                                     int save_bf16) {
  if (!offline && !save_bf16) {
    // K2 in one launch.  A device query that fails here fails again, and is
    // reported, in the update.
    OnePlan plan;
    OneArgs a;
    if (plan_one_launch(L, dims, B, &plan) == cudaSuccess && plan.fits)
      return one_workspace(L, dims, B, plan.G_rows, &a);
  }
  Layout lay;
  if (!make_layout(L, dims, B, offline, save_bf16, &lay)) return -1;
  return lay.total;
}

const char* fused_dqn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K2: one launch where the shapes allow it (k2_update), else the launch
// sequence with the whole batch as one split-K chunk.
int fused_dqn_update(int L, const int* dims, const int* acts, int B,
                     int double_q, const float* consts, void* const* params,
                     const void* obs, const void* nobs, const void* act,
                     const void* rew, const void* nt, const void* mask,
                     const void* lr_t, const void* eps_t, void* metrics,
                     void* workspace, int* n_launches, void* stream) {
  const BatchIn in = tensor_batch(dims[0], obs, nobs, act, rew, nt, mask);
  return k2_update(L, dims, acts, B, double_q, consts, params, in, (const float*)lr_t,
                   (const float*)eps_t, (float*)metrics, (float*)workspace, n_launches,
                   (cudaStream_t)stream);
}

// K2, packed interface: rows and next_rows are [B, row_width] raw replay
// rows; cols = (obs_col, act_col, rew_col, term_col).
int fused_dqn_update_packed(int L, const int* dims, const int* acts, int B,
                            int double_q, const float* consts,
                            void* const* params, const void* rows,
                            const void* next_rows, int row_width,
                            const int* cols, const void* lr_t,
                            const void* eps_t, void* metrics, void* workspace,
                            int* n_launches, void* stream) {
  const float* r = (const float*)rows;
  BatchIn in{};
  in.obs = r + cols[0];
  in.nobs = (const float*)next_rows + cols[0];
  in.obs_ld = in.nobs_ld = row_width;
  in.rows = r;
  in.rows_ld = row_width;
  in.act_col = cols[1];
  in.rew_col = cols[2];
  in.term_col = cols[3];
  return k2_update(L, dims, acts, B, double_q, consts, params, in, (const float*)lr_t,
                   (const float*)eps_t, (float*)metrics, (float*)workspace, n_launches,
                   (cudaStream_t)stream);
}

// K1: 256-row split-K chunks, reduced in fixed order by the Adam kernel.
int fused_dqn_offline_update(int L, const int* dims, const int* acts, int B,
                             int double_q, const float* consts,
                             void* const* params, const void* obs,
                             const void* nobs, const void* act, const void* rew,
                             const void* nt, const void* mask, const void* lr_t,
                             const void* eps_t, void* metrics, void* workspace,
                             int* n_launches, void* stream) {
  const BatchIn in = tensor_batch(dims[0], obs, nobs, act, rew, nt, mask);
  return run_update(L, dims, acts, B, double_q, consts, params, in,
                    (const float*)lr_t, (const float*)eps_t, (float*)metrics,
                    (float*)workspace, n_launches, (cudaStream_t)stream, 1, Precision{0, 0});
}

// K1 with its matmul_dtype / save_dtype options: matmul_bf16 puts every
// product on the tensor cores (operands rounded to bf16, f32 accumulation),
// save_bf16 keeps the saved activations in bf16.  (0, 0) is the entry above.
int fused_dqn_offline_update_bf16(int L, const int* dims, const int* acts, int B,
                                  int double_q, int matmul_bf16, int save_bf16,
                                  const float* consts, void* const* params,
                                  const void* obs, const void* nobs, const void* act,
                                  const void* rew, const void* nt, const void* mask,
                                  const void* lr_t, const void* eps_t, void* metrics,
                                  void* workspace, int* n_launches, void* stream) {
  const BatchIn in = tensor_batch(dims[0], obs, nobs, act, rew, nt, mask);
  return run_update(L, dims, acts, B, double_q, consts, params, in,
                    (const float*)lr_t, (const float*)eps_t, (float*)metrics,
                    (float*)workspace, n_launches, (cudaStream_t)stream, 1,
                    Precision{matmul_bf16 != 0, save_bf16 != 0});
}

}  // extern "C"
