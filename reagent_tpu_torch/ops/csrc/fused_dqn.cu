// Fused DQN update for Hopper (sm_90a), f32 throughout.
//
// Replaces the two TPU kernels that each run a whole DQN training step:
//   K1  reagent_tpu/ops/fused_dqn_offline.py::make_fused_dqn_offline_kernel
//       -> C entry fused_dqn_offline_update (batch split into 256-row chunks)
//   K2  reagent_tpu/ops/fused_dqn.py::make_fused_dqn_train_kernel
//       tensor interface -> C entry fused_dqn_update (whole batch as one
//       chunk); packed interface (packed=, :164-176) -> C entry
//       fused_dqn_update_packed, which reads raw PackedReplayBuffer rows in
//       place: the observation GEMMs take the rows' stride, and the TD-row
//       kernel reads the action, reward and terminal columns, builds the
//       one-hot as |a - j| < 0.5 and sets nt = 1 - terminal (no mask).
//
// One update is a fixed sequence of launches on the caller's stream:
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
// No atomics anywhere: the result repeats bit for bit from run to run.
//
// Bound: f32 operations (about 5 * B * sum(in*out) multiply-adds, no tensor
// cores at this precision) against a few MB of traffic.  This first design
// is a plain 64x64x16 tile with a 4x4 register block per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, bound with ctypes; every entry returns cudaGetLastError()
// after each launch (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int GEMM_THREADS = 256;
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

// C[m, n] = sum_k A(m, k) * B(k, n) over k in this block's split-K chunk,
// with A(m, k) = A[m*sam + k*sak] and B(k, n) = B[k*sbk + n*sbn].
// ones_col: column N-1 of B is a virtual column of ones (gives the bias
// gradient beside the weight gradient).
// Epilogues: EPI_BIAS_ACT  C[m,n] = act(acc + aux[n])
//            EPI_ACT_GRAD  C[m,n] = acc * act'(aux[m,n])   (aux = saved h)
//            EPI_SPLITK    C[z, m, n] = acc                 (z = chunk)
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const float* __restrict__ A, long long sam, long long sak,
            const float* __restrict__ Bm, long long sbk, long long sbn,
            int ones_col, float* __restrict__ C, int M, int N, int K,
            int kchunk, const float* __restrict__ aux, int act) {
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
      As[kk][mm] = (gm < M && gk < kend) ? A[gm * sam + gk * sak] : 0.f;
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
        v = (ones_col && gn == N - 1) ? 1.f : Bm[gk * sbk + gn * sbn];
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i;
      const int n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      const long long o = (long long)m * N + n;
      if (EPI == EPI_BIAS_ACT) {
        C[o] = act_fwd(acc[i][j] + aux[n], act);
      } else if (EPI == EPI_ACT_GRAD) {
        C[o] = acc[i][j] * act_grad_from_h(aux[o], act);
      } else {
        C[(long long)blockIdx.z * M * N + o] = acc[i][j];
      }
    }
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

struct Layout {
  // float offsets into the workspace
  long long h[17];   // saved online outputs over obs, layers 1..L (h[L] = q)
  long long tmp0, tmp1, qn, qt, dz0, dz1, grad, partials, total;
  int nchunks, chunk_rows, maxw, nrowblocks;
};

constexpr int MAX_LAYERS = 16;

bool make_layout(int L, const int* dims, int B, int offline, Layout* lay) {
  if (L < 1 || L > MAX_LAYERS || B < 1) return false;
  lay->chunk_rows = offline ? OFFLINE_CHUNK_ROWS : B;
  lay->nchunks = cdiv(B, lay->chunk_rows);
  lay->nrowblocks = cdiv(B, ROW_THREADS);
  int maxw = 0;
  for (int i = 0; i <= L; ++i) maxw = dims[i] > maxw ? dims[i] : maxw;
  lay->maxw = maxw;
  long long off = 0;
  lay->h[0] = -1;  // obs itself
  for (int i = 1; i <= L; ++i) { lay->h[i] = off; off += (long long)B * dims[i]; }
  const int A = dims[L];
  lay->tmp0 = off; off += (long long)B * maxw;
  lay->tmp1 = off; off += (long long)B * maxw;
  lay->qn = off; off += (long long)B * A;
  lay->qt = off; off += (long long)B * A;
  lay->dz0 = off; off += (long long)B * maxw;
  lay->dz1 = off; off += (long long)B * maxw;
  long long g = 0;
  for (int i = 0; i < L; ++i) {
    const long long s = (long long)lay->nchunks * dims[i + 1] * (dims[i] + 1);
    g = s > g ? s : g;
  }
  lay->grad = off; off += g;
  lay->partials = off; off += (long long)lay->nrowblocks * 4;
  lay->total = off;
  return true;
}

template <int EPI>
cudaError_t gemm(cudaStream_t st, const float* A, long long sam, long long sak,
                 const float* Bm, long long sbk, long long sbn, int ones_col,
                 float* C, int M, int N, int K, int kchunk, int nchunks,
                 const float* aux, int act) {
  dim3 grid(cdiv(N, TN), cdiv(M, TM), nchunks);
  gemm_kernel<EPI><<<grid, GEMM_THREADS, 0, st>>>(
      A, sam, sak, Bm, sbk, sbn, ones_col, C, M, N, K, kchunk, aux, act);
  return cudaGetLastError();
}

#define CHECK(expr)                          \
  do {                                       \
    cudaError_t e_ = (expr);                 \
    if (e_ != cudaSuccess) return (int)e_;   \
    ++*n_launches;                           \
  } while (0)

// Forward x [B, dims[0]] (row stride x_ld) through L layers; layer i
// writes outs[i] (contiguous).
int forward(cudaStream_t st, const float* x, long long x_ld, float* const* Ws,
            float* const* bs, const int* dims, const int* acts, int L, int B,
            float* const* outs, int* n_launches) {
  const float* in = x;
  long long ld = x_ld;
  for (int i = 0; i < L; ++i) {
    const int K = dims[i], N = dims[i + 1];
    CHECK(gemm<EPI_BIAS_ACT>(st, in, ld, 1, Ws[i], 1, K, 0, outs[i], B, N, K, K,
                             1, bs[i], acts[i]));
    in = outs[i];
    ld = N;
  }
  return 0;
}

int run_update(int L, const int* dims, const int* acts, int B, int double_q,
               const float* consts, void* const* params, const BatchIn& in,
               const float* lr_t, const float* eps_t, float* metrics, float* ws,
               int* n_launches, cudaStream_t st, int offline) {
  *n_launches = 0;
  Layout lay;
  if (!make_layout(L, dims, B, offline, &lay)) return (int)cudaErrorInvalidValue;
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

  // (a) forwards
  float* hs[MAX_LAYERS];
  for (int i = 0; i < L; ++i) hs[i] = ws + lay.h[i + 1];
  int e = forward(st, in.obs, in.obs_ld, W, b, dims, acts, L, B, hs, n_launches);
  if (e) return e;
  float* tmp[MAX_LAYERS];
  for (int i = 0; i < L; ++i) tmp[i] = ws + ((i % 2) ? lay.tmp1 : lay.tmp0);
  if (double_q) {
    tmp[L - 1] = ws + lay.qn;
    e = forward(st, in.nobs, in.nobs_ld, W, b, dims, acts, L, B, tmp, n_launches);
    if (e) return e;
  }
  tmp[L - 1] = ws + lay.qt;
  e = forward(st, in.nobs, in.nobs_ld, Wt, bt, dims, acts, L, B, tmp, n_launches);
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
    const float* h_prev = i == 0 ? in.obs : ws + lay.h[i];
    const long long h_ld = i == 0 ? in.obs_ld : fan_in;
    // [dW | db][n, j] = sum_m dz[m, n] * [h_prev | 1][m, j]
    CHECK(gemm<EPI_SPLITK>(st, dz, 1, out, h_prev, h_ld, 1, 1, grad, out,
                           fan_in + 1, B, lay.chunk_rows, lay.nchunks, nullptr, 0));
    if (i > 0) {
      // dz_prev[m, j] = (sum_n dz[m, n] * W[n, j]) * act'(h_prev[m, j])
      CHECK(gemm<EPI_ACT_GRAD>(st, dz, out, 1, W[i], fan_in, 1, 0, dz_next, B,
                               fan_in, out, out, 1, h_prev, acts[i - 1]));
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

}  // namespace

extern "C" {

// Workspace size (in floats) the wrapper allocates for one update.
long long fused_dqn_workspace_floats(int L, const int* dims, int B, int offline) {
  Layout lay;
  if (!make_layout(L, dims, B, offline, &lay)) return -1;
  return lay.total;
}

const char* fused_dqn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K2: the whole batch is one split-K chunk.
int fused_dqn_update(int L, const int* dims, const int* acts, int B,
                     int double_q, const float* consts, void* const* params,
                     const void* obs, const void* nobs, const void* act,
                     const void* rew, const void* nt, const void* mask,
                     const void* lr_t, const void* eps_t, void* metrics,
                     void* workspace, int* n_launches, void* stream) {
  const BatchIn in = tensor_batch(dims[0], obs, nobs, act, rew, nt, mask);
  return run_update(L, dims, acts, B, double_q, consts, params, in,
                    (const float*)lr_t, (const float*)eps_t, (float*)metrics,
                    (float*)workspace, n_launches, (cudaStream_t)stream, 0);
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
  return run_update(L, dims, acts, B, double_q, consts, params, in,
                    (const float*)lr_t, (const float*)eps_t, (float*)metrics,
                    (float*)workspace, n_launches, (cudaStream_t)stream, 0);
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
                    (float*)workspace, n_launches, (cudaStream_t)stream, 1);
}

}  // extern "C"
