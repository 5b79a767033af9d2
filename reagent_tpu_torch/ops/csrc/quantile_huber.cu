// Pairwise quantile-Huber loss (QR-DQN) for Hopper (sm_90a): the loss, its
// gradient sums in the same pass, and the gradient's scaling; f32 or bf16
// inputs, f32 arithmetic.
//
// Replaces the TPU kernel reagent_tpu/ops/quantile_huber.py::quantile_huber_loss
// (its pallas_call at :77, kernel body :58-74).  For each sample b, with
// td_ij = target_i - current_j, tau_j = (j + 0.5) / N, w_ij = |tau_j - 1{td_ij < 0}|
// and Huber_k(x) = 0.5 x^2 if |x| < k else k (|x| - 0.5 k):
//
//   per_sample[b]  = (1/N^2) sum_i sum_j w_ij Huber_k(td_ij)
//   sums[b, j]     = sum_i w_ij clip(td_ij, -k, k)
//   d per_sample[b] / d current[b, j] = -sums[b, j] / N^2
//
// (the weight is a constant of the gradient; the target gets none).  The
// caller takes the mean over b.  The [B, N, N] tensor is never formed.  The
// TPU kernel has no backward: XLA differentiates the plain formulation.
//
// Two routes, one kernel template (quantile_huber_kernel<T, J, SUMS>):
//   - loss only (SUMS = false; quantile_huber_forward): per_sample alone,
//     for callers that take no gradient;
//   - loss and gradient sums (SUMS = true; quantile_huber_forward_sums):
//     the same pairs also give sums[b, j], written as a float32 [B, N]
//     buffer that the autograd function saves in place of the inputs.  The
//     backward is then quantile_huber_scale_kernel: grad[b, j] =
//     (-grad_per_sample[b] / N^2) * sums[b, j] in the inputs' type.
//
// Layout: one warp per sample, WARPS samples per block.  The warp stages its
// target row in shared memory (cast to f32, pitch a multiple of 4 floats).
// Lane l holds its current atoms j = l, l + 32, ... in registers, J of them
// at a time (J = ceil(N / 32) up to 8; past 256 atoms the lane walks its
// atoms a block of 8 at a time), and walks the target row once per block:
// each 16-byte shared load brings four targets (the same address in every
// lane, a broadcast), and each target serves the lane's J atoms, J
// independent chains of sums.
//
// Bound: issued instructions.  The function's least count a pair is 7 on
// the loss-only route and 8 with the gradient sums, each one lane's issue
// slot at 132 SMs x 128 lanes a cycle (chip_smoke.py's K5_LOSS_INSTR,
// K5_SUMS_INSTR): sub; m = min(|td|, k); the Huber value m (|td| - 0.5 m) as
// an fma and a mul; the sign compare; the weight select; the fma into the
// loss sum; with the sums one more fma, m times the signed weight.  This
// kernel issues exactly those in its hot loop (cuobjdump -sass, at J = 7:
// 8.5 a pair with the sums, 7.2 without, the rest a recomputed tau - 1 per
// atom and target load, the 16-byte shared load and the loop step).  The
// design it replaces walked the pairs twice, once for the loss (11.3 a
// pair) and once for the gradient (7.3 a pair), each with its own sub,
// compare, select, load and loop step.  Bytes are few: 8 per N pairs read,
// the [B, N] sums written.  The scaling kernel is bound by bytes (sums read,
// gradient written).
//
// Every sum keeps the order of the design it replaces, so results are bit
// for bit the same: sums[b, j] and the per-atom loss sum run over i = 0 ..
// N-1 in order; the lane adds its atoms' loss sums in the order j = l, l +
// 32, ...; the lanes are then summed by the same __shfl_down_sync tree.  No
// atomics.  The per-pair rewrite is exact in IEEE float32: fma(-0.5, m, |td|)
// is 0.5 |td| (|td| < k) or |td| - 0.5 k (|td| >= k) rounded once, as the
// replaced design's 0.5f * td and a - half_kappa were, and m times it is its
// product (round to nearest is symmetric in sign); m sw is its clip(td, -k,
// k) w.  Only where td is NaN (a NaN input, whose loss is NaN either way)
// does the sum take +k tau where the replaced design took -k tau.  The fmas
// are written as intrinsics so that the contraction is the one nvcc gave the
// replaced design's `acc_j += huber * w` and `g += d * w`.  Comparisons are
// strict as in the plain version: td == 0 takes the quadratic branch and a
// zero gradient.  Rows past B and atoms past N are guarded; rows may be
// strided (the atom stride is 1).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, bound with ctypes; returns cudaGetLastError() (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // samples per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ATOMS = 1536;  // WARPS target rows of f32 within 48 KB
constexpr int MAX_J = 8;         // atoms a lane holds in registers at once

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// floats: each warp's target row starts on 16 bytes
__host__ __device__ inline int row_pitch(int N) { return (N + 3) & ~3; }

// One target atom against the lane's J current atoms.  With m = min(|td|, k),
// Huber_k(td) = m (|td| - 0.5 m) and clip(td, -k, k) w = m sw, where sw =
// sign(td) w is the weight with td's sign: one select gives the loss's weight
// (|sw|, an operand modifier of the fma) and the gradient's signed one.
template <int J, bool SUMS>
__device__ __forceinline__ void pairs(float ti, const float (&c)[J], const float (&tau)[J],
                                      const float (&w_neg)[J], float kappa,
                                      float (&acc_j)[J], float (&g)[J]) {
#pragma unroll
  for (int k = 0; k < J; ++k) {
    const float td = ti - c[k];
    const float a = fabsf(td);
    const float m = fminf(a, kappa);
    const float huber = m * __fmaf_rn(-0.5f, m, a);
    if (SUMS) {
      const float sw = td < 0.f ? -w_neg[k] : tau[k];
      acc_j[k] = __fmaf_rn(huber, fabsf(sw), acc_j[k]);
      g[k] = __fmaf_rn(m, sw, g[k]);
    } else {
      acc_j[k] = __fmaf_rn(huber, td < 0.f ? w_neg[k] : tau[k], acc_j[k]);
    }
  }
}

template <typename T, int J, bool SUMS>
__global__ void __launch_bounds__(THREADS)
quantile_huber_kernel(const T* __restrict__ target, long long t_stride,
                      const T* __restrict__ current, long long c_stride, int B,
                      int N, float kappa, float* __restrict__ per_sample,
                      float* __restrict__ sums) {
  extern __shared__ __align__(16) float smem[];  // [WARPS, pitch] target rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // the whole warp leaves; nothing below syncs the block
  float* t = smem + warp * row_pitch(N);
  const T* trow = target + (long long)b * t_stride;
  for (int i = lane; i < N; i += 32) t[i] = to_float(trow[i]);
  __syncwarp();
  const T* crow = current + (long long)b * c_stride;
  const float4* t4 = reinterpret_cast<const float4*>(t);
  const int n4 = N >> 2;
  float acc = 0.f;
  for (int j0 = 0; j0 < N; j0 += 32 * J) {
    float c[J], tau[J], w_neg[J], acc_j[J], g[J];
#pragma unroll
    for (int k = 0; k < J; ++k) {
      const int j = j0 + lane + 32 * k;
      c[k] = j < N ? to_float(crow[j]) : 0.f;
      tau[k] = ((float)j + 0.5f) / (float)N;
      w_neg[k] = fabsf(tau[k] - 1.f);  // |tau - 1{td < 0}| for td < 0
      acc_j[k] = 0.f;
      g[k] = 0.f;
    }
    for (int i4 = 0; i4 < n4; ++i4) {
      const float4 v = t4[i4];
      pairs<J, SUMS>(v.x, c, tau, w_neg, kappa, acc_j, g);
      pairs<J, SUMS>(v.y, c, tau, w_neg, kappa, acc_j, g);
      pairs<J, SUMS>(v.z, c, tau, w_neg, kappa, acc_j, g);
      pairs<J, SUMS>(v.w, c, tau, w_neg, kappa, acc_j, g);
    }
    for (int i = n4 * 4; i < N; ++i) pairs<J, SUMS>(t[i], c, tau, w_neg, kappa, acc_j, g);
#pragma unroll
    for (int k = 0; k < J; ++k) {
      const int j = j0 + lane + 32 * k;
      if (j < N) {
        acc += acc_j[k];
        if (SUMS) sums[(long long)b * N + j] = g[k];
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) per_sample[b] = acc / (float)(N * N);
}

// grad[b, j] = (-grad_per_sample[b] / N^2) * sums[b, j]: one warp per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantile_huber_scale_kernel(const float* __restrict__ sums, int B, int N,
                            const float* __restrict__ grad_per_sample,
                            long long g_stride, T* __restrict__ grad_current) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  const float scale = -grad_per_sample[(long long)b * g_stride] / (float)(N * N);
  const long long row = (long long)b * N;
  for (int j = lane; j < N; j += 32) from_float(scale * sums[row + j], grad_current + row + j);
}

inline bool bad_shape(int B, int N) { return B < 1 || N < 1 || N > MAX_ATOMS; }

template <typename T, bool SUMS, int J>
void launch_j(const void* target, long long t_stride, const void* current,
              long long c_stride, int B, int N, float kappa, void* per_sample,
              void* sums, cudaStream_t stream) {
  const int grid = (B + WARPS - 1) / WARPS;
  const size_t smem = (size_t)WARPS * row_pitch(N) * sizeof(float);
  quantile_huber_kernel<T, J, SUMS><<<grid, THREADS, smem, stream>>>(
      (const T*)target, t_stride, (const T*)current, c_stride, B, N, kappa,
      (float*)per_sample, (float*)sums);
}

template <typename T, bool SUMS>
void launch(const void* target, long long t_stride, const void* current,
            long long c_stride, int B, int N, float kappa, void* per_sample,
            void* sums, cudaStream_t stream) {
  // J atoms per lane: every atom in one walk up to 256 atoms, else blocks of 8
  const int J = N > 32 * MAX_J ? MAX_J : (N + 31) / 32;
  decltype(&launch_j<T, SUMS, 1>) fn = nullptr;
  switch (J) {
    case 1: fn = launch_j<T, SUMS, 1>; break;
    case 2: fn = launch_j<T, SUMS, 2>; break;
    case 3: fn = launch_j<T, SUMS, 3>; break;
    case 4: fn = launch_j<T, SUMS, 4>; break;
    case 5: fn = launch_j<T, SUMS, 5>; break;
    case 6: fn = launch_j<T, SUMS, 6>; break;
    case 7: fn = launch_j<T, SUMS, 7>; break;
    default: fn = launch_j<T, SUMS, 8>; break;
  }
  fn(target, t_stride, current, c_stride, B, N, kappa, per_sample, sums, stream);
}

template <bool SUMS>
int forward(const void* target, long long t_stride, const void* current,
            long long c_stride, int bf16, int B, int N, float kappa,
            void* per_sample, void* sums, void* stream) {
  if (bad_shape(B, N)) return (int)cudaErrorInvalidValue;
  if (bf16)
    launch<__nv_bfloat16, SUMS>(target, t_stride, current, c_stride, B, N, kappa,
                                per_sample, sums, (cudaStream_t)stream);
  else
    launch<float, SUMS>(target, t_stride, current, c_stride, B, N, kappa,
                        per_sample, sums, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* quantile_huber_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int quantile_huber_max_atoms() { return MAX_ATOMS; }

// The loss-only route.  target, current: [B, N] with row strides (in
// elements) and atom stride 1; bf16 != 0 selects __nv_bfloat16 for both,
// else f32.  per_sample: [B] f32.
int quantile_huber_forward(const void* target, long long t_stride,
                           const void* current, long long c_stride, int bf16,
                           int B, int N, float kappa, void* per_sample,
                           void* stream) {
  return forward<false>(target, t_stride, current, c_stride, bf16, B, N, kappa,
                        per_sample, nullptr, stream);
}

// The gradient route: the loss as above and sums [B, N] f32 contiguous.
int quantile_huber_forward_sums(const void* target, long long t_stride,
                                const void* current, long long c_stride, int bf16,
                                int B, int N, float kappa, void* per_sample,
                                void* sums, void* stream) {
  return forward<true>(target, t_stride, current, c_stride, bf16, B, N, kappa,
                       per_sample, sums, stream);
}

// The backward from the saved sums: sums [B, N] f32 contiguous;
// grad_per_sample [B] f32 with stride g_stride (0 for a broadcast scalar);
// grad_current [B, N] contiguous, bf16 != 0 selects __nv_bfloat16, else f32.
int quantile_huber_scale(const void* sums, int bf16, int B, int N,
                         const void* grad_per_sample, long long g_stride,
                         void* grad_current, void* stream) {
  if (bad_shape(B, N)) return (int)cudaErrorInvalidValue;
  const int grid = (B + WARPS - 1) / WARPS;
  if (bf16)
    quantile_huber_scale_kernel<__nv_bfloat16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)sums, B, N, (const float*)grad_per_sample, g_stride,
        (__nv_bfloat16*)grad_current);
  else
    quantile_huber_scale_kernel<float><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)sums, B, N, (const float*)grad_per_sample, g_stride,
        (float*)grad_current);
  return (int)cudaGetLastError();
}

}  // extern "C"
