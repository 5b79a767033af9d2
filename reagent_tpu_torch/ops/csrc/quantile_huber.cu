// Pairwise quantile-Huber loss (QR-DQN) for Hopper (sm_90a): forward and
// gradient, f32 or bf16 inputs, f32 arithmetic.
//
// Replaces the TPU kernel reagent_tpu/ops/quantile_huber.py::quantile_huber_loss
// (its pallas_call at :77).  For each sample b, with td_ij = target_i - current_j,
// tau_j = (j + 0.5) / N and Huber_k(x) = 0.5 x^2 if |x| < k else k (|x| - 0.5 k):
//
//   per_sample[b]      =  (1/N^2) sum_i sum_j |tau_j - 1{td_ij < 0}| Huber_k(td_ij)
//   d per_sample[b] /
//     d current[b, j]  = -(1/N^2) sum_i |tau_j - 1{td_ij < 0}| clip(td_ij, -k, k)
//
// (the weight is a constant of the gradient; the target gets none).  The
// caller takes the mean over b.  The [B, N, N] tensor is never formed.
//
// One warp per sample, WARPS samples per block.  The warp stages its target
// row in shared memory (cast to f32); lane l owns the current atoms j = l,
// l + 32, ... (each read once into a register) and walks all target atoms,
// which every lane reads from the same shared address (a broadcast).  The
// forward then sums the lanes' partial sums with shuffles in a fixed order,
// so results repeat bit for bit: no atomics.  The backward needs no
// reduction: lane l writes its own grad_current[b, j], scaled by the incoming
// grad_per_sample[b].  Comparisons are strict (|td| < k, td < 0), as in the
// plain version, so td == 0 and |td| == k take the same branch in both and
// the gradient at td == 0 is 0.  Rows past B and atoms past N are guarded;
// rows may be strided (the atom stride is 1).
//
// Bound: operations.  Per (i, j) pair the forward does 12 f32 operations
// (sub, abs, 2 mul for 0.5 td^2, sub and mul for k (|td| - 0.5 k), compare
// and select of the branch, compare and select of the weight, multiply-add
// into the sum) and the backward 7 (sub, min, max, compare and select,
// multiply-add), against 8 bytes of input per N pairs.
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// Stage sample b's target row into this warp's shared row; returns it.
template <typename T>
__device__ __forceinline__ const float* stage_target(
    float* smem, const T* __restrict__ target, long long t_stride, int b, int N,
    int warp, int lane) {
  float* t = smem + warp * N;
  const T* row = target + (long long)b * t_stride;
  for (int i = lane; i < N; i += 32) t[i] = to_float(row[i]);
  __syncwarp();
  return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantile_huber_forward_kernel(const T* __restrict__ target, long long t_stride,
                              const T* __restrict__ current, long long c_stride,
                              int B, int N, float kappa,
                              float* __restrict__ per_sample) {
  extern __shared__ float smem[];  // [WARPS, N] target rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // the whole warp leaves; nothing below syncs the block
  const float* t = stage_target(smem, target, t_stride, b, N, warp, lane);
  const T* crow = current + (long long)b * c_stride;
  const float half_kappa = 0.5f * kappa;
  float acc = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float c = to_float(crow[j]);
    const float tau = ((float)j + 0.5f) / (float)N;
    const float w_neg = fabsf(tau - 1.f);  // |tau - 1{td < 0}| for td < 0
    float acc_j = 0.f;
    for (int i = 0; i < N; ++i) {
      const float td = t[i] - c;
      const float a = fabsf(td);
      const float huber = a < kappa ? 0.5f * td * td : kappa * (a - half_kappa);
      acc_j += huber * (td < 0.f ? w_neg : tau);
    }
    acc += acc_j;
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) per_sample[b] = acc / (float)(N * N);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantile_huber_backward_kernel(const T* __restrict__ target, long long t_stride,
                               const T* __restrict__ current, long long c_stride,
                               int B, int N, float kappa,
                               const float* __restrict__ grad_per_sample,
                               long long g_stride, T* __restrict__ grad_current) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  const float* t = stage_target(smem, target, t_stride, b, N, warp, lane);
  const T* crow = current + (long long)b * c_stride;
  const float scale = -grad_per_sample[(long long)b * g_stride] / (float)(N * N);
  for (int j = lane; j < N; j += 32) {
    const float c = to_float(crow[j]);
    const float tau = ((float)j + 0.5f) / (float)N;
    const float w_neg = fabsf(tau - 1.f);
    float g = 0.f;
    for (int i = 0; i < N; ++i) {
      const float td = t[i] - c;
      // Huber's derivative: td inside kappa, kappa * sign(td) outside, 0 at 0
      const float d = fminf(fmaxf(td, -kappa), kappa);
      g += d * (td < 0.f ? w_neg : tau);
    }
    from_float(scale * g, grad_current + (long long)b * N + j);
  }
}

inline bool bad_shape(int B, int N) { return B < 1 || N < 1 || N > MAX_ATOMS; }

}  // namespace

extern "C" {

const char* quantile_huber_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int quantile_huber_max_atoms() { return MAX_ATOMS; }

// target, current: [B, N] with row strides (in elements) and atom stride 1;
// bf16 != 0 selects __nv_bfloat16 for both, else f32.  per_sample: [B] f32.
int quantile_huber_forward(const void* target, long long t_stride,
                           const void* current, long long c_stride, int bf16,
                           int B, int N, float kappa, void* per_sample,
                           void* stream) {
  if (bad_shape(B, N)) return (int)cudaErrorInvalidValue;
  const int grid = (B + WARPS - 1) / WARPS;
  const size_t smem = (size_t)WARPS * N * sizeof(float);
  if (bf16)
    quantile_huber_forward_kernel<__nv_bfloat16>
        <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)target, t_stride, (const __nv_bfloat16*)current,
            c_stride, B, N, kappa, (float*)per_sample);
  else
    quantile_huber_forward_kernel<float>
        <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const float*)target, t_stride, (const float*)current, c_stride, B,
            N, kappa, (float*)per_sample);
  return (int)cudaGetLastError();
}

// grad_per_sample: [B] f32 with stride g_stride (0 for a broadcast scalar);
// grad_current: [B, N] contiguous, in the inputs' type.
int quantile_huber_backward(const void* target, long long t_stride,
                            const void* current, long long c_stride, int bf16,
                            int B, int N, float kappa,
                            const void* grad_per_sample, long long g_stride,
                            void* grad_current, void* stream) {
  if (bad_shape(B, N)) return (int)cudaErrorInvalidValue;
  const int grid = (B + WARPS - 1) / WARPS;
  const size_t smem = (size_t)WARPS * N * sizeof(float);
  if (bf16)
    quantile_huber_backward_kernel<__nv_bfloat16>
        <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const __nv_bfloat16*)target, t_stride, (const __nv_bfloat16*)current,
            c_stride, B, N, kappa, (const float*)grad_per_sample, g_stride,
            (__nv_bfloat16*)grad_current);
  else
    quantile_huber_backward_kernel<float>
        <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const float*)target, t_stride, (const float*)current, c_stride, B,
            N, kappa, (const float*)grad_per_sample, g_stride,
            (float*)grad_current);
  return (int)cudaGetLastError();
}

}  // extern "C"
