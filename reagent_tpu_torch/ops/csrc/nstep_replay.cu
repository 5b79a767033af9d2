// n-step replay rewards for Hopper (sm_90a).
//
// Replaces the TPU kernel reagent_tpu/ops/nstep_replay.py::nstep_rewards
// (its pallas_call at :92), which ReplayBuffer.sample computes inline at
// reagent_tpu/replay/circular.py:310-324 and :343-344.  For each sampled
// start index i, over the window w_k = (i + k) mod capacity, k < H:
//   steps    = 1 + the first k whose terminal is set, else H (the horizon cap
//              counts as the last step);
//   reward   = sum_{k < steps} decay[k] * r[w_k]   (per reward column);
//   terminal = terminal[w_{steps-1}].
//
// One thread per sampled index walks its window and stops counting after the
// first terminal.  Rewards arrive as [capacity, R] (R = 1 for scalar rewards,
// the flattened trailing dims otherwise), terminals as the store's bool or
// uint8, read in place; indices may wrap, in either direction.  The products
// and sums are rounded as written (no fused multiply-add), in the order of
// the plain version, so the two agree exactly.
//
// Bound: bytes.  Per index, 8 bytes of index, steps terminal bytes and
// steps * R reward floats in, R + 2 values out: about 10 KB at B = 512,
// H = 3, a few nanoseconds at this card's memory rate; the kernel's time is
// its launch latency.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, bound with ctypes; returns cudaGetLastError() (0 on
// success).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_HORIZON = 64;
constexpr int THREADS = 128;

struct Decays {
  float d[MAX_HORIZON];
};

__global__ void __launch_bounds__(THREADS)
nstep_kernel(const float* __restrict__ rewards, int R,
             const unsigned char* __restrict__ terminals,
             const long long* __restrict__ indices, int B, long long capacity,
             int horizon, Decays dec, float* __restrict__ out_r,
             int* __restrict__ out_steps, unsigned char* __restrict__ out_term) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  long long base = indices[b] % capacity;
  if (base < 0) base += capacity;
  int steps = horizon;
  for (int k = 0; k < horizon; ++k) {
    if (terminals[(base + k) % capacity]) {
      steps = k + 1;
      break;
    }
  }
  for (int j = 0; j < R; ++j) {
    float acc = 0.f;
    for (int k = 0; k < steps; ++k) {
      const long long w = (base + k) % capacity;
      acc = __fadd_rn(acc, __fmul_rn(dec.d[k], rewards[w * R + j]));
    }
    out_r[(long long)b * R + j] = acc;
  }
  out_steps[b] = steps;
  out_term[b] = terminals[(base + steps - 1) % capacity] ? 1 : 0;
}

}  // namespace

extern "C" {

const char* nstep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int nstep_max_horizon() { return MAX_HORIZON; }

// rewards [capacity, R] f32, terminals [capacity] bool/uint8, indices [B]
// int64 -> out_r [B, R] f32, out_steps [B] int32, out_term [B] bool.
// decays: H host floats, passed to the kernel by value.
int nstep_rewards(const void* rewards, int R, const void* terminals,
                  const void* indices, int B, long long capacity, int horizon,
                  const float* decays, void* out_r, void* out_steps,
                  void* out_term, void* stream) {
  if (B < 1 || R < 1 || capacity < 1 || horizon < 1 || horizon > MAX_HORIZON)
    return (int)cudaErrorInvalidValue;
  Decays dec;
  for (int k = 0; k < MAX_HORIZON; ++k) dec.d[k] = k < horizon ? decays[k] : 0.f;
  nstep_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)rewards, R, (const unsigned char*)terminals,
      (const long long*)indices, B, capacity, horizon, dec, (float*)out_r,
      (int*)out_steps, (unsigned char*)out_term);
  return (int)cudaGetLastError();
}

}  // extern "C"
