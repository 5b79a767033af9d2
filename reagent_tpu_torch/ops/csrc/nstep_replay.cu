// n-step replay rewards for Hopper (sm_90a).
//
// Replaces the TPU kernel reagent_tpu/ops/nstep_replay.py::nstep_rewards
// (its pallas_call at :92), which ReplayBuffer.sample computes inline at
// reagent_tpu/replay/circular.py:310-324 and :343-344.  For each sampled
// start index i, over the window w_k = (i + k) mod capacity, k < H:
//   steps    = 1 + the first k whose terminal is set, else H (the horizon cap
//              counts as the last step);
//   reward   = sum_{k < steps} decay[k] * r[w_k]   (per reward column);
//   terminal = terminal[w_{steps-1}], which is set iff any terminal of the
//              window is.
//
// Bound: bytes.  Per index, 8 bytes of index, steps terminal bytes and
// steps * R reward floats in, R + 2 values out: about 10 KB at B = 512,
// H = 1 or 3, a few nanoseconds at this card's memory rate; the kernel's time
// is its launch and the round trips of its dependent loads.
//
// Design: one thread per sampled index, one kernel for every H.  The first
// round trip is the index.  Its start is reduced with a 64-bit % only when
// it lies outside [0, capacity), and the window steps on by
// compare-and-reset, which also wraps a window longer than the capacity as
// often as it needs.  The window is walked CHUNK steps a round trip: every
// terminal and first-column reward of a chunk is issued together,
// predicated on k < H and not on steps, and the chunk's sum, steps and
// terminal flag then come from registers.  The walk stops after the chunk
// that holds the first terminal.  CHUNK, a template argument, is the power
// of two at or above H up to 8, so a window of at most 8 steps (the main
// path's H = 1 and 3) is one chunk and two round trips in all.  A chunk of
// 8 at H = 1 and 3 took 0.2-0.5 us longer on an H100
// (tools/k3_k4_designs.py); unrolled to 64 steps the kernel spilled.
// Further reward columns (R > 1) are walked again over the steps found.  Rewards arrive as
// [capacity, R] (R = 1 for scalar rewards, the flattened trailing dims
// otherwise), terminals as the store's bool or uint8, read in place;
// indices may wrap, in either direction.  The products and sums are
// rounded as written (no fused multiply-add), in the order of the plain
// version, so the two agree exactly.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, bound with ctypes; returns cudaGetLastError() (0 on
// success).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_HORIZON = 64;
constexpr int THREADS = 128;
constexpr int MAX_CHUNK = 8;  // the longest chunk of window steps a round trip

struct Decays {
  float d[MAX_HORIZON];
};

__device__ __forceinline__ long long next_slot(long long w, long long capacity) {
  return w + 1 == capacity ? 0 : w + 1;
}

// The first column's sum carried in order through the chunks until the
// first terminal; then each further column over the steps found.
template <int CHUNK>
__global__ void __launch_bounds__(THREADS)
nstep_kernel(const float* __restrict__ rewards, int R,
             const unsigned char* __restrict__ terminals,
             const long long* __restrict__ indices, int B, long long capacity,
             int horizon, Decays dec, float* __restrict__ out_r,
             int* __restrict__ out_steps, unsigned char* __restrict__ out_term) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  long long w0 = indices[b];
  if (w0 < 0 || w0 >= capacity) {
    w0 %= capacity;
    if (w0 < 0) w0 += capacity;
  }
  int steps = horizon;
  bool term = false;
  float acc = 0.f;
  long long w = w0;
  for (int k0 = 0; k0 < steps; k0 += CHUNK) {
    unsigned char t[CHUNK];
    float r[CHUNK];
#pragma unroll
    for (int kk = 0; kk < CHUNK; ++kk) {
      t[kk] = k0 + kk < horizon ? terminals[w] : 0;
      r[kk] = k0 + kk < horizon ? rewards[w * R] : 0.f;
      w = next_slot(w, capacity);
    }
#pragma unroll
    for (int kk = 0; kk < CHUNK; ++kk) {
      const int k = k0 + kk;
      if (k < steps) {
        acc = __fadd_rn(acc, __fmul_rn(dec.d[k], r[kk]));
        if (t[kk]) {
          steps = k + 1;
          term = true;
        }
      }
    }
  }
  out_r[(long long)b * R] = acc;
  for (int j = 1; j < R; ++j) {
    acc = 0.f;
    w = w0;
    for (int k0 = 0; k0 < steps; k0 += CHUNK) {
      float r[CHUNK];
#pragma unroll
      for (int kk = 0; kk < CHUNK; ++kk) {
        r[kk] = k0 + kk < steps ? rewards[w * R + j] : 0.f;
        w = next_slot(w, capacity);
      }
#pragma unroll
      for (int kk = 0; kk < CHUNK; ++kk)
        if (k0 + kk < steps) acc = __fadd_rn(acc, __fmul_rn(dec.d[k0 + kk], r[kk]));
    }
    out_r[(long long)b * R + j] = acc;
  }
  out_steps[b] = steps;
  out_term[b] = term;
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
  auto* kernel = horizon <= 1 ? nstep_kernel<1> : horizon <= 2 ? nstep_kernel<2>
               : horizon <= 4 ? nstep_kernel<4> : nstep_kernel<MAX_CHUNK>;
  kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)rewards, R, (const unsigned char*)terminals, (const long long*)indices, B,
      capacity, horizon, dec, (float*)out_r, (int*)out_steps, (unsigned char*)out_term);
  return (int)cudaGetLastError();
}

}  // extern "C"
