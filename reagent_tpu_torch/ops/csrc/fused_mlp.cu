// Fused small-MLP forward for Hopper (sm_90a), f32 throughout.
//
// Replaces the TPU kernel reagent_tpu/ops/fused_mlp.py::fused_mlp_forward
// (its pallas_call at :75): y = act_L(... act_1(x . W_1 + b_1) ... . W_L + b_L)
// with every layer in one launch, for policy scoring (the act step of the
// online loops and evaluate_policy).
//
// One block per tile of at most MAX_TILE_ROWS rows.  The tile's activations
// ping-pong between two shared-memory buffers through all layers; only x is
// read from and y written to device memory.  At these sizes the time goes to
// the latency of weight loads, not to their bandwidth, so each layer's weights
// are staged into shared memory by the whole block at once (in chunks of
// output columns and of k when a layer is larger than the stage), every thread
// issuing STAGE_UNROLL loads back to back before it stores them.  The staging
// walks the weight's contiguous dimension, so the loads are coalesced for both
// layouts callers hold: [in, out] (JAX's) and the W^T view of [out, in]
// (nn.Linear's and the trainer state's).  The stage is padded to an odd row
// length, which keeps its writes and reads free of bank conflicts.  Then each
// thread sums up to MAX_J (row, column) outputs over k in order, from shared
// memory, applies bias and activation in registers, and writes the next buffer
// (or y after the last layer).  Rows past the batch are masked.  No atomics:
// results repeat bit for bit.
//
// Bound: at the act step (one row, 4 -> 128 -> 64 -> 2) the work is ~36 KB of
// weights and ~18 KFLOP, nanoseconds on this card; the kernel's time is
// latency: its launch and one round of weight loads per layer.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, bound with ctypes; returns cudaGetLastError() (0 on
// success).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LAYERS = 16;
constexpr int MAX_TILE_ROWS = 16;
constexpr int THREADS = 256;
constexpr int MAX_J = 4;        // outputs per thread per column chunk
constexpr int WBUF = 9216;      // floats of staged weights (36 KB)
constexpr int STAGE_UNROLL = 8;
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

struct Layer {
  const float* W;  // W(k, n) = W[k * sk + n * sn]
  long long sk, sn;
  const float* b;  // [out], contiguous
  int in, out, act;
};

struct Net {
  Layer layer[MAX_LAYERS];
  int L;
};

__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ y, int B,
                 int tile_rows, int maxw, Net net) {
  extern __shared__ float smem[];
  float* wbuf = smem;                          // [WBUF]
  float* h = smem + WBUF;                      // [tile_rows, maxw]
  float* o = smem + WBUF + tile_rows * maxw;   // [tile_rows, maxw]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, B - row0);

  const int d0 = net.layer[0].in;
  for (int i = tid; i < rows * d0; i += THREADS) {
    const int r = i / d0, k = i % d0;
    h[r * maxw + k] = x[(long long)(row0 + r) * d0 + k];
  }

  for (int l = 0; l < net.L; ++l) {
    const Layer ly = net.layer[l];
    const bool last = l == net.L - 1;
    const int kc_max = min(ly.in, WBUF / 2);
    const int nc_max = min(ly.out, min(WBUF / kc_max - 1, THREADS * MAX_J / rows));
    for (int n0 = 0; n0 < ly.out; n0 += nc_max) {
      const int nc = min(nc_max, ly.out - n0);
      const int ldw = nc | 1;  // odd row length: no bank conflicts
      float acc[MAX_J];
#pragma unroll
      for (int j = 0; j < MAX_J; ++j) acc[j] = 0.f;
      for (int k0 = 0; k0 < ly.in; k0 += kc_max) {
        const int kc = min(kc_max, ly.in - k0);
        __syncthreads();  // the stage's last readers are done (and h is written)
        // STAGE_UNROLL loads in flight per thread before their stores
        for (int base = 0; base < kc * nc; base += THREADS * STAGE_UNROLL) {
          float v[STAGE_UNROLL];
          int dst[STAGE_UNROLL];
#pragma unroll
          for (int u = 0; u < STAGE_UNROLL; ++u) {
            const int i = base + u * THREADS + tid;
            int k, nn;
            if (ly.sk == 1) { k = i % kc; nn = i / kc; }  // k contiguous in memory
            else            { nn = i % nc; k = i / nc; }  // n contiguous (or neither)
            dst[u] = i < kc * nc ? k * ldw + nn : -1;
            v[u] = dst[u] >= 0
                ? ly.W[(long long)(k0 + k) * ly.sk + (long long)(n0 + nn) * ly.sn] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < STAGE_UNROLL; ++u)
            if (dst[u] >= 0) wbuf[dst[u]] = v[u];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < MAX_J; ++j) {
          const int p = tid + j * THREADS;
          if (p < nc * rows) {
            const int nn = p % nc, r = p / nc;
            const float* hr = h + r * maxw + k0;
            float a = acc[j];
            for (int k = 0; k < kc; ++k) a = fmaf(hr[k], wbuf[k * ldw + nn], a);
            acc[j] = a;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < MAX_J; ++j) {
        const int p = tid + j * THREADS;
        if (p < nc * rows) {
          const int n = n0 + p % nc, r = p / nc;
          const float v = act_fwd(acc[j] + ly.b[n], ly.act);
          if (last) y[(long long)(row0 + r) * ly.out + n] = v;
          else o[r * maxw + n] = v;
        }
      }
    }
    __syncthreads();
    float* t = h; h = o; o = t;
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x [B, dims[0]] contiguous -> y [B, dims[L]] contiguous.  Layer i reads
// Ws[i] with strides (w_strides[2i], w_strides[2i+1]) for (k, n) and the
// contiguous bias bs[i] [dims[i+1]].  tile_rows in 1..16.
int fused_mlp_forward(int L, const int* dims, const int* acts,
                      void* const* Ws, const long long* w_strides,
                      void* const* bs, const void* x, int B, int tile_rows,
                      void* y, void* stream) {
  if (L < 1 || L > MAX_LAYERS || B < 1 || tile_rows < 1 ||
      tile_rows > MAX_TILE_ROWS)
    return (int)cudaErrorInvalidValue;
  Net net;
  net.L = L;
  int maxw = 0;
  for (int i = 0; i < L; ++i) {
    if (dims[i] < 1 || dims[i + 1] < 1) return (int)cudaErrorInvalidValue;
    net.layer[i] = Layer{(const float*)Ws[i], w_strides[2 * i],
                         w_strides[2 * i + 1], (const float*)bs[i], dims[i],
                         dims[i + 1], acts[i]};
    maxw = dims[i] > maxw ? dims[i] : maxw;
    maxw = dims[i + 1] > maxw ? dims[i + 1] : maxw;
  }
  const long long smem = (WBUF + 2LL * tile_rows * maxw) * (long long)sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;  // once per process: allow up to 227 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  fused_mlp_kernel<<<cdiv(B, tile_rows), THREADS, (size_t)smem,
                     (cudaStream_t)stream>>>((const float*)x, (float*)y, B,
                                             tile_rows, maxw, net);
  return (int)cudaGetLastError();
}

}  // extern "C"
