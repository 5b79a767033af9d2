// Fused small-MLP forward for Hopper (sm_90a), f32 throughout.
//
// Replaces the TPU kernel reagent_tpu/ops/fused_mlp.py::fused_mlp_forward
// (its pallas_call at :75): y = act_L(... act_1(x . W_1 + b_1) ... . W_L + b_L)
// with every layer in one launch, for policy scoring (the act step of the
// online loops and evaluate_policy) and the trainers' q_values.
//
// Bound: at the act step (one row, 4 -> 128 -> 64 -> 2) the work is ~36 KB of
// weights and ~18 KFLOP, nanoseconds on this card; the kernel's time is
// latency: its launch and the round trips of its loads to L2 or HBM.
//
// Two routes, one launch each, one block per tile of at most MAX_TILE_ROWS
// rows whose activations ping-pong between two shared-memory buffers:
//
// Resident (every net whose layers, biases and two activation buffers fit
// in the 227 KB a block may opt into; the act step's needs ~38 KB).  Every
// load of the launch is issued at its start, before any arithmetic, as
// cp.async copies: the tile's rows of x, then per layer its weights and its
// bias, one commit group per layer.  Copies are 16 bytes where the pointer,
// the stride and the width allow it (the row's last copy cut to its bytes,
// the rest of the 16 zero-filled), else 4.  Each copy loop, and each layer's
// loop over its outputs, walks rows and columns by compare-and-subtract from
// a start the host planned (Walk): no thread divides.  Layer l waits only
// for its own group (cp.async.wait_group), so later layers' weights land
// while earlier ones compute, and nothing inside the layer loop reads device
// memory.  Each weight keeps its source layout in shared memory: [n][k] for
// the W^T view of [out, in] (sk == 1: nn.Linear's and the trainer's layout,
// the main path) and [k][n] for JAX's [in, out].  Row pitches are an odd
// number of 16-byte units, so the 16-byte copies stay aligned and a quarter
// warp's 16-byte reads of eight [n][k] rows (or eight activation rows) fall
// in eight distinct bank groups; [k][n] rows are read one float per thread
// along n, free of conflicts at any pitch.  A sum reads its terms KB at a
// time, the next KB in flight while the current ones are summed.  While the
// grid would leave SMs idle, a block takes fewer rows than the caller's
// tile: enough for one output of the widest layer a thread.
//
// Streamed (nets that do not fit, e.g. the offline q_values nets of
// 128 -> 512 -> 256 -> A): each layer's weights are staged into a 36 KB
// buffer by the whole block (in chunks of output columns and of k when a
// layer is larger than it), every thread issuing STAGE_UNROLL loads back to
// back before it stores them, then summed from shared memory.
//
// Both routes sum each output the same way: acc = 0, acc = fmaf(h[k], W(k, n),
// acc) for k in order, then act(acc + b[n]) in registers.  Results do not
// depend on the route, the tile or the layout, and repeat bit for bit (no
// atomics).  Rows past the batch are masked.
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
// the streamed route
constexpr int MAX_J = 4;        // outputs per thread per column chunk
constexpr int WBUF = 9216;      // floats of staged weights (36 KB)
constexpr int STAGE_UNROLL = 8;

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

__global__ void __launch_bounds__(THREADS)
fused_mlp_streamed_kernel(const float* __restrict__ x, float* __restrict__ y, int B,
                          int tile_rows, int maxw, Net net) {
  extern __shared__ __align__(16) float smem[];
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
    const Layer& ly = net.layer[l];
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

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

Walk walk_of(int units) {
  return Walk{units, (65536 + units - 1) / units, THREADS / units, THREADS % units};
}

int copy_units(bool vec, int cols) { return vec ? (cols + 3) / 4 : cols; }

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

// x [B, dims[0]] contiguous -> y [B, dims[L]] contiguous.  Layer i reads
// Ws[i] with strides (w_strides[2i], w_strides[2i+1]) for (k, n) and the
// contiguous bias bs[i] [dims[i+1]].  At most tile_rows (1..16) rows a
// block; fused_mlp_resident says which route a launch takes.
int fused_mlp_forward(int L, const int* dims, const int* acts,
                      void* const* Ws, const long long* w_strides,
                      void* const* bs, const void* x, int B, int tile_rows,
                      void* y, void* stream) {
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
  const long long smem = (WBUF + 2LL * tile_rows * maxw) * (long long)sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  const cudaError_t e = opt_in(fused_mlp_streamed_kernel, opted_in);
  if (e != cudaSuccess) return (int)e;
  fused_mlp_streamed_kernel<<<cdiv(B, tile_rows), THREADS, (size_t)smem, s>>>(
      (const float*)x, (float*)y, B, tile_rows, maxw, net);
  return (int)cudaGetLastError();
}

}  // extern "C"
