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
// sequence below; the entry decides from the shapes and the device before
// any launch and reports the count.
//
// K1 (and K2 where the one launch does not fit) is a fixed sequence of
// launches on the caller's stream, 3L + 1 for L layers (10 at L = 3),
// double-Q or not:
//   (a) per layer ONE grouped GEMM  h = act(x . W^T + b)  whose blockIdx.z
//       picks the (net, input) pair: the online net over obs (outputs saved
//       for the backward), the online net over nobs (double-Q only) and the
//       target net over nobs, each with its own outputs;
//   (b) one row-wise kernel: penalty, first-index argmax, y, err, dL/dq and
//       per-block partial metric sums;
//   (c) per layer, last to first: the weight gradient as one split-K GEMM
//       dW = dz^T . h_prev into a [chunks, out, in] workspace, with the bias
//       gradient of each chunk beside it (rows in ascending order: what a
//       ones column in the GEMM gave, bit for bit), then dh = dz . W with
//       the activation-gradient epilogue (it needs the old W);
//   (d) one elementwise kernel for every layer that sums the chunks in fixed
//       order and applies Adam, the parameter write and the polyak blend in
//       place, its block 0 finishing the metrics row.
// No atomics in any value path, in either design: the result repeats bit for
// bit from run to run.
//
// Bound of K1: f32 operations (about 5 * B * sum(in*out) multiply-adds, no
// tensor cores at this precision) against a few MB of traffic, so its GEMM
// (gemm_f32_kernel) is built for FMA throughput: 128 x 64 tiles, 16 deep,
// 256 threads each holding an 8 x 4 register block, so that every k step
// reads 12 floats of shared memory (three 16-byte loads) for 32 FMAs, at
// about 80 registers (three blocks an SM; 128 x 128 tiles with 8 x 8 blocks
// took 128 and ran slower at these shapes, and so did 8-deep stages).
// Operands sit k-major in two shared-memory stages, filled by cp.async
// where the global operand is contiguous in m or n and by 16-byte
// register-staged loads where it is contiguous in k (transposed on the
// store), while the other stage multiplies; the epilogue stores 16 bytes a
// thread.  A narrow 64 x 16 tile, 64 deep (4 x 1 a thread), serves N <= 64:
// the last layer's 8 outputs, and its weight gradient taken as
// h_prev^T . dz.  Each output is one fmaf chain over k in ascending order
// from its chunk's first row, the order the earlier 64 x 64 design summed
// in, and the weight-gradient blocks add the bias gradient from the dz
// tiles in shared memory in row order: the parameters equal that design's
// bit for bit.
//
// K1 with matmul_dtype=bfloat16 (reagent_tpu/ops/fused_dqn_offline.py:71-72,
// :96-100) -> C entry fused_dqn_offline_update_bf16, 3L + 2 launches.  Every
// product rounds BOTH operands to bf16 and accumulates in f32.  Each operand
// is rounded once: a first launch copies both nets' weights and the
// observations into bf16, and every producer of an operand (the forward and
// dh epilogues, the TD rows' dz) writes a bf16 copy beside its f32 output,
// rows padded to 8 elements.  mma_gemm_kernel then feeds the tensor cores
// from 16-byte cp.async copies into a 3-stage ring, 64 deep, ldmatrix
// (.trans for an operand contiguous in m or n) and mma.sync m16n8k16 bf16
// with f32 accumulators: eight warps on a 128 x 128 tile where that gives
// between one and two blocks an SM, else 128 x 64, and a narrow 128 x 16
// tile for N <= 64.  The epilogue runs from the accumulator registers, a
// quad of lanes exchanging values so that each stores 16 bytes.  Summed in
// ascending k16 steps with zero-filled tails, as the earlier nvcuda::wmma
// kernel did (wmma m16n16k16 compiles to the same instruction), so its
// parameters equal that kernel's bit for bit too.  Master weights, Adam
// moments, the polyak blend, q, the TD rows and the f32 dz stay f32; the
// bias gradient is summed from the unrounded f32 dz by extra blocks of the
// weight-gradient launch (eight row-strided partial sums added in order, as
// before).  With save_dtype=bfloat16 the saved layer outputs are stored as
// bf16, the first-layer weight gradient reads the observation rounded to
// bf16, and the activation gradient is taken from the rounded h; q, the
// last layer's output, is never rounded.  All four (matmul, save) pairs
// run.  At the tensor cores' bf16 rate the update's products take about
// 8 us; what is left is the launches' fill and drain, Adam and the f32
// traffic (no wgmma yet).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C, bound with ctypes; every entry returns cudaGetLastError()
// after each launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int GEMM_THREADS = 256;     // both GEMM kernels
constexpr int F32_PAD = 4;            // floats past each shared row of an f32 tile:
                                      // rows stay 16-byte aligned, stores miss no bank
// bf16 products: tiles HK deep, in a ring of HSTAGES shared-memory stages
constexpr int HK = 64;
constexpr int H_PAD = 8;              // bf16 elements past each shared row
constexpr int HSTAGES = 3;
constexpr int NARROW = 64;            // N at or below this takes the narrow tile
constexpr int ROW_THREADS = 256;
constexpr int EW_THREADS = 256;
constexpr int OFFLINE_CHUNK_ROWS = 256;
constexpr int MAX_LAYERS = 16;
constexpr int MAX_GROUPS = 3;
constexpr float NOT_POSSIBLE = -1e9f;

enum Act { ACT_LINEAR = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };
enum Epi { EPI_BIAS_ACT = 0, EPI_ACT_GRAD = 1, EPI_SPLITK = 2 };
// How the f32 product loads its operands.  F32_VEC: 16-byte loads (every
// operand 16-byte aligned with a row stride a multiple of 4); F32_SCALAR: one
// float at a time; MIXED: scalar, with the observation rounded to bf16
// (round_b) and bf16 copies of the outputs (C16); MIXED16: scalar, and the
// saved activation it reads (B under EPI_SPLITK, aux under EPI_ACT_GRAD) is
// bf16.  A template argument, never a run-time branch per load: a branch
// around each load keeps a thread's loads of one tile from being in flight
// together.
enum LoadMode { F32_VEC = 0, F32_SCALAR = 1, MIXED = 2, MIXED16 = 3 };

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

template <bool BF16>
__device__ __forceinline__ float load_at(const void* p, long long i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes from global to shared memory, the last 16 - bytes of them zero
// (bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  TRANS delivers each matrix transposed.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += a . b for one 16x8x16 bf16 product, f32 accumulators (the instruction
// nvcuda::wmma's m16n16k16 bf16 product compiles to, twice)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One product as the host describes it to either GEMM kernel:
// C(m, n) = sum_k A(m, k) * B(k, n) over k in a split-K chunk, k ascending.
// The epilogue fixes the operands' layouts:
//   EPI_BIAS_ACT  A(m,k) = A[m*lda + k], B(k,n) = B[n*ldb + k]   (x . W^T)
//                 v = act(acc + aux[n]); C = v, C16 = bf16(v) (either may be null)
//   EPI_ACT_GRAD  A(m,k) = A[m*lda + k], B(k,n) = B[k*ldb + n]   (dz . W)
//                 v = acc * act'(aux[m*ldaux + n]); C = v, C16 = bf16(v) (may be null)
//   EPI_SPLITK    A(m,k) = A[k*lda + m], B(k,n) = B[k*ldb + n]   (dz^T . h over rows)
//                 C[z*cz + m*csm + n*csn] = acc, z = the chunk
// C(m, n) is at m*csm + n*csn, C16(m, n) at m*ld16 + n.  Forward launches are
// grouped: blockIdx.z picks one of ngroups (net, input) pairs, each with its
// own A, B, aux and outputs.  Under EPI_SPLITK blockIdx.z is the chunk, and
// the bias gradient of the chunk comes with the weight gradient: in the f32
// product from the dz tiles as they pass through shared memory, in the bf16
// one (whose tiles hold rounded dz) from blocks past the tiles (bias_*).
struct GemmArgs {
  int ngroups;
  const void* A[MAX_GROUPS];
  long long lda[MAX_GROUPS];
  const void* B[MAX_GROUPS];
  const void* aux[MAX_GROUPS];
  float* C[MAX_GROUPS];
  __nv_bfloat16* C16[MAX_GROUPS];
  long long ldb, ldaux, csm, csn, cz, ld16;
  int M, N, K, kchunk, act, round_b;
  int ntm, ntn;                 // tiles along m and n
  const float* bias_dz;         // [K rows, bias_n] f32 dz
  float* bias_out;              // [chunks, bias_n]
  int bias_n;
  int bias_src;                 // f32 products: the bias gradient summed from the staged
                                // dz tiles, 1 = A (column m), 2 = B (column n); 0 = none
};

// The bias gradient of one split-K chunk of a bf16 product, from the
// unrounded f32 dz, for BIAS_COLS columns a block.  All threads stage
// BIAS_ROWS rows at a time into shared memory (eight loads in flight a
// thread: the sum is a chain of dependent adds, and waiting on each load in
// it would cost a memory latency per row); then one thread per column adds
// them as eight partial sums over rows strided by 8, added in order (the
// order of the earlier bias kernel of this route, which the results keep).
// `stage` holds BIAS_ROWS * BIAS_COLS floats.
constexpr int BIAS_COLS = 32;
constexpr int BIAS_ROWS = 64;
__device__ __forceinline__ void bias_block(const GemmArgs& g, int bb, int z, float* stage) {
  constexpr int LANES = GEMM_THREADS / BIAS_COLS;   // threads along the rows
  const int tx = threadIdx.x % BIAS_COLS, ty = threadIdx.x / BIAS_COLS;
  const int n = bb * BIAS_COLS + tx;
  const int mbeg = z * g.kchunk;
  const int mend = min(g.K, mbeg + g.kchunk);
  const long long ld = g.bias_n;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.f;
  for (int r0 = mbeg; r0 < mend; r0 += BIAS_ROWS) {
    float v[BIAS_ROWS / LANES];
#pragma unroll
    for (int j = 0; j < BIAS_ROWS / LANES; ++j) {
      const int m = r0 + ty + LANES * j;
      v[j] = (m < mend && n < g.bias_n) ? g.bias_dz[(long long)m * ld + n] : 0.f;
    }
    __syncthreads();  // the previous rows are summed
#pragma unroll
    for (int j = 0; j < BIAS_ROWS / LANES; ++j) stage[(ty + LANES * j) * BIAS_COLS + tx] = v[j];
    __syncthreads();
    if (ty == 0) {
      const int rows = min(BIAS_ROWS, mend - r0);
      for (int r = 0; r < rows; r += 8)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (r + j < rows) s[j] += stage[(r + j) * BIAS_COLS + tx];
    }
  }
  if (ty != 0 || n >= g.bias_n) return;
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) t += s[j];
  g.bias_out[(long long)z * g.bias_n + n] = t;
}

// Shared work of both GEMM kernels: which tile, group and chunk this block
// takes, or (false) that it summed a bias gradient instead.
template <int EPI>
__device__ __forceinline__ bool tile_of(const GemmArgs& g, int& m0, int& n0, int& grp,
                                        int& kbeg, int& kend, int BM, int BN, float* stage) {
  const int tiles = g.ntm * g.ntn;
  const int bx = blockIdx.x;
  if (EPI == EPI_SPLITK && bx >= tiles) {
    bias_block(g, bx - tiles, blockIdx.z, stage);
    return false;
  }
  m0 = (bx / g.ntn) * BM;
  n0 = (bx % g.ntn) * BN;
  grp = EPI == EPI_SPLITK ? 0 : blockIdx.z;
  kbeg = EPI == EPI_SPLITK ? blockIdx.z * g.kchunk : 0;
  kend = min(g.K, kbeg + g.kchunk);
  return true;
}

// The epilogue of output (m, n) with its sum; both kernels end in it.
template <int EPI, bool AUX16>
__device__ __forceinline__ void store_out(const GemmArgs& g, int grp, int m, int n, float acc) {
  float* C = g.C[grp];
  __nv_bfloat16* C16 = g.C16[grp];
  const long long o = (long long)m * g.csm + (long long)n * g.csn;
  if (EPI == EPI_BIAS_ACT) {
    const float v = act_fwd(acc + static_cast<const float*>(g.aux[grp])[n], g.act);
    if (C) C[o] = v;
    if (C16) C16[(long long)m * g.ld16 + n] = __float2bfloat16_rn(v);
  } else if (EPI == EPI_ACT_GRAD) {
    const float v = acc * act_grad_from_h(load_at<AUX16>(g.aux[grp], (long long)m * g.ldaux + n),
                                          g.act);
    C[o] = v;
    if (C16) C16[(long long)m * g.ld16 + n] = __float2bfloat16_rn(v);
  } else {
    C[(long long)blockIdx.z * g.cz + o] = acc;
  }
}

__device__ __forceinline__ bool aligned_at(const void* p, long long i, int bytes, int align) {
  return ((reinterpret_cast<size_t>(p) + (size_t)(i * bytes)) & (align - 1)) == 0;
}

// The epilogue of W (4 or 8) outputs of row m from column n: the same
// arithmetic as store_out, with 16-byte loads and stores (8-byte for four
// bf16 values) where every address allows, else one output at a time.
template <int EPI, bool AUX16, int W>
__device__ __forceinline__ void store_row(const GemmArgs& g, int grp, int m, int n,
                                          const float (&v)[W]) {
  float* C = g.C[grp];
  __nv_bfloat16* C16 = g.C16[grp];
  const void* aux = g.aux[grp];
  const long long o = (long long)m * g.csm + n + (EPI == EPI_SPLITK ? blockIdx.z * g.cz : 0);
  const long long o16 = (long long)m * g.ld16 + n;
  const long long oa = (long long)m * g.ldaux + n;
  bool vec = n + W <= g.N && g.csn == 1 && (!C || aligned_at(C, o, 4, 16)) &&
             (!C16 || aligned_at(C16, o16, 2, 2 * W));
  if (EPI == EPI_BIAS_ACT) vec = vec && aligned_at(aux, n, 4, 16);
  if (EPI == EPI_ACT_GRAD) vec = vec && aligned_at(aux, oa, AUX16 ? 2 : 4, AUX16 ? 2 * W : 16);
  if (!vec) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (n + w < g.N) store_out<EPI, AUX16>(g, grp, m, n + w, v[w]);
    return;
  }
  float x[W];
  if (EPI == EPI_BIAS_ACT) {
    const float4* b4 = reinterpret_cast<const float4*>(static_cast<const float*>(aux) + n);
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 b = b4[q];
      x[4 * q] = act_fwd(v[4 * q] + b.x, g.act);
      x[4 * q + 1] = act_fwd(v[4 * q + 1] + b.y, g.act);
      x[4 * q + 2] = act_fwd(v[4 * q + 2] + b.z, g.act);
      x[4 * q + 3] = act_fwd(v[4 * q + 3] + b.w, g.act);
    }
  } else if (EPI == EPI_ACT_GRAD) {
    float h[W];
    if (AUX16) {
      const __nv_bfloat16* a16 = static_cast<const __nv_bfloat16*>(aux) + oa;
      __nv_bfloat16 hv[W];
      if (W == 8) *reinterpret_cast<uint4*>(hv) = *reinterpret_cast<const uint4*>(a16);
      else *reinterpret_cast<uint2*>(hv) = *reinterpret_cast<const uint2*>(a16);
#pragma unroll
      for (int w = 0; w < W; ++w) h[w] = __bfloat162float(hv[w]);
    } else {
      const float4* a4 = reinterpret_cast<const float4*>(static_cast<const float*>(aux) + oa);
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const float4 a = a4[q];
        h[4 * q] = a.x; h[4 * q + 1] = a.y; h[4 * q + 2] = a.z; h[4 * q + 3] = a.w;
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) x[w] = v[w] * act_grad_from_h(h[w], g.act);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) x[w] = v[w];
  }
  if (C) {
    float4* c4 = reinterpret_cast<float4*>(C + o);
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      c4[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
  if (EPI != EPI_SPLITK && C16) {
    __nv_bfloat16 y[W];
#pragma unroll
    for (int w = 0; w < W; ++w) y[w] = __float2bfloat16_rn(x[w]);
    if (W == 8) *reinterpret_cast<uint4*>(C16 + o16) = *reinterpret_cast<const uint4*>(y);
    else *reinterpret_cast<uint2*>(C16 + o16) = *reinterpret_cast<const uint2*>(y);
  }
}

// f32 products: BM x BN tiles, FK deep, two shared-memory stages, each
// thread an RM x RN register block (8 x 4 in the 128 x 64 tile, 16 deep;
// 4 x 1 in the narrow 64 x 16 one, 64 deep).  Operands sit in shared
// memory k-major, As[k][m] and Bs[k][n], so a thread reads its RM values of
// A and RN of B at one k with 16-byte loads.  An operand whose contiguous dimension is m or n
// (A and B of the weight gradient, B of dh) is copied in with cp.async; one
// contiguous in k is loaded into registers (16 bytes a thread where aligned)
// before the current tile's products and stored transposed after them.
// Every output is one fmaf chain over k in ascending order from 0 (or from
// its chunk's first row): the sum the earlier 64 x 64 tile took, bit for bit.
template <int EPI, int MODE, int BM, int BN, int RM, int RN, int FK>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32_kernel(const GemmArgs g) {
  constexpr bool AK = EPI != EPI_SPLITK;    // A contiguous in k
  constexpr bool BKC = EPI == EPI_BIAS_ACT; // B contiguous in k
  constexpr bool VEC = MODE == F32_VEC;
  constexpr bool B16 = MODE == MIXED16 && EPI == EPI_SPLITK;
  constexpr bool AUX16 = MODE == MIXED16 && EPI == EPI_ACT_GRAD;
  constexpr int TX = BN / RN, TY = BM / RM;
  static_assert(TX * TY == GEMM_THREADS, "one output block per thread");
  static_assert(RM % 4 == 0 && (RN % 4 == 0 || RN == 1), "16-byte shared reads");
  constexpr int PA = BM + F32_PAD, PB = BN + F32_PAD;
  // 16-byte units of a tile (VEC) or floats a thread stages (scalar)
  constexpr int A4 = BM * FK / 4, B4 = BN * FK / 4;
  constexpr int SA = VEC ? (A4 + GEMM_THREADS - 1) / GEMM_THREADS : BM * FK / GEMM_THREADS;
  constexpr int SB = VEC ? (B4 + GEMM_THREADS - 1) / GEMM_THREADS
                         : (BN * FK + GEMM_THREADS - 1) / GEMM_THREADS;
  __shared__ __align__(16) float As[2][FK][PA];
  __shared__ __align__(16) float Bs[2][FK][PB];

  int m0, n0, grp, kbeg, kend;
  if (!tile_of<EPI>(g, m0, n0, grp, kbeg, kend, BM, BN, &As[0][0][0])) return;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int M = g.M, N = g.N;
  const float* __restrict__ Ap = static_cast<const float*>(g.A[grp]);
  const void* __restrict__ Bp = g.B[grp];
  const long long lda = g.lda[grp], ldb = g.ldb;

  // operand values at (row, col) of the tile in global memory, 0 outside
  auto a_at = [&](int m, int k) -> float {
    if (m >= M || k >= kend) return 0.f;
    return AK ? Ap[m * lda + k] : Ap[(long long)k * lda + m];
  };
  auto b_at = [&](int k, int n) -> float {
    if (n >= N || k >= kend) return 0.f;
    float v = BKC ? load_at<B16>(Bp, n * ldb + k) : load_at<B16>(Bp, (long long)k * ldb + n);
    if (MODE == MIXED && EPI == EPI_SPLITK) v = g.round_b ? round_bf16(v) : v;
    return v;
  };

  float ra[VEC ? 4 * SA : SA], rb[VEC ? 4 * SB : SB];  // k-contiguous operands in flight

  // Start the loads of the tile at k0 into stage s: cp.async for the
  // operands contiguous in m or n, registers for those contiguous in k.
  auto load_tile = [&](int k0, int s) {
#pragma unroll
    for (int r = 0; r < SA; ++r) {
      const int e = tid + r * GEMM_THREADS;
      if (VEC) {
        if (e < A4) {
          if (AK) {  // 4 along k of one row m
            const int m = m0 + e / (FK / 4), k = k0 + (e % (FK / 4)) * 4;
            if (m < M && k + 4 <= kend) {
              const float4 v = *reinterpret_cast<const float4*>(Ap + m * lda + k);
              ra[4 * r] = v.x; ra[4 * r + 1] = v.y; ra[4 * r + 2] = v.z; ra[4 * r + 3] = v.w;
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) ra[4 * r + j] = a_at(m, k + j);
            }
          } else {   // 4 along m of one row k
            const int kk = e / (BM / 4), mm = (e % (BM / 4)) * 4;
            const int m = m0 + mm, k = k0 + kk;
            const int ok = (k < kend && m < M) ? min(4, M - m) : 0;
            cp_async16(&As[s][kk][mm], ok ? Ap + (long long)k * lda + m : Ap, 4 * ok);
          }
        }
      } else {
        int m, k;
        if (AK) { k = e % FK; m = e / FK; } else { m = e % BM; k = e / BM; }
        ra[r] = a_at(m0 + m, k0 + k);
      }
    }
#pragma unroll
    for (int r = 0; r < SB; ++r) {
      const int e = tid + r * GEMM_THREADS;
      if (VEC) {
        if (e < B4) {
          const float* Bf = static_cast<const float*>(Bp);
          if (BKC) {  // 4 along k of one row n
            const int n = n0 + e / (FK / 4), k = k0 + (e % (FK / 4)) * 4;
            if (n < N && k + 4 <= kend) {
              const float4 v = *reinterpret_cast<const float4*>(Bf + n * ldb + k);
              rb[4 * r] = v.x; rb[4 * r + 1] = v.y; rb[4 * r + 2] = v.z; rb[4 * r + 3] = v.w;
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) rb[4 * r + j] = b_at(k + j, n);
            }
          } else {   // 4 along n of one row k
            const int kk = e / (BN / 4), nn = (e % (BN / 4)) * 4;
            const int n = n0 + nn, k = k0 + kk;
            const int ok = (k < kend && n < N) ? min(4, N - n) : 0;
            cp_async16(&Bs[s][kk][nn], ok ? Bf + (long long)k * ldb + n : Bf, 4 * ok);
          }
        }
      } else if (e < BN * FK) {
        int n, k;
        if (BKC) { k = e % FK; n = e / FK; } else { n = e % BN; k = e / BN; }
        rb[r] = b_at(k0 + k, n0 + n);
      }
    }
  };
  // Store the register-staged operands into stage s (transposed where the
  // global layout is k-contiguous).
  auto store_tile = [&](int s) {
#pragma unroll
    for (int r = 0; r < SA; ++r) {
      const int e = tid + r * GEMM_THREADS;
      if (VEC) {
        if (AK && e < A4) {
          const int mm = e / (FK / 4), kk = (e % (FK / 4)) * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) As[s][kk + j][mm] = ra[4 * r + j];
        }
      } else {
        int m, k;
        if (AK) { k = e % FK; m = e / FK; } else { m = e % BM; k = e / BM; }
        As[s][k][m] = ra[r];
      }
    }
#pragma unroll
    for (int r = 0; r < SB; ++r) {
      const int e = tid + r * GEMM_THREADS;
      if (VEC) {
        if (BKC && e < B4) {
          const int nn = e / (FK / 4), kk = (e % (FK / 4)) * 4;
#pragma unroll
          for (int j = 0; j < 4; ++j) Bs[s][kk + j][nn] = rb[4 * r + j];
        }
      } else if (e < BN * FK) {
        int n, k;
        if (BKC) { k = e % FK; n = e / FK; } else { n = e % BN; k = e / BN; }
        Bs[s][k][n] = rb[r];
      }
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  // The bias gradient: the first tile along the other dimension sums its dz
  // column over the chunk's rows in ascending order (zero-filled rows add
  // +0, which leaves a sum that started at +0 unchanged), one thread a column.
  const int bias_src = EPI == EPI_SPLITK ? g.bias_src : 0;
  const bool bias_a = bias_src == 1 && n0 == 0 && tid < BM;
  const bool bias_b = bias_src == 2 && m0 == 0 && tid < BN;
  float bsum = 0.f;

  const int nk = (kend - kbeg + FK - 1) / FK;
  load_tile(kbeg, 0);
  cp_async_commit();
  store_tile(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int s = t & 1;
    const bool more = t + 1 < nk;
    if (more) {
      load_tile(kbeg + (t + 1) * FK, s ^ 1);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int p = 0; p < RM / 4; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(&As[s][kk][p * (BM / (RM / 4)) + ty * 4]);
        a[4 * p] = v.x; a[4 * p + 1] = v.y; a[4 * p + 2] = v.z; a[4 * p + 3] = v.w;
      }
      if (RN == 1) {
        b[0] = Bs[s][kk][tx];
      } else {
#pragma unroll
        for (int p = 0; p < RN / 4; ++p) {
          const float4 v =
              *reinterpret_cast<const float4*>(&Bs[s][kk][p * (BN / (RN / 4)) + tx * 4]);
          b[4 * p] = v.x; b[4 * p + 1] = v.y; b[4 * p + 2] = v.z; b[4 * p + 3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (bias_a) {
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) bsum += As[s][kk][tid];
    } else if (bias_b) {
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) bsum += Bs[s][kk][tid];
    }
    if (more) {
      store_tile(s ^ 1);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  if ((bias_a && m0 + tid < M) || (bias_b && n0 + tid < N))
    g.bias_out[(long long)blockIdx.z * g.bias_n + (bias_a ? m0 : n0) + tid] = bsum;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + (i / 4) * (BM / (RM / 4)) + ty * 4 + i % 4;
    if (m >= M) continue;
    if (RN == 1) {
      if (n0 + tx < N) store_out<EPI, AUX16>(g, grp, m, n0 + tx, acc[i][0]);
    } else {
#pragma unroll
      for (int p = 0; p < RN / 4; ++p) {
        const float v[4] = {acc[i][4 * p], acc[i][4 * p + 1], acc[i][4 * p + 2], acc[i][4 * p + 3]};
        store_row<EPI, AUX16, 4>(g, grp, m, n0 + p * (BN / (RN / 4)) + tx * 4, v);
      }
    }
  }
}

// Dynamic shared memory of the bf16 product: HSTAGES stages of an A and a B
// tile, each [rows][HK + H_PAD] when contiguous in k, else [HK][cols + H_PAD].
template <int EPI, int BM, int BN>
__host__ __device__ constexpr int mma_stage_elems() {
  return (EPI != EPI_SPLITK ? BM * (HK + H_PAD) : HK * (BM + H_PAD)) +
         (EPI == EPI_BIAS_ACT ? BN * (HK + H_PAD) : HK * (BN + H_PAD));
}

// bf16 products on the tensor cores, f32 accumulation: a BM x BN tile over
// eight warps (WM x WN), each warp (BM/WM) x (BN/WN) in 16 x 8 mma.sync
// products.  Every operand is a bf16 copy in device memory whose rows are
// padded to a multiple of 8 elements, so each tile comes in by 16-byte
// cp.async copies (the ragged edge zero-filled by the copy's byte count)
// into a ring of HSTAGES stages, HK deep, while earlier stages multiply.
// Fragments come out of shared memory with ldmatrix (.trans for an operand
// contiguous in m or n).  Each output sums its k16 steps in ascending order
// from the chunk's start, with tails zero-filled: the sums of the earlier
// nvcuda::wmma kernel.  The epilogue runs from the accumulator registers.
template <int EPI, bool AUX16, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(GEMM_THREADS)
mma_gemm_kernel(const GemmArgs g) {
  constexpr bool AK = EPI != EPI_SPLITK;
  constexpr bool BKC = EPI == EPI_BIAS_ACT;
  static_assert(WM * WN * 32 == GEMM_THREADS, "eight warps");
  constexpr int WTM = BM / WM, WTN = BN / WN;       // a warp's tile
  constexpr int MI = WTM / 16, NI = WTN / 8;        // its 16 x 8 products
  static_assert(MI >= 1 && NI % 2 == 0, "ldmatrix.x4 feeds two n8 blocks");
  constexpr int PA = AK ? HK + H_PAD : BM + H_PAD;  // row pitch, elements
  constexpr int PB = BKC ? HK + H_PAD : BN + H_PAD;
  constexpr int A_ELEMS = AK ? BM * PA : HK * PA;
  constexpr int STAGE = mma_stage_elems<EPI, BM, BN>();
  constexpr int A_CH = AK ? BM * (HK / 8) : HK * (BM / 8);   // 16-byte copies a tile
  constexpr int B_CH = BKC ? BN * (HK / 8) : HK * (BN / 8);
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(mma_smem);

  int m0, n0, grp, kbeg, kend;
  if (!tile_of<EPI>(g, m0, n0, grp, kbeg, kend, BM, BN, reinterpret_cast<float*>(mma_smem)))
    return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm0 = (warp / WN) * WTM, wn0 = (warp % WN) * WTN;
  const int M = g.M, N = g.N;
  const __nv_bfloat16* Ap = static_cast<const __nv_bfloat16*>(g.A[grp]);
  const __nv_bfloat16* Bp = static_cast<const __nv_bfloat16*>(g.B[grp]);
  const long long lda = g.lda[grp], ldb = g.ldb;

  auto load_tile = [&](int k0, int s) {
    __nv_bfloat16* As = sm + s * STAGE;
    __nv_bfloat16* Bs = As + A_ELEMS;
    for (int e = tid; e < A_CH; e += GEMM_THREADS) {
      int r, c, m, k;
      if (AK) { r = e / (HK / 8); c = (e % (HK / 8)) * 8; m = m0 + r; k = k0 + c; }
      else    { r = e / (BM / 8); c = (e % (BM / 8)) * 8; k = k0 + r; m = m0 + c; }
      const int ok = AK ? (m < M ? min(8, max(0, kend - k)) : 0)
                        : (k < kend ? min(8, max(0, M - m)) : 0);
      const __nv_bfloat16* src = AK ? Ap + m * lda + k : Ap + (long long)k * lda + m;
      cp_async16(As + r * PA + c, ok ? src : Ap, 2 * ok);
    }
    for (int e = tid; e < B_CH; e += GEMM_THREADS) {
      int r, c, n, k;
      if (BKC) { r = e / (HK / 8); c = (e % (HK / 8)) * 8; n = n0 + r; k = k0 + c; }
      else     { r = e / (BN / 8); c = (e % (BN / 8)) * 8; k = k0 + r; n = n0 + c; }
      const int ok = BKC ? (n < N ? min(8, max(0, kend - k)) : 0)
                         : (k < kend ? min(8, max(0, N - n)) : 0);
      const __nv_bfloat16* src = BKC ? Bp + n * ldb + k : Bp + (long long)k * ldb + n;
      cp_async16(Bs + r * PB + c, ok ? src : Bp, 2 * ok);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = (kend - kbeg + HK - 1) / HK;
#pragma unroll
  for (int s = 0; s < HSTAGES - 1; ++s) {
    if (s < nk) load_tile(kbeg + s * HK, s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<HSTAGES - 2>();
    __syncthreads();  // stage t has landed; every warp is done with stage t - 1
    const int tn = t + HSTAGES - 1;
    if (tn < nk) load_tile(kbeg + tn * HK, tn % HSTAGES);
    cp_async_commit();
    const __nv_bfloat16* As = sm + (t % HSTAGES) * STAGE;
    const __nv_bfloat16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < HK; kk += 16) {
      unsigned a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int mb = wm0 + i * 16;
        if (AK)
          ldmatrix_x4<false>(a[i], As + (mb + lane % 8 + ((lane / 8) % 2) * 8) * PA + kk +
                                       (lane / 16) * 8);
        else
          ldmatrix_x4<true>(a[i], As + (kk + lane % 8 + (lane / 16) * 8) * PA + mb +
                                      ((lane / 8) % 2) * 8);
      }
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        const int nb = wn0 + j * 16;
        unsigned r[4];
        if (BKC)
          ldmatrix_x4<false>(r, Bs + (nb + lane % 8 + (lane / 16) * 8) * PB + kk +
                                    ((lane / 8) % 2) * 8);
        else
          ldmatrix_x4<true>(r, Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * PB + nb +
                                   (lane / 16) * 8);
        b[2 * j][0] = r[0]; b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2]; b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + gid + 8 * h;
      if (NI == 4) {
        // A quad holds columns j*8 + tig*2 + q of this row for j < 4; four
        // rounds of shuffles within the quad give lane tig the 8 columns of
        // block j = tig, so that its stores are 16 bytes wide.
        float r[4][2];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = (tig + s) & 3;  // the block this lane sends in round s
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float mine = j == 0 ? acc[i][0][2 * h + q] : j == 1 ? acc[i][1][2 * h + q]
                             : j == 2 ? acc[i][2][2 * h + q] : acc[i][3][2 * h + q];
            r[s][q] = s ? __shfl_sync(0xffffffffu, mine, (lane & ~3) | ((tig - s) & 3)) : mine;
          }
        }
        float v[8];  // column tig*8 + 2u + q came from lane u, in round (tig - u) & 3
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = (tig - u) & 3;
#pragma unroll
          for (int q = 0; q < 2; ++q)
            v[2 * u + q] = s == 0 ? r[0][q] : s == 1 ? r[1][q] : s == 2 ? r[2][q] : r[3][q];
        }
        if (m < M) store_row<EPI, AUX16, 8>(g, grp, m, n0 + wn0 + tig * 8, v);
      } else {
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int n = n0 + wn0 + j * 8 + tig * 2 + q;
            if (n < N) store_out<EPI, AUX16>(g, grp, m, n, acc[i][j][2 * h + q]);
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

// One thread per row.  sel_q is q_online(nobs) for double-Q, else q_target.
// dz16 (may be null): a bf16 copy of dz, row stride ld16, for bf16 products.
__global__ void __launch_bounds__(ROW_THREADS)
td_rows_kernel(const float* __restrict__ q, const float* __restrict__ sel_q,
               const float* __restrict__ qt, BatchIn in, float* __restrict__ dz,
               __nv_bfloat16* __restrict__ dz16, int ld16, float* __restrict__ partials,
               int B, int A, float gamma, float two_over_b) {
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
    for (int a = 0; a < A; ++a) {
      const float d = g * action_at(in, m, r, a);
      dz[r + a] = d;
      if (dz16) dz16[(long long)m * ld16 + a] = __float2bfloat16_rn(d);
    }
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

struct AdamConsts {
  float tau, one_minus_tau, b1, one_minus_b1, b2, one_minus_b2;
};

// Adam, the parameter write and the polyak blend of entry o, gradient g.
// Which product of a * b + c * d the compiler fuses into an fma depends on
// the code around it, and from nonzero moments the two choices round apart;
// the intrinsics fix the form every kernel of this file has used:
// m' = fma(g, 1 - b1, b1 * m), v' = fma((1 - b2) * g, g, b2 * v),
// pt' = fma(tau, p', (1 - tau) * pt).
__device__ __forceinline__ void adam_entry(float* p, float* pt, float* m, float* v, long long o,
                                           float g, float lr_t, float eps_t,
                                           const AdamConsts& c) {
  const float m_n = __fmaf_rn(g, c.one_minus_b1, __fmul_rn(c.b1, m[o]));
  const float v_n = __fmaf_rn(__fmul_rn(c.one_minus_b2, g), g, __fmul_rn(c.b2, v[o]));
  const float p_n = p[o] - lr_t * m_n / (sqrtf(v_n) + eps_t);
  m[o] = m_n;
  v[o] = v_n;
  p[o] = p_n;
  pt[o] = __fmaf_rn(c.tau, p_n, __fmul_rn(c.one_minus_tau, pt[o]));
}

// Every layer's Adam and polyak step in one launch, after every product of
// the update (dh reads the old W first).  Entry e of layer i is W (e <
// out*in) or b; its gradient is the sum of the layer's split-K chunks in
// chunk order.  Block 0 also finishes the metrics row from the TD kernel's
// per-block sums.
struct AdamArgs {
  int L, nchunks;
  long long start[MAX_LAYERS + 1];  // first entry of each layer; start[L] = all
  int out[MAX_LAYERS], in[MAX_LAYERS];
  float* prm[8 * MAX_LAYERS];       // params8: W, b, Wt, bt, mW, mb, vW, vb (L each)
  const float* gw[MAX_LAYERS];      // [chunks, out, in]
  const float* gb[MAX_LAYERS];      // [chunks, out]
  const float* lr_t;
  const float* eps_t;
  AdamConsts c;
  const float* partials;
  float* metrics;
  int nrowblocks, B, A;
};

__global__ void __launch_bounds__(EW_THREADS)
adam_polyak_kernel(const AdamArgs a) {
  const long long e = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    const int k = threadIdx.x;
    float s = 0.f;
    for (int i = 0; i < a.nrowblocks; ++i) s += a.partials[i * 4 + k];
    const float denom = (k == 1) ? (float)a.B * (float)a.A : (float)a.B;
    a.metrics[k] = s / denom;
  }
  if (e >= a.start[a.L]) return;
  int i = 0;
  while (e >= a.start[i + 1]) ++i;
  const int L = a.L, out = a.out[i];
  const long long nw = (long long)out * a.in[i];
  const long long o = e - a.start[i];
  const float lr_t = *a.lr_t, eps_t = *a.eps_t;
  float g = 0.f;
  if (o < nw) {
    for (int z = 0; z < a.nchunks; ++z) g += a.gw[i][z * nw + o];  // fixed order
    adam_entry(a.prm[i], a.prm[2 * L + i], a.prm[4 * L + i], a.prm[6 * L + i], o, g, lr_t,
               eps_t, a.c);
  } else {
    const long long n = o - nw;
    for (int z = 0; z < a.nchunks; ++z) g += a.gb[i][(long long)z * out + n];
    adam_entry(a.prm[L + i], a.prm[3 * L + i], a.prm[5 * L + i], a.prm[7 * L + i], n, g, lr_t,
               eps_t, a.c);
  }
}

// Copies into bf16 (round to nearest even) at the start of a bf16 update:
// each net's weights and the observations, one segment per blockIdx.y, rows
// padded to the copy's row stride.
constexpr int MAX_SEGMENTS = 2 * MAX_LAYERS + 2;
struct ConvertArgs {
  const float* src[MAX_SEGMENTS];
  __nv_bfloat16* dst[MAX_SEGMENTS];
  long long src_ld[MAX_SEGMENTS], dst_ld[MAX_SEGMENTS];
  int rows[MAX_SEGMENTS], cols[MAX_SEGMENTS];
};

__global__ void __launch_bounds__(EW_THREADS)
to_bf16_kernel(const ConvertArgs a) {
  const int s = blockIdx.y;
  const int cols = a.cols[s];
  const int total = a.rows[s] * cols;  // the host keeps each segment below 2^31
  for (int e = blockIdx.x * EW_THREADS + threadIdx.x; e < total; e += gridDim.x * EW_THREADS) {
    const int r = e / cols, c = e - r * cols;
    a.dst[s][r * a.dst_ld[s] + c] = __float2bfloat16_rn(a.src[s][r * a.src_ld[s] + c]);
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
inline long long pad8(long long n) { return (n + 7) / 8 * 8; }

// Which of K1's options an update runs with.
struct Precision {
  int matmul_bf16;  // products on the tensor cores, operands rounded to bf16
  int save_bf16;    // saved layer outputs (and the saved observation) in bf16
};

// Float offsets into the workspace, each a multiple of 4 (16 bytes).  A bf16
// matrix has rows padded to a multiple of 8 elements (pad8), so that each
// row starts 16-byte aligned.
struct Layout {
  long long h[MAX_LAYERS + 1];   // online outputs over obs, layers 1..L (h[L] = q);
                                 // under save_bf16 layers 1..L-1 are bf16, q stays f32
  long long tmp[4];              // f32 forward ping-pong: online over nobs (0, 1), and
                                 // under save_bf16 online over obs (2, 3)
  long long qn, qt, dz[2];       // the target net's forward uses dz[0], dz[1] as its ping-pong
  // K1 only (offline): the bf16 operands of the tensor-core products
  long long hb[MAX_LAYERS + 1];  // hidden outputs over obs (= h under save_bf16)
  long long w16[MAX_LAYERS], wt16[MAX_LAYERS], obs16, nobs16;
  long long tb16[2], dz16[2];    // online-over-nobs ping-pong; dz (the target's ping-pong first)
  long long gw[MAX_LAYERS];      // weight gradients by split-K chunk [chunks, out, in]
  long long gb[MAX_LAYERS];      // bias gradients [chunks, out]
  long long partials, total;
  int nchunks, chunk_rows, maxw, nrowblocks;
};

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
  auto take16 = [&take](long long rows, long long cols) {
    return take((rows * pad8(cols) + 1) / 2);
  };
  const long long Bl = B;
  lay->h[0] = -1;  // obs itself
  for (int i = 1; i <= L; ++i)
    lay->h[i] = save_bf16 && i < L ? take16(Bl, dims[i]) : take(Bl * dims[i]);
  const int A = dims[L];
  for (int t = 0; t < 4; ++t) lay->tmp[t] = t < 2 || save_bf16 ? take(Bl * maxw) : -1;
  lay->qn = take(Bl * A);
  lay->qt = take(Bl * A);
  lay->dz[0] = take(Bl * maxw);
  lay->dz[1] = take(Bl * maxw);
  for (int i = 0; i <= L; ++i) lay->hb[i] = -1;
  for (int i = 0; i < L; ++i) lay->w16[i] = lay->wt16[i] = -1;
  lay->obs16 = lay->nobs16 = lay->tb16[0] = lay->tb16[1] = lay->dz16[0] = lay->dz16[1] = -1;
  if (offline) {
    // the size entry does not know matmul_dtype, so K1 always holds these
    for (int i = 0; i < L; ++i) {
      lay->w16[i] = take16(dims[i + 1], dims[i]);
      lay->wt16[i] = take16(dims[i + 1], dims[i]);
    }
    lay->obs16 = take16(Bl, dims[0]);
    lay->nobs16 = take16(Bl, dims[0]);
    for (int i = 1; i < L; ++i) lay->hb[i] = save_bf16 ? lay->h[i] : take16(Bl, dims[i]);
    for (int t = 0; t < 2; ++t) {
      lay->tb16[t] = take16(Bl, maxw);
      lay->dz16[t] = take16(Bl, maxw);
    }
  }
  for (int i = 0; i < L; ++i) {
    lay->gw[i] = take((long long)lay->nchunks * dims[i + 1] * dims[i]);
    lay->gb[i] = take((long long)lay->nchunks * dims[i + 1]);
  }
  lay->partials = take((long long)lay->nrowblocks * 4);
  lay->total = off;
  return true;
}

constexpr int MAX_DEVICES = 64;

// Launch one bf16 product.  Its ring of stages needs more shared memory than
// the 48 KB a kernel gets by default: granted once per device.
template <int EPI, bool AUX16, int BM, int BN, int WM, int WN>
cudaError_t launch_mma(cudaStream_t st, GemmArgs g, int nz, int nbias) {
  constexpr size_t smem = (size_t)HSTAGES * mma_stage_elems<EPI, BM, BN>() * 2;
  static int granted[MAX_DEVICES];
  const void* kern = (const void*)mma_gemm_kernel<EPI, AUX16, BM, BN, WM, WN>;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!granted[dev]) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      granted[dev] = 1;
    }
  }
  g.ntm = cdiv(g.M, BM);
  g.ntn = cdiv(g.N, BN);
  mma_gemm_kernel<EPI, AUX16, BM, BN, WM, WN>
      <<<dim3(g.ntm * g.ntn + nbias, 1, nz), GEMM_THREADS, smem, st>>>(g);
  return cudaGetLastError();
}

template <int EPI, int MODE, int BM, int BN, int RM, int RN, int FK>
cudaError_t launch_f32(cudaStream_t st, GemmArgs g, int nz, int nbias) {
  g.ntm = cdiv(g.M, BM);
  g.ntn = cdiv(g.N, BN);
  gemm_f32_kernel<EPI, MODE, BM, BN, RM, RN, FK>
      <<<dim3(g.ntm * g.ntn + nbias, 1, nz), GEMM_THREADS, 0, st>>>(g);
  return cudaGetLastError();
}

// The number of SMs of the current device, read once per device.
cudaError_t sm_count(int* sms) {
  static int count[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!count[dev]) {
    e = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = count[dev];
  return cudaSuccess;
}

// One product: nz = groups (forward) or split-K chunks, nbias = bias-gradient
// blocks after the tiles (EPI_SPLITK).  N <= NARROW takes the narrow tile
// (f32: 64 x 16, 64 deep, so that a long K takes few pipeline steps),
// except where the operands are unaligned or typed (off the main path),
// which keep the wide one.
template <int EPI>
cudaError_t gemm(cudaStream_t st, const GemmArgs& g, int nz, int nbias, int tc, int mode,
                 bool aux16) {
  const bool narrow = g.N <= NARROW;
  if (tc) {
    // 128 x 128 tiles where they make between one and two blocks for each
    // SM (two fit an SM at once), else 128 x 64: more blocks for a product
    // too small to fill the card, fewer idle SMs in the last round of one
    // that overfills it
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    const long long wide = ((long long)cdiv(g.M, 128) * cdiv(g.N, 128) + nbias) * nz;
    const bool half = !narrow && (wide < sms || wide > 2LL * sms);
    if constexpr (EPI == EPI_ACT_GRAD) {
      // dh (K = the layer's width, few k steps) took the 128 x 64 tile at
      // every width measured, and is built with no other
      if (aux16)
        return narrow ? launch_mma<EPI, true, 128, 16, 8, 1>(st, g, nz, nbias)
                      : launch_mma<EPI, true, 128, 64, 4, 2>(st, g, nz, nbias);
      return narrow ? launch_mma<EPI, false, 128, 16, 8, 1>(st, g, nz, nbias)
                    : launch_mma<EPI, false, 128, 64, 4, 2>(st, g, nz, nbias);
    } else {
      return narrow ? launch_mma<EPI, false, 128, 16, 8, 1>(st, g, nz, nbias)
             : half ? launch_mma<EPI, false, 128, 64, 4, 2>(st, g, nz, nbias)
                    : launch_mma<EPI, false, 128, 128, 2, 4>(st, g, nz, nbias);
    }
  }
  if (mode == F32_VEC)
    return narrow ? launch_f32<EPI, F32_VEC, 64, 16, 4, 1, 64>(st, g, nz, nbias)
                  : launch_f32<EPI, F32_VEC, 128, 64, 8, 4, 16>(st, g, nz, nbias);
  if (mode == F32_SCALAR)  // unaligned operands: off the main path, one tile
    return launch_f32<EPI, F32_SCALAR, 128, 64, 8, 4, 16>(st, g, nz, nbias);
  if constexpr (EPI != EPI_ACT_GRAD)
    if (mode == MIXED) return launch_f32<EPI, MIXED, 128, 64, 8, 4, 16>(st, g, nz, nbias);
  if constexpr (EPI != EPI_BIAS_ACT)
    if (mode == MIXED16) return launch_f32<EPI, MIXED16, 128, 64, 8, 4, 16>(st, g, nz, nbias);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p, long long ld) {
  return (reinterpret_cast<size_t>(p) & 15) == 0 && ld % 4 == 0;
}

// F32_VEC where every operand of every group takes 16-byte loads.
int f32_mode(const GemmArgs& g) {
  for (int p = 0; p < g.ngroups; ++p)
    if (!aligned16(g.A[p], g.lda[p]) || !aligned16(g.B[p], g.ldb)) return F32_SCALAR;
  return F32_VEC;
}

#define CHECK(expr)                          \
  do {                                       \
    cudaError_t e_ = (expr);                 \
    if (e_ != cudaSuccess) return (int)e_;   \
    ++*n_launches;                           \
  } while (0)

int run_update(int L, const int* dims, const int* acts, int B, int double_q,
               const float* consts, void* const* params, const BatchIn& in,
               const float* lr_t, const float* eps_t, float* metrics, float* ws,
               int* n_launches, cudaStream_t st, int offline, Precision pr) {
  *n_launches = 0;
  Layout lay;
  if (!make_layout(L, dims, B, offline, pr.save_bf16, &lay) || (pr.matmul_bf16 && !offline))
    return (int)cudaErrorInvalidValue;
  float* const* P = reinterpret_cast<float* const*>(params);
  float* const* W = P;
  float* const* b = P + L;
  float* const* Wt = P + 2 * L;
  float* const* bt = P + 3 * L;
  const int D = dims[0], A = dims[L];
  const int tc = pr.matmul_bf16, sv = pr.save_bf16;
  auto f32 = [ws](long long off) { return off < 0 ? nullptr : ws + off; };
  auto b16 = [ws](long long off) {
    return off < 0 ? nullptr : reinterpret_cast<__nv_bfloat16*>(ws + off);
  };

  // (0) bf16 products: both nets' weights and the observations rounded once
  if (tc) {
    ConvertArgs ca{};
    int ns = 0;
    long long most = 0;
    bool fits = true;
    auto seg = [&](const float* src, long long sld, __nv_bfloat16* dst, int rows, int cols) {
      fits = fits && (long long)rows * cols < (1LL << 31);
      ca.src[ns] = src; ca.src_ld[ns] = sld;
      ca.dst[ns] = dst; ca.dst_ld[ns] = pad8(cols);
      ca.rows[ns] = rows; ca.cols[ns] = cols;
      most = (long long)rows * cols > most ? (long long)rows * cols : most;
      ++ns;
    };
    for (int i = 0; i < L; ++i) {
      seg(W[i], dims[i], b16(lay.w16[i]), dims[i + 1], dims[i]);
      seg(Wt[i], dims[i], b16(lay.wt16[i]), dims[i + 1], dims[i]);
    }
    seg(in.obs, in.obs_ld, b16(lay.obs16), B, D);
    seg(in.nobs, in.nobs_ld, b16(lay.nobs16), B, D);
    if (!fits) return (int)cudaErrorInvalidValue;
    const int gx = cdiv(most, EW_THREADS) < 512 ? cdiv(most, EW_THREADS) : 512;
    to_bf16_kernel<<<dim3(gx, ns), EW_THREADS, 0, st>>>(ca);
    CHECK(cudaGetLastError());
  }

  // (a) forwards, one launch per layer for every (net, input) pair: the online
  // net over obs (its outputs saved for the backward: f32 in h, or under
  // save_bf16 as bf16 there, the next layer then reading an f32 copy in tmp
  // when the products are f32), the online net over nobs (double-Q only) and
  // the target net over nobs.  bf16 products read and write bf16 copies.
  const int ng = double_q ? 3 : 2;
  const void* x[MAX_GROUPS];
  long long ldx[MAX_GROUPS];
  for (int p = 0; p < ng; ++p) {
    x[p] = tc ? (const void*)b16(p ? lay.nobs16 : lay.obs16) : (const void*)(p ? in.nobs : in.obs);
    ldx[p] = tc ? pad8(D) : (p ? in.nobs_ld : in.obs_ld);
  }
  for (int i = 0; i < L; ++i) {
    const int K = dims[i], N = dims[i + 1];
    const bool last = i == L - 1;
    GemmArgs g{};
    g.ngroups = ng;
    g.M = B; g.N = N; g.K = K; g.kchunk = K;
    g.act = acts[i];
    g.ldb = tc ? pad8(K) : K;
    g.csm = N; g.csn = 1; g.ld16 = pad8(N);
    bool c16 = false;
    for (int p = 0; p < ng; ++p) {
      const bool target = p == ng - 1;
      g.A[p] = x[p];
      g.lda[p] = ldx[p];
      g.B[p] = tc ? (const void*)b16(target ? lay.wt16[i] : lay.w16[i])
                  : (const void*)(target ? Wt[i] : W[i]);
      g.aux[p] = target ? bt[i] : b[i];
      float* C;
      __nv_bfloat16* C16 = nullptr;
      if (p == 0) {
        C = last ? f32(lay.h[L])
                 : (sv ? (tc ? nullptr : f32(lay.tmp[2 + i % 2])) : f32(lay.h[i + 1]));
        if (!last) C16 = tc ? b16(lay.hb[i + 1]) : (sv ? b16(lay.h[i + 1]) : nullptr);
      } else if (!target) {
        C = last ? f32(lay.qn) : (tc ? nullptr : f32(lay.tmp[i % 2]));
        if (!last && tc) C16 = b16(lay.tb16[i % 2]);
      } else {
        C = last ? f32(lay.qt) : (tc ? nullptr : f32(lay.dz[i % 2]));
        if (!last && tc) C16 = b16(lay.dz16[i % 2]);
      }
      g.C[p] = C;
      g.C16[p] = C16;
      c16 = c16 || C16;
      x[p] = tc ? (const void*)C16 : (const void*)C;
      ldx[p] = tc ? pad8(N) : N;
    }
    CHECK(gemm<EPI_BIAS_ACT>(st, g, ng, 0, tc, c16 && !tc ? MIXED : f32_mode(g), false));
  }

  // (b) TD rows
  const float* q = f32(lay.h[L]);
  const float* sel_q = f32(double_q ? lay.qn : lay.qt);
  td_rows_kernel<<<lay.nrowblocks, ROW_THREADS, 0, st>>>(
      q, sel_q, f32(lay.qt), in, f32(lay.dz[0]), tc ? b16(lay.dz16[0]) : nullptr, (int)pad8(A),
      f32(lay.partials), B, A, consts[0], consts[7]);
  CHECK(cudaGetLastError());

  // (c) backward, last layer first: per layer the weight gradient by split-K
  // chunk with the bias gradient as extra blocks, then dh = dz . W (old W)
  // with the activation-gradient epilogue
  int cur = 0;
  for (int i = L - 1; i >= 0; --i) {
    const int fan_in = dims[i], out = dims[i + 1];
    // the saved input of layer i: the observation, or layer i-1's output
    const void* hp;
    long long ldh;
    if (tc) {
      hp = b16(i ? lay.hb[i] : lay.obs16);
      ldh = pad8(fan_in);
    } else if (i == 0) {
      hp = in.obs;
      ldh = in.obs_ld;
    } else {
      hp = sv ? (const void*)b16(lay.h[i]) : (const void*)f32(lay.h[i]);
      ldh = sv ? pad8(fan_in) : fan_in;
    }
    const float* dzf = f32(lay.dz[cur]);
    const void* dza = tc ? (const void*)b16(lay.dz16[cur]) : (const void*)dzf;
    const long long ldz = tc ? pad8(out) : out;

    // dW[n, j] = sum_m dz[m, n] * h_prev[m, j] over each chunk's rows
    GemmArgs gw{};
    gw.ngroups = 1;
    gw.M = out; gw.N = fan_in; gw.K = B; gw.kchunk = lay.chunk_rows;
    gw.A[0] = dza; gw.lda[0] = ldz;
    gw.B[0] = hp; gw.ldb = ldh;
    gw.C[0] = f32(lay.gw[i]);
    gw.csm = fan_in; gw.csn = 1; gw.cz = (long long)out * fan_in;
    gw.round_b = !tc && sv && i == 0;
    gw.bias_dz = dzf; gw.bias_out = f32(lay.gb[i]); gw.bias_n = out;
    const int mode = tc ? F32_VEC : (sv ? (i ? MIXED16 : MIXED) : f32_mode(gw));
    gw.bias_src = tc ? 0 : 1;
    if (out <= NARROW && out < fan_in && (tc || mode <= F32_SCALAR)) {
      // few outputs: h_prev^T . dz instead, so that the narrow tile fits
      gw.M = fan_in; gw.N = out;
      gw.A[0] = hp; gw.lda[0] = ldh;
      gw.B[0] = dza; gw.ldb = ldz;
      gw.csm = 1; gw.csn = fan_in;
      gw.bias_src = tc ? 0 : 2;
    }
    CHECK(gemm<EPI_SPLITK>(st, gw, lay.nchunks, tc ? cdiv(out, BIAS_COLS) : 0, tc, mode, false));

    if (i > 0) {
      // dz_prev[m, j] = (sum_n dz[m, n] * W[n, j]) * act'(h_prev[m, j])
      GemmArgs gh{};
      gh.ngroups = 1;
      gh.M = B; gh.N = fan_in; gh.K = out; gh.kchunk = out;
      gh.A[0] = dza; gh.lda[0] = ldz;
      gh.B[0] = tc ? (const void*)b16(lay.w16[i]) : (const void*)W[i];
      gh.ldb = tc ? pad8(fan_in) : fan_in;
      gh.aux[0] = sv ? (const void*)b16(lay.h[i]) : (const void*)f32(lay.h[i]);
      gh.ldaux = sv ? pad8(fan_in) : fan_in;
      gh.act = acts[i - 1];
      gh.C[0] = f32(lay.dz[1 - cur]);
      gh.C16[0] = tc ? b16(lay.dz16[1 - cur]) : nullptr;
      gh.csm = fan_in; gh.csn = 1; gh.ld16 = pad8(fan_in);
      CHECK(gemm<EPI_ACT_GRAD>(st, gh, 1, 0, tc, sv ? MIXED16 : f32_mode(gh), sv));
    }
    cur = 1 - cur;
  }

  // (d) Adam and the polyak blend of every layer, and the metrics row
  AdamArgs aa{};
  aa.L = L;
  aa.nchunks = lay.nchunks;
  aa.start[0] = 0;
  for (int i = 0; i < L; ++i) {
    aa.out[i] = dims[i + 1];
    aa.in[i] = dims[i];
    aa.start[i + 1] = aa.start[i] + (long long)dims[i + 1] * (dims[i] + 1);
    aa.gw[i] = f32(lay.gw[i]);
    aa.gb[i] = f32(lay.gb[i]);
  }
  for (int i = 0; i < 8 * L; ++i) aa.prm[i] = P[i];
  aa.lr_t = lr_t;
  aa.eps_t = eps_t;
  aa.c = AdamConsts{consts[1], consts[2], consts[3], consts[4], consts[5], consts[6]};
  aa.partials = f32(lay.partials);
  aa.metrics = metrics;
  aa.nrowblocks = lay.nrowblocks;
  aa.B = B;
  aa.A = A;
  adam_polyak_kernel<<<cdiv(aa.start[L], EW_THREADS), EW_THREADS, 0, st>>>(aa);
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
