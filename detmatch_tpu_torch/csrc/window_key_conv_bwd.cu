// Sparse 3D convolution backward over sorted int32 voxel keys: the
// gradients of csrc/window_key_conv.cu's out[b, m] = sum_k F[b,
// row(b,m,k)] . W_k,
//   dW_k     = sum_{b,m} F[b, row(b,m,k)]^T . dout[b, m]
//   dF[b, n] = sum_k dout[b, inv(b,n,k)] . W_k^T
// where row(b,m,k) is the row of nkeys[b,m,k] in sample b's own sorted key
// table and inv(b,n,k) is the output row whose tap k reads input row n.
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/window_key_conv.py:
// _bwd_fused (_bwd_kernel, pallas_call at :334). That kernel builds, per
// 512-row key tile, the transposed one-hot match S_k of every output row
// in a window against the tile's keys, on the VPU, keeps it in VMEM
// scratch and contracts dF = sum_k S_k W_k^T and dW_k += F^T S_k on the MXU
// in bf16. Gathers are cheap on this card, so nothing of that is kept:
// both gradients are gathers plus fp32 products, and each sample is
// searched in its own sorted segment (the TPU wrapper's flattened table
// is unsorted at B > 1).
//
// What bounds it on the H100: the backbone's gradients are a few MB
// (at most 2 x 24,000 rows x 27 taps x 64 x 128 fp32 products, ~10 GFLOP
// for the widest conv, and feature rows of 16-128 floats), so memory
// latency of the row gathers bounds it, not FLOPs or bandwidth. The design
// keeps every gathered tile in shared memory for the whole C x Co product
// and skips tiles in which no row has the tap (padding, sparse taps).
//
// Passes, all fp32, none with atomics, so every result is deterministic:
// 1. rulebook: one thread per (b, m, k) binary-searches nkeys[b,m,k] and
//    writes rb[b,m,k] = row (-1 = none). If dF is wanted it also writes
//    inv[b, row, k] = m. For any conv (submanifold, strided, (3,1,1)
//    z-compress) an input position and a tap fix at most one output
//    position, and distinct output rows have distinct keys, so each
//    (b, row, k) slot is written at most once: a plain scatter, no
//    atomics, and no conv geometry needed here. Outputs dropped by a
//    level cap have no row in nkeys and so leave inv at -1 (they add 0).
// 2. dF as a gather-GEMM like the forward: one block per 16 input rows;
//    per tap it stages W_k^T (Co x C) and the 16 gathered dout rows in
//    shared memory and accumulates dF in registers.
// 3. dW per tap as a reduction over output rows: block (j, k) sums
//    F[rb]^T . dout over the j-th chunk of output rows, 32 rows at a time
//    from shared memory, and writes one C x Co partial.
// 4. A second pass sums the partials over j in a fixed order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 64;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 8192;                       // C * Co floats per tap
constexpr int kRowsF = 16;                        // input rows per dF block
constexpr int kAccF = kRowsF * kMaxCin / kThreads;
constexpr int kRowsW = 32;                        // rows per dW tile
constexpr int kAccW = kMaxW / kThreads;

__global__ void __launch_bounds__(kThreads)
    rulebook_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ nkeys,
                    int32_t* __restrict__ rb, int32_t* __restrict__ inv,
                    int b, int n, int m, int k) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t total = static_cast<int64_t>(b) * m * k;
  if (p >= total) return;
  const int64_t row = p / k;
  const int tap = static_cast<int>(p - row * k);
  const int bi = static_cast<int>(row / m);
  const int mm = static_cast<int>(row - static_cast<int64_t>(bi) * m);
  const int32_t q = nkeys[p];
  int src = -1;
  if (q != dm::kInvalidKey) {
    const int32_t* tbl = keys + static_cast<size_t>(bi) * n;
    const int pos = dm::lower_bound(tbl, n, q);
    if (pos < n && tbl[pos] == q) src = pos;
  }
  rb[p] = src;
  if (inv != nullptr && src >= 0) {
    inv[(static_cast<int64_t>(bi) * n + src) * k + tap] = mm;
  }
}

__global__ void __launch_bounds__(kThreads)
    dfeats_kernel(const float* __restrict__ dout,
                  const float* __restrict__ weights,
                  const int32_t* __restrict__ inv,
                  float* __restrict__ dfeats, int b, int n, int m, int k,
                  int c, int co) {
  __shared__ int s_inv[kRowsF][kMaxTaps];  // global dout row, -1 = none
  __shared__ float s_wt[kMaxW];            // W_k^T, (co, c)
  __shared__ float s_d[kRowsF * kMaxCout];

  const int t = threadIdx.x;
  const int64_t rows = static_cast<int64_t>(b) * n;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsF;

  for (int p = t; p < kRowsF * k; p += kThreads) {
    const int r = p / k;
    const int tap = p - r * k;
    const int64_t row = row0 + r;
    int dst = -1;
    if (row < rows) {
      const int v = inv[row * k + tap];
      if (v >= 0) dst = static_cast<int>(row / n) * m + v;
    }
    s_inv[r][tap] = dst;
  }
  __syncthreads();

  float acc[kAccF];
#pragma unroll
  for (int j = 0; j < kAccF; ++j) acc[j] = 0.f;

  const int cw = c * co;
  for (int tap = 0; tap < k; ++tap) {
    // a barrier too: the previous tap's tiles are consumed past here
    const bool mine = t < kRowsF && s_inv[t][tap] >= 0;
    if (!__syncthreads_or(mine)) continue;
    const float* wk = weights + static_cast<size_t>(tap) * cw;
    for (int e = t; e < cw; e += kThreads) {
      const int ci = e / co;
      const int oc = e - ci * co;
      s_wt[oc * c + ci] = wk[e];
    }
    for (int e = t; e < kRowsF * co; e += kThreads) {
      const int r = e / co;
      const int oc = e - r * co;
      const int dst = s_inv[r][tap];
      s_d[e] = dst >= 0 ? dout[static_cast<size_t>(dst) * co + oc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccF; ++j) {
      const int o = t + j * kThreads;
      if (o < kRowsF * c) {
        const int r = o / c;
        const int ci = o - r * c;
        const float* d = s_d + r * co;
        float a = acc[j];
        for (int oc = 0; oc < co; ++oc) a = fmaf(d[oc], s_wt[oc * c + ci], a);
        acc[j] = a;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kAccF; ++j) {
    const int o = t + j * kThreads;
    if (o < kRowsF * c) {
      const int r = o / c;
      const int ci = o - r * c;
      const int64_t row = row0 + r;
      if (row < rows) dfeats[row * c + ci] = acc[j];
    }
  }
}

// grid (n_chunks, k): block (j, tap) writes partial[j, tap] (c x co).
__global__ void __launch_bounds__(kThreads)
    dweight_partial_kernel(const float* __restrict__ feats,
                           const float* __restrict__ dout,
                           const int32_t* __restrict__ rb,
                           float* __restrict__ partial, int b, int n, int m,
                           int k, int c, int co, int chunk_rows) {
  __shared__ int s_src[kRowsW];  // global input row, -1 = none
  __shared__ float s_f[kRowsW * kMaxCin];
  __shared__ float s_d[kRowsW * kMaxCout];

  const int t = threadIdx.x;
  const int tap = blockIdx.y;
  const int64_t rows = static_cast<int64_t>(b) * m;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * chunk_rows;
  const int64_t end = start + chunk_rows < rows ? start + chunk_rows : rows;
  const int cw = c * co;

  float acc[kAccW];
#pragma unroll
  for (int j = 0; j < kAccW; ++j) acc[j] = 0.f;

  for (int64_t r0 = start; r0 < end; r0 += kRowsW) {
    int src = -1;
    if (t < kRowsW && r0 + t < end) {
      const int64_t row = r0 + t;
      const int v = rb[row * k + tap];
      if (v >= 0) src = static_cast<int>(row / m) * n + v;
    }
    if (t < kRowsW) s_src[t] = src;
    // a barrier too: the previous tile is consumed past here
    if (!__syncthreads_or(src >= 0)) continue;
    for (int e = t; e < kRowsW * c; e += kThreads) {
      const int r = e / c;
      const int ci = e - r * c;
      const int s = s_src[r];
      s_f[e] = s >= 0 ? feats[static_cast<size_t>(s) * c + ci] : 0.f;
    }
    for (int e = t; e < kRowsW * co; e += kThreads) {
      const int r = e / co;
      const int oc = e - r * co;
      s_d[e] = s_src[r] >= 0 ? dout[(r0 + r) * co + oc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAccW; ++j) {
      const int e = t + j * kThreads;
      if (e < cw) {
        const int ci = e / co;
        const int oc = e - ci * co;
        float a = acc[j];
#pragma unroll 8
        for (int r = 0; r < kRowsW; ++r) {
          a = fmaf(s_f[r * c + ci], s_d[r * co + oc], a);
        }
        acc[j] = a;
      }
    }
  }

  float* out = partial + (static_cast<size_t>(blockIdx.x) * k + tap) * cw;
#pragma unroll
  for (int j = 0; j < kAccW; ++j) {
    const int e = t + j * kThreads;
    if (e < cw) out[e] = acc[j];
  }
}

// dw[tap, e] = sum_j partial[j, tap, e], j ascending.
__global__ void __launch_bounds__(kThreads)
    dweight_reduce_kernel(const float* __restrict__ partial,
                          float* __restrict__ dw, int n_chunks, int kcw) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= kcw) return;
  float s = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    s += partial[static_cast<size_t>(j) * kcw + i];
  }
  dw[i] = s;
}

}  // namespace

// feats (b, n, c) f32; keys (b, n) int32 sorted per sample, INVALID_KEY
// padded; nkeys (b, m, k) int32; weights (k, c, co) f32; dout (b, m, co)
// f32. Scratch from the caller: rb (b, m, k) int32; inv (b, n, k) int32
// filled with -1 (only if dfeats is wanted); partial (n_chunks, k, c, co)
// f32 with n_chunks = ceil(b * m / chunk_rows). Outputs: dfeats (b, n, c)
// (nullptr = not wanted, and inv may be nullptr), dw (k, c, co).
DM_EXPORT int dm_window_key_conv_bwd(
    const float* feats, const int32_t* keys, const int32_t* nkeys,
    const float* weights, const float* dout, int32_t* rb, int32_t* inv,
    float* partial, float* dfeats, float* dw, int b, int n, int m, int k,
    int c, int co, int chunk_rows, int n_chunks, cudaStream_t stream) {
  if (b < 0 || n <= 0 || m < 0 || k <= 0 || k > kMaxTaps || c <= 0 ||
      c > kMaxCin || co <= 0 || co > kMaxCout || c * co > kMaxW ||
      chunk_rows <= 0 || n_chunks < 0 || (dfeats != nullptr && !inv)) {
    return cudaErrorInvalidValue;
  }
  const int64_t out_rows = static_cast<int64_t>(b) * m;
  const int64_t in_rows = static_cast<int64_t>(b) * n;
  if (in_rows > 0x7fffffff || out_rows > 0x7fffffff ||
      static_cast<int64_t>(n_chunks) * chunk_rows < out_rows ||
      (n_chunks > 0 &&
       static_cast<int64_t>(n_chunks - 1) * chunk_rows >= out_rows)) {
    return cudaErrorInvalidValue;
  }
  const int kcw = k * c * co;
  if (out_rows > 0) {
    const int64_t pairs = out_rows * k;
    rulebook_kernel<<<static_cast<unsigned>((pairs + kThreads - 1) /
                                            kThreads),
                      kThreads, 0, stream>>>(keys, nkeys, rb,
                                             dfeats ? inv : nullptr, b, n, m,
                                             k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dweight_partial_kernel<<<dim3(static_cast<unsigned>(n_chunks),
                                  static_cast<unsigned>(k)),
                             kThreads, 0, stream>>>(
        feats, dout, rb, partial, b, n, m, k, c, co, chunk_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dweight_reduce_kernel<<<(kcw + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(partial, dw, n_chunks, kcw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dfeats == nullptr || in_rows == 0) return err;
  dfeats_kernel<<<static_cast<unsigned>((in_rows + kRowsF - 1) / kRowsF),
                  kThreads, 0, stream>>>(dout, weights, inv, dfeats, b, n,
                                         m, k, c, co);
  return cudaGetLastError();
}
