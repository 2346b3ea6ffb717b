// Rulebook sparse 3D convolution with bf16 operands and fp32 sums, forward
// (K6's forward):
//   out[m] = sum_k bf16(F[rb[m, k]]) . bf16(W_k)
// over the taps whose rulebook entry is a row (rb in [0, n)); any other
// entry (-1: no input) contributes nothing.
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/onehot_gather.py:
// _onehot_gather_conv_fwd (pallas_call at :81). That kernel forms each
// tap's gather as a one-hot matmul over the whole feature table in bf16,
// O(M * N * K * C) compares and MACs, because TPU row gathers are slow. A
// rulebook entry matches one row, so the one-hot product is exactly
// bf16(F[rb]) (or 0): this kernel gathers that row by index instead.
//
// What bounds it on the H100: bytes. At the backbone's shapes (up to
// 8 x 24,000 output rows, 27 taps, 4-128 channels) 5-21% of the
// (row, tap) pairs find a row, so a conv reads a few MB of features and
// rulebook; its multiply-adds, on the tensor cores in bf16, are far
// below their rate.
//
// Design:
// 1. A prologue rounds F (n, C) once to bf16 storage fb (n, C16) and W
//    (k, C, Co) to wt (k, Co8, C16), transposed so that an output
//    column's weights are contiguous (the mma's B operand); C up to a
//    multiple of 16 (the mma's k-step), Co up to one of 8, zeros in the
//    pads. Two bytes a value: the tile gathers half the bytes of fp32.
// 2. The tile: a block owns kRows = 64 output rows, a warp 16 of them and
//    all Co8 columns, its fp32 accumulators in registers (the C operand
//    of bf16 mma.sync.m16n8k16). The block loads its rows' rulebook
//    entries, and per tap marks which 16-row groups have a source; the
//    taps with none are skipped. Per remaining tap (ascending), two
//    cp.async stages: the next tap's W_k (Co8 x C16) and, for the groups
//    with a source, the gathered bf16 rows of the matched pairs only
//    (a row without a source at that tap is zero-filled by the copy
//    itself, src-size 0, and reads nothing), while the warps multiply
//    the current tap: ldmatrix fragments (rows padded by 16 bytes in
//    shared memory, so that the eight rows of a fragment hit distinct
//    banks), k-steps of 16 ascending, column tiles of 8 ascending. A
//    group without a source at a tap does no mma.
// 3. Each warp stores its 16 rows x Co columns (pads cut).
//
// Sums: the products of two bf16 values are exact; the mma adds them in
// its own fixed order in fp32, per output element over the taps
// ascending, within a tap over k-steps of 16 ascending. Kernel and plain
// twin (ops/cuda/onehot_gather.onehot_gather_forward_plain, sequential
// fp32 sums) differ by that order only, and every launch gives the same
// bits. The fp32 tile of K7 on rounded operands (csrc/gather_gemm.cuh,
// tools/port_probes/k6k8_designs.cu) is kept as a measured comparison.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // 16 a warp
constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 128;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 16384;  // C * Co per tap
constexpr int kMaxTiles = kMaxCout / 8;  // 8-column mma tiles a warp
constexpr int kMaxSmem = 232448;
constexpr int64_t kMaxBlocks = 132 * 16;

// Rows of the bf16 tiles in shared memory: c16 values and 8 more, so
// that consecutive rows start 16 bytes apart modulo 128.
__host__ __device__ inline int smem_ld(int c16) { return c16 + 8; }

// Bytes of dynamic shared memory of one block: two stages of kRows x ld
// gathered rows and co8 x ld weights (bf16), the (kRows, k) sources, the
// taps' group masks and the list of taps with a source.
inline int64_t smem_bytes(int k, int c16, int co8) {
  const int64_t tiles = 2LL * (kRows + co8) * smem_ld(c16) * 2;
  return tiles + 4LL * kRows * k + 4LL * 32 + 4LL * 32;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, or 16 zero bytes when !valid (src-size 0:
// nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2],
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d (16 x 8 fp32 fragment) += a (16 x 16 bf16) . b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// f (n, c) → fb (n, c16) and w (k, c, co) → wt (k, co8, c16), rounded to
// bf16, zeros in the pads; two values a thread, the feature pairs first.
__global__ void __launch_bounds__(256)
    round_operands_kernel(const float* __restrict__ f,
                          const float* __restrict__ w,
                          __nv_bfloat162* __restrict__ fb,
                          __nv_bfloat162* __restrict__ wt, int n, int k,
                          int c, int co, int c16, int co8) {
  const int h = c16 / 2;  // pairs a row
  const int nf = n * h;
  const int total = nf + k * co8 * h;
  for (int e = blockIdx.x * 256 + threadIdx.x; e < total;
       e += gridDim.x * 256) {
    float v0 = 0.f, v1 = 0.f;
    if (e < nf) {
      const int r = e / h;
      const int ci = (e - r * h) * 2;
      const float* src = f + static_cast<int64_t>(r) * c;
      if (ci < c) v0 = src[ci];
      if (ci + 1 < c) v1 = src[ci + 1];
      fb[e] = __floats2bfloat162_rn(v0, v1);
    } else {
      const int g = e - nf;
      const int to = g / h;  // tap * co8 + o
      const int ci = (g - to * h) * 2;
      const int tap = to / co8;
      const int o = to - tap * co8;
      if (o < co) {
        const float* src = w + static_cast<int64_t>(tap) * c * co + o;
        if (ci < c) v0 = src[static_cast<int64_t>(ci) * co];
        if (ci + 1 < c) v1 = src[static_cast<int64_t>(ci + 1) * co];
      }
      wt[g] = __floats2bfloat162_rn(v0, v1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    gather_mma_kernel(const __nv_bfloat16* __restrict__ fb,
                      const int32_t* __restrict__ rb,
                      const __nv_bfloat16* __restrict__ wt,
                      float* __restrict__ out, int n, int m, int k, int co,
                      int c16, int co8) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = smem_ld(c16);
  __nv_bfloat16* s_a[2];
  __nv_bfloat16* s_b[2];
  s_a[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  s_b[0] = s_a[0] + kRows * ld;
  s_a[1] = s_b[0] + co8 * ld;
  s_b[1] = s_a[1] + kRows * ld;
  int* s_src = reinterpret_cast<int*>(s_b[1] + co8 * ld);  // (kRows, k)
  int* s_mask = s_src + kRows * k;                          // [32]
  int* s_taps = s_mask + 32;                                // [32]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;

  // 1. the tile's (row, tap) sources
  for (int p = t; p < kRows * k; p += kThreads) {
    const int r = p / k;
    const int tap = p - r * k;
    const int64_t row = row0 + r;
    int src = -1;
    if (row < m) {
      const int32_t q = rb[row * k + tap];
      if (q >= 0 && q < n) src = q;
    }
    s_src[p] = src;
  }
  __syncthreads();
  // 2. per tap, a bit for each 16-row group with a source
  for (int tap = warp; tap < k; tap += kThreads / 32) {
    const unsigned lo = __ballot_sync(0xffffffffu, s_src[lane * k + tap] >= 0);
    const unsigned hi =
        __ballot_sync(0xffffffffu, s_src[(lane + 32) * k + tap] >= 0);
    if (lane == 0) {
      s_mask[tap] = ((lo & 0xffffu) ? 1 : 0) | ((lo >> 16) ? 2 : 0) |
                    ((hi & 0xffffu) ? 4 : 0) | ((hi >> 16) ? 8 : 0);
    }
  }
  __syncthreads();
  if (t == 0) {
    int nt = 0;
    for (int tap = 0; tap < k; ++tap) {
      if (s_mask[tap] != 0) s_taps[nt++] = tap;
    }
    s_taps[31] = nt;
  }
  __syncthreads();
  const int n_taps = s_taps[31];

  // 3. taps ascending, the next one's copies in flight
  const int q16 = c16 / 8;  // 16-byte pieces a row
  auto issue = [&](int stage, int tap) {
    const int mask = s_mask[tap];
    __nv_bfloat16* da = s_a[stage];
    for (int e = t; e < kRows * q16; e += kThreads) {
      const int r = e / q16;
      if (!((mask >> (r >> 4)) & 1)) continue;  // a group without a source
      const int q = e - r * q16;
      const int src = s_src[r * k + tap];
      cp_async16_zfill(da + r * ld + q * 8,
                       fb + static_cast<int64_t>(src < 0 ? 0 : src) * c16 +
                           q * 8,
                       src >= 0);
    }
    const __nv_bfloat16* wk = wt + static_cast<int64_t>(tap) * co8 * c16;
    __nv_bfloat16* db = s_b[stage];
    for (int e = t; e < co8 * q16; e += kThreads) {
      const int o = e / q16;
      const int q = e - o * q16;
      dm::cp_async16(db + o * ld + q * 8, wk + o * c16 + q * 8);
    }
  };

  float acc[kMaxTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
  const int n_tiles = co8 / 8;
  // ldmatrix row addresses: A, lanes 0-15 rows 0-15 at k 0, lanes 16-31
  // rows 0-15 at k 8; B, lanes 0-7 columns 0-7 at k 0, lanes 8-15 at k 8
  const int a_row = warp * 16 + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = lane & 7;
  const int b_col = ((lane >> 3) & 1) * 8;

  if (n_taps > 0) issue(0, s_taps[0]);
  dm::cp_async_commit();
  for (int i = 0; i < n_taps; ++i) {
    if (i + 1 < n_taps) issue((i + 1) & 1, s_taps[i + 1]);
    dm::cp_async_commit();
    dm::cp_async_wait<1>();
    __syncthreads();
    if ((s_mask[s_taps[i]] >> warp) & 1) {
      const __nv_bfloat16* sa = s_a[i & 1];
      const __nv_bfloat16* sb = s_b[i & 1];
      for (int ks = 0; ks < c16; ks += 16) {
        unsigned a[4];
        ldmatrix_x4(a, sa + a_row * ld + ks + a_col);
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          if (j < n_tiles) {
            unsigned b[2];
            ldmatrix_x2(b, sb + (j * 8 + b_row) * ld + ks + b_col);
            mma_bf16(acc[j], a, b);
          }
        }
      }
    }
    __syncthreads();
  }
  dm::cp_async_wait<0>();

  // 4. the warp's 16 rows: c0, c1 at (g, 2 t4 + 0/1), c2, c3 at g + 8
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j) {
    if (j < n_tiles) {
      const int col = j * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t row = row0 + warp * 16 + g + half * 8;
        if (row >= m) continue;
        float* dst = out + row * co + col;
        if (col < co) dst[0] = acc[j][half * 2];
        if (col + 1 < co) dst[1] = acc[j][half * 2 + 1];
      }
    }
  }
}

bool bad_args(int n, int m, int k, int c, int co) {
  return n <= 0 || m < 0 || k <= 0 || k > kMaxTaps || c <= 0 ||
         c > kMaxCin || co <= 0 || co > kMaxCout || c * co > kMaxW ||
         static_cast<int64_t>(n) * ((c + 15) / 16 * 16) > 0x7fffffff;
}

}  // namespace

// K6's forward: feats (n, c) f32; rb (m, k) int32 rows, -1 (or any entry
// outside [0, n)) for none; weights (k, c, co) f32 → out (m, co) f32.
// Scratch: fb, n * C16 bf16, and wt, k * Co8 * C16 bf16 (C up to a
// multiple of 16, Co up to one of 8; ops/cuda/onehot_gather.mma_shapes).
DM_EXPORT int dm_onehot_gather_conv_fwd(const float* feats,
                                        const int32_t* rb,
                                        const float* weights, void* fb,
                                        void* wt, float* out, int n, int m,
                                        int k, int c, int co,
                                        cudaStream_t stream) {
  if (bad_args(n, m, k, c, co)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const int c16 = (c + 15) / 16 * 16;
  const int co8 = (co + 7) / 8 * 8;
  const int64_t pairs = static_cast<int64_t>(n) * (c16 / 2) +
                        static_cast<int64_t>(k) * co8 * (c16 / 2);
  const int64_t want = (pairs + 255) / 256;
  round_operands_kernel<<<static_cast<unsigned>(want < kMaxBlocks
                                                    ? want
                                                    : kMaxBlocks),
                          256, 0, stream>>>(
      feats, weights, static_cast<__nv_bfloat162*>(fb),
      static_cast<__nv_bfloat162*>(wt), n, k, c, co, c16, co8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static bool attr_set = false;
  if (!attr_set) {
    err = cudaFuncSetAttribute(gather_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const unsigned blocks = static_cast<unsigned>((m + kRows - 1) / kRows);
  gather_mma_kernel<<<blocks, kThreads,
                      static_cast<size_t>(smem_bytes(k, c16, co8)), stream>>>(
      static_cast<const __nv_bfloat16*>(fb), rb,
      static_cast<const __nv_bfloat16*>(wt), out, n, m, k, co, c16, co8);
  return cudaGetLastError();
}
