// Deterministic segment sums of bf16-rounded rows, in fixed chunks on two
// levels: the scatter-add of K8 (dx, the gradient of onehot_take_rows) and
// the sorted path of K6's S (a rulebook whose (tap, row) slots repeat;
// csrc/onehot_gather.cu stores S directly when none does).
//
// Replaces the TPU kernels detmatch_tpu/ops/pallas/onehot_rows.py:
// _scatter_add (pallas_call at :114) and _scatter_add_batched (:208), and
// on repeats detmatch_tpu/ops/pallas/onehot_gather.py:_scatter_all_taps
// (:138). They form the sums as transposed one-hot matmuls over 512-row
// source tiles, accumulated tile by tile.
//
// The order, stated once; the plain twin (ops/cuda/onehot_rows.py:
// segment_sum_plain) follows it bit for bit. The (slot, source) pairs are
// ordered stably by slot, so within a slot they stay in ascending source
// order. A slot's pairs are cut into consecutive chunks of at most `chunk`
// pairs (ops/cuda/onehot_rows.CHUNK, passed in). Each chunk is summed
// sequentially in fp32 from 0, then the chunk sums sequentially in
// ascending chunk order from 0. A slot with at most `chunk` pairs is one
// sequential sum; a slot with none is 0. No float atomics: every run gives
// the same bits.
//
// What bounds it on the H100: bytes. Every pair's source row is read once
// (K8 at the RoI-grid shape: 8 x 442,368 rows of 64 floats, 906 MB) and the
// output written once; the keys, their sort and the offsets are a few
// bytes a pair.
//
// Why the first design lost to index_add_: each output element was one
// thread's serial loop over its slot's whole range, so a hot slot (339,280
// repeats of the empty balls' index 0) ran 64 threads through 1e5
// dependent adds while the card idled; and the wrapper prepared the slots,
// the order and the offsets with a dozen small host-issued ops.
//
// Design: slot_keys (one launch) writes each pair's slot; the wrapper
// sorts them stably (torch.sort); then one call here launches
//   offsets: the exclusive scan of the per-slot counts, written straight
//     from the sorted keys: position j writes the slot starts in
//     (key[j-1], key[j]], no search;
//   short slots: one thread group per slot of at most `chunk` pairs, the
//     channels of a row across its threads (16-byte loads where C allows),
//     writes its output row: the sequential sum, or 0;
//   long chunks: the chunks of longer slots need no table beyond the
//     offsets. Window w of the sorted pairs, positions [w * chunk,
//     (w + 1) * chunk), holds at most two of their chunk starts: one of
//     the slot that holds position w * chunk, and the first chunk of a
//     slot that starts inside the window (it outlasts the window, so it
//     holds its last position). Two thread groups a window sum those
//     chunks into partial rows 2 * (offsets[s] / chunk) + i, distinct for
//     such slots and below 2 * pairs / chunk. The 339,280-repeat slot
//     becomes 1,326 chunks spread over the card;
//   long tails: one thread group a window adds, for the long slot that
//     starts in it, its partials in chunk order.
// Every output element is written once, so the output needs no memset.
// Indices fit in 32 bits (the wrapper checks): the divisions are 32-bit.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

unsigned grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// V consecutive floats (V = 4: one 16-byte access).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

__global__ void __launch_bounds__(kThreads)
    slot_keys_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ keys,
                     int total, int per_group, int groups, int n) {
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < total; k += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int e = static_cast<int>(k);
    const int32_t i = x[e];
    const int g = (e / per_group) % groups;
    keys[e] = (i >= 0 && i < n) ? g * n + i : groups * n;
  }
}

// offsets[s] = the first position whose key is >= s, for s in [0, slots].
__global__ void __launch_bounds__(kThreads)
    segment_offsets_kernel(const int32_t* __restrict__ sorted_keys,
                           int32_t* __restrict__ offsets, int pairs,
                           int slots) {
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k <= pairs; k += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int j = static_cast<int>(k);
    const int lo = j == 0 ? 0 : min(sorted_keys[j - 1], slots) + 1;
    const int hi = j == pairs ? slots : min(sorted_keys[j], slots);
    for (int s = lo; s <= hi; ++s) offsets[s] = j;
  }
}

// The fp32 sum from 0 of bf16(rows[order[j] / div]) over j in [a, z), V
// channels from ch, in ascending j.
template <int V>
__device__ __forceinline__ void chunk_sum(const float* __restrict__ rows,
                                          const int64_t* __restrict__ order,
                                          int a, int z, int div, int cols,
                                          int ch, float (&acc)[V]) {
#pragma unroll
  for (int t = 0; t < V; ++t) acc[t] = 0.f;
#pragma unroll 8
  for (int j = a; j < z; ++j) {
    float r[V];
    load_vec<V>(rows + static_cast<int>(order[j]) / div * cols + ch, r);
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] += bf16_round(r[t]);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    short_slots_kernel(const float* __restrict__ rows,
                       const int64_t* __restrict__ order,
                       const int32_t* __restrict__ offsets,
                       float* __restrict__ out, int slots, int div, int cols,
                       int chunk) {
  const int groups = cols / V;  // threads per row
  const int total = slots * groups;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < total; k += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int e = static_cast<int>(k);
    const int s = e / groups;
    const int ch = (e - s * groups) * V;
    const int start = offsets[s];
    const int end = offsets[s + 1];
    if (end - start > chunk) continue;  // a long slot
    float acc[V];
    chunk_sum<V>(rows, order, start, end, div, cols, ch, acc);
    store_vec<V>(out + s * cols + ch, acc);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    long_chunks_kernel(const float* __restrict__ rows,
                       const int64_t* __restrict__ order,
                       const int32_t* __restrict__ sorted_keys,
                       const int32_t* __restrict__ offsets,
                       float* __restrict__ partials, int pairs, int slots,
                       int div, int cols, int chunk) {
  const int groups = cols / V;
  const int total = (pairs / chunk + 1) * 2 * groups;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < total; k += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int e = static_cast<int>(k);
    const int u = e / groups;
    const int ch = (e - u * groups) * V;
    const int w0 = (u >> 1) * chunk;  // the window's first position
    const bool first = (u & 1) == 0;
    const int p = first ? w0 : w0 + chunk - 1;
    if (p >= pairs) continue;
    const int s = sorted_keys[p];
    if (s >= slots) continue;
    const int start = offsets[s];
    const int end = offsets[s + 1];
    if (end - start <= chunk) continue;  // a short slot
    if (!first && start <= w0) continue;  // the first group's slot
    const int i = first ? (w0 - start + chunk - 1) / chunk : 0;
    const int a = start + i * chunk;
    if (a >= end) continue;
    float acc[V];
    chunk_sum<V>(rows, order, a, min(a + chunk, end), div, cols, ch, acc);
    store_vec<V>(partials + (2 * (start / chunk) + i) * cols + ch, acc);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    long_tails_kernel(const int32_t* __restrict__ sorted_keys,
                      const int32_t* __restrict__ offsets,
                      const float* __restrict__ partials,
                      float* __restrict__ out, int pairs, int slots, int cols,
                      int chunk) {
  const int groups = cols / V;
  const int total = (pairs / chunk + 1) * groups;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < total; k += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int e = static_cast<int>(k);
    const int w = e / groups;
    const int ch = (e - w * groups) * V;
    const int p = (w + 1) * chunk - 1;  // a long slot starting in window w
    if (p >= pairs) continue;           // holds the window's last position
    const int s = sorted_keys[p];
    if (s >= slots) continue;
    const int start = offsets[s];
    const int count = offsets[s + 1] - start;
    if (count <= chunk || start / chunk != w) continue;
    const int n = (count + chunk - 1) / chunk;
    const float* part = partials + 2 * w * cols + ch;
    float acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      float r[V];
      load_vec<V>(part + i * cols, r);
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] += r[t];
    }
    store_vec<V>(out + s * cols + ch, acc);
  }
}

template <int V>
void launch_sums(const float* rows, const int32_t* sorted_keys,
                 const int64_t* order, const int32_t* offsets,
                 float* partials, float* out, int pairs, int div, int cols,
                 int slots, int chunk, cudaStream_t stream) {
  const int groups = cols / V;
  short_slots_kernel<V><<<grid_for(static_cast<int64_t>(slots) * groups),
                          kThreads, 0, stream>>>(rows, order, offsets, out,
                                                 slots, div, cols, chunk);
  if (pairs <= chunk) return;  // no long slot
  const int64_t windows = pairs / chunk + 1;
  long_chunks_kernel<V><<<grid_for(windows * 2 * groups), kThreads, 0,
                          stream>>>(rows, order, sorted_keys, offsets,
                                    partials, pairs, slots, div, cols, chunk);
  long_tails_kernel<V><<<grid_for(windows * groups), kThreads, 0, stream>>>(
      sorted_keys, offsets, partials, out, pairs, slots, cols, chunk);
}

}  // namespace

// keys[e] = g * n + x[e] with g = (e / per_group) % groups where x[e] is in
// [0, n), groups * n (dropped) elsewhere: K8's b * N + idx for idx (B, Q)
// (per_group Q, groups B), K6's k * N + rb for rb (M, K) (1, K).
DM_EXPORT int dm_slot_keys(const int32_t* x, int32_t* keys, int total,
                           int per_group, int groups, int n,
                           cudaStream_t stream) {
  if (total < 0 || n < 0) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  if (per_group <= 0 || groups <= 0) return cudaErrorInvalidValue;
  slot_keys_kernel<<<grid_for(total), kThreads, 0, stream>>>(
      x, keys, total, per_group, groups, n);
  return cudaGetLastError();
}

// rows (., cols) f32, pair j reading row order[j] / div; sorted_keys
// (pairs,) int32 and order (pairs,) int64 from a stable sort of the pairs'
// slot keys (slots and above: dropped); scratch offsets (slots + 1,) int32
// and partials (2 * (pairs / chunk) + 2, cols) f32 → out (slots, cols) f32.
// rows, partials and out each hold fewer than 2^31 elements.
DM_EXPORT int dm_segment_sum_bf16(const float* rows,
                                  const int32_t* sorted_keys,
                                  const int64_t* order, int32_t* offsets,
                                  float* partials, float* out, int pairs,
                                  int div, int cols, int slots, int chunk,
                                  cudaStream_t stream) {
  if (pairs < 0 || div <= 0 || cols <= 0 || slots < 0 || chunk <= 0) {
    return cudaErrorInvalidValue;
  }
  if (slots == 0) return cudaSuccess;
  segment_offsets_kernel<<<grid_for(static_cast<int64_t>(pairs) + 1),
                           kThreads, 0, stream>>>(sorted_keys, offsets, pairs,
                                                  slots);
  if (cols % 4 == 0) {
    launch_sums<4>(rows, sorted_keys, order, offsets, partials, out, pairs,
                   div, cols, slots, chunk, stream);
  } else {
    launch_sums<1>(rows, sorted_keys, order, offsets, partials, out, pairs,
                   div, cols, slots, chunk, stream);
  }
  return cudaGetLastError();
}
