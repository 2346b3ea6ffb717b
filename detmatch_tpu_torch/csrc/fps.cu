// Farthest-point sampling, one thread-block cluster per sample.
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/fps.py:_fps_pallas
// (_fps_kernel), which keeps the whole batch's (3, N) coordinates and
// running distances in VMEM and advances the B greedy chains in lockstep.
//
// What bounds it on the H100: the 2,048 selections are strictly
// sequential, so the time is 2,048 x (one sweep over N points + one
// argmax over the sample); the data is small (18,000 points = 216 KB of
// xyz). Latency per step, not bandwidth or arithmetic, is the limit. One
// 1,024-thread block per sample used 1 to 8 of the 132 SMs, read 54
// shared floats a thread a step, and ended each step in two block
// barriers.
//
// Design: a cluster of C CTAs (2 to 16; the wrapper's plan) serves one
// sample. CTA r owns points [r * 128 * P, (r + 1) * 128 * P): its 128
// threads keep P points each, xyz and running distance, in registers, so
// a sweep reads no memory. A step ends in one exchange: each warp's
// candidate (distance, index, xyz), the argmax of its lanes by (distance
// desc, index asc), is stored into its slot of every CTA of the cluster
// through distributed shared memory; one cluster barrier (arrive.release,
// wait.acquire) follows; then every warp of every CTA reduces the C x 4
// slots with the same total order, so all agree on the winner, whose xyz
// travels with it. The exchange, not the sweep, now sets a step's time. The slots are double-buffered by step parity: a
// CTA writes step s + 2's slots only after every CTA has arrived at
// barrier s + 1, and each arrives there only after reading step s's. A
// cluster barrier before the first exchange lets every CTA start, and one
// after the last keeps every CTA's shared memory alive until all are
// done. The order is total, so any partition and reduction tree give the
// twin's index; distances keep dm::sq_dist's rounding. Invalid points
// hold -1 and lanes that own no point -FLT_MAX, so a valid point wins
// while one remains and an all-invalid row yields index 0 throughout.
#include <cooperative_groups.h>
#include <float.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxPerThread = 24;
constexpr int kMaxPoints = 49152;  // kMaxCluster x kThreads x kMaxPerThread
constexpr int kMaxSlots = 64;      // kMaxCluster x kWarps
constexpr float kBigDist = 1e10f;  // ops/pointnet.BIG_DIST
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxPoints == kMaxCluster * kThreads * kMaxPerThread &&
                  kMaxSlots == kMaxCluster * kWarps,
              "capacity and slots");

struct Slots {
  uint2 key[2][kMaxSlots];   // (ordered distance, index)
  float4 xyz[2][kMaxSlots];
};

// float order as unsigned order: the larger distance, the larger key
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's best (key desc, index asc); returns the lane that holds it.
__device__ __forceinline__ int warp_best(unsigned& key, unsigned& index) {
  const unsigned kmax = __reduce_max_sync(kFull, key);
  const unsigned imin =
      __reduce_min_sync(kFull, key == kmax ? index : 0xffffffffu);
  const int src =
      __ffs(__ballot_sync(kFull, key == kmax && index == imin)) - 1;
  key = kmax;
  index = imin;
  return src;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster's argmax of every thread's (d, i, xyz): returns the winning
// index and its xyz in (lx, ly, lz), the same in every thread.
__device__ __forceinline__ int cluster_argmax(
    Slots& slots, cg::cluster_group& cluster, int parity, float d,
    int i, float x, float y, float z, float& lx, float& ly, float& lz) {
  const int lane = threadIdx.x & 31;
  const int csize = static_cast<int>(cluster.num_blocks());
  unsigned key = order_key(d);
  unsigned index = static_cast<unsigned>(i);
  int src = warp_best(key, index);
  const float wx = __shfl_sync(kFull, x, src);
  const float wy = __shfl_sync(kFull, y, src);
  const float wz = __shfl_sync(kFull, z, src);
  if (lane < csize) {
    const int slot = static_cast<int>(cluster.block_rank()) * kWarps +
                     (threadIdx.x >> 5);
    Slots* dst = cluster.map_shared_rank(&slots, lane);
    dst->key[parity][slot] = make_uint2(key, index);
    dst->xyz[parity][slot] = make_float4(wx, wy, wz, 0.f);
  }
  cluster_barrier();
  // key 0 lies below every distance's key (-FLT_MAX's is 0x00800000)
  unsigned bk = 0;
  unsigned bi = 0xffffffffu;
  int bs = 0;
  for (int s = lane; s < csize * kWarps; s += 32) {
    const uint2 e = slots.key[parity][s];
    if (e.x > bk || (e.x == bk && e.y < bi)) {
      bk = e.x;
      bi = e.y;
      bs = s;
    }
  }
  src = warp_best(bk, bi);
  const float4 w = slots.xyz[parity][__shfl_sync(kFull, bs, src)];
  lx = w.x;
  ly = w.y;
  lz = w.z;
  return static_cast<int>(bi);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz,
               const uint8_t* __restrict__ valid, int32_t* __restrict__ out,
               int n, int k) {
  __shared__ Slots slots;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int sample = blockIdx.x / csize;
  const int t = threadIdx.x;
  const float* p = xyz + static_cast<size_t>(sample) * n * 3;
  const uint8_t* v = valid + static_cast<size_t>(sample) * n;
  int32_t* o = out + static_cast<size_t>(sample) * k;
  const bool writer = rank == 0 && t == 0;

  float px[P], py[P], pz[P], dist[P];
  const int base = rank * kThreads * P + t;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = base + j * kThreads;
    px[j] = py[j] = pz[j] = 0.f;
    dist[j] = -FLT_MAX;
    if (i < n) {
      px[j] = p[3 * i];
      py[j] = p[3 * i + 1];
      pz[j] = p[3 * i + 2];
      dist[j] = v[i] ? kBigDist : -1.f;
    }
  }
  cluster_barrier();  // every CTA has started before slots are written

  // step 0: the argmax of the starting distances is the first valid
  // point, or index 0 in an all-invalid row
  float bd = dist[0];
  int bi = base;
  float bx = px[0], by = py[0], bz = pz[0];
#pragma unroll
  for (int j = 1; j < P; ++j) {
    if (dist[j] > bd) {  // indices grow with j: strict keeps the first
      bd = dist[j];
      bi = base + j * kThreads;
      bx = px[j];
      by = py[j];
      bz = pz[j];
    }
  }
  float lx, ly, lz;
  int last = cluster_argmax(slots, cluster, 0, bd, bi, bx, by, bz, lx, ly,
                            lz);
  if (writer) o[0] = last;

  for (int s = 1; s < k; ++s) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float d =
          fminf(dist[j], dm::sq_dist(px[j], py[j], pz[j], lx, ly, lz));
      dist[j] = d;
      // selects, not a branch: the branch form compiled to code up to a
      // third slower at some P
      const bool take = j == 0 || d > bd;
      bd = take ? d : bd;
      bi = take ? base + j * kThreads : bi;
      bx = take ? px[j] : bx;
      by = take ? py[j] : by;
      bz = take ? pz[j] : bz;
    }
    last = cluster_argmax(slots, cluster, s & 1, bd, bi, bx, by, bz, lx, ly,
                          lz);
    if (writer) o[s] = last;
  }
  cluster_barrier();  // no CTA leaves while another may still read it
}

cudaLaunchConfig_t config(int b, int cluster, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches (b > 0) or, with active != nullptr, asks how many clusters of
// this shape the card holds at once.
template <int P>
cudaError_t run(const float* xyz, const uint8_t* valid, int32_t* out, int b,
                int n, int k, int cluster, int* active, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<P>, cudaFuncAttributeNonPortableClusterSizeAllowed,
      cluster > 8 ? 1 : 0);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(active ? 1 : b, cluster, stream, &attr);
  if (active) {
    return cudaOccupancyMaxActiveClusters(active, fps_kernel<P>, &cfg);
  }
  err = cudaLaunchKernelEx(&cfg, fps_kernel<P>, xyz, valid, out, n, k);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch(int per_thread, const float* xyz, const uint8_t* valid,
                     int32_t* out, int b, int n, int k, int cluster,
                     int* active, cudaStream_t stream) {
  if constexpr (P > kMaxPerThread) {
    return cudaErrorInvalidValue;
  } else {
    if (per_thread == P) {
      return run<P>(xyz, valid, out, b, n, k, cluster, active, stream);
    }
    return dispatch<P + 1>(per_thread, xyz, valid, out, b, n, k, cluster,
                           active, stream);
  }
}

bool plan_ok(int cluster, int per_thread) {
  return (cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16) &&
         per_thread >= 1 && per_thread <= kMaxPerThread;
}

}  // namespace

// xyz (b, n, 3) f32, valid (b, n) bool as bytes → out (b, k) int32; a
// cluster of `cluster` CTAs of kThreads threads per sample, `per_thread`
// points a thread (cluster x kThreads x per_thread >= n).
DM_EXPORT int dm_fps(const float* xyz, const uint8_t* valid, int32_t* out,
                     int b, int n, int k, int cluster, int per_thread,
                     cudaStream_t stream) {
  if (b < 0 || n <= 0 || k <= 0 || !plan_ok(cluster, per_thread) ||
      static_cast<int64_t>(cluster) * kThreads * per_thread < n ||
      static_cast<int64_t>(b) * cluster > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  if (b == 0) return cudaSuccess;
  return dispatch<1>(per_thread, xyz, valid, out, b, n, k, cluster, nullptr,
                     stream);
}

// How many clusters of this plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *active.
DM_EXPORT int dm_fps_active_clusters(int cluster, int per_thread,
                                     int* active) {
  if (!plan_ok(cluster, per_thread)) return cudaErrorInvalidValue;
  return dispatch<1>(per_thread, nullptr, nullptr, nullptr, 1, 1, 1, cluster,
                     active, nullptr);
}
