// The time-major reverse wavefront scan of the analytic adjoint, for Hopper
// (sm_90a).
//
// Replaces ddr_tpu/routing/pallas_kernel.py::fused_reverse_scan together
// with the reverse streams around it (_reverse_stream and _unskew_reverse,
// ddr_tpu/routing/wavefront.py:299-316, 469): the backward of the forward
// wave scan (wave_scan.cu) is a wavefront over the TRANSPOSED network run in
// reverse time. Its plain version is reverse_scan_tm_reference in
// ddr_tpu_torch/routing/reverse_kernel.py; AnalyticRoute.backward in
// ddr_tpu_torch/routing/wavefront.py computes its four (B, T, .) inputs.
//
// Per reverse wave v = 1..W (W = T + depth) every pair (b, i) whose
// in-flight timestep t = T - v + depth - level[i] lies in [0, T) reads
//   g_k   = ring[(v - 1 - t_row[k]) mod R][t_col[k]]   (successors' lam)
//   zsum  = sum_k zce[b, t, k] * g_k,  dusum = sum_k duce[b, t, k] * g_k
//   lam   = gbar[b, t, i] + gx[i] + zsum
//   gx[i] = ow[b, t, i] * lam + dusum
// over its t_width slots k = i * t_width + j, and lam goes to ring row
// v % R and to lam_all[b, t, i]. The pairs in band at wave v form a few
// contiguous ranges of i (wave_scan.cu); the caller passes them as the same
// kind of table, built from depth - level. Only those pairs are visited.
//
// What bounds it on the H100: bytes, in principle. Each in-band pair reads
// gbar, ow and t_width slots each of zce and duce and writes lam:
// 4 * B * T * n * (3 + 2 * t_width) bytes, 0.31 GB at the training shape
// (T = 240, n = 65,536, t_width = 1), ~0.1 ms at 3.35 TB/s. Below that lies
// what sets its time in practice, as for the forward scan: W sequential
// waves, each ending in a grid barrier, each a chain of dependent loads per
// pair (successor table -> ring) that reads ring rows other blocks wrote in
// earlier waves. As in wave_scan.cu, one pair a thread at a time on a grid
// of one thread a pair of the widest wave (at most co-resident), held to 64
// registers a thread, the successor slots
// fetched four at a time (every table entry, then every ring value), the
// level, gx and the seed loads issued first, and the next wave's run table
// row loaded during this wave.
//
// The ring (B, R, n + 1) lives in device memory, zeroed once by the
// wrapper; column n is the zero sentinel that pad slots read. Only in-band
// pairs write it, which is exact for the reason wave_scan.cu gives: a real
// successor slot of reach i reads successor j at ring distance level[j] -
// level[i], i.e. j's lam at i's own timestep, written in band; a pad slot
// reads the sentinel. gx and the ring are read past L1 (__ldcg) and written
// through to L2 (__stcg), since a reach's pair moves between threads from
// wave to wave. Each node sums its own t_width slots in slot order, without
// atomics, and the build has no FMA contraction (--fmad=false).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM holds: at most 64 registers a thread
constexpr int kSlotBatch = 4;  // slots whose loads are in flight together

struct ReverseScanParams {
  const float* gbar;   // (B, T, n) cotangent seed
  const float* ow;     // (B, T, n) own-channel push weight
  const float* zce;    // (B, T, n t_width) transposed-solve weight per successor slot
  const float* duce;   // (B, T, n t_width) inflow-adjoint weight per successor slot
  float* lam;          // (B, T, n) out
  float* ring;         // (B, R, n + 1) scratch, zeroed by the caller
  float* gx;           // (B, n) carried own-channel push, zeroed by the caller
  const int* runs;     // (W, 2K + 1) in-band ranges per reverse wave
  const int* lvl;      // (n,) level per node, wf order
  const int* t_row;    // (n t_width,) ring row distance - 1 per successor slot
  const int* t_col;    // (n t_width,) ring column per slot (n = sentinel)
  int B, T, n, W, R, K, depth, t_width;
};

// Pair j of a wave -> (request b, its index r among the wave's `count`
// nodes), in 32-bit arithmetic where the wave's pairs fit.
__device__ __forceinline__ void split_pair(long long j, int count, bool narrow, int& b, int& r) {
  if (narrow) {
    const unsigned jj = static_cast<unsigned>(j), c = static_cast<unsigned>(count);
    b = static_cast<int>(jj / c);
    r = static_cast<int>(jj - static_cast<unsigned>(b) * c);
  } else {
    b = static_cast<int>(j / count);
    r = static_cast<int>(j - static_cast<long long>(b) * count);
  }
}

// Pair r of a wave's ranges -> node index.
__device__ __forceinline__ int run_node(const int* s_runs, int K, int r) {
  const int* off = s_runs + K;
  int k = 0;
  while (r >= off[k + 1]) ++k;
  return s_runs[k] + (r - off[k]);
}

// Entry threadIdx.x of run table row v (0 past the table); see wave_scan.cu.
__device__ __forceinline__ int runs_entry(const int* runs, int v, int W, int len) {
  return (v <= W && static_cast<int>(threadIdx.x) < len)
             ? __ldg(runs + static_cast<size_t>(v - 1) * len + threadIdx.x)
             : 0;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) reverse_scan_tm_kernel(ReverseScanParams p) {
  extern __shared__ int s_runs[];
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t row_len = static_cast<size_t>(p.n) + 1;
  const size_t ring_b_len = static_cast<size_t>(p.R) * row_len;
  const size_t e_t = static_cast<size_t>(p.n) * p.t_width;
  const int len = 2 * p.K + 1;

  int entry = runs_entry(p.runs, 1, p.W, len);
  for (int v = 1; v <= p.W; ++v) {
    if (static_cast<int>(threadIdx.x) < len) s_runs[threadIdx.x] = entry;
    __syncthreads();
    entry = runs_entry(p.runs, v + 1, p.W, len);  // in flight during the wave
    const int count = s_runs[2 * p.K];
    const long long pairs = static_cast<long long>(p.B) * count;
    const bool narrow = pairs <= 0x7fffffffLL;
    const int h1 = (v - 1) % p.R;  // row of wave v - 1's output
    const int h = v % p.R;         // this wave's row
    for (long long j = first; j < pairs; j += stride) {
      int b, i;
      split_pair(j, count, narrow, b, i);
      i = run_node(s_runs, p.K, i);
      const size_t own = static_cast<size_t>(b) * p.n + i;
      const float* const ring_b = p.ring + b * ring_b_len;
      // independent loads first: the level and the carried gx
      const int t = p.T - v + p.depth - __ldg(p.lvl + i);
      const float carried = __ldcg(p.gx + own);
      const int k0 = i * p.t_width, k1 = k0 + p.t_width;
      int at[kSlotBatch];
      float g[kSlotBatch];
      float zs = 0.0f, ds = 0.0f;
      const size_t bt = static_cast<size_t>(b) * p.T + t;
      for (int k = k0; k < k1; k += kSlotBatch) {
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          if (k + u < k1) {
            int rot = h1 - __ldg(p.t_row + k + u);
            if (rot < 0) rot += p.R;
            at[u] = rot * static_cast<int>(row_len) + __ldg(p.t_col + k + u);
          }
        }
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          if (k + u < k1) g[u] = __ldcg(ring_b + at[u]);
        }
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {  // slot order
          if (k + u < k1) {
            zs += __ldg(p.zce + bt * e_t + k + u) * g[u];
            ds += __ldg(p.duce + bt * e_t + k + u) * g[u];
          }
        }
      }
      const float lam = __ldg(p.gbar + bt * p.n + i) + carried + zs;
      __stcg(p.gx + own, __ldg(p.ow + bt * p.n + i) * lam + ds);
      __stcg(p.ring + b * ring_b_len + h * row_len + i, lam);
      p.lam[bt * p.n + i] = lam;
    }
    grid.sync();
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream` and returns the launch's cudaError_t (0 on
// success). `max_pairs` is B times the widest wave's count. Does not
// synchronise; faults during the run surface at the caller's next
// synchronisation.
int ddr_reverse_scan_tm(const float* gbar, const float* ow, const float* zce, const float* duce,
                        float* lam, float* ring, float* gx, const int* runs, const int* lvl,
                        const int* t_row, const int* t_col, int B, int T, int n, int W, int R,
                        int K, int depth, int t_width, long long max_pairs, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(K) + 1);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reverse_scan_tm_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  long long blocks = (max_pairs + kThreads - 1) / kThreads;  // a thread a pair, at most
  if (blocks > static_cast<long long>(per_sm) * sms) blocks = static_cast<long long>(per_sm) * sms;
  if (blocks < 1) blocks = 1;

  ReverseScanParams p{gbar, ow,  zce,   duce, lam, ring, gx, runs, lvl,   t_row,
                      t_col, B,  T,     n,    W,   R,    K,  depth, t_width};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(reverse_scan_tm_kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* ddr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
