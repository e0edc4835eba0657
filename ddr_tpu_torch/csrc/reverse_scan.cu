// The reverse wavefront scan of the analytic adjoint, for Hopper (sm_90a).
//
// Replaces ddr_tpu/routing/pallas_kernel.py::fused_reverse_scan: the backward
// of the forward wave scan (wave_scan.cu) is a wavefront over the TRANSPOSED
// network run in reverse time. Its plain version is reverse_scan_reference in
// ddr_tpu_torch/routing/reverse_kernel.py, and the streams it reads are built
// by ddr_tpu_torch/routing/wavefront.py's AnalyticRoute.backward.
//
// Per reverse wave v = 1..W (W = T + depth) every pair (b, i) whose in-flight
// timestep t = T - v + depth - level[i] lies in [0, T-1]:
//   g_k   = ring[(v - 1 - t_row[k]) mod R][t_col[k]]   (successors' lam)
//   zsum  = sum_k zce[k] * g_k,  dusum = sum_k duce[k] * g_k
//   lam   = gbar[i] + gx[i] + zsum
//   gx[i] = ow[i] * lam + dusum
// and lam goes to ring row v % R and to lams[v-1]. Out-of-band pairs write
// lam = 0 to both and leave gx alone: the streams are zero there, so the
// recurrence would give 0 too, and nothing in band reads those values.
//
// What bounds it on the H100: bytes, in principle. Each reach reads its T
// in-band rows of the four streams (gbar, ow, and t_width slots each of zce
// and duce) and writes T lams: 4 * T * n * (3 + 2 * t_width) bytes, 0.31 GB
// at the training shape (T = 240, n = 65,536, t_width = 1), ~0.1 ms at
// 3.35 TB/s. The arithmetic is 5 + 4 * t_width operations a pair. Below both
// lies the floor that sets its time in practice, as for the forward scan: W
// sequential waves, each ending in a grid barrier, each reading ring rows
// other blocks wrote in earlier waves.
//
// Design, as wave_scan.cu's, simple and right first:
// * ONE cooperative launch per scan, the grid sized to co-residency, threads
//   walking the (b, i) pairs grid-stride with the same mapping every wave,
//   and one grid.sync() per wave. One barrier suffices: wave v reads ring rows
//   v - gap with gap in [1, R-2] and writes row v % R, never one of them, and
//   only the owning thread touches gx[b][i].
// * The ring (B, R, n+1) lives in device memory, zeroed once by the wrapper.
//   Column n is the zero sentinel that pad slots read and is never written.
//   Ring loads bypass L1 (__ldcg): other SMs rewrite the rows.
// * Each node sums its own t_width slots in slot order, without atomics, and
//   the build has no FMA contraction (--fmad=false): the sums round as the
//   plain version's do.
// * The streams keep the JAX package's layout, one row per wave:
//   [gbar (n) | ow (n) | zce (n * t_width) | duce (n * t_width)], edge blocks
//   node-major, with a leading batch axis.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct ReverseScanParams {
  const float* rows;   // (B, W, 2n + 2 n t_width) reverse streams
  float* lams;         // (B, W, n) out
  float* ring;         // (B, R, n + 1) scratch, zeroed by the caller
  float* gx;           // (B, n) carried own-channel push, zeroed by the caller
  const int* lvl;      // (n,) level per node, wf order
  const int* t_row;    // (n t_width,) ring row distance - 1 per successor slot
  const int* t_col;    // (n t_width,) ring column per slot (n = sentinel)
  int B, T, n, W, R, depth, t_width;
};

__global__ void __launch_bounds__(kThreads) reverse_scan_kernel(ReverseScanParams p) {
  cg::grid_group grid = cg::this_grid();
  const long long pairs = static_cast<long long>(p.B) * p.n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t row_len = static_cast<size_t>(p.n) + 1;
  const size_t e_t = static_cast<size_t>(p.n) * p.t_width;
  const size_t width_all = 2 * static_cast<size_t>(p.n) + 2 * e_t;

  for (int v = 1; v <= p.W; ++v) {
    const int h1 = (v - 1) % p.R;  // row of wave v - 1's output
    const int h = v % p.R;         // this wave's row
    for (long long idx = first; idx < pairs; idx += stride) {
      const int b = static_cast<int>(idx / p.n);
      const int i = static_cast<int>(idx - static_cast<long long>(b) * p.n);
      float* ring_b = p.ring + static_cast<size_t>(b) * p.R * row_len;
      const size_t out = (static_cast<size_t>(b) * p.W + (v - 1)) * p.n + i;
      const int t = p.T - v + p.depth - p.lvl[i];
      if (t < 0 || t >= p.T) {
        ring_b[h * row_len + i] = 0.0f;
        p.lams[out] = 0.0f;
        continue;
      }
      const float* row = p.rows + (static_cast<size_t>(b) * p.W + (v - 1)) * width_all;
      const float* zce = row + 2 * static_cast<size_t>(p.n);
      const float* duce = zce + e_t;
      float zsum = 0.0f, dusum = 0.0f;
      const int k0 = i * p.t_width;
      for (int k = k0; k < k0 + p.t_width; ++k) {
        int rot = h1 - p.t_row[k];
        if (rot < 0) rot += p.R;
        const float g = __ldcg(ring_b + rot * row_len + p.t_col[k]);
        zsum += zce[k] * g;
        dusum += duce[k] * g;
      }
      float* gx = p.gx + static_cast<size_t>(b) * p.n + i;
      const float lam = row[i] + *gx + zsum;
      *gx = row[p.n + i] * lam + dusum;
      ring_b[h * row_len + i] = lam;
      p.lams[out] = lam;
    }
    grid.sync();
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream` and returns the launch's cudaError_t (0 on
// success). Does not synchronise; faults during the run surface at the
// caller's next synchronisation.
int ddr_reverse_scan(const float* rows, float* lams, float* ring, float* gx, const int* lvl,
                     const int* t_row, const int* t_col, int B, int T, int n, int W, int R,
                     int depth, int t_width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reverse_scan_kernel, kThreads,
                                                           0)) != cudaSuccess)
    return err;
  const long long pairs = static_cast<long long>(B) * n;
  long long blocks = (pairs + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;

  ReverseScanParams p{rows, lams, ring, gx, lvl, t_row, t_col, B, T, n, W, R, depth, t_width};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(reverse_scan_kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* ddr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
