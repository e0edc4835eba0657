// The time-major forward wavefront scan of Muskingum-Cunge routing, for
// Hopper (sm_90a).
//
// Replaces ddr_tpu/routing/pallas_kernel.py::fused_wave_scan together with
// the skews around it (ddr_tpu/routing/wavefront.py:149-175, 343): it reads
// q' (B, T, n) and the optional external rows x_ext/s_ext (B, T, n) at each
// node's in-flight timestep and writes the raw solve raw (B, T, n), wf or
// band-slot order, pre-clamp. One entry point serves every variant:
// * the single-ring engine: no external rows (xe = se = nullptr),
//   mask_raw = 0;
// * a band of the stacked band router (ddr_tpu/routing/stacked.py:409):
//   external rows xe/se (the raw and clamped inflow sums of predecessors in
//   earlier bands) and mask_raw = 1 (the raw sum multiplies each slot by its
//   mask, pallas_kernel.py:184-185);
// * a band of the unrolled depth-chunked router: its own ring, xe/se,
//   mask_raw = 0;
// * each of them with the ring stored in fp32 (ring_bf16 = 0) or in bfloat16
//   (ring_bf16 = 1, compute_dtype="bf16", pallas_kernel.py:49-65): every ring
//   load is upcast to fp32 before any arithmetic, x_pred, s_next and the
//   carried s accumulate in fp32, and y is rounded once, to nearest even, at
//   the ring store; raw carries that rounded value upcast.
// Its plain version is wave_scan_tm_reference in
// ddr_tpu_torch/routing/wave_kernel.py, which also documents the recurrence.
//
// Per wave w = 1..W (W = T + depth) reach i is in band when its timestep
// t = w - 1 - level[i] lies in [0, T). In wf order (bucket, level, id) or
// band-slot order (width rank, level) those reaches form a few contiguous
// ranges, at most one per gather bucket. The caller passes them as a table
// `runs` (W rows of 2K + 1 ints: K range starts, then the K + 1 cumulative
// range lengths, the last being the wave's count), built once per network
// and T on the host. The kernel visits only those B * count pairs a wave.
//
// What bounds it on the H100: below its bytes (q', xe and se read and raw
// written once per in-band pair: 4 * B * T * n * (2 + 2 ext) bytes, 151 MB of
// raw at B 8, T 72, n 65,536) lies the floor of W sequential waves, each
// ending in a grid barrier (1.1 us on up to 132 blocks, 1.7 us on 528), each
// reading ring rows other blocks wrote in earlier waves. Within a wave the
// cost is the latency of each pair's chain of dependent loads (slot table ->
// ring -> sums) and its MC chain, and the number of pairs the card keeps in
// flight, so the design shortens the chain and maximises the pairs in
// flight:
// * only in-band pairs are visited, one per thread at a time, and their
//   reads and writes of q', xe, se and raw are contiguous in i within a
//   range of one level (coalesced);
// * one thread for each pair of the widest wave, at most a co-resident
//   grid, and the kernel holds to 64 registers (four blocks of 256 threads
//   an SM): more pairs in flight beat several pairs a thread, whose
//   registers halve the blocks an SM holds, and a grid no larger than the
//   widest wave keeps the barrier cheap;
// * a node's first slot and slot count follow from its gather bucket (the
//   bucket table sits in shared memory), so the chain starts at the slot
//   table; the slots are fetched four at a time, every table entry, then
//   every ring value, before any is summed; the reach's own ring value, its
//   carried s and its constants are loaded at once, so its MC chain runs
//   while the slots' loads are in flight;
// * what depends only on the reach (sqrt(slope), pw * sqrt(slope) + 1e-8,
//   the depth exponent, 1 / n, q_spatial + 1e-6 and its + 1, 1 - x) is
//   computed once per scan by reach_consts_kernel into 12 floats a reach,
//   by exactly the operations the chain used inline, so the results are
//   unchanged bit for bit (the build has no FMA contraction);
// * the next wave's run table row is loaded during this wave.
//
// The ring (B, R, n + 1) lives in device memory, zeroed once by the
// wrapper; column n is the always-zero sentinel that pad slots read. Only
// in-band pairs write the ring: a column keeps its last in-band values after
// its reach leaves the band. That is exact because no in-band pair ever
// reads such a value: a real slot of reach i (mask 1) reads predecessor p
// at ring distance gap = level[i] - level[p], i.e. p's value at i's own
// timestep t, written in band; a pad slot (mask 0) reads the sentinel; the
// own column at t >= 1 holds i's value at t - 1. Before its band a column
// was never written and is zero, which is what the t = 0 pair reads as
// q_prev (and does not use). The wrapper checks these table properties
// once per network (wave_kernel.py, active_runs), so a poisoned value
// (NaN) left in a column cannot reach a masked slot as 0 * NaN.
//
// Pairs of one reach are owned by different threads from wave to wave, so
// the carried state s[b][i] and the ring are read past L1 (__ldcg) and
// written through to L2 (__stcg): grid.sync() orders the writes, but a
// stale L1 line could still serve an old value. One barrier per wave
// suffices: wave w reads ring rows w - gap for gap in [1, R - 1] and writes
// row w % R, never one of them. Each reach sums its own slots in slot order
// without atomics, for both the raw x_pred and the clamped s_next.
// The MC physics is hard-coded (trapezoidal velocity -> celerity ->
// Muskingum c1..c4), op for op as in the plain version. wgmma has no place
// here: there is no matrix product.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM holds: at most 64 registers a thread
constexpr int kSlotBatch = 4;  // slots whose loads are in flight together

struct WaveScanParams {
  const float* qp;        // (B, T, n) lateral inflow
  float* raw;             // (B, T, n) raw solve values, out
  void* ring;             // (B, R, n + 1) float or bf16 scratch, zeroed by the caller
  float* s;               // (B, n) carried clamped inflow sum, scratch
  const float* xe;        // (B, T, n) external raw inflow sums, or nullptr
  const float* se;        // (B, T, n) external clamped inflow sums, or nullptr
  const int* runs;        // (W, 2K + 1) in-band ranges per wave
  const int* lvl;         // (n,) level per node, wf order
  const int* buckets;     // (nb, 4) gather buckets: first node, end node, width, first slot
  const int* wf_row;      // (E,) ring row distance - 1 per slot
  const int* wf_col;      // (E,) ring column per slot (n = sentinel)
  const float* wf_mask;   // (E,) 1 for real slots, 0 for pad slots
  const float* q_init;    // (B, n) or nullptr (in-band hotstart)
  const float4* consts;   // (n, 3) packed per-reach constants (reach_consts_kernel)
  float depth_lb, bottom_width_lb, velocity_lb, discharge_lb, dt;
  int B, T, n, W, R, K, nb;
  int mask_raw;           // 1: the raw sum multiplies each slot by its mask
};

// NaN-propagating max/min, as torch.maximum / jnp.maximum (fmaxf drops NaN).
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }

// The reach's constants of the MC chain, each by the operations the chain
// used inline: {q_eps, q_eps + 1, n, pw * sqrt(slope) + 1e-8},
// {depth exponent, pw, 1 / n, sqrt(slope)}, {x, 1 - x, length, 0}.
__global__ void reach_consts_kernel(const float* __restrict__ n_mann,
                                    const float* __restrict__ p_spatial,
                                    const float* __restrict__ q_spatial,
                                    const float* __restrict__ slope,
                                    const float* __restrict__ length,
                                    const float* __restrict__ x_storage, float4* __restrict__ out,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float nm = n_mann[i];
  const float pw = p_spatial[i];
  const float sqrt_slope = sqrtf(slope[i]);
  const float q_eps = q_spatial[i] + 1e-6f;
  const float denominator = pw * sqrt_slope;
  const float x = x_storage[i];
  out[3 * i] = make_float4(q_eps, q_eps + 1.0f, nm, denominator + 1e-8f);
  out[3 * i + 1] = make_float4(3.0f / (5.0f + 3.0f * q_eps), pw, 1.0f / nm, sqrt_slope);
  out[3 * i + 2] = make_float4(x, 1.0f - x, length[i], 0.0f);
}

// trapezoidal_geometry's velocity -> celerity -> muskingum_coefficients, from
// the reach's constants a, b, e (reach_consts_kernel).
__device__ __forceinline__ void mc_coefficients(const WaveScanParams& p, float4 a, float4 b,
                                                float4 e, float q, float& c1, float& c2,
                                                float& c3, float& c4) {
  const float q_eps = a.x, n = a.z, pw = b.y, sqrt_slope = b.w;
  const float numerator = q * n * a.y;
  const float depth = max_nan(powf(numerator / a.w, b.x), p.depth_lb);
  const float top_width = pw * powf(depth, q_eps);
  const float side_slope = min_nan(max_nan(top_width * q_eps / (2.0f * depth), 0.5f), 50.0f);
  const float bottom_width = max_nan(top_width - 2.0f * side_slope * depth, p.bottom_width_lb);
  const float area = (top_width + bottom_width) * depth / 2.0f;
  const float wetted = bottom_width + 2.0f * depth * sqrtf(1.0f + side_slope * side_slope);
  const float radius = area / wetted;
  const float velocity = b.z * powf(radius, 2.0f / 3.0f) * sqrt_slope;
  const float c = min_nan(max_nan(velocity, p.velocity_lb), 15.0f) * (5.0f / 3.0f);

  const float x = e.x;
  const float k = e.z / c;
  const float denom = 2.0f * k * e.y + p.dt;
  c1 = (p.dt - 2.0f * k * x) / denom;
  c2 = (p.dt + 2.0f * k * x) / denom;
  c3 = (2.0f * k * e.y - p.dt) / denom;
  c4 = 2.0f * p.dt / denom;
}

// Ring element access: a load through L2 only, upcast to fp32, and the one
// rounding point of a store, written through to L2. The fp32 versions are
// the identity.
__device__ __forceinline__ float ring_load(const float* a) { return __ldcg(a); }
__device__ __forceinline__ float ring_load(const __nv_bfloat16* a) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(a))));
}
__device__ __forceinline__ float ring_store(float* a, float y) {
  __stcg(a, y);
  return y;
}
__device__ __forceinline__ float ring_store(__nv_bfloat16* a, float y) {
  const __nv_bfloat16 r = __float2bfloat16_rn(y);  // round to nearest even, as .to(bfloat16)
  __stcg(reinterpret_cast<unsigned short*>(a), __bfloat16_as_ushort(r));
  return __bfloat162float(r);
}

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

// Entry threadIdx.x of run table row w (0 past the table): each thread of a
// block holds at most one entry (the wrapper checks 2K + 1 <= kThreads), so
// the next wave's row is loaded during this wave and only stored to shared
// memory after the barrier.
__device__ __forceinline__ int runs_entry(const int* runs, int w, int W, int len) {
  return (w <= W && static_cast<int>(threadIdx.x) < len)
             ? __ldg(runs + static_cast<size_t>(w - 1) * len + threadIdx.x)
             : 0;
}

// Node i's run of gather slots [k0, k1), from the bucket table in shared
// memory (nodes before the first bucket have no slots).
__device__ __forceinline__ void node_slots(const int* s_bk, int nb, int i, int& k0, int& k1) {
  k0 = k1 = 0;
  for (int k = 0; k < nb; ++k) {
    const int* bk = s_bk + 4 * k;
    if (i >= bk[0] && i < bk[1]) {
      k0 = bk[3] + (i - bk[0]) * bk[2];
      k1 = k0 + bk[2];
    }
  }
}

template <typename RingT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) wave_scan_tm_kernel(WaveScanParams p) {
  extern __shared__ int s_mem[];  // the bucket table, then the wave's run table row
  int* const s_bk = s_mem;
  int* const s_runs = s_mem + 4 * p.nb;
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t row_len = static_cast<size_t>(p.n) + 1;
  const size_t ring_b_len = static_cast<size_t>(p.R) * row_len;
  const int tq_max = p.T >= 2 ? p.T - 2 : 0;
  const int len = 2 * p.K + 1;
  const float lb = p.discharge_lb;
  RingT* const ring = static_cast<RingT*>(p.ring);
  for (int k = threadIdx.x; k < 4 * p.nb; k += blockDim.x) s_bk[k] = __ldg(p.buckets + k);

  int entry = runs_entry(p.runs, 1, p.W, len);
  for (int w = 1; w <= p.W; ++w) {
    if (static_cast<int>(threadIdx.x) < len) s_runs[threadIdx.x] = entry;
    __syncthreads();
    entry = runs_entry(p.runs, w + 1, p.W, len);  // in flight during the wave
    const int count = s_runs[2 * p.K];
    const long long pairs = static_cast<long long>(p.B) * count;
    const bool narrow = pairs <= 0x7fffffffLL;
    const int h1 = (w - 1) % p.R;  // row of wave w - 1's output
    const int h = w % p.R;         // this wave's row
    for (long long j = first; j < pairs; j += stride) {
      int b, i;
      split_pair(j, count, narrow, b, i);
      i = run_node(s_runs, p.K, i);
      const size_t own = static_cast<size_t>(b) * p.n + i;
      RingT* const ring_b = ring + b * ring_b_len;
      // independent loads first: the level, the own ring value, the carried
      // s and the reach's constants
      const int t = w - 1 - __ldg(p.lvl + i);
      const float q_prev_raw = ring_load(ring_b + h1 * row_len + i);
      const float s_prev = __ldcg(p.s + own);
      const float4 ca = __ldg(p.consts + 3 * i);
      const float4 cb = __ldg(p.consts + 3 * i + 1);
      const float4 ce = __ldg(p.consts + 3 * i + 2);
      int k0, k1;
      node_slots(s_bk, p.nb, i, k0, k1);
      float xp = 0.0f, sn = 0.0f;
      for (int k = k0; k < k1; k += kSlotBatch) {
        int at[kSlotBatch];
        float m[kSlotBatch], v[kSlotBatch];
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          if (k + u < k1) {
            int rot = h1 - __ldg(p.wf_row + k + u);
            if (rot < 0) rot += p.R;
            at[u] = rot * static_cast<int>(row_len) + __ldg(p.wf_col + k + u);
            m[u] = __ldg(p.wf_mask + k + u);
          }
        }
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          if (k + u < k1) v[u] = ring_load(ring_b + at[u]);
        }
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {  // slot order
          if (k + u < k1) {
            if (p.mask_raw) {
              xp += v[u] * m[u];
            } else {
              xp += v[u];
            }
            sn += max_nan(v[u], lb) * m[u];
          }
        }
      }
      const size_t out = (static_cast<size_t>(b) * p.T + t) * p.n + i;
      const int tq = min(max(t - 1, 0), tq_max);
      const float q_row = __ldg(p.qp + (static_cast<size_t>(b) * p.T + tq) * p.n + i);
      if (p.xe != nullptr) xp += __ldg(p.xe + out);
      float y;
      if (t == 0) {  // hotstart diagonal: (I - N) q0 = q'_0, or the carried state
        y = p.q_init != nullptr ? max_nan(__ldg(p.q_init + own), lb) : q_row + 1.0f * xp;
      } else {
        const float q_prev = max_nan(q_prev_raw, lb);
        float c1, c2, c3, c4;
        mc_coefficients(p, ca, cb, ce, q_prev, c1, c2, c3, c4);
        const float s_in = p.se != nullptr ? s_prev + __ldg(p.se + out) : s_prev;
        const float b_step = c2 * s_in + c3 * q_prev + c4 * max_nan(q_row, lb);
        y = b_step + c1 * xp;
      }
      p.raw[out] = ring_store(ring_b + h * row_len + i, y);
      __stcg(p.s + own, sn);
    }
    grid.sync();
  }
}

// An empty scan: W grid barriers and nothing else, the floor under the scan.
__global__ void __launch_bounds__(kThreads) barrier_kernel(int waves) {
  cg::grid_group grid = cg::this_grid();
  for (int w = 0; w < waves; ++w) grid.sync();
}

// Blocks of kThreads for a cooperative launch of `kernel`: one thread for
// each of the widest wave's `max_pairs` pairs, at most co-residency (a grid
// barrier costs 1.1 us on up to 132 blocks, 1.7 us on 528).
cudaError_t grid_blocks(const void* kernel, size_t smem, long long max_pairs, int device,
                        int* blocks) {
  cudaError_t err;
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  long long want = (max_pairs + kThreads - 1) / kThreads;
  if (want > static_cast<long long>(per_sm) * sms) want = static_cast<long long>(per_sm) * sms;
  *blocks = want > 0 ? static_cast<int>(want) : 1;
  return cudaSuccess;
}

template <typename RingT>
cudaError_t launch(WaveScanParams p, const float* n_mann, const float* p_spatial,
                   const float* q_spatial, const float* slope, const float* length,
                   const float* x_storage, long long max_pairs, int device,
                   cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(wave_scan_tm_kernel<RingT>);
  const size_t smem = sizeof(int) * (4 * static_cast<size_t>(p.nb) + 2 * p.K + 1);
  int blocks = 0;
  cudaError_t err = grid_blocks(kernel, smem, max_pairs, device, &blocks);
  if (err != cudaSuccess) return err;
  if (p.n > 0) {
    reach_consts_kernel<<<(p.n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        n_mann, p_spatial, q_spatial, slope, length, x_storage, const_cast<float4*>(p.consts), p.n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the scan on `stream` and returns the launch's cudaError_t (0 on
// success). `ring` holds float (ring_bf16 = 0) or __nv_bfloat16 (ring_bf16 =
// 1) elements; any other ring_bf16 is refused. `buckets` is the (nb, 4)
// bucket table; `consts` is scratch of n * 12 floats; `max_pairs` is B times
// the widest wave's count. Does not synchronise; faults during the run
// surface at the caller's next synchronisation.
int ddr_wave_scan_tm(const float* qp, float* raw, void* ring, float* s, const float* xe,
                     const float* se, const int* runs, const int* lvl, const int* buckets,
                     const int* wf_row, const int* wf_col, const float* wf_mask,
                     const float* q_init, float* consts, const float* n_mann,
                     const float* p_spatial, const float* q_spatial, const float* slope,
                     const float* length, const float* x_storage, float depth_lb,
                     float bottom_width_lb, float velocity_lb, float discharge_lb, float dt, int B,
                     int T, int n, int W, int R, int K, int nb, long long max_pairs,
                     int mask_raw, int ring_bf16, int device, void* stream) {
  if (ring_bf16 != 0 && ring_bf16 != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  WaveScanParams p{qp,      raw,       ring,    s,      xe,     se,
                   runs,    lvl,       buckets, wf_row, wf_col, wf_mask,
                   q_init,  reinterpret_cast<const float4*>(consts),
                   depth_lb, bottom_width_lb, velocity_lb, discharge_lb, dt,
                   B,       T,         n,       W,      R,      K,      nb,
                   mask_raw};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ring_bf16 ? launch<__nv_bfloat16>(p, n_mann, p_spatial, q_spatial, slope, length,
                                           x_storage, max_pairs, device, st)
                   : launch<float>(p, n_mann, p_spatial, q_spatial, slope, length, x_storage,
                                   max_pairs, device, st);
}

// Launches `waves` grid barriers and nothing else on the grid the fp32
// scan takes for a widest wave of `max_pairs` pairs (the block count is
// written to *blocks): the scan's floor.
int ddr_wave_barrier(int waves, long long max_pairs, int device, void* stream, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(int) * 3;  // a one-range run table
  err = grid_blocks(reinterpret_cast<const void*>(wave_scan_tm_kernel<float>), smem, max_pairs,
                    device, blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&waves};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_kernel),
                                    dim3(static_cast<unsigned>(*blocks)), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* ddr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
