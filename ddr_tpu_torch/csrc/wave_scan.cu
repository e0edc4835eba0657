// The forward wavefront scan of Muskingum-Cunge routing, for Hopper (sm_90a).
//
// Replaces ddr_tpu/routing/pallas_kernel.py::fused_wave_scan with optional
// q_init, in the variants of one entry point:
// * the single-ring engine: no external-inflow rows (xe = se = nullptr),
//   mask_raw = 0;
// * a band of the stacked band router (ddr_tpu/routing/stacked.py:409):
//   external rows xe/se (pre-skewed (B, W, n), the raw and clamped inflow
//   sums of predecessors in earlier bands) and mask_raw = 1 (the raw sum
//   multiplies each slot by its mask, pallas_kernel.py:184-185);
// * either of them with the ring stored in fp32 (ring_bf16 = 0) or in
//   bfloat16 (ring_bf16 = 1, compute_dtype="bf16", pallas_kernel.py:49-65):
//   every ring load is upcast to fp32 before any arithmetic, x_pred, s_next
//   and the carried s accumulate in fp32, and y is rounded once, to nearest
//   even, at the ring store; ys carries that rounded value upcast.
// The ring type is a template parameter: the fp32 instantiation runs the
// same operations as before the bf16 one existed, and with xe = se =
// nullptr and mask_raw = 0 the ones the single-ring kernel did before the
// band variant. Its plain version is wave_scan_reference in
// ddr_tpu_torch/routing/wave_kernel.py, which also documents the recurrence.
//
// What bounds it on the H100: bytes. The pre-skewed qs and ys are (B, W, n)
// float32 with W = T + depth, but each reach is in its valid band for only T
// of the W waves, so the scan needs to read B * T * n * 4 bytes of qs and
// write as many of ys (151 MB each at B = 8, T = 72, n = 65,536). This
// version still writes the out-of-band zeros of ys, B * W * n * 4 bytes in
// all (1.23 GB). A band counts the same way at n = n_cap and W = T +
// span_max, plus its in-band xe and se rows read once. The ring's recent
// rows stay in the 50 MB L2. Below that lies
// a floor of W grid barriers: the waves are sequential and every wave reads
// rows other blocks wrote in the previous waves.
//
// Design, simple and right first:
// * ONE cooperative launch per scan, with the grid sized to co-residency;
//   threads walk the (b, i) pairs grid-stride and cooperative_groups'
//   grid.sync() runs once per wave. One barrier per wave suffices: wave w
//   reads ring rows w - gap for gap in [1, R-2] and writes row w % R, which is
//   never one of them, and only the owning thread touches s[b][i] (the
//   pair-to-thread mapping is the same every wave). A grid that cannot
//   co-reside is refused by the launch, and the error is returned.
// * The ring (B, R, n+1) lives in device memory; the wrapper zeroes it once
//   (bf16 zero is the bit pattern 0x0000). Column n is the always-zero
//   sentinel that pad slots read and is never written. Ring loads bypass L1
//   (__ldcg): rows are rewritten by other SMs. __ldcg has no bf16 overload,
//   so a bf16 slot is loaded as its unsigned short and reinterpreted. The
//   bf16 ring halves only the ring's bytes, which stay in L2 anyway.
// * The MC physics is hard-coded (trapezoidal velocity -> celerity ->
//   Muskingum c1..c4), op for op as in the plain version; built without fast
//   math and without FMA contraction.
// * Each node sums its own slots sequentially in slot order, without atomics,
//   for both the raw x_pred and the clamped s_next: deterministic.
// * Pairs outside the valid (t, level) band (t < 0 or t >= T) only write
//   zeros: nothing reads their ring values or their s, so they skip the
//   physics and the gathers, which leaves T of every W waves' work per reach.
// wgmma has no place here (there is no matrix product). Faster versions lie
// in the barrier cost, ring locality and fusing the input/output skews.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct WaveScanParams {
  const float* qs;        // (B, W, n) pre-skewed lateral inflow
  float* ys;              // (B, W, n) raw solve values, out
  void* ring;             // (B, R, n + 1) float or bf16 scratch, zeroed by the caller
  float* s;               // (B, n) carried clamped inflow sum, zeroed by the caller
  const float* xe;        // (B, W, n) external raw inflow rows, or nullptr
  const float* se;        // (B, W, n) external clamped inflow rows, or nullptr
  const int* lvl;         // (n,) level per node, wf order
  const int* slot;        // (n,) first gather slot per node
  const int* width;       // (n,) gather slot count per node (0: no slots)
  const int* wf_row;      // (E,) ring row distance - 1 per slot
  const int* wf_col;      // (E,) ring column per slot (n = sentinel)
  const float* wf_mask;   // (E,) 1 for real slots, 0 for pad slots
  const float* q_init;    // (B, n) or nullptr (in-band hotstart)
  const float* n_mann;    // (n,) per-reach physics, wf order
  const float* p_spatial;
  const float* q_spatial;
  const float* slope;
  const float* length;
  const float* x_storage;
  float depth_lb, bottom_width_lb, velocity_lb, discharge_lb, dt;
  int B, T, n, W, R;
  int mask_raw;           // 1: the raw sum multiplies each slot by its mask
};

// NaN-propagating max/min, as torch.maximum / jnp.maximum (fmaxf drops NaN).
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }

// trapezoidal_geometry's velocity -> celerity -> muskingum_coefficients.
__device__ __forceinline__ void mc_coefficients(const WaveScanParams& p, int i, float q,
                                                float& c1, float& c2, float& c3, float& c4) {
  const float n = p.n_mann[i];
  const float pw = p.p_spatial[i];
  const float slope = p.slope[i];
  const float q_eps = p.q_spatial[i] + 1e-6f;
  const float numerator = q * n * (q_eps + 1.0f);
  const float denominator = pw * sqrtf(slope);
  const float depth = max_nan(powf(numerator / (denominator + 1e-8f), 3.0f / (5.0f + 3.0f * q_eps)),
                              p.depth_lb);
  const float top_width = pw * powf(depth, q_eps);
  const float side_slope = min_nan(max_nan(top_width * q_eps / (2.0f * depth), 0.5f), 50.0f);
  const float bottom_width = max_nan(top_width - 2.0f * side_slope * depth, p.bottom_width_lb);
  const float area = (top_width + bottom_width) * depth / 2.0f;
  const float wetted = bottom_width + 2.0f * depth * sqrtf(1.0f + side_slope * side_slope);
  const float radius = area / wetted;
  const float velocity = (1.0f / n) * powf(radius, 2.0f / 3.0f) * sqrtf(slope);
  const float c = min_nan(max_nan(velocity, p.velocity_lb), 15.0f) * (5.0f / 3.0f);

  const float x = p.x_storage[i];
  const float k = p.length[i] / c;
  const float denom = 2.0f * k * (1.0f - x) + p.dt;
  c1 = (p.dt - 2.0f * k * x) / denom;
  c2 = (p.dt + 2.0f * k * x) / denom;
  c3 = (2.0f * k * (1.0f - x) - p.dt) / denom;
  c4 = 2.0f * p.dt / denom;
}

// Ring element access: a load through L2 only, upcast to fp32, and the one
// rounding point of a store. The fp32 versions are the identity.
__device__ __forceinline__ float ring_load(const float* a) { return __ldcg(a); }
__device__ __forceinline__ float ring_load(const __nv_bfloat16* a) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(a))));
}
__device__ __forceinline__ void ring_round(float y, float& stored, float& upcast) {
  stored = y;
  upcast = y;
}
__device__ __forceinline__ void ring_round(float y, __nv_bfloat16& stored, float& upcast) {
  stored = __float2bfloat16_rn(y);  // round to nearest even, as astype / .to(bfloat16)
  upcast = __bfloat162float(stored);
}

template <typename RingT>
__global__ void __launch_bounds__(kThreads) wave_scan_kernel(WaveScanParams p) {
  cg::grid_group grid = cg::this_grid();
  const long long pairs = static_cast<long long>(p.B) * p.n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t row_len = static_cast<size_t>(p.n) + 1;
  const float lb = p.discharge_lb;
  RingT* const ring = static_cast<RingT*>(p.ring);

  for (int w = 1; w <= p.W; ++w) {
    const int h1 = (w - 1) % p.R;  // row of wave w - 1's output
    const int h = w % p.R;         // this wave's row
    for (long long idx = first; idx < pairs; idx += stride) {
      const int b = static_cast<int>(idx / p.n);
      const int i = static_cast<int>(idx - static_cast<long long>(b) * p.n);
      RingT* ring_b = ring + static_cast<size_t>(b) * p.R * row_len;
      const size_t out = (static_cast<size_t>(b) * p.W + (w - 1)) * p.n + i;
      const int t = w - 1 - p.lvl[i];
      if (t < 0 || t >= p.T) {
        float zero_up;
        ring_round(0.0f, ring_b[h * row_len + i], zero_up);
        p.ys[out] = 0.0f;
        continue;
      }
      float x_pred = 0.0f, s_next = 0.0f;
      const int k0 = p.slot[i];
      const int k1 = k0 + p.width[i];
      for (int k = k0; k < k1; ++k) {
        int rot = h1 - p.wf_row[k];
        if (rot < 0) rot += p.R;
        const float v = ring_load(ring_b + rot * row_len + p.wf_col[k]);
        if (p.mask_raw) {
          x_pred += v * p.wf_mask[k];
        } else {
          x_pred += v;
        }
        s_next += max_nan(v, lb) * p.wf_mask[k];
      }
      if (p.xe != nullptr) x_pred += p.xe[out];
      const float q_row = p.qs[out];
      float y;
      if (t == 0) {  // hotstart diagonal: (I - N) q0 = q'_0, or the carried state
        y = p.q_init != nullptr ? max_nan(p.q_init[static_cast<size_t>(b) * p.n + i], lb)
                                : q_row + 1.0f * x_pred;
      } else {
        const float q_prev = max_nan(ring_load(ring_b + h1 * row_len + i), lb);
        float c1, c2, c3, c4;
        mc_coefficients(p, i, q_prev, c1, c2, c3, c4);
        const float s_prev = p.s[static_cast<size_t>(b) * p.n + i];
        const float s_in = p.se != nullptr ? s_prev + p.se[out] : s_prev;
        const float b_step = c2 * s_in + c3 * q_prev + c4 * max_nan(q_row, lb);
        y = b_step + c1 * x_pred;
      }
      float y_up;
      ring_round(y, ring_b[h * row_len + i], y_up);
      p.ys[out] = y_up;
      p.s[static_cast<size_t>(b) * p.n + i] = s_next;
    }
    grid.sync();
  }
}

// One cooperative launch of the RingT instantiation, its grid sized to
// co-residency.
template <typename RingT>
cudaError_t launch(WaveScanParams p, int device, cudaStream_t stream) {
  cudaError_t err;
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_scan_kernel<RingT>,
                                                           kThreads, 0)) != cudaSuccess)
    return err;
  const long long pairs = static_cast<long long>(p.B) * p.n;
  long long blocks = (pairs + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(wave_scan_kernel<RingT>),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the scan on `stream` and returns the launch's cudaError_t (0 on
// success). `ring` holds float (ring_bf16 = 0) or __nv_bfloat16 (ring_bf16 =
// 1) elements; any other ring_bf16 is refused. Does not synchronise; faults
// during the run surface at the caller's next synchronisation.
int ddr_wave_scan(const float* qs, float* ys, void* ring, float* s, const float* xe,
                  const float* se, const int* lvl, const int* slot, const int* width, const int* wf_row, const int* wf_col,
                  const float* wf_mask, const float* q_init, const float* n_mann,
                  const float* p_spatial, const float* q_spatial, const float* slope,
                  const float* length, const float* x_storage, float depth_lb,
                  float bottom_width_lb, float velocity_lb, float discharge_lb, float dt, int B,
                  int T, int n, int W, int R, int mask_raw, int ring_bf16, int device,
                  void* stream) {
  if (ring_bf16 != 0 && ring_bf16 != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  WaveScanParams p{qs,        ys,          ring,       s,      xe,           se,
                   lvl,       slot,        width,      wf_row, wf_col,       wf_mask,
                   q_init,    n_mann,      p_spatial,  q_spatial, slope,     length,
                   x_storage, depth_lb,    bottom_width_lb, velocity_lb, discharge_lb,
                   dt,        B,           T,          n,      W,            R,
                   mask_raw};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ring_bf16 ? launch<__nv_bfloat16>(p, device, st) : launch<float>(p, device, st);
}

const char* ddr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
