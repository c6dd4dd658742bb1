// K2: the soft-DTW dynamic program on Hopper (sm_90a).
//
// Replaces clipspm_tpu/ops/softdtw_pallas.py:_sdtw_kernel. It computes the
// same function -- R[N, M] of each [N, M] fp32 distance table under
//   R[0,0] = 0, R[i,0] = R[0,j] = 1e30,
//   R[i,j] = D[i-1,j-1] + softmin_gamma(R[i-1,j-1], R[i-1,j], R[i,j-1]),
// with cells |i - j| > bandwidth pruned to exactly 1e30 when bandwidth > 0
// -- but not the TPU kernel's layout: the [K, rows, 128] diagonal-major
// gather and the sublane roll have no use here. Two entries:
//
// - table mode, softdtw_dp_launch: [B, N, M] fp32 tables -> [B]. One W-lane
//   segment of a warp (W = 16 when M <= 16, else 32) owns one table and
//   runs the anti-diagonal wavefront of dp_wavefront.cuh over it, borders
//   implicit, reading the table one step ahead of its use.
// - fused mode, softdtw_cos_padded_launch: x [B, N, D] and y [B, M, D] ->
//   [B], what ops/softdtw.py:softdtw(x, y, normalize=False, dist="cos")
//   computes: one block per pair builds the 1 - cos table (each norm
//   clamped at 1e-8, as pairwise_cos_dist) in shared memory, then one
//   segment runs the DP over the table with two zero rows on the query
//   axis (above and below, implicit), a second segment the DP over the
//   transposed table with its own two implicit zero rows, and the block
//   writes 0.5 * (forward + reverse). The reverse table is the forward
//   table's dot products read transposed, where the JAX package takes a
//   second matmul dist(y, x): equal up to rounding.
//
// What bounds it: neither bytes nor FLOPs. On the TA2N head (25 pairs of
// 8-frame sequences, D = 2048) a launch reads 3.3 MB of features and does
// 6.6 MFLOP of dot products; what remains is latency: the launch, the
// gram's staged loads, and the DP's dependent chain. A padded 10 x 8 table
// has 80 cells in dependence order; the wavefront runs it in 17 steps of one
// shuffle and one soft-min, with no division on the chain.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsoftdtw_dp.so softdtw_dp.cu

#include "dp_wavefront.cuh"

namespace {

constexpr int kMaxM = 32;  // one lane per column
constexpr int kTableThreads = 128;

template <int W>
__global__ void __launch_bounds__(kTableThreads)
softdtw_dp_kernel(const float* __restrict__ dists, float* __restrict__ out,
                  int B, int N, int M, float gamma, float inv,
                  float bandwidth) {
  const int b = blockIdx.x * (kTableThreads / W) + threadIdx.x / W;
  const int lane = threadIdx.x % W;
  // a segment past the last table walks the last one and writes nothing:
  // every lane of the warp must take part in every shuffle
  const int bt = b < B ? b : B - 1;
  const dpw::Strided get{dists + static_cast<size_t>(bt) * N * M, M, 1};
  const float r = dpw::softdtw_wavefront<W>(get, N, M, lane, N + M - 1,
                                            gamma, inv, bandwidth);
  if (b < B && lane == M - 1) out[b] = r;
}

template <int W>
__global__ void __launch_bounds__(dpw::kFusedThreads)
softdtw_fused_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     float* __restrict__ out, int N, int M, int D,
                     float gamma, float inv, float bandwidth, int vec16) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float result[2];
  const int b = blockIdx.x;
  // rows: x's steps (the query axis), columns: y's steps
  const float* tab = dpw::gram_cos_table(
      x + static_cast<size_t>(b) * N * D, N,
      y + static_cast<size_t>(b) * M * D, M, D, vec16 != 0, smem,
      dpw::ClampedCos{});
  const int pitch = M + 1;
  if (threadIdx.x < 2 * W) {
    // segment 0: [N + 2, M], the table between two zero rows; segment 1:
    // [M + 2, N], the transpose between two zero rows. Both take N + M + 1
    // steps, so the warp's shuffles stay uniform.
    const int seg = threadIdx.x / W, lane = threadIdx.x % W;
    const int rows = seg ? M : N, cols = seg ? N : M;
    const dpw::PaddedRows get{tab, seg ? 1 : pitch, seg ? pitch : 1, rows};
    const float r = dpw::softdtw_wavefront<W>(get, rows + 2, cols, lane,
                                              N + M + 1, gamma, inv,
                                              bandwidth);
    if (lane == cols - 1) result[seg] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) out[b] = 0.5f * (result[0] + result[1]);
}

}  // namespace

extern "C" {

// Launches K2's table mode on `stream` over B contiguous fp32 tables
// [B, N, M]; writes [B] fp32. Returns a cudaError_t (0 on success).
int softdtw_dp_launch(const float* dists, float* out, int B, int N, int M,
                      float gamma, float bandwidth, void* stream) {
  if (B <= 0) return 0;
  if (N < 1 || M < 1 || M > kMaxM || !(gamma > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const float inv = 1.0f / gamma;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    const int per = kTableThreads / 16;
    softdtw_dp_kernel<16><<<(B + per - 1) / per, kTableThreads, 0, st>>>(
        dists, out, B, N, M, gamma, inv, bandwidth);
  } else {
    const int per = kTableThreads / 32;
    softdtw_dp_kernel<32><<<(B + per - 1) / per, kTableThreads, 0, st>>>(
        dists, out, B, N, M, gamma, inv, bandwidth);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K2's fused mode on `stream`: contiguous fp32 x [B, N, D] and
// y [B, M, D] -> [B] fp32, the average of the forward and reverse padded
// soft-DTW over the 1 - cos table. Returns a cudaError_t (0 on success).
int softdtw_cos_padded_launch(const float* x, const float* y, float* out,
                              int B, int N, int M, int D, float gamma,
                              float bandwidth, void* stream) {
  if (B <= 0) return 0;
  if (N < 1 || M < 1 || N > dpw::kMaxFrames || M > dpw::kMaxFrames ||
      D < 1 || !(gamma > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const float inv = 1.0f / gamma;
  const int vec16 = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const size_t smem = sizeof(float) * dpw::fused_smem_floats(N, M, D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool smem_allowed[2][dpw::kMaxDevices];
  const bool narrow = N <= 16 && M <= 16;
  const cudaError_t rc =
      narrow ? dpw::allow_fused_smem(
                   reinterpret_cast<const void*>(softdtw_fused_kernel<16>),
                   smem_allowed[0])
             : dpw::allow_fused_smem(
                   reinterpret_cast<const void*>(softdtw_fused_kernel<32>),
                   smem_allowed[1]);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (narrow)
    softdtw_fused_kernel<16><<<B, dpw::kFusedThreads, smem, st>>>(
        x, y, out, N, M, D, gamma, inv, bandwidth, vec16);
  else
    softdtw_fused_kernel<32><<<B, dpw::kFusedThreads, smem, st>>>(
        x, y, out, N, M, D, gamma, inv, bandwidth, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
