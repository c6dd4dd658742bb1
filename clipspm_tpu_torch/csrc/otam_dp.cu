// K1: the OTAM band dynamic program on Hopper (sm_90a).
//
// Replaces clipspm_tpu/ops/otam_pallas.py:_otam_kernel. It computes the same
// function -- the OTAM cumulative distance C[L-1, M-1] of each (query,
// support) frame-distance table, M = Ms + 2 with both zero pad columns
// implicit -- but not the TPU kernel's layout: no diagonal-major gather, no
// 128-lane tile, no roll. Two entries:
//
// - table mode, otam_dp_launch: [B, L, Ms] fp32 tables -> [B]. One W-lane
//   segment of a warp (W = 16 when Ms <= 16, else 32) owns one table and
//   runs the anti-diagonal wavefront of dp_wavefront.cuh over it, reading
//   the table from global memory one step ahead of its use.
// - fused mode, otam_distance_launch: support [S, Ls, D] and query
//   [Q, Lq, D] frame features -> [Q, S] distances. One block per (q, s)
//   pair builds the 1 - cos table (eps on the norm product, as
//   ops/otam.py:frame_distance_cos) in shared memory from the 2L frame
//   vectors (dp_wavefront.cuh's gram stage), then one segment runs the
//   forward DP and a second segment the DP of the transposed table, both
//   reading the table from shared memory. The [Q, S, L, L] tables never
//   reach device memory, and one launch replaces the cosine ops, two
//   transposed copies, two DP launches and the add.
//
// What bounds it: neither bytes nor FLOPs. At the main-path sizes (5 x 5
// pairs of 8-frame videos, D = 1024) a launch reads 320 KB of features and
// does 3.3 MFLOP of dot products; what remains is latency: the launch, the
// gram's staged loads, and the DP's dependent chain. An 8 x 8 table has 63
// cells in dependence order; the wavefront runs it in 14 steps of one
// shuffle and one soft-min, with no division on the chain.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libotam_dp.so otam_dp.cu

#include "dp_wavefront.cuh"

namespace {

constexpr int kMaxMs = 32;       // Ms + 2 <= 34: one lane per real column
constexpr int kTableThreads = 128;

template <int W>
__global__ void __launch_bounds__(kTableThreads)
otam_dp_kernel(const float* __restrict__ dists, float* __restrict__ out,
               int B, int L, int Ms, float lbda, float inv) {
  const int b = blockIdx.x * (kTableThreads / W) + threadIdx.x / W;
  const int lane = threadIdx.x % W;
  // a segment past the last table walks the last one and writes nothing:
  // every lane of the warp must take part in every shuffle
  const int bt = b < B ? b : B - 1;
  const dpw::Strided get{dists + static_cast<size_t>(bt) * L * Ms, Ms, 1};
  const float r = dpw::otam_wavefront<W>(get, L, Ms, lane, L + Ms - 2, lbda,
                                         inv);
  if (b < B && lane == Ms - 1) out[b] = r;
}

template <int W>
__global__ void __launch_bounds__(dpw::kFusedThreads)
otam_fused_kernel(const float* __restrict__ support,
                  const float* __restrict__ query, float* __restrict__ out,
                  int S, int Ls, int Lq, int D, float lbda, float inv,
                  float eps, int bidirectional, int vec16) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float result[2];
  const int q = blockIdx.x / S, s = blockIdx.x - q * S;
  // rows: query frames, columns: support frames (frame_distance_cos)
  const float* tab = dpw::gram_cos_table(
      query + static_cast<size_t>(q) * Lq * D, Lq,
      support + static_cast<size_t>(s) * Ls * D, Ls, D, vec16 != 0, smem,
      dpw::OtamCos{eps});
  const int pitch = Ls + 1;
  if (threadIdx.x < 2 * W) {
    // segment 0: the [Lq, Ls] table; segment 1: its transpose [Ls, Lq].
    // Both take Lq + Ls - 2 steps, so the warp's shuffles stay uniform.
    const int seg = threadIdx.x / W, lane = threadIdx.x % W;
    const int L = seg ? Ls : Lq, Ms = seg ? Lq : Ls;
    const dpw::Strided get{tab, seg ? 1 : pitch, seg ? pitch : 1};
    const float r = dpw::otam_wavefront<W>(get, L, Ms, lane, Lq + Ls - 2,
                                           lbda, inv);
    if (lane == Ms - 1) result[seg] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    out[blockIdx.x] = bidirectional ? result[0] + result[1] : result[0];
}

}  // namespace

extern "C" {

// Launches K1's table mode on `stream` over B contiguous fp32 tables
// [B, L, Ms]; writes [B] fp32. Returns a cudaError_t (0 on success).
int otam_dp_launch(const float* dists, float* out, int B, int L, int Ms,
                   float lbda, void* stream) {
  if (B <= 0) return 0;
  if (L < 1 || Ms < 1 || Ms > kMaxMs || !(lbda > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const float inv = 1.0f / lbda;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Ms <= 16) {
    const int per = kTableThreads / 16;
    otam_dp_kernel<16><<<(B + per - 1) / per, kTableThreads, 0, st>>>(
        dists, out, B, L, Ms, lbda, inv);
  } else {
    const int per = kTableThreads / 32;
    otam_dp_kernel<32><<<(B + per - 1) / per, kTableThreads, 0, st>>>(
        dists, out, B, L, Ms, lbda, inv);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K1's fused mode on `stream`: contiguous fp32 support [S, Ls, D]
// and query [Q, Lq, D] -> [Q, S] fp32 OTAM distances (the forward DP plus,
// when `bidirectional`, the DP of the transposed table). Returns a
// cudaError_t (0 on success).
int otam_distance_launch(const float* support, const float* query,
                         float* out, int S, int Ls, int Q, int Lq, int D,
                         float lbda, float eps, int bidirectional,
                         void* stream) {
  if (S <= 0 || Q <= 0) return 0;
  if (Ls < 1 || Lq < 1 || Ls > dpw::kMaxFrames || Lq > dpw::kMaxFrames ||
      D < 1 || !(lbda > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const float inv = 1.0f / lbda;
  const int vec16 = D % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(support) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(query) % 16 == 0;
  const size_t smem = sizeof(float) * dpw::fused_smem_floats(Lq, Ls, D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = Q * S;
  static bool smem_allowed[2][dpw::kMaxDevices];
  const bool narrow = Ls <= 16 && Lq <= 16;
  const cudaError_t rc =
      narrow ? dpw::allow_fused_smem(
                   reinterpret_cast<const void*>(otam_fused_kernel<16>),
                   smem_allowed[0])
             : dpw::allow_fused_smem(
                   reinterpret_cast<const void*>(otam_fused_kernel<32>),
                   smem_allowed[1]);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (narrow)
    otam_fused_kernel<16><<<blocks, dpw::kFusedThreads, smem, st>>>(
        support, query, out, S, Ls, Lq, D, lbda, inv, eps, bidirectional,
        vec16);
  else
    otam_fused_kernel<32><<<blocks, dpw::kFusedThreads, smem, st>>>(
        support, query, out, S, Ls, Lq, D, lbda, inv, eps, bidirectional,
        vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
