// K2: the soft-DTW dynamic program on Hopper (sm_90a).
//
// Replaces clipspm_tpu/ops/softdtw_pallas.py:_sdtw_kernel. It computes the
// same function -- R[N, M] of each [N, M] fp32 distance table under
//   R[0,0] = 0, R[i,0] = R[0,j] = 1e30,
//   R[i,j] = D[i-1,j-1] + softmin_gamma(R[i-1,j-1], R[i-1,j], R[i,j-1]),
// with cells |i - j| > bandwidth pruned to 1e30 when bandwidth > 0 -- but
// not the TPU kernel's layout: the [K, rows, 128] diagonal-major gather and
// the sublane roll exist to vectorise across 128 lanes and have no use here.
// The recurrence is serial within one table, so one thread owns one table
// and walks it row by row, keeping one rolling row of M + 1 floats in
// registers. The borders are implicit: no padded copy of the table is made.
//
// What bounds it: on the TA2N head (B = 25 tables of 10 x 8 per launch) one
// launch reads 8 KB and does a few thousand exp/log operations, so neither
// bytes nor FLOPs bound it: latency does. One launch is as long as one
// thread's serial walk of its table (80 dependent cells at N = 10, M = 8,
// each with three IEEE divisions, three expf and one logf) plus the launch
// itself. The levers, left to later changes, are K1's: batch the episodes'
// tables into one launch, shorten the chain (multiply by 1/gamma), fuse the
// cosine table.
//
// Soft-min is the clamped, max-shifted form of softdtw.py:_softmin3_masked
// (clamp at 80, sentinel 1e30) with expf/logf; build without
// --use_fast_math so the division and the transcendental functions stay
// IEEE-accurate. A pruned cell is written as 1e30 exactly, as the Pallas
// kernel does, never as a computed value.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsoftdtw_dp.so softdtw_dp.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Largest table width M the kernel takes (the wrapper raises above).
constexpr int kMaxM = 32;
constexpr int kThreads = 128;
constexpr float kClamp = 80.0f;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float softmin3(float a, float b, float c,
                                          float gamma) {
  const float m = fminf(fminf(a, b), c);
  const float ea = expf(-fminf((a - m) / gamma, kClamp));
  const float eb = expf(-fminf((b - m) / gamma, kClamp));
  const float ec = expf(-fminf((c - m) / gamma, kClamp));
  return m - gamma * logf(ea + eb + ec);
}

__global__ void __launch_bounds__(kThreads)
softdtw_dp_kernel(const float* __restrict__ dists, float* __restrict__ out,
                  int B, int N, int M, float gamma, float bandwidth) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* table = dists + static_cast<size_t>(b) * N * M;
  const bool banded = bandwidth > 0.0f;

  // row[j] holds R[i, j] of the row being built (R[i-1, j] before column j
  // is overwritten); row[0] is the border column and is never stored. Every
  // index below is a compile-time constant after unrolling, so the row stays
  // in registers.
  float row[kMaxM + 1];
#pragma unroll
  for (int j = 1; j <= kMaxM; ++j) row[j] = kBig;  // row 0: R[0, j] = BIG
  float result = kBig;

  for (int i = 1; i <= N; ++i) {
    const float* drow = table + static_cast<size_t>(i - 1) * M;
    float upleft = (i == 1) ? 0.0f : kBig;  // R[i-1, 0]
    float left = kBig;                      // R[i, 0]
#pragma unroll
    for (int j = 1; j <= kMaxM; ++j) {
      if (j <= M) {
        const float up = row[j];  // R[i-1, j]
        float c;
        if (banded && fabsf(static_cast<float>(i - j)) > bandwidth) {
          c = kBig;
        } else {
          c = drow[j - 1] + softmin3(upleft, up, left, gamma);
        }
        if (j == M) result = c;
        upleft = up;
        left = c;
        row[j] = c;
      }
    }
  }
  out[b] = result;
}

}  // namespace

extern "C" {

int softdtw_dp_max_m() { return kMaxM; }

// Launches K2 on `stream` over B contiguous fp32 tables [B, N, M]; writes
// [B] fp32. Returns cudaGetLastError() (0 on success).
int softdtw_dp_launch(const float* dists, float* out, int B, int N, int M,
                      float gamma, float bandwidth, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  softdtw_dp_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      dists, out, B, N, M, gamma, bandwidth);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
