// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// per channel, from h0.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` of
// src/repro/kernels/rglru_scan.py (launched by `rglru_scan`, reached
// through `repro.kernels.ops.rglru_scan`).  Same function in fp32: a, b
// (B, S, W), h0 (B, W) or zero; returns every h_t (B, S, W) and the last
// (B, W).  The TPU kernel pads the sequence and the channels to its
// (256, 128) tiles with a = 1, b = 0; here nothing is padded: a thread
// past the last channel does nothing.
//
// What bounds it: the bytes.  Each element of a and b is read once and
// each h written once for one FMA, so a call moves 12 bytes per element
// (plus h0 and h_last) and does 2 flops: at the serving shape (8 rows x
// 32 tokens x 2560 channels) ~8 MB, ~2.4 us at the memory rate.
//
// What the design does about it: the recurrence is diagonal, so one
// thread owns one (batch row, channel) and keeps h in a register for the
// whole sequence; the 32 threads of a warp hold 32 neighbouring channels,
// so every load of a and b and every store of h is one coalesced 128-byte
// line; the loads of a step do not depend on h, so the unrolled loop
// keeps several in flight.  B * W / 128 blocks of 128 threads (160 at the
// serving shape).  A long sequence with few channels would leave the card
// idle: splitting the sequence (a chunked scan with a second pass) is
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W, long long a_sb,
                  long long a_ss, long long b_sb, long long b_ss,
                  long long h_sb, long long h_ss) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  const float* ap = a + row * a_sb + w;
  const float* bp = b + row * b_sb + w;
  float* hp = h + row * h_sb + w;
  float hv = h0 ? h0[(long long)row * W + w] : 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    hv = ap[s * a_ss] * hv + bp[s * b_ss];
    hp[s * h_ss] = hv;
  }
  h_last[(long long)row * W + w] = hv;
}

}  // namespace

extern "C" {

// a, b: float32 (B, S, W), last dim contiguous, other strides in elements;
// h0 (may be null) and h_last: float32 (B, W) contiguous; h: float32
// (B, S, W).  Returns the cudaError_t of the launch (0 = success).
int rglru_scan(const float* a, const float* b, const float* h0, float* h,
               float* h_last, int B, int S, int W, long long a_sb,
               long long a_ss, long long b_sb, long long b_ss,
               long long h_sb, long long h_ss, void* stream) {
  if (B < 1 || S < 1 || W < 1) return int(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, h_last, S, W, a_sb, a_ss, b_sb, b_ss, h_sb, h_ss);
  return int(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
