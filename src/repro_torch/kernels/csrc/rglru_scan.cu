// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// per channel, from h0, as a segmented scan in one launch.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` of
// src/repro/kernels/rglru_scan.py (launched by `rglru_scan`, reached
// through `repro.kernels.ops.rglru_scan`).  Same function in fp32: a, b
// (B, S, W), h0 (B, W) or zero; returns every h_t (B, S, W) and the last
// (B, W).  The TPU kernel pads the sequence and the channels to its
// (256, 128) tiles with a = 1, b = 0; here nothing is padded in memory: a
// lane past the last channel loads and stores nothing, and a step past S
// runs as the identity (a = 1, b = 0) in registers.
//
// What bounds it: the bytes.  Each element of a and b is read once and
// each h written once for one FMA, so a call moves 12 bytes per element
// (plus h0 and h_last) and does 2 flops: 8.0 MB at the serving shape (8
// rows x 32 tokens x 2560 channels, 2.4 us at the memory rate), 126 MB at
// RecurrentGemma-2B's cache-free forward (1 x 4096 x 2560, 38 us).  To
// reach the memory rate the whole card has to keep loads in flight, and a
// chain of S dependent FMAs per channel must not set the time.
//
// What the design does about it: the step (a, b) composes,
// (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2), so the sequence is cut
// into segments scanned side by side.
//   * Each warp owns one segment of L steps of 32 neighbouring channels
//     (the lane is the channel: every load and store is one 128-byte line)
//     and issues all 2 L loads of its segment's a and b into registers
//     before the chain starts.
//   * It scans its segment from zero, keeping the segment's product of a
//     and its local h; the 8 warps of a block leave those in shared
//     memory, and a cluster of C <= 8 blocks covers a tile of C * 8 * L
//     steps.  After one barrier (cluster.sync() when C > 1) each warp
//     applies the earlier blocks' compositions (read through distributed
//     shared memory) and the earlier warps' to the tile's carry, in
//     order, which gives h just before its segment; then it reruns its
//     segment from that carry out of its registers and stores h.  So the
//     only rounding that differs from the sequential recurrence is that of
//     the carries (|a| < 1: it does not grow).
//   * A longer sequence is walked tile by tile: each warp's loads of the
//     next tile are in flight while it scans this one (two register
//     buffers), and the carry is the h that the previous tile's last
//     segment handed on through shared memory (double-buffered by the
//     tile's parity, so one barrier a tile suffices).  h_last is stored by
//     the warp that computed step S - 1.
//   * L and C come from the host (`kernels/rglru_scan.py::geometry`, from
//     S alone): L is the least power of two with 8 L >= S, at most 16 (two
//     buffers of 2 L registers), C the blocks that cover S (at most 8).
//     The serving shape (S 32) runs 640 blocks of 8 warps of 4 steps, all
//     resident at once; RecurrentGemma-2B's cache-free forward (S 4096) 80
//     clusters of 8 blocks, four tiles of 1,024 steps.  (Two or four
//     channels a lane, 8- or 16-byte loads, were no faster at the serving
//     shape and slower at S 4096, where they shorten the segments; the
//     cluster launch costs nothing over a plain one where C is 1.)  One
//     launch, no scratch in device memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;   // a portable cluster

struct Params {
  const float* a;
  const float* b;
  const float* h0;
  float* h;
  float* h_last;
  int S, W, cluster;
  long long a_sb, a_ss, b_sb, b_ss, h_sb, h_ss;
};

// one warp's segment: L steps of a and b
template <int L>
struct Seg {
  float a[L], b[L];
};

// steps t0 .. t0 + L - 1; past S (or past W) the identity a = 1, b = 0
template <int L>
__device__ __forceinline__ void load_seg(Seg<L>& s, const Params& p,
                                         const float* a, const float* b,
                                         int t0, bool live) {
#pragma unroll
  for (int t = 0; t < L; ++t) {
    const bool ok = live && t0 + t < p.S;
    s.a[t] = ok ? a[(long long)(t0 + t) * p.a_ss] : 1.f;
    s.b[t] = ok ? b[(long long)(t0 + t) * p.b_ss] : 0.f;
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, 2)
rglru_scan_kernel(Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  // by the tile's parity: a block may start tile k + 1 while its peers
  // still read tile k's compositions
  __shared__ float seg_a[2][kWarps][32], seg_h[2][kWarps][32];
  __shared__ float blk_a[2][32], blk_h[2][32];   // the block's composition
  __shared__ float tail[2][32];                  // h at a tile's last step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = p.cluster, rank = int(cluster.block_rank());
  const int seg = rank * kWarps + warp, tile = C * kWarps * L;
  const int w = (blockIdx.x / C) * 32 + lane;
  const long long row = blockIdx.y;
  const bool live = w < p.W;
  const float* a = p.a + row * p.a_sb + w;
  const float* b = p.b + row * p.b_sb + w;
  float* h = p.h + row * p.h_sb + w;
  float carry = p.h0 && live ? p.h0[row * p.W + w] : 0.f;

  Seg<L> cur, nxt;
  load_seg<L>(cur, p, a, b, seg * L, live);
  for (int s0 = 0, k = 0; s0 < p.S; s0 += tile, k ^= 1) {
    const int t0 = s0 + seg * L;
    const bool more = s0 + tile < p.S;
    if (more) load_seg<L>(nxt, p, a, b, t0 + tile, live);
    float A = 1.f, hv = 0.f;   // the segment from zero
#pragma unroll
    for (int t = 0; t < L; ++t) {
      hv = fmaf(cur.a[t], hv, cur.b[t]);
      A *= cur.a[t];
    }
    seg_a[k][warp][lane] = A;
    seg_h[k][warp][lane] = hv;
    __syncthreads();
    if (C > 1) {
      if (warp == 0) {
        float ba = 1.f, bh = 0.f;
#pragma unroll
        for (int j = 0; j < kWarps; ++j) {
          bh = fmaf(seg_a[k][j][lane], bh, seg_h[k][j][lane]);
          ba *= seg_a[k][j][lane];
        }
        blk_a[k][lane] = ba;
        blk_h[k][lane] = bh;
      }
      cluster.sync();
      // the carry into this tile: what its predecessor's last segment
      // handed on (written before this barrier)
      if (s0 > 0)
        carry = cluster.map_shared_rank(&tail[k ^ 1][0], C - 1)[lane];
    } else if (s0 > 0) {
      carry = tail[k ^ 1][lane];
    }
    float c = carry;                          // h just before the segment
    for (int r = 0; r < rank; ++r)
      c = fmaf(cluster.map_shared_rank(&blk_a[k][0], r)[lane], c,
               cluster.map_shared_rank(&blk_h[k][0], r)[lane]);
    for (int j = 0; j < warp; ++j)
      c = fmaf(seg_a[k][j][lane], c, seg_h[k][j][lane]);
    hv = c;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      hv = fmaf(cur.a[t], hv, cur.b[t]);
      if (live && t0 + t < p.S) h[(long long)(t0 + t) * p.h_ss] = hv;
    }
    if (more) {
      // a full tile's last step is this cluster's last segment's
      if (seg == C * kWarps - 1) tail[k][lane] = hv;
      cur = nxt;
    } else if (live && t0 <= p.S - 1 && p.S - 1 < t0 + L) {
      p.h_last[row * p.W + w] = hv;   // steps past S kept hv
    }
  }
  if (C > 1) cluster.sync();               // peers are done reading ours
}

template <int L>
int launch(const Params& p, int B, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster * ((p.W + 31) / 32), B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, rglru_scan_kernel<L>, p);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b: float32 (B, S, W), last dim contiguous, other strides in elements;
// h0 (may be null) and h_last: float32 (B, W) contiguous; h: float32
// (B, S, W).  seg_len: steps a warp, a power of two <= 16; cluster: blocks
// a cluster, 1..8.  Both are a function of S alone, and
// `kernels/rglru_scan.py::geometry` is its one definition (the tests hold
// the segmented order at what it gives): they are not a tuning option, and
// are checked here only so that a wrong pair cannot launch.  Returns the
// cudaError_t of the launch (0 = success).
int rglru_scan(const float* a, const float* b, const float* h0, float* h,
               float* h_last, int B, int S, int W, long long a_sb,
               long long a_ss, long long b_sb, long long b_ss,
               long long h_sb, long long h_ss, int seg_len, int cluster,
               void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1 || cluster < 1 ||
      cluster > kMaxCluster)
    return int(cudaErrorInvalidValue);
  const Params p{a, b, h0, h, h_last, S, W, cluster,
                 a_sb, a_ss, b_sb, b_ss, h_sb, h_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seg_len) {
    case 1: return launch<1>(p, B, s);
    case 2: return launch<2>(p, B, s);
    case 4: return launch<4>(p, B, s);
    case 8: return launch<8>(p, B, s);
    case 16: return launch<16>(p, B, s);
  }
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
