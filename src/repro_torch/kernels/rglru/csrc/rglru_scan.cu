// Linear recurrence of the RG-LRU for Hopper (sm_90a), on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/rglru/kernel.py
// (linear_scan_blocked, body _scan_kernel) together with its wrapper
// src/repro/kernels/rglru/ops.py (linear_scan):
//   h_t = a_t * h_{t-1} + b_t  per channel (b, d), from h_{-1} = h0;
//   y[b, t, d] = h_t;  hT[b, d] = h_{S-1}.  f32 in, f32 out, f32 arithmetic.
//
// What is not carried over.  The TPU kernel starts from a zero state and its
// wrapper folds h0 in afterwards with cumprod(a), a second pass over (B,S,D);
// here h0 is the first value of the carry, in one pass.  The TPU kernel pads
// S and D to its block sizes with a = 1, b = 0; here every access is bounds
// checked and nothing is padded.  Its in-chunk log-step composition is for a
// machine with one core walking a sequential grid; here the channels give the
// parallelism.
//
// Design.  One thread per channel (b, d); neighbouring threads take
// neighbouring d, so each time step of a warp loads and stores 128
// contiguous bytes.  A thread walks time with h in a register, U steps at a
// time: the loads of the next U steps of a and b are issued before the
// current U steps are computed, so about 2U loads of a thread are in flight.
// Blocks of 64 threads, a grid of (ceil(D / 64), B).
//
// Bound on an H100 SXM.  The work reads a and b and writes y, 12 bytes per
// (b, t, d), and does one FMA per (b, t, d): bound by bytes.  At
// recurrentgemma-2b's prefill (B=4, S=2112, D=2560) that is 259.5 MB, 77 us at
// 3.35 TB/s.  There are only B*D = 10240 channels there: 160 blocks, 80
// threads an SM, too few loads in flight to reach the memory rate, so this
// kernel sits well above its bound.  The fix, left for a later change, is a
// chunked scan: chunks of time across blocks, then a second pass that
// carries the state across chunks.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 16;  // time steps loaded ahead

__device__ __forceinline__ void load_steps(const float* __restrict__ a,
                                           const float* __restrict__ b, int t0,
                                           int S, long long D, float (&ra)[U],
                                           float (&rb)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    ra[u] = t < S ? a[t * D] : 1.f;
    rb[u] = t < S ? b[t * D] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ hT, int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const long long row = (long long)blockIdx.y * D + d;   // (b, d) in h0, hT
  const long long base = (long long)blockIdx.y * S * D + d;
  const float* ab = a + base;
  const float* bb = b + base;
  float* yb = y + base;

  float h = h0[row];
  float ca[U], cb[U];
  load_steps(ab, bb, 0, S, D, ca, cb);
  for (int t0 = 0; t0 < S; t0 += U) {
    float na[U], nb[U];
    load_steps(ab, bb, t0 + U, S, D, na, nb);  // in flight while this chunk runs
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        h = fmaf(ca[u], h, cb[u]);
        yb[(long long)(t0 + u) * D] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
  hT[row] = h;
}

}  // namespace

// a, b, y: (B, S, D); h0, hT: (B, D); all float32 and contiguous.  Launches
// on `stream` without synchronising; returns the cudaError_t.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0, void* y,
                          void* hT, int B, int S, int D, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), S, D);
  return (int)cudaGetLastError();
}

extern "C" const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
