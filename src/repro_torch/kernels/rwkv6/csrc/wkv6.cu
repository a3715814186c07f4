// WKV6 recurrence of RWKV-6 for Hopper (sm_90a), on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py (wkv6_chunked,
// body _wkv_kernel) together with its wrapper src/repro/kernels/rwkv6/ops.py
// (wkv6).  Per (b, h), from S_{-1} = state0:
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
// r, k, v are f32 or bf16 (converted to f32 as they are read, as the TPU
// kernel casts them itself); logw, u, state0, y and the final state are f32;
// all arithmetic is f32.
//
// What is not carried over.  The TPU kernel works in chunks of L steps with
// an (L, L, N) pairwise decay tensor (1 MB at L = N = 64) so that a chunk is
// three matrix products; it starts from a zero state and its wrapper folds a
// nonzero state0 in with a second pass over the sequence; it pads S to a
// multiple of L.  Here the carry starts at state0, in one pass, every access
// is bounds checked and nothing is padded.  The recurrence needs no decay
// clamp: the chunked form's exponent clamp at -60 changes terms below
// exp(-60).
//
// Design.  Blocks of 64 threads walk time for one (b, h) with the state in
// registers.  A head's value columns are split over CS blocks (1, 2 or 4;
// the wrapper picks it), each holding an N x N/CS slab: thread (rb, cb) of
// an 8 x 8 grid owns the R x C tile (R = N / 8, C = N / CS / 8) of rows
// rb*R.. and the slab's columns cb*C.., so that a step reads only R values
// each of r_t, k_t, w_t and C of v_t from shared memory for its R*C
// entries (8 float4 loads a step at N = 64, CS = 1, where a thread owning a
// whole column would make 3N / 4 = 48).  Per step, for j in its columns:
//   part[rb][t][j] = sum_{i in rows of rb} r_ti (S_ij + u_i k_ti v_tj)
//   S_ij <- w_ti S_ij + k_ti v_tj
// and the operands of step t+1 are loaded while step t is computed.  Steps
// come in tiles of T: cp.async copies tile n+1 of r, k, v and logw (16-byte
// chunks of N-element rows, coalesced) into one half of a double buffer
// while tile n is computed; w = exp(logw) is taken in place once per
// (t, i).  After a tile's steps, a reduction pass sums the 8 row blocks'
// partial y and writes the slab's columns of y with 16-byte stores.  bf16
// streams are converted to f32 as they are read from shared memory.  The
// streams are addressed through (sB, sH, sS) strides, so the model's
// (B, S, H, N) projections are read, and y written, in place.
//
// Bound on an H100 SXM.  The work reads r, k, v and logw and writes y (20
// bytes per (b, h, t, i) in f32) plus the two states, and does 5 N^2 + O(N)
// flops per (b, h, t).  At rwkv6-3b's prefill (B=4, H=40, S=2100, N=64, f32)
// that is 435 MB, 0.130 ms at 3.35 TB/s, against 6.9 GFLOP, 0.103 ms at the
// 67 TFLOP/s f32 peak: bound by bytes.  What holds this design back is the
// serial step chain of a block (about 250 instructions a thread a step at
// N = 64, CS = 1): one (b, h) alone takes 97% of the full shape's time.  A
// split shortens the chain, but an SM that holds more than two blocks (four
// warps, one per scheduler) shares a scheduler between warps and is slower
// than one chain, so the split pays only while the grid leaves SMs with at
// most two blocks (bench.py in this directory measures both).
// Left for later: the chunked tensor-core form (intra-chunk products with
// mma/wgmma, the state carried across chunks in shared memory), which does
// the same work in far fewer instructions.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int T = 16;             // time steps per staged tile
constexpr int G = 8;              // row blocks = column blocks of the state
constexpr int THREADS = G * G;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one group of this thread's copies is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// R consecutive values of shared memory as f32, in 16-byte loads where R
// allows (p is then 16-byte aligned)
template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&out)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = x.x, out[4 * q + 1] = x.y, out[4 * q + 2] = x.z, out[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < R; ++a) out[a] = p[a];
  }
}

template <int R>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&out)[R]) {
  if constexpr (R % 8 == 0) {
#pragma unroll
    for (int q = 0; q < R / 8; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[q];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 f = __bfloat1622float2(h[m]);
        out[8 * q + 2 * m] = f.x, out[8 * q + 2 * m + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < R; ++a) out[a] = __bfloat162float(p[a]);
  }
}

template <int R>
__device__ __forceinline__ void store_row(float* p, const float (&in)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(in[4 * q], in[4 * q + 1], in[4 * q + 2], in[4 * q + 3]);
  } else {
#pragma unroll
    for (int a = 0; a < R; ++a) p[a] = in[a];
  }
}

// Dynamic shared memory of one block, in bytes: a double buffer of raw
// r, k, v (In) and logw (f32, exp'd in place) tiles of T steps x N, and the
// G row blocks' partial y of a tile over the block's N / CS columns.
template <typename In, int N, int CS>
constexpr int smem_bytes() {
  return 2 * T * N * (3 * (int)sizeof(In) + 4) + G * T * (N / CS) * 4;
}

// Where (b, h) of a (B, H, S, N) stream starts and how far apart its steps
// are, in elements; a row of N elements is contiguous.
struct Layout {
  long long sB, sH, sS;
};

// Copies `rows` steps of r, k, v, logw from step offset `off` (elements) into
// the raw buffers, packed as [rows][N]; a row is N * sizeof(In) bytes, a
// multiple of 16 for N % 8 == 0, and starts 16-byte aligned.
template <typename In, int N>
__device__ __forceinline__ void issue_tile(const In* r, const In* k, const In* v,
                                           const float* w, long long off, long long sS,
                                           int rows, In* rr, In* kr, In* vr, float* wr) {
  constexpr int E = 16 / sizeof(In);  // elements per 16-byte chunk
  const int n_in = rows * (N / E);
  for (int c = threadIdx.x; c < n_in; c += THREADS) {
    const long long g = off + (c / (N / E)) * sS + (c % (N / E)) * E;
    cp_async16(rr + c * E, r + g);
    cp_async16(kr + c * E, k + g);
    cp_async16(vr + c * E, v + g);
  }
  const int n_w = rows * (N / 4);
  for (int c = threadIdx.x; c < n_w; c += THREADS)
    cp_async16(wr + c * 4, w + off + (c / (N / 4)) * sS + (c % (N / 4)) * 4);
}

// Block (b, h, cs) computes columns cs * N / CS .. of the state of (b, h) and
// of its y; every block of a head reads all of r, k and w.
template <typename In, int N, int CS>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const In* __restrict__ r, const In* __restrict__ k,
            const In* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int H, int S, Layout lay) {
  constexpr int NC = N / CS;  // the block's columns
  constexpr int R = N / G;    // rows of a thread's state tile
  constexpr int C = NC / G;   // columns of a thread's state tile
  static_assert(C >= 1 && NC % 4 == 0, "column split too fine for N");
  constexpr int TN = T * N;
  constexpr int TC = T * NC;
  extern __shared__ __align__(16) unsigned char smem[];
  In* raw = reinterpret_cast<In*>(smem);                                    // [2][3][TN]
  float* raw_w = reinterpret_cast<float*>(smem + 2 * 3 * TN * sizeof(In));  // [2][TN]
  float* part = raw_w + 2 * TN;                                             // [G][TC]

  const int bh = blockIdx.x / CS;
  const int c0 = (blockIdx.x % CS) * NC;
  const int tid = threadIdx.x;
  const int rb = tid / G;
  const int i0 = rb * R, jl = (tid % G) * C, j0 = c0 + jl;
  const long long base = (bh / H) * lay.sB + (bh % H) * lay.sH;

  float ur[R];     // u of the thread's rows
  float st[R][C];  // S[i0 + a][j0 + c]
  const float* s0b = s0 + (long long)bh * N * N;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    ur[a] = u[(bh % H) * N + i0 + a];
#pragma unroll
    for (int c = 0; c < C; ++c) st[a][c] = s0b[(i0 + a) * N + j0 + c];
  }

  const int n_tiles = (S + T - 1) / T;
  issue_tile<In, N>(r, k, v, logw, base, lay.sS, min(T, S), raw, raw + TN, raw + 2 * TN,
                    raw_w);
  cp_async_commit();
  for (int n = 0; n < n_tiles; ++n) {
    const int t0 = n * T;
    const int rows = min(T, S - t0);
    if (n + 1 < n_tiles) {  // into the half that tile n-1 used
      const int b = (n + 1) & 1;
      In* nr = raw + b * 3 * TN;
      issue_tile<In, N>(r, k, v, logw, base + (long long)(t0 + T) * lay.sS, lay.sS,
                        min(T, S - t0 - T), nr, nr + TN, nr + 2 * TN, raw_w + b * TN);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile n has landed, for this thread's copies
    __syncthreads();      // ... for every thread's; and tile n-1 is done

    const In* rr = raw + (n & 1) * 3 * TN;
    const In* kr = rr + TN;
    const In* vr = rr + 2 * TN;
    float* wr = raw_w + (n & 1) * TN;
#pragma unroll
    for (int m = 0; m < TN / THREADS; ++m) {
      const int e = tid + m * THREADS;
      if (e < rows * N) wr[e] = expf(wr[e]);
    }
    __syncthreads();

    float rt[R], kt[R], wt[R], vt[C];
    load_row<R>(rr + i0, rt);
    load_row<R>(kr + i0, kt);
    load_row<R>(wr + i0, wt);
    load_row<C>(vr + j0, vt);
    for (int t = 0; t < rows; ++t) {
      const int tn = t + 1 < T ? t + 1 : t;  // step t+1's operands, loaded ahead
      float rn[R], kn[R], wn[R], vn[C];
      load_row<R>(rr + tn * N + i0, rn);
      load_row<R>(kr + tn * N + i0, kn);
      load_row<R>(wr + tn * N + i0, wn);
      load_row<C>(vr + tn * N + j0, vn);

      float bonus = 0.f, yp[C];  // sum over the thread's rows of r u k
#pragma unroll
      for (int a = 0; a < R; ++a) bonus = fmaf(rt[a] * ur[a], kt[a], bonus);
#pragma unroll
      for (int c = 0; c < C; ++c) yp[c] = bonus * vt[c];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          yp[c] = fmaf(rt[a], st[a][c], yp[c]);
          st[a][c] = fmaf(wt[a], st[a][c], kt[a] * vt[c]);
        }
      store_row<C>(part + rb * TC + t * NC + jl, yp);
#pragma unroll
      for (int a = 0; a < R; ++a) rt[a] = rn[a], kt[a] = kn[a], wt[a] = wn[a];
#pragma unroll
      for (int c = 0; c < C; ++c) vt[c] = vn[c];
    }
    __syncthreads();

    float* yb = y + base + (long long)t0 * lay.sS + c0;
#pragma unroll
    for (int m = 0; m < (TC + 4 * THREADS - 1) / (4 * THREADS); ++m) {
      const int e = 4 * (tid + m * THREADS);
      if (e < rows * NC) {
        float4 acc = *reinterpret_cast<const float4*>(part + e);
#pragma unroll
        for (int g = 1; g < G; ++g) {
          const float4 p = *reinterpret_cast<const float4*>(part + g * TC + e);
          acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
        }
        *reinterpret_cast<float4*>(yb + (e / NC) * lay.sS + e % NC) = acc;
      }
    }
  }

  float* sTb = sT + (long long)bh * N * N;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) sTb[(i0 + a) * N + j0 + c] = st[a][c];
}

template <typename In, int N, int CS>
cudaError_t launch(const void* r, const void* k, const void* v, const void* logw,
                   const void* u, const void* s0, void* y, void* sT, int BH, int H,
                   int S, Layout lay, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<In, N, CS>();
  static_assert(bytes <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<In, N, CS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  wkv6_kernel<In, N, CS><<<BH * CS, THREADS, bytes, stream>>>(
      static_cast<const In*>(r), static_cast<const In*>(k),
      static_cast<const In*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sT), H, S, lay);
  return cudaGetLastError();
}

// N in {8, 16, 32} takes CS = 1; N = 64 takes CS in {1, 2, 4}
template <typename In>
cudaError_t dispatch(const void* r, const void* k, const void* v, const void* logw,
                     const void* u, const void* s0, void* y, void* sT, int BH, int H,
                     int S, int N, int CS, Layout lay, cudaStream_t stream) {
#define WKV6_LAUNCH(n, cs) \
  launch<In, n, cs>(r, k, v, logw, u, s0, y, sT, BH, H, S, lay, stream)
  if (N == 64 && CS == 1) return WKV6_LAUNCH(64, 1);
  if (N == 64 && CS == 2) return WKV6_LAUNCH(64, 2);
  if (N == 64 && CS == 4) return WKV6_LAUNCH(64, 4);
  if (CS != 1) return cudaErrorInvalidValue;
  switch (N) {
    case 8: return WKV6_LAUNCH(8, 1);
    case 16: return WKV6_LAUNCH(16, 1);
    case 32: return WKV6_LAUNCH(32, 1);
    default: return cudaErrorInvalidValue;
  }
#undef WKV6_LAUNCH
}

}  // namespace

// r, k, v, logw, y: (B, H, S, N) with strides (sB, sH, sS, 1) in elements,
// one layout for all five (a contiguous (B, H, S, N), or the (1, 2) transpose
// of a contiguous (B, S, H, N)); u: (H, N); state0, stateT: (B, H, N, N),
// contiguous.  r, k, v float32 (bf16 = 0) or bfloat16 (bf16 = 1), the rest
// float32; every stream 16-byte aligned and its strides multiples of 8;
// N in {8, 16, 32, 64}; col_split blocks per head (1, or 2 or 4 at N = 64).
// Launches on `stream` without synchronising; returns the cudaError_t.
extern "C" int wkv6(const void* r, const void* k, const void* v, const void* logw,
                    const void* u, const void* state0, void* y, void* stateT,
                    int bf16, int B, int H, int S, int N, long long sB, long long sH,
                    long long sS, int col_split, void* stream) {
  if (B < 1 || H < 1 || S < 1 || (long long)B * H * col_split > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (sB % 8 || sH % 8 || sS % 8) return (int)cudaErrorInvalidValue;
  const Layout lay{sB, sH, sS};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch<__nv_bfloat16>(r, k, v, logw, u, state0, y, stateT, B * H, H, S,
                                        N, col_split, lay, s);
  return (int)dispatch<float>(r, k, v, logw, u, state0, y, stateT, B * H, H, S, N,
                              col_split, lay, s);
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
