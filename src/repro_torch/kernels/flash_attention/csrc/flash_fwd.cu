// Causal GQA flash-attention forward for Hopper (sm_90a), on CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _fa_kernel): the same function, computed the
// way this card wants it rather than copied block by block.
//   * scale D**-0.5; query head h reads kv head h / (Hq / Hkv);
//   * mask: k_pos <= q_pos (causal), q_pos - k_pos < window, in bounds, with
//     positions aligned at the top left (row i is position i, also when
//     Sq != Skv); masked scores are -1e30 as in the reference;
//   * f32 running (m, l, acc) across kv tiles; out = acc / max(l, 1e-30),
//     cast to the input type.  Inputs are f32 or bf16, arithmetic is f32.
//
// Design.  One block per (q tile of 64 rows, query head, batch row).  The
// TPU's sequential kv grid axis becomes a loop inside the block over kv tiles
// of 64 keys, staged in shared memory with Q.  Tiles wholly above the causal
// diagonal or wholly before the window are never visited (the Pallas grid
// visits them all).  The head dim is padded to DP in {32, 64, 128, 256} with
// zeros in shared memory only; the wrapper never pads.  TX lanes share a
// query row: each thread owns a 4 x (64/TX) patch of the 64 x 64 score tile
// and a 4 x (DP/TX) patch of the output, and row max and row sum are reduced
// across the TX lanes with warp shuffles.
//   * DP <= 128: TX = 8, 128 threads; every shared-memory read feeds 2.7 FMAs.
//   * DP = 256: TX = 16, 256 threads.  With TX = 8 the output patch alone
//     would be 4 x 32 floats a thread, which with the scores does not fit in
//     255 registers; with TX = 16 it is 4 x 16.  Q, K, V and P take 214.5 KB
//     of shared memory, so one block (8 warps) runs on an SM.
//
// Sentinel.  m starts at -1e30, the masked score.  A row whose first visited
// tile has no live key accumulates exp(0) = 1 weights there; the first live
// key later multiplies them by exp(-1e30 - m) = 0, exactly.  A row with no
// live key at all (only with a window and Sq > Skv) gets the reference's
// uniform average over all Skv keys: its block visits every tile.  Keys past
// Skv get weight 0 through -inf.
//
// Bound on an H100 SXM.  Attention needs 4*D flops per live (q, k) pair.  At
// smollm-360m's slice shape (B=4, S=512, Hq=15, Hkv=5, D=64, f32, causal)
// that is 2.0 GFLOP, 30 us at the 67 TFLOP/s f32 CUDA-core peak, against
// 21 MB of q/k/v/o, 6.3 us at 3.35 TB/s.  At recurrentgemma-2b's prefill
// (B=4, S=2112, Hq=10, Hkv=1, D=256, window 2048) it is 91.3 GFLOP, 1.36 ms,
// against 190 MB, 57 us.  So it is bound by operations.  This simple design
// leaves for later: tensor cores (mma.sync or wgmma on bf16, TF32 for f32),
// cp.async/TMA double buffering of the K/V tiles, 16-byte vector loads, and
// load balance across the causal triangle.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // keys per kv tile
constexpr int RM = 4;             // rows of a thread: ty*4 + i
constexpr float NEG_INF = -1e30f;

// lanes that share a query row: 8 up to DP = 128, 16 at DP = 256
template <int DP>
__host__ __device__ constexpr int lanes() { return DP <= 128 ? 8 : 16; }
// thread (ty, tx) = (tid / TX, tid % TX); BQ / RM = 16 row groups
template <int DP>
__host__ __device__ constexpr int threads() { return (BQ / RM) * lanes<DP>(); }
// the 4 rows of a warp's P patch start TX banks apart: writes and reads of P
// are free of bank conflicts
template <int DP>
__host__ __device__ constexpr int p_pitch() { return BKV + lanes<DP>() / 4; }

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DP>
__host__ __device__ constexpr int smem_floats() {
  // Q and K rows padded by one float so that column reads hit distinct banks
  return BQ * (DP + 1) + BKV * (DP + 1) + BKV * DP + BQ * p_pitch<DP>();
}

// sum or max over the TX lanes of a row (a power of two, lanes contiguous)
template <int TX>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int TX>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DP>
__global__ void __launch_bounds__(threads<DP>())
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int Hq, int Hkv, int D, int causal, int window, float scale) {
  constexpr int TX = lanes<DP>();
  constexpr int THREADS = threads<DP>();
  constexpr int CN = BKV / TX;  // score columns of a thread: tx + TX*j
  constexpr int DC = DP / TX;   // output columns of a thread: tx + TX*c
  constexpr int QK_PITCH = DP + 1;
  constexpr int P_PITCH = p_pitch<DP>();
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][QK_PITCH]
  float* Ks = Qs + BQ * QK_PITCH;    // [BKV][QK_PITCH]
  float* Vs = Ks + BKV * QK_PITCH;   // [BKV][DP]
  float* Ps = Vs + BKV * DP;         // [BQ][P_PITCH]

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const long long q_row = (long long)Hq * D;    // stride between positions
  const long long kv_row = (long long)Hkv * D;
  const T* qb = q + ((long long)b * Sq * Hq + h) * D;
  const T* kb = k + ((long long)b * Skv * Hkv + hk) * D;
  const T* vb = v + ((long long)b * Skv * Hkv + hk) * D;
  T* ob = o + ((long long)b * Sq * Hq + h) * D;

  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP, d = i % DP, s = q0 + r;
    Qs[r * QK_PITCH + d] = (s < Sq && d < D) ? load_f32(qb + s * q_row + d) : 0.f;
  }

  // kv tiles this block must visit
  const bool has_window = window > 0;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const bool rows_all_live =
      !has_window || (long long)q_last < (long long)Skv + window - 1;
  int k_lo = 0, k_hi = Skv - 1;
  if (rows_all_live) {
    if (causal) k_hi = min(k_hi, q_last);
    if (has_window) k_lo = max(0, q0 - window + 1);
  }

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = k_lo / BKV; t <= k_hi / BKV; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BKV * DP; i += THREADS) {
      const int r = i / DP, d = i % DP, s = k0 + r;
      const bool in = s < Skv && d < D;
      Ks[r * QK_PITCH + d] = in ? load_f32(kb + s * kv_row + d) : 0.f;
      Vs[r * DP + d] = in ? load_f32(vb + s * kv_row + d) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty * RM + i) * QK_PITCH + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + TX * j) * QK_PITCH + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tx + TX * j;
        float x;
        if (kj >= Skv) {
          x = -INFINITY;  // not a key: weight exactly 0
        } else {
          const bool live = (!causal || kj <= qi) && (!has_window || qi - kj < window);
          x = live ? s[i][j] * scale : NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max<TX>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * RM + i) * P_PITCH + tx + TX * j] = p;
      }
      sum = row_sum<TX>(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a warp reads back only the rows of P it wrote

    const float* prow = Ps + ty * RM * P_PITCH;
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = prow[i * P_PITCH + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[kk * DP + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + TX * c;
      if (d < D) store_f32(ob + qi * q_row + d, acc[i][c] / denom);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<DP>() * (int)sizeof(float);
  static_assert(smem <= 232448, "over the 227 KB of shared memory of a block");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, DP><<<grid, threads<DP>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, D,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                     int window, float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, scale, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, scale, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, scale, stream);
  return launch<T, 256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, scale, stream);
}

}  // namespace

// q: (B, Sq, Hq, D), k and v: (B, Skv, Hkv, D), o like q, all contiguous and
// of one type (bf16 != 0: bfloat16, else float32), D <= 256.  window <= 0:
// no window.  Launches on `stream` without synchronising; returns the
// cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int bf16, int B, int Sq, int Skv, int Hq, int Hkv,
                         int D, int causal, int window, float scale,
                         void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq < 1 ||
      Hq > 65535 || Hq % Hkv != 0 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                        causal, window, scale, s);
  return (int)dispatch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                              window, scale, s);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
