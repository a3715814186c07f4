// Causal GQA flash-attention forward for Hopper (sm_90a), on tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _fa_kernel): the same function, computed the
// way this card wants it rather than copied block by block.
//   * scale D**-0.5; query head h reads kv head h / (Hq / Hkv);
//   * mask: k_pos <= q_pos (causal), q_pos - k_pos < window, in bounds, with
//     positions aligned at the top left (row i is position i, also when
//     Sq != Skv); masked scores are -1e30 as in the reference;
//   * f32 running (m, l, acc) across kv tiles; out = acc / max(l, 1e-30),
//     cast to the input type.  Inputs are f32 or bf16.
//
// Design (FlashAttention-2's shape on mma.sync).  One block per (q tile of
// BQ rows, query head, batch row); each warp owns 16 query rows, across the
// whole head dim (DS = 1) or a 1/DS share of it (DS = 2 or 4: the DS warps
// of a row band each compute the scores over their share of D, the partial
// score tiles are summed through shared memory in one order, and each warp
// keeps the output of its share).  The TPU's sequential kv grid axis becomes
// a loop over kv tiles of BKV keys.  S = Q K^T is computed into mma
// accumulator fragments; the online softmax runs in registers (row max over
// the 4 lanes of a quad by __shfl_xor_sync 1, 2; the row sum stays per lane
// until the end); P feeds P V from registers.
//   * f32 inputs: mma.sync m16n8k8 tf32 in the 3xTF32 form.  Each operand x
//     is split as hi = rna.tf32(x), lo = rna.tf32(x - hi) (the rounding of
//     cvt.rna.tf32.f32, done with two integer instructions), and
//     lo*hi + hi*lo go into the accumulator before hi*hi, for both products
//     (P is split the same way).  Why not plain TF32: it rounds q, k, v and P
//     to 11 significant bits, and on normal inputs that moves the output by
//     about 1.3e-3, 250 times the f32 bar of 5e-6; the split form keeps
//     about 21 bits and lands near 2e-6 (tests/test_torch_kernels.py
//     emulates both).  The C fragment gives a thread the keys {2t, 2t+1} of
//     an 8-key step, the tf32 A fragment wants {t, t+4}: P is fed as it
//     lies, and V's B fragment reads key 2t where the MMA expects t and key
//     2t+1 where it expects t+4.  The key index is summed over, so the
//     product is unchanged (testing.tf32_pv_key_order is that map).
//   * Short MMA sums.  The tensor cores round the sums they accumulate
//     toward zero, so a long chain of MMAs into one accumulator drifts: with
//     S summed over all of D = 256 and P V over all 2048 keys in the
//     accumulators, the error at recurrentgemma-2b's prefill was over the
//     5e-6 bar.  So S is summed in chunks of 4 k-steps in fresh
//     accumulators, each chunk added to S in f32, and each tile's P V in
//     fresh accumulators folded into the output by one f32 FMA with the
//     rescale (under 3e-6 at that shape, PERF.md).
//   * bf16 inputs: mma.sync m16n8k16 bf16 with f32 accumulation; the C
//     fragment is the A fragment as it lies.  P is carried as two bf16 terms
//     (hi + lo, two P V MMAs), so that P is not rounded to 8 bits before the
//     product.  V's fragments come by ldmatrix.trans.
//   * K and V tiles are staged by 16-byte cp.async.  By default into two
//     shared-memory stages, so that tile t+1 loads while tile t computes.
//     With QS (the f32 default at DP = 256), Q is split into its TF32 terms
//     once per block and kept in shared memory, which leaves room for one
//     stage each of K and V: K of tile t+1 loads during tile t's softmax and
//     P V, V of tile t+1 during tile t+1's Q K^T.  Q, K fragments come by
//     ldmatrix (an f32 word is a pair of 16-bit halves).  Rows are padded
//     (f32: DP + 4 floats, bf16: DP + 8 halves), so that each 8-row ldmatrix
//     phase reads 8 distinct 16-byte bank groups and the permuted V reads
//     of a quad (lanes t, rows 2t) land on banks 8t + g: all fragment loads
//     are free of bank conflicts.  A head dim whose rows are not 16-byte
//     multiples (or an unaligned pointer) is staged by plain loads instead.
//   * Tiles wholly above the causal diagonal or wholly before the window are
//     never visited; tiles inside the mask skip the mask arithmetic.  The
//     grid is (Hq, B, q tiles) with the q tile reversed, so the heaviest
//     tiles of the causal triangle start first.
//   * The head dim is padded to DP in {32, 64, 128, 256} in shared memory
//     only (zero-filled by cp.async); the wrapper never pads.
//
// Tiles: the default of each (type, DP), which flash_fwd launches and the
// serving library alone holds.  Built with -DFLASH_BENCH_VARIANTS (bench.py
// and the card tests), the library also holds the variants that lost to
// them (VARIANTS), which flash_fwd_variant runs.
// Registers are ptxas's (0 spills; chip_smoke.py's build phase
// prints them and fails on any spill), blocks per SM the fewer that
// registers and shared memory allow.
//   f32  DP 256: 8 warps, BQ 64, BKV 32, DS 2, QS: 211 KB, 238 registers, 1
//   f32  DP 128: 4 warps, BQ 64, BKV 32: 99 KB, 241 registers, 2
//   f32  DP 64:  4 warps, BQ 64, BKV 64: 85 KB, 239 registers, 2
//   f32  DP 32:  4 warps, BQ 64, BKV 64: 45 KB, 164 registers, 3
//   bf16 DP 256: 8 warps, BQ 64, BKV 32, DS 2: 115 KB, 238 registers, 1
//   bf16 DP 128 / 64 / 32: 4 warps, BQ 64, BKV 64: 85 / 45 / 25 KB,
//                255 / 178 / 134 registers, 2 / 2 / 3
// With DS = 1 at DP = 256 the output fragment alone is 128 registers a
// thread, and both types spilled at BKV 32 (f32 also at 16), so no such
// variant is kept.  Eight warps of one block run on an SM at DP = 256: the
// products' MMA chains are short and the warps few, so the kernel is held by
// the latency of the MMAs, the TF32 splits and the barriers between phases,
// not by the tensor cores' rate (PERF.md).
//
// Sentinel.  m starts at -1e30, the masked score.  A row whose first visited
// tile has no live key accumulates exp(0) = 1 weights there; the first live
// key later multiplies them by exp(-1e30 - m) = 0, exactly.  A row with no
// live key at all (only with a window and Sq > Skv) gets the reference's
// uniform average over all Skv keys: its block visits every tile.  Keys past
// Skv get weight 0 through -inf.  Scores are kept in log2 units (scaled by
// D**-0.5 * log2(e)) and exponentiated with exp2f.
//
// Bound on an H100 SXM.  Attention needs 4*D flops per live (q, k) pair; in
// 3xTF32 each is three TF32 products, so f32 is bound by 3 * 4*D flops per
// pair over the 495 TFLOP/s TF32 peak.  At recurrentgemma-2b's prefill
// (B=4, S=2112, Hq=10, Hkv=1, D=256, window 2048, f32) that is 3 x 91.3
// GFLOP, 0.553 ms, against 190 MB of q/k/v/o, 57 us: bound by operations.
// At smollm-360m's serving shape (B=4, S=256, Hq=15, Hkv=5, D=64, f32,
// causal) it is 3 x 0.51 GFLOP, 3.1 us, against 10.5 MB, 3.1 us: bytes and
// operations meet; at its 512-token shape operations, 12.2 us.  bf16 inputs
// are bound by 4*D flops per pair at 989 TFLOP/s, or by their bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int DP, int NW, int BKV, int DS, int QS>
struct Tile {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int THREADS = 32 * NW;
  static constexpr int BQ = 16 * NW / DS;              // query rows of a block
  static constexpr int PITCH = DP + (F32 ? 4 : 8);     // row pitch, elements
  static constexpr int DW = DP / DS;                   // head-dim columns of a warp
  static constexpr int NT = BKV / 8;                   // 8-key score fragments
  static constexpr int NO = DW / 8;                    // 8-column output fragments
  static constexpr int XS_BYTES = DS > 1 ? 4 * NW * 32 * (BKV / 2) : 0;
  // QS: Q is split once into TF32 hi (in place) and lo (beside it), and K
  // and V have one stage each, K loading during P V and V during Q K^T
  static constexpr int STAGES = QS ? 1 : 2;
  static constexpr int QLO_BYTES = QS ? 4 * BQ * PITCH : 0;
  static constexpr int SMEM =
      (int)sizeof(T) * PITCH * (BQ + 2 * STAGES * BKV) + QLO_BYTES + XS_BYTES;
  static_assert(NW % DS == 0 && (DS == 1 || DS == 2 || DS == 4), "warps and split");
  static_assert(DW % 16 == 0 && BKV % 16 == 0, "fragment steps");
  static_assert(!QS || F32, "Q is split for the f32 route only");
  static_assert(SMEM <= 232448, "over the 227 KB of shared memory of a block");
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// cvt.rna.tf32.f32 for a finite x: the 13 low mantissa bits rounded half away
// from zero.  Two integer instructions; ptxas expands the cvt itself into
// four or more, with a guard for NaN and infinity that finite inputs do not
// need.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to about 21 significant bits, both terms exact in TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b, 16 x 8 x 8, tf32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b, 16 x 8 x 16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 8 matrices of 16-bit pairs (or of f32 words: lane l gets word
// l % 4 of row l / 4 of each), rows addressed by lanes 8i..8i+7
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) -> bf16 pairs hi and lo with x = hi + lo to about 16 bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void store2(float* p, float x, float y, bool both) {
  p[0] = x;
  if (both) p[1] = y;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y, bool both) {
  p[0] = __float2bfloat16(x);
  if (both) p[1] = __float2bfloat16(y);
}

// ROWS rows of a (S, D) slice with row stride `stride`, from row s0, into a
// shared tile of pitch PITCH padded to DP columns; rows past S and columns
// past D are zeros.  vec: 16-byte cp.async (D * sizeof(T) a multiple of 16,
// pointers aligned); else plain loads.
template <typename T, int DP, int ROWS, int THREADS, int PITCH>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride, int s0,
                                      int S, int D, bool vec) {
  if (vec) {
    constexpr int EPC = 16 / (int)sizeof(T);   // elements per chunk
    constexpr int CPR = DP / EPC;              // chunks per row
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * EPC, s = s0 + r;
      const bool in = s < S && c < D;
      cp_async16(dst + r * PITCH + c, in ? src + s * stride + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP, s = s0 + r;
      dst[r * PITCH + c] = (s < S && c < D) ? src[s * stride + c] : zero<T>();
    }
  }
}

template <typename T, int DP, int NW, int BKV, int DS, int QS>
__global__ void __launch_bounds__(32 * NW, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int Hq, int Hkv, int D, int causal, int window, float scale,
                 int vec) {
  using C = Tile<T, DP, NW, BKV, DS, QS>;
  constexpr int BQ = C::BQ, P = C::PITCH, DW = C::DW, NT = C::NT, NO = C::NO;
  constexpr int THREADS = C::THREADS;
  constexpr int ROW_BYTES = P * (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGES = C::STAGES;
  T* Qs = reinterpret_cast<T*>(smem);     // [BQ][P]
  float* Qlo = reinterpret_cast<float*>(smem + sizeof(T) * BQ * P);   // [BQ][P], QS
  T* Ks = reinterpret_cast<T*>(smem + sizeof(T) * BQ * P + C::QLO_BYTES);  // [STAGES][BKV][P]
  T* Vs = Ks + STAGES * BKV * P;          // [STAGES][BKV][P]
  float* Xs = reinterpret_cast<float*>(Vs + STAGES * BKV * P);  // [NW][BKV/2][32]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int band = warp / DS, d0 = (warp % DS) * DW;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest tiles first
  const int hk = h / (Hq / Hkv);

  const long long q_row = (long long)Hq * D;    // stride between positions
  const long long kv_row = (long long)Hkv * D;
  const T* qb = q + ((long long)b * Sq * Hq + h) * D;
  const T* kb = k + ((long long)b * Skv * Hkv + hk) * D;
  const T* vb = v + ((long long)b * Skv * Hkv + hk) * D;
  T* ob = o + ((long long)b * Sq * Hq + h) * D;

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
  const int t_lo = k_lo / BKV, t_hi = k_hi / BKV;

  stage<T, DP, BQ, THREADS, P>(Qs, qb, q_row, q0, Sq, D, vec);
  stage<T, DP, BKV, THREADS, P>(Ks, kb, kv_row, t_lo * BKV, Skv, D, vec);
  if constexpr (QS) {
    cp_async_commit();
    stage<T, DP, BKV, THREADS, P>(Vs, vb, kv_row, t_lo * BKV, Skv, D, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll 4
    for (int i = threadIdx.x; i < BQ * DP; i += THREADS) {
      const int at = (i / DP) * P + i % DP;
      uint32_t hi, lo;
      split_tf32(Qs[at], hi, lo);
      Qs[at] = __uint_as_float(hi);
      Qlo[at] = __uint_as_float(lo);
    }
  } else {
    stage<T, DP, BKV, THREADS, P>(Vs, vb, kv_row, t_lo * BKV, Skv, D, vec);
    cp_async_commit();
  }

  const float scale_log2 = scale * LOG2E;
  const int r0 = q0 + band * 16 + g;   // this lane's rows: r0 and r0 + 8
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // ldmatrix row addresses (bytes).  A fragment of Q: lane l gives row
  // 8 * ((l >> 3) & 1) + (l & 7) of the warp's 16, at 16 bytes * (l >> 4)
  // into the k-step.  B fragments of K for score fragments n and n + 1: lane
  // l gives key 8 * (l >> 4) + (l & 7) of the pair, at 16 bytes *
  // ((l >> 3) & 1) into the k-step.
  const int qa_off = (band * 16 + 8 * ((lane >> 3) & 1) + (lane & 7)) * ROW_BYTES +
                     16 * (lane >> 4);
  const unsigned char* qa = reinterpret_cast<const unsigned char*>(Qs) + qa_off;
  const unsigned char* qla = reinterpret_cast<const unsigned char*>(Qlo) + qa_off;
  const int kb_off = (8 * (lane >> 4) + (lane & 7)) * ROW_BYTES + 16 * ((lane >> 3) & 1);
  constexpr int KSTEP = C::F32 ? 8 : 16;          // head-dim columns of an MMA
  constexpr int KSTEP_BYTES = KSTEP * (int)sizeof(T);
  constexpr int KC = DW / KSTEP < 4 ? DW / KSTEP : 4;   // k-steps of a chunk
  constexpr int NCH = DW / (KSTEP * KC);
  constexpr int NCH_UNROLL = NCH <= 2 ? NCH : 2;

  int buf = 0;
  for (int tile = t_lo; tile <= t_hi; ++tile, buf ^= 1) {
    const int k0 = tile * BKV;
    if constexpr (QS) {   // K of this tile has come; V may still be coming
      cp_async_wait<1>();
    } else if (tile < t_hi) {   // the next tile loads while this one computes
      const int nxt = (buf ^ 1) * BKV * P;
      stage<T, DP, BKV, THREADS, P>(Ks + nxt, kb, kv_row, k0 + BKV, Skv, D, vec);
      stage<T, DP, BKV, THREADS, P>(Vs + nxt, vb, kv_row, k0 + BKV, Skv, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + (STAGES - 1) * buf * BKV * P;
    const T* Vt = Vs + (STAGES - 1) * buf * BKV * P;
    const unsigned char* kt = reinterpret_cast<const unsigned char*>(Kt) + kb_off;

    // S = Q K^T over this warp's head-dim columns, in NCH chunks of KC
    // k-steps: each chunk accumulates in fresh MMA registers and is added to
    // s in f32, so the MMAs' own rounding of their sums stays within a chunk
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll NCH_UNROLL
    for (int ch = 0; ch < NCH; ++ch) {
      float c[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KC; ++ks) {
        const int kbytes = (d0 / KSTEP + ch * KC + ks) * KSTEP_BYTES;
        uint32_t a[4];
        ldmatrix_x4(a, qa + kbytes);
        if constexpr (C::F32) {
          uint32_t ah[4], al[4];
          if constexpr (QS) {
            ldmatrix_x4(al, qla + kbytes);
#pragma unroll
            for (int i = 0; i < 4; ++i) ah[i] = a[i];
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
          }
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t bk[4], lo[4];
            ldmatrix_x4(bk, kt + 8 * n * ROW_BYTES + kbytes);
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(bk[i]), bk[i], lo[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              bh[n + i / 2][i % 2] = bk[i];
              bl[n + i / 2][i % 2] = lo[i];
            }
          }
          // each product for every fragment before the next product, so that
          // the NT accumulator chains interleave
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(c[n], al, bh[n]);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(c[n], ah, bl[n]);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_tf32(c[n], ah, bh[n]);
        } else {
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t bk[4];
            ldmatrix_x4(bk, kt + 8 * n * ROW_BYTES + kbytes);
            const uint32_t b0[2] = {bk[0], bk[1]}, b1[2] = {bk[2], bk[3]};
            mma_bf16(c[n], a, b0);
            mma_bf16(c[n + 1], a, b1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += c[n][e];
    }
    // the band's DS partial scores, summed in one order by all its warps,
    // so that they hold the same S, m and P bit for bit
    float* xs = Xs + band * DS * (BKV / 2) * 32;
    if constexpr (DS > 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[((warp % DS) * NT * 4 + 4 * n + e) * 32 + lane] = s[n][e];
    }
    if constexpr (DS > 1 || QS) __syncthreads();   // partials written, K read
    if constexpr (QS) {
      if (tile < t_hi) {   // the next K loads during the softmax and P V
        stage<T, DP, BKV, THREADS, P>(Ks, kb, kv_row, k0 + BKV, Skv, D, vec);
        cp_async_commit();
      }
    }
    if constexpr (DS > 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = xs[(4 * n + e) * 32 + lane];
#pragma unroll
          for (int i = 1; i < DS; ++i) sum += xs[(i * NT * 4 + 4 * n + e) * 32 + lane];
          s[n][e] = sum;
        }
    }

    // mask, scale to log2 units, online softmax; P overwrites S
    const bool need_mask = k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0) ||
                           (has_window && q0 + BQ - 1 - k0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (need_mask) {
          const int qi = r0 + 8 * (e >> 1), kj = k0 + 8 * n + 2 * t + (e & 1);
          if (kj >= Skv) {
            x = -INFINITY;   // not a key: weight exactly 0
          } else if ((causal && kj > qi) || (has_window && qi - kj >= window)) {
            x = NEG_INF;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }

    if constexpr (QS) {   // V of this tile has come; the next K may be coming
      if (tile < t_hi) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }

    // O = O * corr + P V over this warp's head-dim columns: each 8-column
    // fragment sums the tile's keys in fresh MMA registers, then one f32 FMA
    // folds them into the running output
    if constexpr (C::F32) {
      // P's C fragment as the A fragment: A column t is key 2t, t+4 is 2t+1
      uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        split_tf32(s[j][0], ph[j][0], pl[j][0]);
        split_tf32(s[j][2], ph[j][1], pl[j][1]);
        split_tf32(s[j][1], ph[j][2], pl[j][2]);
        split_tf32(s[j][3], ph[j][3], pl[j][3]);
      }
      const int v_off = 2 * t * P + d0 + g;
      constexpr int NB = NO < 4 ? NO : 4;   // output fragments in flight
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NB) {
        float c[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const int at = v_off + 8 * j * P + 8 * (n0 + nb);   // key 8j + 2t, then + 1
            split_tf32(Vt[at], bh[nb][0], bl[nb][0]);
            split_tf32(Vt[at + P], bh[nb][1], bl[nb][1]);
          }
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma_tf32(c[nb], pl[j], bh[nb]);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma_tf32(c[nb], ph[j], bl[nb]);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma_tf32(c[nb], ph[j], bh[nb]);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n0 + nb][e] = fmaf(acc[n0 + nb][e], corr[e >> 1], c[nb][e]);
      }
    } else {
      uint32_t ph[NT / 2][4], pl[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        split_bf16(s[2 * j][0], s[2 * j][1], ph[j][0], pl[j][0]);
        split_bf16(s[2 * j][2], s[2 * j][3], ph[j][1], pl[j][1]);
        split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], ph[j][2], pl[j][2]);
        split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], ph[j][3], pl[j][3]);
      }
      // lane l addresses row (l & 15) of each 16-key step, columns 8 * (l >> 4)
      const T* vr = Vt + (lane & 15) * P + d0 + 8 * (lane >> 4);
      constexpr int NB = NO < 4 ? NO : 4;   // output fragments in flight
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NB) {
        float c[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t bv[NB][2];
#pragma unroll
          for (int nb = 0; nb < NB; nb += 2) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, vr + 16 * j * P + 8 * (n0 + nb));
            bv[nb][0] = r[0];
            bv[nb][1] = r[1];
            bv[nb + 1][0] = r[2];
            bv[nb + 1][1] = r[3];
          }
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma_bf16(c[nb], pl[j], bv[nb]);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma_bf16(c[nb], ph[j], bv[nb]);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n0 + nb][e] = fmaf(acc[n0 + nb][e], corr[e >> 1], c[nb][e]);
      }
    }
    __syncthreads();   // this stage is loaded again by the next iteration
    if constexpr (QS) {
      if (tile < t_hi) {   // the next V loads during the next Q K^T
        stage<T, DP, BKV, THREADS, P>(Vs, vb, kv_row, k0 + BKV, Skv, D, vec);
        cp_async_commit();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= Sq) continue;
    T* orow = ob + qi * q_row;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = d0 + 8 * n + 2 * t;
      if (d < D)
        store2(orow + d, acc[n][2 * i] * l[i], acc[n][2 * i + 1] * l[i], d + 1 < D);
    }
  }
}

template <typename T, int DP, int NW, int BKV, int DS, int QS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                   int window, float scale, cudaStream_t stream) {
  using C = Tile<T, DP, NW, BKV, DS, QS>;
  auto kernel = flash_fwd_kernel<T, DP, NW, BKV, DS, QS>;
  // the shared-memory limit is raised once per instantiation and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static bool smem_set[64] = {};
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = true;
  }
  const int nq = (Sq + C::BQ - 1) / C::BQ;
  if (nq > 65535) return cudaErrorInvalidValue;
  const bool vec = (D * (int)sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid(Hq, B, nq);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, D,
      causal, window, scale, (int)vec);
  return cudaGetLastError();
}

typedef cudaError_t (*LaunchFn)(const void*, const void*, const void*, void*, int,
                                int, int, int, int, int, int, int, float,
                                cudaStream_t);

// The tiles flash_fwd launches for each (type, DP), as in the table above.
LaunchFn default_tiles(int bf16, int dp) {
  if (!bf16) {
    switch (dp) {
      case 32: return launch<float, 32, 4, 64, 1, 0>;
      case 64: return launch<float, 64, 4, 64, 1, 0>;
      case 128: return launch<float, 128, 4, 32, 1, 0>;
      case 256: return launch<float, 256, 8, 32, 2, 1>;
    }
  } else {
    switch (dp) {
      case 32: return launch<__nv_bfloat16, 32, 4, 64, 1, 0>;
      case 64: return launch<__nv_bfloat16, 64, 4, 64, 1, 0>;
      case 128: return launch<__nv_bfloat16, 128, 4, 64, 1, 0>;
      case 256: return launch<__nv_bfloat16, 256, 8, 32, 2, 0>;
    }
  }
  return nullptr;
}

#ifdef FLASH_BENCH_VARIANTS
struct Variant {
  int bf16, dp, warps, bkv, dsplit, qsplit, smem;
  LaunchFn fn;
};

#define VARIANT(T, BF, DP, NW, BKV, DS, QS) \
  {BF, DP, NW, BKV, DS, QS, Tile<T, DP, NW, BKV, DS, QS>::SMEM, launch<T, DP, NW, BKV, DS, QS>}

// The defaults and the variants measured against them (PERF.md)
const Variant VARIANTS[] = {
    VARIANT(float, 0, 32, 4, 64, 1, 0),
    VARIANT(float, 0, 64, 4, 64, 1, 0),
    VARIANT(float, 0, 64, 4, 32, 1, 0),
    VARIANT(float, 0, 128, 4, 32, 1, 0),
    VARIANT(float, 0, 256, 8, 32, 2, 1),
    VARIANT(float, 0, 256, 8, 16, 2, 0),
    VARIANT(float, 0, 256, 16, 16, 4, 0),
    VARIANT(float, 0, 256, 8, 32, 2, 0),
    VARIANT(__nv_bfloat16, 1, 32, 4, 64, 1, 0),
    VARIANT(__nv_bfloat16, 1, 64, 4, 64, 1, 0),
    VARIANT(__nv_bfloat16, 1, 128, 4, 64, 1, 0),
    VARIANT(__nv_bfloat16, 1, 256, 8, 32, 2, 0),
    VARIANT(__nv_bfloat16, 1, 256, 8, 16, 2, 0),
};
constexpr int N_VARIANTS = sizeof(VARIANTS) / sizeof(VARIANTS[0]);
#endif

int padded_dim(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256; }

bool valid(int B, int Sq, int Skv, int Hq, int Hkv, int D) {
  return B >= 1 && B <= 65535 && Sq >= 1 && Skv >= 1 && Hkv >= 1 && Hq >= 1 &&
         Hq % Hkv == 0 && D >= 1 && D <= 256;
}

}  // namespace

// q: (B, Sq, Hq, D), k and v: (B, Skv, Hkv, D), o like q, all contiguous and
// of one type (bf16 != 0: bfloat16, else float32), D <= 256.  window <= 0:
// no window.  Launches the default tiles of D on `stream` without
// synchronising; returns the cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int bf16, int B, int Sq, int Skv, int Hq, int Hkv,
                         int D, int causal, int window, float scale,
                         void* stream) {
  if (!valid(B, Sq, Skv, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  return (int)default_tiles(bf16 != 0, padded_dim(D))(
      q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, scale,
      static_cast<cudaStream_t>(stream));
}

#ifdef FLASH_BENCH_VARIANTS
// The same with the tiles of variant `index` (see flash_fwd_variant_info);
// cudaErrorInvalidValue if that variant is not of this type and D.
extern "C" int flash_fwd_variant(int index, const void* q, const void* k,
                                 const void* v, void* o, int bf16, int B, int Sq,
                                 int Skv, int Hq, int Hkv, int D, int causal,
                                 int window, float scale, void* stream) {
  if (index < 0 || index >= N_VARIANTS || !valid(B, Sq, Skv, Hq, Hkv, D))
    return (int)cudaErrorInvalidValue;
  const Variant& w = VARIANTS[index];
  if (w.bf16 != (bf16 != 0) || w.dp != padded_dim(D)) return (int)cudaErrorInvalidValue;
  return (int)w.fn(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, scale,
                   static_cast<cudaStream_t>(stream));
}

// The number of variants, and variant `index` as
// {bf16, DP, warps, BKV, head-dim split, Q split once, is default,
// shared-memory bytes}.
extern "C" int flash_fwd_variant_count() { return N_VARIANTS; }
extern "C" int flash_fwd_variant_info(int index, int* out) {
  if (index < 0 || index >= N_VARIANTS) return (int)cudaErrorInvalidValue;
  const Variant& w = VARIANTS[index];
  const int vals[8] = {w.bf16, w.dp, w.warps, w.bkv, w.dsplit, w.qsplit,
                       w.fn == default_tiles(w.bf16, w.dp), w.smem};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}
#endif

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
