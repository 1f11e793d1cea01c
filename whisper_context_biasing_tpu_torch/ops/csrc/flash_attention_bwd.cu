// Flash attention backward, full or causal, with a key-length mask.
//
// Replaces the TPU kernel whisper_context_biasing_tpu/ops/flash_attention.py:
// _bwd_kernel (its pallas_call in _flash_core_bwd). That kernel is the fused
// 5-product backward: per q-block it recomputes the softmax, writes dq, and
// adds into dk/dv blocks that stay in VMEM across the *sequential* q-block
// grid axis. Hopper blocks run in parallel and in no order, so nothing can
// carry over between them; this port splits the work in two kernels, each
// with a loop inside the block in place of the sequential axis:
//
//   dq kernel    one block per (q-tile of 64 rows, batch*head): computes
//                D = rowsum(do * o) for its rows (written out for the other
//                kernel), then walks the k-tiles: S = q k^T, P = exp(S*scale
//                - lse), dP = do v^T, dS = P (dP - D) scale, dq += dS k.
//   dk/dv kernel one block per (k-tile of 64 keys, batch*head): keeps its dk
//                and dv in registers and walks the q-tiles, recomputing S, P,
//                dP and dS: dv += P^T do, dk += dS^T q.
//
// That is 7 products where the Pallas kernel does 5 (S and dP are computed
// in both kernels), in exchange for a deterministic result: no atomics, every
// sum in a fixed order. P comes from the logsumexp the forward saved, not
// from a recomputed row max and sum as in Pallas; both give softmax(S) to
// f32 rounding.
//
// Masks: key j >= kv_len, query row i >= Tq, and (causal) j > i give P = 0
// exactly, so a masked entry adds nothing to any sum and a fully masked tile
// never yields exp(0). Causal blocks skip the tiles wholly above the diagonal.
//
// Numerics follow _bwd_kernel: do and o widen to f32 for D; dS is rounded to
// the input dtype before dS k and dS^T q, P before P^T do; every sum is f32;
// dq, dk and dv are written in the input dtype at the end.
//
// What bounds it on an H100: 10*Tq*Tk*64 operations per head (5 products;
// half that causal) against ~8*T*64 elements moved: operations. Like the
// forward, this first version computes in f32 on the CUDA cores, 4x4 outputs
// per thread from float4 reads of shared memory, so it is bound by the f32
// rate and shared-memory traffic, far below the bf16 tensor-core bound;
// wgmma and TMA are later work.
//
// Layout: q, o, do (B, Tq, H, 64), k, v (B, Tk, H, 64) with any batch, row and
// head strides (the last axis contiguous); lse and D (B, H, Tq) f32; dq, dk,
// dv with strides of their own.
#include "common.cuh"

namespace {

constexpr int D = 64;    // head dim
constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile (== BQ: the causal tile skipping relies on it)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PS = BK + 4;    // row stride of the (BQ, BK) tiles in shared memory

struct Strides {
  long long b, t, h;
};

// Rows [r0, r0 + 64) of a (T, 64) head slice into shared memory, transposed
// ([64][64], d-major) and, if `rm` is given, also row-major; rows at or past
// n are zero. Lanes walk rows, so the transposed writes do not conflict.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, long long st, int r0,
                                          int n, float* tr, float* rm) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int d = i / 64;
    const int r = i - d * 64;
    const float x = (r0 + r < n) ? to_f32(base[(r0 + r) * st + d]) : 0.f;
    tr[d * 64 + r] = x;
    if (rm) rm[r * D + d] = x;
  }
}

// s = q k^T and dp = do v^T for one (q-tile, k-tile) pair: thread (ty, tx)
// owns rows ty*4.. and columns tx*4.. of both.
__device__ __forceinline__ void scores(const float* qT, const float* doT, const float* kT,
                                       const float* vT, int ty, int tx, float s[4][4],
                                       float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(qT + d * BQ + ty * 4);
    const float4 g = *reinterpret_cast<const float4*>(doT + d * BQ + ty * 4);
    const float4 c = *reinterpret_cast<const float4*>(kT + d * BK + tx * 4);
    const float4 w = *reinterpret_cast<const float4*>(vT + d * BK + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
    const float cv[4] = {c.x, c.y, c.z, c.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], cv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], wv[j], dp[i][j]);
      }
  }
}

// P and dS of one tile pair, in place of s and dp; rows q0 + ty*4 + i,
// columns k0 + tx*4 + j. Masked entries are exactly 0.
__device__ __forceinline__ void probs_and_ds(float s[4][4], float dp[4][4], const float* lse_s,
                                             const float* d_s, int q0, int k0, int ty, int tx,
                                             int Tq, int kv_len, float scale, int causal) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      const bool keep = r < Tq && col < kv_len && (!causal || col <= r);
      const float p = keep ? expf(s[i][j] * scale - lse_s[ty * 4 + i]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - d_s[ty * 4 + i]) * scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse, const T* __restrict__ dO,
                        T* __restrict__ dq, float* __restrict__ dterm, int H, int Tq,
                        int kv_len, float scale, int causal, Strides sq, Strides sk,
                        Strides sv, Strides so, Strides sdo, Strides sdq) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* doT = qT + D * BQ;                     // [D][BQ]
  float* kT = doT + D * BQ;                     // [D][BK]
  float* vT = kT + D * BK;                      // [D][BK]
  float* ks = vT + D * BK;                      // [BK][D]
  float* dss = ks + BK * D;                     // [BQ][PS] dS, rounded to T
  float* lse_s = dss + BQ * PS;                 // [BQ]
  float* d_s = lse_s + BQ;                      // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* ob = o + b * so.b + h * so.h;
  const T* dob = dO + b * sdo.b + h * sdo.h;

  load_tile(qb, sq.t, q0, Tq, qT, nullptr);
  load_tile(dob, sdo.t, q0, Tq, doT, nullptr);
  {  // D = rowsum(do * o) in f32, four lanes per row
    const int r = tid / 4;
    const int part = tid % 4;
    const bool in = q0 + r < Tq;
    float acc = 0.f;
    if (in) {
      const T* dor = dob + (q0 + r) * sdo.t;
      const T* orow = ob + (q0 + r) * so.t;
      for (int d = part * 16; d < part * 16 + 16; ++d)
        acc = fmaf(to_f32(dor[d]), to_f32(orow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const long long at = static_cast<long long>(bh) * Tq + q0 + r;
      d_s[r] = acc;
      lse_s[r] = in ? lse[at] : 0.f;
      if (in) dterm[at] = acc;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q0 / BK + 1);  // tiles up to the diagonal
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's kT, vT, ks and dss are consumed
    load_tile(kb, sk.t, k0, kv_len, kT, ks);
    load_tile(vb, sv.t, k0, kv_len, vT, nullptr);
    __syncthreads();

    float s[4][4], ds[4][4];
    scores(qT, doT, kT, vT, ty, tx, s, ds);
    probs_and_ds(s, ds, lse_s, d_s, q0, k0, ty, tx, Tq, kv_len, scale, causal);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dss + (ty * 4 + i) * PS + tx * 4) =
          make_float4(round_to<T>(ds[i][0]), round_to<T>(ds[i][1]),
                      round_to<T>(ds[i][2]), round_to<T>(ds[i][3]));
    __syncthreads();

    // dq[r][d] += sum_c dS[r][c] k[c][d]: thread owns rows ty*4.., dims tx*4..
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const float4 w = *reinterpret_cast<const float4*>(ks + c * D + tx * 4);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = dss[(ty * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(g, wv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    T* row = dq + b * sdq.b + r * sdq.t + h * sdq.h + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ lse,
                          const T* __restrict__ dO, const float* __restrict__ dterm,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
                          int kv_len, float scale, int causal, Strides sq, Strides sk,
                          Strides sv, Strides sdo, Strides sdk, Strides sdv) {
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // [D][BK]
  float* vT = kT + D * BK;                      // [D][BK]
  float* qT = vT + D * BK;                      // [D][BQ]
  float* qs = qT + D * BQ;                      // [BQ][D]
  float* doT = qs + BQ * D;                     // [D][BQ]
  float* dos = doT + D * BQ;                    // [BQ][D]
  float* ps = dos + BQ * D;                     // [BQ][PS] P, rounded to T
  float* dss = ps + BQ * PS;                    // [BQ][PS] dS, rounded to T
  float* lse_s = dss + BQ * PS;                 // [BQ]
  float* d_s = lse_s + BQ;                      // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dO + b * sdo.b + h * sdo.h;

  // dk, dv rows k0 + ty*4 + i, dims tx*4 + j, summed over every q-tile in f32
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  if (k0 < kv_len) {
    load_tile(kb, sk.t, k0, kv_len, kT, nullptr);
    load_tile(vb, sv.t, k0, kv_len, vT, nullptr);
    const int n_qt = (Tq + BQ - 1) / BQ;
    for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {  // causal: skip tiles above
      const int q0 = qt * BQ;                              // the diagonal
      __syncthreads();  // the previous tile's q, do, P and dS are consumed
      load_tile(qb, sq.t, q0, Tq, qT, qs);
      load_tile(dob, sdo.t, q0, Tq, doT, dos);
      if (tid < BQ) {
        const bool in = q0 + tid < Tq;
        const long long at = static_cast<long long>(bh) * Tq + q0 + tid;
        lse_s[tid] = in ? lse[at] : 0.f;
        d_s[tid] = in ? dterm[at] : 0.f;
      }
      __syncthreads();

      float p[4][4], ds[4][4];
      scores(qT, doT, kT, vT, ty, tx, p, ds);
      probs_and_ds(p, ds, lse_s, d_s, q0, k0, ty, tx, Tq, kv_len, scale, causal);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(ps + (ty * 4 + i) * PS + tx * 4) =
            make_float4(round_to<T>(p[i][0]), round_to<T>(p[i][1]), round_to<T>(p[i][2]),
                        round_to<T>(p[i][3]));
        *reinterpret_cast<float4*>(dss + (ty * 4 + i) * PS + tx * 4) =
            make_float4(round_to<T>(ds[i][0]), round_to<T>(ds[i][1]),
                        round_to<T>(ds[i][2]), round_to<T>(ds[i][3]));
      }
      __syncthreads();

      // dv[c][d] += sum_r P[r][c] do[r][d]; dk[c][d] += sum_r dS[r][c] q[r][d]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float4 pa = *reinterpret_cast<const float4*>(ps + r * PS + ty * 4);
        const float4 sa = *reinterpret_cast<const float4*>(dss + r * PS + ty * 4);
        const float4 ga = *reinterpret_cast<const float4*>(dos + r * D + tx * 4);
        const float4 qa = *reinterpret_cast<const float4*>(qs + r * D + tx * 4);
        const float pv[4] = {pa.x, pa.y, pa.z, pa.w}, sv4[4] = {sa.x, sa.y, sa.z, sa.w};
        const float gv[4] = {ga.x, ga.y, ga.z, ga.w}, qv[4] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv4[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

  // keys in [kv_len, Tk) get zero gradients
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= Tk) continue;
    T* krow = dk + b * sdk.b + c * sdk.t + h * sdk.h + tx * 4;
    T* vrow = dv + b * sdv.b + c * sdv.t + h * sdv.h + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      krow[j] = from_f32<T>(dk_acc[i][j]);
      vrow[j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dO, void* dq, void* dk, void* dv, float* dterm, int B, int H, int Tq,
           int Tk, int kv_len, float scale, int causal, const Strides* st,
           cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * (5 * D * 64 + BQ * PS + 2 * BQ);
  const size_t smem_dkdv = sizeof(float) * (6 * D * 64 + 2 * BQ * PS + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dO);
  // st: q, k, v, o, do, dq, dk, dv
  flash_bwd_dq_kernel<T><<<dim3((Tq + BQ - 1) / BQ, B * H), THREADS, smem_dq, stream>>>(
      qp, kp, vp, static_cast<const T*>(o), lse, dop, static_cast<T*>(dq), dterm, H, Tq,
      kv_len, scale, causal, st[0], st[1], st[2], st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // same stream: runs after the dq kernel has written D
  flash_bwd_dkdv_kernel<T><<<dim3((Tk + BK - 1) / BK, B * H), THREADS, smem_dkdv, stream>>>(
      qp, kp, vp, lse, dop, dterm, static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk,
      kv_len, scale, causal, st[0], st[1], st[2], st[4], st[6], st[7]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements, 3 per tensor (batch, row, head) in the order q, k,
// v, o, do, dq, dk, dv. dterm is (B, H, Tq) f32 scratch. kv_len <= Tk keys are
// attended; causal needs Tq == Tk.
WCB_EXPORT int wcb_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* o, const float* lse, const void* dO, void* dq,
                             void* dk, void* dv, float* dterm, int B, int H, int Tq, int Tk,
                             int kv_len, float scale, int causal, const long long* strides,
                             cudaStream_t stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1],
                                              strides[3 * i + 2]};
  if (dtype == WCB_F32)
    return launch<float>(q, k, v, o, lse, dO, dq, dk, dv, dterm, B, H, Tq, Tk, kv_len,
                         scale, causal, st, stream);
  if (dtype == WCB_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, lse, dO, dq, dk, dv, dterm, B, H, Tq, Tk,
                                 kv_len, scale, causal, st, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
