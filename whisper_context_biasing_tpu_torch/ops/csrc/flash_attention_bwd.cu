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
// sum in a fixed order, so two runs give the same bits. P comes from the
// logsumexp the forward saved, not from a recomputed row max and sum as in
// Pallas; both give softmax(S) to f32 rounding.
//
// What bounds it on an H100: 10*Tq*Tk*64 operations per head (5 products;
// half that causal; this design does 14*Tq*Tk*64) against ~8*T*64 elements
// moved: operations. So the design's job is to keep the tensor cores fed.
//
// bf16 runs every product on the tensor cores with wgmma (m64n64k16, f32
// accumulators; the blocks are in mma_tiles.cuh). Both kernels are one
// warpgroup a block (64 rows, 16 a warp), with bf16 tiles of 64 rows in
// shared memory in the 128-byte-swizzled layout wgmma reads, filled by
// 16-byte cp.async copies along the head dim (each thread's chunk addresses
// fixed before the loop); the streamed tiles run through a ring of three
// stages, so a copy has a whole tile of arithmetic to land and the loop has
// one barrier a tile. P and dS are rounded to bf16 in registers, which are
// the A operand of the next product; neither goes through shared memory, and
// no second copy of any tile exists: one tile is read along its rows by one
// product and across them (the transpose flag) by another.
//   dq kernel    its Q and dO tiles stay in shared memory; K and V tiles
//                stream. S = Q K^T and dP = dO V^T land in accumulator
//                registers, dS becomes the A operand of dq += dS K (the K
//                tile read across its rows).
//   dk/dv kernel computes the transposed tiles: its K and V tiles stay in
//                shared memory as A operands; Q and dO tiles stream with
//                their rows' lse and D (small shared arrays: they index the
//                accumulator's columns here). S^T = K Q^T and dP^T = V dO^T
//                give P^T and dS^T already laid out as the A operands of
//                dv += P^T dO and dk += dS^T Q (the dO and Q tiles read
//                across their rows).
// 64 KB of shared memory a block in either kernel. TMA copies issued by a
// producer warp, products in flight under the elementwise pass, and a
// deterministic 5-product form are the rungs after this one.
//
// f32 is true f32 on the CUDA cores, 4x4 outputs a thread from float4 reads
// of f32 tiles in shared memory: TF32 would keep three decimal digits, and
// the f32 path is what holds the port's training step to its plain version.
//
// Masks: key j >= kv_len, query row i >= Tq, and (causal) j > i give P = 0
// exactly, so a masked entry adds nothing to any sum and a fully masked tile
// never yields exp(0). Causal blocks skip the tiles wholly above the
// diagonal; keys in [kv_len, Tk) get zero gradients.
//
// Numerics follow _bwd_kernel: do and o widen to f32 for D; dS is rounded to
// the input dtype before dS k and dS^T q, P before P^T do; every sum is f32;
// dq, dk and dv are written in the input dtype at the end. The bf16 kernels
// alone take P as 2^(S*scale*log2(e) - lse*log2(e)) on the special-function
// unit's ex2 (about 2 ulp, far inside P's rounding to bf16).
//
// Layout: q, o, do (B, Tq, H, 64), k, v (B, Tk, H, 64) with any batch, row and
// head strides (the last axis contiguous); bf16 needs 16-byte aligned
// pointers and strides that are multiples of 8 elements (the wrapper
// checks); lse and D (B, H, Tq) f32; dq, dk, dv with strides of their own.
#include "mma_tiles.cuh"

namespace {

constexpr int D = TILE_D;  // head dim
constexpr int BQ = 64;     // query rows per tile, every kernel
constexpr int BK = 64;     // keys per tile (== BQ: the causal tile skipping relies on it)

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int PS = BK + 4;    // row stride of the (BQ, BK) tiles in shared memory
constexpr size_t SMEM_DQ_F32 = sizeof(float) * (5 * D * 64 + BQ * PS + 2 * BQ);
constexpr size_t SMEM_DKDV_F32 = sizeof(float) * (6 * D * 64 + 2 * BQ * PS + 2 * BQ);

// Rows [r0, r0 + 64) of a (T, 64) head slice into shared memory, transposed
// ([64][64], d-major) and, if `rm` is given, also row-major; rows at or past
// n are zero. Lanes walk rows, so the transposed writes do not conflict.
__device__ __forceinline__ void load_tile(const float* __restrict__ base, long long st, int r0,
                                          int n, float* tr, float* rm) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int d = i / 64;
    const int r = i - d * 64;
    const float x = (r0 + r < n) ? base[(r0 + r) * st + d] : 0.f;
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

__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ o,
                            const float* __restrict__ lse, const float* __restrict__ dO,
                            float* __restrict__ dq, float* __restrict__ dterm, int H, int Tq,
                            int kv_len, float scale, int causal, Strides sq, Strides sk,
                            Strides sv, Strides so, Strides sdo, Strides sdq) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* doT = qT + D * BQ;                     // [D][BQ]
  float* kT = doT + D * BQ;                     // [D][BK]
  float* vT = kT + D * BK;                      // [D][BK]
  float* ks = vT + D * BK;                      // [BK][D]
  float* dss = ks + BK * D;                     // [BQ][PS] dS
  float* lse_s = dss + BQ * PS;                 // [BQ]
  float* d_s = lse_s + BQ;                      // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* ob = o + b * so.b + h * so.h;
  const float* dob = dO + b * sdo.b + h * sdo.h;

  load_tile(qb, sq.t, q0, Tq, qT, nullptr);
  load_tile(dob, sdo.t, q0, Tq, doT, nullptr);
  {  // D = rowsum(do * o) in f32, four lanes per row
    const int r = tid / 4;
    const int part = tid % 4;
    const bool in = q0 + r < Tq;
    float acc = 0.f;
    if (in) {
      const float* dor = dob + (q0 + r) * sdo.t;
      const float* orow = ob + (q0 + r) * so.t;
      for (int d = part * 16; d < part * 16 + 16; ++d)
        acc = fmaf(dor[d], orow[d], acc);
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
          make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
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
    float* row = dq + b * sdq.b + r * sdq.t + h * sdq.h + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ lse,
                              const float* __restrict__ dO, const float* __restrict__ dterm,
                              float* __restrict__ dk, float* __restrict__ dv, int H, int Tq,
                              int Tk, int kv_len, float scale, int causal, Strides sq,
                              Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv) {
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // [D][BK]
  float* vT = kT + D * BK;                      // [D][BK]
  float* qT = vT + D * BK;                      // [D][BQ]
  float* qs = qT + D * BQ;                      // [BQ][D]
  float* doT = qs + BQ * D;                     // [D][BQ]
  float* dos = doT + D * BQ;                    // [BQ][D]
  float* ps = dos + BQ * D;                     // [BQ][PS] P
  float* dss = ps + BQ * PS;                    // [BQ][PS] dS
  float* lse_s = dss + BQ * PS;                 // [BQ]
  float* d_s = lse_s + BQ;                      // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dO + b * sdo.b + h * sdo.h;

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
            make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
        *reinterpret_cast<float4*>(dss + (ty * 4 + i) * PS + tx * 4) =
            make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
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
    float* krow = dk + b * sdk.b + c * sdk.t + h * sdk.h + tx * 4;
    float* vrow = dv + b * sdv.b + c * sdv.t + h * sdv.h + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      krow[j] = dk_acc[i][j];
      vrow[j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // one warpgroup: 64 query rows (dq) or 64 keys (dk/dv)
constexpr int TC_STAGES = 3;     // streamed tile pairs in flight
// either kernel: its two resident tiles and TC_STAGES of the two streamed ones
constexpr size_t SMEM_BF16 = sizeof(__nv_bfloat16) * (2 + 2 * TC_STAGES) * SWZ_TILE;

__global__ void __launch_bounds__(TC_THREADS, 3)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ o,
                           const float* __restrict__ lse,
                           const __nv_bfloat16* __restrict__ dO,
                           __nv_bfloat16* __restrict__ dq, float* __restrict__ dterm, int H,
                           int Tq, int kv_len, float scale, int causal, Strides sq,
                           Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // Q tile
  __nv_bfloat16* dos = qs + SWZ_TILE;                             // dO tile
  __nv_bfloat16* ks = dos + SWZ_TILE;                             // [TC_STAGES] K tiles
  __nv_bfloat16* vs = ks + TC_STAGES * SWZ_TILE;                  // [TC_STAGES] V tiles
  __shared__ float lse_s[BQ], d_s[BQ];  // the rows' lse * log2(e) and D

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  // the last q-tile first: causal, it visits the most key tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_lo = q0 + warp * 16;  // the warp's rows: row_lo + gid and + 8

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const __nv_bfloat16* ob = o + b * so.b + h * so.h;
  const __nv_bfloat16* dob = dO + b * sdo.b + h * sdo.h;

  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, q0 / BK + 1);  // tiles up to the diagonal

  const TileCopy<TC_THREADS> copy_q(qb, sq.t), copy_do(dob, sdo.t), copy_k(kb, sk.t),
      copy_v(vb, sv.t);
  auto load_kv = [&](int kt) {
    copy_k(ks + (kt % TC_STAGES) * SWZ_TILE, kt * BK, kv_len);
    copy_v(vs + (kt % TC_STAGES) * SWZ_TILE, kt * BK, kv_len);
  };
  copy_q(qs, q0, Tq);
  copy_do(dos, q0, Tq);
  load_kv(0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();

  {  // D = rowsum(do * o) in f32, two lanes per row, while the tiles load
    const int r = tid >> 1, part = tid & 1;
    const bool in = q0 + r < Tq;
    float sum = 0.f;
    if (in) {
      const uint4* dor = reinterpret_cast<const uint4*>(dob + (q0 + r) * sdo.t + part * 32);
      const uint4* orow = reinterpret_cast<const uint4*>(ob + (q0 + r) * so.t + part * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 g = dor[i], w = orow[i];
        const uint32_t gw[4] = {g.x, g.y, g.z, g.w}, ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = unpack_bf16(gw[j]), y = unpack_bf16(ww[j]);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (part == 0) {
      const long long at = static_cast<long long>(bh) * Tq + q0 + r;
      d_s[r] = sum;
      lse_s[r] = in ? lse[at] * LOG2E : 0.f;
      if (in) dterm[at] = sum;
    }
  }
  __syncthreads();
  const float lse0 = lse_s[warp * 16 + gid], lse1 = lse_s[warp * 16 + gid + 8];
  const float dd0 = d_s[warp * 16 + gid], dd1 = d_s[warp * 16 + gid + 8];
  const float scale2 = scale * LOG2E;
  const uint64_t q_desc = smem_desc(qs, 16, 1024);
  const uint64_t do_desc = smem_desc(dos, 16, 1024);

  float acc[8][4];  // 16 x 64 of dq, 8 n-tiles over the head dim
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // tile kt is in once all but the newest copy group are; past the barrier
    // every warp is done with tile kt - 1, whose stage tile kt + 2 takes
    cp_async_wait<1>();
    fence_async_proxy();
    __syncthreads();
    if (kt + 2 < n_tiles) load_kv(kt + 2);
    cp_async_commit();
    const __nv_bfloat16* kst = ks + (kt % TC_STAGES) * SWZ_TILE;
    const uint64_t k_desc = smem_desc(kst, 16, 1024);       // K as [n = key][k = d]
    const uint64_t kx_desc = smem_desc(kst, 8192, 1024);    // K as [k = key][n = d]
    const uint64_t v_desc = smem_desc(vs + (kt % TC_STAGES) * SWZ_TILE, 16, 1024);

    float s[8][4], dp[8][4];  // 16 x 64 of S and dP, 8 n-tiles over the keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss(s, q_desc + kc * DESC_K16_ALONG_ROWS, k_desc + kc * DESC_K16_ALONG_ROWS, kc > 0);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss(dp, do_desc + kc * DESC_K16_ALONG_ROWS, v_desc + kc * DESC_K16_ALONG_ROWS, kc > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S scale - lse), exactly 0 where masked; dS = P (dP - D) scale
    const bool edge = q0 + BQ > Tq || k0 + BK > kv_len || (causal && k0 + BK - 1 > row_lo);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool keep = true;
        if (edge) {
          const int col = k0 + j * 8 + tig * 2 + (e & 1);
          const int row = row_lo + gid + (e >> 1) * 8;
          keep = row < Tq && col < kv_len && (!causal || col <= row);
        }
        const float p = keep ? fast_exp2(fmaf(s[j][e], scale2, e < 2 ? -lse0 : -lse1)) : 0.f;
        dp[j][e] = p * (dp[j][e] - (e < 2 ? dd0 : dd1)) * scale;
      }
    // dq += dS (bf16, in registers) K: 16 keys at a time
    uint32_t da[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) c_to_a(da[t], dp[2 * t], dp[2 * t + 1]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) wgmma_rs_bt(acc, da[t], kx_desc + t * DESC_K16_ACROSS_ROWS);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its last tile: the K stages are free
  store_tile_16x64(acc, ks + warp * 16 * TILE_LD, dq + b * sdq.b + h * sdq.h, sdq.t, row_lo, Tq,
                   lane);
}

__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ lse,
                             const __nv_bfloat16* __restrict__ dO,
                             const float* __restrict__ dterm, __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk,
                             int kv_len, float scale, int causal, Strides sq, Strides sk,
                             Strides sv, Strides sdo, Strides sdk, Strides sdv) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // K tile
  __nv_bfloat16* vs = ks + SWZ_TILE;                              // V tile
  __nv_bfloat16* qs = vs + SWZ_TILE;                              // [TC_STAGES] Q tiles
  __nv_bfloat16* dos = qs + TC_STAGES * SWZ_TILE;                 // [TC_STAGES] dO tiles
  __shared__ __align__(16) float lse_s[TC_STAGES][BQ], d_s[TC_STAGES][BQ];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * BK;  // causal: the first k-tile visits the most q-tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int key_lo = k0 + warp * 16;  // the warp's keys: key_lo + gid and + 8

  // dk, dv of the warp's 16 keys, 8 n-tiles over the head dim, summed over
  // every q-tile in f32
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  if (k0 < kv_len) {
    const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
    const __nv_bfloat16* dob = dO + b * sdo.b + h * sdo.h;
    const float* lse_b = lse + static_cast<long long>(bh) * Tq;
    const float* d_b = dterm + static_cast<long long>(bh) * Tq;
    const int n_qt = (Tq + BQ - 1) / BQ;
    const int qt0 = causal ? k0 / BQ : 0;  // causal: skip the tiles above the diagonal
    const int n_it = n_qt - qt0;           // q-tiles to visit

    const TileCopy<TC_THREADS> copy_q(qb, sq.t), copy_do(dob, sdo.t),
        copy_k(k + b * sk.b + h * sk.h, sk.t), copy_v(v + b * sv.b + h * sv.h, sv.t);
    // Q and dO rows of the it-th q-tile, with their lse (threads 0..63) and D (64..127)
    auto load_rows = [&](int it) {
      const int st = it % TC_STAGES;
      const int r0 = (qt0 + it) * BQ;
      copy_q(qs + st * SWZ_TILE, r0, Tq);
      copy_do(dos + st * SWZ_TILE, r0, Tq);
      const int r = tid & (BQ - 1);
      const bool in = r0 + r < Tq;
      const float* src = tid < BQ ? lse_b : d_b;
      float* dst = (tid < BQ ? lse_s[st] : d_s[st]) + r;
      cp_async_4(dst, in ? src + r0 + r : src, in);
    };
    copy_k(ks, k0, kv_len);
    copy_v(vs, k0, kv_len);
    load_rows(0);
    cp_async_commit();
    if (n_it > 1) load_rows(1);
    cp_async_commit();

    const uint64_t k_desc = smem_desc(ks, 16, 1024);
    const uint64_t v_desc = smem_desc(vs, 16, 1024);
    const float scale2 = scale * LOG2E;

    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qt0 + it) * BQ;
      const int stage = it % TC_STAGES;
      cp_async_wait<1>();
      fence_async_proxy();
      __syncthreads();
      if (it + 2 < n_it) load_rows(it + 2);
      cp_async_commit();
      const __nv_bfloat16* qst = qs + stage * SWZ_TILE;
      const __nv_bfloat16* dost = dos + stage * SWZ_TILE;
      const uint64_t q_desc = smem_desc(qst, 16, 1024);      // Q as [n = row][k = d]
      const uint64_t qx_desc = smem_desc(qst, 8192, 1024);   // Q as [k = row][n = d]
      const uint64_t do_desc = smem_desc(dost, 16, 1024);
      const uint64_t dox_desc = smem_desc(dost, 8192, 1024);
      const float* lrow = lse_s[stage];
      const float* drow = d_s[stage];
      const bool edge = q0 + BQ > Tq || k0 + BK > kv_len || (causal && key_lo + 15 > q0);

      // 16 x 64 of S^T = K Q^T and dP^T = V dO^T: rows are keys, the 8
      // n-tiles run over query rows
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_ss(st, k_desc + kc * DESC_K16_ALONG_ROWS, q_desc + kc * DESC_K16_ALONG_ROWS,
                 kc > 0);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_ss(dpt, v_desc + kc * DESC_K16_ALONG_ROWS, do_desc + kc * DESC_K16_ALONG_ROWS,
                 kc > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(st);
      fence_regs(dpt);
      // P^T and dS^T: lse and D belong to the query row, here the column
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int rl = j * 8 + tig * 2;  // the tile's query row of e = 0 and 2
        const float2 ls = *reinterpret_cast<const float2*>(lrow + rl);
        const float2 dd = *reinterpret_cast<const float2*>(drow + rl);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool keep = true;
          if (edge) {
            const int row = q0 + rl + (e & 1);
            const int key = key_lo + gid + (e >> 1) * 8;
            keep = row < Tq && key < kv_len && (!causal || key <= row);
          }
          const float l2 = ((e & 1) ? ls.y : ls.x) * LOG2E;
          const float p = keep ? fast_exp2(fmaf(st[j][e], scale2, -l2)) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dd.y : dd.x)) * scale;
        }
      }
      // dv += P^T dO, dk += dS^T Q (bf16 A operands from registers): 16 query
      // rows at a time
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        c_to_a(pa[t], st[2 * t], st[2 * t + 1]);
        c_to_a(da[t], dpt[2 * t], dpt[2 * t + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        wgmma_rs_bt(dv_acc, pa[t], dox_desc + t * DESC_K16_ACROSS_ROWS);
        wgmma_rs_bt(dk_acc, da[t], qx_desc + t * DESC_K16_ACROSS_ROWS);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is past its last tile: the Q stages are free
  }
  // keys in [kv_len, Tk) get zero gradients
  store_tile_16x64(dk_acc, qs + warp * 16 * TILE_LD, dk + b * sdk.b + h * sdk.h, sdk.t, key_lo,
                   Tk, lane);
  store_tile_16x64(dv_acc, dos + warp * 16 * TILE_LD, dv + b * sdv.b + h * sdv.h, sdv.t, key_lo,
                   Tk, lane);
}

struct Args {
  const void *q, *k, *v, *o;
  const float* lse;
  const void* dO;
  void *dq, *dk, *dv;
  float* dterm;
  int B, H, Tq, Tk, kv_len;
  float scale;
  int causal;
  Strides st[8];  // q, k, v, o, do, dq, dk, dv
};

// The dq kernel, then the dk/dv kernel on the same stream: it runs after
// the dq kernel has written D.
template <typename T, typename DqKernel, typename DkDvKernel>
int launch(DqKernel* dq_kernel, DkDvKernel* dkdv_kernel, int threads, size_t smem_dq,
           size_t smem_dkdv, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const T* dop = static_cast<const T*>(a.dO);
  const Strides* st = a.st;
  dq_kernel<<<dim3((a.Tq + BQ - 1) / BQ, a.B * a.H), threads, smem_dq, stream>>>(
      qp, kp, vp, static_cast<const T*>(a.o), a.lse, dop, static_cast<T*>(a.dq), a.dterm, a.H,
      a.Tq, a.kv_len, a.scale, a.causal, st[0], st[1], st[2], st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dim3((a.Tk + BK - 1) / BK, a.B * a.H), threads, smem_dkdv, stream>>>(
      qp, kp, vp, a.lse, dop, a.dterm, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Tq,
      a.Tk, a.kv_len, a.scale, a.causal, st[0], st[1], st[2], st[4], st[6], st[7]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements, 3 per tensor (batch, row, head) in the order q, k,
// v, o, do, dq, dk, dv. dterm is (B, H, Tq) f32 scratch. kv_len <= Tk keys are
// attended; causal needs Tq == Tk. bf16 needs 16-byte aligned tensors and
// strides that are multiples of 8.
WCB_EXPORT int wcb_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* o, const float* lse, const void* dO, void* dq,
                             void* dk, void* dv, float* dterm, int B, int H, int Tq, int Tk,
                             int kv_len, float scale, int causal, const long long* strides,
                             cudaStream_t stream) {
  Args a{q, k, v, o, lse, dO, dq, dk, dv, dterm, B, H, Tq, Tk, kv_len, scale, causal, {}};
  for (int i = 0; i < 8; ++i) a.st[i] = Strides{strides[3 * i], strides[3 * i + 1],
                                                strides[3 * i + 2]};
  if (dtype == WCB_F32)
    return launch<float>(flash_bwd_dq_f32_kernel, flash_bwd_dkdv_f32_kernel, THREADS,
                         SMEM_DQ_F32, SMEM_DKDV_F32, a, stream);
  if (dtype == WCB_BF16)
    return launch<__nv_bfloat16>(flash_bwd_dq_bf16_kernel, flash_bwd_dkdv_bf16_kernel,
                                 TC_THREADS, SMEM_BF16, SMEM_BF16, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0..4]: registers, shared memory bytes (static + dynamic), local memory
// bytes, resident blocks per SM and threads per block of the dtype's dq
// kernel (which = 0) or dk/dv kernel (which = 1).
WCB_EXPORT int wcb_flash_bwd_info(int dtype, int which, int* out) {
  if (dtype == WCB_F32)
    return which == 0 ? kernel_info(flash_bwd_dq_f32_kernel, THREADS, SMEM_DQ_F32, out)
                      : kernel_info(flash_bwd_dkdv_f32_kernel, THREADS, SMEM_DKDV_F32, out);
  if (dtype == WCB_BF16)
    return which == 0 ? kernel_info(flash_bwd_dq_bf16_kernel, TC_THREADS, SMEM_BF16, out)
                      : kernel_info(flash_bwd_dkdv_bf16_kernel, TC_THREADS, SMEM_BF16, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
