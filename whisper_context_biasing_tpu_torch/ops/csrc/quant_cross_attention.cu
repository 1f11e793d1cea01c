// Single-query cross-attention against int8 K/V: the decode step's hot loop.
//
// Replaces the TPU kernel whisper_context_biasing_tpu/ops/quant_cross_attention.py:
// _kernel via _kernel_indexed (its pallas_call in
// quant_cross_attention_step_indexed). The TPU kernel expands the query
// block-diagonally and extracts heads with a 0/1 mask so that the MXU sees
// full-width matmuls; none of that is needed here. The layer is a pointer
// offset into the stacked (L, B, T_pad, D) tensors, so no slice is copied,
// and nothing dequantised is ever written.
//
// What bounds it on an H100: bytes. A step reads the layer's int8 K and V
// (2 * B * T_pad * D bytes) and their f32 scales for ~4 operations a byte,
// and at decode batch sizes B * heads is smaller than the card's 132 SMs.
// So one (batch row, head) is spread over a thread block cluster of up to 8
// blocks along T_pad. Four lanes share a key row (16 bytes each, one 16-byte
// load), and a thread asks for its part of every K and V row of the block's
// slice up front, into registers (at most 8 rows of each), so every byte of
// the launch is requested in its first microsecond and V arrives while K is
// scored. The softmax is over the whole row: each block sends its slice's
// (max, sum of exp) to every block of the cluster through distributed shared
// memory, one cluster barrier later every block knows the row's max and sum,
// forms its weights, multiplies its V slice, and sends its 64 partial
// outputs to the cluster's first block, which adds them in rank order and
// writes the row once. One launch, no workspace, no atomics: the same bits
// on every run. Scores and weights never leave registers.
//
// int8 -> f32 without the conversion unit: a byte b, flipped to b + 128, is
// dropped into the mantissa of 2^23 by one byte permute, and one subtract of
// 2^23 + 128 leaves float(b) exactly.
//
// Op order follows the XLA path models/whisper.py:_attention_quant_cross:
// scores = (q . k_q) in f32, then * (k_s / sqrt(dh)), the f32 minimum where
// k_s == 0 (padded positions), softmax in f32, p * v_s cast to the compute
// dtype, then . v_q with f32 sums, cast to the compute dtype. A slice that
// is all padding has max -FLT_MAX and weighs exp(-FLT_MAX - max) = 0.
#include <cooperative_groups.h>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int DH = 64;                      // head dim = bytes of one int8 head row
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_PASS = THREADS / 4;  // four lanes share a key row, 16 bytes each
constexpr int MAX_SPLITS = 8;               // the portable cluster size
constexpr int MAX_PASSES = 8;               // a block owns at most 8 x 64 key rows

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// float(b) of the four int8 values in w
__device__ __forceinline__ void unpack_int8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128 in each byte
  constexpr float BIAS = 8388736.f;    // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - BIAS;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - BIAS;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - BIAS;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - BIAS;
}

// 16 consecutive values of q (16-byte aligned) as f32, in 16-byte loads
__device__ __forceinline__ void load_q16(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    out[4 * i] = v.x, out[4 * i + 1] = v.y, out[4 * i + 2] = v.z, out[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load_q16(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(words[e]);
      out[8 * i + 2 * e] = f.x, out[8 * i + 2 * e + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red is free (an earlier reduction has been read)
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Grid (heads * splits, B), clusters of `splits` blocks along x: block
// `rank` of a cluster owns key rows [rank * R, rank * R + R), R = 64 * PASSES
// = Tp / splits. A thread holds its 16 bytes of PASSES key rows and PASSES
// value rows in registers, all asked for before the first is used.
template <typename T, int PASSES>
__global__ void __launch_bounds__(THREADS)
    quant_cross_kernel(const T* __restrict__ q,         // (B, D)
                       const int8_t* __restrict__ kq,   // (B, Tp, D), one layer
                       const float* __restrict__ ksc,   // (B, Tp)
                       const int8_t* __restrict__ vq,   // (B, Tp, D)
                       const float* __restrict__ vsc,   // (B, Tp)
                       T* __restrict__ out,             // (B, D)
                       int Tp, int D, int splits, float sqrt_dh) {
  __shared__ float red[WARPS];
  __shared__ float stats[MAX_SPLITS][2];   // every rank's (max, sum of exp), sent by the ranks
  __shared__ float part[WARPS][DH];        // the warps' partial outputs
  __shared__ float opart[MAX_SPLITS][DH];  // rank 0: every rank's partial outputs

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x % splits;
  const int h = blockIdx.x / splits;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  // every block of the cluster is running once this barrier completes; it is
  // waited for just before the first write into another block's shared memory
  cluster_arrive();

  // lanes 4j..4j+3 share row j of a pass (64 rows), 16 bytes each
  const int sub = tid & 3;
  const size_t row0 = static_cast<size_t>(b) * Tp + rank * (PASSES * ROWS_PER_PASS) + (tid >> 2);
  const int8_t* kr = kq + row0 * D + h * DH + sub * 16;
  const int8_t* vr = vq + row0 * D + h * DH + sub * 16;
  const size_t pass_bytes = static_cast<size_t>(ROWS_PER_PASS) * D;
  // a row's scales: lane `sub` of its four loads those of passes p = sub
  // (mod 4), and hands them round when they are used
  constexpr int SCALES = (PASSES + 3) / 4;
  uint4 kraw[PASSES], vraw[PASSES];
  float ks_mine[SCALES], vs_mine[SCALES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
    kraw[p] = __ldg(reinterpret_cast<const uint4*>(kr + p * pass_bytes));
#pragma unroll
  for (int i = 0; i < SCALES; ++i) {
    const int p = min(4 * i + sub, PASSES - 1);
    ks_mine[i] = __ldg(ksc + row0 + p * ROWS_PER_PASS);
    vs_mine[i] = __ldg(vsc + row0 + p * ROWS_PER_PASS);
  }
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
    vraw[p] = __ldg(reinterpret_cast<const uint4*>(vr + p * pass_bytes));
  float qreg[16];
  load_q16(q + static_cast<size_t>(b) * D + h * DH + sub * 16, qreg);
  const int lane4 = tid & 28;  // the first of the row's four lanes, within the warp

  float score[PASSES];
  float mx = -FLT_MAX;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const uint32_t words[4] = {kraw[p].x, kraw[p].y, kraw[p].z, kraw[p].w};
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float kf[4];
      unpack_int8x4(words[w], kf);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[w] = fmaf(qreg[w * 4 + i], kf[i], acc[w]);
    }
    float dot = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    const float ks = __shfl_sync(0xffffffffu, ks_mine[p / 4], lane4 | (p & 3));
    score[p] = (ks > 0.f) ? dot * (ks / sqrt_dh) : -FLT_MAX;
    mx = fmaxf(mx, score[p]);
  }
  mx = block_reduce(mx, red, true);
  float sum = 0.f;  // each row once: by the first of its four lanes
#pragma unroll
  for (int p = 0; p < PASSES; ++p) sum += (sub == 0) ? expf(score[p] - mx) : 0.f;
  sum = block_reduce(sum, red, false);

  // the slice's (max, sum) to every block of the cluster, then the row's
  cluster_wait();
  if (tid < splits) {
    float* theirs = cluster.map_shared_rank(&stats[0][0], tid);
    theirs[rank * 2] = mx;
    theirs[rank * 2 + 1] = sum;
  }
  cluster_arrive();
  cluster_wait();
  float row_max = stats[0][0];
  for (int r = 1; r < splits; ++r) row_max = fmaxf(row_max, stats[r][0]);
  float row_sum = 0.f;
  for (int r = 0; r < splits; ++r) row_sum += stats[r][1] * expf(stats[r][0] - row_max);

  // weights . v: the row's four lanes each form its weight, 16 columns each
  float o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const float vs = __shfl_sync(0xffffffffu, vs_mine[p / 4], lane4 | (p & 3));
    const float w = round_to<T>((expf(score[p] - row_max) / row_sum) * vs);
    const uint32_t words[4] = {vraw[p].x, vraw[p].y, vraw[p].z, vraw[p].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float vf[4];
      unpack_int8x4(words[j], vf);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j * 4 + i] = fmaf(w, vf[i], o[j * 4 + i]);
    }
  }
  // the warp's eight row slots, then the block's warps, then the cluster's
  // blocks: every sum in a fixed order
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    o[i] += __shfl_xor_sync(0xffffffffu, o[i], 4);
    o[i] += __shfl_xor_sync(0xffffffffu, o[i], 8);
    o[i] += __shfl_xor_sync(0xffffffffu, o[i], 16);
  }
  if ((tid & 31) < 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i) part[tid >> 5][sub * 16 + i] = o[i];
  }
  __syncthreads();
  if (tid < DH) {
    float r = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) r += part[w][tid];
    cluster.map_shared_rank(&opart[0][0], 0)[rank * DH + tid] = r;
  }
  cluster_arrive();
  cluster_wait();
  if (rank == 0 && tid < DH) {
    float r = 0.f;
    for (int s = 0; s < splits; ++s) r += opart[s][tid];
    out[static_cast<size_t>(b) * D + h * DH + tid] = from_f32<T>(r);
  }
}

template <typename T, int PASSES>
int launch(const void* q, const int8_t* kq, const float* ks, const int8_t* vq,
           const float* vs, void* out, int B, int Tp, int D, int splits, float sqrt_dh,
           cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D / DH) * splits, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, quant_cross_kernel<T, PASSES>,
                                       static_cast<const T*>(q), kq, ks, vq, vs,
                                       static_cast<T*>(out), Tp, D, splits, sqrt_dh);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One instance for each number of 64-row passes a block may own
template <typename T, int PASSES = MAX_PASSES>
struct ByPasses {
  template <typename... Args>
  static int launch_for(int passes, Args... args) {
    if (passes == PASSES) return launch<T, PASSES>(args...);
    return ByPasses<T, PASSES - 1>::launch_for(passes, args...);
  }
  static int info_for(int passes, int* out) {
    if (passes == PASSES) return kernel_info(quant_cross_kernel<T, PASSES>, THREADS, 0, out);
    return ByPasses<T, PASSES - 1>::info_for(passes, out);
  }
};
template <typename T>
struct ByPasses<T, 0> {
  template <typename... Args>
  static int launch_for(int, Args...) { return static_cast<int>(cudaErrorInvalidValue); }
  static int info_for(int, int*) { return static_cast<int>(cudaErrorInvalidValue); }
};

}  // namespace

// q (B, D) in the compute dtype; kq, vq (B, Tp, D) int8 and ks, vs (B, Tp)
// f32, already offset to the layer; out (B, D). `splits` blocks (1..8, one
// cluster) share a (row, head) along Tp; Tp / splits must be a whole
// multiple of 64 rows, at most 8 of them.
WCB_EXPORT int wcb_quant_cross(int dtype, const void* q, const int8_t* kq,
                               const float* ks, const int8_t* vq, const float* vs,
                               void* out, int B, int Tp, int D, int splits, float sqrt_dh,
                               cudaStream_t stream) {
  if (splits < 1 || splits > MAX_SPLITS || Tp % (splits * ROWS_PER_PASS) != 0 || D % DH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int passes = Tp / (splits * ROWS_PER_PASS);
  if (dtype == WCB_F32)
    return ByPasses<float>::launch_for(passes, q, kq, ks, vq, vs, out, B, Tp, D, splits,
                                       sqrt_dh, stream);
  if (dtype == WCB_BF16)
    return ByPasses<__nv_bfloat16>::launch_for(passes, q, kq, ks, vq, vs, out, B, Tp, D,
                                               splits, sqrt_dh, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0..4]: registers, shared memory bytes, local memory bytes, resident
// blocks per SM and threads per block of the dtype's kernel when a block
// owns `rows` key rows (a multiple of 64 up to 512).
WCB_EXPORT int wcb_quant_cross_info(int dtype, int rows, int* out) {
  if (rows % ROWS_PER_PASS != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == WCB_F32) return ByPasses<float>::info_for(rows / ROWS_PER_PASS, out);
  if (dtype == WCB_BF16) return ByPasses<__nv_bfloat16>::info_for(rows / ROWS_PER_PASS, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
