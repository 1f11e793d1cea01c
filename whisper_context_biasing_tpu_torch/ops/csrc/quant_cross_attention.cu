// Single-query cross-attention against int8 K/V: the decode step's hot loop.
//
// Replaces the TPU kernel whisper_context_biasing_tpu/ops/quant_cross_attention.py:
// _kernel via _kernel_indexed (its pallas_call in
// quant_cross_attention_step_indexed). The TPU kernel expands the query
// block-diagonally and extracts heads with a 0/1 mask so that the MXU sees
// full-width matmuls; none of that is needed here. One block serves one
// (head, batch row): it reads that head's 64-byte slice of every int8 K and
// V row of the chosen layer, dequantises in registers and never writes a
// dequantised tensor. The layer is a pointer offset into the stacked
// (L, B, T_pad, D) tensors, so no slice is copied.
//
// What bounds it on an H100: bytes. Each step reads the layer's int8 K and
// V (2 * B * T_pad * D bytes) and their f32 scales for ~4 operations per
// byte. Four lanes share one key row (16 bytes each, one 16-byte load), so
// a warp reads eight whole 64-byte head rows per instruction.
//
// Op order follows the XLA path models/whisper.py:_attention_quant_cross:
// scores = (q . k_q) in f32, then * (k_s / sqrt(dh)), the f32 minimum where
// k_s == 0 (padded positions), softmax in f32, p * v_s cast to the compute
// dtype, then . v_q with f32 sums, cast to the compute dtype.
#include "common.cuh"

namespace {

constexpr int DH = 64;
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / 4;  // key rows scored per pass
constexpr int V_GROUPS = THREADS / 16;      // 16 lanes x 4 columns cover a head

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
  for (int w = 1; w < THREADS / 32; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    quant_cross_kernel(const T* __restrict__ q,         // (B, D)
                       const int8_t* __restrict__ kq,   // (B, Tp, D), one layer
                       const float* __restrict__ ksc,   // (B, Tp)
                       const int8_t* __restrict__ vq,   // (B, Tp, D)
                       const float* __restrict__ vsc,   // (B, Tp)
                       T* __restrict__ out,             // (B, D)
                       int Tp, int D, float sqrt_dh) {
  extern __shared__ float sc[];  // [Tp] scores, then weights
  __shared__ float red[THREADS / 32];
  __shared__ float part[V_GROUPS][DH];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int8_t* kr = kq + static_cast<size_t>(b) * Tp * D + h * DH;
  const int8_t* vr = vq + static_cast<size_t>(b) * Tp * D + h * DH;
  const float* ks = ksc + static_cast<size_t>(b) * Tp;
  const float* vs = vsc + static_cast<size_t>(b) * Tp;

  // scores: lanes 4j..4j+3 share key row j, 16 int8 values each
  const int sub = tid & 3;
  float qreg[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qreg[i] = to_f32(q[static_cast<size_t>(b) * D + h * DH + sub * 16 + i]);
  for (int base = 0; base < Tp; base += ROWS_PER_PASS) {
    const int t = base + (tid >> 2);
    float acc = 0.f;
    if (t < Tp) {
      const int4 raw = *reinterpret_cast<const int4*>(kr + static_cast<size_t>(t) * D + sub * 16);
      const int8_t* kv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc = fmaf(qreg[i], static_cast<float>(kv[i]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (t < Tp && sub == 0) {
      const float s = ks[t];
      sc[t] = (s > 0.f) ? acc * (s / sqrt_dh) : -FLT_MAX;
    }
  }
  __syncthreads();

  float mx = -FLT_MAX;
  for (int t = tid; t < Tp; t += THREADS) mx = fmaxf(mx, sc[t]);
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int t = tid; t < Tp; t += THREADS) sum += expf(sc[t] - mx);
  sum = block_reduce(sum, red, false);
  for (int t = tid; t < Tp; t += THREADS) {
    sc[t] = round_to<T>((expf(sc[t] - mx) / sum) * vs[t]);
  }
  __syncthreads();

  // weights . v: 16 groups of key rows, 16 lanes x 4 columns per row
  const int g = tid / 16;
  const int c = (tid % 16) * 4;
  float o4[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = g; t < Tp; t += V_GROUPS) {
    const char4 raw = *reinterpret_cast<const char4*>(vr + static_cast<size_t>(t) * D + c);
    const float w = sc[t];
    o4[0] = fmaf(w, static_cast<float>(raw.x), o4[0]);
    o4[1] = fmaf(w, static_cast<float>(raw.y), o4[1]);
    o4[2] = fmaf(w, static_cast<float>(raw.z), o4[2]);
    o4[3] = fmaf(w, static_cast<float>(raw.w), o4[3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[g][c + j] = o4[j];
  __syncthreads();
  if (tid < DH) {
    float r = 0.f;
    for (int gg = 0; gg < V_GROUPS; ++gg) r += part[gg][tid];
    out[static_cast<size_t>(b) * D + h * DH + tid] = from_f32<T>(r);
  }
}

template <typename T>
int launch(const void* q, const int8_t* kq, const float* ks, const int8_t* vq,
           const float* vs, void* out, int B, int Tp, int D, float sqrt_dh,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tp;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(quant_cross_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(D / DH, B);
  quant_cross_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), kq, ks, vq, vs, static_cast<T*>(out), Tp, D, sqrt_dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, D) in the compute dtype; kq, vq (B, Tp, D) int8 and ks, vs (B, Tp)
// f32, already offset to the layer; out (B, D).
WCB_EXPORT int wcb_quant_cross(int dtype, const void* q, const int8_t* kq,
                               const float* ks, const int8_t* vq, const float* vs,
                               void* out, int B, int Tp, int D, float sqrt_dh,
                               cudaStream_t stream) {
  if (dtype == WCB_F32) return launch<float>(q, kq, ks, vq, vs, out, B, Tp, D, sqrt_dh, stream);
  if (dtype == WCB_BF16)
    return launch<__nv_bfloat16>(q, kq, ks, vq, vs, out, B, Tp, D, sqrt_dh, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
