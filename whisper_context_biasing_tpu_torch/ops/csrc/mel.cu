// Log-mel frontend kernel: framing, windowed DFT, power and mel projection.
//
// Replaces the TPU kernel whisper_context_biasing_tpu/ops/mel_kernel.py:
// _mel_kernel (its pallas_call in log_mel_spectrogram_fused). That kernel
// took (B*T, 400) frames gathered outside it, because Mosaic cannot re-tile
// a sample stream into overlapping windows; here each block builds its own
// frames from the audio with strided loads and the reflect padding folded
// into the index, so the (B*T, 400) frame tensor never exists.
//
// What bounds it on an H100: the two products run in true float32 (no TF32,
// the frontend's dynamic range needs it), so the bound is the card's f32
// rate, not memory: ~450 kFLOP per frame against 1.6 kB of frame samples.
// The design keeps everything a frame needs on chip: the block's frames sit
// transposed in shared memory (one float4 read feeds four frames), each
// thread owns one DFT bin (re and im, as two interleaved partial sums) for
// all of the block's frames in registers while the windowed basis streams
// from L2, and the power spectrum stays in shared memory for the mel
// projection. Only the mel energies are written. The log/clamp tail stays in torch, as in JAX.
#include "common.cuh"

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_BINS = N_FFT / 2 + 1;  // 201
constexpr int BINS_PAD = 256;          // basis layout: [cos | 0 | -sin | 0]
constexpr int FRAMES = 16;             // frames per block
constexpr int THREADS = 256;           // >= N_BINS: one DFT bin per thread
constexpr int XT_STRIDE = FRAMES + 4;  // float4-aligned rows, fewer conflicts
constexpr int PW_STRIDE = BINS_PAD;

__global__ void __launch_bounds__(THREADS)
    mel_kernel(const float* __restrict__ audio, int n_samples, int n_frames,
               const float* __restrict__ basis,  // (N_FFT, 2*BINS_PAD)
               const float* __restrict__ fb,     // (BINS_PAD, n_mels)
               int n_mels, float* __restrict__ out) {  // (B, n_frames, n_mels)
  extern __shared__ float4 smem4[];
  float* xt = reinterpret_cast<float*>(smem4);  // [N_FFT][XT_STRIDE]
  float* pw = xt + N_FFT * XT_STRIDE;           // [FRAMES][PW_STRIDE]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FRAMES;
  const float* x = audio + static_cast<size_t>(b) * n_samples;

  // frames, transposed: xt[k][f] = padded[(f0 + f) * HOP + k], where
  // padded is the clip reflect-padded by N_FFT/2 on each side
  for (int i = threadIdx.x; i < FRAMES * N_FFT; i += THREADS) {
    const int f = i / N_FFT;
    const int k = i - f * N_FFT;
    float v = 0.f;
    if (f0 + f < n_frames) {
      int j = (f0 + f) * HOP + k - N_FFT / 2;
      if (j < 0) {
        j = -j;
      } else if (j >= n_samples) {
        j = 2 * (n_samples - 1) - j;
      }
      v = __ldg(x + j);
    }
    xt[k * XT_STRIDE + f] = v;
  }
  __syncthreads();

  const int bin = threadIdx.x;
  if (bin < N_BINS) {
    // two interleaved partial sums per output (even and odd samples), added
    // at the end: the same order as the plain version, and half the f32
    // rounding growth of one 400-term running sum
    float re[2][FRAMES], im[2][FRAMES];
#pragma unroll
    for (int f = 0; f < FRAMES; ++f) {
      re[0][f] = re[1][f] = 0.f;
      im[0][f] = im[1][f] = 0.f;
    }
    for (int k0 = 0; k0 < N_FFT; k0 += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + h;
        const float c = __ldg(basis + k * 2 * BINS_PAD + bin);
        const float s = __ldg(basis + k * 2 * BINS_PAD + BINS_PAD + bin);
        const float4* row = reinterpret_cast<const float4*>(xt + k * XT_STRIDE);
#pragma unroll
        for (int q = 0; q < FRAMES / 4; ++q) {
          const float4 v = row[q];
          re[h][4 * q + 0] = fmaf(v.x, c, re[h][4 * q + 0]);
          re[h][4 * q + 1] = fmaf(v.y, c, re[h][4 * q + 1]);
          re[h][4 * q + 2] = fmaf(v.z, c, re[h][4 * q + 2]);
          re[h][4 * q + 3] = fmaf(v.w, c, re[h][4 * q + 3]);
          im[h][4 * q + 0] = fmaf(v.x, s, im[h][4 * q + 0]);
          im[h][4 * q + 1] = fmaf(v.y, s, im[h][4 * q + 1]);
          im[h][4 * q + 2] = fmaf(v.z, s, im[h][4 * q + 2]);
          im[h][4 * q + 3] = fmaf(v.w, s, im[h][4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < FRAMES; ++f) {
      const float r = re[0][f] + re[1][f];
      const float i = im[0][f] + im[1][f];
      pw[f * PW_STRIDE + bin] = r * r + i * i;
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < FRAMES * n_mels; o += THREADS) {
    const int f = o / n_mels;
    const int m = o - f * n_mels;
    if (f0 + f >= n_frames) continue;
    const float* p = pw + f * PW_STRIDE;
    float acc = 0.f;
    for (int k = 0; k < N_BINS; ++k) acc = fmaf(p[k], __ldg(fb + k * n_mels + m), acc);
    out[(static_cast<size_t>(b) * n_frames + f0 + f) * n_mels + m] = acc;
  }
}

}  // namespace

// audio (batch, n_samples) f32; basis (400, 512) f32; fb (256, n_mels) f32;
// out (batch, n_samples / 160, n_mels) f32 mel energies.
WCB_EXPORT int wcb_mel(const float* audio, int batch, int n_samples,
                       const float* basis, const float* fb, int n_mels,
                       float* out, cudaStream_t stream) {
  const int n_frames = n_samples / HOP;
  const size_t smem = sizeof(float) * (N_FFT * XT_STRIDE + FRAMES * PW_STRIDE);
  cudaError_t err = cudaFuncSetAttribute(
      mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + FRAMES - 1) / FRAMES, batch);
  mel_kernel<<<grid, THREADS, smem, stream>>>(audio, n_samples, n_frames, basis,
                                              fb, n_mels, out);
  return static_cast<int>(cudaGetLastError());
}
