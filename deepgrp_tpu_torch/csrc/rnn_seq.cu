// GRU over a float input sequence (inference), for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package:
//   * dg_gru_seq <- deepgrp_tpu/models/pallas_rnn.py:43 _gru_kernel
//                   (_pallas_gru :76, pallas_gru_apply :126)
// Contract (identical to that kernel and to the plain PyTorch version
// deepgrp_tpu_torch/models/rnn.py:gru_apply): x [B, T, C] float32 or
// bfloat16 (any C: a real input dot x_t W + b_in, not a row select);
// kernel W [C, 3u] and recurrent U [u, 3u] in x's type; bias [2, 3u]
// float32 (input row, recurrent row); Keras GRU gate math (reset_after=True,
// gates z, r, h); outputs seq [B, T, u] and last [B, u] (the state after
// step T-1) in x's type.  The carried state h and the gate math are float32.
// Precision: float32 IO sums float32 FMAs in k order (Precision.HIGHEST);
// bfloat16 IO rounds h to bfloat16 for the recurrent dot (W and U already
// are) and accumulates in float32: the TPU's DEFAULT precision.
//
// Bound on this card.  Per row the recurrent products cost T x u x 3u
// multiply-adds and the input dot T x C x 3u; at the scan route's shape
// (2048 rows = a doubled batch of 1024, T=342, u=60, C=5) that is 16.4
// GFLOP against 182 MB of float32 IO, so float32 work bounds it (0.245 ms
// at 67 TFLOP/s; 0.054 ms of bytes at 3.35 TB/s).  The recurrence is
// sequential in T, so the parallelism is B x u.
//
// Design (right and simple first; the same shape as rnn_avg.cu):
//   * One CTA owns a block of `bb` rows for all T steps; the recurrence is
//     a loop inside the kernel.  Thread (b, i) owns unit i of row b: it
//     keeps h[b, i] in a register, computes its three gate pre-activations
//     and writes seq[b, t, i] itself.
//   * Shared memory holds W [C, 3u] and the bias rows as float32, the
//     double-buffered hidden state [2][bb][u] (as float32, already rounded
//     to the dot's precision), so one __syncthreads a step suffices, and a
//     tile of x [bb][kTimeTile][C] (float32), loaded coalesced once every
//     kTimeTile steps.
//   * U stays in shared memory, in x's type, where it fits with the rest
//     (float32 up to u = 128: 196,608 B; bfloat16 up to u = 192).  Beyond
//     that the kernel reads U from device memory through L2 (786 kB at
//     u = 256 float32), slower but right: the launcher picks the placement
//     from the card's opt-in shared-memory limit.
//   * Tile: bb = 8 rows (fewer when 8 u > 1024 threads).  At 2048 rows and
//     u = 60 that is 256 CTAs of 480 threads, two CTAs an SM; at u = 256,
//     bb = 4 and 1024 threads.  Ragged B and T are masked in the kernel.
//   * As in rnn_avg.cu, shared-memory bandwidth (a U load per FMA pair of
//     the three gates) and one barrier a step bound this version, not the
//     FMA units; tensor cores and several steps a barrier are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBlockRows = 8;
constexpr int kTimeTile = 16;

int BlockRows(int units) {
  int bb = kBlockRows;
  while (bb > 1 && bb * units > kMaxThreads) --bb;
  return bb;
}

__device__ __forceinline__ float Sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float ToFloat(float x) { return x; }
__device__ __forceinline__ float ToFloat(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T FromFloat(float x);
template <>
__device__ __forceinline__ float FromFloat<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 FromFloat<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// The operand of the recurrent dot: h itself (float32), or h rounded to
// bfloat16.
template <typename T>
__device__ __forceinline__ float DotOperand(float x) {
  return ToFloat(FromFloat<T>(x));
}

// Shared memory of one CTA in bytes, without U.
size_t SmemBase(int units, int channels, int bb) {
  const size_t width = 3 * static_cast<size_t>(units);
  return sizeof(float) * (channels * width + 2 * width +
                          2 * static_cast<size_t>(bb) * units +
                          static_cast<size_t>(bb) * kTimeTile * channels);
}

// Bytes of U in shared memory (elem bytes an element).
size_t SmemU(int units, size_t elem) {
  return elem * 3 * static_cast<size_t>(units) * units;
}

// Whether U fits in shared memory beside the rest, within the current
// card's opt-in limit a block; a CUDA error otherwise.
cudaError_t UInSmem(int units, int channels, size_t elem, bool *fits) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  *fits = SmemBase(units, channels, BlockRows(units)) + SmemU(units, elem) <=
          static_cast<size_t>(optin);
  return cudaSuccess;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
GruSeqKernel(const T *__restrict__ x, int batch, int steps, int channels,
             const T *__restrict__ kernel, const float *__restrict__ bias,
             const T *__restrict__ recurrent, int units, int bb,
             bool u_in_smem, T *__restrict__ seq, T *__restrict__ last) {
  extern __shared__ float smem[];
  const int width = 3 * units;
  float *s_w = smem;                          // [C, width]
  float *s_b = s_w + channels * width;        // [2, width]
  float *s_h = s_b + 2 * width;               // [2 buffers][bb][u]
  float *s_x = s_h + 2 * bb * units;          // [bb][kTimeTile][C]
  T *s_u = reinterpret_cast<T *>(s_x + bb * kTimeTile * channels);

  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int row0 = blockIdx.x * bb;
  for (int j = tid; j < channels * width; j += n_threads) {
    s_w[j] = ToFloat(kernel[j]);
  }
  for (int j = tid; j < 2 * width; j += n_threads) s_b[j] = bias[j];
  for (int j = tid; j < 2 * bb * units; j += n_threads) s_h[j] = 0.0f;
  if (u_in_smem) {
    for (int j = tid; j < units * width; j += n_threads) {
      s_u[j] = recurrent[j];
    }
  }
  // U through a generic pointer: shared memory or device memory (L2).
  const T *u_src = u_in_smem ? s_u : recurrent;

  const int b = tid / units;
  const int i = tid % units;
  const int row = row0 + b;
  const bool valid = row < batch;
  const float *b_in = s_b;
  const float *b_rec = s_b + width;
  float h = 0.0f;

  for (int t = 0; t < steps; ++t) {
    const int s = t % kTimeTile;
    if (s == 0) {
      // Every thread is past the previous step's barrier, so the old tile
      // is no longer read.  Rows of a CTA are contiguous in x: coalesced.
      const int tile = kTimeTile * channels;
      for (int j = tid; j < bb * tile; j += n_threads) {
        const int rb = j / tile;
        const int tt = t + (j % tile) / channels;
        const int c = j % channels;
        const int r = row0 + rb;
        s_x[j] = (r < batch && tt < steps)
                     ? ToFloat(x[(static_cast<size_t>(r) * steps + tt) *
                                     channels + c])
                     : 0.0f;
      }
      __syncthreads();
    }
    const float *h_cur = s_h + (t & 1) * bb * units;
    float *h_nxt = s_h + ((t + 1) & 1) * bb * units;

    // Input dot x_t W in channel order, then + b_in.
    float xz = 0.0f, xr = 0.0f, xh = 0.0f;
    const float *x_t = s_x + (b * kTimeTile + s) * channels;
    for (int c = 0; c < channels; ++c) {
      const float v = x_t[c];
      const float *w = s_w + c * width + i;
      xz = fmaf(v, w[0], xz);
      xr = fmaf(v, w[units], xr);
      xh = fmaf(v, w[2 * units], xh);
    }
    xz += b_in[i];
    xr += b_in[units + i];
    xh += b_in[2 * units + i];

    // Recurrent products h @ U, float32 FMA in k order.
    float az = 0.0f, ar = 0.0f, ah = 0.0f;
    const float *hv = h_cur + b * units;
#pragma unroll 4
    for (int k = 0; k < units; ++k) {
      const T *u_k = u_src + k * width + i;
      const float v = hv[k];
      az = fmaf(v, ToFloat(u_k[0]), az);
      ar = fmaf(v, ToFloat(u_k[units]), ar);
      ah = fmaf(v, ToFloat(u_k[2 * units]), ah);
    }

    // Keras GRU, reset_after=True.
    const float z = Sigmoid(xz + (az + b_rec[i]));
    const float r = Sigmoid(xr + (ar + b_rec[units + i]));
    const float hh = tanhf(xh + r * (ah + b_rec[2 * units + i]));
    h = z * h + (1.0f - z) * hh;

    h_nxt[b * units + i] = DotOperand<T>(h);
    if (valid) {
      seq[(static_cast<size_t>(row) * steps + t) * units + i] =
          FromFloat<T>(h);
      if (t == steps - 1) {
        last[static_cast<size_t>(row) * units + i] = FromFloat<T>(h);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int Launch(const void *x, int batch, int steps, int channels,
           const void *kernel, const void *bias, const void *recurrent,
           int units, void *seq, void *last, void *stream) {
  if (batch <= 0 || steps <= 0 || channels <= 0 || units <= 0 ||
      units > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bb = BlockRows(units);
  bool u_in_smem = false;
  cudaError_t err = UInSmem(units, channels, sizeof(T), &u_in_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = SmemBase(units, channels, bb) +
                      (u_in_smem ? SmemU(units, sizeof(T)) : 0);
  // Above 48 kB a kernel only launches after this opt-in; a launch without
  // it is refused, and the refusal shows only in cudaGetLastError.
  err = cudaFuncSetAttribute(GruSeqKernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + bb - 1) / bb);
  GruSeqKernel<T><<<grid, bb * units, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T *>(x), batch, steps, channels,
      static_cast<const T *>(kernel), static_cast<const float *>(bias),
      static_cast<const T *>(recurrent), units, bb, u_in_smem,
      static_cast<T *>(seq), static_cast<T *>(last));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 = launched).  bf16 != 0 selects bfloat16 IO (x, kernel, recurrent,
// seq, last); bias is float32 either way.
int dg_gru_seq(const void *x, int batch, int steps, int channels,
               const void *kernel, const void *bias, const void *recurrent,
               int units, int bf16, void *seq, void *last, void *stream) {
  if (bf16) {
    return Launch<__nv_bfloat16>(x, batch, steps, channels, kernel, bias,
                                 recurrent, units, seq, last, stream);
  }
  return Launch<float>(x, batch, steps, channels, kernel, bias, recurrent,
                       units, seq, last, stream);
}

// 1 if U of a `units`-wide GRU over `channels` inputs stays in shared
// memory on the current card, 0 if the kernel reads it through L2, -1 on a
// CUDA error.
int dg_gru_seq_u_in_smem(int units, int channels, int bf16) {
  bool fits = false;
  if (UInSmem(units, channels, bf16 ? 2 : 4, &fits) != cudaSuccess) return -1;
  return fits ? 1 : 0;
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
