// Fused forward + reverse-complement GRU / LSTM recurrence with branch
// averaging (inference), for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package:
//   * dg_gru_avg, dg_gru_avg_bf16
//       <- deepgrp_tpu/models/pallas_rnn.py:178 _gru_avg_kernel
//          (pallas_gru_avg, :466; out_dtype float32 / bfloat16)
//   * dg_lstm_avg, dg_lstm_avg_bf16
//       <- deepgrp_tpu/models/pallas_rnn.py:309 _lstm_avg_kernel
//          (pallas_lstm_avg, :433; out_dtype float32 / bfloat16)
// Contract (identical to those kernels and to the plain PyTorch versions in
// deepgrp_tpu_torch/models/rnn.py): codes int8 [B, T] (A=0 C=1 G=2 T=3 N=4,
// pad=5); every window runs twice through one shared cell, forward and as its
// reverse complement (time reversed, codes mapped by (3,2,1,0,4,5)); the
// input projection is the exact row select W[code] plus bias (pad selects
// bias only); Keras gate math (GRU reset_after=True, gates z,r,h with an
// input and a recurrent bias row; LSTM gates i,f,c,o with one bias row);
// outputs avg [B, T, u] = (h_fwd + h_rev) / 2 at every step and
// hidden [B, u] = avg at step T-1, float32.  The _bf16 variants are the
// fast mode (the TPU's Precision.DEFAULT, pallas_rnn.py:262-265): h and U
// are rounded to bfloat16 for the recurrent dot, which accumulates in
// float32; the row select, the carry, the gate math and the average stay
// float32, and avg and hidden are stored as bfloat16.  The float32 variants
// compile to the same arithmetic as before the bf16 variants existed.
//
// Bound on this card.  Per window the recurrent products cost
// 2 rows x T x u x (g*u) multiply-adds (g = 3 GRU, 4 LSTM); at the flagship
// shape (T=342, u=60) that is 14.8 MFLOP per window against 82 kB of
// output, so the work is bound by float32 arithmetic (the H100 has no
// float32 tensor-core path; TF32 would not be float32), not by the bytes.
// The recurrence is sequential in T, so the parallelism is B x 2 x u.
//
// Design (right and simple first):
//   * One CTA owns a block of `bb` windows for all T steps; the recurrence
//     is a loop inside the kernel, not a grid dimension.  Nothing carries
//     between CTAs.
//   * Thread (b, i) owns unit i of window b for BOTH branches: it keeps
//     h_fwd[b, i] and h_rev[b, i] (and c for LSTM) in registers, computes
//     their g gate pre-activations, and writes avg[b, t, i] itself (no
//     second pass, no reverse-complement tensor in device memory).  Each U
//     element loaded from shared memory feeds two rows (fwd and rev).
//   * Shared memory holds U [u, g*u], W [5, g*u], the bias rows, the CTA's
//     codes [bb, T] (loaded once, so no global load sits on the step's
//     critical path), and the doubled hidden state [2*bb, u] twice: step t
//     reads one buffer and writes the other, so one __syncthreads per step
//     suffices.
//   * The recurrent dot is a plain float32 FMA chain over k in order (the
//     counterpart of Precision.HIGHEST on the TPU): no TF32, no tensor
//     cores.
//   * Tile: bb = 8 windows (fewer when 8*u > 1024 threads).  At the engine's
//     batch of 1024 windows that is 128 CTAs for the 132 SMs, one wave with
//     one CTA per SM; at u=60 a CTA has 480 threads (15 warps) and needs
//     ~59 kB (GRU) / ~75 kB (LSTM) of shared memory, above the 48 kB static
//     limit, so the launch opts in to dynamic shared memory.  Ragged B is
//     masked in the kernel (rows past B read pad codes and store nothing).
//   * What bounds this version is shared-memory bandwidth (3-4 loads per
//     2-row FMA pair), not the FMA units; tensor cores, more rows per thread
//     and several steps per barrier are left to later work.  The bf16
//     variants keep U and h in shared memory as float32 values already
//     rounded to bfloat16, so they run the same float32 FMAs: their bound
//     is the same work at the bf16 tensor-core rate, which this design
//     cannot reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodes = 5;  // W rows: A, C, G, T, N; pad (5) selects none
constexpr int kPadCode = 5;
constexpr int kMaxThreads = 1024;
constexpr int kBlockRows = 8;

int BlockRows(int units) {
  int bb = kBlockRows;
  while (bb > 1 && bb * units > kMaxThreads) --bb;
  return bb;
}

__device__ __forceinline__ float Sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ int Complement(int c) {
  return (c >= 0 && c < 4) ? 3 - c : c;  // A<->T, C<->G, N and pad kept
}

// Output element type and the precision of the recurrent dot's operands.
template <bool kBf16>
struct Io;
template <>
struct Io<false> {
  using Out = float;
  static __device__ __forceinline__ float Operand(float x) { return x; }
  static __device__ __forceinline__ float Store(float x) { return x; }
};
template <>
struct Io<true> {
  using Out = __nv_bfloat16;
  // Round to nearest even, as torch's .to(torch.bfloat16).
  static __device__ __forceinline__ float Operand(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 Store(float x) {
    return __float2bfloat16(x);
  }
};

// kGates == 3: GRU (bias [2, 3u]: input row, recurrent row).
// kGates == 4: LSTM (bias [4u]).
template <int kGates, bool kBf16>
__global__ void __launch_bounds__(kMaxThreads, 1)
RnnAvgKernel(const int8_t *__restrict__ codes, int batch, int steps,
             const float *__restrict__ kernel, const float *__restrict__ bias,
             const float *__restrict__ recurrent, int units, int bb,
             typename Io<kBf16>::Out *__restrict__ avg,
             typename Io<kBf16>::Out *__restrict__ hidden) {
  using IoT = Io<kBf16>;
  constexpr int kBiasRows = (kGates == 3) ? 2 : 1;
  extern __shared__ float smem[];
  const int width = kGates * units;
  float *s_u = smem;                           // [u, width]
  float *s_w = s_u + units * width;            // [5, width]
  float *s_b = s_w + kCodes * width;           // [kBiasRows, width]
  float *s_h = s_b + kBiasRows * width;        // [2 buffers][2*bb][u]
  int8_t *s_codes = reinterpret_cast<int8_t *>(s_h + 4 * bb * units);

  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int row0 = blockIdx.x * bb;
  for (int j = tid; j < units * width; j += n_threads) {
    s_u[j] = IoT::Operand(recurrent[j]);
  }
  for (int j = tid; j < kCodes * width; j += n_threads) s_w[j] = kernel[j];
  for (int j = tid; j < kBiasRows * width; j += n_threads) s_b[j] = bias[j];
  for (int j = tid; j < 4 * bb * units; j += n_threads) s_h[j] = 0.0f;
  for (int j = tid; j < bb * steps; j += n_threads) {
    const bool in_batch = row0 + j / steps < batch;
    s_codes[j] = in_batch ? codes[static_cast<size_t>(row0) * steps + j]
                          : static_cast<int8_t>(kPadCode);
  }
  __syncthreads();

  const int b = tid / units;
  const int i = tid % units;
  const int row = row0 + b;
  const bool valid = row < batch;
  const int8_t *my_codes = s_codes + b * steps;
  const float *b_in = s_b;
  const float *b_rec = s_b + (kBiasRows - 1) * width;  // GRU recurrent row
  float h_f = 0.0f, h_r = 0.0f, c_f = 0.0f, c_r = 0.0f;

  for (int t = 0; t < steps; ++t) {
    const float *h_cur = s_h + (t & 1) * 2 * bb * units;
    float *h_nxt = s_h + ((t + 1) & 1) * 2 * bb * units;
    const int code_f = my_codes[t];
    const int code_r = Complement(my_codes[steps - 1 - t]);

    // Input projection: bias + W[code] (exact row select).
    float x_f[kGates], x_r[kGates];
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      x_f[g] = b_in[g * units + i];
      x_r[g] = b_in[g * units + i];
    }
    if (static_cast<unsigned>(code_f) < kCodes) {
      const float *w = s_w + code_f * width;
#pragma unroll
      for (int g = 0; g < kGates; ++g) x_f[g] += w[g * units + i];
    }
    if (static_cast<unsigned>(code_r) < kCodes) {
      const float *w = s_w + code_r * width;
#pragma unroll
      for (int g = 0; g < kGates; ++g) x_r[g] += w[g * units + i];
    }

    // Recurrent products h @ U for both branches, float32 FMA in k order.
    float a_f[kGates], a_r[kGates];
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      a_f[g] = 0.0f;
      a_r[g] = 0.0f;
    }
    const float *hv_f = h_cur + b * units;
    const float *hv_r = h_cur + (bb + b) * units;
#pragma unroll 4
    for (int k = 0; k < units; ++k) {
      const float *u_k = s_u + k * width + i;
      const float vf = hv_f[k];
      const float vr = hv_r[k];
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        const float w = u_k[g * units];
        a_f[g] = fmaf(vf, w, a_f[g]);
        a_r[g] = fmaf(vr, w, a_r[g]);
      }
    }

    if constexpr (kGates == 3) {
      // Keras GRU, reset_after=True.
      const float rz = b_rec[i], rr = b_rec[units + i],
                  rh = b_rec[2 * units + i];
      float z = Sigmoid(x_f[0] + (a_f[0] + rz));
      float r = Sigmoid(x_f[1] + (a_f[1] + rr));
      float hh = tanhf(x_f[2] + r * (a_f[2] + rh));
      h_f = z * h_f + (1.0f - z) * hh;
      z = Sigmoid(x_r[0] + (a_r[0] + rz));
      r = Sigmoid(x_r[1] + (a_r[1] + rr));
      hh = tanhf(x_r[2] + r * (a_r[2] + rh));
      h_r = z * h_r + (1.0f - z) * hh;
    } else {
      // Keras LSTM, gates i, f, c, o.
      float ig = Sigmoid(x_f[0] + a_f[0]);
      float fg = Sigmoid(x_f[1] + a_f[1]);
      float gg = tanhf(x_f[2] + a_f[2]);
      float og = Sigmoid(x_f[3] + a_f[3]);
      c_f = fg * c_f + ig * gg;
      h_f = og * tanhf(c_f);
      ig = Sigmoid(x_r[0] + a_r[0]);
      fg = Sigmoid(x_r[1] + a_r[1]);
      gg = tanhf(x_r[2] + a_r[2]);
      og = Sigmoid(x_r[3] + a_r[3]);
      c_r = fg * c_r + ig * gg;
      h_r = og * tanhf(c_r);
    }

    h_nxt[b * units + i] = IoT::Operand(h_f);
    h_nxt[(bb + b) * units + i] = IoT::Operand(h_r);
    if (valid) {
      const float mean = (h_f + h_r) * 0.5f;
      avg[(static_cast<size_t>(row) * steps + t) * units + i] =
          IoT::Store(mean);
      if (t == steps - 1) {
        hidden[static_cast<size_t>(row) * units + i] = IoT::Store(mean);
      }
    }
    __syncthreads();
  }
}

template <int kGates, bool kBf16>
int Launch(const void *codes, int batch, int steps, const void *kernel,
           const void *bias, const void *recurrent, int units, void *avg,
           void *hidden, void *stream) {
  if (batch <= 0 || steps <= 0 || units <= 0 || units > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bias_rows = (kGates == 3) ? 2 : 1;
  const int bb = BlockRows(units);
  const size_t width = static_cast<size_t>(kGates) * units;
  const size_t smem =
      sizeof(float) * (units * width + kCodes * width + bias_rows * width +
                       4 * static_cast<size_t>(bb) * units) +
      static_cast<size_t>(bb) * steps;
  // Above 48 kB a kernel only launches after this opt-in; a launch without
  // it is refused, and the refusal shows only in cudaGetLastError.
  using Out = typename Io<kBf16>::Out;
  cudaError_t err = cudaFuncSetAttribute(
      RnnAvgKernel<kGates, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + bb - 1) / bb);
  RnnAvgKernel<kGates, kBf16><<<grid, bb * units, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t *>(codes), batch, steps,
      static_cast<const float *>(kernel), static_cast<const float *>(bias),
      static_cast<const float *>(recurrent), units, bb,
      static_cast<Out *>(avg), static_cast<Out *>(hidden));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 = launched).
int dg_gru_avg(const void *codes, int batch, int steps, const void *kernel,
               const void *bias, const void *recurrent, int units, void *avg,
               void *hidden, void *stream) {
  return Launch<3, false>(codes, batch, steps, kernel, bias, recurrent,
                          units, avg, hidden, stream);
}

int dg_lstm_avg(const void *codes, int batch, int steps, const void *kernel,
                const void *bias, const void *recurrent, int units, void *avg,
                void *hidden, void *stream) {
  return Launch<4, false>(codes, batch, steps, kernel, bias, recurrent,
                          units, avg, hidden, stream);
}

// The bfloat16 fast mode: same arguments, avg and hidden bfloat16.
int dg_gru_avg_bf16(const void *codes, int batch, int steps,
                    const void *kernel, const void *bias,
                    const void *recurrent, int units, void *avg, void *hidden,
                    void *stream) {
  return Launch<3, true>(codes, batch, steps, kernel, bias, recurrent, units,
                         avg, hidden, stream);
}

int dg_lstm_avg_bf16(const void *codes, int batch, int steps,
                     const void *kernel, const void *bias,
                     const void *recurrent, int units, void *avg,
                     void *hidden, void *stream) {
  return Launch<4, true>(codes, batch, steps, kernel, bias, recurrent, units,
                         avg, hidden, stream);
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
