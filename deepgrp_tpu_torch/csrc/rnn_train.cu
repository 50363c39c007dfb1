// Training forward and backward of the fused forward + reverse-complement
// GRU / LSTM recurrence with branch averaging, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package
// (deepgrp_tpu/models/pallas_rnn_train.py):
//   * dg_gru_train_fwd  <- :97  _gru_train_fwd_kernel  (_fwd_call :252)
//   * dg_gru_train_bwd  <- :135 _gru_train_bwd_kernel  (_bwd_call :328,
//                          custom VJP pallas_gru_avg_train :422-474)
//   * dg_lstm_train_fwd <- :496 _lstm_train_fwd_kernel (_lstm_fwd_call :638)
//   * dg_lstm_train_bwd <- :542 _lstm_train_bwd_kernel (_lstm_bwd_call :715,
//                          custom VJP pallas_lstm_avg_train :806-855)
// Contract (identical to those kernels and to the plain PyTorch versions in
// deepgrp_tpu_torch/models/rnn.py): the inference contract of rnn_avg.cu,
// plus Keras input dropout as per-gate scales of the selected input row,
//   xp_g[row, t] = b_in_g + mask[g, row, code] * W_g[code]
// (masks float32 [g, 2B, 5], rows 0..B-1 forward, B..2B-1 reverse
// complement; a null mask pointer means scale 1; pad code 5 selects bias
// only, N (4) is a real channel).  The forward also writes the residuals
// the backward reads: hseq [2B, T, u] (and cseq for LSTM), forward rows
// first, each branch in its own time order.
//
// Backward per step t (reverse order), given the carried cotangent dh
// (seeded dhid/2 on both branch rows; each step adds davg[t]/2):
//   GRU:  da_z = dh (h_prev - hh) z (1-z),  da_h = dh (1-z) (1-hh^2),
//         da_r = da_h rh r (1-r);  d_xp = [da_z, da_r, da_h],
//         d_rp = [da_z, da_r, da_h r];  dh_prev = dh z + d_rp U^T
//   LSTM: do = dh tanh(c), dc_t = dc + dh o (1-tanh(c)^2),
//         da = [dc_t g i(1-i), dc_t c_prev f(1-f), dc_t i (1-g^2),
//               do o(1-o)];  dh_prev = da U^T,  dc_prev = dc_t f
//   dU += h_prev^T d_rp, db += sums of d_xp (and d_rp), and
//   dW[c] += sum over rows with code c of mask_c * d_xp.
// The gates are recomputed from h_prev (and c_prev), as on the TPU: only
// hseq (cseq) goes through device memory.
//
// Bound on this card.  The forward does the inference kernel's multiply-adds
// (2 rows x T x u x g*u a window); the backward about three times as many
// (gate recompute, d_rp U^T, and h_prev^T d_rp).  At the flagship training
// shape (B=256, T=342, u=60) that is 3.8 GFLOP forward against ~42 MB of
// hseq written, so both kernels are bound by float32 arithmetic, not bytes.
// The recurrence is sequential in T, so the parallelism is B x 2 x u.
//
// Design (right and simple first):
//   * One CTA owns `bb` windows (both branch rows of each) for all T steps;
//     thread (b, i) owns unit i of the forward and the reverse-complement
//     row of window b.  bb is chosen from the batch so that the grid fills
//     the SMs: the smallest bb in 1..8 with ceil(B / bb) <= #SMs (B=256 on
//     132 SMs: bb=2, 128 CTAs).
//   * Forward: as rnn_avg.cu (U, W, biases, the CTA's codes, mask scales and
//     a double-buffered hidden state in shared memory, one barrier a step),
//     plus the stores of hseq / cseq.
//   * Backward: a reverse loop over t with two barriers a step: (1) stage
//     h_prev of the CTA's rows, (2) stage d_rp, then each thread forms its
//     dh_prev with the row U[i, :] (U is kept with an odd row stride, so
//     that 32 threads reading 32 rows hit 32 banks) and updates its share of
//     the CTA's dU, which lives in shared memory (element e belongs to
//     thread e mod #threads; rows summed in order).  dW and db are summed
//     in registers, per thread.
//   * No float atomics: each CTA writes its dU, and each (CTA, b) slot its
//     dW and db, to partial buffers in device memory; a second kernel sums
//     the partials in a fixed order.  Two runs give bitwise-equal
//     gradients.
//   * All float32 with FMA in k order (the counterpart of
//     Precision.HIGHEST): no TF32, no tensor cores.  Making these fast
//     (tensor cores, more rows a thread, several steps a barrier) is later
//     work; dU's shared-memory update is the likely limit of the backward.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodes = 5;  // W rows: A, C, G, T, N; pad (5) selects none
constexpr int kPadCode = 5;
constexpr int kMaxThreads = 512;
constexpr int kMaxBlockRows = 8;

__device__ __forceinline__ float Sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ int Complement(int c) {
  return (c >= 0 && c < 4) ? 3 - c : c;  // A<->T, C<->G, N and pad kept
}

int SmCount() {
  int device = 0, count = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess) {
    return 0;
  }
  return count;
}

// Windows a CTA owns: the least that keeps the grid within one wave.
int TrainBlockRows(int batch, int units) {
  const int sms = SmCount();
  int bb = sms > 0 ? (batch + sms - 1) / sms : kMaxBlockRows;
  if (bb < 1) bb = 1;
  if (bb > kMaxBlockRows) bb = kMaxBlockRows;
  while (bb > 1 && bb * units > kMaxThreads) --bb;
  return bb;
}

// Row stride of U in the backward's shared memory: odd, so that the 32
// threads of a warp reading U[i, j] for 32 consecutive i hit 32 banks.
__host__ __device__ __forceinline__ int OddStride(int width) {
  return width | 1;
}

// Stages the CTA's per-gate mask scales: s_m[lr * g*5 + g*5 + c] for local
// row lr (0..bb-1 forward, bb..2bb-1 reverse complement).  1 without masks
// or past the batch.
template <int kGates>
__device__ void StageMasks(const float *__restrict__ masks, int batch,
                           int row0, int bb, float *s_m) {
  const int per_row = kGates * kCodes;
  for (int j = threadIdx.x; j < 2 * bb * per_row; j += blockDim.x) {
    const int lr = j / per_row;
    const int g = (j % per_row) / kCodes;
    const int c = j % kCodes;
    const int window = row0 + (lr < bb ? lr : lr - bb);
    const int grow = lr < bb ? window : batch + window;
    s_m[j] = (masks != nullptr && window < batch)
                 ? masks[(static_cast<size_t>(g) * 2 * batch + grow) *
                             kCodes + c]
                 : 1.0f;
  }
}

__device__ void StageCodes(const int8_t *__restrict__ codes, int batch,
                           int steps, int row0, int bb, int8_t *s_codes) {
  for (int j = threadIdx.x; j < bb * steps; j += blockDim.x) {
    const bool in_batch = row0 + j / steps < batch;
    s_codes[j] = in_batch ? codes[static_cast<size_t>(row0) * steps + j]
                          : static_cast<int8_t>(kPadCode);
  }
}

// Masked input projection of one row for unit i: bias + scale * W[code].
template <int kGates>
__device__ __forceinline__ void InputProjection(const float *s_w,
                                                const float *b_in,
                                                const float *m_row, int code,
                                                int units, int i,
                                                float *x) {
  const int width = kGates * units;
#pragma unroll
  for (int g = 0; g < kGates; ++g) x[g] = b_in[g * units + i];
  if (static_cast<unsigned>(code) < kCodes) {
    const float *w = s_w + code * width;
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      x[g] += m_row[g * kCodes + code] * w[g * units + i];
    }
  }
}

// ---------------------------------------------------------------- forward

template <int kGates>
__global__ void __launch_bounds__(kMaxThreads, 1)
RnnTrainFwdKernel(const int8_t *__restrict__ codes, int batch, int steps,
                  const float *__restrict__ masks,
                  const float *__restrict__ kernel,
                  const float *__restrict__ bias,
                  const float *__restrict__ recurrent, int units, int bb,
                  float *__restrict__ avg, float *__restrict__ hidden,
                  float *__restrict__ hseq, float *__restrict__ cseq) {
  constexpr int kBiasRows = (kGates == 3) ? 2 : 1;
  extern __shared__ float smem[];
  const int width = kGates * units;
  float *s_u = smem;                          // [u, width]
  float *s_w = s_u + units * width;           // [5, width]
  float *s_b = s_w + kCodes * width;          // [kBiasRows, width]
  float *s_m = s_b + kBiasRows * width;       // [2bb, g*5]
  float *s_h = s_m + 2 * bb * kGates * kCodes;  // [2 buffers][2bb][u]
  int8_t *s_codes = reinterpret_cast<int8_t *>(s_h + 4 * bb * units);

  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int row0 = blockIdx.x * bb;
  for (int j = tid; j < units * width; j += n_threads) s_u[j] = recurrent[j];
  for (int j = tid; j < kCodes * width; j += n_threads) s_w[j] = kernel[j];
  for (int j = tid; j < kBiasRows * width; j += n_threads) s_b[j] = bias[j];
  for (int j = tid; j < 4 * bb * units; j += n_threads) s_h[j] = 0.0f;
  StageMasks<kGates>(masks, batch, row0, bb, s_m);
  StageCodes(codes, batch, steps, row0, bb, s_codes);
  __syncthreads();

  const int b = tid / units;
  const int i = tid % units;
  const int row = row0 + b;
  const bool valid = row < batch;
  const int8_t *my_codes = s_codes + b * steps;
  const float *m_f = s_m + b * kGates * kCodes;
  const float *m_r = s_m + (bb + b) * kGates * kCodes;
  const float *b_rec = s_b + (kBiasRows - 1) * width;  // GRU recurrent row
  const size_t seq_f = static_cast<size_t>(row) * steps * units + i;
  const size_t seq_r = static_cast<size_t>(batch + row) * steps * units + i;
  float h_f = 0.0f, h_r = 0.0f, c_f = 0.0f, c_r = 0.0f;

  for (int t = 0; t < steps; ++t) {
    const float *h_cur = s_h + (t & 1) * 2 * bb * units;
    float *h_nxt = s_h + ((t + 1) & 1) * 2 * bb * units;
    float x_f[kGates], x_r[kGates];
    InputProjection<kGates>(s_w, s_b, m_f, my_codes[t], units, i, x_f);
    InputProjection<kGates>(s_w, s_b, m_r,
                            Complement(my_codes[steps - 1 - t]), units, i,
                            x_r);

    // Recurrent products h @ U for both rows, float32 FMA in k order.
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

    h_nxt[b * units + i] = h_f;
    h_nxt[(bb + b) * units + i] = h_r;
    if (valid) {
      const size_t at = static_cast<size_t>(t) * units;
      hseq[seq_f + at] = h_f;
      hseq[seq_r + at] = h_r;
      if constexpr (kGates == 4) {
        cseq[seq_f + at] = c_f;
        cseq[seq_r + at] = c_r;
      }
      const float mean = (h_f + h_r) * 0.5f;
      avg[(static_cast<size_t>(row) * steps + t) * units + i] = mean;
      if (t == steps - 1) hidden[static_cast<size_t>(row) * units + i] = mean;
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------- backward

template <int kGates>
__global__ void __launch_bounds__(kMaxThreads, 1)
RnnTrainBwdKernel(const int8_t *__restrict__ codes, int batch, int steps,
                  const float *__restrict__ masks,
                  const float *__restrict__ kernel,
                  const float *__restrict__ bias,
                  const float *__restrict__ recurrent, int units, int bb,
                  const float *__restrict__ hseq,
                  const float *__restrict__ cseq,
                  const float *__restrict__ d_avg,
                  const float *__restrict__ d_hidden,
                  float *__restrict__ part_w, float *__restrict__ part_b,
                  float *__restrict__ part_u) {
  constexpr int kBiasRows = (kGates == 3) ? 2 : 1;
  extern __shared__ float smem[];
  const int width = kGates * units;
  const int ldu = OddStride(width);
  float *s_u = smem;                           // [u, ldu]
  float *s_du = s_u + units * ldu;             // [u, width] dU of the CTA
  float *s_w = s_du + units * width;           // [5, width]
  float *s_b = s_w + kCodes * width;           // [kBiasRows, width]
  float *s_m = s_b + kBiasRows * width;        // [2bb, g*5]
  float *s_hp = s_m + 2 * bb * kGates * kCodes;  // [2 buffers][2bb][u]
  float *s_drp = s_hp + 4 * bb * units;        // [2bb, width]
  int8_t *s_codes = reinterpret_cast<int8_t *>(s_drp + 2 * bb * width);

  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int row0 = blockIdx.x * bb;
  for (int j = tid; j < units * width; j += n_threads) {
    s_u[(j / width) * ldu + j % width] = recurrent[j];
    s_du[j] = 0.0f;
  }
  for (int j = tid; j < kCodes * width; j += n_threads) s_w[j] = kernel[j];
  for (int j = tid; j < kBiasRows * width; j += n_threads) s_b[j] = bias[j];
  StageMasks<kGates>(masks, batch, row0, bb, s_m);
  StageCodes(codes, batch, steps, row0, bb, s_codes);
  __syncthreads();

  const int b = tid / units;
  const int i = tid % units;
  const int row = row0 + b;
  const bool valid = row < batch;
  const int8_t *my_codes = s_codes + b * steps;
  const float *m_f = s_m + b * kGates * kCodes;
  const float *m_r = s_m + (bb + b) * kGates * kCodes;
  const float *b_rec = s_b + (kBiasRows - 1) * width;
  const size_t seq_f = static_cast<size_t>(row) * steps * units + i;
  const size_t seq_r = static_cast<size_t>(batch + row) * steps * units + i;

  // Carried cotangents; the final state's cotangent seeds both rows.
  const float half_hid =
      valid ? d_hidden[static_cast<size_t>(row) * units + i] * 0.5f : 0.0f;
  float dh_f = half_hid, dh_r = half_hid, dc_f = 0.0f, dc_r = 0.0f;
  float acc_w[kCodes][kGates], acc_b[kBiasRows][kGates];
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
#pragma unroll
    for (int c = 0; c < kCodes; ++c) acc_w[c][g] = 0.0f;
#pragma unroll
    for (int r = 0; r < kBiasRows; ++r) acc_b[r][g] = 0.0f;
  }

  // Values of step t, loaded one step ahead: h_prev and c_prev of both
  // rows (zero at t=0) and davg/2.
  float nx_hf = 0.0f, nx_hr = 0.0f, nx_cf = 0.0f, nx_cr = 0.0f, nx_da = 0.0f;
  {
    const int t = steps - 1;
    if (valid) {
      nx_da = d_avg[(static_cast<size_t>(row) * steps + t) * units + i] *
              0.5f;
      if (t > 0) {
        const size_t at = static_cast<size_t>(t - 1) * units;
        nx_hf = hseq[seq_f + at];
        nx_hr = hseq[seq_r + at];
        if constexpr (kGates == 4) {
          nx_cf = cseq[seq_f + at];
          nx_cr = cseq[seq_r + at];
        }
      }
    }
  }

  for (int t = steps - 1; t >= 0; --t) {
    const float hp_f = nx_hf, hp_r = nx_hr, cp_f = nx_cf, cp_r = nx_cr;
    const float half_avg = nx_da;
    float *hp = s_hp + (t & 1) * 2 * bb * units;
    hp[b * units + i] = hp_f;
    hp[(bb + b) * units + i] = hp_r;
    if (t > 0) {  // prefetch step t-1; the loads land during this step
      nx_hf = nx_hr = nx_cf = nx_cr = nx_da = 0.0f;
      if (valid) {
        nx_da = d_avg[(static_cast<size_t>(row) * steps + t - 1) * units +
                      i] * 0.5f;
        if (t > 1) {
          const size_t at = static_cast<size_t>(t - 2) * units;
          nx_hf = hseq[seq_f + at];
          nx_hr = hseq[seq_r + at];
          if constexpr (kGates == 4) {
            nx_cf = cseq[seq_f + at];
            nx_cr = cseq[seq_r + at];
          }
        }
      }
    }
    __syncthreads();  // (1) h_prev of every row staged

    const int code_f = my_codes[t];
    const int code_r = Complement(my_codes[steps - 1 - t]);
    float x_f[kGates], x_r[kGates];
    InputProjection<kGates>(s_w, s_b, m_f, code_f, units, i, x_f);
    InputProjection<kGates>(s_w, s_b, m_r, code_r, units, i, x_r);
    float a_f[kGates], a_r[kGates];
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      a_f[g] = 0.0f;
      a_r[g] = 0.0f;
    }
    const float *hv_f = hp + b * units;
    const float *hv_r = hp + (bb + b) * units;
#pragma unroll 4
    for (int k = 0; k < units; ++k) {
      const float *u_k = s_u + k * ldu + i;
      const float vf = hv_f[k];
      const float vr = hv_r[k];
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        const float w = u_k[g * units];
        a_f[g] = fmaf(vf, w, a_f[g]);
        a_r[g] = fmaf(vr, w, a_r[g]);
      }
    }

    const float dht_f = dh_f + half_avg;
    const float dht_r = dh_r + half_avg;
    float dx_f[kGates], dx_r[kGates];  // d_xp of both rows
    float keep_f = 0.0f, keep_r = 0.0f;  // GRU: dh * z
    float *drp_f = s_drp + b * width + i;
    float *drp_r = s_drp + (bb + b) * width + i;
    if constexpr (kGates == 3) {
      const float rz = b_rec[i], rr = b_rec[units + i],
                  rhb = b_rec[2 * units + i];
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const float *x = side ? x_r : x_f;
        const float *a = side ? a_r : a_f;
        const float dht = side ? dht_r : dht_f;
        const float h_prev = side ? hp_r : hp_f;
        float *dx = side ? dx_r : dx_f;
        float *drp = side ? drp_r : drp_f;
        const float z = Sigmoid(x[0] + (a[0] + rz));
        const float r = Sigmoid(x[1] + (a[1] + rr));
        const float rh = a[2] + rhb;
        const float hh = tanhf(x[2] + r * rh);
        const float da_z = dht * (h_prev - hh) * z * (1.0f - z);
        const float da_h = dht * (1.0f - z) * (1.0f - hh * hh);
        const float da_r = (da_h * rh) * r * (1.0f - r);
        dx[0] = da_z;
        dx[1] = da_r;
        dx[2] = da_h;
        drp[0] = da_z;
        drp[units] = da_r;
        drp[2 * units] = da_h * r;
        acc_b[1][0] += da_z;
        acc_b[1][1] += da_r;
        acc_b[1][2] += da_h * r;
        if (side) {
          keep_r = dht * z;
        } else {
          keep_f = dht * z;
        }
      }
    } else {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const float *x = side ? x_r : x_f;
        const float *a = side ? a_r : a_f;
        const float dht = side ? dht_r : dht_f;
        const float c_prev = side ? cp_r : cp_f;
        float *dx = side ? dx_r : dx_f;
        float *drp = side ? drp_r : drp_f;
        const float gi = Sigmoid(x[0] + a[0]);
        const float gf = Sigmoid(x[1] + a[1]);
        const float gg = tanhf(x[2] + a[2]);
        const float go = Sigmoid(x[3] + a[3]);
        const float c_t = gf * c_prev + gi * gg;
        const float tanh_c = tanhf(c_t);
        const float d_o = dht * tanh_c;
        const float dc_t =
            (side ? dc_r : dc_f) + dht * go * (1.0f - tanh_c * tanh_c);
        dx[0] = (dc_t * gg) * gi * (1.0f - gi);
        dx[1] = (dc_t * c_prev) * gf * (1.0f - gf);
        dx[2] = (dc_t * gi) * (1.0f - gg * gg);
        dx[3] = d_o * go * (1.0f - go);
#pragma unroll
        for (int g = 0; g < 4; ++g) drp[g * units] = dx[g];
        if (side) {
          dc_r = dc_t * gf;
        } else {
          dc_f = dc_t * gf;
        }
      }
    }
    // dW and the input bias: the selected row's mask scale times d_xp.
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      acc_b[0][g] += dx_f[g];
      acc_b[0][g] += dx_r[g];
#pragma unroll
      for (int c = 0; c < kCodes; ++c) {
        if (code_f == c) acc_w[c][g] += m_f[g * kCodes + c] * dx_f[g];
        if (code_r == c) acc_w[c][g] += m_r[g * kCodes + c] * dx_r[g];
      }
    }
    __syncthreads();  // (2) d_rp of every row staged

    // dh_prev = (dh z) + d_rp U[i, :]^T.
    float dot_f = 0.0f, dot_r = 0.0f;
    const float *u_i = s_u + i * ldu;
    const float *dv_f = s_drp + b * width;
    const float *dv_r = s_drp + (bb + b) * width;
#pragma unroll 4
    for (int j = 0; j < width; ++j) {
      const float w = u_i[j];
      dot_f = fmaf(dv_f[j], w, dot_f);
      dot_r = fmaf(dv_r[j], w, dot_r);
    }
    dh_f = keep_f + dot_f;
    dh_r = keep_r + dot_r;

    // dU += h_prev^T d_rp over the CTA's rows, in row order.
    for (int e = tid; e < units * width; e += n_threads) {
      const int k = e / width;
      const int j = e - k * width;
      float acc = s_du[e];
      for (int lr = 0; lr < 2 * bb; ++lr) {
        acc = fmaf(hp[lr * units + k], s_drp[lr * width + j], acc);
      }
      s_du[e] = acc;
    }
  }
  __syncthreads();

  // Partials: dU per CTA, dW and db per (CTA, b) slot.
  float *pu = part_u + static_cast<size_t>(blockIdx.x) * units * width;
  for (int e = tid; e < units * width; e += n_threads) pu[e] = s_du[e];
  const size_t slot = static_cast<size_t>(row0 + b);
  float *pw = part_w + slot * kCodes * width;
  float *pb = part_b + slot * kBiasRows * width;
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
#pragma unroll
    for (int c = 0; c < kCodes; ++c) pw[c * width + g * units + i] =
        acc_w[c][g];
#pragma unroll
    for (int r = 0; r < kBiasRows; ++r) pb[r * width + g * units + i] =
        acc_b[r][g];
  }
}

// out[e] = sum over p of parts[p, e], p in order (deterministic).
__global__ void SumPartsKernel(const float *__restrict__ parts, int n_parts,
                               int n_elem, float *__restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elem) return;
  float acc = 0.0f;
  for (int p = 0; p < n_parts; ++p) {
    acc += parts[static_cast<size_t>(p) * n_elem + e];
  }
  out[e] = acc;
}

size_t FwdSmem(int gates, int units, int bb, int steps) {
  const size_t width = static_cast<size_t>(gates) * units;
  const int bias_rows = (gates == 3) ? 2 : 1;
  return sizeof(float) *
             (units * width + kCodes * width + bias_rows * width +
              2 * static_cast<size_t>(bb) * gates * kCodes +
              4 * static_cast<size_t>(bb) * units) +
         static_cast<size_t>(bb) * steps;
}

size_t BwdSmem(int gates, int units, int bb, int steps) {
  const size_t width = static_cast<size_t>(gates) * units;
  const int bias_rows = (gates == 3) ? 2 : 1;
  return sizeof(float) *
             (units * static_cast<size_t>(OddStride(static_cast<int>(width))) +
              units * width + kCodes * width + bias_rows * width +
              2 * static_cast<size_t>(bb) * gates * kCodes +
              4 * static_cast<size_t>(bb) * units +
              2 * static_cast<size_t>(bb) * width) +
         static_cast<size_t>(bb) * steps;
}

bool BadShape(int batch, int steps, int units, int bb) {
  return batch <= 0 || steps <= 0 || units <= 0 || bb <= 0 ||
         bb > kMaxBlockRows || bb * units > kMaxThreads;
}

template <int kGates>
int LaunchFwd(const void *codes, int batch, int steps, const void *masks,
              const void *kernel, const void *bias, const void *recurrent,
              int units, int bb, void *avg, void *hidden, void *hseq,
              void *cseq, void *stream) {
  if (BadShape(batch, steps, units, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = FwdSmem(kGates, units, bb, steps);
  // Above 48 kB a kernel only launches after this opt-in; a launch without
  // it is refused, and the refusal shows only in cudaGetLastError.
  cudaError_t err = cudaFuncSetAttribute(
      RnnTrainFwdKernel<kGates>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + bb - 1) / bb);
  RnnTrainFwdKernel<kGates><<<grid, bb * units, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t *>(codes), batch, steps,
      static_cast<const float *>(masks), static_cast<const float *>(kernel),
      static_cast<const float *>(bias),
      static_cast<const float *>(recurrent), units, bb,
      static_cast<float *>(avg), static_cast<float *>(hidden),
      static_cast<float *>(hseq), static_cast<float *>(cseq));
  return static_cast<int>(cudaGetLastError());
}

template <int kGates>
int LaunchBwd(const void *codes, int batch, int steps, const void *masks,
              const void *kernel, const void *bias, const void *recurrent,
              int units, int bb, const void *hseq, const void *cseq,
              const void *d_avg, const void *d_hidden, void *part_w,
              void *part_b, void *part_u, void *d_kernel, void *d_bias,
              void *d_recurrent, void *stream) {
  if (BadShape(batch, steps, units, bb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kBiasRows = (kGates == 3) ? 2 : 1;
  const size_t smem = BwdSmem(kGates, units, bb, steps);
  cudaError_t err = cudaFuncSetAttribute(
      RnnTrainBwdKernel<kGates>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_cta = (batch + bb - 1) / bb;
  RnnTrainBwdKernel<kGates><<<n_cta, bb * units, smem, s>>>(
      static_cast<const int8_t *>(codes), batch, steps,
      static_cast<const float *>(masks), static_cast<const float *>(kernel),
      static_cast<const float *>(bias),
      static_cast<const float *>(recurrent), units, bb,
      static_cast<const float *>(hseq), static_cast<const float *>(cseq),
      static_cast<const float *>(d_avg),
      static_cast<const float *>(d_hidden), static_cast<float *>(part_w),
      static_cast<float *>(part_b), static_cast<float *>(part_u));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int width = kGates * units;
  const int n_slots = n_cta * bb;
  const struct {
    const void *parts;
    int n_parts, n_elem;
    void *out;
  } sums[3] = {{part_w, n_slots, kCodes * width, d_kernel},
               {part_b, n_slots, kBiasRows * width, d_bias},
               {part_u, n_cta, units * width, d_recurrent}};
  for (const auto &job : sums) {
    constexpr int kThreads = 256;
    SumPartsKernel<<<(job.n_elem + kThreads - 1) / kThreads, kThreads, 0,
                     s>>>(static_cast<const float *>(job.parts),
                          job.n_parts, job.n_elem,
                          static_cast<float *>(job.out));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Windows a CTA owns for a training batch (the grid is ceil(batch / bb)).
int dg_train_block_rows(int batch, int units) {
  return TrainBlockRows(batch, units);
}

// Each launcher returns cudaGetLastError() after its launches (0 = all
// launched).  `masks` may be null (no dropout: scale 1).
int dg_gru_train_fwd(const void *codes, int batch, int steps,
                     const void *masks, const void *kernel, const void *bias,
                     const void *recurrent, int units, int bb, void *avg,
                     void *hidden, void *hseq, void *stream) {
  return LaunchFwd<3>(codes, batch, steps, masks, kernel, bias, recurrent,
                      units, bb, avg, hidden, hseq, nullptr, stream);
}

int dg_lstm_train_fwd(const void *codes, int batch, int steps,
                      const void *masks, const void *kernel,
                      const void *bias, const void *recurrent, int units,
                      int bb, void *avg, void *hidden, void *hseq,
                      void *cseq, void *stream) {
  return LaunchFwd<4>(codes, batch, steps, masks, kernel, bias, recurrent,
                      units, bb, avg, hidden, hseq, cseq, stream);
}

// part_w [n_cta*bb, 5, g*u], part_b [n_cta*bb, bias rows, g*u] and
// part_u [n_cta, u, g*u] are scratch the caller allocates.
int dg_gru_train_bwd(const void *codes, int batch, int steps,
                     const void *masks, const void *kernel, const void *bias,
                     const void *recurrent, int units, int bb,
                     const void *hseq, const void *d_avg,
                     const void *d_hidden, void *part_w, void *part_b,
                     void *part_u, void *d_kernel, void *d_bias,
                     void *d_recurrent, void *stream) {
  return LaunchBwd<3>(codes, batch, steps, masks, kernel, bias, recurrent,
                      units, bb, hseq, nullptr, d_avg, d_hidden, part_w,
                      part_b, part_u, d_kernel, d_bias, d_recurrent, stream);
}

int dg_lstm_train_bwd(const void *codes, int batch, int steps,
                      const void *masks, const void *kernel,
                      const void *bias, const void *recurrent, int units,
                      int bb, const void *hseq, const void *cseq,
                      const void *d_avg, const void *d_hidden, void *part_w,
                      void *part_b, void *part_u, void *d_kernel,
                      void *d_bias, void *d_recurrent, void *stream) {
  return LaunchBwd<4>(codes, batch, steps, masks, kernel, bias, recurrent,
                      units, bb, hseq, cseq, d_avg, d_hidden, part_w, part_b,
                      part_u, d_kernel, d_bias, d_recurrent, stream);
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
