// Training forward and backward of the fused forward + reverse-complement
// GRU / LSTM recurrence with branch averaging, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package
// (deepgrp_tpu/models/pallas_rnn_train.py):
//   * dg_gru_train_fwd       <- :97  _gru_train_fwd_kernel  (_fwd_call :252)
//   * dg_gru_bwd_recurrence  <- :135 _gru_train_bwd_kernel  (_bwd_call :328,
//     + dg_train_reduce         custom VJP pallas_gru_avg_train :422-474)
//   * dg_lstm_train_fwd      <- :496 _lstm_train_fwd_kernel
//                               (_lstm_fwd_call :638)
//   * dg_lstm_bwd_recurrence <- :542 _lstm_train_bwd_kernel (_lstm_bwd_call
//     + dg_train_reduce         :715, custom VJP pallas_lstm_avg_train
//                               :806-855)
// up to u=1024 (kMaxUnits); the caller (models/cuda_rnn.py) sends u=512
// and past to rnn_grid.cu's grid tile, whose cotangents dg_train_reduce
// sums too.
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
//   dU = sum h_prev^T d_rp, db = sums of d_xp (and d_rp), and
//   dW[c] = sum over rows with code c of mask_c * d_xp (LSTM: d_rp = d_xp
//   = da).
// The gates are recomputed from h_prev (and c_prev), as on the TPU: only
// hseq (cseq) goes through device memory.
//
// Bound on this card.  The forward does the inference kernel's multiply-adds
// (2 rows x T x u x g*u a window); the backward about three times as many
// (gate recompute, d_rp U^T, and h_prev^T d_rp).  At the flagship training
// shape (B=256, T=342, u=60) that is 3.8 GFLOP forward against ~42 MB of
// hseq written, so both kernels are bound by float32 arithmetic, not bytes.
// The recurrence is sequential in T, so its parallelism is B x 2 x g*u.
//
// The window tile (every kernel here up to u=128).  The first design's
// block-row tile gave 120 threads a CTA and one CTA an SM at B=256: 3.75
// warps an SM, about one a scheduler, so nothing hid the latency of shared
// loads and dependent FMAs; and its
// backward spent most of each step adding h_prev^T d_rp into the CTA's dU in
// shared memory (u * g u elements a step, one division, a load and a store
// each).  The TPU kernel sums dU inside its body only because its grid is
// sequential and VMEM holds the accumulator; here that sum leaves the step
// loop:
//   * Tile ("window tile"): one CTA a window (its 2 rows), 4u threads (240
//     at u=60); thread tid = 4 i + s owns unit i and k-slice s (the float4
//     quads s, s+4, s+8, ... of the recurrent dot), and its row is s & 1.
//     B=256 gives 256 CTAs, two resident an SM: 16 warps an SM, 4.3x the
//     block-row tile's.  Up to u=64 (kRegUnits) the thread keeps its slice
//     of U (U[k, g u + i] for its 16 k and the g gates: 64 floats LSTM, 48
//     GRU) in registers under the launch bound of 256 threads x 2 CTAs (at
//     most 128 registers a thread); wider layers read that slice through
//     L1/L2.
//   * Forwards (LstmTrainFwdKernel, GruTrainFwdKernel), one barrier a step:
//     each lane forms the g gate dots of both rows over its k-slice (h
//     broadcast as float4 from shared memory), a fixed butterfly of
//     shuffles leaves each lane its own row's g sums, and lanes s < 2 store
//     h (and the LSTM's c) and the branch average.  The GRU forward sums
//     its dots in the order its backward recomputes them (GateDots), so the
//     recomputed gates are the forward's.
//   * Backward recurrences (LstmBwdRecurrenceKernel,
//     GruBwdRecurrenceKernel), two barriers a step: (A) each lane
//     recomputes its row's gates from h_prev as the forward does (GRU: the
//     three gate dots summed over the slices by shuffles, then z, r, hh) and
//     forms the gate cotangents, which it writes to device memory: LSTM
//     lanes s < 2 write da [2B, T, 4u] (168 MB at the flagship shape); GRU
//     lanes s < 2 write d_rp and lanes s >= 2 d_xp, [2B, T, 3u] each
//     (126 MB each); (C1) the lane takes the other row's cotangents (da,
//     d_rp) by a shuffle and stages p[row, k, i] = sum_g d[row, g u + i]
//     U[k, g u + i] for the k of its slice; (C2) thread (row, k) adds
//     p[row, k, :] over the units in a fixed order (four chains) into
//     dh_prev (GRU: the lane adds its dh z) and stages the next step's
//     h_prev.  No dU, dW or db.
//   * Reduction (TrainReduceKernel + SumReducePartsKernel): dU, db and dW
//     as one tiled f32 product over the K = 2B*T rows, split over K, with
//     fixed-order partial sums (see the kernel).  Written for g*u columns
//     and an optional second right-hand matrix: the GRU passes d_rp (dU,
//     recurrent bias) and d_xp (dW, input bias).
//   * Shared memory (WindowSmem): the forwards 4 (4 Pad4(u) + Pad4(5 g u) +
//     10 g) + T bytes (LSTM 6,262 B, GRU 5,022 B at u=60, T=342); the
//     backward recurrences 4 (2 Pad4(u) + Pad4(5 g u) + 2 g 5 + 2u ldp +
//     2u) + T bytes (LSTM 36,022 B, GRU 34,782 B at u=60).  U is not
//     there, so the threads bound the width: 4u <= 512, u <= 128, for both
//     cells (the block-row backward, with U and the CTA's dU in shared
//     memory, stopped at u=82 for LSTM and u=94 for GRU), and then the
//     cluster tile below.  B=256 gives the GRU forward 16 warps an SM,
//     against the block-row tile's 3.75.
//   * No float atomics anywhere: two backward runs are bitwise equal.
//   * All float32 with FMA (the counterpart of Precision.HIGHEST): no TF32,
//     no tensor cores.  Sums run in other orders than the plain versions;
//     the tolerances allow for that.
//   * ptxas -v (sm_90a, CUDA 12.8): LstmTrainFwdKernel 109 registers (U in
//     registers) / 72 (U through L2), GruTrainFwdKernel 94 / 69, no
//     spills; LstmBwdRecurrenceKernel 128 / 86 registers, 16 bytes of
//     spill stores and loads in the register variant, none in the other;
//     GruBwdRecurrenceKernel 128 / 89 registers, 28 bytes of spill stores
//     and loads in the register variant, none in the other;
//     TrainReduceKernel 72 registers, 32,384 B of static shared memory, no
//     spills; SumReducePartsKernel 32.
//   * What bounds them on this card up to u=128: not bytes or FMAs but
//     latency.  The step loop is sequential, and each step waits on
//     shared loads, shuffles and barriers; 16 warps an SM hide part of
//     it.
//
// The cluster tile (129 <= u <= 1024, kMaxUnits of rnn_cluster.cuh; the
// section of that name below): a window's units over a thread-block
// cluster of 4, 8 or 16 CTAs, each owning uc = ceil(u / kCluster) <= 64
// units with all their gates and U's columns, one unit a lane, for 2, 4
// or 8 windows a cluster (TrainFwdClusterKernel,
// BwdRecurrenceClusterKernel<kGates, kWin, kCluster>).  The forward is
// the f32 inference cluster tile's step (rnn_avg.cu) with the masked
// input row and the hseq (cseq) stores; the backward's (A) recomputes
// the gates with the forward's ClusterDots and GruGateMath (the forward's
// bits), its (B) reduce-scatters dh_prev's partials through distributed
// shared memory.
//   * The routes (tools/train_tile_sweep.py --routes on an NVIDIA H100
//     80GB HBM3 at its 700 W limit: at u=129, 160, 192, 224, 256, 300,
//     384, 512, 768 and 1023, B=256 and 64 at T=342, B=37 at T=150, B=5
//     at T=23, both cells, masks at rate 0.0928, each tile checked
//     against the plain versions, then timed in turns in one process;
//     PERF.md section 6 has the figures).  No tile was within 1.02x of
//     the fastest at every batch: the grid tile (rnn_grid.cu) won at
//     B=256 from u=224 (the LSTM from 192) and at B=64 from u=512, this
//     tile at B=37 up to u=384 (the LSTM 512) and at B=5 up to 768 (the
//     LSTM 1023).  So
//     each width takes the tile whose largest ratio to the fastest, over
//     both cells and the four batches, is least: this tile from u=129 to
//     511 (at u=129 1.08, u=256 1.25, u=384 1.62; the grid 3.05, 2.02,
//     1.71), the grid from u=512 (1.60 against this tile's 1.69; at
//     u=1023 1.07 against 2.11).  The wide layout that served u=129-256
//     (one CTA a window, 4u threads up to 1,024, every CTA reading all of
//     U from L2 each step) was never the fastest (largest ratio 1.96 at
//     u=129, 3.48 at u=256) and was deleted.
//   * The layout (ClusterLayoutOf), from the same sweep (each kernel's
//     CTAs a cluster with the least largest ratio over the batches; ms at
//     GRU B=256, T=342, 4 / 8 / 16 CTAs, the best windows): the forward 8
//     CTAs up to u=256 (u=129 2.53 / 2.76 / 3.75, u=256 6.46 / 5.25 /
//     5.59), 16 past it (within 1.14 of the best at u=300-512, 8 up to
//     1.32); the backward (recurrence and reduction) 4 CTAs up to u=256
//     (u=129 7.22 / 11.44 / 14.21, u=256 21.06 / 22.04 / 23.72).  Past
//     u=256 the backward keeps the layout it had before the sweep, 8 CTAs
//     and 4 windows up to u=384, 8 past it: 16 CTAs had the least largest
//     ratio there (u=384 1.07 against 8's 1.19, both at B=5) but took
//     1.12 / 1.08x (GRU / LSTM) the 8-CTA layout's time at B=256, u=511,
//     in turns.  The windows a cluster by batch and width are within 1.10
//     (forward) and 1.15 (backward up to u=256) of the best windows at
//     every case.  The CTAs a cluster depend on the
//     width only: the order of dh_prev's sum over the slots does, so a
//     window's bits are the same in any batch.
//   * What bounds it: every cluster streams its CTAs' column slices of U
//     (all of U, 12.6 MB for the GRU at u=1024) from L2 each step, the
//     backward twice (A, B); more windows a cluster cut the stream a row,
//     fewer let more clusters run at once.
//   * ptxas -v (sm_90a): TrainFwdClusterKernel 96 (2 windows), 118 (GRU
//     4, 8), 127 / 144 (LSTM 4 / 8) registers; BwdRecurrenceClusterKernel
//     110 (2 windows), 126-146 (4), 224 / 228 (8) registers; no spills
//     (each layout in rnn_train.log of a build).
//   * Shared memory: the forward's two h buffers 16 kWin Pad4(u) bytes,
//     the backward's h_prev 8 kWin Pad4(u) and the slots 8 kCluster kWin
//     uc bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rnn_cluster.cuh"

namespace {

constexpr int kCodes = 5;  // W rows: A, C, G, T, N; pad (5) selects none
constexpr int kPadCode = 5;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float Sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
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

// ------------------------------------------------- window tile (Hopper)
//
// One CTA owns one window (its forward and reverse-complement rows) for
// all T steps.  Thread tid = 4 i + s owns unit i and k-slice s (the float4
// quads s, s+4, s+8, ... of the recurrent dot): at u=60, 240 threads, and
// at B=256, 256 CTAs, two resident an SM: 16 warps an SM.  Both cells'
// forwards and backward recurrences use it.

constexpr int kLstmGates = 4;
constexpr int kGruGates = 3;
constexpr int kMaxGates = 4;
constexpr int kSlices = 4;  // k-slices a unit (lanes 4i .. 4i+3)
// U's slice stays in registers up to this width (kRegQuads quads x 4 k x g
// gates: 64 floats LSTM, 48 GRU; 256 threads, two CTAs an SM under a
// 128-register cap); wider layers (up to kWindowUnits = 128 units) read it
// from device memory through L2 (U is 4 g u^2 bytes, at most 256 KB).
constexpr int kRegUnits = 64;
constexpr int kRegQuads = kRegUnits / (4 * kSlices);
constexpr int kRegThreads = kSlices * kRegUnits;
constexpr int kWindowUnits = kMaxThreads / kSlices;

// The launch bound of a window kernel's variant: U in registers, or U
// through L1/L2 up to u=128.
constexpr int WindowThreads(bool u_regs) {
  return u_regs ? kRegThreads : kMaxThreads;
}

__host__ __device__ __forceinline__ int Pad4(int n) { return (n + 3) & ~3; }

// Row stride of the transposed product's partials [2][u][ldp] (index i
// last): ldp = 2 mod 4, so that the 32 lanes of a store (8 units x 4
// slices) hit 32 banks and a float2 load of 16 lanes is conflict-free.
__host__ __device__ __forceinline__ int PartStride(int units) {
  return ((units + 1) & ~3) + 2;
}

// The U entries of thread (i, s): U[4 (s + 4 m) + c, g u + i] for quad m of
// the slice, c < 4, gate g (zero past u); from registers or device memory.
template <int kGates, bool kURegs>
struct USlice {
  float reg[kURegs ? kRegQuads : 1][4][kGates];
  const float *recurrent;

  __device__ __forceinline__ float at(int m, int c, int g, int s, int units,
                                      int i) const {
    if constexpr (kURegs) {
      return reg[m][c][g];
    } else {
      const int k = 4 * (s + kSlices * m) + c;
      return k < units
                 ? __ldg(recurrent + k * kGates * units + g * units + i)
                 : 0.0f;
    }
  }
};

template <int kGates, bool kURegs>
__device__ __forceinline__ void LoadUSlice(const float *__restrict__ recurrent,
                                           int units, int i, int s,
                                           USlice<kGates, kURegs> &us) {
  us.recurrent = recurrent;
  if constexpr (kURegs) {
    const int width = kGates * units;
#pragma unroll
    for (int m = 0; m < kRegQuads; ++m) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 4 * (s + kSlices * m) + c;
#pragma unroll
        for (int g = 0; g < kGates; ++g) {
          us.reg[m][c][g] =
              k < units ? recurrent[k * width + g * units + i] : 0.0f;
        }
      }
    }
  }
}

// Quads of slice s (float4 groups of k below Pad4(u)).
__device__ __forceinline__ int SliceQuads(int units, int s) {
  const int quads = Pad4(units) / 4;
  return quads > s ? (quads - s + kSlices - 1) / kSlices : 0;
}

// The recurrent dots h U[:, g u + i] of unit i for row `row` (= s & 1) of
// the lane, summed over the four slices of the unit by a fixed butterfly
// of shuffles (lanes s and s^2 end with the same bits).  `s_h` holds both
// rows' h (row stride Pad4(u), zero past u).
template <int kGates, bool kURegs>
__device__ __forceinline__ void GateDots(const USlice<kGates, kURegs> &us,
                                         const float *s_h, int units, int i,
                                         int s, unsigned lanes,
                                         float (&dot)[kGates]) {
  const int hstride = Pad4(units);
  const float4 *hf = reinterpret_cast<const float4 *>(s_h);
  const float4 *hr = reinterpret_cast<const float4 *>(s_h + hstride);
  float acc_f[kGates] = {}, acc_r[kGates] = {};
  auto quad = [&](int m) {
    const int q = s + kSlices * m;
    const float4 a4 = hf[q], b4 = hr[q];
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        const float w = us.at(m, c, g, s, units, i);
        acc_f[g] = fmaf(a[c], w, acc_f[g]);
        acc_r[g] = fmaf(b[c], w, acc_r[g]);
      }
    }
  };
  const int n_quads = SliceQuads(units, s);
  if constexpr (kURegs) {
#pragma unroll
    for (int m = 0; m < kRegQuads; ++m) {
      if (m < n_quads) quad(m);
    }
  } else {
    for (int m = 0; m < n_quads; ++m) quad(m);
  }
  // (1) xor 1: lane bit 0 picks the row it keeps.
  const bool odd = s & 1;
  float part[kGates];
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    const float send = odd ? acc_f[g] : acc_r[g];
    part[g] = (odd ? acc_r[g] : acc_f[g]) + __shfl_xor_sync(lanes, send, 1);
  }
  if constexpr (kGates == kLstmGates) {
    // (2) xor 2: lane bit 1 picks the gate pair it sums, (3) then the pairs
    // are swapped back, so both lanes of a row hold all four sums.
    const bool high = s & 2;
    float sum[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float send = high ? part[p] : part[2 + p];
      sum[p] =
          (high ? part[2 + p] : part[p]) + __shfl_xor_sync(lanes, send, 2);
    }
    float other[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) other[p] = __shfl_xor_sync(lanes, sum[p], 2);
    dot[0] = high ? other[0] : sum[0];
    dot[1] = high ? other[1] : sum[1];
    dot[2] = high ? sum[0] : other[0];
    dot[3] = high ? sum[1] : other[1];
  } else {
    // (2) xor 2: each gate summed by both lanes of the row (a + b == b + a).
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      dot[g] = part[g] + __shfl_xor_sync(lanes, part[g], 2);
    }
  }
}

// The masked input row of unit i: b_in + mask[g, row, code] W_g[code].
template <int kGates>
__device__ __forceinline__ void InputRow(const float *s_w, const float *m_row,
                                         const float (&b_in)[kGates],
                                         int units, int i, int code,
                                         float (&x)[kGates]) {
  const int width = kGates * units;
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    x[g] = b_in[g];
    if (static_cast<unsigned>(code) < kCodes) {
      x[g] += m_row[g * kCodes + code] * s_w[code * width + g * units + i];
    }
  }
}

// The four LSTM gate preactivations of unit i for the lane's row.
template <bool kURegs>
__device__ __forceinline__ void LstmPreacts(
    const USlice<kLstmGates, kURegs> &us, const float *s_h, const float *s_w,
    const float *s_m, const float (&b_in)[kLstmGates], int units, int i,
    int s, int code, unsigned lanes, float (&pre)[kLstmGates]) {
  float dot[kLstmGates], x[kLstmGates];
  GateDots<kLstmGates, kURegs>(us, s_h, units, i, s, lanes, dot);
  InputRow<kLstmGates>(s_w, s_m + (s & 1) * kLstmGates * kCodes, b_in, units,
                       i, code, x);
#pragma unroll
  for (int g = 0; g < kLstmGates; ++g) pre[g] = x[g] + dot[g];
}

// The cell update of one row from its preactivations; returns h.
__device__ __forceinline__ float LstmCell(const float (&pre)[kLstmGates],
                                          float &c) {
  const float ig = Sigmoid(pre[0]);
  const float fg = Sigmoid(pre[1]);
  const float gg = tanhf(pre[2]);
  const float og = Sigmoid(pre[3]);
  c = fg * c + ig * gg;
  return og * tanhf(c);
}

// The gate cotangents of one row from its recomputed preactivations;
// carries dc back one step.
__device__ __forceinline__ void LstmCellBackward(
    const float (&pre)[kLstmGates], float dht, float c_prev, float &dc,
    float (&da)[kLstmGates]) {
  const float gi = Sigmoid(pre[0]);
  const float gf = Sigmoid(pre[1]);
  const float gg = tanhf(pre[2]);
  const float go = Sigmoid(pre[3]);
  const float c_t = gf * c_prev + gi * gg;
  const float tanh_c = tanhf(c_t);
  const float d_o = dht * tanh_c;
  const float dc_t = dc + dht * go * (1.0f - tanh_c * tanh_c);
  da[0] = (dc_t * gg) * gi * (1.0f - gi);
  da[1] = (dc_t * c_prev) * gf * (1.0f - gf);
  da[2] = (dc_t * gi) * (1.0f - gg * gg);
  da[3] = d_o * go * (1.0f - go);
  dc = dc_t * gf;
}

// Shared memory of the window kernels, in floats (then T bytes of codes):
// h [2 (forward: 2 buffers x 2)][Pad4(u)], W [5][g u] (padded to 4
// floats), masks [2][g*5];
// the backward recurrences also the transposed product's partials
// [2][u][ldp] and dh_prev [2][u].  U is not there: the width is bounded by
// the threads.
size_t WindowSmem(int gates, int units, int steps, bool backward) {
  const size_t width = static_cast<size_t>(gates) * units;
  size_t floats = (backward ? 2 : 4) * static_cast<size_t>(Pad4(units)) +
                  Pad4(kCodes * static_cast<int>(width)) +
                  2 * static_cast<size_t>(gates) * kCodes;
  if (backward) {
    floats += 2 * static_cast<size_t>(units) * PartStride(units) + 2 * units;
  }
  return sizeof(float) * floats + static_cast<size_t>(steps);
}

// Lanes of this thread's warp that exist (the last warp of a CTA of 4u
// threads may be partial); the shuffles name only those.
__device__ __forceinline__ unsigned WarpLanes() {
  const int n = static_cast<int>(blockDim.x) - (threadIdx.x & ~31);
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// Stages W and the window's masks and codes (through StageMasks and
// StageCodes, written for a block of bb windows, at bb=1: folding them into
// this function for one window moved the register allocation of the
// backward recurrences' step loops, whose spills grew from 16 to 24 bytes
// (LSTM) and from 28 to 44 (GRU), and made lstm_train_bwd 14 % slower on
// the H100).
template <int kGates>
__device__ void StageWindow(const int8_t *__restrict__ codes, int batch,
                            int steps, const float *__restrict__ masks,
                            const float *__restrict__ kernel, int units,
                            int window, float *s_w, float *s_m,
                            int8_t *s_codes) {
  const int width = kGates * units;
  for (int e = threadIdx.x; e < kCodes * width; e += blockDim.x) {
    s_w[e] = kernel[e];
  }
  StageMasks<kGates>(masks, batch, window, 1, s_m);
  StageCodes(codes, batch, steps, window, 1, s_codes);
}

template <bool kURegs>
__global__ void __launch_bounds__(WindowThreads(kURegs), kURegs ? 2 : 1)
LstmTrainFwdKernel(const int8_t *__restrict__ codes, int batch, int steps,
                   const float *__restrict__ masks,
                   const float *__restrict__ kernel,
                   const float *__restrict__ bias,
                   const float *__restrict__ recurrent, int units,
                   float *__restrict__ avg, float *__restrict__ hidden,
                   float *__restrict__ hseq, float *__restrict__ cseq) {
  extern __shared__ float4 smem4[];
  const int width = kLstmGates * units;
  const int hstride = Pad4(units);
  float *s_h = reinterpret_cast<float *>(smem4);  // [2 buffers][2][hstride]
  float *s_w = s_h + 4 * hstride;                 // [5][width]
  float *s_m = s_w + kCodes * width;              // [2][4*5]
  int8_t *s_codes = reinterpret_cast<int8_t *>(s_m + 2 * kLstmGates * kCodes);

  const int tid = threadIdx.x;
  const int window = blockIdx.x;
  const int i = tid / kSlices, s = tid % kSlices;
  const int row = s & 1;  // 0: forward, 1: reverse complement
  const bool writer = (s & 2) == 0;  // one of the row's two lanes
  for (int e = tid; e < 4 * hstride; e += blockDim.x) s_h[e] = 0.0f;
  StageWindow<kLstmGates>(codes, batch, steps, masks, kernel, units, window,
                          s_w, s_m, s_codes);
  USlice<kLstmGates, kURegs> us;
  LoadUSlice<kLstmGates, kURegs>(recurrent, units, i, s, us);
  const unsigned lanes = WarpLanes();
  float b_in[kLstmGates];
#pragma unroll
  for (int g = 0; g < kLstmGates; ++g) b_in[g] = bias[g * units + i];
  __syncthreads();

  const size_t seq =
      static_cast<size_t>(row ? batch + window : window) * steps * units + i;
  float c = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const float *h_cur = s_h + (t & 1) * 2 * hstride;
    float *h_nxt = s_h + ((t + 1) & 1) * 2 * hstride;
    const int code = row ? Complement(s_codes[steps - 1 - t]) : s_codes[t];
    float pre[kLstmGates];
    LstmPreacts<kURegs>(us, h_cur, s_w, s_m, b_in, units, i, s, code, lanes,
                        pre);
    const float h = LstmCell(pre, c);
    const float h_other = __shfl_xor_sync(lanes, h, 1);
    if (writer) {
      h_nxt[row * hstride + i] = h;
      const size_t at = static_cast<size_t>(t) * units;
      hseq[seq + at] = h;
      cseq[seq + at] = c;
      if (row == 0) {
        const float mean = (h + h_other) * 0.5f;
        avg[(static_cast<size_t>(window) * steps + t) * units + i] = mean;
        if (t == steps - 1) {
          hidden[static_cast<size_t>(window) * units + i] = mean;
        }
      }
    }
    __syncthreads();  // h of step t staged
  }
}

// The GRU's (reset_after=True): the LSTM forward's step with three gates
// and a recurrent bias row; the gate dots are summed in the order
// GruBwdRecurrenceKernel recomputes them.
template <bool kURegs>
__global__ void __launch_bounds__(WindowThreads(kURegs), kURegs ? 2 : 1)
GruTrainFwdKernel(const int8_t *__restrict__ codes, int batch, int steps,
                  const float *__restrict__ masks,
                  const float *__restrict__ kernel,
                  const float *__restrict__ bias,
                  const float *__restrict__ recurrent, int units,
                  float *__restrict__ avg, float *__restrict__ hidden,
                  float *__restrict__ hseq) {
  extern __shared__ float4 smem4[];
  const int width = kGruGates * units;
  const int hstride = Pad4(units);
  float *s_h = reinterpret_cast<float *>(smem4);  // [2 buffers][2][hstride]
  float *s_w = s_h + 4 * hstride;                 // [5][width]
  float *s_m = s_w + kCodes * width;              // [2][3*5]
  int8_t *s_codes = reinterpret_cast<int8_t *>(s_m + 2 * kGruGates * kCodes);

  const int tid = threadIdx.x;
  const int window = blockIdx.x;
  const int i = tid / kSlices, s = tid % kSlices;
  const int row = s & 1;  // 0: forward, 1: reverse complement
  const bool writer = (s & 2) == 0;  // one of the row's two lanes
  for (int e = tid; e < 4 * hstride; e += blockDim.x) s_h[e] = 0.0f;
  StageWindow<kGruGates>(codes, batch, steps, masks, kernel, units, window,
                         s_w, s_m, s_codes);
  USlice<kGruGates, kURegs> us;
  LoadUSlice<kGruGates, kURegs>(recurrent, units, i, s, us);
  const unsigned lanes = WarpLanes();
  float b_in[kGruGates], b_rec[kGruGates];
#pragma unroll
  for (int g = 0; g < kGruGates; ++g) {
    b_in[g] = bias[g * units + i];
    b_rec[g] = bias[width + g * units + i];
  }
  __syncthreads();

  const size_t seq =
      static_cast<size_t>(row ? batch + window : window) * steps * units + i;
  float h = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const float *h_cur = s_h + (t & 1) * 2 * hstride;
    float *h_nxt = s_h + ((t + 1) & 1) * 2 * hstride;
    const int code = row ? Complement(s_codes[steps - 1 - t]) : s_codes[t];
    float dot[kGruGates], x[kGruGates];
    GateDots<kGruGates, kURegs>(us, h_cur, units, i, s, lanes, dot);
    InputRow<kGruGates>(s_w, s_m + row * kGruGates * kCodes, b_in, units, i,
                        code, x);
    const float z = Sigmoid(x[0] + (dot[0] + b_rec[0]));
    const float r = Sigmoid(x[1] + (dot[1] + b_rec[1]));
    const float hh = tanhf(x[2] + r * (dot[2] + b_rec[2]));
    h = z * h + (1.0f - z) * hh;
    const float h_other = __shfl_xor_sync(lanes, h, 1);
    if (writer) {
      h_nxt[row * hstride + i] = h;
      hseq[seq + static_cast<size_t>(t) * units] = h;
      if (row == 0) {
        const float mean = (h + h_other) * 0.5f;
        avg[(static_cast<size_t>(window) * steps + t) * units + i] = mean;
        if (t == steps - 1) {
          hidden[static_cast<size_t>(window) * units + i] = mean;
        }
      }
    }
    __syncthreads();  // h of step t staged
  }
}

// The sequential part of a backward: a reverse loop carrying the state's
// cotangents, which writes the gate cotangents to device memory and sums
// nothing over rows.  Per step: (A) lane (i, s) recomputes the gates of
// unit i for its row from h_prev (and c_prev), as the forward does, and
// forms the row's gate cotangents; (C1) it takes the other row's from lane
// s^1 and writes its slice's parts of dh_prev (StageParts); (C2) thread
// (row, k) adds them over the units in order (SumParts).

// Both rows' values of a per-lane array: the lane's own and, by a shuffle,
// lane s^1's (the other row).
template <int kGates>
__device__ __forceinline__ void BothRows(const float (&mine)[kGates], int row,
                                         unsigned lanes,
                                         float (&fwd)[kGates],
                                         float (&rev)[kGates]) {
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    const float other = __shfl_xor_sync(lanes, mine[g], 1);
    fwd[g] = row ? other : mine[g];
    rev[g] = row ? mine[g] : other;
  }
}

// (C1) The parts of dh_prev of slice s: p[row, k, i] = sum_g d[row, g u + i]
// U[k, g u + i] for the k of the slice, both rows, into s_p [2][u][ldp].
template <int kGates, bool kURegs>
__device__ __forceinline__ void StageParts(const USlice<kGates, kURegs> &us,
                                           const float (&d_f)[kGates],
                                           const float (&d_r)[kGates],
                                           int units, int i, int s, int ldp,
                                           float *s_p) {
  auto parts = [&](int m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kk = 4 * (s + kSlices * m) + c;
      float p_f = 0.0f, p_r = 0.0f;
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        const float w = us.at(m, c, g, s, units, i);
        p_f = fmaf(d_f[g], w, p_f);
        p_r = fmaf(d_r[g], w, p_r);
      }
      if (kk < units) {
        s_p[kk * ldp + i] = p_f;
        s_p[(units + kk) * ldp + i] = p_r;
      }
    }
  };
  const int n_quads = SliceQuads(units, s);
  if constexpr (kURegs) {
#pragma unroll
    for (int m = 0; m < kRegQuads; ++m) {
      if (m < n_quads) parts(m);
    }
  } else {
    for (int m = 0; m < n_quads; ++m) parts(m);
  }
}

// (C2) sum over the units of p[srow, k, :], in order, four chains.
__device__ __forceinline__ float SumParts(const float *s_p, int units,
                                          int ldp, int srow, int k) {
  const float *p1 = s_p + (srow * units + k) * ldp;
  const float2 *p2 = reinterpret_cast<const float2 *>(p1);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int j = 0;
  for (; j + 4 <= units; j += 4) {
    const float2 x = p2[j / 2], y = p2[j / 2 + 1];
    a0 += x.x;
    a1 += x.y;
    a2 += y.x;
    a3 += y.y;
  }
  for (; j < units; ++j) a0 += p1[j];
  return (a0 + a1) + (a2 + a3);
}

// Shared memory of a backward recurrence: h_prev [2][hstride], W [5][width],
// masks [2][g*5], parts [2][u][ldp], dh_prev [2][u], codes [T].
template <int kGates>
struct BwdLayout {
  float *h, *w, *m, *p, *dh;
  int8_t *codes;
  __device__ explicit BwdLayout(float *base, int units) {
    h = base;
    w = h + 2 * Pad4(units);
    m = w + Pad4(kCodes * kGates * units);  // keeps p 8-byte aligned
    p = m + 2 * kGates * kCodes;
    dh = p + 2 * units * PartStride(units);
    codes = reinterpret_cast<int8_t *>(dh + 2 * units);
  }
};

// The LSTM's: carries (dh, dc); writes da [2B, T, 4u].
template <bool kURegs>
__global__ void __launch_bounds__(kURegs ? kRegThreads : kMaxThreads,
                                  kURegs ? 2 : 1)
LstmBwdRecurrenceKernel(const int8_t *__restrict__ codes, int batch,
                        int steps, const float *__restrict__ masks,
                        const float *__restrict__ kernel,
                        const float *__restrict__ bias,
                        const float *__restrict__ recurrent, int units,
                        const float *__restrict__ hseq,
                        const float *__restrict__ cseq,
                        const float *__restrict__ d_avg,
                        const float *__restrict__ d_hidden,
                        float *__restrict__ da) {
  extern __shared__ float4 smem4[];
  const int width = kLstmGates * units;
  const int hstride = Pad4(units);
  const int ldp = PartStride(units);
  const BwdLayout<kLstmGates> sm(reinterpret_cast<float *>(smem4), units);

  const int tid = threadIdx.x;
  const int window = blockIdx.x;
  const int i = tid / kSlices, s = tid % kSlices;
  const int row = s & 1;
  const bool writer = (s & 2) == 0;
  // (C2) and the staging of h_prev: thread (srow, k) for tid < 2u.
  const bool stager = tid < 2 * units;
  const int srow = tid / units, k = tid - srow * units;
  const size_t row_base =
      static_cast<size_t>(row ? batch + window : window) * steps;
  const size_t stage_base =
      static_cast<size_t>(srow ? batch + window : window) * steps * units + k;
  auto h_at = [&](int step) {  // hseq of (srow, k) at `step`, zero before 0
    return (stager && step >= 0)
               ? hseq[stage_base + static_cast<size_t>(step) * units]
               : 0.0f;
  };
  auto c_at = [&](int step) {  // cseq of (row, i) at `step`
    return step >= 0 ? cseq[(row_base + step) * units + i] : 0.0f;
  };
  auto half_avg_at = [&](int step) {
    return d_avg[(static_cast<size_t>(window) * steps + step) * units + i] *
           0.5f;
  };
  for (int e = tid; e < 2 * hstride; e += blockDim.x) {
    if (e % hstride >= units) sm.h[e] = 0.0f;
  }
  if (stager) sm.h[srow * hstride + k] = h_at(steps - 2);  // h_prev of T-1
  StageWindow<kLstmGates>(codes, batch, steps, masks, kernel, units, window,
                          sm.w, sm.m, sm.codes);
  USlice<kLstmGates, kURegs> us;
  LoadUSlice<kLstmGates, kURegs>(recurrent, units, i, s, us);
  const unsigned lanes = WarpLanes();
  float b_in[kLstmGates];
#pragma unroll
  for (int g = 0; g < kLstmGates; ++g) b_in[g] = bias[g * units + i];
  __syncthreads();

  // Values of the coming step, loaded one step ahead: c_prev and davg/2
  // of the lane's (row, i), and the h_prev that (C2) stages for the step
  // after it.
  const float half_hid =
      d_hidden[static_cast<size_t>(window) * units + i] * 0.5f;
  float nx_c = c_at(steps - 2), nx_da = half_avg_at(steps - 1);
  float nx_h = h_at(steps - 3);
  float dc = 0.0f;

  for (int t = steps - 1; t >= 0; --t) {
    // (A) preactivations and da of the lane's row.
    const int code = row ? Complement(sm.codes[steps - 1 - t])
                         : sm.codes[t];
    float pre[kLstmGates];
    LstmPreacts<kURegs>(us, sm.h, sm.w, sm.m, b_in, units, i, s, code, lanes,
                        pre);
    const float dh = t < steps - 1 ? sm.dh[row * units + i] : half_hid;
    float d_a[kLstmGates];
    LstmCellBackward(pre, dh + nx_da, nx_c, dc, d_a);
    if (writer) {
      float *out = da + (row_base + t) * width + i;
#pragma unroll
      for (int g = 0; g < kLstmGates; ++g) out[g * units] = d_a[g];
    }
    if (t > 0) {
      nx_c = c_at(t - 2);
      nx_da = half_avg_at(t - 1);
    }

    // (C1) both rows' da of unit i, then this slice's parts of dh_prev.
    float da_f[kLstmGates], da_r[kLstmGates];
    BothRows<kLstmGates>(d_a, row, lanes, da_f, da_r);
    StageParts<kLstmGates, kURegs>(us, da_f, da_r, units, i, s, ldp, sm.p);
    __syncthreads();  // (1) parts staged; every read of h_prev done

    // (C2) dh_prev[srow, k]; stage the next step's h_prev.
    if (stager) {
      sm.dh[srow * units + k] = SumParts(sm.p, units, ldp, srow, k);
      sm.h[srow * hstride + k] = nx_h;
      nx_h = h_at(t - 3);
    }
    __syncthreads();  // (2) dh_prev and h_prev staged
  }
}

// The GRU's: carries dh (dh_prev = dh z + d_rp U^T, the first term in the
// lane's registers); writes d_rp = [da_z, da_r, da_h r] (the cotangent of
// the recurrent preactivations) and d_xp = [da_z, da_r, da_h] (of the
// input preactivations), [2B, T, 3u] each: lane s < 2 of a row writes
// d_rp, lane s >= 2 d_xp.
template <bool kURegs>
__global__ void __launch_bounds__(kURegs ? kRegThreads : kMaxThreads,
                                  kURegs ? 2 : 1)
GruBwdRecurrenceKernel(const int8_t *__restrict__ codes, int batch,
                       int steps, const float *__restrict__ masks,
                       const float *__restrict__ kernel,
                       const float *__restrict__ bias,
                       const float *__restrict__ recurrent, int units,
                       const float *__restrict__ hseq,
                       const float *__restrict__ d_avg,
                       const float *__restrict__ d_hidden,
                       float *__restrict__ d_rp, float *__restrict__ d_xp) {
  extern __shared__ float4 smem4[];
  const int width = kGruGates * units;
  const int hstride = Pad4(units);
  const int ldp = PartStride(units);
  const BwdLayout<kGruGates> sm(reinterpret_cast<float *>(smem4), units);

  const int tid = threadIdx.x;
  const int window = blockIdx.x;
  const int i = tid / kSlices, s = tid % kSlices;
  const int row = s & 1;
  const bool rp_writer = (s & 2) == 0;
  const bool stager = tid < 2 * units;
  const int srow = tid / units, k = tid - srow * units;
  const size_t row_base =
      static_cast<size_t>(row ? batch + window : window) * steps;
  const size_t stage_base =
      static_cast<size_t>(srow ? batch + window : window) * steps * units + k;
  auto h_at = [&](int step) {
    return (stager && step >= 0)
               ? hseq[stage_base + static_cast<size_t>(step) * units]
               : 0.0f;
  };
  auto half_avg_at = [&](int step) {
    return d_avg[(static_cast<size_t>(window) * steps + step) * units + i] *
           0.5f;
  };
  for (int e = tid; e < 2 * hstride; e += blockDim.x) {
    if (e % hstride >= units) sm.h[e] = 0.0f;
  }
  if (stager) sm.h[srow * hstride + k] = h_at(steps - 2);
  StageWindow<kGruGates>(codes, batch, steps, masks, kernel, units, window,
                         sm.w, sm.m, sm.codes);
  USlice<kGruGates, kURegs> us;
  LoadUSlice<kGruGates, kURegs>(recurrent, units, i, s, us);
  const unsigned lanes = WarpLanes();
  float b_in[kGruGates], b_rec[kGruGates];
#pragma unroll
  for (int g = 0; g < kGruGates; ++g) {
    b_in[g] = bias[g * units + i];
    b_rec[g] = bias[width + g * units + i];
  }
  __syncthreads();

  const float half_hid =
      d_hidden[static_cast<size_t>(window) * units + i] * 0.5f;
  float nx_da = half_avg_at(steps - 1);
  float nx_h = h_at(steps - 3);
  float keep = 0.0f;  // dh z of the step after this one

  for (int t = steps - 1; t >= 0; --t) {
    // (A) gates and cotangents of the lane's row.
    const int code = row ? Complement(sm.codes[steps - 1 - t])
                         : sm.codes[t];
    float dot[kGruGates], x[kGruGates];
    GateDots<kGruGates, kURegs>(us, sm.h, units, i, s, lanes, dot);
    InputRow<kGruGates>(sm.w, sm.m + row * kGruGates * kCodes, b_in, units,
                        i, code, x);
    const float z = Sigmoid(x[0] + (dot[0] + b_rec[0]));
    const float r = Sigmoid(x[1] + (dot[1] + b_rec[1]));
    const float rh = dot[2] + b_rec[2];
    const float hh = tanhf(x[2] + r * rh);
    const float h_prev = sm.h[row * hstride + i];
    const float dh = t < steps - 1 ? keep + sm.dh[row * units + i] : half_hid;
    const float dht = dh + nx_da;
    const float da_z = dht * (h_prev - hh) * z * (1.0f - z);
    const float da_h = dht * (1.0f - z) * (1.0f - hh * hh);
    const float da_r = (da_h * rh) * r * (1.0f - r);
    keep = dht * z;
    const float drp[kGruGates] = {da_z, da_r, da_h * r};
    {
      float *out = (rp_writer ? d_rp : d_xp) + (row_base + t) * width + i;
      out[0] = da_z;
      out[units] = da_r;
      out[2 * units] = rp_writer ? drp[2] : da_h;
    }
    if (t > 0) nx_da = half_avg_at(t - 1);

    // (C1) both rows' d_rp of unit i, then this slice's parts of dh_prev.
    float drp_f[kGruGates], drp_r[kGruGates];
    BothRows<kGruGates>(drp, row, lanes, drp_f, drp_r);
    StageParts<kGruGates, kURegs>(us, drp_f, drp_r, units, i, s, ldp, sm.p);
    __syncthreads();  // (1) parts staged; every read of h_prev done

    // (C2) the d_rp U^T part of dh_prev[srow, k]; the next step's h_prev.
    if (stager) {
      sm.dh[srow * units + k] = SumParts(sm.p, units, ldp, srow, k);
      sm.h[srow * hstride + k] = nx_h;
      nx_h = h_at(t - 3);
    }
    __syncthreads();  // (2) dh_prev and h_prev staged
  }
}

// --------------------------- the cluster tile (129 <= u <= 1024)
//
// Past kWindowUnits a window's units split over a thread-block cluster of
// kCluster CTAs, as the float32 inference tile does (AvgClusterKernel in
// rnn_avg.cu): the CTA of rank r owns units [r uc, (r + 1) uc), uc =
// ceil(u / kCluster) <= 64, with all their gates and all k of their
// columns of U (read through L1/L2), for the kWin windows of the cluster
// (one lane group of 4 uc threads; lane (i, s) owns unit base + i and
// k-slice s).  Each CTA keeps a full copy of h per row.  The forward's
// step: ClusterDots (the quads of the slice, then the butterfly) leaves
// each lane the whole gate sums of the rows it owns, it does their gate
// math on the masked input row, stores hseq (cseq), avg and hidden, and
// writes the unit's new h into every CTA's next buffer through
// distributed shared memory; one cluster barrier a step.  The backward's
// step: (A) the same ClusterDots over h_prev (each CTA reads the rows from
// hseq into shared memory, cp.async, one step ahead; no exchange), the
// gate cotangents of the owned units, written to device memory as the
// window tile writes them and staged as d [2 kWin][g uc] (the columns the
// CTA owns); (B) dh_prev as a reduce-scatter: the CTA forms p_r[row, k] =
// sum over its columns j of d[row, j] U[k, j] for every k (the same
// column slice of U that (A) read) and writes peer q the partials of q's
// units into its slot r (double-buffered); after the cluster barrier the
// owner of (row, k) adds the kCluster slots in rank order (then the GRU's
// dh z, then d_avg / 2).  u floats a row cross the cluster, not the g u
// of an all-gather of the cotangents, whose double buffer would not fit
// (256 kB for the LSTM at u=1024 and 4 windows).  One __syncthreads and
// one cluster barrier a step.

constexpr int kClusterUnits = 64;  // most units a CTA of a cluster owns
constexpr int kClusterThreads = kSlices * kClusterUnits;
constexpr int kPartialKs = 4;  // rows k of U a pass of (B) takes

// Shared memory of a cluster kernel, as float offsets from a 16-byte
// aligned base: h [2 (forward: 2 buffers x 2)][kWin][Pad4(u)]; the
// backward's d [2 kWin][Pad4(g uc)], the column of U of each of those
// columns (ints) and the slots [2][kCluster][2 kWin][uc]; then W's columns
// [5][g uc] and the masks [2 kWin][g * 5] (StageMasks' order).
struct ClusterLayout {
  int uc, cols, hstride, dstride;
  size_t d, col, slots, w, m, end;
  __host__ __device__ ClusterLayout(int gates, int units, int win,
                                    int cluster, bool backward) {
    uc = (units + cluster - 1) / cluster;
    cols = gates * uc;
    hstride = Pad4(units);
    dstride = Pad4(cols);
    const size_t rows = 2 * static_cast<size_t>(win);
    d = (backward ? 1 : 2) * rows * hstride;
    col = d + (backward ? rows * dstride : 0);
    slots = col + (backward ? dstride : 0);
    w = slots + (backward ? 2 * cluster * rows * uc : 0);
    m = w + static_cast<size_t>(kCodes) * cols;
    end = m + rows * gates * kCodes;
  }
  size_t bytes() const { return sizeof(float) * end; }
};

// The CTA's columns of W: s_w[c][g uc + n] = W[c, g u + base + n], zero
// past u.
template <int kGates>
__device__ void StageClusterWeights(const float *__restrict__ kernel,
                                    int units, int uc, int base,
                                    float *s_w) {
  const int cols = kGates * uc;
  for (int j = threadIdx.x; j < kCodes * cols; j += blockDim.x) {
    const int c = j / cols, o = j - c * cols;
    const int g = o / uc, n = base + o - g * uc;
    s_w[j] = n < units ? kernel[c * kGates * units + g * units + n] : 0.0f;
  }
}

// The code of window `row`'s branch b at step t, through L1 (pad past the
// batch).
__device__ __forceinline__ int ClusterCode(const int8_t *__restrict__ codes,
                                           bool in_batch, int row,
                                           int steps, int t, int b) {
  if (!in_batch) return kPadCode;
  const int8_t *w_codes = codes + static_cast<size_t>(row) * steps;
  return b ? Complement(w_codes[steps - 1 - t]) : w_codes[t];
}

// The butterfly of a cluster tile: sums acc over the four lanes of a unit
// (their k-slices) and leaves lane s the rows of the windows it owns
// (OwnWindow), in an order fixed by the slices: (s0 + s1) + (s2 + s3).
template <int kWin, int kN>
__device__ __forceinline__ void FoldOwn(const float (&acc)[kWin][2][kN],
                                        int s, unsigned lanes,
                                        float (&out)[OwnWindows(kWin)][2][kN]) {
  if constexpr (kWin >= 4) {
    float half[kWin / 2][2][kN];
    FoldWindows<kWin, kN>(acc, s & 1, 1, lanes, half);
    FoldWindows<kWin / 2, kN>(half, (s >> 1) & 1, 2, lanes, out);
  } else {
    FoldWindows<kWin, kN>(acc, s & 1, 1, lanes, out);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int g = 0; g < kN; ++g) {
        out[0][b][g] += __shfl_xor_sync(lanes, out[0][b][g], 2);
      }
    }
  }
}

// The recurrent dots of the lane's rows: lane (i, s) sums the quads s,
// s+4, ... of k of column u_col of each gate of U (through L1/L2) against
// the 2 kWin rows of h in s_h [2 kWin][Pad4(u)] (row 2w + b), each in the
// order of the window tile's GateDots, then FoldOwn.  The forward and the
// backward's gate recompute both call it: the recomputed gates are the
// forward's bits.
template <int kGates, int kWin>
__device__ __forceinline__ void ClusterDots(
    const float *__restrict__ recurrent, const float *s_h, int units,
    int u_col, int s, unsigned lanes,
    float (&dot)[OwnWindows(kWin)][2][kGates]) {
  const int hstride = Pad4(units);
  const int width = kGates * units;
  float acc[kWin][2][kGates] = {};
  const int n_quads = SliceQuads(units, s);
  for (int m = 0; m < n_quads; ++m) {
    const int q = s + kSlices * m;
    float u_q[4][kGates];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = 4 * q + c;
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        u_q[c][g] = k < units
                        ? __ldg(recurrent + k * width + g * units + u_col)
                        : 0.0f;
      }
    }
#pragma unroll
    for (int w = 0; w < kWin; ++w) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float4 h4 =
            reinterpret_cast<const float4 *>(s_h + (2 * w + b) * hstride)[q];
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int g = 0; g < kGates; ++g) {
            acc[w][b][g] = fmaf(hv[c], u_q[c][g], acc[w][b][g]);
          }
        }
      }
    }
  }
  FoldOwn<kWin, kGates>(acc, s, lanes, dot);
}

// The GRU's gates from a row's input row and recurrent dots (the window
// tile's arithmetic); both cluster kernels call it.
struct GruGates {
  float z, r, rh, hh;
};
__device__ __forceinline__ GruGates GruGateMath(
    const float (&x)[kGruGates], const float (&dot)[kGruGates],
    const float (&b_rec)[kGruGates]) {
  GruGates o;
  o.z = Sigmoid(x[0] + (dot[0] + b_rec[0]));
  o.r = Sigmoid(x[1] + (dot[1] + b_rec[1]));
  o.rh = dot[2] + b_rec[2];
  o.hh = tanhf(x[2] + o.r * o.rh);
  return o;
}

// The biases of unit u_col: the input row and, for the GRU, the recurrent
// row.
template <int kGates>
__device__ __forceinline__ void ClusterBiases(const float *__restrict__ bias,
                                              int units, int u_col,
                                              float (&b_in)[kGates],
                                              float (&b_rec)[kGates]) {
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    b_in[g] = bias[g * units + u_col];
    b_rec[g] = kGates == kGruGates ? bias[kGates * units + g * units + u_col]
                                   : 0.0f;
  }
}

// The training forward of either cell on the cluster tile (the note
// above); cseq is the LSTM's (null for the GRU).
template <int kGates, int kWin, int kCluster>
__global__ void __launch_bounds__(kClusterThreads, 1)
TrainFwdClusterKernel(const int8_t *__restrict__ codes, int batch, int steps,
                      const float *__restrict__ masks,
                      const float *__restrict__ kernel,
                      const float *__restrict__ bias,
                      const float *__restrict__ recurrent, int units,
                      float *__restrict__ avg, float *__restrict__ hidden,
                      float *__restrict__ hseq, float *__restrict__ cseq) {
  constexpr int kOwn = OwnWindows(kWin);
  constexpr int kRows = 2 * kWin;
  extern __shared__ float4 smem4[];
  const ClusterLayout lay(kGates, units, kWin, kCluster, false);
  float *s_h = reinterpret_cast<float *>(smem4);  // [2][kRows][hstride]
  float *s_w = s_h + lay.w;
  float *s_m = s_h + lay.m;
  const int uc = lay.uc, hstride = lay.hstride;
  const int base = static_cast<int>(ClusterRank()) * uc;
  const int tid = threadIdx.x;
  const int i = tid / kSlices, s = tid % kSlices;
  const int unit = base + i;
  const int u_col = min(unit, units - 1);  // lanes past u: sums dropped
  const int row0 = blockIdx.x / kCluster * kWin;
  for (int j = tid; j < 2 * kRows * hstride; j += blockDim.x) s_h[j] = 0.0f;
  StageClusterWeights<kGates>(kernel, units, uc, base, s_w);
  StageMasks<kGates>(masks, batch, row0, kWin, s_m);
  float b_in[kGates], b_rec[kGates];
  ClusterBiases<kGates>(bias, units, u_col, b_in, b_rec);
  const unsigned lanes = WarpLanes();
  const bool writer = unit < units && (kWin >= 4 || s < 2);
  float h_own[kOwn][2] = {}, c_own[kOwn][2] = {};
  ClusterBarrier();  // every CTA's h zeroed before a peer writes it

  for (int t = 0; t < steps; ++t) {
    const float *h_cur = s_h + (t & 1) * kRows * hstride;
    float *h_nxt = s_h + ((t + 1) & 1) * kRows * hstride;
    float dot[kOwn][2][kGates];
    ClusterDots<kGates, kWin>(recurrent, h_cur, units, u_col, s, lanes, dot);
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int w = OwnWindow<kWin>(0, s, j), row = row0 + w;
      const bool in_batch = row < batch;
      if (!writer) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int code = ClusterCode(codes, in_batch, row, steps, t, b);
        float x[kGates];
        InputRow<kGates>(s_w, s_m + (b * kWin + w) * kGates * kCodes, b_in,
                         uc, i, code, x);
        float h;
        if constexpr (kGates == kGruGates) {
          const GruGates gg = GruGateMath(x, dot[j][b], b_rec);
          h = gg.z * h_own[j][b] + (1.0f - gg.z) * gg.hh;
        } else {
          float pre[kLstmGates];
#pragma unroll
          for (int g = 0; g < kLstmGates; ++g) pre[g] = x[g] + dot[j][b][g];
          h = LstmCell(pre, c_own[j][b]);
        }
        h_own[j][b] = h;
        const uint32_t at = static_cast<uint32_t>(
            sizeof(float) * ((2 * w + b) * hstride + unit));
#pragma unroll
        for (int p = 0; p < kCluster; ++p) {
          StoreCluster(PeerAddress(h_nxt, p) + at, h);
        }
        if (in_batch) {
          const size_t seq =
              (static_cast<size_t>(b ? batch + row : row) * steps + t) *
                  units + unit;
          hseq[seq] = h;
          if constexpr (kGates == kLstmGates) cseq[seq] = c_own[j][b];
        }
      }
      if (in_batch) {
        const float mean = (h_own[j][0] + h_own[j][1]) * 0.5f;
        avg[(static_cast<size_t>(row) * steps + t) * units + unit] = mean;
        if (t == steps - 1) {
          hidden[static_cast<size_t>(row) * units + unit] = mean;
        }
      }
    }
    ClusterBarrier();  // the new h in every CTA's next buffer
  }
}

// An asynchronous 4-byte copy from device to shared memory (cp.async; the
// thread waits for its copies with CopyAsyncWait).
__device__ __forceinline__ void CopyAsync4(float *dst, const float *src) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void CopyAsyncWait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Row lr (2w + b) of the cluster's h_prev at `step` into s_h [kRows][
// hstride] (zero before step 0 and past the batch), asynchronously.
__device__ __forceinline__ void LoadHPrev(const float *__restrict__ hseq,
                                          int batch, int steps, int units,
                                          int row0, int rows, int step,
                                          float *s_h, bool async) {
  const int hstride = Pad4(units);
  for (int e = threadIdx.x; e < rows * units; e += blockDim.x) {
    const int lr = e / units, k = e - lr * units;
    const int row = row0 + (lr >> 1);
    float *dst = s_h + lr * hstride + k;
    if (row < batch && step >= 0) {
      const float *src =
          hseq + (static_cast<size_t>((lr & 1) ? batch + row : row) * steps +
                  step) * units + k;
      if (async) {
        CopyAsync4(dst, src);
      } else {
        *dst = *src;
      }
    } else {
      *dst = 0.0f;
    }
  }
}

// The backward recurrence of either cell on the cluster tile (the note
// above): writes d_out = d_rp and d_xp (GRU) or d_out = da (LSTM; d_xp
// null), as the window tile's kernels do.
template <int kGates, int kWin, int kCluster>
__global__ void __launch_bounds__(kClusterThreads, 1)
BwdRecurrenceClusterKernel(const int8_t *__restrict__ codes, int batch,
                           int steps, const float *__restrict__ masks,
                           const float *__restrict__ kernel,
                           const float *__restrict__ bias,
                           const float *__restrict__ recurrent, int units,
                           const float *__restrict__ hseq,
                           const float *__restrict__ cseq,
                           const float *__restrict__ d_avg,
                           const float *__restrict__ d_hidden,
                           float *__restrict__ d_out,
                           float *__restrict__ d_xp) {
  constexpr int kOwn = OwnWindows(kWin);
  constexpr int kRows = 2 * kWin;
  extern __shared__ float4 smem4[];
  const ClusterLayout lay(kGates, units, kWin, kCluster, true);
  float *s_h = reinterpret_cast<float *>(smem4);  // [kRows][hstride]
  float *s_d = s_h + lay.d;                       // [kRows][dstride]
  int *s_col = reinterpret_cast<int *>(s_h + lay.col);  // [dstride]
  float *s_slot = s_h + lay.slots;  // [2][kCluster][kRows][uc]
  float *s_w = s_h + lay.w;
  float *s_m = s_h + lay.m;
  const int uc = lay.uc, cols = lay.cols, hstride = lay.hstride;
  const int dstride = lay.dstride;
  const int slot_buf = kCluster * kRows * uc;  // floats a slot buffer
  const unsigned rank = ClusterRank();
  const int base = static_cast<int>(rank) * uc;
  const int width = kGates * units;
  const int tid = threadIdx.x;
  const int i = tid / kSlices, s = tid % kSlices;
  const int unit = base + i;
  const int u_col = min(unit, units - 1);
  const int row0 = blockIdx.x / kCluster * kWin;

  for (int j = tid; j < kRows * hstride; j += blockDim.x) s_h[j] = 0.0f;
  for (int j = tid; j < kRows * dstride; j += blockDim.x) s_d[j] = 0.0f;
  // The column of U of each of the CTA's columns of d (a valid one where
  // d is zero: past u and the pads).
  for (int o = tid; o < dstride; o += blockDim.x) {
    const int g = o / uc, n = base + o - g * uc;
    s_col[o] = o < cols && n < units ? g * units + n : 0;
  }
  StageClusterWeights<kGates>(kernel, units, uc, base, s_w);
  StageMasks<kGates>(masks, batch, row0, kWin, s_m);
  __syncthreads();  // zeroed before the rows of h_prev land
  LoadHPrev(hseq, batch, steps, units, row0, kRows, steps - 2, s_h, false);
  float b_in[kGates], b_rec[kGates];
  ClusterBiases<kGates>(bias, units, u_col, b_in, b_rec);
  const unsigned lanes = WarpLanes();
  const bool writer = unit < units && (kWin >= 4 || s < 2);
  const bool p_writer = kWin >= 4 || s < 2;

  // Per owned window: dhid / 2, and one step ahead d_avg / 2 and c_prev.
  float half_hid[kOwn], nx_da[kOwn], nx_c[kOwn][2];
  float dc[kOwn][2] = {}, keep[kOwn][2] = {};
  auto c_at = [&](int row, int b, int step) {
    return step >= 0 ? cseq[(static_cast<size_t>(b ? batch + row : row) *
                                 steps + step) * units + unit]
                     : 0.0f;
  };
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int row = row0 + OwnWindow<kWin>(0, s, j);
    const bool live = writer && row < batch;
    half_hid[j] =
        live ? d_hidden[static_cast<size_t>(row) * units + unit] * 0.5f
             : 0.0f;
    nx_da[j] = live ? d_avg[(static_cast<size_t>(row) * steps + steps - 1) *
                                units + unit] * 0.5f
                    : 0.0f;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      nx_c[j][b] = kGates == kLstmGates && live ? c_at(row, b, steps - 2)
                                                : 0.0f;
    }
  }
  ClusterBarrier();  // h_prev staged; every CTA started before (B) writes

  for (int t = steps - 1; t >= 0; --t) {
    // (A) the owned rows' gates from h_prev and their cotangents.
    float dot[kOwn][2][kGates];
    ClusterDots<kGates, kWin>(recurrent, s_h, units, u_col, s, lanes, dot);
    const float *slot_cur = s_slot + (t & 1) * slot_buf;
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int w = OwnWindow<kWin>(0, s, j), row = row0 + w;
      const bool in_batch = row < batch;
      if (!writer) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int lr = 2 * w + b;
        const int code = ClusterCode(codes, in_batch, row, steps, t, b);
        float x[kGates];
        InputRow<kGates>(s_w, s_m + (b * kWin + w) * kGates * kCodes, b_in,
                         uc, i, code, x);
        float dh = half_hid[j];
        if (t < steps - 1) {  // the slots of dh_prev, in rank order
          float sum = slot_cur[lr * uc + i];
#pragma unroll
          for (int p = 1; p < kCluster; ++p) {
            sum += slot_cur[(p * kRows + lr) * uc + i];
          }
          dh = kGates == kGruGates ? keep[j][b] + sum : sum;
        }
        const float dht = dh + nx_da[j];
        float d_r[kGates];  // of the recurrent preactivations
        const size_t out =
            (static_cast<size_t>(b ? batch + row : row) * steps + t) * width +
            unit;
        if constexpr (kGates == kGruGates) {
          const GruGates gg = GruGateMath(x, dot[j][b], b_rec);
          const float h_prev = s_h[lr * hstride + unit];
          const float da_z = dht * (h_prev - gg.hh) * gg.z * (1.0f - gg.z);
          const float da_h = dht * (1.0f - gg.z) * (1.0f - gg.hh * gg.hh);
          const float da_r = (da_h * gg.rh) * gg.r * (1.0f - gg.r);
          keep[j][b] = dht * gg.z;
          d_r[0] = da_z;
          d_r[1] = da_r;
          d_r[2] = da_h * gg.r;
          if (in_batch) {
            d_xp[out] = da_z;
            d_xp[out + units] = da_r;
            d_xp[out + 2 * units] = da_h;
          }
        } else {
          float pre[kLstmGates];
#pragma unroll
          for (int g = 0; g < kLstmGates; ++g) pre[g] = x[g] + dot[j][b][g];
          LstmCellBackward(pre, dht, nx_c[j][b], dc[j][b], d_r);
        }
#pragma unroll
        for (int g = 0; g < kGates; ++g) {
          if (in_batch) d_out[out + g * units] = d_r[g];
          s_d[lr * dstride + g * uc + i] = in_batch ? d_r[g] : 0.0f;
        }
      }
      if (t > 0 && in_batch) {
        nx_da[j] = d_avg[(static_cast<size_t>(row) * steps + t - 1) * units +
                         unit] * 0.5f;
        if constexpr (kGates == kLstmGates) {
#pragma unroll
          for (int b = 0; b < 2; ++b) nx_c[j][b] = c_at(row, b, t - 2);
        }
      }
    }
    __syncthreads();  // d staged; every read of h_prev done

    if (t > 0) {
      LoadHPrev(hseq, batch, steps, units, row0, kRows, t - 2, s_h, true);
      // (B) p_r[row, k] for k = q uc + i of each peer q, kPartialKs peers
      // a pass over the CTA's columns (quads s, s+4, ... of the slice).
      const int n_quads = SliceQuads(cols, s);
      const uint32_t slot_at = static_cast<uint32_t>(
          sizeof(float) * (((t - 1) & 1) * slot_buf + rank * kRows * uc + i));
#pragma unroll 1
      for (int q0 = 0; q0 < kCluster; q0 += kPartialKs) {
        const float *u_rows[kPartialKs];
#pragma unroll
        for (int kk = 0; kk < kPartialKs; ++kk) {
          u_rows[kk] = recurrent +
                       min((q0 + kk) * uc + i, units - 1) * width;
        }
        float acc[kPartialKs][kWin][2][1] = {};
        for (int m = 0; m < n_quads; ++m) {
          const int qd = s + kSlices * m;
          const int4 col4 = reinterpret_cast<const int4 *>(s_col)[qd];
          const int col[4] = {col4.x, col4.y, col4.z, col4.w};
          float uv[kPartialKs][4];
#pragma unroll
          for (int kk = 0; kk < kPartialKs; ++kk) {
#pragma unroll
            for (int c = 0; c < 4; ++c) uv[kk][c] = __ldg(u_rows[kk] + col[c]);
          }
#pragma unroll
          for (int w = 0; w < kWin; ++w) {
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const float4 d4 = reinterpret_cast<const float4 *>(
                  s_d + (2 * w + b) * dstride)[qd];
              const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
              for (int kk = 0; kk < kPartialKs; ++kk) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  acc[kk][w][b][0] = fmaf(dv[c], uv[kk][c], acc[kk][w][b][0]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < kPartialKs; ++kk) {
          float p[kOwn][2][1];
          FoldOwn<kWin, 1>(acc[kk], s, lanes, p);
          const int q = q0 + kk;
          if (!p_writer || q * uc + i >= units) continue;
          const uint32_t peer = PeerAddress(s_slot, q) + slot_at;
#pragma unroll
          for (int j = 0; j < kOwn; ++j) {
            const int w = OwnWindow<kWin>(0, s, j);
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              StoreCluster(static_cast<uint32_t>(
                               peer + sizeof(float) * (2 * w + b) * uc),
                           p[j][b][0]);
            }
          }
        }
      }
      CopyAsyncWait();  // the next h_prev landed (the barrier shows it)
    }
    ClusterBarrier();  // slots written, h_prev staged, d read
  }
}

// Launches a layout of the cluster tile's forward (ctas a multiple of
// kCluster, 4 uc threads): the launch's error (0 = launched), or
// cudaErrorInvalidValue past 64 units a CTA.
template <int kGates, int kWin, int kCluster>
int LaunchFwdCluster(const void *codes, int batch, int steps,
                     const void *masks, const void *kernel, const void *bias,
                     const void *recurrent, int units, void *avg,
                     void *hidden, void *hseq, void *cseq,
                     cudaStream_t stream) {
  const ClusterLayout lay(kGates, units, kWin, kCluster, false);
  if (lay.uc > kClusterUnits) return static_cast<int>(cudaErrorInvalidValue);
  const auto f32 = [](const void *p) { return static_cast<const float *>(p); };
  return static_cast<int>(LaunchCluster(
      TrainFwdClusterKernel<kGates, kWin, kCluster>,
      (batch + kWin - 1) / kWin * kCluster, kSlices * lay.uc, lay.bytes(),
      kCluster, stream, static_cast<const int8_t *>(codes), batch, steps,
      f32(masks), f32(kernel), f32(bias), f32(recurrent), units,
      static_cast<float *>(avg), static_cast<float *>(hidden),
      static_cast<float *>(hseq), static_cast<float *>(cseq)));
}

// The same for the backward recurrence (d_xp: the GRU's, null for LSTM).
template <int kGates, int kWin, int kCluster>
int LaunchBwdCluster(const void *codes, int batch, int steps,
                     const void *masks, const void *kernel, const void *bias,
                     const void *recurrent, int units, const void *hseq,
                     const void *cseq, const void *d_avg,
                     const void *d_hidden, void *d_out, void *d_xp,
                     cudaStream_t stream) {
  const ClusterLayout lay(kGates, units, kWin, kCluster, true);
  if (lay.uc > kClusterUnits) return static_cast<int>(cudaErrorInvalidValue);
  const auto f32 = [](const void *p) { return static_cast<const float *>(p); };
  return static_cast<int>(LaunchCluster(
      BwdRecurrenceClusterKernel<kGates, kWin, kCluster>,
      (batch + kWin - 1) / kWin * kCluster, kSlices * lay.uc, lay.bytes(),
      kCluster, stream, static_cast<const int8_t *>(codes), batch, steps,
      f32(masks), f32(kernel), f32(bias), f32(recurrent), units, f32(hseq),
      f32(cseq), f32(d_avg), f32(d_hidden), static_cast<float *>(d_out),
      static_cast<float *>(d_xp)));
}

// The clusters of a layout the card runs at once (0 if it cannot place
// one), or -1 past 64 units a CTA.
template <int kGates, int kWin, int kCluster, bool kBackward>
int ClusterSlotsOf(int units) {
  const ClusterLayout lay(kGates, units, kWin, kCluster, kBackward);
  if (lay.uc > kClusterUnits) return -1;
  if constexpr (kBackward) {
    return ClusterSlots(BwdRecurrenceClusterKernel<kGates, kWin, kCluster>,
                        kSlices * lay.uc, lay.bytes(), kCluster);
  } else {
    return ClusterSlots(TrainFwdClusterKernel<kGates, kWin, kCluster>,
                        kSlices * lay.uc, lay.bytes(), kCluster);
  }
}

// The cluster tile's layout of a kernel at a width and batch: CTAs a
// cluster and windows a cluster, from tools/train_tile_sweep.py --routes
// on the H100 (the note at the top).  The forward: 8 CTAs up to u=256,
// 16 past it; 2 windows a cluster below B=64, 4 below B=256 or up to
// u=192, else 8.  The backward: 4 CTAs up to u=256, 2 windows below
// B=64, else 4; past u=256 the layout it had before the sweep, 8 CTAs
// and 4 windows up to u=384, 8 past it, fewer where the batch holds at
// most half of them (16 CTAs lost 1.08-1.12x at B=256, u=511).  CTAs a
// cluster depend on the width only, so a window's bits do not depend on
// its batch.
struct TrainCluster {
  int cluster, windows;
};
constexpr int kNarrowClusterUnits = 256;  // the forward's 8, backward's 4
TrainCluster ClusterLayoutOf(bool backward, int units, int batch) {
  const bool narrow = units <= kNarrowClusterUnits;
  if (backward && narrow) return {4, batch < 64 ? 2 : 4};
  if (backward) {
    int windows = units <= 384 ? 4 : 8;
    while (windows > 2 && batch <= windows / 2) windows /= 2;
    return {8, windows};
  }
  return {narrow ? 8 : 16,
          batch < 64 ? 2 : batch < 256 || units <= 192 ? 4 : 8};
}

template <int kValue>
using Int = std::integral_constant<int, kValue>;

// op(Int<kWin>{}, Int<kCluster>{}) in the layout ClusterLayoutOf picks
// (the backward's 4 CTAs only in 2 or 4 windows, so only those are
// compiled).
template <bool kBackward, typename Op>
int InClusterLayout(int units, int batch, Op op) {
  const TrainCluster lay = ClusterLayoutOf(kBackward, units, batch);
  const auto in = [&](auto cluster) {
    if (lay.windows == 2) return op(Int<2>{}, cluster);
    if (lay.windows == 4) return op(Int<4>{}, cluster);
    return op(Int<8>{}, cluster);
  };
  if constexpr (kBackward) {
    if (lay.cluster == 8) return in(Int<8>{});
    return lay.windows == 2 ? op(Int<2>{}, Int<4>{}) : op(Int<4>{}, Int<4>{});
  } else {
    if (lay.cluster == 8) return in(Int<8>{});
    return in(Int<16>{});
  }
}

// The training forward on the cluster tile, in the layout ClusterLayoutOf
// picks.
template <int kGates>
int FwdCluster(const void *codes, int batch, int steps, const void *masks,
               const void *kernel, const void *bias, const void *recurrent,
               int units, void *avg, void *hidden, void *hseq, void *cseq,
               cudaStream_t stream) {
  return InClusterLayout<false>(units, batch, [&](auto win, auto cluster) {
    return LaunchFwdCluster<kGates, decltype(win)::value,
                            decltype(cluster)::value>(
        codes, batch, steps, masks, kernel, bias, recurrent, units, avg,
        hidden, hseq, cseq, stream);
  });
}

// The backward recurrence on the cluster tile, likewise.
template <int kGates>
int BwdCluster(const void *codes, int batch, int steps, const void *masks,
               const void *kernel, const void *bias, const void *recurrent,
               int units, const void *hseq, const void *cseq,
               const void *d_avg, const void *d_hidden, void *d_out,
               void *d_xp, cudaStream_t stream) {
  return InClusterLayout<true>(units, batch, [&](auto win, auto cluster) {
    return LaunchBwdCluster<kGates, decltype(win)::value,
                            decltype(cluster)::value>(
        codes, batch, steps, masks, kernel, bias, recurrent, units, hseq,
        cseq, d_avg, d_hidden, d_out, d_xp, stream);
  });
}

// The clusters at once of the layout ClusterLayoutOf picks.
template <int kGates, bool kBackward>
int ClusterSlotsAt(int units, int batch) {
  return InClusterLayout<kBackward>(units, batch, [&](auto win, auto cluster) {
    return ClusterSlotsOf<kGates, decltype(win)::value,
                          decltype(cluster)::value, kBackward>(units);
  });
}

// ------------------------------------------- weight-gradient reduction
//
// After the recurrence, the parameter gradients are sums over the
// K = 2B*T rows n = (row, t) of the gate cotangents R1 (and, optionally, a
// second right-hand matrix R2 of the same shape; LSTM has only R1):
//   out[k]      = sum_n h_prev[n, k] R1[n]   (k < u: dU; h_prev = hseq one
//                                             step back, zero at t = 0)
//   out[u]      = sum_n R1[n]                (bias of R1)
//   out[u+1]    = sum_n R2[n]                (bias of R2)
//   out[u+2+c]  = sum_{n: code(n) = c} mask[g(j), row(n), c] R2[n, j]  (dW)
// Tiled f32 product (64 x 64 tile, 16 rows of K a chunk, 4 x 4 outputs a
// thread), split over K: split z writes its partial [u+7, g*u] and
// SumReducePartsKernel adds the splits in order (no atomics, so the
// gradients are bitwise reproducible).  The CTAs of the first row tile
// also form the seven vector rows from the staged R tiles.

constexpr int kRedTile = 64;
constexpr int kRedDepth = 16;
constexpr int kRedThreads = 256;
constexpr int kVecRows = 7;

__global__ void __launch_bounds__(kRedThreads)
TrainReduceKernel(const float *__restrict__ hseq,
                  const float *__restrict__ r1, const float *__restrict__ r2,
                  const int8_t *__restrict__ codes,
                  const float *__restrict__ masks, int batch, int steps,
                  int units, int gates, int per_split,
                  float *__restrict__ parts) {
  // Two buffers of each staged chunk: chunk c+1 is loaded into registers
  // while chunk c is multiplied, then stored to the other buffer.
  __shared__ __align__(16) float s_l[2][kRedDepth][kRedTile];
  __shared__ __align__(16) float s_r[2][kRedDepth][kRedTile];
  __shared__ __align__(16) float s_r2[2][kRedDepth][kRedTile];
  __shared__ int s_code[2][kRedDepth];
  __shared__ float s_scale[2][kRedDepth][kMaxGates];
  __shared__ float s_vec[4][kVecRows][kRedTile];

  const int width = gates * units;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kRedTile;
  const int k0 = blockIdx.y * kRedTile;
  const bool vectors = blockIdx.y == 0;
  const bool two = r2 != nullptr;
  // Int arithmetic: rows (n_rows < 2^31, dg_train_reduce checks it),
  // columns (width = g u, at most 4 x the grid tile's widest, 2,097,120)
  // and the partials' rows; every element index of hseq, r1, r2 and parts
  // is size_t.  Past 2^31 elements: the CLI's B=256, T=342 at u=4096,
  // 175,104 rows of r1 x 16,384 columns (LSTM) = 2.87e9, and the grid
  // tile's GRU u=26,800 / LSTM u=23,200, whose partials [u+7, g u] pass
  // 2^31 (tests/test_torch_cuda.py::test_train_reduce_past_2_31_elements).
  const int n_rows = 2 * batch * steps;
  const int n_begin = blockIdx.z * per_split;
  const int n_stop = min(n_begin + per_split, n_rows);
  const int tx = tid % 16, ty = tid / 16;  // 4 x 4 outputs of the tile
  const int vc = tid % kRedTile, vp = tid / kRedTile;  // vector rows
  const int vg = min((j0 + vc) / units, gates - 1);
  // The staging thread's element: rows nn = vp + 4 m (m < 4) of a chunk,
  // column kk = vc; the step of each row is carried from chunk to chunk.
  const int kk = vc;
  const bool l_in = k0 + kk < units, r_in = j0 + kk < width;
  int step[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) step[m] = (n_begin + vp + 4 * m) % steps;
  float ld_l[4], ld_r[4], ld_r2[4], ld_scale[kMaxGates];
  int ld_code = kPadCode;

  auto load = [&](int n0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = n0 + vp + 4 * m;
      const bool in = n < n_stop;
      ld_l[m] = (in && l_in && step[m] != 0)
                    ? hseq[static_cast<size_t>(n - 1) * units + k0 + kk]
                    : 0.0f;
      ld_r[m] = (in && r_in) ? r1[static_cast<size_t>(n) * width + j0 + kk]
                             : 0.0f;
      if (vectors && two) {
        ld_r2[m] = (in && r_in)
                       ? r2[static_cast<size_t>(n) * width + j0 + kk]
                       : 0.0f;
      }
    }
    if (vectors && tid < kRedDepth) {
      const int n = n0 + tid;
      int row = 0;
      ld_code = kPadCode;
      if (n < n_stop) {
        row = n / steps;
        const int t = n - row * steps;
        ld_code = row < batch
                      ? codes[static_cast<size_t>(row) * steps + t]
                      : Complement(codes[static_cast<size_t>(row - batch) *
                                             steps + steps - 1 - t]);
      }
      for (int g = 0; g < gates; ++g) {
        ld_scale[g] =
            (masks != nullptr && ld_code < kCodes)
                ? masks[(static_cast<size_t>(g) * 2 * batch + row) * kCodes +
                        ld_code]
                : 1.0f;
      }
    }
  };

  float acc[4][4] = {};
  float vec[kVecRows] = {};
  if (n_begin < n_stop) load(n_begin);
  for (int n0 = n_begin, buf = 0; n0 < n_stop;
       n0 += kRedDepth, buf ^= 1) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      s_l[buf][vp + 4 * m][kk] = ld_l[m];
      s_r[buf][vp + 4 * m][kk] = ld_r[m];
      if (vectors && two) s_r2[buf][vp + 4 * m][kk] = ld_r2[m];
      step[m] += kRedDepth;
      while (step[m] >= steps) step[m] -= steps;
    }
    if (vectors && tid < kRedDepth) {
      s_code[buf][tid] = ld_code;
      for (int g = 0; g < gates; ++g) s_scale[buf][tid][g] = ld_scale[g];
    }
    __syncthreads();
    if (n0 + kRedDepth < n_stop) load(n0 + kRedDepth);
#pragma unroll
    for (int nn = 0; nn < kRedDepth; ++nn) {
      const float4 a =
          *reinterpret_cast<const float4 *>(&s_l[buf][nn][4 * ty]);
      const float4 b =
          *reinterpret_cast<const float4 *>(&s_r[buf][nn][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[p][r] = fmaf(av[p], bv[r], acc[p][r]);
      }
    }
    if (vectors) {
      for (int nn = vp; nn < kRedDepth; nn += 4) {
        const float v1 = s_r[buf][nn][vc];
        const float v2 = two ? s_r2[buf][nn][vc] : v1;
        vec[0] += v1;
        vec[1] += v2;
        const int code = s_code[buf][nn];
        const float scaled = s_scale[buf][nn][vg] * v2;
#pragma unroll
        for (int c = 0; c < kCodes; ++c) {
          if (code == c) vec[2 + c] += scaled;
        }
      }
    }
  }

  float *part = parts + static_cast<size_t>(blockIdx.z) * (units + kVecRows) *
                            width;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int k = k0 + 4 * ty + p;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + 4 * tx + r;
      if (k < units && j < width) part[static_cast<size_t>(k) * width + j] =
          acc[p][r];
    }
  }
  if (vectors) {  // the four interleaved vector partials, added in order
#pragma unroll
    for (int r = 0; r < kVecRows; ++r) s_vec[vp][r][vc] = vec[r];
    __syncthreads();
    for (int e = tid; e < kVecRows * kRedTile; e += kRedThreads) {
      const int r = e / kRedTile, c = e % kRedTile;
      if (j0 + c < width) {
        part[static_cast<size_t>(units + r) * width + j0 + c] =
            ((s_vec[0][r][c] + s_vec[1][r][c]) + s_vec[2][r][c]) +
            s_vec[3][r][c];
      }
    }
  }
}

// Adds the splits' partials in order and scatters the rows to the
// gradients (a null bias pointer drops its row).  Element offsets are
// size_t: (u + 7) g u passes 2^31 at u=26,752 (GRU) and 23,167 (LSTM), so
// the threads stride over the elements.
__global__ void SumReducePartsKernel(const float *__restrict__ parts,
                                     int n_parts, int units, int width,
                                     float *__restrict__ d_recurrent,
                                     float *__restrict__ d_bias_1,
                                     float *__restrict__ d_bias_2,
                                     float *__restrict__ d_kernel) {
  const size_t n_elem = static_cast<size_t>(units + kVecRows) * width;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elem; e += stride) {
    float acc = 0.0f;
    for (int p = 0; p < n_parts; ++p) {
      acc += parts[static_cast<size_t>(p) * n_elem + e];
    }
    const size_t row = e / width, j = e - row * width;
    if (row < static_cast<size_t>(units)) {
      d_recurrent[e] = acc;
    } else if (row == static_cast<size_t>(units)) {
      if (d_bias_1 != nullptr) d_bias_1[j] = acc;
    } else if (row == static_cast<size_t>(units) + 1) {
      if (d_bias_2 != nullptr) d_bias_2[j] = acc;
    } else {
      d_kernel[(row - units - 2) * width + j] = acc;
    }
  }
}

// Opt-in shared memory above 48 kB, then the launch (one CTA a window).
template <typename Kernel, typename... Args>
int LaunchWindow(Kernel kernel_fn, int batch, int units, size_t smem,
                 cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel_fn<<<batch, kSlices * units, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The window kernels take 4u threads a CTA: up to kWindowUnits = 128
// units, U in registers or through L1/L2.
bool BadWindowShape(int batch, int steps, int units) {
  return batch <= 0 || steps <= 0 || units <= 0 || units > kWindowUnits;
}

// Past the window tile the cluster tile, up to kMaxUnits.
bool BadTrainShape(int batch, int steps, int units) {
  return batch <= 0 || steps <= 0 || units <= 0 || units > kMaxUnits;
}

bool IsCluster(int units) { return units > kWindowUnits; }

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after its launches (0 = all
// launched).  `masks` may be null (no dropout: scale 1).
int dg_gru_train_fwd(const void *codes, int batch, int steps,
                     const void *masks, const void *kernel, const void *bias,
                     const void *recurrent, int units, void *avg,
                     void *hidden, void *hseq, void *stream) {
  if (BadTrainShape(batch, steps, units)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (IsCluster(units)) {
    return FwdCluster<kGruGates>(codes, batch, steps, masks, kernel, bias,
                                 recurrent, units, avg, hidden, hseq,
                                 nullptr,
                                 static_cast<cudaStream_t>(stream));
  }
  const size_t smem = WindowSmem(kGruGates, units, steps, false);
  const auto fn = units <= kRegUnits ? GruTrainFwdKernel<true> : GruTrainFwdKernel<false>;
  return LaunchWindow(
      fn, batch, units, smem, static_cast<cudaStream_t>(stream),
      static_cast<const int8_t *>(codes), batch, steps,
      static_cast<const float *>(masks), static_cast<const float *>(kernel),
      static_cast<const float *>(bias), static_cast<const float *>(recurrent),
      units, static_cast<float *>(avg), static_cast<float *>(hidden),
      static_cast<float *>(hseq));
}

int dg_lstm_train_fwd(const void *codes, int batch, int steps,
                      const void *masks, const void *kernel,
                      const void *bias, const void *recurrent, int units,
                      void *avg, void *hidden, void *hseq, void *cseq,
                      void *stream) {
  if (BadTrainShape(batch, steps, units)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (IsCluster(units)) {
    return FwdCluster<kLstmGates>(codes, batch, steps, masks, kernel, bias,
                                  recurrent, units, avg, hidden, hseq, cseq,
                                  static_cast<cudaStream_t>(stream));
  }
  const size_t smem = WindowSmem(kLstmGates, units, steps, false);
  const auto fn = units <= kRegUnits ? LstmTrainFwdKernel<true> : LstmTrainFwdKernel<false>;
  return LaunchWindow(
      fn, batch, units, smem, static_cast<cudaStream_t>(stream),
      static_cast<const int8_t *>(codes), batch, steps,
      static_cast<const float *>(masks), static_cast<const float *>(kernel),
      static_cast<const float *>(bias), static_cast<const float *>(recurrent),
      units, static_cast<float *>(avg), static_cast<float *>(hidden),
      static_cast<float *>(hseq), static_cast<float *>(cseq));
}

// The LSTM backward's recurrence: writes the gate cotangents da [2B, T, 4u]
// (scratch the caller allocates); dg_train_reduce then sums the gradients.
int dg_lstm_bwd_recurrence(const void *codes, int batch, int steps,
                           const void *masks, const void *kernel,
                           const void *bias, const void *recurrent,
                           int units, const void *hseq, const void *cseq,
                           const void *d_avg, const void *d_hidden, void *da,
                           void *stream) {
  if (BadTrainShape(batch, steps, units)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (IsCluster(units)) {
    return BwdCluster<kLstmGates>(codes, batch, steps, masks, kernel, bias,
                                  recurrent, units, hseq, cseq, d_avg,
                                  d_hidden, da, nullptr,
                                  static_cast<cudaStream_t>(stream));
  }
  const size_t smem = WindowSmem(kLstmGates, units, steps, true);
  const auto fn = units <= kRegUnits ? LstmBwdRecurrenceKernel<true>
                                     : LstmBwdRecurrenceKernel<false>;
  return LaunchWindow(
      fn, batch, units, smem, static_cast<cudaStream_t>(stream),
      static_cast<const int8_t *>(codes), batch, steps,
      static_cast<const float *>(masks), static_cast<const float *>(kernel),
      static_cast<const float *>(bias), static_cast<const float *>(recurrent),
      units, static_cast<const float *>(hseq),
      static_cast<const float *>(cseq), static_cast<const float *>(d_avg),
      static_cast<const float *>(d_hidden), static_cast<float *>(da));
}

// The GRU backward's recurrence: writes d_rp and d_xp [2B, T, 3u] (scratch
// the caller allocates); dg_train_reduce then sums the gradients.
int dg_gru_bwd_recurrence(const void *codes, int batch, int steps,
                          const void *masks, const void *kernel,
                          const void *bias, const void *recurrent, int units,
                          const void *hseq, const void *d_avg,
                          const void *d_hidden, void *d_rp, void *d_xp,
                          void *stream) {
  if (BadTrainShape(batch, steps, units)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (IsCluster(units)) {
    return BwdCluster<kGruGates>(codes, batch, steps, masks, kernel, bias,
                                 recurrent, units, hseq, nullptr, d_avg,
                                 d_hidden, d_rp, d_xp,
                                 static_cast<cudaStream_t>(stream));
  }
  const size_t smem = WindowSmem(kGruGates, units, steps, true);
  const auto fn = units <= kRegUnits ? GruBwdRecurrenceKernel<true>
                                     : GruBwdRecurrenceKernel<false>;
  return LaunchWindow(
      fn, batch, units, smem, static_cast<cudaStream_t>(stream),
      static_cast<const int8_t *>(codes), batch, steps,
      static_cast<const float *>(masks), static_cast<const float *>(kernel),
      static_cast<const float *>(bias), static_cast<const float *>(recurrent),
      units, static_cast<const float *>(hseq),
      static_cast<const float *>(d_avg), static_cast<const float *>(d_hidden),
      static_cast<float *>(d_rp), static_cast<float *>(d_xp));
}

// CTAs of a window kernel that fit on one SM at this width and length (0
// if the kernel cannot launch): which = 0 the LSTM forward, 1 the LSTM
// backward recurrence, 2 the GRU backward recurrence, 3 the GRU forward.
int dg_window_ctas_per_sm(int which, int units, int steps) {
  struct Entry {
    const void *fns[2];  // U through L2, U in registers
    int gates;
    bool backward;
  };
  const Entry kernels[4] = {
      {{reinterpret_cast<const void *>(LstmTrainFwdKernel<false>),
        reinterpret_cast<const void *>(LstmTrainFwdKernel<true>)},
       kLstmGates, false},
      {{reinterpret_cast<const void *>(LstmBwdRecurrenceKernel<false>),
        reinterpret_cast<const void *>(LstmBwdRecurrenceKernel<true>)},
       kLstmGates, true},
      {{reinterpret_cast<const void *>(GruBwdRecurrenceKernel<false>),
        reinterpret_cast<const void *>(GruBwdRecurrenceKernel<true>)},
       kGruGates, true},
      {{reinterpret_cast<const void *>(GruTrainFwdKernel<false>),
        reinterpret_cast<const void *>(GruTrainFwdKernel<true>)},
       kGruGates, false}};
  if (which < 0 || which > 3 || BadWindowShape(1, steps, units)) return 0;
  const Entry &entry = kernels[which];
  const void *fn = entry.fns[units <= kRegUnits ? 1 : 0];
  const size_t smem = WindowSmem(entry.gates, units, steps, entry.backward);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, kSlices * units, smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return blocks;
}

// The cluster tile of a training kernel at this width and batch (which:
// as dg_window_ctas_per_sm's): out[0] CTAs a cluster, out[1] windows a
// cluster, out[2] the clusters of it the card runs at once (0 if it cannot
// place one).  Returns 0 (out untouched) where the kernel runs no cluster:
// u <= 128, or a shape it refuses.
int dg_train_clusters(int which, int units, int batch, int *out) {
  if (which < 0 || which > 3 || BadTrainShape(batch, 1, units) ||
      !IsCluster(units)) {
    return 0;
  }
  const bool lstm = which < 2, backward = which == 1 || which == 2;
  const int slots =
      lstm ? (backward ? ClusterSlotsAt<kLstmGates, true>(units, batch)
                       : ClusterSlotsAt<kLstmGates, false>(units, batch))
           : (backward ? ClusterSlotsAt<kGruGates, true>(units, batch)
                       : ClusterSlotsAt<kGruGates, false>(units, batch));
  if (slots < 0) return 0;
  const TrainCluster lay = ClusterLayoutOf(backward, units, batch);
  out[0] = lay.cluster;
  out[1] = lay.windows;
  out[2] = slots;
  return 1;
}

// Sums of the backward over K = 2B*T rows (see TrainReduceKernel):
// partials [splits, u+7, g*u] (scratch the caller allocates), then
// d_recurrent [u, g*u], d_bias_1 (sum of r1), d_bias_2 (sum of r2; r2 may
// be null and then is r1) and d_kernel [5, g*u].  Null bias pointers drop
// their row.
int dg_train_reduce(const void *hseq, const void *r1, const void *r2,
                    const void *codes, const void *masks, int batch,
                    int steps, int units, int gates, int splits,
                    void *parts, void *d_kernel, void *d_bias_1,
                    void *d_bias_2, void *d_recurrent, void *stream) {
  if (batch <= 0 || steps <= 0 || units <= 0 || splits <= 0 ||
      gates < kGruGates || gates > kMaxGates) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = gates * units;
  const size_t n_rows = 2 * static_cast<size_t>(batch) * steps;
  if (n_rows > 0x7fffffffu - kRedDepth) {  // rows are counted in int
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_split = static_cast<int>((n_rows + splits - 1) / splits);
  const dim3 grid((width + kRedTile - 1) / kRedTile,
                  (units + kRedTile - 1) / kRedTile, splits);
  TrainReduceKernel<<<grid, kRedThreads, 0, s>>>(
      static_cast<const float *>(hseq), static_cast<const float *>(r1),
      static_cast<const float *>(r2), static_cast<const int8_t *>(codes),
      static_cast<const float *>(masks), batch, steps, units, gates,
      per_split, static_cast<float *>(parts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  constexpr size_t kMaxBlocks = 1 << 20;  // then the threads stride
  const size_t n_elem = static_cast<size_t>(units + kVecRows) * width;
  const size_t blocks = (n_elem + kThreads - 1) / kThreads;
  SumReducePartsKernel<<<static_cast<unsigned>(blocks < kMaxBlocks
                                                   ? blocks
                                                   : kMaxBlocks),
                         kThreads, 0, s>>>(
      static_cast<const float *>(parts), splits, units, width,
      static_cast<float *>(d_recurrent), static_cast<float *>(d_bias_1),
      static_cast<float *>(d_bias_2), static_cast<float *>(d_kernel));
  return static_cast<int>(cudaGetLastError());
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
