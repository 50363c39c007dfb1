// GRU over a float input sequence (inference), for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package:
//   * dg_gru_seq <- deepgrp_tpu/models/pallas_rnn.py:43 _gru_kernel
//                   (_pallas_gru :78, pallas_gru_apply :126)
// Contract (identical to that kernel and to the plain PyTorch version
// deepgrp_tpu_torch/models/rnn.py:gru_apply): x [B, T, C] float32 or
// bfloat16 (any C: a real input dot x_t W + b_in, not a row select);
// kernel W [C, 3u] and recurrent U [u, 3u] in x's type; bias [2, 3u]
// float32 (input row, recurrent row); Keras GRU gate math (reset_after=True,
// gates z, r, h); outputs seq [B, T, u] and last [B, u] (the state after
// step T-1) in x's type.  The carried state h and the gate math are float32.
// Precision: float32 IO sums float32 FMAs (Precision.HIGHEST); bfloat16 IO
// rounds h to bfloat16 for the recurrent dot (W and U already are) and
// accumulates in float32: the TPU's DEFAULT precision.
//
// Bound on this card.  Per row the recurrent products cost T x u x 3u
// multiply-adds and the input dot T x C x 3u; at the scan route's shape
// (2048 rows = a doubled batch of 1024, T=342, u=60, C=5) that is 16.4
// GFLOP against 182 MB of float32 IO, so float32 work bounds it (0.245 ms
// at 67 TFLOP/s; 0.054 ms of bytes at 3.35 TB/s).  The recurrence is
// sequential in T, so the parallelism is B x u.
//
// Design: the register tile of rnn_avg.cu (its building blocks are in
// rnn_tile.cuh), with independent rows in place of the fused kernel's
// forward / reverse pairs.  The first design (one thread per row-unit, U in
// shared memory, a U load for every 3 FMAs) was bound by shared-memory
// wavefronts and ran level with cuDNN at u=60 and 1.5x slower at u=128.
//   * Tile: a CTA owns bb rows for all T steps, bb chosen by the caller
//     from the row count and the SM count so the grid is one wave (2048
//     rows on 132 SMs: bb=16, 128 CTAs), at most 16 rows (MaxRows; 4 from
//     u=257 to 512).  Threads come in lane groups of 4 u: lane 4 i + s
//     owns unit i and k-slice s of the recurrent dot for the group's kRows
//     rows; a CTA has ceil(bb / kRows) groups.
//   * Layouts by width: up to u=64 four slices with U's slice in registers
//     (48 floats a lane) and kRows 8 (4 when bb <= 4); up to u=128 four
//     slices through L1/L2 with kRows 16 (4 when bb <= 4); past u=128 the
//     cluster tile (below), to u=1024 (kMaxUnits); past it the caller
//     runs the grid tile (rnn_grid.cu), and u=1025 is refused here.
//   * The layouts, timed on an NVIDIA H100 80GB HBM3 at its 700 W limit
//     (tools/avg_tile_sweep.py --kernel seq, two runs, f32, T=342, ms a
//     launch): at 2048 rows, u=60, kRows 8 with U in
//     registers (bb=16, 128 CTAs) 1.0259 / 1.0178, kRows 16 with U in
//     registers (158 registers, one group of 240 threads) 1.3153 / 1.3054,
//     kRows 4 with U in registers (bb=8, 256 CTAs) 1.5694 / 1.5527, kRows 8
//     through L1/L2 1.4460 / 1.4323, kRows 16 through L1/L2 1.5139 /
//     1.4972; at 512 rows (bb=4) kRows 4 with U in registers 0.5890 /
//     0.5844 against kRows 8 0.7163 / 0.7096; at u=128, 2048 rows, kRows
//     16 (bb=16) 3.9191 / 3.8929, kRows 8 (bb=8) 5.6679 / 5.6704, kRows 4
//     (bb=4) 7.5896 / 7.5813.  Unrolling the L1/L2 quad loop made kRows
//     16 spill and run slower.
//   * Past u=128 one CTA a row (two k-slices a unit up to u=512, one beyond:
//     2u or u threads) would stream all of U from L2 every step (786 kB at
//     u=256), so the per-SM L2 rate and its latency would bound the wide
//     layers, and a few rows would use few SMs (u=512 at 16 rows: 16 CTAs,
//     20.4 ms against cuDNN's 5.6).  There the cluster tile (kCluster CTAs, a
//     thread-block cluster: Hopper's distributed shared memory, the helpers in
//     rnn_tile.cuh) splits a row's units: the CTA of rank r owns units [r uc,
//     (r + 1) uc), uc = ceil(u / kCluster), with all their gates and all k of
//     their columns of U, so it forms whole gate sums (four slices and the
//     butterfly, as above) from its full copy of h; no partial sum crosses
//     CTAs and each unit's sum runs in an order fixed by u.  At the end of a
//     step a unit's owner lanes write its new h into the next buffer of every
//     CTA of the cluster (st.shared::cluster), and one cluster barrier
//     (arrive.release, wait.acquire) stands where the CTA's barrier stood.
//     Each CTA of a cluster holds the cluster's bb rows and its columns of W
//     and the biases; lanes past u (the last CTA's, when kCluster does not
//     divide u) read U's last column, and their sums are dropped.  Layouts: up
//     to u=256 8 CTAs a cluster, each with its slice of U in shared memory (98
//     kB at u=256), kRows 8 (4 when bb <= 4); up to u=512 16 CTAs
//     (non-portable), U's slice in shared memory (196 kB at u=512, which
//     leaves room for 4 rows: MaxRows), kRows 4; past u=512 16 CTAs streaming
//     U's slice through L1/L2 (786 kB at u=1024), kRows 16 (4 when bb <= 4).
//     The caller counts clusters, not CTAs, in a wave, and asks the card how
//     many it places at once (dg_gru_seq_clusters,
//     cudaOccupancyMaxActiveClusters): a 16-CTA cluster needs 16 SMs of one
//     GPC, and the H100 runs 7 at once (112 CTAs), so 8 clusters take two
//     waves.
//   * The cluster tile, timed on the same card (tools/avg_tile_sweep.py
//     --kernel seq --min-units 129, f32 / bf16 IO, T=342, ms a launch; my
//     chip call 5 of PR 17): at 16 rows, u=512, 16 CTAs a cluster, U in
//     shared memory, bb=4 (4 clusters) 1.5667 / 1.5593, bb=2 (8 clusters,
//     two waves) 3.0284 / 2.9968; U through L1/L2 instead, bb=2, 4.6136 /
//     4.9160; 8 CTAs through L1/L2, bb=2 4.5040 / 5.0070, bb=1 6.5196 /
//     6.7096 (one CTA a row, two slices: 20.4598 in f32, PR 7's
//     chip_smoke.py).  At 512 rows, u=256: 8 CTAs, U in shared memory,
//     bb=16, kRows 8 5.7095 / 5.6668, kRows 16 6.6121 / 6.5032; bb=4
//     (1,024 CTAs), kRows 4, 9.7046 / 9.6058; U through L1/L2, kRows 16,
//     10.2910 / 10.6849; 16 CTAs, U in shared memory, kRows 4 8.0617 /
//     7.9911, kRows 16 11.4475 / 11.3130 (one CTA a row: 6.2830 in f32,
//     PR 7).  At 64 rows, u=1024: 16 CTAs through L1/L2, bb=16 (4
//     clusters), kRows 16, 15.1230 / 15.3363; bb=8 (8 clusters, two
//     waves) 28.8990 / 29.3197; bb=4 (16 clusters), kRows 4, 24.8945 /
//     25.8522.  So 16 CTAs with U in shared memory where it fits, few
//     rows a cluster, kRows 8 at 8 CTAs.
//   * What bounds the cluster tile: with U in shared memory, the latency
//     of the step (one to four warps a scheduler, the shared-memory round
//     trips of the dot, the hand-off and the cluster barrier), not the
//     FMA rate (u=512 at 16 rows: 4.6 us a step against 0.13 ms of FMAs
//     a launch); past u=512 the L2 stream of U's slices (88 MB a step at
//     u=1024 over 112 CTAs, about 2 TB/s), where cuDNN is faster.
//   * Where it stops: u=1024.  A layout with several units a lane served
//     u=1025 to 4096 once, but the grid tile (rnn_grid.cu) was faster at
//     every width past u=1024 and every row count swept
//     (tools/avg_tile_sweep.py --grid on an NVIDIA H100 80GB HBM3 at 700 W,
//     ms cluster / grid, f32: u=1025, 16 rows 16.719 / 13.497; u=2048, 64
//     rows 129.006 / 23.524).  At u=1024 this tile stays: 16 rows 8.321 /
//     13.075 (bf16 IO 9.388 / 13.263).
//   * Step: the lane forms the three gate partials of its group's kRows rows
//     over its slice, each U entry loaded once for all of them and h read as
//     float4 broadcasts from shared memory; the butterfly (xor 1, then xor
//     2) leaves each lane whole sums for kRows / 4 rows (two of the same
//     pair with kRows 4, where lanes s and s ^ 2 agree and s < 2 writes).
//     That lane then forms the row's input dot x_t W in channel order (W
//     and both bias rows in shared memory, x_t from the staged tile), does
//     the gate math, carries h in a register, writes h to the other of two
//     shared buffers (one barrier a step), and stores seq[row, t, i] (and
//     last at T-1).
//   * x is staged in shared memory as float32, the CTA's whole x when it
//     fits (16 x 342 x 5 floats: 109 kB at the scan route's shape), else
//     double-buffered tiles of tile_steps steps, each loaded one tile ahead
//     at the first step of the one before it: no second barrier a step.
//   * Ragged rows: rows past the batch read zeros and store nothing; a
//     group's rows past the CTA's bb read zero rows of h (the buffers are
//     padded to whole groups), so the dot has no branch (as rnn_avg.cu
//     found, a branch there keeps the compiler from interleaving the rows'
//     loads), and their sums are dropped.
//   * The sums run in a fixed order (four slices, then the butterfly), with
//     no atomics: a second launch is bitwise equal to the first; the order
//     differs from the plain version's, which the tolerance allows for.
// The bf16 variant runs the same float32 FMAs on rounded operands: its
// bound is the same work at the bf16 tensor-core rate, which this design
// does not reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_tile.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTileUnits = 128;  // widest layer of one CTA a row

// The cluster tile past u=128 (see the note above): CTAs a cluster and
// whether each keeps its slice of U in shared memory, by width.
__host__ __device__ __forceinline__ int SeqCluster(int units) {
  return units <= kTileUnits ? 1 : units <= 256 ? 8 : 16;
}
__host__ __device__ __forceinline__ bool SeqUSmem(int units) {
  return units > kTileUnits && units <= 512;
}

// Rows a CTA may own at this width: 16, but 4 from u=257 to 512 (U's
// slice in shared memory).
__host__ __device__ __forceinline__ int MaxRows(int units) {
  return units <= 256 || units > 512 ? 16 : 4;
}

// Units of a row each CTA of a cluster owns (the last may own fewer).
__host__ __device__ __forceinline__ int ClusterUnits(int units,
                                                     int cluster) {
  return (units + cluster - 1) / cluster;
}

// Floats a k row of the shared slice of U takes: 3 uc, padded to 2 mod 8
// so that the four lanes of a unit (4 k rows apart, 8 banks apart) read
// other banks.
__host__ __device__ __forceinline__ int UStride(int uc) {
  return 3 * uc + ((2 - 3 * uc) % 8 + 8) % 8;
}

// The launch bound of a layout: 16 rows a group with U in registers is one
// group of at most 256 threads; 4 rows through L1/L2 keep the 1,024 that
// the one-CTA layouts past u=128 needed (2u threads) and the 64 registers
// a thread that their timings were taken at.  A CTA of a cluster owns at
// most 64 units and 16 rows in one or two groups: 256 threads, which
// leave a thread up to 255 registers (101 at kRows 4, 102 at kRows 8),
// but 16 rows a group through L1/L2 keep 512 (124 registers), which ran
// faster than 255.
__host__ __device__ constexpr int SeqThreads(int rows, bool u_regs,
                                             int cluster, bool u_smem) {
  return cluster > 1 ? (rows >= 16 && !u_smem ? 512 : 256)
         : u_regs    ? (rows >= 16 ? 256 : 512)
                     : (rows == 4 ? kMaxThreads : 512);
}

// Floats a row of the staged x takes: tile_steps x C, padded to 4 mod 16
// so the owner lanes' reads of neighbouring rows fall in other banks.
__host__ __device__ __forceinline__ int XStride(int tile_steps,
                                                 int channels) {
  const int n = tile_steps * channels;
  return n + (20 - n % 16) % 16;
}

template <bool kBf16>
using Elem = typename Io<kBf16>::Out;

// kRows rows a lane group (4 UnitSpan(uc, kUnits) threads, uc the CTA's
// units: u without a cluster); ceil(bb / kRows) groups a CTA.  kCluster
// CTAs a cluster split a row's units (1: no cluster); kUSmem keeps the
// CTA's slice of U in shared memory (else registers, kURegs, or L1/L2);
// each lane owns kUnits of the CTA's units (LaneUnit), one after the
// other.  Every launch runs one unit a lane (kUnits 1): the unit loop
// stays because this is the code whose machine code was measured; the
// same kernel without it compiles to other SASS, the flagship's
// SeqKernel<8, U in registers> among them (tools/train_turns.py --sass
// --libs rnn_seq).
template <int kRows, bool kURegs, bool kBf16, int kCluster = 1,
          bool kUSmem = false, int kUnits = 1>
__global__ void __launch_bounds__(SeqThreads(kRows, kURegs, kCluster,
                                             kUSmem),
                                  1)
SeqKernel(const Elem<kBf16> *__restrict__ x, int batch, int steps,
          int channels, const Elem<kBf16> *__restrict__ kernel,
          const float *__restrict__ bias,
          const Elem<kBf16> *__restrict__ recurrent, int units, int bb,
          int tile_steps, Elem<kBf16> *__restrict__ seq,
          Elem<kBf16> *__restrict__ last) {
  static_assert(kRows == 4 || kRows == 8 || kRows == 16,
                "kRows: pairs enough for the butterfly");
  static_assert(!(kURegs && (kUSmem || kCluster > 1)),
                "U in registers: one CTA a row");
  static_assert(kUnits == 1 || (!kURegs && !kUSmem),
                "several units a lane read U through L1/L2");
  using IoT = Io<kBf16>;
  // The butterfly folds row pairs (as rnn_avg.cu folds a window's two
  // branches): a lane ends with kOwn pairs, 4 j + s, or with kRows 4 the
  // pair s & 1, which lanes s and s ^ 2 share.
  constexpr int kPairs = kRows / 2;
  constexpr int kOwn = kPairs >= kSlices ? kPairs / kSlices : 1;
  extern __shared__ float4 smem4[];
  const int width = 3 * units;
  const int hstride = Pad4(units);
  const int rows_pad = (bb + kRows - 1) / kRows * kRows;
  const int xstride = XStride(tile_steps, channels);
  // The CTA's units of a row: [base, base + uc), all u without a cluster;
  // it keeps their columns of W, the biases (and U): cols a row.
  const int uc = ClusterUnits(units, kCluster);
  const int base = kCluster > 1 ? static_cast<int>(ClusterRank()) * uc : 0;
  const int cols = 3 * uc;
  const int ustride = UStride(uc);
  const int span = UnitSpan(uc, kUnits);
  float *s_h = reinterpret_cast<float *>(smem4);  // [2][rows_pad][hstride]
  float *s_w = s_h + 2 * rows_pad * hstride;     // [C][cols]
  float *s_b = s_w + channels * cols;            // [2][cols]
  float *s_u = s_b + 2 * cols;                   // [Pad4(u)][ustride]
  float *s_x = s_u + (kUSmem ? Pad4(units) * ustride : 0);
  // [1 or 2][bb][xstride]

  const int tid = threadIdx.x;
  const int group = tid / (kSlices * span);
  const int lane = tid - group * kSlices * span;
  const int i = lane / kSlices, s = lane % kSlices;
  const int g0 = group * kRows;
  const int row0 = blockIdx.x / kCluster * bb;
  for (int j = tid; j < 2 * rows_pad * hstride; j += blockDim.x) {
    s_h[j] = 0.0f;
  }
  // Column o of the CTA's cols (gate o / uc, unit base + o % uc) in a
  // matrix of the row's width; -1 past u.
  auto column = [&](int o) {
    const int g = o / uc, n = base + o - g * uc;
    return n < units ? g * units + n : -1;
  };
  for (int j = tid; j < channels * cols; j += blockDim.x) {
    const int c = j / cols, col = column(j - c * cols);
    s_w[j] = col >= 0 ? ToOperand<kBf16>(kernel[c * width + col]) : 0.0f;
  }
  for (int j = tid; j < 2 * cols; j += blockDim.x) {
    const int r = j / cols, col = column(j - r * cols);
    s_b[j] = col >= 0 ? bias[r * width + col] : 0.0f;
  }
  if constexpr (kUSmem) {
    for (int j = tid; j < Pad4(units) * ustride; j += blockDim.x) {
      const int k = j / ustride, o = j - k * ustride;
      const int col = o < cols && k < units ? column(o) : -1;
      s_u[j] = col >= 0 ? ToOperand<kBf16>(recurrent[k * width + col])
                        : 0.0f;
    }
  }
  // Steps [t0, t0 + tile_steps) of the CTA's rows into buffer
  // (t0 / tile_steps) & 1; rows past the batch read zeros.  Each row's span
  // is contiguous in x: coalesced.
  auto stage = [&](int t0) {
    float *dst = s_x + ((t0 / tile_steps) & 1) * bb * xstride;
    const int span = min(tile_steps, steps - t0) * channels;
    for (int j = tid; j < bb * span; j += blockDim.x) {
      const int rb = j / span;
      const int o = j - rb * span;
      const int r = row0 + rb;
      const size_t at = (static_cast<size_t>(r) * steps + t0) * channels + o;
      dst[rb * xstride + o] = r < batch ? ToOperand<kBf16>(x[at]) : 0.0f;
    }
  };
  stage(0);
  // The lane's units of the row (local[n] of the CTA's).  A lane past u
  // (the last CTA of a cluster) or past the CTA's units reads the last
  // unit's column of U; its sums are dropped.
  int local[kUnits], unit[kUnits], u_col[kUnits];
  bool writer[kUnits];
#pragma unroll
  for (int n = 0; n < kUnits; ++n) {
    local[n] = LaneUnit(i, span, n);
    unit[n] = base + local[n];
    u_col[n] = min(unit[n], units - 1);
    writer[n] = (kPairs >= kSlices || s < 2) &&
                (kUnits == 1 || local[n] < uc) && unit[n] < units;
  }
  USlice<3, kURegs, kBf16, Elem<kBf16>> us;
  us.load(recurrent, units, u_col[0], s);
  const float *u_lane = s_u + i;
  const unsigned lanes = WarpLanes();
  const int n_quads = Pad4(units) / 4 > s
                          ? (Pad4(units) / 4 - s + kSlices - 1) / kSlices
                          : 0;
  int own_p[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    own_p[j] = kPairs >= kSlices ? kSlices * j + s : (s & 1);
  }
  float h_own[kUnits][kOwn][2] = {};
  // The h buffers of the cluster's CTAs (the first must not be written
  // before its CTA has zeroed it: the barrier below).
  uint32_t h_peer[kCluster];
#pragma unroll
  for (int p = 0; p < kCluster; ++p) {
    h_peer[p] = kCluster > 1 ? PeerAddress(s_h, p) : 0u;
  }
  if constexpr (kCluster > 1) {
    ClusterBarrier();
  } else {
    __syncthreads();
  }

  for (int t = 0; t < steps; ++t) {
    const int tt = t % tile_steps;
    // The other buffer was last read a tile ago, before the previous
    // step's barrier; this tile is read from the next tile on.
    if (tt == 0 && t + tile_steps < steps) stage(t + tile_steps);
    const float *h_cur =
        s_h + ((t & 1) * rows_pad + g0) * hstride;  // the group's rows
    const int nxt = ((t + 1) & 1) * rows_pad * hstride;
    float *h_nxt = s_h + nxt;

    // The lane's units one after the other.
#pragma unroll
    for (int n = 0; n < kUnits; ++n) {
      // Partial gate dots of the group's rows over the lane's slice: each
      // U entry, loaded once, feeds kRows rows.
      float acc[kPairs][2][3] = {};
      auto quad = [&](int m) {
        const int q = s + kSlices * m;
        float u_q[4][3];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            if constexpr (kUSmem) {
              u_q[c][g] = u_lane[(4 * q + c) * ustride + g * uc];
            } else {
              u_q[c][g] = us.at(m, c, g, s, units, u_col[n]);
            }
          }
        }
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float4 h4 = reinterpret_cast<const float4 *>(
                h_cur + (2 * p + b) * hstride)[q];
            const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
#pragma unroll
              for (int g = 0; g < 3; ++g) {
                acc[p][b][g] = fmaf(hv[c], u_q[c][g], acc[p][b][g]);
              }
            }
          }
        }
      };
      if constexpr (kURegs) {
#pragma unroll
        for (int m = 0; m < kRegQuads; ++m) {
          if (m < n_quads) quad(m);
        }
      } else {
        for (int m = 0; m < n_quads; ++m) quad(m);
      }

      // Reduce-scatter over the unit's four lanes: xor 1, then xor 2
      // (with one pair left after xor 1, the second level is an
      // all-reduce: a + b == b + a, so lanes s and s ^ 2 hold the same
      // bits).
      float dot[kOwn][2][3];
      if constexpr (kPairs >= 4) {
        float half[kPairs / 2][2][3];
        FoldWindows<kPairs, 3>(acc, s & 1, 1, lanes, half);
        FoldWindows<kPairs / 2, 3>(half, (s >> 1) & 1, 2, lanes, dot);
      } else {
        FoldWindows<kPairs, 3>(acc, s & 1, 1, lanes, dot);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            dot[0][b][g] += __shfl_xor_sync(lanes, dot[0][b][g], 2);
          }
        }
      }

      // The input dot and the gate math of the lane's rows.
      const float *x_t =
          s_x + ((t / tile_steps) & 1) * bb * xstride + tt * channels;
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const int r0 = g0 + 2 * own_p[j];
        if (!writer[n] || r0 >= bb) continue;
        // x_t W in channel order, W's entries read once for both rows
        // (the second row may lie past bb: it reads the last row's x).
        const float *x_r[2] = {x_t + r0 * xstride,
                               x_t + min(r0 + 1, bb - 1) * xstride};
        float xg[2][3] = {};
        for (int c = 0; c < channels; ++c) {
          const float *w = s_w + c * cols + local[n];
          const float w_c[3] = {w[0], w[uc], w[2 * uc]};
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float v = x_r[b][c];
#pragma unroll
            for (int g = 0; g < 3; ++g) xg[b][g] = fmaf(v, w_c[g], xg[b][g]);
          }
        }
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int r = r0 + b;
          if (r >= bb) break;
          // Keras GRU, reset_after=True.
          const float *b_in = s_b + local[n];
          const float *b_rec = s_b + cols + local[n];
          const float z = Sigmoid((xg[b][0] + b_in[0]) +
                                  (dot[j][b][0] + b_rec[0]));
          const float rg = Sigmoid((xg[b][1] + b_in[uc]) +
                                   (dot[j][b][1] + b_rec[uc]));
          const float hh = tanhf((xg[b][2] + b_in[2 * uc]) +
                                 rg * (dot[j][b][2] + b_rec[2 * uc]));
          float &h = h_own[n][j][b];
          h = z * h + (1.0f - z) * hh;
          if constexpr (kCluster > 1) {
            // The unit's new h into every CTA's next buffer (its own too).
            const uint32_t at =
                sizeof(float) * (nxt + r * hstride + unit[n]);
#pragma unroll
            for (int p = 0; p < kCluster; ++p) {
              StoreCluster(h_peer[p] + at, IoT::Operand(h));
            }
          } else {
            h_nxt[r * hstride + local[n]] = IoT::Operand(h);
          }
          const int row = row0 + r;
          if (row < batch) {
            const size_t at_row = static_cast<size_t>(row);
            seq[(at_row * steps + t) * units + unit[n]] = IoT::Store(h);
            if (t == steps - 1) {
              last[at_row * units + unit[n]] = IoT::Store(h);
            }
          }
        }
      }
    }
    if constexpr (kCluster > 1) {
      ClusterBarrier();
    } else {
      __syncthreads();
    }
  }
}

// Steps a staged tile of x holds and the CTA's shared memory in bytes: the
// whole T when it fits within the card's opt-in limit a block, else the
// most that two buffers take; a CUDA error, or cudaErrorInvalidValue when
// not even one step fits.
cudaError_t SeqSmem(int units, int channels, int steps, int bb, int rows,
                    int cluster, bool u_smem, int *tile_steps,
                    size_t *bytes) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int uc = ClusterUnits(units, cluster);
  const size_t cols = 3 * static_cast<size_t>(uc);
  const size_t rows_pad = (bb + rows - 1) / rows * rows;
  const size_t u_floats =
      u_smem ? static_cast<size_t>(Pad4(units)) * UStride(uc) : 0;
  const size_t base =
      sizeof(float) *
      (2 * rows_pad * Pad4(units) + (channels + 2) * cols + u_floats);
  const size_t row_bytes = sizeof(float) * static_cast<size_t>(bb);
  if (base + row_bytes * XStride(steps, channels) <=
      static_cast<size_t>(optin)) {
    *tile_steps = steps;
    *bytes = base + row_bytes * XStride(steps, channels);
    return cudaSuccess;
  }
  if (base >= static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  // XStride adds at most 15 floats to tile_steps x C.
  const long fit = static_cast<long>((optin - base) / (2 * row_bytes)) - 15;
  if (fit < channels) return cudaErrorInvalidValue;
  *tile_steps = static_cast<int>(fit / channels);
  *bytes = base + 2 * row_bytes * XStride(*tile_steps, channels);
  return cudaSuccess;
}

// Launches the layout; with `slots`, launches nothing and writes the
// clusters the card runs at once (0 without a cluster, or if it cannot
// place one).
template <int kRows, bool kURegs, bool kBf16, int kCluster = 1,
          bool kUSmem = false>
int LaunchTile(const void *x, int batch, int steps, int channels,
               const void *kernel, const void *bias, const void *recurrent,
               int units, int bb, void *seq, void *last,
               cudaStream_t stream, int *slots = nullptr) {
  using T = Elem<kBf16>;
  const auto fn = SeqKernel<kRows, kURegs, kBf16, kCluster, kUSmem>;
  const int threads =
      (bb + kRows - 1) / kRows * kSlices * ClusterUnits(units, kCluster);
  if (threads > SeqThreads(kRows, kURegs, kCluster, kUSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile_steps = 0;
  size_t smem = 0;
  cudaError_t err = SeqSmem(units, channels, steps, bb, kRows, kCluster,
                            kUSmem, &tile_steps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slots != nullptr) {
    if constexpr (kCluster > 1) {
      *slots = ClusterSlots(fn, threads, smem, kCluster);
    } else {
      *slots = 0;
    }
    return 0;
  }
  const int ctas = (batch + bb - 1) / bb * kCluster;
  const auto args = [&](auto launch) {
    return launch(static_cast<const T *>(x), batch, steps, channels,
                  static_cast<const T *>(kernel),
                  static_cast<const float *>(bias),
                  static_cast<const T *>(recurrent), units, bb, tile_steps,
                  static_cast<T *>(seq), static_cast<T *>(last));
  };
  if constexpr (kCluster > 1) {
    return static_cast<int>(args([&](auto... a) {
      return LaunchCluster(fn, ctas, threads, smem, kCluster, stream, a...);
    }));
  } else {
    // Above 48 kB a kernel only launches after this opt-in; a launch
    // without it is refused, and the refusal shows only in
    // cudaGetLastError.
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(args([&](auto... a) {
      fn<<<ctas, threads, smem, stream>>>(a...);
      return cudaGetLastError();
    }));
  }
}

// The layout at this width and rows a CTA: {rows a lane group, slices a
// unit, where U sits (0 L1/L2, 1 registers, 2 shared memory), CTAs a
// cluster}; false if the shape is refused.
bool Layout(int units, int bb, int *out) {
  if (units <= 0 || units > kMaxUnits || bb < 1 || bb > MaxRows(units)) {
    return false;
  }
  const bool small = bb <= 4;
  out[3] = SeqCluster(units);
  if (out[3] > 1) {  // four slices of the CTA's units
    out[0] = small ? 4 : out[3] == 8 ? 8 : 16;
    out[1] = 4;
    out[2] = SeqUSmem(units) ? 2 : 0;
    return true;
  }
  out[0] = small ? 4 : units <= kRegUnits ? 8 : 16;
  out[1] = 4;
  out[2] = units <= kRegUnits;
  return true;
}

template <bool kBf16>
int LaunchSeq(const void *x, int batch, int steps, int channels,
              const void *kernel, const void *bias, const void *recurrent,
              int units, int bb, void *seq, void *last, void *stream,
              int *slots = nullptr) {
  int layout[4];
  if (batch <= 0 || steps <= 0 || channels <= 0 ||
      !Layout(units, bb, layout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto fn) {
    return fn(x, batch, steps, channels, kernel, bias, recurrent, units, bb,
              seq, last, s, slots);
  };
  if (layout[3] == 8) {
    return layout[0] == 4 ? launch(LaunchTile<4, false, kBf16, 8, true>)
                          : launch(LaunchTile<8, false, kBf16, 8, true>);
  }
  if (layout[3] == 16) {
    if (layout[2] == 2) return launch(LaunchTile<4, false, kBf16, 16, true>);
    return layout[0] == 4 ? launch(LaunchTile<4, false, kBf16, 16, false>)
                          : launch(LaunchTile<16, false, kBf16, 16, false>);
  }
  if (layout[2]) {
    return layout[0] == 4 ? launch(LaunchTile<4, true, kBf16>)
                          : launch(LaunchTile<8, true, kBf16>);
  }
  return layout[0] == 16 ? launch(LaunchTile<16, false, kBf16>)
                         : launch(LaunchTile<4, false, kBf16>);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 = launched).  `bb` is the rows a CTA (a cluster past u=128) owns, 1
// .. dg_gru_seq_layout's maximum.  bf16 != 0 selects bfloat16 IO (x,
// kernel, recurrent, seq, last); bias is float32 either way.
int dg_gru_seq(const void *x, int batch, int steps, int channels,
               const void *kernel, const void *bias, const void *recurrent,
               int units, int bb, int bf16, void *seq, void *last,
               void *stream) {
  if (bf16) {
    return LaunchSeq<true>(x, batch, steps, channels, kernel, bias,
                           recurrent, units, bb, seq, last, stream);
  }
  return LaunchSeq<false>(x, batch, steps, channels, kernel, bias,
                          recurrent, units, bb, seq, last, stream);
}

// The layout dg_gru_seq launches for `units` and `bb` rows a CTA:
// out[0] rows a lane group, out[1] slices a unit, out[2] where U sits (0
// read through L1/L2, 1 registers, 2 shared memory), out[3] CTAs a
// cluster (1: none; each CTA of a cluster owns ceil(u / out[3]) units).
// Returns the most rows a CTA may own at this width, or 0 if the shape is
// refused (out untouched).
int dg_gru_seq_layout(int units, int bb, int *out) {
  return Layout(units, bb, out) ? MaxRows(units) : 0;
}

// The clusters of dg_gru_seq's layout for this shape (`bb` rows a CTA)
// that the card runs at once: 0 when the layout has no cluster, or when
// the card cannot place one (or the shape is refused).
int dg_gru_seq_clusters(int units, int bb, int steps, int channels,
                        int bf16) {
  int slots = 0;
  const int err =
      bf16 ? LaunchSeq<true>(nullptr, 1, steps, channels, nullptr, nullptr,
                             nullptr, units, bb, nullptr, nullptr, nullptr,
                             &slots)
           : LaunchSeq<false>(nullptr, 1, steps, channels, nullptr, nullptr,
                              nullptr, units, bb, nullptr, nullptr, nullptr,
                              &slots);
  return err == 0 ? slots : 0;
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
