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
//     rows on 132 SMs: bb=16, 128 CTAs), at most 16 rows up to u=128 and 4
//     above (MaxRows).  Threads come in lane groups of kSl u: lane kSl i + s
//     owns unit i and k-slice s of the recurrent dot for the group's kRows
//     rows; a CTA has ceil(bb / kRows) groups.
//   * Layouts by width: up to u=64 four slices with U's slice in registers
//     (48 floats a lane) and kRows 8 (4 when bb <= 4); up to u=128 four
//     slices through L1/L2 with kRows 16 (4 when bb <= 4); up to u=512 two
//     slices (2u threads), up to u=1024 one slice (u threads, no
//     butterfly), both kRows 4 through L1/L2.  u=1025 is refused, as the
//     first design refused it.
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
//     (bb=4) 7.5896 / 7.5813; at u=256, 512 rows (bb=4), two slices
//     6.2656 / 6.2604 against four 8.1330 / 8.1393; at u=512, 16 rows,
//     two slices 20.4492 / 20.4392 against one 26.6409 / 26.6260.
//     Unrolling the L1/L2 quad loop made kRows 16 spill and run slower.
//   * Past u=128 each CTA streams all of U from L2 every step (786 kB at
//     u=256), so the per-SM L2 rate and its latency bound the wide layers,
//     and a few rows use few SMs (u=512 at 16 rows: 16 CTAs); splitting
//     the units of a row over a cluster of CTAs is later work.
//   * Step: the lane forms the three gate partials of its group's kRows rows
//     over its slice, each U entry loaded once for all of them and h read as
//     float4 broadcasts from shared memory; the butterfly (xor 1, then xor
//     2) leaves each lane whole sums for kRows / kSl rows (two of the same
//     pair with kRows 4 and four slices, where lanes s and s ^ 2 agree and
//     s < 2 writes).  That lane then forms the row's input dot x_t W in
//     channel order (W and both bias rows in shared memory, x_t from the
//     staged tile), does the gate math, carries h in a register, writes h
//     to the other of two shared buffers (one barrier a step), and stores
//     seq[row, t, i] (and last at T-1).
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
constexpr int kMaxUnits = kMaxThreads;  // one slice a unit
constexpr int kTileUnits = 128;         // widest layer with 16 rows a CTA

// Rows a CTA may own at this width.
__host__ __device__ __forceinline__ int MaxRows(int units) {
  return units <= kTileUnits ? 16 : 4;
}

// The launch bound of a layout: 16 rows a group with U in registers is one
// group of at most 256 threads; 4 rows through L1/L2 serve the layers past
// u=128 with up to 1,024 threads (2u, or u with one slice).
__host__ __device__ constexpr int SeqThreads(int rows, bool u_regs) {
  return u_regs ? (rows >= 16 ? 256 : 512) : (rows == 4 ? kMaxThreads : 512);
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

// kRows rows a lane group (kSl u threads); ceil(bb / kRows) groups a CTA.
template <int kSl, int kRows, bool kURegs, bool kBf16>
__global__ void __launch_bounds__(SeqThreads(kRows, kURegs), 1)
SeqKernel(const Elem<kBf16> *__restrict__ x, int batch, int steps,
          int channels, const Elem<kBf16> *__restrict__ kernel,
          const float *__restrict__ bias,
          const Elem<kBf16> *__restrict__ recurrent, int units, int bb,
          int tile_steps, Elem<kBf16> *__restrict__ seq,
          Elem<kBf16> *__restrict__ last) {
  static_assert(kSl == 1 || kSl == 2 || kSl == 4, "kSl: 1, 2 or 4");
  static_assert(kRows % 2 == 0 && kRows / 2 >= (kSl == 4 ? 2 : kSl),
                "kRows: pairs enough for the butterfly");
  using IoT = Io<kBf16>;
  // The butterfly folds row pairs (as rnn_avg.cu folds a window's two
  // branches): a lane ends with kOwn pairs, kSl j + s, or with kRows 4 and
  // four slices the pair s & 1, which lanes s and s ^ 2 share.
  constexpr int kPairs = kRows / 2;
  constexpr int kOwn = kPairs >= kSl ? kPairs / kSl : 1;
  extern __shared__ float4 smem4[];
  const int width = 3 * units;
  const int hstride = Pad4(units);
  const int rows_pad = (bb + kRows - 1) / kRows * kRows;
  const int xstride = XStride(tile_steps, channels);
  float *s_h = reinterpret_cast<float *>(smem4);  // [2][rows_pad][hstride]
  float *s_w = s_h + 2 * rows_pad * hstride;     // [C][width]
  float *s_b = s_w + channels * width;           // [2][width]
  float *s_x = s_b + 2 * width;                  // [1 or 2][bb][xstride]

  const int tid = threadIdx.x;
  const int group = tid / (kSl * units);
  const int lane = tid - group * kSl * units;
  const int i = lane / kSl, s = lane % kSl;
  const int g0 = group * kRows;
  const int row0 = blockIdx.x * bb;
  for (int j = tid; j < 2 * rows_pad * hstride; j += blockDim.x) {
    s_h[j] = 0.0f;
  }
  for (int j = tid; j < channels * width; j += blockDim.x) {
    s_w[j] = ToOperand<kBf16>(kernel[j]);
  }
  for (int j = tid; j < 2 * width; j += blockDim.x) s_b[j] = bias[j];
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
  USlice<3, kURegs, kBf16, kSl, Elem<kBf16>> us;
  us.load(recurrent, units, i, s);
  const unsigned lanes = WarpLanes();
  const int n_quads = Pad4(units) / 4 > s
                          ? (Pad4(units) / 4 - s + kSl - 1) / kSl
                          : 0;
  int own_p[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    own_p[j] = kPairs >= kSl ? kSl * j + s : (s & 1);
  }
  const bool writer = kPairs >= kSl || s < 2;
  float h_own[kOwn][2] = {};
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int tt = t % tile_steps;
    // The other buffer was last read a tile ago, before the previous
    // step's barrier; this tile is read from the next tile on.
    if (tt == 0 && t + tile_steps < steps) stage(t + tile_steps);
    const float *h_cur =
        s_h + ((t & 1) * rows_pad + g0) * hstride;  // the group's rows
    float *h_nxt = s_h + ((t + 1) & 1) * rows_pad * hstride;

    // Partial gate dots of the group's rows over the lane's slice: each U
    // entry, loaded once, feeds kRows rows.
    float acc[kPairs][2][3] = {};
    auto quad = [&](int m) {
      const int q = s + kSl * m;
      float u_q[4][3];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int g = 0; g < 3; ++g) u_q[c][g] = us.at(m, c, g, s, units, i);
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

    // Reduce-scatter over the unit's kSl lanes: xor 1, then xor 2 (with
    // one pair left after xor 1, the second level is an all-reduce: a + b
    // == b + a, so lanes s and s ^ 2 hold the same bits).
    float dot[kOwn][2][3];
    if constexpr (kSl == 1) {
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int g = 0; g < 3; ++g) dot[p][b][g] = acc[p][b][g];
        }
      }
    } else if constexpr (kSl == 2) {
      FoldWindows<kPairs, 3>(acc, s & 1, 1, lanes, dot);
    } else if constexpr (kPairs >= 4) {
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
      if (!writer || r0 >= bb) continue;
      // x_t W in channel order, W's entries read once for both rows (the
      // second row may lie past bb: it reads the last row's x).
      const float *x_r[2] = {x_t + r0 * xstride,
                             x_t + min(r0 + 1, bb - 1) * xstride};
      float xg[2][3] = {};
      for (int c = 0; c < channels; ++c) {
        const float *w = s_w + c * width + i;
        const float w_c[3] = {w[0], w[units], w[2 * units]};
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
        const float *b_in = s_b + i;
        const float *b_rec = s_b + width + i;
        const float z = Sigmoid((xg[b][0] + b_in[0]) +
                                (dot[j][b][0] + b_rec[0]));
        const float rg = Sigmoid((xg[b][1] + b_in[units]) +
                                 (dot[j][b][1] + b_rec[units]));
        const float hh = tanhf((xg[b][2] + b_in[2 * units]) +
                               rg * (dot[j][b][2] + b_rec[2 * units]));
        float &h = h_own[j][b];
        h = z * h + (1.0f - z) * hh;
        h_nxt[r * hstride + i] = IoT::Operand(h);
        const int row = row0 + r;
        if (row < batch) {
          seq[(static_cast<size_t>(row) * steps + t) * units + i] =
              IoT::Store(h);
          if (t == steps - 1) {
            last[static_cast<size_t>(row) * units + i] = IoT::Store(h);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Steps a staged tile of x holds and the CTA's shared memory in bytes: the
// whole T when it fits within the card's opt-in limit a block, else the
// most that two buffers take; a CUDA error, or cudaErrorInvalidValue when
// not even one step fits.
cudaError_t SeqSmem(int units, int channels, int steps, int bb, int rows,
                    int *tile_steps, size_t *bytes) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t width = 3 * static_cast<size_t>(units);
  const size_t rows_pad = (bb + rows - 1) / rows * rows;
  const size_t base =
      sizeof(float) * (2 * rows_pad * Pad4(units) + (channels + 2) * width);
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

template <int kSl, int kRows, bool kURegs, bool kBf16>
int LaunchTile(const void *x, int batch, int steps, int channels,
               const void *kernel, const void *bias, const void *recurrent,
               int units, int bb, void *seq, void *last,
               cudaStream_t stream) {
  using T = Elem<kBf16>;
  const auto fn = SeqKernel<kSl, kRows, kURegs, kBf16>;
  const int threads = (bb + kRows - 1) / kRows * kSl * units;
  if (threads > SeqThreads(kRows, kURegs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile_steps = 0;
  size_t smem = 0;
  cudaError_t err =
      SeqSmem(units, channels, steps, bb, kRows, &tile_steps, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Above 48 kB a kernel only launches after this opt-in; a launch without
  // it is refused, and the refusal shows only in cudaGetLastError.
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<(batch + bb - 1) / bb, threads, smem, stream>>>(
      static_cast<const T *>(x), batch, steps, channels,
      static_cast<const T *>(kernel), static_cast<const float *>(bias),
      static_cast<const T *>(recurrent), units, bb, tile_steps,
      static_cast<T *>(seq), static_cast<T *>(last));
  return static_cast<int>(cudaGetLastError());
}

// The layout at this width and rows a CTA: {rows a lane group, slices a
// unit, U in registers}; false if the shape is refused.
bool Layout(int units, int bb, int *out) {
  if (units <= 0 || units > kMaxUnits || bb < 1 || bb > MaxRows(units)) {
    return false;
  }
  const bool small = bb <= 4;
  out[0] = small || units > kTileUnits ? 4 : units <= kRegUnits ? 8 : 16;
  out[1] = units <= kTileUnits ? 4 : units <= 512 ? 2 : 1;
  out[2] = units <= kRegUnits;
  return true;
}

template <bool kBf16>
int LaunchSeq(const void *x, int batch, int steps, int channels,
              const void *kernel, const void *bias, const void *recurrent,
              int units, int bb, void *seq, void *last, void *stream) {
  int layout[3];
  if (batch <= 0 || steps <= 0 || channels <= 0 ||
      !Layout(units, bb, layout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto fn) {
    return fn(x, batch, steps, channels, kernel, bias, recurrent, units, bb,
              seq, last, s);
  };
  if (layout[2]) {
    return layout[0] == 4 ? launch(LaunchTile<4, 4, true, kBf16>)
                          : launch(LaunchTile<4, 8, true, kBf16>);
  }
  if (layout[0] == 16) return launch(LaunchTile<4, 16, false, kBf16>);
  switch (layout[1]) {
    case 4: return launch(LaunchTile<4, 4, false, kBf16>);
    case 2: return launch(LaunchTile<2, 4, false, kBf16>);
    default: return launch(LaunchTile<1, 4, false, kBf16>);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 = launched).  `bb` is the rows a CTA owns (1 .. 16 up to u=128, 1 .. 4
// above).  bf16 != 0 selects bfloat16 IO (x, kernel, recurrent, seq,
// last); bias is float32 either way.
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
// out[0] rows a lane group, out[1] slices a unit, out[2] 1 if U sits in
// registers (0: read through L1/L2).  Returns the most rows a CTA may own
// at this width, or 0 if the shape is refused (out untouched).
int dg_gru_seq_layout(int units, int bb, int *out) {
  return Layout(units, bb, out) ? MaxRows(units) : 0;
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
