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
// float32, and avg and hidden are stored as bfloat16.
//
// Bound on this card.  Per window the recurrent products cost
// 2 rows x T x u x (g*u) multiply-adds (g = 3 GRU, 4 LSTM); at the flagship
// shape (T=342, u=60) that is 14.8 MFLOP (GRU) or 19.7 MFLOP (LSTM) per
// window against 82 kB of output, so the work is bound by float32
// arithmetic (the H100 has no float32 tensor-core path; TF32 would not be
// float32), not by the bytes.  The recurrence is sequential in T, so the
// parallelism is B x 2 x u.
//
// One kernel serves both cells (AvgKernel<kGates, ...>, the register tile;
// its building blocks, shared with rnn_seq.cu, are in rnn_tile.cuh).
// The first design ran one thread per (window, unit) over a k loop that
// issued 2 broadcast h loads and g U loads from shared memory for 2g
// FMAs: the step was bound by shared-memory wavefronts, no U element fed
// more than two rows, and U [u, g u] in shared memory capped the LSTM at
// u=113 (T=342).  Here each U element, loaded once into a register, feeds
// many rows:
//   * Tile: a CTA owns bb windows (2bb rows) for all T steps, bb chosen by
//     the caller from the batch and the SM count so the grid is one wave
//     (1024 windows on 132 SMs: bb=8, 128 CTAs; the CLI's default 256:
//     bb=2; the fixtures' 64: bb=1), at most 8 (2 above u=128).  Threads
//     come in lane groups of 4u: thread 4 i + s of a group owns unit i and
//     k-slice s (the float4 quads s, s+4, ... of the recurrent dot) for the
//     group's kWin windows; a CTA has ceil(bb / kWin) groups.
//   * Up to u=64 (kRegUnits) the lane keeps its slice of U (U[k, g u + i]
//     for its 16 k and the g gates: 48 floats GRU, 64 LSTM) in registers,
//     with kWin = 4 (bb=8: 2 groups, 480 threads, 15 warps an SM), or 2
//     when bb <= 2; wider layers read the slice through L1/L2 (one quad's
//     4g entries at a time), with kWin = 8 up to u=128 (4u threads) and 2
//     above (up to u=256, 1,024 threads).
//   * Step: the lane forms the g gate partials of its group's 2 kWin rows
//     over its slice, reading h as float4 broadcasts from shared memory
//     (kWin=4: 32 g FMAs a quad against 8 shared loads); a fixed butterfly
//     of shuffles (xor 1, then xor 2) reduce-scatters the sums, so lane s
//     ends with whole sums for its window's two rows; it does their gate
//     math, carries their h (and the LSTM's c) in registers, writes h to
//     the other of two shared buffers (one barrier a step) and stores the
//     branch average.  Ragged B: windows past the batch read pad codes and
//     store nothing; a group's windows past bb read the CTA's last window
//     (no branch in the dot) and their sums are dropped.
//   * Shared memory: the doubled h of bb windows twice, W [5, g u] and the
//     codes, 4 (4 bb Pad4(u) + 5 g u) + bb T bytes: the LSTM at u=128, bb=8,
//     T=342 takes 29,360 B; the width is bounded by the threads (4u <=
//     1,024: u <= 256) for both cells.
//   * Found on the H100 while choosing the GRU's tile: a branch on
//     the window count inside the dot made the step markedly slower (the
//     compiler could not interleave the windows' loads); 8 windows a group
//     with U in registers hit the 128-register cap and spilled, and so did
//     the register variants under a 1,024-thread bound (64 registers).
//   * The sums run in another order than the plain version's (four slices,
//     then the butterfly); its tolerance allows for that.
//   * The LSTM's tile, timed on the H100 (tools/avg_tile_sweep.py, f32,
//     T=342, ms a launch): at B=1024, u=60, kWin 4 with U in registers
//     (bb=8, 128 CTAs) 1.087, kWin 2 with U in registers 1.404 (bb=4, 256
//     CTAs) and 1.389 (bb=2, 512 CTAs), kWin 4 through L1/L2 1.645, kWin 8
//     through L1/L2 1.884; at B=256 (bb=2) kWin 2 with U in registers
//     0.491, through L1/L2 0.892, kWin 4 with U in registers at bb=4 (64
//     CTAs) 0.718; at u=96 kWin 8 (bb=8) 3.134 against kWin 4 (bb=4)
//     3.691; at u=128 kWin 8 5.056, kWin 4 6.088, kWin 2 (bb=2) 8.843.  So
//     the LSTM takes the GRU's tile: the 28 bytes its kWin 4 register
//     variant spills cost less than any other layout.
//   * ptxas -v (sm_90a, CUDA 12.8), float32 and bfloat16 alike but where
//     noted: GRU kWin 4 with U in registers 128 registers, kWin 2 with U in
//     registers 111, kWin 8 through L1/L2 126, kWin 2 through L1/L2 64 (4
//     bytes of spill stores and loads in float32); LSTM kWin 4 with U in
//     registers 128 (28 bytes of spill stores and loads), kWin 2 with U in
//     registers 126, kWin 8 through L1/L2 128, kWin 2 through L1/L2 64 (8
//     bytes of spills in bfloat16); nothing else spills.
//   * What bounds it: the FMA issue of the dot (the floor at 1024 x 342 x
//     60 on 128 SMs is about 0.23 ms GRU, 0.31 ms LSTM) plus the gate math
//     (960 rows x units an SM a step at bb=8; three transcendentals each
//     for the GRU, five for the LSTM), then the latency of the butterfly
//     and the barrier of each step.
// The bf16 variants keep U and h as float32 values already rounded to
// bfloat16, so they run the same float32 FMAs: their bound is the same work
// at the bf16 tensor-core rate, which this design does not reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_tile.cuh"

namespace {

constexpr int kCodes = 5;  // W rows: A, C, G, T, N; pad (5) selects none
constexpr int kPadCode = 5;
constexpr int kMaxThreads = 1024;
constexpr int kTileUnits = 128;  // widest layer with 8 windows a CTA
constexpr int kMaxUnits = kMaxThreads / kSlices;  // 256

__device__ __forceinline__ int Complement(int c) {
  return (c >= 0 && c < 4) ? 3 - c : c;  // A<->T, C<->G, N and pad kept
}

// Windows a CTA may own at this width.
__host__ __device__ __forceinline__ int MaxWindows(int units) {
  return units <= kTileUnits ? 8 : 2;
}

// The cell of unit i: its bias in registers and the Keras gate math of one
// row from the row's recurrent dots and its input row W[code] (w_row, read
// at g u; none for pad).
template <int kGates>
struct Cell;

// GRU (reset_after=True), bias [2, 3u] (input row, recurrent row); c unused.
template <>
struct Cell<3> {
  float b_in[3], b_rec[3];

  __device__ __forceinline__ void load(const float *__restrict__ bias,
                                       int units, int i) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      b_in[g] = bias[g * units + i];
      b_rec[g] = bias[3 * units + g * units + i];
    }
  }

  __device__ __forceinline__ void step(const float (&dot)[3],
                                       const float *w_row, bool has_w,
                                       int units, float &h,
                                       float & /*c*/) const {
    float x[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      x[g] = b_in[g];
      if (has_w) x[g] += w_row[g * units];
    }
    const float z = Sigmoid(x[0] + (dot[0] + b_rec[0]));
    const float r = Sigmoid(x[1] + (dot[1] + b_rec[1]));
    const float hh = tanhf(x[2] + r * (dot[2] + b_rec[2]));
    h = z * h + (1.0f - z) * hh;
  }
};

// LSTM, gates i, f, c, o, bias [4u].
template <>
struct Cell<4> {
  float b[4];

  __device__ __forceinline__ void load(const float *__restrict__ bias,
                                       int units, int i) {
#pragma unroll
    for (int g = 0; g < 4; ++g) b[g] = bias[g * units + i];
  }

  __device__ __forceinline__ void step(const float (&dot)[4],
                                       const float *w_row, bool has_w,
                                       int units, float &h, float &c) const {
    float x[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      x[g] = b[g];
      if (has_w) x[g] += w_row[g * units];
    }
    const float ig = Sigmoid(x[0] + dot[0]);
    const float fg = Sigmoid(x[1] + dot[1]);
    const float gg = tanhf(x[2] + dot[2]);
    const float og = Sigmoid(x[3] + dot[3]);
    c = fg * c + ig * gg;
    h = og * tanhf(c);
  }
};

// kWin windows a lane group (4u threads); ceil(bb / kWin) groups a CTA.
template <int kGates, int kWin, bool kURegs, bool kBf16>
__global__ void __launch_bounds__(kWin == 2 && !kURegs ? kMaxThreads
                                                       : kMaxThreads / 2,
                                  1)
AvgKernel(const int8_t *__restrict__ codes, int batch, int steps,
          const float *__restrict__ kernel, const float *__restrict__ bias,
          const float *__restrict__ recurrent, int units, int bb,
          typename Io<kBf16>::Out *__restrict__ avg,
          typename Io<kBf16>::Out *__restrict__ hidden) {
  static_assert(kWin == 2 || kWin == 4 || kWin == 8, "kWin: 2, 4 or 8");
  using IoT = Io<kBf16>;
  // Windows a lane owns after the butterfly: w0 + 4 j + s (kWin >= 4), or
  // w0 + (s & 1), shared by lanes s and s ^ 2 (kWin 2).
  constexpr int kOwn = kWin >= 4 ? kWin / 4 : 1;
  extern __shared__ float4 smem4[];
  const int width = kGates * units;
  const int hstride = Pad4(units);
  float *s_h = reinterpret_cast<float *>(smem4);  // [2 buffers][2bb][hstride]
  float *s_w = s_h + 4 * bb * hstride;           // [5][width]
  int8_t *s_codes = reinterpret_cast<int8_t *>(s_w + kCodes * width);

  const int tid = threadIdx.x;
  const int group = tid / (kSlices * units);
  const int lane = tid - group * kSlices * units;
  const int i = lane / kSlices, s = lane % kSlices;
  const int w0 = group * kWin;
  const int row0 = blockIdx.x * bb;
  for (int j = tid; j < 4 * bb * hstride; j += blockDim.x) s_h[j] = 0.0f;
  for (int j = tid; j < kCodes * width; j += blockDim.x) s_w[j] = kernel[j];
  for (int j = tid; j < bb * steps; j += blockDim.x) {
    const bool in_batch = row0 + j / steps < batch;
    s_codes[j] = in_batch ? codes[static_cast<size_t>(row0) * steps + j]
                          : static_cast<int8_t>(kPadCode);
  }
  USlice<kGates, kURegs, kBf16> us;
  us.load(recurrent, units, i, s);
  Cell<kGates> cell;
  cell.load(bias, units, i);
  const unsigned lanes = WarpLanes();
  const int n_quads = Pad4(units) / 4 > s
                          ? (Pad4(units) / 4 - s + kSlices - 1) / kSlices
                          : 0;
  int own_w[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    own_w[j] = w0 + (kWin >= 4 ? 4 * j + s : s & 1);
  }
  const bool writer = kWin >= 4 || s < 2;
  // The group's windows past the CTA's bb read the last one's rows (a
  // branch here would keep the compiler from interleaving the windows'
  // loads); their sums are dropped.
  int h_row[kWin];
#pragma unroll
  for (int w = 0; w < kWin; ++w) h_row[w] = 2 * min(w0 + w, bb - 1) * hstride;
  float h_own[kOwn][2] = {}, c_own[kOwn][2] = {};
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float *h_cur = s_h + (t & 1) * 2 * bb * hstride;
    float *h_nxt = s_h + ((t + 1) & 1) * 2 * bb * hstride;

    // Partial gate dots of the group's rows over the lane's slice: each U
    // entry, loaded once, feeds 2 kWin rows.
    float acc[kWin][2][kGates] = {};
    auto quad = [&](int m) {
      const int q = s + kSlices * m;
      float u_q[4][kGates];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int g = 0; g < kGates; ++g) {
          u_q[c][g] = us.at(m, c, g, s, units, i);
        }
      }
#pragma unroll
      for (int w = 0; w < kWin; ++w) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float4 h4 = reinterpret_cast<const float4 *>(
              h_cur + h_row[w] + b * hstride)[q];
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
    };
    if constexpr (kURegs) {
#pragma unroll
      for (int m = 0; m < kRegQuads; ++m) {
        if (m < n_quads) quad(m);
      }
    } else {
      for (int m = 0; m < n_quads; ++m) quad(m);
    }

    // Reduce-scatter over the unit's four lanes: xor 1, then xor 2 (for
    // kWin 2 the second level is an all-reduce: a + b == b + a, so lanes s
    // and s ^ 2 hold the same bits).
    float dot[kOwn][2][kGates];
    if constexpr (kWin >= 4) {
      float half[kWin / 2][2][kGates];
      FoldWindows<kWin, kGates>(acc, s & 1, 1, lanes, half);
      FoldWindows<kWin / 2, kGates>(half, (s >> 1) & 1, 2, lanes, dot);
    } else {
      FoldWindows<kWin, kGates>(acc, s & 1, 1, lanes, dot);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int g = 0; g < kGates; ++g) {
          dot[0][b][g] += __shfl_xor_sync(lanes, dot[0][b][g], 2);
        }
      }
    }

    // The gate math of the lane's windows, both branches.
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int w = own_w[j];
      if (!writer || w >= bb) continue;
      const int8_t *w_codes = s_codes + w * steps;
      const int code_b[2] = {w_codes[t], Complement(w_codes[steps - 1 - t])};
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const bool has_w = static_cast<unsigned>(code_b[b]) < kCodes;
        cell.step(dot[j][b], s_w + (has_w ? code_b[b] : 0) * width + i,
                  has_w, units, h_own[j][b], c_own[j][b]);
        h_nxt[(2 * w + b) * hstride + i] = IoT::Operand(h_own[j][b]);
      }
      const int row = row0 + w;
      if (row < batch) {
        const float mean = (h_own[j][0] + h_own[j][1]) * 0.5f;
        avg[(static_cast<size_t>(row) * steps + t) * units + i] =
            IoT::Store(mean);
        if (t == steps - 1) {
          hidden[static_cast<size_t>(row) * units + i] = IoT::Store(mean);
        }
      }
    }
    __syncthreads();
  }
}

template <int kGates, int kWin, bool kURegs, bool kBf16>
int LaunchTile(const void *codes, int batch, int steps, const void *kernel,
               const void *bias, const void *recurrent, int units, int bb,
               void *avg, void *hidden, cudaStream_t stream) {
  using Out = typename Io<kBf16>::Out;
  const auto fn = AvgKernel<kGates, kWin, kURegs, kBf16>;
  const int groups = (bb + kWin - 1) / kWin;
  const size_t smem =
      sizeof(float) * (4 * static_cast<size_t>(bb) * Pad4(units) +
                       static_cast<size_t>(kCodes) * kGates * units) +
      static_cast<size_t>(bb) * steps;
  // Above 48 kB a kernel only launches after this opt-in; a launch without
  // it is refused, and the refusal shows only in cudaGetLastError.
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<(batch + bb - 1) / bb, groups * kSlices * units, smem, stream>>>(
      static_cast<const int8_t *>(codes), batch, steps,
      static_cast<const float *>(kernel), static_cast<const float *>(bias),
      static_cast<const float *>(recurrent), units, bb,
      static_cast<Out *>(avg), static_cast<Out *>(hidden));
  return static_cast<int>(cudaGetLastError());
}

// The tile by width and windows a CTA (measured on the H100, see the note
// above): U in registers with 4 windows a lane group (2 when the CTA owns
// at most 2), U through L1/L2 with 8 windows, then 2 past u=128.
template <int kGates, bool kBf16>
int LaunchAvg(const void *codes, int batch, int steps, const void *kernel,
              const void *bias, const void *recurrent, int units, int bb,
              void *avg, void *hidden, void *stream) {
  if (batch <= 0 || steps <= 0 || units <= 0 || units > kMaxUnits ||
      bb < 1 || bb > MaxWindows(units)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (units <= kRegUnits) {
    return bb <= 2 ? LaunchTile<kGates, 2, true, kBf16>(
                         codes, batch, steps, kernel, bias, recurrent, units,
                         bb, avg, hidden, s)
                   : LaunchTile<kGates, 4, true, kBf16>(
                         codes, batch, steps, kernel, bias, recurrent, units,
                         bb, avg, hidden, s);
  }
  if (units <= kTileUnits) {
    return LaunchTile<kGates, 8, false, kBf16>(codes, batch, steps, kernel,
                                               bias, recurrent, units, bb,
                                               avg, hidden, s);
  }
  return LaunchTile<kGates, 2, false, kBf16>(codes, batch, steps, kernel,
                                             bias, recurrent, units, bb, avg,
                                             hidden, s);
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 = launched).
// `bb` is the windows a CTA owns (1 .. dg_avg_max_windows).
int dg_gru_avg(const void *codes, int batch, int steps, const void *kernel,
               const void *bias, const void *recurrent, int units, int bb,
               void *avg, void *hidden, void *stream) {
  return LaunchAvg<3, false>(codes, batch, steps, kernel, bias, recurrent,
                             units, bb, avg, hidden, stream);
}

int dg_lstm_avg(const void *codes, int batch, int steps, const void *kernel,
                const void *bias, const void *recurrent, int units, int bb,
                void *avg, void *hidden, void *stream) {
  return LaunchAvg<4, false>(codes, batch, steps, kernel, bias, recurrent,
                             units, bb, avg, hidden, stream);
}

// The bfloat16 fast mode: same arguments, avg and hidden bfloat16.
int dg_gru_avg_bf16(const void *codes, int batch, int steps,
                    const void *kernel, const void *bias,
                    const void *recurrent, int units, int bb, void *avg,
                    void *hidden, void *stream) {
  return LaunchAvg<3, true>(codes, batch, steps, kernel, bias, recurrent,
                            units, bb, avg, hidden, stream);
}

int dg_lstm_avg_bf16(const void *codes, int batch, int steps,
                     const void *kernel, const void *bias,
                     const void *recurrent, int units, int bb, void *avg,
                     void *hidden, void *stream) {
  return LaunchAvg<4, true>(codes, batch, steps, kernel, bias, recurrent,
                            units, bb, avg, hidden, stream);
}

// The most windows a CTA of the kernels of a cell with `gates` gates (3
// GRU, 4 LSTM) may own at this width (0: the shape is refused).
int dg_avg_max_windows(int gates, int units) {
  return (gates == 3 || gates == 4) && units > 0 && units <= kMaxUnits
             ? MaxWindows(units)
             : 0;
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
