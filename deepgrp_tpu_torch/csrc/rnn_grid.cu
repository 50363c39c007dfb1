// The recurrences past the cluster tiles' ceiling (u > 4096), for Hopper
// (sm_90a): the grid tile, a tiled product of every row's h_t with U a step
// with the gate math in its epilogue.
//
// Replaces, past u=4096, the TPU kernels of the JAX package:
//   * dg_avg_grid gates=3 (f32 / bf16 out)
//       <- deepgrp_tpu/models/pallas_rnn.py:178 _gru_avg_kernel
//          (pallas_gru_avg, :466)
//   * dg_avg_grid gates=4 (f32 / bf16 out)
//       <- deepgrp_tpu/models/pallas_rnn.py:309 _lstm_avg_kernel
//          (pallas_lstm_avg, :433)
//   * dg_seq_grid (f32 / bf16 IO)
//       <- deepgrp_tpu/models/pallas_rnn.py:43 _gru_kernel
//          (_pallas_gru :78, pallas_gru_apply :126)
// Contracts: those of rnn_avg.cu (codes int8 [B, T]; the doubled batch of
// forward rows and their reverse complements; the row select W[code] plus
// the input bias, pad code 5 the bias only; Keras gate math, the GRU with
// reset_after=True; avg [B, T, u] = (h_fwd + h_rev) / 2, hidden = avg at
// T-1) and of rnn_seq.cu (x [B, T, C] float32 or bfloat16, x W + b_in over
// the C channels, seq [B, T, u] and last [B, u] in x's type), as the plain
// versions in deepgrp_tpu_torch/models/rnn.py compute them.  Precision:
// float32 sums float32 FMAs (Precision.HIGHEST; no TF32); bf16 rounds h and
// U to bfloat16 for the recurrent dot, sums in float32 and keeps the carry,
// the gate math and the average in float32 (the TPU's DEFAULT precision).
//
// Why a tile of its own.  Every cluster tile (rnn_avg.cu, rnn_seq.cu) keeps
// a window's whole doubled h in each CTA of its cluster and streams all of
// U each step, once a cluster: past u~3600 U no longer fits the 50 MB L2,
// so each of the ~7 clusters at once reads it from HBM each step, and 16
// CTAs of 256 units stop at u=4096.  Here one step is one launch of a
// product of all the launch's rows with U, so U is read about once a step
// for all windows, and the width is bounded by device memory only.
//
// Bound on this card.  A step multiplies R rows (2B for the fused rows, B
// for row 7) by U [u, g u]: 2 R g u^2 FLOP, and U (g u^2 elements: 4 bytes
// in float32, 2 in bfloat16) does not fit on chip past u~3600 (50 MB of
// L2, ~30 MB of shared memory in all), so it is read from HBM each step:
// the bound is the larger of the FLOP over 67 TFLOP/s (f32 FMAs) and
// T |U| over 3.35 TB/s.  At B=16, T=342, u=4608 (f32 GRU) that is 20.8 ms
// of FLOP against 26.0 ms of U (87.1 GB).
//
// Design:
//   * The grid is (row blocks) x (unit blocks): a CTA owns kBlockRows rows
//     (for the fused rows 16 windows, each with both its branch rows, row
//     2w + branch, so the epilogue averages them) and kBlockUnits units,
//     with every gate's columns of those units (GRU z, r, h; LSTM i, f, c,
//     o), so the gate math is the product's epilogue.  Row blocks run
//     fastest in the grid, so the CTAs that run at once read the same
//     columns of U and share them through L2.
//   * U comes from the wrapper as a zero-padded copy [W][g][W] in the dot's
//     type (W = u rounded up to kBlockUnits; bf16: rounded to nearest even,
//     as torch rounds), so every tile is whole and 16-byte aligned, and
//     bf16 halves the stream.  h lives in two global buffers [W][R'] (R'
//     the rows rounded up to kBlockRows), k-major, holding the dot's
//     operand (rounded in bf16); the carried f32 h and the LSTM's c sit in
//     a carry buffer [2][W][R'] that only the owner of a (row, unit) reads
//     and writes.  The wrapper zeroes all three, so padded rows and columns
//     stay zero and add nothing.
//   * K runs in tiles of kBlockK through a ring of kStages shared-memory
//     stages filled by cp.async (16 bytes a copy, U and h both).  The CTA's
//     256 threads are kSplit k-slices of 64: slice s sums k = 32 i + 8 s +
//     j of every tile i in order, each thread 4 rows x 4 units x g gates
//     (one float4 of h and g float4s of U a k for 16 g FMAs); the slices'
//     sums are then added in slice order through shared memory.  Every
//     (row, unit) sum thus runs in an order fixed by u alone: a window's
//     bits do not depend on the batch, its place, or the launch (no
//     atomics, no split that depends on B).
//   * The epilogue (slice 0's threads): the input term (the row select, or
//     x W over the channels in channel order), the gate math of
//     rnn_avg.cu's Cell / rnn_seq.cu's step, the new h into the other h
//     buffer and the carry, and the outputs.
//   * The time loop runs on the host inside the C entry point: T launches
//     on the caller's stream, each checked with cudaGetLastError; nothing
//     is allocated and nothing synchronises, so a stream capture records
//     the T launches.
//   * Offsets into U, h, the carry and the outputs are size_t: g u^2 passes
//     2^31 at u=26,755 (GRU) and 23,171 (LSTM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_tile.cuh"

namespace {

constexpr int kBlockRows = 32;   // rows a CTA (16 windows of 2 branch rows)
constexpr int kBlockUnits = 32;  // units a CTA, all their gates
constexpr int kBlockK = 32;      // k a stage
constexpr int kSplit = 4;        // k-slices of a CTA
constexpr int kThreads = 256;    // kSplit slices of 64
constexpr int kStages = 3;
constexpr int kThreadRows = 4;   // rows a thread
constexpr int kThreadUnits = 4;  // units a thread (each with all gates)
constexpr int kSliceThreads = kThreads / kSplit;
// The widest layer: the grid's y dimension holds at most 65,535 unit
// blocks.
constexpr long long kGridMaxUnits = 65535LL * kBlockUnits;

static_assert(kSliceThreads * kThreadRows * kThreadUnits ==
                  kBlockRows * kBlockUnits,
              "a slice's threads cover the CTA's tile");
static_assert(kBlockK * kBlockRows / 4 == kThreads,
              "one 16-byte copy of h a thread a stage");
static_assert(kBlockUnits == kBlockK, "U is padded alike on both sides");

__host__ __device__ constexpr long long RoundUp(long long n, long long to) {
  return (n + to - 1) / to * to;
}

// The arguments of a step, the same for all T launches.
struct GridArgs {
  const int8_t *codes;   // fused rows: [B, T]
  const void *x;         // row 7: [B, T, C] in the IO type
  const void *kernel;    // fused rows: float [5, g u]; row 7: [C, 3u]
  const float *bias;     // GRU [2, 3u] (input, recurrent), LSTM [4u]
  const void *recurrent; // the padded U [W][g][W] in the dot's type
  float *carry;          // [2][W][R']: the carried h, the LSTM's c
  void *out;             // avg or seq [B, T, u]
  void *last;            // hidden or last [B, u]
  int batch, steps, channels, units;
  int width;             // W
  int rows;              // R'
};

__device__ __forceinline__ void CpAsync16(void *smem, const void *gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void CpAsyncCommit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void CpAsyncWait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Four consecutive U entries of shared memory as floats.
__device__ __forceinline__ void LoadU4(const float *p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4 *>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void LoadU4(const __nv_bfloat16 *p,
                                       float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2 *>(p);
  // A bfloat16 is the high half of its float32.
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ float AsFloat(float v) { return v; }
__device__ __forceinline__ float AsFloat(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int kGates, bool kBf16>
__host__ __device__ constexpr size_t StageBytes() {
  return static_cast<size_t>(kBlockK) * kGates * kBlockUnits *
             sizeof(typename Io<kBf16>::Out) +
         static_cast<size_t>(kBlockK) * kBlockRows * sizeof(float);
}

// Dynamic shared memory of a CTA: the ring of stages, which the slices'
// sums reuse after the last tile.
template <int kGates, bool kBf16>
__host__ __device__ constexpr size_t GridSmem() {
  const size_t ring = kStages * StageBytes<kGates, kBf16>();
  const size_t sums = static_cast<size_t>(kSplit - 1) * 16 * kGates *
                      kSliceThreads * sizeof(float);
  return ring > sums ? ring : sums;
}

// One step t of the recurrence for the CTA's rows and units: h_cur (the
// dot's operand at step t) in, h_next out.  kSeq: row 7 (x W over C
// channels, seq and last out); else the fused rows (codes, avg and hidden
// out).
template <int kGates, bool kBf16, bool kSeq>
__global__ void __launch_bounds__(kThreads, 2)
    GridStepKernel(const GridArgs a, const int t,
                   const float *__restrict__ h_cur,
                   float *__restrict__ h_next) {
  using TU = typename Io<kBf16>::Out;  // U's type, and the output's
  constexpr size_t kUBytes =
      static_cast<size_t>(kBlockK) * kGates * kBlockUnits * sizeof(TU);
  constexpr size_t kStage = StageBytes<kGates, kBf16>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int slice = tid / kSliceThreads, own = tid % kSliceThreads;
  const int ug = own % (kBlockUnits / kThreadUnits);
  const int rg = own / (kBlockUnits / kThreadUnits);
  const int r0 = blockIdx.x * kBlockRows;
  const int n0 = blockIdx.y * kBlockUnits;
  const size_t width = a.width, rows = a.rows;
  const TU *__restrict__ u_mat = static_cast<const TU *>(a.recurrent);
  const int n_tiles = a.width / kBlockK;

  const auto load_tile = [&](int stage, int tile) {
    unsigned char *base = smem + stage * kStage;
    TU *s_u = reinterpret_cast<TU *>(base);
    float *s_h = reinterpret_cast<float *>(base + kUBytes);
    const size_t k0 = static_cast<size_t>(tile) * kBlockK;
    constexpr int kPer = 16 / sizeof(TU);  // elements a copy
    constexpr int kRowCopies = kBlockUnits / kPer;
    constexpr int kCopies = kBlockK * kGates * kRowCopies;
#pragma unroll
    for (int c = tid; c < kCopies; c += kThreads) {
      const int kk = c / (kGates * kRowCopies);
      const int rest = c % (kGates * kRowCopies);
      const int g = rest / kRowCopies, piece = rest % kRowCopies;
      CpAsync16(s_u + (kk * kGates + g) * kBlockUnits + piece * kPer,
                u_mat + ((k0 + kk) * kGates + g) * width + n0 +
                    piece * kPer);
    }
    const int kk = tid / (kBlockRows / 4), piece = tid % (kBlockRows / 4);
    CpAsync16(s_h + kk * kBlockRows + piece * 4,
              h_cur + (k0 + kk) * rows + r0 + piece * 4);
  };

  float acc[kThreadRows][kGates][kThreadUnits] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    CpAsyncCommit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    CpAsyncWait<kStages - 2>();
    __syncthreads();  // the tile landed; every slice is done with tile-1
    const int next = tile + kStages - 1;
    if (next < n_tiles) load_tile(next % kStages, next);
    CpAsyncCommit();
    const unsigned char *base = smem + (tile % kStages) * kStage;
    const TU *s_u = reinterpret_cast<const TU *>(base);
    const float *s_h = reinterpret_cast<const float *>(base + kUBytes);
#pragma unroll
    for (int j = 0; j < kBlockK / kSplit; ++j) {
      const int kk = slice * (kBlockK / kSplit) + j;
      const float4 hq = *reinterpret_cast<const float4 *>(
          s_h + kk * kBlockRows + kThreadRows * rg);
      const float h[kThreadRows] = {hq.x, hq.y, hq.z, hq.w};
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        float u[kThreadUnits];
        LoadU4(s_u + (kk * kGates + g) * kBlockUnits + kThreadUnits * ug, u);
#pragma unroll
        for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
          for (int n = 0; n < kThreadUnits; ++n) {
            acc[r][g][n] = fmaf(h[r], u[n], acc[r][g][n]);
          }
        }
      }
    }
  }
  CpAsyncWait<0>();
  __syncthreads();  // the ring is free for the slices' sums

  // The slices' sums, added in slice order.
  constexpr int kAcc = kThreadRows * kGates * kThreadUnits;
  float *sums = reinterpret_cast<float *>(smem);
  if (slice > 0) {
    float *mine = sums + (slice - 1) * kAcc * kSliceThreads + own;
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
#pragma unroll
        for (int n = 0; n < kThreadUnits; ++n) {
          mine[((r * kGates + g) * kThreadUnits + n) * kSliceThreads] =
              acc[r][g][n];
        }
      }
    }
  }
  __syncthreads();
  if (slice != 0) return;
  for (int s = 1; s < kSplit; ++s) {
    const float *theirs = sums + (s - 1) * kAcc * kSliceThreads + own;
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
#pragma unroll
        for (int n = 0; n < kThreadUnits; ++n) {
          acc[r][g][n] +=
              theirs[((r * kGates + g) * kThreadUnits + n) * kSliceThreads];
        }
      }
    }
  }

  // The epilogue: the gate math of the thread's rows and units.
  const int units = a.units, steps = a.steps, batch = a.batch;
  const size_t plane = width * rows;
  TU *out = static_cast<TU *>(a.out);
  TU *last = static_cast<TU *>(a.last);
#pragma unroll
  for (int n = 0; n < kThreadUnits; ++n) {
    const int un = n0 + kThreadUnits * ug + n;
    if (un >= units) break;
    if constexpr (kSeq) {
      const TU *x = static_cast<const TU *>(a.x);
      const TU *kernel = static_cast<const TU *>(a.kernel);
      const float *b_in = a.bias + un;
      const float *b_rec = a.bias + 3 * static_cast<size_t>(units) + un;
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        const int row = r0 + kThreadRows * rg + r;
        if (row >= batch) break;
        // x_t W in channel order, then the Keras GRU (reset_after=True).
        const TU *x_t =
            x + (static_cast<size_t>(row) * steps + t) * a.channels;
        float xg[3] = {};
        for (int c = 0; c < a.channels; ++c) {
          const float v = AsFloat(x_t[c]);
          const TU *w = kernel + static_cast<size_t>(c) * 3 * units + un;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            xg[g] = fmaf(v, AsFloat(w[static_cast<size_t>(g) * units]),
                         xg[g]);
          }
        }
        const size_t at = static_cast<size_t>(un) * rows + row;
        float h = a.carry[at];
        const float z = Sigmoid((xg[0] + b_in[0]) + (acc[r][0][n] + b_rec[0]));
        const float reset = Sigmoid((xg[1] + b_in[units]) +
                                    (acc[r][1][n] + b_rec[units]));
        const float hh = tanhf((xg[2] + b_in[2 * units]) +
                               reset * (acc[r][2][n] + b_rec[2 * units]));
        h = z * h + (1.0f - z) * hh;
        a.carry[at] = h;
        h_next[at] = Io<kBf16>::Operand(h);
        const size_t o = static_cast<size_t>(row) * units + un;
        out[(static_cast<size_t>(row) * steps + t) * units + un] =
            Io<kBf16>::Store(h);
        if (t == steps - 1) last[o] = Io<kBf16>::Store(h);
      }
    } else {
      const float *kernel = static_cast<const float *>(a.kernel);
      const size_t cols = static_cast<size_t>(kGates) * units;
#pragma unroll
      for (int q = 0; q < kThreadRows / 2; ++q) {
        const int w = (r0 + kThreadRows * rg) / 2 + q;
        if (w >= batch) break;
        float mean = 0.0f;
#pragma unroll
        for (int branch = 0; branch < 2; ++branch) {
          const int r = 2 * q + branch;
          const int row = 2 * w + branch;
          const size_t at_code =
              static_cast<size_t>(w) * steps +
              (branch == 0 ? t : steps - 1 - t);
          const int code = branch == 0 ? a.codes[at_code]
                                       : Complement(a.codes[at_code]);
          const bool has_w = static_cast<unsigned>(code) < 5u;
          const float *w_row = kernel + (has_w ? code : 0) * cols + un;
          const size_t at = static_cast<size_t>(un) * rows + row;
          float h = a.carry[at];
          float x[kGates];
          if constexpr (kGates == 3) {
            // Keras GRU, reset_after=True: bias [2, 3u].
            float b_rec[3];
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              x[g] = a.bias[g * static_cast<size_t>(units) + un];
              if (has_w) x[g] += w_row[g * static_cast<size_t>(units)];
              b_rec[g] = a.bias[(3 + g) * static_cast<size_t>(units) + un];
            }
            const float z = Sigmoid(x[0] + (acc[r][0][n] + b_rec[0]));
            const float rr = Sigmoid(x[1] + (acc[r][1][n] + b_rec[1]));
            const float hh = tanhf(x[2] + rr * (acc[r][2][n] + b_rec[2]));
            h = z * h + (1.0f - z) * hh;
          } else {
            // LSTM, gates i, f, c, o: bias [4u].
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              x[g] = a.bias[g * static_cast<size_t>(units) + un];
              if (has_w) x[g] += w_row[g * static_cast<size_t>(units)];
            }
            float &c = a.carry[plane + at];
            const float ig = Sigmoid(x[0] + acc[r][0][n]);
            const float fg = Sigmoid(x[1] + acc[r][1][n]);
            const float gg = tanhf(x[2] + acc[r][2][n]);
            const float og = Sigmoid(x[3] + acc[r][3][n]);
            c = fg * c + ig * gg;
            h = og * tanhf(c);
          }
          a.carry[at] = h;
          h_next[at] = Io<kBf16>::Operand(h);
          mean += h;
        }
        mean *= 0.5f;
        out[(static_cast<size_t>(w) * steps + t) * units + un] =
            Io<kBf16>::Store(mean);
        if (t == steps - 1) {
          last[static_cast<size_t>(w) * units + un] = Io<kBf16>::Store(mean);
        }
      }
    }
  }
}

// {W, R', row blocks, unit blocks} for `rows` rows of width `units`; false
// if the shape is refused.
bool Shape(long long rows, long long units, long long *out) {
  if (rows < 1 || units < 1 || units > kGridMaxUnits) return false;
  out[0] = RoundUp(units, kBlockUnits);
  out[1] = RoundUp(rows, kBlockRows);
  out[2] = out[1] / kBlockRows;
  out[3] = out[0] / kBlockUnits;
  return true;
}

// The T launches of one call on `stream`; the first error, else 0.
template <int kGates, bool kBf16, bool kSeq>
int RunGrid(GridArgs a, long long rows, void *h0, void *h1, void *stream) {
  long long shape[4];
  if (a.batch < 1 || a.steps < 1 || !Shape(rows, a.units, shape)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.width = static_cast<int>(shape[0]);
  a.rows = static_cast<int>(shape[1]);
  const auto fn = GridStepKernel<kGates, kBf16, kSeq>;
  constexpr size_t smem = GridSmem<kGates, kBf16>();
  // Above 48 kB a kernel only launches after this opt-in.
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(shape[2]),
                  static_cast<unsigned>(shape[3]));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *h[2] = {static_cast<float *>(h0), static_cast<float *>(h1)};
  for (int t = 0; t < a.steps; ++t) {
    fn<<<grid, kThreads, smem, s>>>(a, t, h[t & 1], h[(t + 1) & 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// The fused rows past the cluster tiles (1, 2; bf16 != 0: 1b, 2b): codes
// int8 [B, T]; kernel float [5, g u]; bias float (GRU [2, 3u], LSTM [4u]);
// recurrent the zero-padded U [W][g][W] (float32, or bfloat16 for bf16);
// h0, h1 float [W][R'] and carry float [2][W][R'], zeroed (R' for 2B
// rows: dg_grid_shape); avg [B, T, u] and hidden [B, u] (float32 or
// bfloat16).  T launches on `stream`; returns the first launch's error (0 =
// launched).
int dg_avg_grid(int gates, int bf16, const void *codes, int batch,
                int steps, const void *kernel, const void *bias,
                const void *recurrent, int units, void *h0, void *h1,
                void *carry, void *avg, void *hidden, void *stream) {
  GridArgs a{};
  a.codes = static_cast<const int8_t *>(codes);
  a.kernel = kernel;
  a.bias = static_cast<const float *>(bias);
  a.recurrent = recurrent;
  a.carry = static_cast<float *>(carry);
  a.out = avg;
  a.last = hidden;
  a.batch = batch;
  a.steps = steps;
  a.units = units;
  const long long rows = 2LL * batch;
  if (gates == 3) {
    return bf16 ? RunGrid<3, true, false>(a, rows, h0, h1, stream)
                : RunGrid<3, false, false>(a, rows, h0, h1, stream);
  }
  if (gates == 4) {
    return bf16 ? RunGrid<4, true, false>(a, rows, h0, h1, stream)
                : RunGrid<4, false, false>(a, rows, h0, h1, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Row 7 past the cluster tile: x [B, T, C], kernel [C, 3u] and the padded
// recurrent [W][3][W] in the IO type (bf16 != 0: bfloat16), bias float
// [2, 3u]; h0, h1, carry as dg_avg_grid's for B rows; seq [B, T, u] and
// last [B, u] in the IO type.
int dg_seq_grid(int bf16, const void *x, int batch, int steps, int channels,
                const void *kernel, const void *bias, const void *recurrent,
                int units, void *h0, void *h1, void *carry, void *seq,
                void *last, void *stream) {
  if (channels < 1) return static_cast<int>(cudaErrorInvalidValue);
  GridArgs a{};
  a.x = x;
  a.kernel = kernel;
  a.bias = static_cast<const float *>(bias);
  a.recurrent = recurrent;
  a.carry = static_cast<float *>(carry);
  a.out = seq;
  a.last = last;
  a.batch = batch;
  a.steps = steps;
  a.channels = channels;
  a.units = units;
  return bf16 ? RunGrid<3, true, true>(a, batch, h0, h1, stream)
              : RunGrid<3, false, true>(a, batch, h0, h1, stream);
}

// out[0] W (u padded to whole unit blocks: U's rows and columns, h's k),
// out[1] R' (the rows padded to whole row blocks), out[2] row blocks,
// out[3] unit blocks (the grid); returns 0 if the shape is refused.
int dg_grid_shape(int rows, int units, long long *out) {
  return Shape(rows, units, out) ? 1 : 0;
}

// out: rows a CTA, units a CTA, k a stage, k-slices, threads a CTA,
// stages, rows a thread, units a thread.
void dg_grid_layout(int *out) {
  out[0] = kBlockRows;
  out[1] = kBlockUnits;
  out[2] = kBlockK;
  out[3] = kSplit;
  out[4] = kThreads;
  out[5] = kStages;
  out[6] = kThreadRows;
  out[7] = kThreadUnits;
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
