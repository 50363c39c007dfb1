// The recurrences past the cluster tiles' ceilings, for Hopper (sm_90a):
// the grid tile, a tiled product of every row's h_t with U a step with the
// gate math in its epilogue; in training also the backward's products
// (see "Training" below).  models/cuda_rnn.py routes here the float32
// fused rows and the GRU sequence kernel with float32 IO past u=1024, the
// bf16 fused rows past u=1279, the GRU sequence kernel with bf16 IO past
// u=767 and training from u=1024: the widths at which this tile was as
// fast as the cluster tiles or faster at every batch swept
// (tools/avg_tile_sweep.py --grid, tools/train_tile_sweep.py --grid; the
// figures are beside those widths in models/cuda_rnn.py).
//
// Replaces, at those widths, the TPU kernels of the JAX package:
//   * dg_avg_grid gates=3 (f32 / bf16 out)
//       <- deepgrp_tpu/models/pallas_rnn.py:178 _gru_avg_kernel
//          (pallas_gru_avg, :466)
//   * dg_avg_grid gates=4 (f32 / bf16 out)
//       <- deepgrp_tpu/models/pallas_rnn.py:309 _lstm_avg_kernel
//          (pallas_lstm_avg, :433)
//   * dg_seq_grid (f32 / bf16 IO)
//       <- deepgrp_tpu/models/pallas_rnn.py:43 _gru_kernel
//          (_pallas_gru :78, pallas_gru_apply :126)
//   * dg_gru_train_fwd_grid, dg_lstm_train_fwd_grid
//       <- deepgrp_tpu/models/pallas_rnn_train.py:97 _gru_train_fwd_kernel,
//          :496 _lstm_train_fwd_kernel
//   * dg_gru_bwd_grid, dg_lstm_bwd_grid (then rnn_train.cu's
//     dg_train_reduce)
//       <- deepgrp_tpu/models/pallas_rnn_train.py:135
//          _gru_train_bwd_kernel, :542 _lstm_train_bwd_kernel (custom VJPs
//          :422-474, :806-855)
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
// Why a tile of its own.  Every cluster tile (rnn_avg.cu, rnn_seq.cu,
// rnn_train.cu) keeps a window's whole doubled h in each CTA of its
// cluster and streams all of U each step, once a cluster (past u~3600 U
// no longer fits the 50 MB L2, so each of the ~7 clusters at once reads
// it from HBM each step), and 16 CTAs of 64 units stop at u=1024.  Here
// one step is one launch of a product of all the launch's rows with U, so
// U is read about once a step for all windows, and the width is bounded
// by device memory only.
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
//     the rows rounded up to kBlockRows), k-major (the bf16 step: [R'][W],
//     bf16); the carried h and the LSTM's c sit in a float32 carry buffer
//     [2][W][R'] that only the owner of a (row, unit) reads and writes.
//     The wrapper zeroes all three, so padded rows and columns stay zero
//     and add nothing.
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
//   * The float32 step (GridStepKernel) is described above; the bf16 step
//     (GridMmaKernel) below.
//
// The bf16 step (rows 1b, 2b, and row 7 with bf16 IO; GridMmaKernel).  The
// same step as the float32 one, with the product on the tensor cores:
// mma.sync.aligned.m16n8k16 (rnn_mma.cuh), h and U as bf16 operands
// straight from shared memory (ldmatrix, ldmatrix.trans), float32 sums,
// never widened before the product.
//   * Bound on this card: 2 R g u^2 FLOP a step at 989 TFLOP/s (bf16
//     tensor cores), and U (2 g u^2 bytes) from L2, or past u~3600 from
//     HBM, each step.  At B=64, T=342, u=4608 (GRU): 5.64 ms of FLOP, 127
//     MB of U a step.
//   * h lives in bf16: two buffers [R'][W] row-major (the A operand's
//     layout; the wrapper allocates them in the dot's type), the float32
//     carry (h, the LSTM's c) in [2][R'][W] that only the owner of a
//     (row, unit) reads and writes.  U is the wrapper's bf16 copy
//     [W][g][W], streamed in 2 bytes.
//   * A CTA owns 128 rows (8 m16 tiles: 64 windows) so that U streams
//     about once a step for B <= 64 (4 times at B=256), and 32 units with
//     all their gates, or 16 where 32 would leave SMs idle (MmaUnits: the
//     grid of 32 has fewer CTAs than the card has SMs; at u=2049, B=64,
//     130 CTAs of 16 against 65 of 32).  A warp owns 32 rows x 16 units
//     (2 m16 x 2 n8 tiles a gate); a warp whose rows are all padding
//     does no product.
//   * Rows: for the fused rows an m16 tile holds 8 windows, their forward
//     rows in rows 0-7 and their reverse-complement rows in 8-15
//     (MmaWindow), so the accumulator gives a lane (rows l/4 and l/4 + 8)
//     both branches of a window and the average forms in registers.
//     Columns: each gate's n8 tile covers the same 8 units, so a lane
//     holds every gate of its (row, unit) cells (as MmaAvgKernel in
//     rnn_avg.cu).
//   * K runs in tiles of 32 through a ring of 4 shared-memory stages filled
//     by cp.async (16 bytes a copy), U's tile [g][32][units + 8] and h's
//     [128][32 + 8] (16 bytes of pad a row: ldmatrix's 8 rows fall in 8
//     bank groups).  Each (row, unit) sum runs over the k-tiles in order,
//     an order fixed by u alone (no atomics, no split of K): a window's
//     bits do not depend on the batch, its place or the launch.
//   * The epilogue: the input rows (bias + W[code], the pad's bias; the
//     GRU's recurrent bias; row 7's biases) come from a table of the
//     CTA's units in shared memory filled before the product; for each
//     m16 tile the carry, the codes and row 7's x W (channel order) are
//     loaded before any store; then GridStepKernel's gate math, the
//     carry, h_next in bf16 and the outputs.
//   * ptxas -v (sm_90a, CUDA 12.8): GridMmaKernel<3, fused, 16 / 32> 124
//     / 124 registers, <4, fused, 16 / 32> 126 / 126, <3, row 7, 16 / 32>
//     128 / 128; no spills.
//   * What bounds it (tools/avg_bf16_ablation.py --grid: edited copies on
//     an NVIDIA H100 80GB HBM3 at 700 W): not the products and not HBM.
//     At B=64, u=4608 (GRU, 47.07 ms) the step without its cp.async copies
//     past the first stages takes 0.525x the time, without the mma 0.887x,
//     with U read only from its first 256 k rows (L2) 0.959x, with 5
//     stages 1.009x.  A CTA's 144 k-tiles run one after the other, each a
//     wait on copies issued three tiles before, a barrier and a dependent
//     mma chain of 2 k16 steps: that chain, and the 12 SMs that hold two
//     of the 144 CTAs, bound the step.
//
// Training (rows 3-6 from u=1024; rnn_train.cu's contract: masked input
// rows, hseq (cseq) kept for the backward, the backward's gate cotangents
// summed by its dg_train_reduce).  All float32.
//   * The forward (GridTrainFwdKernel) is the fused step above with the
//     masked input row in the epilogue and hseq (cseq) stored, each branch
//     row in its own time order; T launches.
//   * The backward's (A), GridRecomputeKernel, one launch: the recurrent
//     preactivations h_prev U of all 2B T rows (h_prev = hseq one step
//     back, zero at t = 0) as one product, with the forward's tiles,
//     slices and order (TileDot), so they carry the forward's bits.  It
//     writes them into the d_xp (GRU) or da (LSTM) buffer: the owner of a
//     (row, unit) at step t reads that unit's gates there in (B) and then
//     writes its cotangents in their place, so no buffer is added.  One
//     product of 2B T rows fills the card far better than T products of 2B
//     (197k CTAs at B=64, T=342, u=4608 against 576 a step), which is why
//     (B) does not recompute.
//   * The backward's (B), GridBwdStepKernel, T launches in reverse time:
//     dh of each (row, unit) as the product of step t+1's gate cotangents
//     (GRU d_rp, LSTM da) with a zero-padded U^T [g][W][W] (K = g W), then
//     the cotangent math of rnn_train.cu's header in the epilogue for
//     every gate of the unit; a carry passes dh z (GRU) or dc f (LSTM) to
//     step t-1; step T-1 seeds dh with d_hidden / 2.  A CTA owns 32 rows
//     and 1-4 blocks of 32 units (the caller's count: grid_bwd_groups
//     of models/cuda_rnn.py, from the CTAs a step against the SMs),
//     each thread 4 rows x 4
//     units of each block (16-64 sums); the epilogue also writes the
//     cotangents k-major into a ping-pong [2][g W][R'] that the next
//     step stages with 16-byte copies, as the forward stages h.
//   * (A) reads hseq row-major, so a gather stages it k-major with 4-byte
//     cp.async copies that write zeros past the rows and the width
//     (Gather), into a stage padded to 36 floats a k so a warp's copies
//     meet no bank conflict.
//   * Every sum runs in an order fixed by u: a window's bits do not depend
//     on the batch, its place, (B)'s blocks a CTA or the launch; no
//     atomics.
//   * Bound: the forward does the inference step's FLOP, the backward
//     three times as many (A, B and the reduction's dU).
//   * What held (B) back, and the redesign (tools/train_tile_sweep.py
//     --ablate: edited copies, each checked against the plain recurrence
//     and bitwise equal to the shipped one; NVIDIA H100 80GB HBM3 at
//     700 W; ms of (B) at B=64, T=342, u=4608, GRU / LSTM).  The first
//     design, one block of 32 units a CTA (16 sums a thread, 2 FMAs a
//     float loaded from shared memory) with A gathered in 4-byte copies
//     from the row-major cotangents, took 380.13 / 461.39 (2.0 / 1.8x
//     the forward's step; this kernel so edited 356.84 / 468.44); the
//     same tile with the 16-byte k-major copies 257.47 / 343.65: the
//     gather was the larger cause (1.39 / 1.36x).
//     With those copies, 1-4 blocks a CTA took 257.47 / 257.08 / 213.23
//     / 285.12 (GRU): 3 blocks (48 sums, 3 FMAs a float, the forward's
//     ratio) fill the 132 SMs with 192 CTAs, 4 leave 12 SMs two of 144.
//     grid_bwd_groups (models/cuda_rnn.py) estimates each count's time
//     from the CTAs a step against the SMs; it picks 3 there (213.23 / 278.92: 1.12 / 1.09x the
//     forward's 189.70 / 255.58), 2 at B=256, u=1024 (44.02 against 1
//     block's 51.93), 1 at B=16, u=4096 (77.50; 4 blocks 190.83).
//   * ptxas -v (sm_90a, CUDA 12.8): GridBwdStepKernel<g, 1-4 blocks> 87 /
//     91 / 113 / 127 registers, either cell; no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_mma.cuh"
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

template <int kGates, int kAStride = kBlockRows>
__host__ __device__ constexpr size_t StageBytes() {
  return static_cast<size_t>(kBlockK) * (kGates * kBlockUnits + kAStride) *
         sizeof(float);
}

// Dynamic shared memory of a CTA: the ring of stages, which the slices'
// sums reuse after the last tile.
template <int kGates, int kAStride = kBlockRows>
__host__ __device__ constexpr size_t GridSmem() {
  const size_t ring = kStages * StageBytes<kGates, kAStride>();
  const size_t sums = static_cast<size_t>(kSplit - 1) * 16 * kGates *
                      kSliceThreads * sizeof(float);
  return ring > sums ? ring : sums;
}

// The CTA's tile of one product (GridStepKernel's loop, which that kernel
// keeps written out so that its machine code stays as it was): acc[r][g][n]
// = sum over k of A[row, k]
// B[k][g][unit] for its kBlockRows rows and kBlockUnits units (with every
// gate g of B), k in n_tiles tiles of kBlockK.  B is a zero-padded matrix
// [n_tiles kBlockK][kGates][width] of TU; load_a(s_a, tile) issues the
// cp.async copies that stage the tile's A k-major (s_a[kk kAStride + r]).
// Slice s of the 256 threads sums k = 32 i + 8 s + j of every tile i in
// order, the slices' sums are then added in slice order: each sum runs in
// an order fixed by the tile count alone.  Returns true in the threads of
// slice 0, which then hold the sums of their rows and units.
template <int kGates, int kAStride, typename TU, typename LoadA>
__device__ __forceinline__ bool TileDot(
    unsigned char *smem, const TU *__restrict__ b_mat, size_t width, int n0,
    int n_tiles, const LoadA &load_a,
    float (&acc)[kThreadRows][kGates][kThreadUnits]) {
  constexpr size_t kUBytes =
      static_cast<size_t>(kBlockK) * kGates * kBlockUnits * sizeof(TU);
  constexpr size_t kStage =
      kUBytes + static_cast<size_t>(kBlockK) * kAStride * sizeof(float);
  const int tid = threadIdx.x;
  const int slice = tid / kSliceThreads, own = tid % kSliceThreads;
  const int ug = own % (kBlockUnits / kThreadUnits);
  const int rg = own / (kBlockUnits / kThreadUnits);

  const auto load_tile = [&](int stage, int tile) {
    unsigned char *base = smem + stage * kStage;
    TU *s_u = reinterpret_cast<TU *>(base);
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
                b_mat + ((k0 + kk) * kGates + g) * width + n0 +
                    piece * kPer);
    }
    load_a(reinterpret_cast<float *>(base + kUBytes), tile);
  };

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
          s_h + kk * kAStride + kThreadRows * rg);
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
  if (slice != 0) return false;
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
  return true;
}

// Stages the tile's h_cur [W][R'] (k-major already) for rows r0..: one
// 16-byte copy a thread.
__device__ __forceinline__ void StageH(float *s_h, const float *h_cur,
                                       size_t rows, int r0, int tile) {
  const size_t k0 = static_cast<size_t>(tile) * kBlockK;
  const int kk = threadIdx.x / (kBlockRows / 4);
  const int piece = threadIdx.x % (kBlockRows / 4);
  CpAsync16(s_h + kk * kBlockRows + piece * 4,
            h_cur + (k0 + kk) * rows + r0 + piece * 4);
}

// One float32 step t of the recurrence for the CTA's rows and units: h_cur
// (the dot's operand at step t) in, h_next out.  kSeq: row 7 (x W over C
// channels, seq and last out); else the fused rows (codes, avg and hidden
// out).  The bf16 step is GridMmaKernel's.
template <int kGates, bool kSeq>
__global__ void __launch_bounds__(kThreads, 2)
    GridStepKernel(const GridArgs a, const int t,
                   const float *__restrict__ h_cur,
                   float *__restrict__ h_next) {
  using TU = float;  // U's type, and the output's
  constexpr size_t kUBytes =
      static_cast<size_t>(kBlockK) * kGates * kBlockUnits * sizeof(TU);
  constexpr size_t kStage = StageBytes<kGates>();
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
          const float v = x_t[c];
          const TU *w = kernel + static_cast<size_t>(c) * 3 * units + un;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            xg[g] = fmaf(v, w[static_cast<size_t>(g) * units], xg[g]);
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
        h_next[at] = h;
        const size_t o = static_cast<size_t>(row) * units + un;
        out[(static_cast<size_t>(row) * steps + t) * units + un] = h;
        if (t == steps - 1) last[o] = h;
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
          h_next[at] = h;
          mean += h;
        }
        mean *= 0.5f;
        out[(static_cast<size_t>(w) * steps + t) * units + un] = mean;
        if (t == steps - 1) {
          last[static_cast<size_t>(w) * units + un] = mean;
        }
      }
    }
  }
}

// ------------------------------------------------------ bf16: mma.sync
//
// The bf16 step (rows 1b, 2b, and row 7 with bf16 IO): the same product,
// h (bf16) times U (bf16) summed in float32, on the tensor cores, and the
// float32 epilogue of GridStepKernel.  See "The bf16 step" above.

constexpr int kMmaRows = 128;       // rows a CTA: 8 m16 tiles
constexpr int kMmaWarpRows = 32;    // rows a warp: 2 m16 tiles
constexpr int kMmaWarpUnits = 16;   // units a warp: 2 n8 tiles a gate
constexpr int kMmaK = 32;           // k a stage: 2 k16 steps
constexpr int kMmaStages = 4;
constexpr int kMmaPad = 8;          // bf16 after each row of a stage

// Threads of a CTA of kUnits units: a warp for each 32 rows x 16 units.
template <int kUnits>
__host__ __device__ constexpr int MmaThreads() {
  return 32 * (kMmaRows / kMmaWarpRows) * (kUnits / kMmaWarpUnits);
}

// Bytes of a stage: U's tile [g][kMmaK][kUnits + pad] and h's [kMmaRows]
// [kMmaK + pad], bf16.  The pad of 16 bytes a row puts the 8 rows that an
// ldmatrix reads in 8 distinct 16-byte bank groups.
template <int kGates, int kUnits>
__host__ __device__ constexpr size_t MmaStageBytes() {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(kGates) * kMmaK * (kUnits + kMmaPad) +
          static_cast<size_t>(kMmaRows) * (kMmaK + kMmaPad));
}

// Rows of the epilogue's table of input rows and biases (see
// GridMmaKernel): row 7 its two biases; the fused rows the five W rows and
// the pad's, and for the GRU its recurrent bias.
template <int kGates, bool kSeq>
__host__ __device__ constexpr int MmaTableRows() {
  return kSeq ? 2 : kGates == 3 ? 7 : 6;
}

// Dynamic shared memory of a CTA: the ring of stages, then the table.
template <int kGates, bool kSeq, int kUnits>
__host__ __device__ constexpr size_t MmaSmem() {
  return kMmaStages * MmaStageBytes<kGates, kUnits>() +
         sizeof(float) * MmaTableRows<kGates, kSeq>() * kGates * kUnits;
}

// The row of an mma row index in the h buffers and the carry: for the
// fused rows an m16 tile holds 8 windows, their forward rows first (rows
// 0-7) and their reverse-complement rows after (8-15), so the accumulator
// gives a lane (rows l/4 and l/4 + 8) both branches of one window.
__device__ __forceinline__ int MmaWindow(int row) {
  return 8 * (row >> 4) + (row & 7);
}

// One bf16 step t for the CTA's kMmaRows rows and kUnits units: h_cur
// [R'][W] bf16 (row-major, the dot's operand at step t) in, h_next out;
// the carry [2][R'][W] float32 (h, the LSTM's c).  kSeq: row 7; else the
// fused rows, row r holding branch (r / 8) % 2 of window MmaWindow(r).
template <int kGates, bool kSeq, int kUnits>
__global__ void __launch_bounds__(MmaThreads<kUnits>(),
                                  512 / MmaThreads<kUnits>())
    GridMmaKernel(const GridArgs a, const int t,
                  const __nv_bfloat16 *__restrict__ h_cur,
                  __nv_bfloat16 *__restrict__ h_next) {
  using bf16 = __nv_bfloat16;
  constexpr int kThreadsN = MmaThreads<kUnits>();
  constexpr int kUStride = kUnits + kMmaPad;  // bf16 a (gate, k) row
  constexpr int kHStride = kMmaK + kMmaPad;   // bf16 a row of h
  constexpr size_t kUElems = static_cast<size_t>(kGates) * kMmaK * kUStride;
  constexpr size_t kStageElems = MmaStageBytes<kGates, kUnits>() /
                                 sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 *const ring = reinterpret_cast<bf16 *>(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kMmaRows;
  const int n0 = blockIdx.y * kUnits;
  const size_t width = a.width;
  const int rows = a.rows;
  const int cta_rows = min(kMmaRows, rows - r0);  // a multiple of 32
  const bf16 *__restrict__ u_mat = static_cast<const bf16 *>(a.recurrent);
  const int n_tiles = a.width / kMmaK;
  // The warp's 32 rows and 16 units (2 unit groups of 8, every gate);
  // a warp whose rows are all past R' does no product.
  const int wrow0 = (warp % (kMmaRows / kMmaWarpRows)) * kMmaWarpRows;
  const int wunit0 = (warp / (kMmaRows / kMmaWarpRows)) * kMmaWarpUnits;
  const bool active = wrow0 < cta_rows;

  // The epilogue's table of the CTA's units, filled before the product
  // (the pipeline's barriers order it before its reads), zero past u: for
  // the fused rows the input rows s_x[code][g][unit] = bias + W[code]
  // (code 5, the pad: the bias only) and the GRU's recurrent bias in row
  // 6; for row 7 the input and recurrent biases in rows 0 and 1.
  float *const s_x = reinterpret_cast<float *>(
      smem + kMmaStages * MmaStageBytes<kGates, kUnits>());
  for (int i = tid; i < MmaTableRows<kGates, kSeq>() * kGates * kUnits;
       i += kThreadsN) {
    const int row = i / (kGates * kUnits), rest = i % (kGates * kUnits);
    const int g = rest / kUnits, un = n0 + rest % kUnits;
    const size_t u = a.units;
    float v = 0.0f;
    if (un < a.units) {
      if (kSeq || row == 6) {  // a bias row: [2, 3u]'s row 0 or 1
        v = a.bias[(3 * (kSeq ? row : 1) + g) * u + un];
      } else {
        v = a.bias[g * u + un];
        if (row < 5) {
          v += static_cast<const float *>(
              a.kernel)[(row * kGates + g) * u + un];
        }
      }
    }
    s_x[i] = v;
  }

  const auto load_tile = [&](int stage, int tile) {
    bf16 *s_u = ring + stage * kStageElems;
    bf16 *s_h = s_u + kUElems;
    const size_t k0 = static_cast<size_t>(tile) * kMmaK;
    constexpr int kRowCopies = kUnits / 8;  // 16 bytes a copy
    constexpr int kUCopies = kMmaK * kGates * kRowCopies;
#pragma unroll
    for (int c = tid; c < kUCopies; c += kThreadsN) {
      const int kk = c / (kGates * kRowCopies);
      const int rest = c % (kGates * kRowCopies);
      const int g = rest / kRowCopies, piece = rest % kRowCopies;
      CpAsync16(s_u + (g * kMmaK + kk) * kUStride + piece * 8,
                u_mat + ((k0 + kk) * kGates + g) * width + n0 + piece * 8);
    }
    constexpr int kHRowCopies = kMmaK / 8;
    for (int c = tid; c < cta_rows * kHRowCopies; c += kThreadsN) {
      const int r = c / kHRowCopies, piece = c % kHRowCopies;
      CpAsync16(s_h + r * kHStride + piece * 8,
                h_cur + static_cast<size_t>(r0 + r) * width + k0 +
                    piece * 8);
    }
  };

  // acc[m][q][j]: m16 tile m, gate q, unit group j (an n8 tile).
  float acc[2][kGates][2][4] = {};
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    CpAsyncCommit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    CpAsyncWait<kMmaStages - 2>();
    __syncthreads();  // the tile landed; every warp is done with tile-1
    const int next = tile + kMmaStages - 1;
    if (next < n_tiles) load_tile(next % kMmaStages, next);
    CpAsyncCommit();
    if (!active) continue;
    const bf16 *s_u = ring + (tile % kMmaStages) * kStageElems;
    const bf16 *s_h = s_u + kUElems;
#pragma unroll
    for (int k16 = 0; k16 < kMmaK / 16; ++k16) {
      const int col = 16 * k16 + 8 * (lane >> 4);
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        LdMatrixX4(af[m], s_h + (wrow0 + 16 * m + (lane & 15)) * kHStride +
                              col);
      }
#pragma unroll
      for (int q = 0; q < kGates; ++q) {
        uint32_t bf[4];
        LdMatrixX4Trans(bf, s_u + (q * kMmaK + 16 * k16 + (lane & 15)) *
                                      kUStride +
                                wunit0 + 8 * (lane >> 4));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            MmaBf16(acc[m][q][j], af[m], bf[2 * j], bf[2 * j + 1]);
          }
        }
      }
    }
  }
  CpAsyncWait<0>();
  if (!active) return;

  // The epilogue, in the registers the sums are in: lane l holds rows
  // l/4 (fragments 0, 1) and l/4 + 8 (2, 3) of each m16 tile, units 2 (l %
  // 4) and the next of each unit group, every gate.  For each m16 tile the
  // loads come first (the carry, the codes, row 7's x W), then the gate
  // math and the stores, so the loads of a tile wait on no store.
  const int units = a.units, steps = a.steps, batch = a.batch;
  const size_t plane = width * rows;
  bf16 *out = static_cast<bf16 *>(a.out);
  bf16 *last = static_cast<bf16 *>(a.last);
  const bool pairs = (units & 1) == 0;  // bf16x2 output stores aligned
  const int gq = lane >> 2, tq = lane & 3;
  // Stores output row `row`'s units un0 and un0 + 1 (the second only if
  // it exists) at step t, and at the last step into `last` too: bf16x2
  // where aligned.
  const auto store = [&](int row, int un0, const float (&v)[2]) {
    const size_t o = (static_cast<size_t>(row) * steps + t) * units + un0;
    const size_t o_last = static_cast<size_t>(row) * units + un0;
    const bool both = un0 + 1 < units;
    if (pairs && both) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162 *>(out + o) = pair;
      if (t == steps - 1) {
        *reinterpret_cast<__nv_bfloat162 *>(last + o_last) = pair;
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e == 1 && !both) break;
      out[o + e] = __float2bfloat16(v[e]);
      if (t == steps - 1) last[o_last + e] = __float2bfloat16(v[e]);
    }
  };
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mrow = r0 + wrow0 + 16 * m;  // the m16 tile's first row
    // [half (row mrow + gq, or + 8)][unit group][unit]: the carried h
    // (and the LSTM's c) of the lane's cells.
    float h_st[2][2][2];
    [[maybe_unused]] float c_st[2][2][2];
    if constexpr (kSeq) {
      const bf16 *x = static_cast<const bf16 *>(a.x);
      const bf16 *kernel = static_cast<const bf16 *>(a.kernel);
      float xg[2][2][2][3] = {};  // x_t W: [half][unit group][unit][gate]
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mrow + 8 * half + gq;
        if (row >= batch) continue;
        const bf16 *x_t =
            x + (static_cast<size_t>(row) * steps + t) * a.channels;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int un0 = n0 + wunit0 + 8 * j + 2 * tq;
          const float2 h2 = *reinterpret_cast<const float2 *>(
              a.carry + static_cast<size_t>(row) * width + un0);
          h_st[half][j][0] = h2.x;
          h_st[half][j][1] = h2.y;
          // x_t W in channel order.
          for (int c = 0; c < a.channels; ++c) {
            const float v = __bfloat162float(x_t[c]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (un0 + e >= units) break;
              const bf16 *w =
                  kernel + static_cast<size_t>(c) * 3 * units + un0 + e;
#pragma unroll
              for (int g = 0; g < 3; ++g) {
                xg[half][j][e][g] = fmaf(
                    v, __bfloat162float(w[static_cast<size_t>(g) * units]),
                    xg[half][j][e][g]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = mrow + 8 * half + gq;
        if (row >= batch) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ul0 = wunit0 + 8 * j + 2 * tq;  // the CTA's unit
          const int un0 = n0 + ul0;
          if (un0 >= units) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (un0 + e >= units) break;
            // The Keras GRU (reset_after=True), biases from the table.
            const float *b_in = s_x + ul0 + e;
            const float *b_rec = s_x + 3 * kUnits + ul0 + e;
            const int f = 2 * half + e;
            const float z = Sigmoid((xg[half][j][e][0] + b_in[0]) +
                                    (acc[m][0][j][f] + b_rec[0]));
            const float reset =
                Sigmoid((xg[half][j][e][1] + b_in[kUnits]) +
                        (acc[m][1][j][f] + b_rec[kUnits]));
            const float hh =
                tanhf((xg[half][j][e][2] + b_in[2 * kUnits]) +
                      reset * (acc[m][2][j][f] + b_rec[2 * kUnits]));
            h_st[half][j][e] = z * h_st[half][j][e] + (1.0f - z) * hh;
          }
          const size_t at = static_cast<size_t>(row) * width + un0;
          *reinterpret_cast<float2 *>(a.carry + at) =
              make_float2(h_st[half][j][0], h_st[half][j][1]);
          *reinterpret_cast<__nv_bfloat162 *>(h_next + at) =
              __floats2bfloat162_rn(h_st[half][j][0], h_st[half][j][1]);
          const float v[2] = {h_st[half][j][0], h_st[half][j][1]};
          store(row, un0, v);
        }
      }
    } else {
      const int w = MmaWindow(mrow) + gq;
      if (w >= batch) continue;
      const size_t at_code = static_cast<size_t>(w) * steps;
      const int code[2] = {a.codes[at_code + t],
                           Complement(a.codes[at_code + steps - 1 - t])};
#pragma unroll
      for (int branch = 0; branch < 2; ++branch) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const size_t at =
              static_cast<size_t>(mrow + 8 * branch + gq) * width + n0 +
              wunit0 + 8 * j + 2 * tq;
          const float2 h2 = *reinterpret_cast<const float2 *>(a.carry + at);
          h_st[branch][j][0] = h2.x;
          h_st[branch][j][1] = h2.y;
          if constexpr (kGates == 4) {
            const float2 c2 =
                *reinterpret_cast<const float2 *>(a.carry + plane + at);
            c_st[branch][j][0] = c2.x;
            c_st[branch][j][1] = c2.y;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ul0 = wunit0 + 8 * j + 2 * tq;  // the CTA's unit
        const int un0 = n0 + ul0;
        if (un0 >= units) continue;
        float mean[2] = {0.0f, 0.0f};
#pragma unroll
        for (int branch = 0; branch < 2; ++branch) {
          // The input row: bias + W[code] (pad: the bias only).
          const float *x_row =
              s_x + (static_cast<unsigned>(code[branch]) < 5u ? code[branch]
                                                              : 5) *
                        kGates * kUnits + ul0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (un0 + e >= units) break;
            const int f = 2 * branch + e;
            float x[kGates];
#pragma unroll
            for (int g = 0; g < kGates; ++g) x[g] = x_row[g * kUnits + e];
            float &h = h_st[branch][j][e];
            if constexpr (kGates == 3) {
              // Keras GRU, reset_after=True.
              const float *b_rec = s_x + 6 * 3 * kUnits + ul0 + e;
              const float z =
                  Sigmoid(x[0] + (acc[m][0][j][f] + b_rec[0]));
              const float rr =
                  Sigmoid(x[1] + (acc[m][1][j][f] + b_rec[kUnits]));
              const float hh = tanhf(
                  x[2] + rr * (acc[m][2][j][f] + b_rec[2 * kUnits]));
              h = z * h + (1.0f - z) * hh;
            } else {
              // LSTM, gates i, f, c, o.
              float &c = c_st[branch][j][e];
              const float ig = Sigmoid(x[0] + acc[m][0][j][f]);
              const float fg = Sigmoid(x[1] + acc[m][1][j][f]);
              const float gg = tanhf(x[2] + acc[m][2][j][f]);
              const float og = Sigmoid(x[3] + acc[m][3][j][f]);
              c = fg * c + ig * gg;
              h = og * tanhf(c);
            }
            mean[e] += h;
          }
          const size_t at =
              static_cast<size_t>(mrow + 8 * branch + gq) * width + un0;
          *reinterpret_cast<float2 *>(a.carry + at) =
              make_float2(h_st[branch][j][0], h_st[branch][j][1]);
          if constexpr (kGates == 4) {
            *reinterpret_cast<float2 *>(a.carry + plane + at) =
                make_float2(c_st[branch][j][0], c_st[branch][j][1]);
          }
          *reinterpret_cast<__nv_bfloat162 *>(h_next + at) =
              __floats2bfloat162_rn(h_st[branch][j][0], h_st[branch][j][1]);
        }
        const float v[2] = {mean[0] * 0.5f, mean[1] * 0.5f};
        store(w, un0, v);
      }
    }
  }
}

// ------------------------------------------------------ training
//
// Rows 3-6 past the cluster tiles (rnn_train.cu's contract: masked input
// rows, hseq (cseq) stored for the backward, each branch row in its own
// time order; the backward writes the gate cotangents that dg_train_reduce
// of rnn_train.cu sums).  All float32.

// Row stride of an operand that a gather stages (kBlockK rows of
// kBlockRows floats, four more so a warp's 32 four-byte copies of 8
// columns x 4 rows land in 32 banks).
constexpr int kGatherStride = kBlockRows + 4;
constexpr int kCodes = 5;  // W rows: A, C, G, T, N; pad (5) selects none

// The arguments of a training call's launches.
struct TrainArgs {
  const int8_t *codes;      // [B, T]
  const float *masks;       // [g, 2B, 5]; null: scale 1
  const float *kernel;      // [5, g u]
  const float *bias;        // GRU [2, 3u] (input, recurrent), LSTM [4u]
  const float *recurrent;   // the padded U [W][g][W]
  const float *transposed;  // backward: the padded U^T [g][W][W]
  float *carry;             // [2][W][R']
  float *hseq, *cseq;       // [2B, T, u], forward rows first
  float *avg, *hidden;      // forward: [B, T, u], [B, u]
  const float *d_avg, *d_hidden;  // backward: [B, T, u], [B, u]
  float *d_out;             // backward: GRU d_xp, LSTM da [2B, T, g u]
  float *d_rp;              // backward, GRU: d_rp [2B, T, 3u]
  int batch, steps, units;
  int width;                // W
  int rows;                 // R' (2B rounded up to kBlockRows)
};

// A 4-byte cp.async; bytes = 0 writes a zero and reads nothing.
__device__ __forceinline__ void CpAsync4(void *smem, const void *gmem,
                                         int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

// Stages a tile of a row-major operand k-major (s_a[kk kGatherStride +
// r]), four bytes a copy: the thread's 4 rows r = r_first + 8 i start at
// src[i] (null: a zero row) and column `col` of the tile (valid: in
// range, else zero).  Column kk = lane % 8 + 8 ((tid / 32) % 4), so a
// warp reads 8 consecutive floats of 4 rows.
struct Gather {
  const float *src[4];
  const float *any;  // a global address for the zero copies
  int r_first, kk;

  __device__ __forceinline__ explicit Gather(const float *global)
      : any(global) {
    const int lane = threadIdx.x % 32;
    kk = lane % 8 + 8 * ((threadIdx.x / 32) % 4);
    r_first = lane / 8 + 4 * (threadIdx.x / 128);
  }
  __device__ __forceinline__ int Row(int i) const { return r_first + 8 * i; }
  __device__ __forceinline__ void Stage(float *s_a, size_t col,
                                        bool valid) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = valid && src[i] != nullptr;
      CpAsync4(s_a + kk * kGatherStride + Row(i),
               in ? src[i] + col : any, in ? 4 : 0);
    }
  }
};

// The code a branch row reads at its step t: the forward row's base, or
// the reverse complement of the base T-1-t.
__device__ __forceinline__ int RowCode(const TrainArgs &a, int w,
                                       bool reverse, int t) {
  const size_t at = static_cast<size_t>(w) * a.steps +
                    (reverse ? a.steps - 1 - t : t);
  return reverse ? Complement(a.codes[at]) : a.codes[at];
}

// The masked input row of unit un: x_g = b_in_g + mask[g, row, code]
// W_g[code] (pad: the bias only; null masks: scale 1); row is the doubled
// batch's (forward rows first).
template <int kGates>
__device__ __forceinline__ void InputRow(const TrainArgs &a, int row,
                                         int code, int un,
                                         float (&x)[kGates]) {
  const size_t units = a.units;
  const bool has_w = static_cast<unsigned>(code) < kCodes;
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    x[g] = a.bias[g * units + un];
    if (has_w) {
      const float scale =
          a.masks != nullptr
              ? a.masks[(static_cast<size_t>(g) * 2 * a.batch + row) *
                            kCodes + code]
              : 1.0f;
      x[g] += scale * a.kernel[(code * kGates + g) * units + un];
    }
  }
}

// The training forward's step t (rows 3, 5): GridStepKernel's fused step
// with the masked input row, and hseq (the LSTM's cseq too) stored.
template <int kGates>
__global__ void __launch_bounds__(kThreads, 2)
    GridTrainFwdKernel(const TrainArgs a, const int t,
                       const float *__restrict__ h_cur,
                       float *__restrict__ h_next) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int own = threadIdx.x % kSliceThreads;
  const int ug = own % (kBlockUnits / kThreadUnits);
  const int rg = own / (kBlockUnits / kThreadUnits);
  const int r0 = blockIdx.x * kBlockRows;
  const int n0 = blockIdx.y * kBlockUnits;
  const size_t width = a.width, rows = a.rows;

  float acc[kThreadRows][kGates][kThreadUnits] = {};
  if (!TileDot<kGates, kBlockRows>(
          smem, a.recurrent, width, n0, a.width / kBlockK,
          [&](float *s_h, int tile) { StageH(s_h, h_cur, rows, r0, tile); },
          acc)) {
    return;
  }

  const int units = a.units, steps = a.steps, batch = a.batch;
  const size_t plane = width * rows;
#pragma unroll
  for (int n = 0; n < kThreadUnits; ++n) {
    const int un = n0 + kThreadUnits * ug + n;
    if (un >= units) break;
#pragma unroll
    for (int q = 0; q < kThreadRows / 2; ++q) {
      const int w = (r0 + kThreadRows * rg) / 2 + q;
      if (w >= batch) break;
      float mean = 0.0f;
#pragma unroll
      for (int branch = 0; branch < 2; ++branch) {
        const int r = 2 * q + branch;
        const int seq_row = branch == 0 ? w : batch + w;
        float x[kGates];
        InputRow<kGates>(a, seq_row, RowCode(a, w, branch == 1, t), un, x);
        const size_t at = static_cast<size_t>(un) * rows + 2 * w + branch;
        const size_t at_seq =
            (static_cast<size_t>(seq_row) * steps + t) * units + un;
        float h = a.carry[at];
        if constexpr (kGates == 3) {
          float b_rec[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            b_rec[g] = a.bias[(3 + g) * static_cast<size_t>(units) + un];
          }
          const float z = Sigmoid(x[0] + (acc[r][0][n] + b_rec[0]));
          const float rr = Sigmoid(x[1] + (acc[r][1][n] + b_rec[1]));
          const float hh = tanhf(x[2] + rr * (acc[r][2][n] + b_rec[2]));
          h = z * h + (1.0f - z) * hh;
        } else {
          float &c = a.carry[plane + at];
          const float ig = Sigmoid(x[0] + acc[r][0][n]);
          const float fg = Sigmoid(x[1] + acc[r][1][n]);
          const float gg = tanhf(x[2] + acc[r][2][n]);
          const float og = Sigmoid(x[3] + acc[r][3][n]);
          c = fg * c + ig * gg;
          h = og * tanhf(c);
          a.cseq[at_seq] = c;
        }
        a.carry[at] = h;
        h_next[at] = h;
        a.hseq[at_seq] = h;
        mean += h;
      }
      mean *= 0.5f;
      a.avg[(static_cast<size_t>(w) * steps + t) * units + un] = mean;
      if (t == steps - 1) a.hidden[static_cast<size_t>(w) * units + un] = mean;
    }
  }
}

// The backward's (A): the recurrent preactivations h_prev U of every
// (row, t), h_prev = hseq one step back (zero at t = 0), as one product
// over the 2B T rows n = row T + t, into d_out [2B T, g u].  TileDot with
// the forward's tiles, slices and order, so each preactivation has the
// forward's bits.
template <int kGates>
__global__ void __launch_bounds__(kThreads, 2)
    GridRecomputeKernel(const TrainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int own = threadIdx.x % kSliceThreads;
  const int ug = own % (kBlockUnits / kThreadUnits);
  const int rg = own / (kBlockUnits / kThreadUnits);
  const long long r0 = static_cast<long long>(blockIdx.x) * kBlockRows;
  const int n0 = blockIdx.y * kBlockUnits;
  const long long n_rows = 2LL * a.batch * a.steps;
  const int units = a.units;

  Gather gather(a.hseq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long n = r0 + gather.Row(i);
    gather.src[i] = n < n_rows && n % a.steps != 0
                        ? a.hseq + static_cast<size_t>(n - 1) * units
                        : nullptr;
  }
  float acc[kThreadRows][kGates][kThreadUnits] = {};
  if (!TileDot<kGates, kGatherStride>(
          smem, a.recurrent, a.width, n0, a.width / kBlockK,
          [&](float *s_a, int tile) {
            const int k = tile * kBlockK + gather.kk;
            gather.Stage(s_a, k, k < units);
          },
          acc)) {
    return;
  }
  const size_t cols = static_cast<size_t>(kGates) * units;
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r) {
    const long long n = r0 + kThreadRows * rg + r;
    if (n >= n_rows) break;
#pragma unroll
    for (int m = 0; m < kThreadUnits; ++m) {
      const int un = n0 + kThreadUnits * ug + m;
      if (un >= units) break;
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        a.d_out[static_cast<size_t>(n) * cols + g * static_cast<size_t>(units) +
                un] = acc[r][g][m];
      }
    }
  }
}

// ---- the backward's (B)
//
// The product of step t+1's gate cotangents A [R', g W] (GRU d_rp, LSTM
// da, K = g W in the padded U^T's (gate, unit) order) with U^T [g W, W]:
// dh [R', W].  A CTA owns kBlockRows rows and kGroups blocks of 32 units
// (the caller's); each thread 4 rows x 4 kGroups units, unit n0 + 32 q + 4 ug
// + e of block q, so a warp's loads of a k's U are 128 contiguous bytes
// and its A loads four broadcast float4s: per k one float4 of A and
// kGroups of U for 16 kGroups FMAs.  A arrives k-major from the previous
// step's epilogue (a ping-pong cot [2][g W][R']), staged with 16-byte
// copies as StageH stages h.  K and the slices run as in TileDot: slice s
// sums k = 32 i + 8 s + j of every tile i in order, and the slices' sums
// are added in slice order, an order fixed by u alone (kGroups and the
// batch change which CTA owns a sum, not its order).

constexpr int kBwdMaxGroups = 4;     // most blocks of 32 units a CTA
constexpr int kBwdRowA = kBlockRows;  // A's stage row stride (floats)

template <int kGroups>
__host__ __device__ constexpr size_t BwdStageBytes() {
  return static_cast<size_t>(kBlockK) *
         (kGroups * kBlockUnits + kBwdRowA) * sizeof(float);
}

// Dynamic shared memory of (B): the ring, which every slice's sums reuse
// after the last tile.
template <int kGroups>
__host__ __device__ constexpr size_t BwdSmem() {
  const size_t ring = kStages * BwdStageBytes<kGroups>();
  const size_t sums = static_cast<size_t>(kSplit) * 16 * kGroups *
                      kSliceThreads * sizeof(float);
  return ring > sums ? ring : sums;
}

// A 16-byte cp.async that writes zeros and reads nothing unless `valid`.
__device__ __forceinline__ void CpAsync16If(void *smem, const void *gmem,
                                            bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// (B)'s product for the CTA's rows r0.. and units n0..: acc[r][q][e] of
// row r0 + 4 rg + r and unit n0 + 32 q + 4 ug + e, summed over n_tiles
// tiles of kBlockK.  load_a(s_a, tile) issues the copies that stage the
// tile's A k-major (s_a[kk kBwdRowA + r]).  Every thread then holds the
// sum of its slice; CotSums adds them.
template <int kGroups, typename LoadA>
__device__ __forceinline__ void CotDot(
    unsigned char *smem, const float *__restrict__ b_mat, size_t width,
    int n0, int n_tiles, const LoadA &load_a,
    float (&acc)[kThreadRows][kGroups][kThreadUnits]) {
  constexpr size_t kUBytes =
      static_cast<size_t>(kBlockK) * kGroups * kBlockUnits * sizeof(float);
  constexpr size_t kStage = BwdStageBytes<kGroups>();
  constexpr int kUnits = kGroups * kBlockUnits;
  const int tid = threadIdx.x;
  const int slice = tid / kSliceThreads, own = tid % kSliceThreads;
  const int ug = own % (kBlockUnits / kThreadUnits);
  const int rg = own / (kBlockUnits / kThreadUnits);

  const auto load_tile = [&](int stage, int tile) {
    unsigned char *base = smem + stage * kStage;
    float *s_u = reinterpret_cast<float *>(base);
    const size_t k0 = static_cast<size_t>(tile) * kBlockK;
    constexpr int kRowCopies = kUnits / 4;
#pragma unroll
    for (int c = tid; c < kBlockK * kRowCopies; c += kThreads) {
      const int kk = c / kRowCopies, col = (c % kRowCopies) * 4;
      const bool in = n0 + col < static_cast<int>(width);
      CpAsync16If(s_u + kk * kUnits + col,
                  b_mat + (k0 + kk) * width + (in ? n0 + col : 0), in);
    }
    load_a(reinterpret_cast<float *>(base + kUBytes), tile);
  };

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
    const float *s_u = reinterpret_cast<const float *>(base);
    const float *s_a = reinterpret_cast<const float *>(base + kUBytes);
#pragma unroll
    for (int j = 0; j < kBlockK / kSplit; ++j) {
      const int kk = slice * (kBlockK / kSplit) + j;
      const float4 aq = *reinterpret_cast<const float4 *>(
          s_a + kk * kBwdRowA + kThreadRows * rg);
      const float av[kThreadRows] = {aq.x, aq.y, aq.z, aq.w};
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        float u[kThreadUnits];
        LoadU4(s_u + kk * kUnits + q * kBlockUnits + kThreadUnits * ug, u);
#pragma unroll
        for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
          for (int e = 0; e < kThreadUnits; ++e) {
            acc[r][q][e] = fmaf(av[r], u[e], acc[r][q][e]);
          }
        }
      }
    }
  }
  CpAsyncWait<0>();
  __syncthreads();  // the ring is free for the slices' sums
}

// The slices' sums of CotDot, added in slice order ((s0 + s1) + s2) + s3:
// every slice stores its sums, then thread (slice s, own) takes the sums
// of own's 4 rows at its units c = s kGroups + i (c = 4 q + e), i <
// kGroups, into dh[r][i].
template <int kGroups>
__device__ __forceinline__ void CotSums(
    unsigned char *smem,
    const float (&acc)[kThreadRows][kGroups][kThreadUnits],
    float (&dh)[kThreadRows][kGroups]) {
  constexpr int kAcc = kThreadRows * kGroups * kThreadUnits;
  const int slice = threadIdx.x / kSliceThreads;
  const int own = threadIdx.x % kSliceThreads;
  float *sums = reinterpret_cast<float *>(smem);
  float *mine = sums + slice * kAcc * kSliceThreads + own;
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
#pragma unroll
      for (int e = 0; e < kThreadUnits; ++e) {
        mine[((r * kGroups + q) * kThreadUnits + e) * kSliceThreads] =
            acc[r][q][e];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int c = slice * kGroups + i;
      const int idx = (r * kGroups + c / kThreadUnits) * kThreadUnits +
                      c % kThreadUnits;
      float v = sums[idx * kSliceThreads + own];
#pragma unroll
      for (int s = 1; s < kSplit; ++s) {
        v += sums[(s * kAcc + idx) * kSliceThreads + own];
      }
      dh[r][i] = v;
    }
  }
}

// The backward's (B), step t (launched for t = T-1 down to 0): dh of the
// CTA's rows and units (CotDot, CotSums), then the cotangent math of
// rnn_train.cu's header for every gate of each unit, reading the
// preactivations (A) left in d_out at step t and writing the cotangents
// there (and d_rp), and k-major into cot_next for step t-1.  The carry
// holds what passes to step t-1 beside the product (GRU dh z, LSTM dc f);
// step T-1 seeds dh with d_hidden / 2 and runs no product.
template <int kGates, int kGroups>
__global__ void __launch_bounds__(kThreads, 2)
    GridBwdStepKernel(const TrainArgs a, const int t,
                      const float *__restrict__ cot_cur,
                      float *__restrict__ cot_next) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slice = threadIdx.x / kSliceThreads;
  const int own = threadIdx.x % kSliceThreads;
  const int ug = own % (kBlockUnits / kThreadUnits);
  const int rg = own / (kBlockUnits / kThreadUnits);
  const int r0 = blockIdx.x * kBlockRows;
  const int n0 = blockIdx.y * kGroups * kBlockUnits;
  const int units = a.units, steps = a.steps, batch = a.batch;
  const size_t rows = a.rows;
  const size_t cols = static_cast<size_t>(kGates) * units;

  float acc[kThreadRows][kGroups][kThreadUnits] = {};
  CotDot<kGroups>(
      smem, a.transposed, a.width, n0,
      t == steps - 1 ? 0 : kGates * a.width / kBlockK,
      [&](float *s_a, int tile) { StageH(s_a, cot_cur, rows, r0, tile); },
      acc);
  float dh_sum[kThreadRows][kGroups];
  CotSums<kGroups>(smem, acc, dh_sum);

  int code[kThreadRows];
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r) {
    const int row = r0 + kThreadRows * rg + r;
    const bool reverse = row >= batch;
    code[r] = row < 2 * batch ? RowCode(a, reverse ? row - batch : row,
                                        reverse, t)
                              : 0;
  }
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int c = slice * kGroups + i;
    const int un = n0 + kBlockUnits * (c / kThreadUnits) +
                   kThreadUnits * ug + c % kThreadUnits;
    if (un >= units) continue;
    float next[kGates][kThreadRows] = {};
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
      const int row = r0 + kThreadRows * rg + r;
      if (row >= 2 * batch) break;
      const int w = row >= batch ? row - batch : row;
      float x[kGates], p[kGates];
      InputRow<kGates>(a, row, code[r], un, x);
      const size_t at_d =
          (static_cast<size_t>(row) * steps + t) * cols + un;
#pragma unroll
      for (int g = 0; g < kGates; ++g) p[g] = a.d_out[at_d + g * units];
      const size_t at_prev =
          (static_cast<size_t>(row) * steps + t - 1) * units + un;
      const size_t at = static_cast<size_t>(un) * rows + row;
      const size_t at_w = static_cast<size_t>(w) * units + un;
      const float seed = 0.5f * a.d_hidden[at_w];
      const float half_avg =
          0.5f * a.d_avg[(static_cast<size_t>(w) * steps + t) * units + un];
      if constexpr (kGates == 3) {
        float b_rec[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          b_rec[g] = a.bias[(3 + g) * static_cast<size_t>(units) + un];
        }
        const float h_prev = t > 0 ? a.hseq[at_prev] : 0.0f;
        const float z = Sigmoid(x[0] + (p[0] + b_rec[0]));
        const float rr = Sigmoid(x[1] + (p[1] + b_rec[1]));
        const float rh = p[2] + b_rec[2];
        const float hh = tanhf(x[2] + rr * rh);
        const float dh =
            ((t == steps - 1 ? seed : a.carry[at]) + dh_sum[r][i]) +
            half_avg;
        const float da_z = dh * (h_prev - hh) * z * (1.0f - z);
        const float da_h = dh * (1.0f - z) * (1.0f - hh * hh);
        const float da_r = (da_h * rh) * rr * (1.0f - rr);
        a.d_out[at_d] = da_z;
        a.d_out[at_d + units] = da_r;
        a.d_out[at_d + 2 * units] = da_h;
        next[0][r] = da_z;
        next[1][r] = da_r;
        next[2][r] = da_h * rr;
        a.carry[at] = dh * z;
      } else {
        const float c_prev = t > 0 ? a.cseq[at_prev] : 0.0f;
        const float ig = Sigmoid(x[0] + p[0]);
        const float fg = Sigmoid(x[1] + p[1]);
        const float gg = tanhf(x[2] + p[2]);
        const float og = Sigmoid(x[3] + p[3]);
        const float tanh_c = tanhf(fg * c_prev + ig * gg);
        const float dh = ((t == steps - 1 ? seed : 0.0f) + dh_sum[r][i]) +
                         half_avg;
        const float dc = t == steps - 1 ? 0.0f : a.carry[at];
        const float d_o = dh * tanh_c;
        const float dc_t = dc + dh * og * (1.0f - tanh_c * tanh_c);
        next[0][r] = (dc_t * gg) * ig * (1.0f - ig);
        next[1][r] = (dc_t * c_prev) * fg * (1.0f - fg);
        next[2][r] = (dc_t * ig) * (1.0f - gg * gg);
        next[3][r] = d_o * og * (1.0f - og);
        a.carry[at] = dc_t * fg;
      }
      float *d_next = kGates == 3 ? a.d_rp : a.d_out;
#pragma unroll
      for (int g = 0; g < kGates; ++g) d_next[at_d + g * units] = next[g][r];
    }
    // The cotangents of step t+1's product (d_rp, da) k-major for step
    // t-1: rows 4 rg.. of column (g, un), zeros past the batch.
#pragma unroll
    for (int g = 0; g < kGates; ++g) {
      *reinterpret_cast<float4 *>(
          cot_next + (static_cast<size_t>(g) * a.width + un) * rows + r0 +
          kThreadRows * rg) =
          make_float4(next[g][0], next[g][1], next[g][2], next[g][3]);
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

// Opts a kernel into `smem` bytes of dynamic shared memory: above 48 kB a
// kernel only launches after it.
template <typename Kernel>
cudaError_t OptIn(Kernel fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The T launches of a step kernel (GridStepKernel, GridMmaKernel,
// GridTrainFwdKernel) for `rows` rows on `stream`, CTAs of `threads`
// threads owning `rows_a_cta` rows and `units_a_cta` units, h_cur and
// h_next (of TH) swapping each step; the first error, else 0.
template <typename TH, typename Kernel, typename Args>
int RunSteps(Kernel fn, size_t smem, Args a, long long rows, void *h0,
             void *h1, void *stream, int rows_a_cta = kBlockRows,
             int units_a_cta = kBlockUnits, int threads = kThreads) {
  long long shape[4];
  if (a.batch < 1 || a.steps < 1 || !Shape(rows, a.units, shape)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.width = static_cast<int>(shape[0]);
  a.rows = static_cast<int>(shape[1]);
  cudaError_t err = OptIn(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(RoundUp(shape[1], rows_a_cta) /
                                        rows_a_cta),
                  static_cast<unsigned>(shape[0] / units_a_cta));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  TH *h[2] = {static_cast<TH *>(h0), static_cast<TH *>(h1)};
  for (int t = 0; t < a.steps; ++t) {
    fn<<<grid, threads, smem, s>>>(a, t, h[t & 1], h[(t + 1) & 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Units a CTA of the bf16 step for `rows` rows at this width on the
// current card: 32, unless its grid would have fewer CTAs than the card
// has SMs, then 16 (twice the CTAs, each reading all of h); 0 if the
// shape is refused or the card cannot be asked.
int MmaUnits(long long rows, long long units) {
  long long shape[4];
  int device = 0, sms = 0;
  if (!Shape(rows, units, shape) || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess) {
    return 0;
  }
  const long long ctas = RoundUp(shape[1], kMmaRows) / kMmaRows *
                         (shape[0] / 32);
  return ctas >= sms ? 32 : 16;
}

template <int kGates, bool kSeq, int kUnits>
int RunMma(GridArgs a, long long rows, void *h0, void *h1, void *stream) {
  return RunSteps<__nv_bfloat16>(
      GridMmaKernel<kGates, kSeq, kUnits>, MmaSmem<kGates, kSeq, kUnits>(),
      a, rows, h0, h1, stream,
      kMmaRows, kUnits, MmaThreads<kUnits>());
}

// The T launches of a step for `rows` rows: the float32 FMA step, or in
// bf16 the tensor-core step at MmaUnits' unit block.
template <int kGates, bool kSeq>
int RunGrid(bool bf16, GridArgs a, long long rows, void *h0, void *h1,
            void *stream) {
  if (!bf16) {
    return RunSteps<float>(GridStepKernel<kGates, kSeq>, GridSmem<kGates>(),
                           a, rows, h0, h1, stream);
  }
  switch (MmaUnits(rows, a.units)) {
    case 16: return RunMma<kGates, kSeq, 16>(a, rows, h0, h1, stream);
    case 32: return RunMma<kGates, kSeq, 32>(a, rows, h0, h1, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kGates>
int RunTrainFwd(TrainArgs a, void *h0, void *h1, void *stream) {
  return RunSteps<float>(GridTrainFwdKernel<kGates>, GridSmem<kGates>(), a,
                  2LL * a.batch, h0, h1, stream);
}

// (B)'s T launches for t = T-1 down to 0, kGroups blocks of 32 units a
// CTA, the cotangents handed k-major between steps through cot [2][g
// W][R']; the first error, else 0.
template <int kGates, int kGroups>
int RunBwdSteps(const TrainArgs &a, const long long *shape, float *cot,
                cudaStream_t s) {
  const auto step = GridBwdStepKernel<kGates, kGroups>;
  constexpr size_t smem = BwdSmem<kGroups>();
  cudaError_t err = OptIn(step, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(shape[2]),
                  static_cast<unsigned>((shape[3] + kGroups - 1) / kGroups));
  const size_t plane = static_cast<size_t>(kGates) * shape[0] * shape[1];
  for (int t = a.steps - 1; t >= 0; --t) {
    step<<<grid, kThreads, smem, s>>>(a, t, cot + ((t + 1) & 1) * plane,
                                      cot + (t & 1) * plane);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// A training backward's launches on `stream`: (A) once, then (B) for t =
// T-1 down to 0 in `groups` blocks of 32 units a CTA (1 to
// kBwdMaxGroups); the first error, else 0.
template <int kGates>
int RunTrainBwd(TrainArgs a, float *cot, int groups, void *stream) {
  long long shape[4];
  const long long n_rows = 2LL * a.batch * a.steps;
  if (a.batch < 1 || a.steps < 1 || groups < 1 || groups > kBwdMaxGroups ||
      !Shape(2LL * a.batch, a.units, shape) ||
      n_rows > 0x7fffffffLL - kBlockRows) {  // (A)'s rows a 32-bit grid
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.width = static_cast<int>(shape[0]);
  a.rows = static_cast<int>(shape[1]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto recompute = GridRecomputeKernel<kGates>;
  constexpr size_t smem_a = GridSmem<kGates, kGatherStride>();
  cudaError_t err = OptIn(recompute, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  recompute<<<dim3(static_cast<unsigned>((n_rows + kBlockRows - 1) /
                                         kBlockRows),
                   static_cast<unsigned>(shape[3])),
              kThreads, smem_a, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (groups) {
    case 1: return RunBwdSteps<kGates, 1>(a, shape, cot, s);
    case 2: return RunBwdSteps<kGates, 2>(a, shape, cot, s);
    case 3: return RunBwdSteps<kGates, 3>(a, shape, cot, s);
    case 4: return RunBwdSteps<kGates, 4>(a, shape, cot, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The arguments every training entry point shares.
TrainArgs TrainHead(const void *codes, int batch, int steps,
                    const void *masks, const void *kernel, const void *bias,
                    const void *recurrent, int units) {
  TrainArgs a{};
  a.codes = static_cast<const int8_t *>(codes);
  a.masks = static_cast<const float *>(masks);
  a.kernel = static_cast<const float *>(kernel);
  a.bias = static_cast<const float *>(bias);
  a.recurrent = static_cast<const float *>(recurrent);
  a.batch = batch;
  a.steps = steps;
  a.units = units;
  return a;
}

}  // namespace

extern "C" {

// The fused rows past the cluster tiles (1, 2; bf16 != 0: 1b, 2b): codes
// int8 [B, T]; kernel float [5, g u]; bias float (GRU [2, 3u], LSTM [4u]);
// recurrent the zero-padded U [W][g][W] (float32, or bfloat16 for bf16);
// h0, h1 [W][R'] float (bf16: [R'][W] bfloat16) and carry float [2][W][R']
// (bf16: [2][R'][W]), zeroed (R' for 2B rows: dg_grid_shape); avg [B, T,
// u] and hidden [B, u] (float32 or bfloat16).  T launches on `stream`;
// returns the first launch's error (0 = launched).
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
  if (gates == 3) return RunGrid<3, false>(bf16, a, rows, h0, h1, stream);
  if (gates == 4) return RunGrid<4, false>(bf16, a, rows, h0, h1, stream);
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
  return RunGrid<3, true>(bf16, a, batch, h0, h1, stream);
}

// Rows 3 and 5 past the cluster tiles: dg_gru_train_fwd's and
// dg_lstm_train_fwd's arguments (rnn_train.cu), recurrent the zero-padded
// U [W][g][W] float32, then h0, h1 [W][R'] and carry [2][W][R'] zeroed,
// as dg_avg_grid's for 2B rows.  T launches on `stream`; returns the
// first launch's error (0 = launched).
int dg_gru_train_fwd_grid(const void *codes, int batch, int steps,
                          const void *masks, const void *kernel,
                          const void *bias, const void *recurrent, int units,
                          void *avg, void *hidden, void *hseq, void *h0,
                          void *h1, void *carry, void *stream) {
  TrainArgs a =
      TrainHead(codes, batch, steps, masks, kernel, bias, recurrent, units);
  a.avg = static_cast<float *>(avg);
  a.hidden = static_cast<float *>(hidden);
  a.hseq = static_cast<float *>(hseq);
  a.carry = static_cast<float *>(carry);
  return RunTrainFwd<3>(a, h0, h1, stream);
}

int dg_lstm_train_fwd_grid(const void *codes, int batch, int steps,
                           const void *masks, const void *kernel,
                           const void *bias, const void *recurrent,
                           int units, void *avg, void *hidden, void *hseq,
                           void *cseq, void *h0, void *h1, void *carry,
                           void *stream) {
  TrainArgs a =
      TrainHead(codes, batch, steps, masks, kernel, bias, recurrent, units);
  a.avg = static_cast<float *>(avg);
  a.hidden = static_cast<float *>(hidden);
  a.hseq = static_cast<float *>(hseq);
  a.cseq = static_cast<float *>(cseq);
  a.carry = static_cast<float *>(carry);
  return RunTrainFwd<4>(a, h0, h1, stream);
}

// Rows 4 and 6's recurrences past the cluster tiles: the arguments of
// dg_gru_bwd_recurrence / dg_lstm_bwd_recurrence (rnn_train.cu), recurrent
// the padded U as above, transposed the padded U^T [g][W][W] (zero past
// u), carry [W][R'] and cot [2][g W][R'] scratch, zeroed; the gate
// cotangents out (d_rp and d_xp, or da, [2B, T, g u]), for
// dg_train_reduce; (B) in `groups` blocks of 32 units a CTA (1-4; any
// count gives the same bits).  T + 1 launches on `stream`.
int dg_gru_bwd_grid(const void *codes, int batch, int steps,
                    const void *masks, const void *kernel, const void *bias,
                    const void *recurrent, int units, const void *transposed,
                    const void *hseq, const void *d_avg,
                    const void *d_hidden, void *d_rp, void *d_xp,
                    void *carry, void *cot, int groups, void *stream) {
  TrainArgs a =
      TrainHead(codes, batch, steps, masks, kernel, bias, recurrent, units);
  a.transposed = static_cast<const float *>(transposed);
  a.hseq = static_cast<float *>(const_cast<void *>(hseq));
  a.d_avg = static_cast<const float *>(d_avg);
  a.d_hidden = static_cast<const float *>(d_hidden);
  a.d_rp = static_cast<float *>(d_rp);
  a.d_out = static_cast<float *>(d_xp);
  a.carry = static_cast<float *>(carry);
  return RunTrainBwd<3>(a, static_cast<float *>(cot), groups, stream);
}

int dg_lstm_bwd_grid(const void *codes, int batch, int steps,
                     const void *masks, const void *kernel, const void *bias,
                     const void *recurrent, int units,
                     const void *transposed, const void *hseq,
                     const void *cseq, const void *d_avg,
                     const void *d_hidden, void *da, void *carry,
                     void *cot, int groups, void *stream) {
  TrainArgs a =
      TrainHead(codes, batch, steps, masks, kernel, bias, recurrent, units);
  a.transposed = static_cast<const float *>(transposed);
  a.hseq = static_cast<float *>(const_cast<void *>(hseq));
  a.cseq = static_cast<float *>(const_cast<void *>(cseq));
  a.d_avg = static_cast<const float *>(d_avg);
  a.d_hidden = static_cast<const float *>(d_hidden);
  a.d_out = static_cast<float *>(da);
  a.carry = static_cast<float *>(carry);
  return RunTrainBwd<4>(a, static_cast<float *>(cot), groups, stream);
}

// out[0] W (u padded to whole unit blocks: U's rows and columns, h's k),
// out[1] R' (the rows padded to whole row blocks), out[2] row blocks,
// out[3] unit blocks (the grid); returns 0 if the shape is refused.
int dg_grid_shape(int rows, int units, long long *out) {
  return Shape(rows, units, out) ? 1 : 0;
}

// The step's layout for `rows` rows at this width, float32 (bf16 == 0) or
// bf16: out rows a CTA, units a CTA, k a stage, k-slices, threads a CTA,
// stages, then rows and units a thread (float32: FMAs) or a warp (bf16:
// mma.sync); returns 0 if the shape is refused (out untouched).
int dg_grid_layout(int bf16, int rows, int units, int *out) {
  long long shape[4];
  if (!Shape(rows, units, shape)) return 0;
  if (!bf16) {
    const int layout[8] = {kBlockRows, kBlockUnits, kBlockK,     kSplit,
                           kThreads,   kStages,     kThreadRows, kThreadUnits};
    for (int i = 0; i < 8; ++i) out[i] = layout[i];
    return 1;
  }
  const int mma_units = MmaUnits(rows, units);
  if (mma_units == 0) return 0;
  const int layout[8] = {kMmaRows,
                         mma_units,
                         kMmaK,
                         1,
                         mma_units == 32 ? MmaThreads<32>() : MmaThreads<16>(),
                         kMmaStages,
                         kMmaWarpRows,
                         kMmaWarpUnits};
  for (int i = 0; i < 8; ++i) out[i] = layout[i];
  return 1;
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
