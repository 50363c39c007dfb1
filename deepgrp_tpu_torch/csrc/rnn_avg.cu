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
//     bb=2; the fixtures' 64: bb=1), at most 8.  Threads
//     come in lane groups of 4u: thread 4 i + s of a group owns unit i and
//     k-slice s (the float4 quads s, s+4, ... of the recurrent dot) for the
//     group's kWin windows; a CTA has ceil(bb / kWin) groups.
//   * Up to u=64 (kRegUnits) the lane keeps its slice of U (U[k, g u + i]
//     for its 16 k and the g gates: 48 floats GRU, 64 LSTM) in registers,
//     with kWin = 4 (bb=8: 2 groups, 480 threads, 15 warps an SM), or 2
//     when bb <= 2; wider layers read the slice through L1/L2 (one quad's
//     4g entries at a time), with kWin = 8 up to u=128 (4u threads).
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
//     T=342 takes 29,360 B; the width is bounded by the threads (a lane
//     group of 4u <= 512: u <= 128) for both cells.
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
//   * ptxas -v (sm_90a, CUDA 12.8): GRU kWin 4 with U in registers 128
//     registers, kWin 2 with U in registers 111, kWin 8 through L1/L2 126;
//     LSTM kWin 4 with U in registers 128 (28 bytes of spill stores and
//     loads), kWin 2 with U in registers 126, kWin 8 through L1/L2 128;
//     nothing else spills.
//   * What bounds it: the FMA issue of the dot (the floor at 1024 x 342 x
//     60 on 128 SMs is about 0.23 ms GRU, 0.31 ms LSTM) plus the gate math
//     (960 rows x units an SM a step at bb=8; three transcendentals each
//     for the GRU, five for the LSTM), then the latency of the butterfly
//     and the barrier of each step.
// It serves float32 outputs only: the bf16 variants' float32-FMA copy of
// it above u=128 took 8.3761 / 10.5517 ms at u=256, B=256 (GRU / LSTM;
// PR 16's chip_smoke.py), slower than cuDNN's bf16 recurrence, and the
// cluster tile below took its place.
//
// The float32 cluster tile (AvgClusterKernel<kGates, kWin, kCluster,
// kUSmem, 1>), which the float32 entry points run past u=128 up to u=1024
// (kMaxUnits); the route (cuda_rnn.py) sends it u=129-383 and the
// stationary tile (below) u=384-1024, the grid tile (rnn_grid.cu) past
// u=1024.  Past u=128 one CTA a window would read all of U from L2 every
// step (the register tile's 2 windows a CTA at u=256: 8.2622 / 10.7776 ms
// at B=256, slower than cuDNN), and 4u threads stop at u=256.  So a
// window's units split over a thread-block cluster, as the GRU sequence
// kernel's cluster tile (csrc/rnn_seq.cu) splits a row's, with this
// file's windows and input:
//   * The CTA of rank r owns units [r uc, (r + 1) uc), uc = ceil(u /
//     kCluster) <= 64, with all their gates and all k of their columns of
//     U, so its lanes (four k-slices a unit, the register tile's lane
//     groups of kWin windows) form whole gate sums from the CTA's own full
//     copy of h with the fixed butterfly: no partial sum crosses CTAs.
//   * A window's forward and reverse-complement rows sit in the same
//     CTA, so a unit's owner lane does both rows' gate math (Cell, the
//     register tile's float32 arithmetic, the LSTM's c in a register),
//     forms the average and stores avg (and hidden at T-1); it writes
//     the unit's new h of both rows into the next buffer of every CTA of
//     the cluster (st.shared::cluster), and one cluster barrier a step
//     stands where the CTA's barrier stood.
//   * The input is the row select: each CTA keeps its columns of W [5, g
//     uc] in shared memory and its units' biases in registers (pad code
//     5 selects the bias only); the codes are read through L1, so shared
//     memory does not bound T.
//   * Ragged widths: lanes past u (the last CTA's, when kCluster does not
//     divide u) read the last unit's column and store nothing; windows
//     past bb in a group read zero rows of h (no branch in the dot).
//   * Layouts: up to u=256 8 CTAs, each CTA's slice of U in shared memory
//     (98 kB GRU, 130 kB LSTM at u=256), 4 windows a lane group; past it
//     16 CTAs (non-portable) streaming the slice through L1/L2, 8 windows
//     a lane group; 2 when the CTA owns at most 2; at most 8 windows a CTA.
//     The caller counts clusters in a wave and asks the card how many it
//     places at once (dg_avg_clusters): on the H100 15 of 8 CTAs at u=256,
//     of 16 CTAs 21 at u=512 but 7 at u=1024 (the two h buffers of 8
//     windows take 128 kB).
//   * The layouts, timed on an NVIDIA H100 80GB HBM3 at its 700 W limit
//     (tools/avg_tile_sweep.py --min-units 129, T=342, ms a launch, GRU /
//     LSTM): at u=256, B=1024 the register tile 31.9709 / 40.9670, 8 CTAs
//     at 2, 4 and 8 windows a cluster 22.8968, 22.9307, 16.6558 /
//     39.0031, 26.5938, 18.7939; at u=300, B=256 16 CTAs with U in shared
//     memory at 2 windows 14.1780 / 17.0470, through L1/L2 at 2, 4 and 8
//     14.7025, 15.8506, 8.8753 / 22.6416, 20.0151, 11.0055.  So the cluster
//     tile from u=129 on, past u=256 the L1/L2 layout at 8 windows.
//   * ptxas -v (sm_90a, CUDA 12.8): AvgClusterKernel<3, 4, 8, shared> 104
//     registers, <4, 4, 8, shared> 128, <3, 8, 16, L1/L2> 124, <4, 8, 16,
//     L1/L2> 128, kWin 2 96-101; no spills.
//   * What bounds it: up to u=256 the step's latency (a CTA of 4 uc
//     threads, one or two warps a scheduler, the cluster barrier), as the
//     GRU sequence kernel's; past it the L2 stream of U's slices (every
//     cluster reads all of U each step: 3 MB for the GRU at u=512, 12.6
//     MB at u=1024, under 2 TB/s at u=1024, B=64, where 8 clusters run in
//     two waves).
//   * A window's bits depend on its codes and the weights only: each
//     unit's sum runs in an order fixed by u (its quads in order, then the
//     butterfly), nothing is atomic, whatever the window's cluster, CTA
//     or lane.
//   * Where it stops: past u=1024 a CTA of 16 would own more than 64
//     units, more than a lane group of 4 uc threads holds within the
//     launch bounds; the grid tile (rnn_grid.cu: one tiled product a step,
//     U read about once for the batch) was faster at every width past
//     u=1024 and every batch swept (tools/avg_tile_sweep.py --grid).
//
// The float32 stationary tile (AvgStationaryKernel<kGates, kWin, kUt,
// kThreads>, entry point dg_avg_stationary), which the route runs at
// u=384-1024 in place of the cluster tile.  There the cluster tile
// streamed U, not h: the card's 132 SMs hold 132 x 227 kB of shared
// memory, and U (12.6 MB GRU, 16.8 MB LSTM at u=1024) fits on chip once,
// split over the SMs, though not in one cluster.  So U stays put and h
// moves:
//   * One cooperative launch for all T steps (every CTA resident, at most
//     one an SM; a grid the card cannot hold at once is refused and the
//     wrapper raises).  CTA c owns units [c uc, (c + 1) uc), uc = ceil(u /
//     SMs) (8 at u=1024: 128 CTAs), with all their gates and all k of
//     their columns of U, loaded into shared memory once (99 kB GRU, 132
//     kB LSTM at u=1024), k-major a column, padded so that a warp's unit
//     slots start 16 banks apart, and its columns of W.
//   * Every CTA serves every window, in row blocks of `windows` windows.
//     Each step the owners store the new h of their units into one of two
//     buffers [rows][width] of the zeroed scratch (rows 2 w + b; 512 kB at
//     B=64, u=1024, so it stays in L2), and each CTA streams every row
//     block's h back by cp.async in stages of 64 k through a ring of 2-4
//     stages (a wait and a CTA barrier a stage); a grid barrier (an atomic
//     arrival a CTA after a fence, an acquire poll) ends the step.
//   * The lanes: 4 a unit slot (the four k-slices), a lane group of kWin
//     windows, each lane kUt units with all their gates, so a quad of k
//     costs 2 kWin + kUt g float4 loads from shared memory for 16 kWin kUt
//     g FMAs.  The butterfly, the gate math, the average and the stores
//     are the cluster tile's; a lane's carry comes from the scratch (h
//     from the buffer its owner wrote the step before, the LSTM's c from a
//     third buffer only its lane writes).
//   * Variants, (kWin, kUt, threads): (4, 2, 256) where all its row
//     groups fill, else (4, 1, 512) where it has at least 128 threads,
//     else (2, 1, 256) (StatVariant; one that does not fit the shared
//     memory gives way to the next).  Timed on the H100
//     (tools/avg_tile_sweep.py --stationary --variants; GRU, ms (2, 1) /
//     (4, 1) / (4, 2)): u=1024, B=64 26.150 / 14.575 / 12.623; B=16 6.894
//     / 6.137 / 8.291; B=5, T=23 0.394 / 0.485 / 0.762; u=768, B=64 20.176
//     / 9.734 / 10.423; u=512, B=16 3.091 / 3.551 / 5.283; B=256 29.601 /
//     17.250 / 15.701.
//   * Bits: each unit's sum runs in the cluster tile's order (k-slice s
//     takes the quads s, s + 4, ... in order, then the butterfly) into the
//     same gate math, so the outputs equal the cluster tile's bit for bit
//     (tests/test_torch_cuda.py's digests), and a window's bits depend on
//     its codes and the weights only, whatever the batch, row block,
//     variant or CTA.
//   * Timed on an NVIDIA H100 80GB HBM3 at 700 W (tools/avg_tile_sweep.py
//     --stationary; ms stationary / cluster / grid / cuDNN): GRU B=64,
//     u=1024 12.633 / 30.936 / 12.227 / 14.410, LSTM 14.453 / 39.788 /
//     16.743 / 15.031; GRU B=256, u=512 15.763 / 20.490 / 11.209 / 14.421,
//     LSTM 18.168 / 24.754 / 15.577 / 15.372; GRU B=5, T=23, u=1024 0.376 /
//     0.592 / 0.825 / 0.491.  From u=384 it took at most 0.97x the cluster
//     tile's time at every batch swept (B=16, 64, 256 at T=342; B=37,
//     T=150; B=5, T=23); at u=257-352 up to 1.05-1.57x (at B=256), at
//     u=129-256 1.8-3.2x; past u=1024 it lost to the grid tile at B >= 64.
//   * ptxas -v (sm_90a, CUDA 12.8; chip_smoke.py's phase 2):
//     AvgStationaryKernel<3, 2, 1, 256> 96 registers, <3, 4, 1, 512> 117,
//     <3, 4, 2, 256> 168, <4, 2, 1, 256> 110, <4, 4, 1, 512> 116, <4, 4, 2,
//     256> 246; no spills.
//   * What bounds it (tools/avg_stationary_ablation.py, GRU B=64, u=1024,
//     ms): shipped 12.73; no copies of h past the ring's first stages
//     10.72; no grid barrier 12.04; no FMAs 7.68; stages of 32 k 15.94; a
//     ring of 2 stages 12.71.  A step (37 us, 805 MFLOP: a
//     third of the float32 rate) is the FMA loop at two warps a scheduler,
//     a fixed cost a stage (its wait, barrier and copies: halving the
//     stages' k adds 0.6 us each) and the h stream from L2 (all CTAs read
//     the same rows: 64 MB a step at B=64, u=1024), then the barrier.  At
//     B=256 the stream weighs more (u=512: no copies 11.81 of 15.68).
//     Tried and not kept (same bits, slower at every shape tried): each
//     stage multicast to clusters of 2 or 4 CTAs by bulk copies with
//     mbarriers, and mbarriers in place of the CTA barrier a stage.
//
// The bf16 tensor-core tile (MmaAvgKernel<kGates, kKT, kUSmem, kCluster>),
// which the _bf16 entry points run up to u=128 (kMmaUnits) one CTA a
// window, and up to u=1024 as its cluster tile (the last bullets), past
// it up to u=2048 (kMmaWideUnits) as MmaWideKernel<kGates, kKT, 1>.  Bound
// at the flagship shape: the same 14.8 / 19.7 MFLOP a window at the bf16
// tensor-core rate (989 TFLOP/s), 0.0153 ms GRU and 0.0204 ms LSTM at
// B=1024; the recurrence is still sequential in T, so a step's latency,
// not the rate, is what a design can shorten.  Each step is exactly the
// TPU's Precision.DEFAULT dot: h rounded to bf16 (round to nearest even,
// as Io<true>::Operand) times U rounded to bf16, summed in float32, by
// mma.sync.aligned.m16n8k16 (bf16 operands, float32 accumulator):
//   * Rows: an m16 tile holds 8 windows, their forward rows in rows 0-7
//     and their reverse-complement rows in rows 8-15.  The accumulator
//     gives lane l rows l/4 and l/4 + 8, so a lane holds one window's
//     forward and reverse sums for the same units and forms the branch
//     average in registers.
//   * Columns: U's columns are taken as mma sees them, so that the n-tile
//     of each gate covers the same 8 units: a warp owns a unit group of 8
//     and gets all kGates pre-activations of its (row, unit) cells in
//     matching accumulator registers (lane l: units 8 ug + 2 (l % 4) and
//     the next).  The gate math runs where the sums are; no shuffle.  At
//     u=60 (padded to 64) that is 8 unit groups, one warp each for each
//     m-tile.  Padded units and k rows are zero in U and in h and are
//     never stored.
//   * U is loaded once, before the T loop, as bf16 B fragments, in shared
//     memory in fragment order (kUSmem: one 8-byte load a lane a fragment;
//     the LSTM's at u=128 is 128 KB) or in registers (kKT k-tiles x kGates
//     x 2 words: 24 GRU, 32 LSTM at u=64).  Each step a warp reads the A
//     fragments of h with ldmatrix.x4 from a bf16 h buffer in shared
//     memory (rows padded by 8 elements: ldmatrix and the lanes' bf16x2
//     writes of the new h are free of bank conflicts), double-buffered,
//     one barrier a step.  The input rows bias + W[code] (pad: bias; the
//     same float32 add as the FMA tile's) are a [6, g u] table in shared
//     memory, read before the products, and so are the codes.
//   * The gates: Keras's float32 gate math with FastSigmoid and FastTanh
//     (exp through __expf, quotients through __fdividef, a few ulp from
//     libm), the carry in float32.
//   * A row's bits depend only on its own codes and the weights: the
//     k-tiles are summed in an order fixed by u, each mma row only reads
//     its own h row, and nothing is atomic, so neither the batch, nor the
//     windows a CTA, nor the row's place in the tile changes them.
//   * Why mma.sync and not wgmma: a CTA holds at most 16 windows, 32 rows
//     a step, against wgmma's 64-row minimum, and wgmma's asynchronous
//     commit and wait would sit on the critical path of every step.  The
//     products are not what bounds the step (below), so no transposed
//     wgmma (U as the M side) was tried.
//   * The tile, timed on the H100 (tools/avg_tile_sweep.py --kernel
//     avg_bf16, T=342, ms a launch; GRU / LSTM; U in registers, in shared
//     memory):
//       u=60,  B=1024,  8 windows a CTA (128 CTAs): 0.302, 0.319 / 0.392,
//              0.377; 16 (64 CTAs, two warps a unit group): 0.424, 0.458
//              / 0.580, 0.627;
//       u=60,  B=256,   2 windows (128 CTAs): 0.286, 0.300 / 0.354, 0.340;
//       u=60,  B=2048,  8 windows (256 CTAs): 0.382, 0.386 / 0.500, 0.483;
//              16 (128 CTAs): 0.414, 0.449 / 0.582, 0.628;
//       u=96,  B=1024,  8 windows: 0.817, 0.508 / 1.228, 0.659;
//       u=128, B=1024,  8 windows: 1.123, 0.733 / 1.594, 0.907;
//       u=128, B=2048,  8 windows: -, 1.327 / -, 1.765; 16: -, 1.244 / -,
//              1.636 (16 windows 7-8 % faster here; 8 faster below
//              u=128).
//     At kKT 8 the 1,024-thread bound of 16 windows leaves 64 registers,
//     and U in registers spills.  So: at most 8 windows a CTA (kMmaCap,
//     one m-tile); up to u=64 kKT 4, U in registers for the GRU and in
//     shared memory for the LSTM; above, kKT 8 with U in shared memory.
//   * ptxas -v (sm_90a, CUDA 12.8), MmaAvgKernel<gates, kKT, kUSmem>:
//     <3, 4, registers> 96 registers, <3, 4, shared> 68, <4, 4,
//     registers> 128, <4, 4, shared> 74, <3 or 4, 8, shared> 64; <3, 8,
//     registers> and <4, 8, registers> 64 with 224 and 456 bytes of
//     spill stores; nothing else spills.
//   * What bounds it (tools/avg_bf16_ablation.py, PERF.md): the gate
//     math's transcendentals (each lane carries 4 cells, 8 windows x 64
//     units x 2 rows an SM), then a floor of barrier, shared-memory round
//     trips and index math each step; the products cost little.  libm's
//     expf, IEEE quotient and tanhf take the step about 1.5x longer;
//     tanh.approx.f32 (relative error up to 2^-11, not float32 gate math)
//     would save about a quarter.  B=256 (2 windows a CTA) takes about as
//     long as B=1024: a warp runs the same instructions for the padded
//     rows of an m-tile.
//   * Past u=128 a CTA cannot hold U (the LSTM's is 512 KB of fragments
//     at u=256), so the cluster tile (kCluster CTAs, a thread-block
//     cluster; the helpers in rnn_tile.cuh) splits a window's unit groups:
//     the CTA of rank r owns groups [r local, (r + 1) local), local =
//     ceil(groups / kCluster), with their U fragments in its shared
//     memory and their columns of the input rows.  The step is the one
//     above: each warp reads the A fragments of the CTA's own full bf16 h
//     buffer, so it forms whole gate sums (k-tiles in an order fixed by
//     u) and no partial sum crosses CTAs; a window's bits depend on its
//     codes and the weights only, as above, whatever the cluster rank.
//     At the end of a step each lane writes its two units' new h (one
//     bf16x2 word a branch) into the next buffer of every CTA of the
//     cluster (st.shared::cluster), and one cluster barrier
//     (arrive.release, wait.acquire) stands where the CTA's barrier
//     stood.  The codes are read through L1 (shared memory would bound
//     T).  A cluster has 2 CTAs where a CTA's half of U fits the shared
//     memory at 8 windows (GRU up to u=256, 222,720 B; LSTM up to u=224),
//     else 4 (Bf16Cluster); a CTA takes 16 windows (two m-tiles) where
//     they fit, else 8 (MaxWindowsBf16; the GRU past u=240, the LSTM from
//     u=209 to 224); the caller counts clusters in a wave.
//   * The cluster tile, timed on the H100 (tools/avg_tile_sweep.py
//     --kernel avg_bf16 --min-units 129, T=342, ms a launch, my chip call
//     5 of PR 17; GRU / LSTM; clusters of 2 CTAs at 4, 8, 16 windows a
//     CTA, then of 4):
//       u=160, B=256:  0.8226, 0.8545, 1.2080 / 0.9881, 1.0532, 1.4918;
//                      0.8591, 0.8311, 0.9258 / 1.0035, 0.9190, 1.0306;
//       u=160, B=1024: 1.9075, 1.0195, 1.1848 / 3.9740, 2.0782, 1.4925;
//                      2.5937, 1.7277, 2.0932 / 2.9768, 2.2394, 2.3291;
//       u=192, B=256:  0.9319, 0.9963, 1.4727 / 1.0605, 1.1346, 1.7926;
//                      1.0495, 0.9253, 1.0183 / 1.7674, 1.0435, 1.1853;
//       u=192, B=1024: 3.7021, 1.9717, 1.4719 / 4.2133, 2.2279, 1.7875;
//                      3.0401, 2.1933, 2.3037 / 4.6120, 3.0776, 2.6382;
//       u=256, B=256:  1.1760, 1.2648, - / -, -, -;
//                      2.7198, 1.9752, 1.3855 / 2.9214, 2.1135, 1.5863;
//       u=256, B=1024: 4.7594, 2.4685, - / -, -, -;
//                      8.1495, 4.9900, 4.0831 / 8.7628, 5.2931, 4.6418
//     (-: the CTA's shared memory does not fit; the FMA tile took 8.3761
//     / 10.5517 at u=256, B=256 in PR 16's chip_smoke.py).  Two CTAs beat
//     four wherever they fit but at u=160-192, B=256 (by 1-7 %); the
//     fewest windows a CTA that fill one wave win (4 at B=256; at B=1024
//     16, or 8 where 16 do not fit), but for the GRU at u=160, B=1024 (8
//     beat 16 by 14 %).  So the caller's rule (block_windows over the
//     clusters) with these caps.
//   * ptxas -v: MmaAvgKernel<3, 16, shared, 2> 60 registers, <3, 16,
//     shared, 4> 72, <4, 16, shared, 2> 64, <4, 16, shared, 4> 78; no
//     spills.
//   * What bounds it (tools/avg_bf16_ablation.py --units 256, my chip
//     call 5; B=256, GRU 2 CTAs x 4 windows / LSTM 4 CTAs x 8, ms):
//     shipped 1.1964 / 2.1541; the CTA's barrier in place of the
//     cluster's 0.9397 / 1.5681; no DSMEM hand-off 1.1573 / 1.9396; a
//     trivial cell 1.0392 / 1.8336; no mma 1.0842 / 1.9303; tanh.approx
//     1.1017 / 1.9534; two accumulator chains 1.2845 / 2.1033.  A step
//     (3.5 us GRU) is a floor of shared-memory traffic (every warp reads
//     its U fragments, 12 KB a step, and h through ldmatrix: about 330 KB
//     a step an SM), then the cluster barrier (0.75 / 1.7 us a step, skew
//     between the CTAs included), the gates and the mma chain; the
//     hand-off costs 3-10 %.
//   * Past u=256 the cluster tile takes clusters of up to 16 CTAs and 64
//     k-tiles (kKT 32 up to u=512, 64 up to u=1024): the fewest of 2, 4,
//     8 and 16 CTAs whose share of U's fragments fits a CTA beside 8
//     windows (Bf16Cluster: the GRU 4 up to u=352, 8 up to u=496, 16
//     beyond; the LSTM 4 up to u=304, 8 up to u=432, 16 beyond), 16
//     windows a CTA where two m-tiles fit.  Past u=640 (GRU) / 592 (LSTM)
//     not even 16 CTAs hold their fragments (384 / 512 kB a CTA at
//     u=1024): there each warp forms its fragments every step from U read
//     through L1/L2 (UFragment: four float32 loads a fragment, 32 bytes of
//     a column in each of four rows a warp, so every sector is used) and
//     rounds them as the shared-memory variant does, a few k-tiles in
//     flight (unrolled over all 64, the compiler hoisted every load into
//     registers and spilled 8-12 kB).
//   * Timed on an NVIDIA H100 80GB HBM3 at 700 W (tools/avg_tile_sweep.py
//     --kernel avg_bf16 --min-units 257, T=342, ms at 4, 8 and 16 windows
//     a CTA, GRU / LSTM): u=300, B=256, clusters of 4: 3.1524, 2.3503,
//     1.7201 / 3.7451, 2.6397, - (does not fit); of 8: 3.1398, 2.5671,
//     2.5363 / 5.1791, 3.1215, 2.8589; of 16: 4.6390, 3.1571, 3.6653 /
//     5.7894, 4.1229, 4.0298; u=512, B=256, 16 CTAs: 12.5263, 7.0229,
//     5.4198 / 12.8178, 7.1345, 5.6569; u=640, B=256, 16 CTAs, fragments
//     in shared memory: 15.7924, 8.6038, - / -, -, - (do not fit); through
//     L1/L2: 24.3068, 14.6253, 16.8169 / 30.5518, 18.3873, 19.3295;
//     u=1024, B=64, through L1/L2: 21.8873, 11.6813, 11.5368 / 27.6849,
//     14.7301, 14.5990.  So the fewest CTAs that fit, as up to u=256.
//   * ptxas -v: MmaAvgKernel<3, 32, shared, 4 / 8 / 16> 60 / 76 / 84
//     registers, <4, 32, shared, 4 / 8 / 16> 64 / 82 / 90, <3 or 4, 64,
//     shared, 16> 84 / 90, no spills; <3, 64, L1/L2, 16> 128 registers
//     and 8 bytes of spill stores, <4, 64, L1/L2, 16> 128 and 4.
//   * What bounds it past u=640: the L2 stream of U (each cluster reads
//     all of U in float32 each step, 12.6 / 16.8 MB at u=1024), as the
//     float32 tile; pre-rounded bf16 fragments in device memory would
//     halve it.
//   * Past u=1024 (128 k-tiles up to u=2048) MmaWideKernel runs that
//     16-CTA route, forming fragments from U through L1/L2, with one
//     m-tile (at most 8 windows a CTA): two m-tiles of 16 rows at u=2048
//     would take 263 kB of h buffers.  The h buffers hold only the CTA's 2
//     bb rows (MmaLayout's compact rows, window w's branch b at row b bb +
//     w; the ldmatrix lanes of windows past bb address the last window's
//     rows, whose sums are dropped), so a CTA takes 8 windows at u=2048
//     (MaxWindowsBf16).  A warp owns one unit group (16 warps).  The step
//     is MmaAvgKernel's, so a row's bits depend on its codes and the
//     weights only; the recurrent dot stays Precision.DEFAULT: bf16
//     operands, float32 sums and carry.  A kernel of its own: the same
//     changes made inside MmaAvgKernel (the compact rows and their flags)
//     took its one-CTA tile 3-10 % longer at u <= 128 on the H100 (timed
//     in turns with the kernel without them; here its times are within
//     0.6 % of that kernel's at every width to u=1024).
//   * ptxas -v: MmaWideKernel<3, 128, 1> 128 registers, <4, 128, 1> 126,
//     no spills.
//   * Where it stops: the library takes up to u=2048 (a CTA of 16 would
//     own more than 16 unit groups past it), but the route sends u=1280 on
//     to the grid tile's bf16 step (rnn_grid.cu, mma.sync too), faster at
//     every batch swept from u=1280 (tools/avg_tile_sweep.py --grid on an
//     NVIDIA H100 80GB HBM3 at 700 W, ms cluster / grid: GRU B=64, u=2048
//     52.040 / 13.884; B=16, u=1280 10.003 / 8.243); at u=1025 the LSTM
//     at B=16, T=342 keeps the cluster tile (8.786 / 9.329).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "rnn_mma.cuh"
#include "rnn_tile.cuh"

namespace {

constexpr int kCodes = 5;  // W rows: A, C, G, T, N; pad (5) selects none
constexpr int kPadCode = 5;
constexpr int kMaxThreads = 1024;
constexpr int kTileUnits = 128;  // widest layer of the register tile
constexpr int kMmaUnits = 128;   // widest layer of one CTA a window
constexpr int kMmaWindows = 16;  // most windows a CTA of that tile takes
constexpr int kMmaCap = 8;       // most the bf16 entry points give it
// The bf16 cluster tile's ceiling (MmaWideKernel past kMaxUnits); the
// route (cuda_rnn.BF16_CLUSTER_MAX_UNITS) runs the grid tile from u=1280.
constexpr int kMmaWideUnits = 2048;

// ---- The float32 cluster tile's layout ------------------------------------

// CTAs a cluster of the float32 kernels at this width (1: the register
// tile, one CTA a window; see the note above); each CTA of 8 keeps its
// slice of U in shared memory, of 16 reads it through L1/L2.
__host__ __device__ __forceinline__ int AvgCluster(int units) {
  return units <= kTileUnits ? 1 : units <= 256 ? 8 : 16;
}

// Floats a k row of a CTA's shared slice of U takes: its g uc columns,
// padded to 2 mod 8 so that the four lanes of a unit (4 k rows apart, 8
// banks apart) read other banks.
__host__ __device__ __forceinline__ int UColStride(int cols) {
  return cols + ((2 - cols) % 8 + 8) % 8;
}

// Shared memory of the float32 cluster tile in bytes, for bb windows a CTA
// in lane groups of `win`: the doubled h of the windows (padded to whole
// groups) twice, the CTA's columns of W [5][g uc] and, with u_smem, its
// slice of U [Pad4(u)][UColStride(g uc)].
__host__ __device__ inline size_t ClusterSmem(int gates, int units, int bb,
                                              int win, int cluster,
                                              bool u_smem) {
  const int uc = (units + cluster - 1) / cluster;
  const size_t rows_pad = 2 * static_cast<size_t>((bb + win - 1) / win) * win;
  const size_t u_floats =
      u_smem ? static_cast<size_t>(Pad4(units)) * UColStride(gates * uc) : 0;
  return sizeof(float) * (2 * rows_pad * Pad4(units) +
                          static_cast<size_t>(kCodes) * gates * uc +
                          u_floats);
}

// The launch bound of the cluster tile: a CTA owns at most 64 units and 8
// windows, in one or two lane groups of 4 uc threads (256), but 8
// windows a group through L1/L2 keep 512 (128 registers), as the GRU
// sequence kernel's 16 rows a group do (csrc/rnn_seq.cu).
__host__ __device__ constexpr int ClusterThreads(int win, bool u_smem) {
  return win >= 8 && !u_smem ? 512 : 256;
}

// Windows a CTA (of a cluster: each of its CTAs) of the float32 kernels
// may own at this width (0: refused): 8 up to kMaxUnits.
__host__ __device__ __forceinline__ int MaxWindows(int units) {
  return units > 0 && units <= kMaxUnits ? 8 : 0;
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

// ---- The step of a lane group, shared by both float32 tiles ---------------

// Adds quad q of the lane's k-slice to the gate partials of its group's 2
// kWin rows: u(c, g) is U[4 q + c] of gate g in the lane's column, row(w,
// b) the h of window w's branch b in shared memory.  Each U entry, loaded
// once, feeds 2 kWin rows.
template <int kWin, int kGates, typename UAt, typename Row>
__device__ __forceinline__ void QuadDot(float (&acc)[kWin][2][kGates], int q,
                                        const UAt &u, const Row &row) {
  float u_q[4][kGates];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int g = 0; g < kGates; ++g) u_q[c][g] = u(c, g);
  }
#pragma unroll
  for (int w = 0; w < kWin; ++w) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float4 h4 = reinterpret_cast<const float4 *>(row(w, b))[q];
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

// A window's step on both branches from their sums and codes: the gate
// math on the input rows (w_col: the lane's column of W [5][..], rows
// w_stride apart, gates g_stride apart; pad selects none), the new h to
// store(b, h), and the branch average of the unit (column `unit` of avg
// [B, T, u]) at step t, and of hidden at T-1, for a row in the batch.
template <int kGates, typename Store>
__device__ __forceinline__ void StepWindow(
    const Cell<kGates> &cell, const float (&dot)[2][kGates],
    const int (&code)[2], const float *w_col, int w_stride, int g_stride,
    float (&h)[2], float (&c)[2], const Store &store, int row, int batch,
    int steps, int t, int units, int unit, float *__restrict__ avg,
    float *__restrict__ hidden) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const bool has_w = static_cast<unsigned>(code[b]) < kCodes;
    cell.step(dot[b], w_col + (has_w ? code[b] : 0) * w_stride, has_w,
              g_stride, h[b], c[b]);
    store(b, h[b]);
  }
  if (row < batch) {
    const float mean = (h[0] + h[1]) * 0.5f;
    avg[(static_cast<size_t>(row) * steps + t) * units + unit] = mean;
    if (t == steps - 1) hidden[static_cast<size_t>(row) * units + unit] = mean;
  }
}

// kWin windows a lane group (4u threads); ceil(bb / kWin) groups a CTA.
template <int kGates, int kWin, bool kURegs>
__global__ void __launch_bounds__(kMaxThreads / 2, 1)
AvgKernel(const int8_t *__restrict__ codes, int batch, int steps,
          const float *__restrict__ kernel, const float *__restrict__ bias,
          const float *__restrict__ recurrent, int units, int bb,
          float *__restrict__ avg, float *__restrict__ hidden) {
  static_assert(kWin == 2 || kWin == 4 || kWin == 8, "kWin: 2, 4 or 8");
  constexpr int kOwn = OwnWindows(kWin);
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
  USlice<kGates, kURegs, false> us;
  us.load(recurrent, units, i, s);
  Cell<kGates> cell;
  cell.load(bias, units, i);
  const unsigned lanes = WarpLanes();
  const int n_quads = Pad4(units) / 4 > s
                          ? (Pad4(units) / 4 - s + kSlices - 1) / kSlices
                          : 0;
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

    float acc[kWin][2][kGates] = {};
    auto quad = [&](int m) {
      QuadDot<kWin, kGates>(
          acc, s + kSlices * m,
          [&](int c, int g) { return us.at(m, c, g, s, units, i); },
          [&](int w, int b) { return h_cur + h_row[w] + b * hstride; });
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
    // and s ^ 2 hold the same bits).  Written out in each kernel: as a
    // shared helper it made the cluster tile's step slower on the H100.
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
      const int w = OwnWindow<kWin>(w0, s, j);
      if (!writer || w >= bb) continue;
      const int8_t *w_codes = s_codes + w * steps;
      const int code_b[2] = {w_codes[t], Complement(w_codes[steps - 1 - t])};
      StepWindow(
          cell, dot[j], code_b, s_w + i, width, units, h_own[j], c_own[j],
          [&](int b, float h) { h_nxt[(2 * w + b) * hstride + i] = h; },
          row0 + w, batch, steps, t, units, i, avg, hidden);
    }
    __syncthreads();
  }
}

template <int kGates, int kWin, bool kURegs>
int LaunchTile(const void *codes, int batch, int steps, const void *kernel,
               const void *bias, const void *recurrent, int units, int bb,
               void *avg, void *hidden, cudaStream_t stream) {
  const auto fn = AvgKernel<kGates, kWin, kURegs>;
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
      static_cast<float *>(avg), static_cast<float *>(hidden));
  return static_cast<int>(cudaGetLastError());
}

// The float32 cluster tile (see the note above): kCluster CTAs a cluster
// split a window's units, uc = ceil(u / kCluster) each; kWin windows a
// lane group of 4 UnitSpan(uc, kUnits) threads, ceil(bb / kWin) groups a
// CTA, each lane owning kUnits of the CTA's units (LaneUnit); kUSmem keeps
// the CTA's slice of U in shared memory (else it is read through L1/L2).
// Every launch runs one unit a lane (kUnits 1): the unit loop stays
// because this is the code whose machine code was measured; the same
// kernel without it compiles to other SASS for the 8-CTA layouts (ptxas,
// sm_90a, CUDA 12.8; tools/train_turns.py --sass --libs rnn_avg).
template <int kGates, int kWin, int kCluster, bool kUSmem, int kUnits = 1>
__global__ void __launch_bounds__(ClusterThreads(kWin, kUSmem), 1)
AvgClusterKernel(const int8_t *__restrict__ codes, int batch, int steps,
                 const float *__restrict__ kernel,
                 const float *__restrict__ bias,
                 const float *__restrict__ recurrent, int units, int bb,
                 float *__restrict__ avg, float *__restrict__ hidden) {
  static_assert(kWin == 2 || kWin == 4 || kWin == 8, "kWin: 2, 4 or 8");
  static_assert(kCluster > 1, "one CTA a window is the register tile");
  static_assert(kUnits == 1 || !kUSmem,
                "several units a lane read U through L1/L2");
  constexpr int kOwn = OwnWindows(kWin);
  extern __shared__ float4 smem4[];
  const int width = kGates * units;
  const int hstride = Pad4(units);
  const int rows_pad = 2 * ((bb + kWin - 1) / kWin) * kWin;
  // The CTA's units of a window: [base, base + uc), with their columns of
  // W, the biases and U (cols a row).
  const int uc = (units + kCluster - 1) / kCluster;
  const int base = static_cast<int>(ClusterRank()) * uc;
  const int cols = kGates * uc;
  const int ustride = UColStride(cols);
  const int span = UnitSpan(uc, kUnits);
  float *s_h = reinterpret_cast<float *>(smem4);  // [2][rows_pad][hstride]
  float *s_w = s_h + 2 * rows_pad * hstride;      // [5][cols]
  float *s_u = s_w + kCodes * cols;               // [Pad4(u)][ustride]

  const int tid = threadIdx.x;
  const int group = tid / (kSlices * span);
  const int lane = tid - group * kSlices * span;
  const int i = lane / kSlices, s = lane % kSlices;
  const int w0 = group * kWin;
  const int row0 = blockIdx.x / kCluster * bb;
  for (int j = tid; j < 2 * rows_pad * hstride; j += blockDim.x) {
    s_h[j] = 0.0f;
  }
  // Column o of the CTA's cols (gate o / uc, unit base + o % uc) in a
  // matrix of the window's width; -1 past u.
  auto column = [&](int o) {
    const int g = o / uc, n = base + o - g * uc;
    return n < units ? g * units + n : -1;
  };
  for (int j = tid; j < kCodes * cols; j += blockDim.x) {
    const int c = j / cols, col = column(j - c * cols);
    s_w[j] = col >= 0 ? kernel[c * width + col] : 0.0f;
  }
  if constexpr (kUSmem) {
    for (int j = tid; j < Pad4(units) * ustride; j += blockDim.x) {
      const int k = j / ustride, o = j - k * ustride;
      const int col = o < cols && k < units ? column(o) : -1;
      s_u[j] = col >= 0 ? recurrent[k * width + col] : 0.0f;
    }
  }
  // The lane's units of the window (local[j] of the CTA's).  A lane past
  // u (the last CTA's, when kCluster does not divide u) or past the CTA's
  // units reads the last unit's column of U and bias; its sums are
  // dropped.
  int local[kUnits], unit[kUnits], u_col[kUnits];
  bool writer[kUnits];
  bool writes = false;
  Cell<kGates> cell[kUnits];
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    local[j] = LaneUnit(i, span, j);
    unit[j] = base + local[j];
    u_col[j] = min(unit[j], units - 1);
    writer[j] = (kWin >= 4 || s < 2) && (kUnits == 1 || local[j] < uc) &&
                unit[j] < units;
    writes = writes || writer[j];
    cell[j].load(bias, units, u_col[j]);
  }
  USlice<kGates, false, false> us;
  us.load(recurrent, units, u_col[0], s);
  const float *u_lane = s_u + i;
  const unsigned lanes = WarpLanes();
  const int n_quads = Pad4(units) / 4 > s
                          ? (Pad4(units) / 4 - s + kSlices - 1) / kSlices
                          : 0;
  float h_own[kUnits][kOwn][2] = {}, c_own[kUnits][kOwn][2] = {};
  // The h buffers of the cluster's CTAs (the first must not be written
  // before its CTA has zeroed it: the barrier below).
  uint32_t h_peer[kCluster];
#pragma unroll
  for (int p = 0; p < kCluster; ++p) h_peer[p] = PeerAddress(s_h, p);
  ClusterBarrier();

  for (int t = 0; t < steps; ++t) {
    // The codes of the lane's windows (they do not wait for h), through
    // L1: windows past the batch read pad.
    int code_b[kOwn][2];
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int w = OwnWindow<kWin>(w0, s, j), row = row0 + w;
      const int8_t *w_codes = codes + static_cast<size_t>(row) * steps;
      const bool in_batch = writes && w < bb && row < batch;
      code_b[j][0] = in_batch ? w_codes[t] : kPadCode;
      code_b[j][1] = in_batch ? Complement(w_codes[steps - 1 - t])
                              : kPadCode;
    }
    // The group's rows (the windows past bb are zero rows: no branch in
    // the dot).
    const float *h_cur = s_h + ((t & 1) * rows_pad + 2 * w0) * hstride;
    const int nxt = ((t + 1) & 1) * rows_pad * hstride;

    // The lane's units one after the other.
#pragma unroll
    for (int n = 0; n < kUnits; ++n) {
      float acc[kWin][2][kGates] = {};
      for (int m = 0; m < n_quads; ++m) {
        const int q = s + kSlices * m;
        QuadDot<kWin, kGates>(
            acc, q,
            [&](int c, int g) {
              if constexpr (kUSmem) {
                return u_lane[(4 * q + c) * ustride + g * uc];
              } else {
                return us.at(m, c, g, s, units, u_col[n]);
              }
            },
            [&](int w, int b) { return h_cur + (2 * w + b) * hstride; });
      }
      // The register tile's butterfly.
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

      // The gate math of the lane's windows, both branches; the unit's
      // new h into every CTA's next buffer (its own too).
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const int w = OwnWindow<kWin>(w0, s, j);
        if (!writer[n] || w >= bb) continue;
        StepWindow(
            cell[n], dot[j], code_b[j], s_w + local[n], cols, uc,
            h_own[n][j], c_own[n][j],
            [&](int b, float h) {
              const uint32_t at =
                  sizeof(float) * (nxt + (2 * w + b) * hstride + unit[n]);
#pragma unroll
              for (int p = 0; p < kCluster; ++p) {
                StoreCluster(h_peer[p] + at, h);
              }
            },
            row0 + w, batch, steps, t, units, unit[n], avg, hidden);
      }
    }
    ClusterBarrier();
  }
}

// Launches a layout of the cluster tile; with `slots`, launches nothing
// and writes the clusters of it the card runs at once (0 if it cannot
// place one).
template <int kGates, int kWin, int kCluster, bool kUSmem>
int LaunchClusterTile(const void *codes, int batch, int steps,
                      const void *kernel, const void *bias,
                      const void *recurrent, int units, int bb, void *avg,
                      void *hidden, cudaStream_t stream,
                      int *slots = nullptr) {
  const auto fn = AvgClusterKernel<kGates, kWin, kCluster, kUSmem>;
  const int uc = (units + kCluster - 1) / kCluster;
  const int threads = (bb + kWin - 1) / kWin * kSlices * uc;
  if (threads > ClusterThreads(kWin, kUSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      ClusterSmem(kGates, units, bb, kWin, kCluster, kUSmem);
  if (slots != nullptr) {
    *slots = ClusterSlots(fn, threads, smem, kCluster);
    return 0;
  }
  const auto f32 = [](const void *p) { return static_cast<const float *>(p); };
  return static_cast<int>(LaunchCluster(
      fn, (batch + bb - 1) / bb * kCluster, threads, smem, kCluster, stream,
      static_cast<const int8_t *>(codes), batch, steps, f32(kernel),
      f32(bias), f32(recurrent), units, bb, static_cast<float *>(avg),
      static_cast<float *>(hidden)));
}

// ---- The float32 stationary tile -------------------------------------------

constexpr int kStatK = 64;          // k of a stage of h (16 quads)
constexpr int kStatHStride = kStatK + 4;  // floats a row of a stage
constexpr int kStatStages = 4;      // most stages of the ring
constexpr int kStatCount = 64;      // floats before h in the scratch (the
                                    // barrier's count, then padding)

// The stationary tile's variants: (windows a lane group, units a lane,
// most threads a CTA) = (2, 1, 256), (4, 1, 512), (4, 2, 256).
constexpr int kStatVariants = 3;
__host__ __device__ constexpr int StatWin(int v) { return v == 0 ? 2 : 4; }
__host__ __device__ constexpr int StatUnits(int v) { return v == 2 ? 2 : 1; }
__host__ __device__ constexpr int StatThreads(int v) {
  return v == 1 ? 512 : 256;
}

// The layout of the stationary tile for one launch (host and device):
// each CTA owns uc units of the width with all their gates and all k of
// their columns of U (in shared memory for the whole launch), for every
// window of the batch, which it takes in row blocks of `windows` windows
// (row_groups lane groups of `win` windows; a lane group has 4 threads a
// unit slot, `groups` slots of `per_lane` units), each row block's h
// streamed from the scratch in stages of kStatK k through a ring of
// `stages` buffers.  threads == 0: refused.
struct StatLayout {
  int uc, ctas, groups, row_groups, threads, windows, blocks, width;
  int ustride, stages, rows_pad;
  int u_floats, w_floats, stage_floats;
  size_t smem, scratch;

  StatLayout() = default;
  __host__ StatLayout(int gates, int units, int batch, int win, int per_lane,
                      int max_threads, int sms, size_t optin) {
    *this = StatLayout{};
    if (units <= 0 || batch <= 0 || sms <= 0) return;
    uc = (units + sms - 1) / sms;
    ctas = (units + uc - 1) / uc;
    groups = (uc + per_lane - 1) / per_lane;
    const int most = max_threads / (kSlices * groups);
    if (most < 1) return;
    row_groups = std::min(most, (batch + win - 1) / win);
    windows = row_groups * win;
    blocks = (batch + windows - 1) / windows;
    width = (units + kStatK - 1) / kStatK * kStatK;
    // Columns a unit slot apart start 16 banks apart (see the note).
    ustride = width + 16 / per_lane;
    u_floats = gates * uc * ustride;
    w_floats = Pad4(kCodes * gates * uc);
    stage_floats = 2 * windows * kStatHStride;
    const size_t fixed = sizeof(float) * (static_cast<size_t>(u_floats) +
                                          w_floats);
    const size_t stage = sizeof(float) * static_cast<size_t>(stage_floats);
    if (optin < fixed + 2 * stage) return;
    stages = static_cast<int>(std::min<size_t>(kStatStages,
                                               (optin - fixed) / stage));
    smem = fixed + stages * stage;
    rows_pad = blocks * 2 * windows;
    // The count, the two h buffers and (LSTM) the carry, zeroed.
    scratch = sizeof(float) *
              (kStatCount + static_cast<size_t>(gates == 4 ? 3 : 2) *
                                rows_pad * width);
    threads = kSlices * groups * row_groups;
  }
};

struct StatArgs {
  const int8_t *codes;
  const float *kernel, *bias, *recurrent;
  unsigned *count;          // the grid barrier's arrivals
  float *h;                 // [2][rows_pad][width], rows 2 w + b
  float *carry;             // [rows_pad][width] (LSTM's c)
  float *avg, *hidden;
  int batch, steps, units;
  StatLayout lay;
};

__device__ __forceinline__ void StatCopy16(void *smem, const void *gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void StatCommit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most stages - 2 groups are pending: the oldest stage of
// the ring has landed.
__device__ __forceinline__ void StatWait(int stages) {
  if (stages <= 2) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (stages == 3) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

// Every CTA of the (cooperative) launch has arrived `target` times in all:
// the h stores of each CTA before it are seen by every CTA after it.
__device__ __forceinline__ void GridBarrier(unsigned *count,
                                            unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// The stationary tile (see the note above): one cooperative launch for
// all T steps; CTA c owns units [c uc, (c + 1) uc) with their slice of U in
// shared memory; each step every CTA streams the h of every row from the
// scratch (row blocks, stages of kStatK k), forms whole gate sums of its
// units (four k-slices, the butterfly), does their gate math and writes
// their new h back; a grid barrier ends the step.
template <int kGates, int kWin, int kUt, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
AvgStationaryKernel(const StatArgs a) {
  static_assert(kWin == 2 || kWin == 4 || kWin == 8, "kWin: 2, 4 or 8");
  constexpr int kOwn = OwnWindows(kWin);
  constexpr int kCols = kUt * kGates;
  constexpr int kStageQuads = kStatK / 4;
  extern __shared__ float4 smem4[];
  const StatLayout &lay = a.lay;
  const int units = a.units, uc = lay.uc, cols = kGates * uc;
  const int width = lay.width, steps = a.steps, batch = a.batch;
  float *s_u = reinterpret_cast<float *>(smem4);  // [g uc][ustride]
  float *s_w = s_u + lay.u_floats;                // [5][g uc]
  float *s_h = s_w + lay.w_floats;                // [stages][2 windows][hs]
  const int base = static_cast<int>(blockIdx.x) * uc;
  const int tid = threadIdx.x;
  const int group = tid / kSlices, s = tid % kSlices;
  const int slot = group % lay.groups;
  const int w0 = group / lay.groups * kWin;  // in a row block

  // The CTA's columns of U (column g uc + j: gate g of unit base + j),
  // k-major a column, zero past u; a warp reads a k row's uc units.
  for (int j = tid; j < units * cols; j += blockDim.x) {
    const int k = j / cols, o = j - k * cols;
    const int g = o / uc, n = base + o - g * uc;
    s_u[o * lay.ustride + k] =
        n < units ? a.recurrent[k * kGates * units + g * units + n] : 0.0f;
  }
  for (int j = tid; j < cols * (lay.ustride - units); j += blockDim.x) {
    const int o = j / (lay.ustride - units);
    s_u[o * lay.ustride + units + j - o * (lay.ustride - units)] = 0.0f;
  }
  for (int j = tid; j < kCodes * cols; j += blockDim.x) {
    const int c = j / cols, o = j - c * cols;
    const int g = o / uc, n = base + o - g * uc;
    s_w[j] = n < units ? a.kernel[c * kGates * units + g * units + n] : 0.0f;
  }

  // The lane's units: local[j] of the CTA's (a slot past uc reads the
  // last one's column and stores nothing).
  int local[kUt], unit[kUt];
  bool valid[kUt];
  Cell<kGates> cell[kUt];
  const float *u_col[kUt][kGates];
#pragma unroll
  for (int j = 0; j < kUt; ++j) {
    local[j] = slot * kUt + j;
    unit[j] = base + local[j];
    valid[j] = local[j] < uc && unit[j] < units;
    const int l = min(local[j], uc - 1);
    cell[j].load(a.bias, units, min(unit[j], units - 1));
#pragma unroll
    for (int g = 0; g < kGates; ++g) u_col[j][g] = s_u + (g * uc + l) *
                                                      lay.ustride;
  }
  const bool writer = kWin >= 4 || s < 2;
  const unsigned lanes = WarpLanes();
  const int n_quads = Pad4(units) / 4;
  const int k_blocks = width / kStatK;
  const int chunks = lay.blocks * k_blocks;
  const int stages = lay.stages;
  const size_t buffer = static_cast<size_t>(lay.rows_pad) * width;
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float *h_cur = a.h + (t & 1) * buffer;
    float *h_nxt = a.h + ((t + 1) & 1) * buffer;
    // Chunk c: k block c % k_blocks of row block c / k_blocks, into stage
    // c % stages (an empty group past the last chunk keeps the count).
    const auto issue = [&](int c) {
      if (c < chunks) {
        const int rb = c / k_blocks, kb = c - rb * k_blocks;
        float *dst = s_h + (c % stages) * lay.stage_floats;
        const float *src =
            h_cur + static_cast<size_t>(rb) * 2 * lay.windows * width +
            kb * kStatK;
        for (int i = tid; i < 2 * lay.windows * kStageQuads;
             i += blockDim.x) {
          const int r = i / kStageQuads, q = i - r * kStageQuads;
          StatCopy16(dst + r * kStatHStride + 4 * q,
                     src + static_cast<size_t>(r) * width + 4 * q);
        }
      }
      StatCommit();
    };
    for (int c = 0; c < stages - 1; ++c) issue(c);

    float acc[kWin][2][kCols];
    float h_own[kOwn][kUt][2], c_own[kOwn][kUt][2];
    for (int c = 0; c < chunks; ++c) {
      StatWait(stages);
      __syncthreads();
      issue(c + stages - 1);
      const int rb = c / k_blocks, kb = c - rb * k_blocks;
      if (kb == 0) {
#pragma unroll
        for (int w = 0; w < kWin; ++w) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
#pragma unroll
            for (int o = 0; o < kCols; ++o) acc[w][b][o] = 0.0f;
          }
        }
        // The carry of the lane's windows (written by this lane the step
        // before; h by its owner CTA, read from L2).
#pragma unroll
        for (int jw = 0; jw < kOwn; ++jw) {
          const int row = rb * lay.windows + OwnWindow<kWin>(w0, s, jw);
#pragma unroll
          for (int j = 0; j < kUt; ++j) {
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const size_t at = static_cast<size_t>(2 * row + b) * width +
                                min(unit[j], units - 1);
              h_own[jw][j][b] = __ldcg(h_cur + at);
              c_own[jw][j][b] = kGates == 4 ? a.carry[at] : 0.0f;
            }
          }
        }
      }
      const float *stage = s_h + (c % stages) * lay.stage_floats +
                           2 * w0 * kStatHStride;
      // Quad ql of the stage (q of the width) into the sums.
      const auto quad = [&](int ql, int q) {
        float u_q[4][kCols];
#pragma unroll
        for (int j = 0; j < kUt; ++j) {
#pragma unroll
          for (int g = 0; g < kGates; ++g) {
            const float4 v =
                *reinterpret_cast<const float4 *>(u_col[j][g] + 4 * q);
            u_q[0][j * kGates + g] = v.x;
            u_q[1][j * kGates + g] = v.y;
            u_q[2][j * kGates + g] = v.z;
            u_q[3][j * kGates + g] = v.w;
          }
        }
#pragma unroll
        for (int w = 0; w < kWin; ++w) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float4 h4 = *reinterpret_cast<const float4 *>(
                stage + (2 * w + b) * kStatHStride + 4 * ql);
            const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
            for (int cq = 0; cq < 4; ++cq) {
#pragma unroll
              for (int o = 0; o < kCols; ++o) {
                acc[w][b][o] = fmaf(hv[cq], u_q[cq][o], acc[w][b][o]);
              }
            }
          }
        }
      };
      if ((kb + 1) * kStageQuads <= n_quads) {
#pragma unroll
        for (int m = 0; m < kStageQuads / kSlices; ++m) {
          quad(s + kSlices * m, kb * kStageQuads + s + kSlices * m);
        }
      } else {
#pragma unroll
        for (int m = 0; m < kStageQuads / kSlices; ++m) {
          const int ql = s + kSlices * m;
          if (kb * kStageQuads + ql < n_quads) {
            quad(ql, kb * kStageQuads + ql);
          }
        }
      }
      if (kb != k_blocks - 1) continue;

      // The row block's sums are whole: the butterfly, the gate math of
      // the lane's windows and units, the new h and c, the average.
      float dot[kOwn][2][kCols];
      if constexpr (kWin >= 4) {
        float half[kWin / 2][2][kCols];
        FoldWindows<kWin, kCols>(acc, s & 1, 1, lanes, half);
        FoldWindows<kWin / 2, kCols>(half, (s >> 1) & 1, 2, lanes, dot);
      } else {
        FoldWindows<kWin, kCols>(acc, s & 1, 1, lanes, dot);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int o = 0; o < kCols; ++o) {
            dot[0][b][o] += __shfl_xor_sync(lanes, dot[0][b][o], 2);
          }
        }
      }
#pragma unroll
      for (int jw = 0; jw < kOwn; ++jw) {
        const int row = rb * lay.windows + OwnWindow<kWin>(w0, s, jw);
        if (!writer || row >= batch) continue;
        const int8_t *w_codes = a.codes + static_cast<size_t>(row) * steps;
        const int code_b[2] = {w_codes[t], Complement(w_codes[steps - 1 - t])};
#pragma unroll
        for (int j = 0; j < kUt; ++j) {
          if (!valid[j]) continue;
          float d[2][kGates];
#pragma unroll
          for (int b = 0; b < 2; ++b) {
#pragma unroll
            for (int g = 0; g < kGates; ++g) d[b][g] = dot[jw][b][j * kGates + g];
          }
          StepWindow(
              cell[j], d, code_b, s_w + local[j], cols, uc, h_own[jw][j],
              c_own[jw][j],
              [&](int b, float h) {
                const size_t at =
                    static_cast<size_t>(2 * row + b) * width + unit[j];
                h_nxt[at] = h;
                if constexpr (kGates == 4) a.carry[at] = c_own[jw][j][b];
              },
              row, batch, steps, t, units, unit[j], a.avg, a.hidden);
        }
      }
    }
    if (t + 1 < steps) GridBarrier(a.count, (t + 1) * gridDim.x);
  }
}

// Calls f with the kernel of (gates, variant v); -1 for an unknown
// variant.
template <int kGates, int v, typename F>
int StatWith(const F &f) {
  return f(AvgStationaryKernel<kGates, StatWin(v), StatUnits(v),
                               StatThreads(v)>);
}

template <typename F>
int StatWithKernel(int gates, int v, const F &f) {
  switch (gates * 10 + v) {
    case 30: return StatWith<3, 0>(f);
    case 31: return StatWith<3, 1>(f);
    case 32: return StatWith<3, 2>(f);
    case 40: return StatWith<4, 0>(f);
    case 41: return StatWith<4, 1>(f);
    case 42: return StatWith<4, 2>(f);
  }
  return -1;
}

// A cooperative launch of the layout's grid, or with `fits`, none:
// whether the card holds every CTA at once (1) or not (0).
template <typename Kernel>
int StatLaunch(Kernel fn, const StatArgs &a, cudaStream_t stream,
               int *fits = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(a.lay.smem));
  // Every CTA must be resident (a grid barrier each step): refused where
  // the card cannot hold the grid at once.
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, a.lay.threads, a.lay.smem);
  }
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fits != nullptr) {
    *fits = per_sm * sms >= a.lay.ctas;
    return 0;
  }
  if (per_sm * sms < a.lay.ctas) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.lay.ctas);
  config.blockDim = dim3(a.lay.threads);
  config.dynamicSmemBytes = a.lay.smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, fn, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The layout of variant `v` (0 .. kStatVariants - 1) on the current card.
inline StatLayout StatLayoutOf(int gates, int units, int batch, int v) {
  int device = 0, sms = 0;
  if (v < 0 || v >= kStatVariants ||
      cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return StatLayout{};
  }
  return StatLayout(gates, units, batch, StatWin(v), StatUnits(v),
                    StatThreads(v), sms, SmemOptin());
}

// Whether the card holds every CTA of the layout at once.
inline bool StatFits(int gates, int v, const StatLayout &lay) {
  if (lay.threads == 0) return false;
  StatArgs a{};
  a.lay = lay;
  int fits = 0;
  const int err = StatWithKernel(
      gates, v, [&](auto fn) { return StatLaunch(fn, a, nullptr, &fits); });
  cudaGetLastError();  // clears an error of the query
  return err == 0 && fits == 1;
}

// The variant the library picks for a shape (v < 0; measured on the
// H100, see the note above): (4, 2) where its row groups are full (all 256
// threads), else (4, 1) where it has at least 128 threads, else (2, 1).
// Every variant gives the same bits.
inline int StatVariant(int gates, int units, int batch, int v) {
  if (v >= 0) return v < kStatVariants ? v : -1;
  const StatLayout wide = StatLayoutOf(gates, units, batch, 2);
  if (wide.threads > 0 &&
      wide.row_groups == StatThreads(2) / (kSlices * wide.groups)) {
    return 2;
  }
  return StatLayoutOf(gates, units, batch, 1).threads >= 128 ? 1 : 0;
}

// The layout the library launches for a shape: variant `v` (< 0: its
// choice, else the first of the others whose grid the card holds at
// once); threads == 0 if refused.
inline StatLayout StatChoose(int gates, int units, int batch, int *v) {
  const int first = StatVariant(gates, units, batch, *v);
  if (first < 0) return StatLayout{};
  const int order[] = {first, 2, 1, 0};
  for (int cand : order) {
    if (*v >= 0 && cand != first) break;  // a variant asked for: no other
    const StatLayout lay = StatLayoutOf(gates, units, batch, cand);
    if (StatFits(gates, cand, lay)) {
      *v = cand;
      return lay;
    }
  }
  return StatLayout{};
}

// The float32 tile by width and windows a CTA (measured on the H100, see
// the note above): up to u=128 the register tile, U in registers with 4
// windows a lane group (2 when the CTA owns at most 2), U through L1/L2
// with 8 windows; past it the cluster tile, 4 windows a group on 8 CTAs
// (U in shared memory), 8 on 16 (U through L1/L2), 2 when the CTA owns at
// most 2.  With `slots`, launches nothing and writes the clusters the
// card runs at once (0 without a cluster).
template <int kGates>
int LaunchAvg(const void *codes, int batch, int steps, const void *kernel,
              const void *bias, const void *recurrent, int units, int bb,
              void *avg, void *hidden, void *stream, int *slots = nullptr) {
  if (batch <= 0 || steps <= 0 || bb < 1 || bb > MaxWindows(units)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto fn) {
    return fn(codes, batch, steps, kernel, bias, recurrent, units, bb, avg,
              hidden, s, slots);
  };
  const int cluster = AvgCluster(units);
  if (cluster == 8) {
    return bb <= 2 ? launch(LaunchClusterTile<kGates, 2, 8, true>)
                   : launch(LaunchClusterTile<kGates, 4, 8, true>);
  }
  if (cluster == 16) {
    return bb <= 2 ? launch(LaunchClusterTile<kGates, 2, 16, false>)
                   : launch(LaunchClusterTile<kGates, 8, 16, false>);
  }
  if (slots != nullptr) {
    *slots = 0;
    return 0;
  }
  if (units <= kRegUnits) {
    return bb <= 2 ? LaunchTile<kGates, 2, true>(
                         codes, batch, steps, kernel, bias, recurrent, units,
                         bb, avg, hidden, s)
                   : LaunchTile<kGates, 4, true>(
                         codes, batch, steps, kernel, bias, recurrent, units,
                         bb, avg, hidden, s);
  }
  return LaunchTile<kGates, 8, false>(codes, batch, steps, kernel, bias,
                                      recurrent, units, bb, avg, hidden, s);
}

// ---- The bf16 tensor-core tile --------------------------------------------


__device__ __forceinline__ uint32_t PackBf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t *>(&v);
}

// Shared memory of the tile, in bytes from the start: the input rows
// [6][g][xcols] float32 (the CTA's columns: all u without a cluster, its
// unit groups' 8 local in one), U's fragments of its unit groups (kUSmem),
// the two h buffers [2][h_rows][hstride] bf16 (every unit; h_rows: the m
// tiles' 16 rows each, or with `compact` (u > 1024, one m-tile) the CTA's
// 2 bb rows only, row b bb + w for window w's branch b), the codes [bb][T]
// (none in a cluster, whose CTAs read them through L1: the shared memory
// then does not depend on T).
struct MmaLayout {
  int width, k_tiles, groups, local, xcols, m_tiles, hstride, h_rows;
  size_t u_off, h_off, codes_off, bytes;

  __host__ __device__ MmaLayout(int gates, int units, int bb, int steps,
                                bool u_smem, int cluster = 1,
                                bool compact = false) {
    width = gates * units;
    k_tiles = (units + 15) / 16;
    groups = (units + 7) / 8;
    local = (groups + cluster - 1) / cluster;  // unit groups a CTA
    xcols = cluster > 1 ? 8 * local : units;
    m_tiles = (bb + 7) / 8;
    hstride = 16 * k_tiles + 8;  // bf16 a row: 16 bytes of pad
    h_rows = compact ? 2 * bb : 16 * m_tiles;
    u_off = (sizeof(float) * 6 * gates * xcols + 15) &
            ~static_cast<size_t>(15);
    h_off = u_off + (u_smem ? sizeof(uint2) * 32 * local * k_tiles * gates
                            : 0);
    codes_off = h_off + sizeof(__nv_bfloat16) * 2 * h_rows * hstride;
    bytes = codes_off + (cluster > 1 ? 0 : static_cast<size_t>(bb) * steps);
  }
};

// B fragment words of lane (g, tq) for unit n = 8 ug + g of gate q and
// k-tile kt: U[16 kt + 2 tq + {0, 1}] and U[16 kt + 2 tq + {8, 9}] in
// column q u + n, rounded to bf16; zero past u.
__device__ __forceinline__ uint2 UFragment(const float *__restrict__ u_mat,
                                           int units, int width, int q,
                                           int n, int kt, int tq) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 16 * kt + 2 * tq + (j & 1) + 8 * (j >> 1);
    v[j] = n < units && k < units ? u_mat[k * width + q * units + n] : 0.0f;
  }
  return make_uint2(PackBf16(v[0], v[1]), PackBf16(v[2], v[3]));
}

// The float32 sigmoid and tanh of the tensor-core tile: exp through the
// hardware's exp2 (__expf) and the quotient through its reciprocal
// (__fdividef), a few ulp from expf and the IEEE quotient; tanh(x) = 1 -
// 2 / (1 + e^2x), within about 1e-7 of tanhf.  1 / (1 + inf) is 0, so both
// saturate.
__device__ __forceinline__ float FastSigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float FastTanh(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// The cell's gate math on one (row, unit) cell from its input row x
// (bias + W[code]) and its recurrent dots d; the GRU adds its recurrent
// bias b_rec.  Cell<kGates>::step's float32 operations, with FastSigmoid
// and FastTanh.
template <int kGates>
__device__ __forceinline__ void MmaCellStep(const float (&x)[kGates],
                                            const float (&d)[kGates],
                                            const float (&b_rec)[kGates],
                                            float &h, float &c) {
  if constexpr (kGates == 3) {
    const float z = FastSigmoid(x[0] + (d[0] + b_rec[0]));
    const float r = FastSigmoid(x[1] + (d[1] + b_rec[1]));
    const float hh = FastTanh(x[2] + r * (d[2] + b_rec[2]));
    h = z * h + (1.0f - z) * hh;
  } else {
    const float ig = FastSigmoid(x[0] + d[0]);
    const float fg = FastSigmoid(x[1] + d[1]);
    const float gg = FastTanh(x[2] + d[2]);
    const float og = FastSigmoid(x[3] + d[3]);
    c = fg * c + ig * gg;
    h = og * FastTanh(c);
  }
}

// Threads of the largest CTA: a warp for each `groups` of its share of 2
// kKT unit groups and each m-tile of kMmaWindows windows, or past u=1024
// (kKT > 64: one m-tile) of its one m-tile.
__host__ __device__ constexpr int MmaThreads(int k_tiles, int cluster,
                                             int groups = 1) {
  return 32 * UnitSpan((2 * k_tiles + cluster - 1) / cluster, groups) *
         (k_tiles > kMaxUnits / 16 ? 1 : kMmaWindows / 8);
}

// kKT: most k-tiles (u <= 16 kKT); kUSmem: U's fragments in shared memory
// (else in registers, or on a cluster formed each step from U through
// L1/L2); kCluster CTAs a cluster split the unit groups (1: none).  A CTA owns bb windows, ceil(bb / 8) m-tiles; warp w is its unit
// group w % local of m-tile w / local.
template <int kGates, int kKT, bool kUSmem, int kCluster = 1>
__global__ void __launch_bounds__(MmaThreads(kKT, kCluster), 1)
MmaAvgKernel(const int8_t *__restrict__ codes, int batch, int steps,
             const float *__restrict__ kernel, const float *__restrict__ bias,
             const float *__restrict__ recurrent, int units, int bb,
             __nv_bfloat16 *__restrict__ avg,
             __nv_bfloat16 *__restrict__ hidden) {
  static_assert(MmaThreads(kKT, kCluster) <= kMaxThreads,
                "more threads than a CTA may have");
  // U's fragments in registers (one CTA a window), in shared memory, or
  // (a cluster without kUSmem) formed each step from U through L1/L2.
  constexpr bool kURegs = !kUSmem && kCluster == 1;
  extern __shared__ float4 smem4[];
  const MmaLayout lay(kGates, units, bb, steps, kUSmem, kCluster);
  const int width = lay.width, hstride = lay.hstride, xcols = lay.xcols;
  // The CTA's first unit group (0 without a cluster).
  const int ug0 = kCluster > 1 ? static_cast<int>(ClusterRank()) * lay.local
                               : 0;
  const int mbuf = lay.m_tiles * 16 * hstride;  // bf16 a buffer
  char *base = reinterpret_cast<char *>(smem4);
  float *s_x = reinterpret_cast<float *>(base);  // [6][g][xcols]
  uint2 *s_u = reinterpret_cast<uint2 *>(base + lay.u_off);
  __nv_bfloat16 *s_h = reinterpret_cast<__nv_bfloat16 *>(base + lay.h_off);
  int8_t *s_codes = reinterpret_cast<int8_t *>(base + lay.codes_off);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x / kCluster * bb;
  for (int j = tid; j < mbuf; j += blockDim.x) {  // both buffers, by words
    reinterpret_cast<uint32_t *>(s_h)[j] = 0u;
  }
  for (int j = tid; j < 6 * kGates * xcols; j += blockDim.x) {
    const int code = j / (kGates * xcols), o = j - code * kGates * xcols;
    const int q = o / xcols, n = 8 * ug0 + o - q * xcols;
    const int col = q * units + n;
    s_x[j] = n >= units       ? 0.0f
             : code < kCodes ? bias[col] + kernel[code * width + col]
                             : bias[col];
  }
  for (int j = tid; j < (kCluster > 1 ? 0 : bb * steps); j += blockDim.x) {
    const bool in_batch = row0 + j / steps < batch;
    s_codes[j] = in_batch ? codes[static_cast<size_t>(row0) * steps + j]
                          : static_cast<int8_t>(kPadCode);
  }
  if constexpr (kUSmem) {
    const int n_frag = 32 * lay.local * lay.k_tiles * kGates;
    for (int j = tid; j < n_frag; j += blockDim.x) {
      const int l = j & 31, f = j >> 5;  // f = (ug k_tiles + kt) g + q
      const int q = f % kGates, kt = (f / kGates) % lay.k_tiles;
      const int ug = ug0 + f / (kGates * lay.k_tiles);
      s_u[j] = UFragment(recurrent, units, width, q, 8 * ug + (l >> 2), kt,
                         l & 3);
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int ug_l = warp % lay.local, mi = warp / lay.local;  // m-tile
  const int ug = ug0 + ug_l;
  const int g = lane >> 2, tq = lane & 3;
  const int w = 8 * mi + g;  // the lane's window (none past bb)
  const int unit0 = 8 * ug + 2 * tq;  // the lane's units: unit0, unit0 + 1
  const bool mine[2] = {unit0 < units, unit0 + 1 < units};  // not padding
  const bool pair_store = mine[1] && (units & 1) == 0;
  uint2 u_reg[kURegs ? kKT : 1][kGates];
  if constexpr (kURegs) {
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt) {
#pragma unroll
      for (int q = 0; q < kGates; ++q) {
        u_reg[kt][q] = UFragment(recurrent, units, width, q, 8 * ug + g, kt,
                                 tq);
      }
    }
  }
  const uint2 *u_warp = s_u + 32 * kGates * lay.k_tiles * ug_l + lane;
  float b_rec[2][kGates] = {};  // [unit][gate], GRU only
  if constexpr (kGates == 3) {
#pragma unroll
    for (int q = 0; q < kGates; ++q) {
      if (mine[0]) b_rec[0][q] = bias[width + q * units + unit0];
      if (mine[1]) b_rec[1][q] = bias[width + q * units + unit0 + 1];
    }
  }
  float h_st[2][2] = {}, c_st[2][2] = {};  // [branch][unit]
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
    const __nv_bfloat16 *h_cur = s_h + (t & 1) * mbuf;
    const int nxt = ((t + 1) & 1) * mbuf;

    // The step's input rows (they do not wait for h): x[b][j][q].
    float x[2][2][kGates];
    int code_b[2];
    if constexpr (kCluster > 1) {  // the codes through L1
      const int row = row0 + min(w, bb - 1);
      const int8_t *w_codes = codes + static_cast<size_t>(row) * steps;
      code_b[0] = row < batch ? w_codes[t] : kPadCode;
      code_b[1] = row < batch ? Complement(w_codes[steps - 1 - t]) : kPadCode;
    } else {
      const int8_t *w_codes = s_codes + min(w, bb - 1) * steps;
      code_b[0] = w_codes[t];
      code_b[1] = Complement(w_codes[steps - 1 - t]);
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float *x_row =
          s_x + (static_cast<unsigned>(code_b[b]) < kCodes ? code_b[b]
                                                             : kCodes) *
                    kGates * xcols + unit0 - 8 * ug0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int q = 0; q < kGates; ++q) {
          x[b][j][q] = mine[j] ? x_row[q * xcols + j] : 0.0f;
        }
      }
    }

    float acc[kGates][4] = {};
    const __nv_bfloat16 *a_row =
        h_cur + (16 * mi + (lane & 15)) * hstride + 8 * (lane >> 4);
    if constexpr (kUSmem || kURegs) {
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        if (kt < lay.k_tiles) {
          uint32_t a[4];
          LdMatrixX4(a, a_row + 16 * kt);
#pragma unroll
          for (int q = 0; q < kGates; ++q) {
            uint2 b;
            if constexpr (kUSmem) {
              b = u_warp[32 * (kGates * kt + q)];
            } else {
              b = u_reg[kt][q];
            }
            MmaBf16(acc[q], a, b.x, b.y);
          }
        }
      }
    } else {
      // U through L1/L2, rounded to bf16 fragments here, a few k-tiles in
      // flight (unrolled over all of them, the loads were hoisted into
      // registers and spilled).
#pragma unroll 4
      for (int kt = 0; kt < lay.k_tiles; ++kt) {
        uint32_t a[4];
        LdMatrixX4(a, a_row + 16 * kt);
#pragma unroll
        for (int q = 0; q < kGates; ++q) {
          const uint2 b =
              UFragment(recurrent, units, width, q, 8 * ug + g, kt, tq);
          MmaBf16(acc[q], a, b.x, b.y);
        }
      }
    }

    if (w < bb && mine[0]) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!mine[j]) continue;
          float d[kGates];
#pragma unroll
          for (int q = 0; q < kGates; ++q) d[q] = acc[q][2 * b + j];
          MmaCellStep<kGates>(x[b][j], d, b_rec[j], h_st[b][j], c_st[b][j]);
        }
        const int at = nxt + (16 * mi + 8 * b + g) * hstride + unit0;
        const uint32_t pair =
            PackBf16(h_st[b][0], mine[1] ? h_st[b][1] : 0.0f);
        if constexpr (kCluster > 1) {
          // The units' new h into every CTA's next buffer (its own too).
#pragma unroll
          for (int p = 0; p < kCluster; ++p) {
            StoreCluster(h_peer[p] + sizeof(__nv_bfloat16) * at, pair);
          }
        } else {
          *reinterpret_cast<uint32_t *>(s_h + at) = pair;
        }
      }
      const int row = row0 + w;
      if (row < batch) {
        float mean[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mean[j] = (h_st[0][j] + h_st[1][j]) * 0.5f;
        }
        auto store = [&](__nv_bfloat16 *dst) {
          if (pair_store) {
            *reinterpret_cast<__nv_bfloat162 *>(dst) =
                __floats2bfloat162_rn(mean[0], mean[1]);
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (mine[j]) dst[j] = __float2bfloat16(mean[j]);
            }
          }
        };
        store(avg + (static_cast<size_t>(row) * steps + t) * units + unit0);
        if (t == steps - 1) {
          store(hidden + static_cast<size_t>(row) * units + unit0);
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

template <int kGates, int kKT, bool kUSmem, int kCluster = 1>
int LaunchMma(const void *codes, int batch, int steps, const void *kernel,
              const void *bias, const void *recurrent, int units, int bb,
              void *avg, void *hidden, cudaStream_t stream,
              int *slots = nullptr) {
  // With `slots`, it launches nothing and writes the clusters the card
  // runs at once (0 without a cluster, or if it cannot place one).
  if (units > 16 * kKT || bb > kMmaWindows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fn = MmaAvgKernel<kGates, kKT, kUSmem, kCluster>;
  const MmaLayout lay(kGates, units, bb, steps, kUSmem, kCluster);
  const int threads = 32 * lay.local * lay.m_tiles;
  if (slots != nullptr) {
    *slots = kCluster > 1 ? ClusterSlots(fn, threads, lay.bytes, kCluster)
                          : 0;
    return 0;
  }
  const int ctas = (batch + bb - 1) / bb * kCluster;
  const auto i8 = static_cast<const int8_t *>(codes);
  const auto f32 = [](const void *p) { return static_cast<const float *>(p); };
  const auto out = static_cast<__nv_bfloat16 *>(avg);
  const auto last = static_cast<__nv_bfloat16 *>(hidden);
  if constexpr (kCluster > 1) {
    return static_cast<int>(LaunchCluster(
        fn, ctas, threads, lay.bytes, kCluster, stream, i8, batch, steps,
        f32(kernel), f32(bias), f32(recurrent), units, bb, out, last));
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(lay.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<ctas, threads, lay.bytes, stream>>>(i8, batch, steps, f32(kernel),
                                              f32(bias), f32(recurrent),
                                              units, bb, out, last);
    return static_cast<int>(cudaGetLastError());
  }
}

// The bf16 cluster tile past u=1024 (see the note above): 16 CTAs a
// cluster split the unit groups, local = ceil(groups / 16) each; one
// m-tile of bb <= 8 windows, the h buffers holding only the CTA's 2 bb
// rows; warp w owns unit groups w + j span (span = UnitSpan(local,
// kGroups), j < kGroups), each step forming their fragments from U
// through L1/L2, one group after the other.  Every launch gives a warp one
// group (kGroups 1): the group loop stays because this is the code whose
// machine code was measured; without it the kernel compiles to other SASS
// (tools/train_turns.py --sass --libs rnn_avg).
template <int kGates, int kKT, int kGroups>
__global__ void __launch_bounds__(MmaThreads(kKT, 16, kGroups), 1)
MmaWideKernel(const int8_t *__restrict__ codes, int batch, int steps,
              const float *__restrict__ kernel, const float *__restrict__ bias,
              const float *__restrict__ recurrent, int units, int bb,
              __nv_bfloat16 *__restrict__ avg,
              __nv_bfloat16 *__restrict__ hidden) {
  constexpr int kCluster = 16;
  static_assert(kKT > kMaxUnits / 16, "up to u=1024: MmaAvgKernel");
  static_assert(MmaThreads(kKT, kCluster, kGroups) <= kMaxThreads,
                "more threads than a CTA may have");
  extern __shared__ float4 smem4[];
  const MmaLayout lay(kGates, units, bb, steps, false, kCluster, true);
  const int width = lay.width, hstride = lay.hstride, xcols = lay.xcols;
  const int ug0 = static_cast<int>(ClusterRank()) * lay.local;
  const int mbuf = lay.h_rows * hstride;  // bf16 a buffer
  char *base = reinterpret_cast<char *>(smem4);
  float *s_x = reinterpret_cast<float *>(base);  // [6][g][xcols]
  __nv_bfloat16 *s_h = reinterpret_cast<__nv_bfloat16 *>(base + lay.h_off);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x / kCluster * bb;
  for (int j = tid; j < mbuf; j += blockDim.x) {  // both buffers, by words
    reinterpret_cast<uint32_t *>(s_h)[j] = 0u;
  }
  for (int j = tid; j < 6 * kGates * xcols; j += blockDim.x) {
    const int code = j / (kGates * xcols), o = j - code * kGates * xcols;
    const int q = o / xcols, n = 8 * ug0 + o - q * xcols;
    const int col = q * units + n;
    s_x[j] = n >= units       ? 0.0f
             : code < kCodes ? bias[col] + kernel[code * width + col]
                             : bias[col];
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int span = UnitSpan(lay.local, kGroups);
  const int g = lane >> 2, tq = lane & 3;  // the lane's window: g
  // The warp's unit groups: ug_l[n] of the CTA's (has[n]: one it owns, a
  // warp-wide flag), ug0 + ug_l[n] of the window's.  The lane's units of
  // group n: unit0[n] and unit0[n] + 1 (mine: not padding).
  int ug_l[kGroups], unit0[kGroups];
  bool has[kGroups], mine[kGroups][2], pair_store[kGroups];
  float b_rec[kGroups][2][kGates] = {};  // [group][unit][gate], GRU only
#pragma unroll
  for (int n = 0; n < kGroups; ++n) {
    ug_l[n] = LaneUnit(warp, span, n);
    has[n] = ug_l[n] < lay.local;
    unit0[n] = 8 * (ug0 + ug_l[n]) + 2 * tq;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mine[n][j] = has[n] && unit0[n] + j < units;
#pragma unroll
      for (int q = 0; q < kGates; ++q) {
        if (kGates == 3 && mine[n][j]) {
          b_rec[n][j][q] = bias[width + q * units + unit0[n] + j];
        }
      }
    }
    pair_store[n] = mine[n][1] && (units & 1) == 0;
  }
  // [group][branch][unit]
  float h_st[kGroups][2][2] = {}, c_st[kGroups][2][2] = {};
  // The h buffers of the cluster's CTAs (the first must not be written
  // before its CTA has zeroed it: the barrier below).
  uint32_t h_peer[kCluster];
#pragma unroll
  for (int p = 0; p < kCluster; ++p) h_peer[p] = PeerAddress(s_h, p);
  // The row of the A fragment this lane addresses for ldmatrix: row l % 16
  // of the m-tile, window l % 8's branch (l / 8) % 2 at row b bb + w
  // (windows past bb address the last one's rows; their sums are
  // dropped).
  const int a_row = min(lane & 7, bb - 1) + bb * ((lane >> 3) & 1);
  ClusterBarrier();

  for (int t = 0; t < steps; ++t) {
    const __nv_bfloat16 *h_cur = s_h + (t & 1) * mbuf;
    const int nxt = ((t + 1) & 1) * mbuf;

    // The step's codes through L1 (they do not wait for h).
    int code_b[2];
    const int row = row0 + min(g, bb - 1);
    const int8_t *w_codes = codes + static_cast<size_t>(row) * steps;
    code_b[0] = row < batch ? w_codes[t] : kPadCode;
    code_b[1] = row < batch ? Complement(w_codes[steps - 1 - t]) : kPadCode;
    const __nv_bfloat16 *a_ptr = h_cur + a_row * hstride + 8 * (lane >> 4);

#pragma unroll
    for (int n = 0; n < kGroups; ++n) {
      if (!has[n]) continue;  // the same for the whole warp
      // The step's input rows: x[b][j][q].
      float x[2][2][kGates];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float *x_row =
            s_x + (static_cast<unsigned>(code_b[b]) < kCodes ? code_b[b]
                                                               : kCodes) *
                      kGates * xcols + unit0[n] - 8 * ug0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int q = 0; q < kGates; ++q) {
            x[b][j][q] = mine[n][j] ? x_row[q * xcols + j] : 0.0f;
          }
        }
      }
      // U through L1/L2, rounded to bf16 fragments here, a few k-tiles in
      // flight.
      float sums[kGates][4] = {};
      const int col = 8 * (ug0 + ug_l[n]) + g;
#pragma unroll 4
      for (int kt = 0; kt < lay.k_tiles; ++kt) {
        uint32_t a[4];
        LdMatrixX4(a, a_ptr + 16 * kt);
#pragma unroll
        for (int q = 0; q < kGates; ++q) {
          const uint2 b = UFragment(recurrent, units, width, q, col, kt, tq);
          MmaBf16(sums[q], a, b.x, b.y);
        }
      }

      if (g < bb && mine[n][0]) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (!mine[n][j]) continue;
            float d[kGates];
#pragma unroll
            for (int q = 0; q < kGates; ++q) d[q] = sums[q][2 * b + j];
            MmaCellStep<kGates>(x[b][j], d, b_rec[n][j], h_st[n][b][j],
                                c_st[n][b][j]);
          }
          // The units' new h into every CTA's next buffer (its own too).
          const uint32_t at = sizeof(__nv_bfloat16) *
                              (nxt + (b * bb + g) * hstride + unit0[n]);
          const uint32_t pair = PackBf16(
              h_st[n][b][0], mine[n][1] ? h_st[n][b][1] : 0.0f);
#pragma unroll
          for (int p = 0; p < kCluster; ++p) {
            StoreCluster(h_peer[p] + at, pair);
          }
        }
        if (row0 + g < batch) {
          float mean[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mean[j] = (h_st[n][0][j] + h_st[n][1][j]) * 0.5f;
          }
          auto store = [&](__nv_bfloat16 *dst) {
            if (pair_store[n]) {
              *reinterpret_cast<__nv_bfloat162 *>(dst) =
                  __floats2bfloat162_rn(mean[0], mean[1]);
            } else {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if (mine[n][j]) dst[j] = __float2bfloat16(mean[j]);
              }
            }
          };
          const size_t at_row = static_cast<size_t>(row0 + g);
          store(avg + (at_row * steps + t) * units + unit0[n]);
          if (t == steps - 1) store(hidden + at_row * units + unit0[n]);
        }
      }
    }
    ClusterBarrier();
  }
}

template <int kGates, int kKT>
int LaunchMmaWide(const void *codes, int batch, int steps, const void *kernel,
                  const void *bias, const void *recurrent, int units, int bb,
                  void *avg, void *hidden, cudaStream_t stream,
                  int *slots = nullptr) {
  // With `slots`, it launches nothing and writes the clusters the card
  // runs at once (0 if it cannot place one).
  if (units > 16 * kKT || bb > kMmaCap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fn = MmaWideKernel<kGates, kKT, 1>;
  const MmaLayout lay(kGates, units, bb, steps, false, 16, true);
  const int threads = 32 * lay.local;
  if (slots != nullptr) {
    *slots = ClusterSlots(fn, threads, lay.bytes, 16);
    return 0;
  }
  const auto f32 = [](const void *p) { return static_cast<const float *>(p); };
  return static_cast<int>(LaunchCluster(
      fn, (batch + bb - 1) / bb * 16, threads, lay.bytes, 16, stream,
      static_cast<const int8_t *>(codes), batch, steps, f32(kernel),
      f32(bias), f32(recurrent), units, bb, static_cast<__nv_bfloat16 *>(avg),
      static_cast<__nv_bfloat16 *>(hidden)));
}

// Which tile the bf16 kernels run at this width: 1 the tensor-core tile
// (u <= kMmaUnits), 3 its cluster tile (u <= kMmaWideUnits), 0 refused.
// (2, the float32-FMA register tile, served u=129-256 before the cluster
// tile.)
__host__ __device__ __forceinline__ int Bf16Tile(int units) {
  return units <= 0 || units > kMmaWideUnits ? 0
         : units <= kMmaUnits               ? 1
                                            : 3;
}

// Whether a CTA of the bf16 cluster tile of `cluster` CTAs holds its unit
// groups' U fragments in shared memory beside 8 windows.
bool Bf16USmem(int gates, int units, int cluster) {
  return MmaLayout(gates, units, kMmaCap, 1, true, cluster).bytes <=
         SmemOptin();
}

// CTAs a cluster of the bf16 kernels at this width on this card (see the
// note above): 1 up to u=128; past it the fewest of 2, 4, 8 and 16 whose
// CTA holds its share of U's fragments beside 8 windows, else 16 (U
// through L1/L2); 0 if the width is refused or on a CUDA error.
int Bf16Cluster(int gates, int units) {
  if (Bf16Tile(units) != 3) return Bf16Tile(units);
  if (SmemOptin() == 0) return 0;
  for (int cluster = 2; cluster < 16; cluster *= 2) {
    if (Bf16USmem(gates, units, cluster)) return cluster;
  }
  return 16;
}

// Windows a CTA of the bf16 kernels may own at this width in clusters of
// `cluster` (see the note above): one m-tile of 8 on the one-CTA tile; on
// the cluster tile two m-tiles where they fit the shared memory, else one;
// past u=1024 (one m-tile, the CTA's rows of h only) the most of 8 whose
// rows fit.
int MaxWindowsBf16(int gates, int units, int cluster) {
  if (cluster == 1) return kMmaCap;
  if (units > kMaxUnits) {
    const size_t optin = SmemOptin();
    for (int bb = kMmaCap; bb >= 1; --bb) {
      if (MmaLayout(gates, units, bb, 1, false, cluster, true).bytes <=
          optin) {
        return bb;
      }
    }
    return 0;
  }
  return MmaLayout(gates, units, kMmaWindows, 1,
                   Bf16USmem(gates, units, cluster), cluster)
                     .bytes <= SmemOptin()
             ? kMmaWindows
             : kMmaCap;
}

// The bf16 tile by width (measured on the H100, see the note above):
// k-tiles up to 16 (u <= 256), 32, 64 and 128 on the cluster tile.
// With `slots`, launches nothing and writes the clusters the card runs at
// once (0 without a cluster).
template <int kGates>
int LaunchAvgBf16(const void *codes, int batch, int steps, const void *kernel,
                  const void *bias, const void *recurrent, int units, int bb,
                  void *avg, void *hidden, void *stream,
                  int *slots = nullptr) {
  const int cluster = Bf16Cluster(kGates, units);
  if (batch <= 0 || steps <= 0 || cluster == 0 || bb < 1 ||
      bb > MaxWindowsBf16(kGates, units, cluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto fn) {
    return fn(codes, batch, steps, kernel, bias, recurrent, units, bb, avg,
              hidden, s, slots);
  };
  if (units <= 64) {  // U in registers for the GRU, in shared memory
    return launch(LaunchMma<kGates, 4, kGates == 4>);
  }
  if (units <= kMmaUnits) return launch(LaunchMma<kGates, 8, true>);
  if (!Bf16USmem(kGates, units, cluster)) {
    if (units <= kMaxUnits) return launch(LaunchMma<kGates, 64, false, 16>);
    // Past u=1024: one m-tile, 128 k-tiles, a unit group a warp (16 a
    // CTA, 512 threads).
    return launch(LaunchMmaWide<kGates, 128>);
  }
  // The clusters each range of widths can get on the H100 (a card that
  // gives another is refused).
  const int k_tiles = units <= 256 ? 16 : units <= 512 ? 32 : 64;
  switch (k_tiles * 100 + cluster) {
    case 1602: return launch(LaunchMma<kGates, 16, true, 2>);
    case 1604: return launch(LaunchMma<kGates, 16, true, 4>);
    case 3204: return launch(LaunchMma<kGates, 32, true, 4>);
    case 3208: return launch(LaunchMma<kGates, 32, true, 8>);
    case 3216: return launch(LaunchMma<kGates, 32, true, 16>);
    case 6416: return launch(LaunchMma<kGates, 64, true, 16>);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 = launched).
// `bb` is the windows a CTA owns (1 .. dg_avg_layout's most).
int dg_gru_avg(const void *codes, int batch, int steps, const void *kernel,
               const void *bias, const void *recurrent, int units, int bb,
               void *avg, void *hidden, void *stream) {
  return LaunchAvg<3>(codes, batch, steps, kernel, bias, recurrent, units,
                      bb, avg, hidden, stream);
}

int dg_lstm_avg(const void *codes, int batch, int steps, const void *kernel,
                const void *bias, const void *recurrent, int units, int bb,
                void *avg, void *hidden, void *stream) {
  return LaunchAvg<4>(codes, batch, steps, kernel, bias, recurrent, units,
                      bb, avg, hidden, stream);
}

// The bfloat16 fast mode: same arguments, avg and hidden bfloat16.
int dg_gru_avg_bf16(const void *codes, int batch, int steps,
                    const void *kernel, const void *bias,
                    const void *recurrent, int units, int bb, void *avg,
                    void *hidden, void *stream) {
  return LaunchAvgBf16<3>(codes, batch, steps, kernel, bias, recurrent,
                          units, bb, avg, hidden, stream);
}

int dg_lstm_avg_bf16(const void *codes, int batch, int steps,
                     const void *kernel, const void *bias,
                     const void *recurrent, int units, int bb, void *avg,
                     void *hidden, void *stream) {
  return LaunchAvgBf16<4>(codes, batch, steps, kernel, bias, recurrent,
                          units, bb, avg, hidden, stream);
}

// The float32 stationary tile's layout for a shape on the current card:
// out[0] CTAs, [1] units a CTA, [2] threads a CTA, [3] windows a row
// block, [4] row blocks, [5] stages, [6] shared bytes, [7] windows a lane
// group, [8] units a lane, [9] the padded width, [10] the variant;
// `variant` -1 for the library's choice, else 0 .. 2.  Returns the
// scratch bytes its launch takes (zeroed by the caller), 0 if refused (or
// if the card cannot hold the grid at once).
long long dg_avg_stationary_layout(int gates, int units, int batch,
                                   int variant, int *out) {
  if (gates != 3 && gates != 4) return 0;
  int v = variant;
  const StatLayout lay = StatChoose(gates, units, batch, &v);
  if (lay.threads == 0) return 0;
  const int fields[11] = {lay.ctas, lay.uc, lay.threads, lay.windows,
                          lay.blocks, lay.stages,
                          static_cast<int>(lay.smem), StatWin(v),
                          StatUnits(v), lay.width, v};
  for (int i = 0; i < 11; ++i) out[i] = fields[i];
  return static_cast<long long>(lay.scratch);
}

// Launches the stationary tile (cooperative: every CTA resident, else
// cudaErrorCooperativeLaunchTooLarge) in `variant` (as
// dg_avg_stationary_layout takes it) with `scratch` of its bytes, zeroed;
// the other arguments as dg_gru_avg's.
int dg_avg_stationary(int gates, int variant, const void *codes, int batch,
                      int steps, const void *kernel, const void *bias,
                      const void *recurrent, int units, void *scratch,
                      void *avg, void *hidden, void *stream) {
  if ((gates != 3 && gates != 4) || steps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int v = variant;
  StatArgs a{};
  a.lay = StatChoose(gates, units, batch, &v);
  if (a.lay.threads == 0) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  a.codes = static_cast<const int8_t *>(codes);
  a.kernel = static_cast<const float *>(kernel);
  a.bias = static_cast<const float *>(bias);
  a.recurrent = static_cast<const float *>(recurrent);
  a.count = static_cast<unsigned *>(scratch);
  a.h = static_cast<float *>(scratch) + kStatCount;
  a.carry = a.h + 2 * static_cast<size_t>(a.lay.rows_pad) * a.lay.width;
  a.avg = static_cast<float *>(avg);
  a.hidden = static_cast<float *>(hidden);
  a.batch = batch;
  a.steps = steps;
  a.units = units;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return StatWithKernel(gates, v,
                        [&](auto fn) { return StatLaunch(fn, a, s); });
}

// The layout the kernels of a cell with `gates` gates (3 GRU, 4 LSTM) run
// at this width, in float32 (bf16 == 0) or bfloat16: out[0] CTAs a
// cluster (1: one CTA a window), out[1] where U sits (0 read through
// L1/L2, 1 registers, 2 shared memory).  Returns the most windows a CTA
// (each CTA of a cluster holds the cluster's) may own, or 0 if the width
// is refused (out untouched).
int dg_avg_layout(int gates, int units, int bf16, int *out) {
  if ((gates != 3 && gates != 4) || units <= 0 ||
      units > (bf16 ? kMmaWideUnits : kMaxUnits)) {
    return 0;
  }
  if (bf16) {
    const int cluster = Bf16Cluster(gates, units);
    if (cluster == 0) return 0;
    out[0] = cluster;
    out[1] = units <= 64 && gates == 3       ? 1
             : units <= kMmaUnits            ? 2
             : Bf16USmem(gates, units, cluster) ? 2
                                                : 0;
    return MaxWindowsBf16(gates, units, cluster);
  }
  out[0] = AvgCluster(units);
  out[1] = units <= kRegUnits ? 1 : out[0] == 8 ? 2 : 0;
  return MaxWindows(units);
}

// The clusters of that layout, at `bb` windows a CTA, that the card runs
// at once: 0 when the layout has no cluster, or when the card cannot
// place one (or the shape is refused).
int dg_avg_clusters(int gates, int units, int bb, int bf16) {
  if (gates != 3 && gates != 4) return 0;
  int slots = 0;
  const auto query = [&](auto fn) {
    return fn(nullptr, 1, 1, nullptr, nullptr, nullptr, units, bb, nullptr,
              nullptr, nullptr, &slots);
  };
  const int err = bf16 ? (gates == 3 ? query(LaunchAvgBf16<3>)
                                     : query(LaunchAvgBf16<4>))
                       : (gates == 3 ? query(LaunchAvg<3>)
                                     : query(LaunchAvg<4>));
  return err == 0 ? slots : 0;
}

// The tile the bfloat16 kernels run at this width: 1 the tensor-core tile
// (mma.sync), 3 its cluster tile, 0 refused.
int dg_avg_bf16_tile(int gates, int units) {
  return gates == 3 || gates == 4 ? Bf16Tile(units) : 0;
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
