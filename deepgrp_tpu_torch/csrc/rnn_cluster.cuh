// Thread-block cluster helpers (Hopper), shared by the kernels that split
// a row's units over the CTAs of a cluster: rnn_avg.cu and rnn_seq.cu
// (through rnn_tile.cuh) and rnn_train.cu.
//
// A lane group's butterfly (FoldWindows) reduce-scatters the partial sums
// of a unit's four k-slice lanes over the group's windows, so that lane s
// ends with whole sums of the windows it owns (OwnWindows, OwnWindow).
//
// Each CTA of such a cluster writes its slice of a step's result into its
// peers' shared memory (PeerAddress, StoreCluster); one cluster barrier a
// step (ClusterBarrier) makes the writes visible to every CTA.
// LaunchCluster launches such a kernel after asking the card whether it
// can place one cluster (ClusterSlots).
//
// Complement, the reverse-complement branch's code, is here too, so that
// every recurrence library (rnn_grid.cu through rnn_tile.cuh) shares it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int Complement(int c) {
  return (c >= 0 && c < 4) ? 3 - c : c;  // A<->T, C<->G, N and pad kept
}

// ---- The butterfly of a lane group ---------------------------------------

// Sums in[.][b][g] with lane (this ^ mask) and keeps half of the windows:
// lane bit `hi` set keeps the odd ones (2w + 1), else the even (2w); the
// partner lane sends the other half.
template <int kN, int kGates>
__device__ __forceinline__ void FoldWindows(
    const float (&in)[kN][2][kGates], bool hi, int mask, unsigned lanes,
    float (&out)[kN / 2][2][kGates]) {
#pragma unroll
  for (int w = 0; w < kN / 2; ++w) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        const float keep = hi ? in[2 * w + 1][b][g] : in[2 * w][b][g];
        const float send = hi ? in[2 * w][b][g] : in[2 * w + 1][b][g];
        out[w][b][g] = keep + __shfl_xor_sync(lanes, send, mask);
      }
    }
  }
}

// ---- The lane's units ----------------------------------------------------

// The ceiling of the cluster tiles of one unit a lane (rnn_avg.cu's
// float32 tile, rnn_seq.cu, rnn_train.cu): 16 CTAs of 64 units.  Past it
// the grid tile (rnn_grid.cu) runs every recurrence faster on the H100
// (tools/avg_tile_sweep.py --grid, tools/train_tile_sweep.py --grid), and
// the bf16 tile keeps its cluster tile to kMmaWideUnits (rnn_avg.cu).
constexpr int kMaxUnits = 1024;

// A lane of rnn_avg.cu's and rnn_seq.cu's cluster tiles loops over
// per_lane of its CTA's uc units: the k-slice lanes of a group span
// UnitSpan(uc, per_lane) units, and the lane of unit slot i owns the
// CTA's local units LaneUnit(i, span, j) = i + j span, j < per_lane (the
// bf16 tile's warps own unit groups the same way).  Every launch passes
// per_lane 1; the loop stays in those kernels because their machine code
// is the one measured (without it they compile to other SASS).
__host__ __device__ constexpr int UnitSpan(int uc, int per_lane) {
  return (uc + per_lane - 1) / per_lane;
}

__host__ __device__ constexpr int LaneUnit(int i, int span, int j) {
  return i + j * span;
}

// Windows a lane of a group of `win` owns after the butterfly.
__host__ __device__ constexpr int OwnWindows(int win) {
  return win >= 4 ? win / 4 : 1;
}

// The j-th of them: w0 + 4 j + s (kWin >= 4), or w0 + (s & 1), shared by
// lanes s and s ^ 2 (kWin 2).
template <int kWin>
__device__ __forceinline__ int OwnWindow(int w0, int s, int j) {
  return w0 + (kWin >= 4 ? 4 * j + s : s & 1);
}

// ---- Clusters ------------------------------------------------------------

// Shared memory a block of the current device may opt in to (0 on a CUDA
// error).
inline size_t SmemOptin() {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  return static_cast<size_t>(optin);
}

// The CTA's rank in its cluster.
__device__ __forceinline__ unsigned ClusterRank() {
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// The address in the cluster's shared window of `local` (this CTA's
// shared memory) in the CTA of the cluster with rank `rank`.
__device__ __forceinline__ uint32_t PeerAddress(const void *local,
                                                unsigned rank) {
  const uint32_t own =
      static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(peer)
               : "r"(own), "r"(rank));
  return peer;
}

// A 4-byte store to a peer's shared memory (an address from PeerAddress).
__device__ __forceinline__ void StoreCluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ void StoreCluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// Every thread of the cluster: the shared-memory writes of each CTA before
// it (to its own memory and its peers') are seen by all after it.  It also
// orders the CTA's own threads, as __syncthreads() would.
__device__ __forceinline__ void ClusterBarrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A launch of `ctas` CTAs in clusters of `cluster` along x, `threads`
// threads and `smem` bytes of dynamic shared memory each.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;

  ClusterLaunch(int ctas, int threads, size_t smem, int cluster,
                cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config = {};
    config.gridDim = dim3(ctas);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
  }
};

// The opt-ins a cluster launch of `kernel` needs: `smem` bytes of dynamic
// shared memory and, past 8 CTAs (not portable), the cluster size.
template <typename... Params>
cudaError_t ClusterOptIn(void (*kernel)(Params...), size_t smem,
                         int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// Clusters of `kernel` at this shape that the card runs at once (0 if it
// cannot place one, or on a CUDA error).
template <typename... Params>
int ClusterSlots(void (*kernel)(Params...), int threads, size_t smem,
                 int cluster) {
  int placed = 0;
  const ClusterLaunch launch(cluster, threads, smem, cluster, nullptr);
  if (ClusterOptIn(kernel, smem, cluster) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&placed, kernel, &launch.config) !=
          cudaSuccess) {
    return 0;
  }
  return placed;
}

// Launches `kernel` on `stream` as ctas / cluster clusters of `cluster`
// CTAs (ctas a multiple of it), after asking the card whether it can
// place one such cluster: cudaErrorLaunchOutOfResources when it cannot
// (no smaller tile is tried), else the launch's error (0 = launched).
template <typename... Params, typename... Args>
cudaError_t LaunchCluster(void (*kernel)(Params...), int ctas, int threads,
                          size_t smem, int cluster, cudaStream_t stream,
                          Args... args) {
  if (ClusterSlots(kernel, threads, smem, cluster) < 1) {
    const cudaError_t err = cudaGetLastError();  // clears a sticky error
    return err != cudaSuccess ? err : cudaErrorLaunchOutOfResources;
  }
  const ClusterLaunch launch(ctas, threads, smem, cluster, stream);
  const cudaError_t err = cudaLaunchKernelEx(&launch.config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
