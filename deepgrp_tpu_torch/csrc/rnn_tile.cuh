// The register tile's building blocks, shared by rnn_avg.cu (the fused
// inference kernels) and rnn_seq.cu (the GRU over a float input).
//
// A lane group holds kSlices (4) lanes a unit: lane 4 i + s owns unit i
// and k-slice s of the recurrent dot (the float4 quads s, s + 4, ... of
// k).  The lane keeps its slice of U in registers up to u = kRegUnits or
// reads it through L1/L2 (USlice); a fixed butterfly of shuffles
// reduce-scatters the partial sums over the unit's lanes (FoldWindows).
//
// The cluster tile (Hopper's thread-block clusters) serves layers too wide
// for one SM: the CTAs of a cluster split a row's units, each keeps the
// whole gate sums of its slice and a full copy of h, and at the end of a
// step writes its slice of the new h into every peer's next-h buffer
// through distributed shared memory (PeerAddress, StoreCluster); one
// cluster barrier a step (ClusterBarrier) then stands where the CTA's
// barrier stood, and the double buffer needs no second one.
// LaunchCluster launches such a kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlices = 4;      // k-slices a unit (lanes 4i .. 4i+3)
constexpr int kRegUnits = 64;   // U's slice in registers up to this width
constexpr int kRegQuads = kRegUnits / (4 * kSlices);

__device__ __forceinline__ float Sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__host__ __device__ __forceinline__ int Pad4(int n) { return (n + 3) & ~3; }

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

// A stored value as an operand of the dots: a float32 one rounded to the
// dots' precision; a bfloat16 one is exact already.
template <bool kBf16>
__device__ __forceinline__ float ToOperand(float v) {
  return Io<kBf16>::Operand(v);
}
template <bool kBf16>
__device__ __forceinline__ float ToOperand(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The U entries of lane (i, s): U[4 (s + 4 m) + c, g u + i] for quad m of
// its slice, c < 4, gate g (zero past u), as operands of the dot; from
// registers or, for wider layers, device memory through L1/L2.  U is
// float32 or, for kBf16, may be bfloat16 (TU).
template <int kGates, bool kURegs, bool kBf16, typename TU = float>
struct USlice {
  float reg[kURegs ? kRegQuads : 1][4][kGates];
  const TU *recurrent;

  __device__ __forceinline__ void load(const TU *__restrict__ u_mat,
                                       int units, int i, int s) {
    recurrent = u_mat;
    if constexpr (kURegs) {
#pragma unroll
      for (int m = 0; m < kRegQuads; ++m) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * (s + kSlices * m) + c;
#pragma unroll
          for (int g = 0; g < kGates; ++g) {
            reg[m][c][g] =
                k < units ? ToOperand<kBf16>(
                                u_mat[k * kGates * units + g * units + i])
                          : 0.0f;
          }
        }
      }
    }
  }

  __device__ __forceinline__ float at(int m, int c, int g, int s, int units,
                                      int i) const {
    if constexpr (kURegs) {
      return reg[m][c][g];
    } else {
      const int k = 4 * (s + kSlices * m) + c;
      return k < units ? ToOperand<kBf16>(__ldg(
                             recurrent + k * kGates * units + g * units + i))
                       : 0.0f;
    }
  }
};

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

// Lanes of this thread's warp that exist (the last warp of a CTA of 4 u
// threads may be partial); the shuffles name only those.
__device__ __forceinline__ unsigned WarpLanes() {
  const int n = static_cast<int>(blockDim.x) - (threadIdx.x & ~31);
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// ---- Thread-block clusters ----------------------------------------------

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
