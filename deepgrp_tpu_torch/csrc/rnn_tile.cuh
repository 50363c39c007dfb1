// The register tile's building blocks, shared by rnn_avg.cu (the fused
// inference kernels) and rnn_seq.cu (the GRU over a float input).
//
// A lane group holds kSl lanes a unit: lane kSl i + s owns unit i and
// k-slice s of the recurrent dot (the float4 quads s, s + kSl, ... of k).
// The lane keeps its slice of U in registers up to u = kRegUnits (with four
// slices) or reads it through L1/L2 (USlice); a fixed butterfly of shuffles
// reduce-scatters the partial sums over the unit's lanes (FoldWindows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// The U entries of lane (i, s): U[4 (s + kSl m) + c, g u + i] for quad m of
// its slice, c < 4, gate g (zero past u), as operands of the dot; from
// registers (kSl = 4 only) or, for wider layers, device memory through
// L1/L2.  U is float32 or, for kBf16, may be bfloat16 (TU).
template <int kGates, bool kURegs, bool kBf16, int kSl = kSlices,
          typename TU = float>
struct USlice {
  static_assert(!kURegs || kSl == kSlices, "U in registers: four slices");
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
          const int k = 4 * (s + kSl * m) + c;
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
      const int k = 4 * (s + kSl * m) + c;
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

// Lanes of this thread's warp that exist (the last warp of a CTA of kSl u
// threads may be partial); the shuffles name only those.
__device__ __forceinline__ unsigned WarpLanes() {
  const int n = static_cast<int>(blockDim.x) - (threadIdx.x & ~31);
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

}  // namespace
