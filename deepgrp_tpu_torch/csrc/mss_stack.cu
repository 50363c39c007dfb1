// Ruzzo-Tompa candidate-stack scan over collapsed positive runs, for
// Hopper (sm_90a).
//
// Counterpart of the sequential part of the JAX package's on-device MSS:
//   * dg_mss_stack <- deepgrp_tpu/ops/mss_device.py:160-226 (the run_body
//                     lax.while_loop of mss_find_all_device; plain jnp, no
//                     Pallas kernel), whose host replica is
//                     mss_stack_from_candidates (:410-481).
// Contract (identical to the plain version
// deepgrp_tpu_torch/ops/mss_device.py:mss_stack_from_candidates): the first
// min(*n_runs, capacity) runs, run k spanning [starts[k], ends[k]) with the
// global float64 prefixes l_glob[k] (before it) and r_glob[k] (through it),
// in order.  The reference's candidate stack (mss.c:50-101): an X-drop reset
// placed at a run's start (flush, new frame at l_glob), the back-pointer
// search, merge and push, a flush on a new minimum and at the end, and the
// threshold truncated to an integer (mss.c:35).  Writes the segments'
// starts out[0, capacity), ends out[capacity, 2 capacity) and their count
// out[2 capacity], in ascending order.  Float64 additions, subtractions and
// comparisons only, in the plain version's order (no multiply, so nothing
// contracts into an FMA): the output is the plain version's, bit for bit.
//
// Bound on this card.  The scan reads 24 bytes a run and writes 8 a
// segment; at 3.35 TB/s that is microseconds for any track.  But every step
// depends on the last (the stack top decides the next load), so the real
// bound is the latency of a chain of dependent loads: about a microsecond a
// run through L1/L2, more on a deep back-pointer chain.  PyTorch has no
// device loop; a host loop would synchronise once a run.
//
// Design: one thread of one block walks the runs; the stack (28 bytes an
// entry) and the output live in global memory, which the wrapper allocates
// at the capacity.  A sparse track (a trained model's: a few thousand runs)
// scans in milliseconds; a noisy track's hundreds of thousands of runs take
// correspondingly longer, which is why the auto route never sends one here.

#include <cuda_runtime.h>

namespace {

constexpr double kNegInf = -1e30;

struct Stack {
  double *left;
  double *right;
  int *start;
  int *end;
  int *back;
};

// Emits every pending candidate whose score clears the threshold, bottom
// up, and empties the stack.
__device__ void Flush(const Stack &stack, int *top, double min_sc,
                      int capacity, int *seg_starts, int *seg_ends,
                      int *n_out) {
  for (int k = 0; k < *top; ++k) {
    if (stack.right[k] - stack.left[k] >= min_sc && *n_out < capacity) {
      seg_starts[*n_out] = stack.start[k];
      seg_ends[*n_out] = stack.end[k];
      ++*n_out;
    }
  }
  *top = 0;
}

__global__ void __launch_bounds__(1)
    MssStackKernel(const int *starts, const int *ends, const double *l_glob,
                   const double *r_glob, const int *n_runs, int capacity,
                   double min_score, double xdrop, double *stack_f,
                   int *stack_i, int *out) {
  const Stack stack{stack_f, stack_f + capacity, stack_i,
                    stack_i + capacity, stack_i + 2 * capacity};
  int *seg_starts = out;
  int *seg_ends = out + capacity;
  const double min_sc = trunc(min_score);
  const int runs = min(*n_runs, capacity);
  int top = 0;
  int n_out = 0;
  double shift = 0.0;
  double best = kNegInf;
  for (int run = 0; run < runs; ++run) {
    const double l_run = l_glob[run];
    const double r_run = r_glob[run];
    if (xdrop > 0.0 && l_run - shift + xdrop < best) {
      Flush(stack, &top, min_sc, capacity, seg_starts, seg_ends, &n_out);
      shift = l_run;
      best = kNegInf;
    }
    double cur_l = l_run - shift;
    const double cur_r = r_run - shift;
    if (cur_r > best) best = cur_r;
    int start = starts[run];
    const int end = ends[run];
    while (true) {
      // The nearest candidate below the top with a smaller left prefix.
      int j = top - 1;
      while (j >= 0 && !(stack.left[j] < cur_l)) {
        j = stack.back[j] >= 0 ? stack.back[j] : j - 1;
      }
      if (j >= 0 && stack.right[j] < cur_r) {  // merge with candidate j
        start = stack.start[j];
        cur_l = stack.left[j];
        top = j;
        continue;
      }
      if (j < 0) {  // a new minimum: everything pending is final
        Flush(stack, &top, min_sc, capacity, seg_starts, seg_ends, &n_out);
        best = cur_r;
      }
      stack.left[top] = cur_l;
      stack.right[top] = cur_r;
      stack.start[top] = start;
      stack.end[top] = end;
      stack.back[top] = j;
      ++top;
      break;
    }
  }
  Flush(stack, &top, min_sc, capacity, seg_starts, seg_ends, &n_out);
  out[2 * capacity] = n_out;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 = launched).  starts, ends int32 [capacity]; l_glob, r_glob float64
// [capacity]; n_runs one int32 on the device; stack_f float64 [2 capacity]
// and stack_i int32 [3 capacity] are scratch; out int32 [2 capacity + 1].
int dg_mss_stack(const void *starts, const void *ends, const void *l_glob,
                 const void *r_glob, const void *n_runs, int capacity,
                 double min_score, double xdrop, void *stack_f,
                 void *stack_i, void *out, void *stream) {
  if (capacity <= 0) return static_cast<int>(cudaErrorInvalidValue);
  MssStackKernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int *>(starts), static_cast<const int *>(ends),
      static_cast<const double *>(l_glob),
      static_cast<const double *>(r_glob), static_cast<const int *>(n_runs),
      capacity, min_score, xdrop, static_cast<double *>(stack_f),
      static_cast<int *>(stack_i), static_cast<int *>(out));
  return static_cast<int>(cudaGetLastError());
}

const char *dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
