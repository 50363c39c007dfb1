// Leading/trailing-'N' trimming of an ASCII DNA sequence (a copy of
// dg_trim_n in the JAX package's deepgrp_tpu/native/src/encode.cc; parity
// target: the reference DeepGRP's sequence.pyx:21-36).

#include <cstdint>

#include "deepgrp_native.h"

extern "C" void dg_trim_n(const char *seq, int64_t n, int64_t *start,
                          int64_t *end) {
  // Only uppercase 'N' is trimmed, matching the reference's byte comparison
  // (sequence.pyx:27-30); callers upper-case FASTA lines first.
  int64_t lo = 0;
  int64_t hi = n;
  while (lo < hi && seq[lo] == 'N') ++lo;
  while (hi > 0 && seq[hi - 1] == 'N') --hi;
  if (hi < lo) hi = lo;
  *start = lo;
  *end = hi;
}
