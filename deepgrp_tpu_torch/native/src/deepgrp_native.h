/* deepgrp_tpu_torch native host library (a copy of the parts of the JAX
 * package's deepgrp_tpu/native library that prediction uses).
 *
 * C ABI for the host-side hot paths:
 *   - Ruzzo–Tompa all-maximal-scoring-subsequences with X-drop reset and
 *     majority-vote segment labelling (behavioural parity with the reference
 *     DeepGRP's _mss/mss.c + _mss/pymss.pyx),
 *   - leading/trailing 'N' trimming of a DNA sequence (reference
 *     sequence.pyx:21-36),
 *   - the streaming MSS's split scan (the port's own: the JAX package
 *     scans in numpy).
 */
#ifndef DEEPGRP_TPU_TORCH_NATIVE_H_
#define DEEPGRP_TPU_TORCH_NATIVE_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  int64_t start;
  int64_t end; /* exclusive */
  double score;
} DgSegment;

/* Find all maximal scoring subsequences of `scores[0..n)`.
 * Segments with score >= trunc(min_score) are reported (the truncation of
 * min_score to an integer mirrors the reference's implicit double->int
 * conversion at mss.c:35/79 and is required for bit parity).
 * An X-drop reset occurs when xdrop > 0 and the running prefix falls more
 * than `xdrop` below the running maximum (mss.c:89-92 semantics).
 *
 * Writes up to `capacity` segments into `out`; returns the total number of
 * segments found (which may exceed capacity). */
int64_t dg_mss_find_all(const double *scores, int64_t n, double min_score,
                        double xdrop, DgSegment *out, int64_t capacity);

/* Exact multithreaded variant (see mss_parallel.cc for the reset-point
 * block-decomposition argument; the output is identical to
 * dg_mss_find_all for every input and thread count). */
int64_t dg_mss_find_all_mt(const double *scores, int64_t n, double min_score,
                           double xdrop, int32_t n_threads, DgSegment *out,
                           int64_t capacity);

/* Reference-parity MSS labelling (pymss.pyx:31-80): score constants
 * s0 = log(0.99/0.01), min_sc = s0*min_mss_len, xdrop = s0*xdrop_len*10 (or
 * -1 when xdrop_len <= 0); in each found segment, positions labelled 0 take
 * the segment's majority class over 1..n_labels-1 (ties keep the lowest),
 * every other position keeps its label.  Writes the class id per position
 * into `classes_out` [n] (need not be initialized). */
void dg_find_mss_classes_mt(const double *scores, const int64_t *labels,
                            int64_t n, int32_t n_labels, int32_t min_mss_len,
                            int32_t xdrop_len, int32_t n_threads,
                            int32_t *classes_out);

/* Streaming split-point scan (the port's SplitScanner, ops/mss.py): scans
 * scores[lo..hi) in one pass, carrying the open non-positive run across
 * calls in `state` = {run_start (-1: none), last_split} and `drop` (the open
 * run's cumulative drop, in double).  A run that starts after position 0
 * and ends at i (the first positive position after it) splits at i when its
 * drop exceeds xdrop + 1e-6 * max(1, |xdrop|) and i - last_split >= min_gap.
 * Writes the split points, ascending, into `out` (room for
 * (hi - lo) / min_gap + 1) and returns their count. */
int64_t dg_split_scan_f32(const float *scores, int64_t lo, int64_t hi,
                          double xdrop, int64_t min_gap, int64_t *state,
                          double *drop, int64_t *out);
int64_t dg_split_scan_f64(const double *scores, int64_t lo, int64_t hi,
                          double xdrop, int64_t min_gap, int64_t *state,
                          double *drop, int64_t *out);

/* On return [*start, *end) is the range of seq[0..n) left after trimming
 * leading and trailing 'N' bytes. */
void dg_trim_n(const char *seq, int64_t n, int64_t *start, int64_t *end);

#ifdef __cplusplus
}
#endif

#endif /* DEEPGRP_TPU_TORCH_NATIVE_H_ */
