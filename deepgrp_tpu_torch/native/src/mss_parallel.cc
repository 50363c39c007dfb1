// Exact multithreaded Ruzzo–Tompa with X-drop, via reset-point block
// decomposition (a copy of the JAX package's
// deepgrp_tpu/native/src/mss_parallel.cc).
//
// Theory (why this is exact, not approximate):
//  1. Inside a maximal non-positive run (all S[i] <= 0) no new candidate
//     segments form, and a flush emits the same pending set no matter at
//     which position inside the run the X-drop reset fires.
//  2. For a maximal non-positive run starting at a > 0, the prefix at the
//     run start satisfies L_a <= max (L_a is the rprefix of the positive
//     run immediately before, and max is the running maximum of rprefixes
//     since the last reset).  Hence once the cumulative drop within the
//     run exceeds xdrop, the reset condition L + S[i] + xdrop < max is
//     guaranteed to have fired somewhere in the run.
//  3. After a reset the algorithm's state is (L, max) = (0, -inf) with an
//     empty candidate stack, and the subsequent DP is invariant under a
//     constant shift of the prefix: candidate merges compare L and R
//     differences, segment scores are R - L, and the reset condition
//     compares L-to-max differences.  The only effect of *where* in the
//     run the reset fired is a constant offset of the prefix entering the
//     next positive run — which therefore cannot change any output.
// Together: the END of any maximal non-positive run with total drop >
// xdrop (and run start > 0) is an exact block boundary; blocks can be
// processed independently with fresh state and their outputs concatenated.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#include "deepgrp_native.h"

namespace {

// Find exact block boundaries: ends of maximal non-positive runs whose
// cumulative drop exceeds xdrop.  Returns ascending positions in (0, n).
std::vector<int64_t> FindSplitPoints(const double *scores, int64_t n,
                                     double xdrop) {
  std::vector<int64_t> splits;
  if (xdrop <= 0.0) return splits;
  int64_t run_start = -1;
  double drop = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    if (scores[i] > 0.0) {
      if (run_start > 0 && drop > xdrop) splits.push_back(i);
      run_start = -1;
    } else {
      if (run_start < 0) {
        run_start = i;
        drop = 0.0;
      }
      drop -= scores[i];
    }
  }
  return splits;
}

}  // namespace

extern "C" int64_t dg_mss_find_all_mt(const double *scores, int64_t n,
                                      double min_score, double xdrop,
                                      int32_t n_threads, DgSegment *out,
                                      int64_t capacity) {
  if (n_threads <= 1 || n < (1 << 16)) {
    return dg_mss_find_all(scores, n, min_score, xdrop, out, capacity);
  }
  std::vector<int64_t> splits = FindSplitPoints(scores, n, xdrop);
  if (splits.empty()) {
    return dg_mss_find_all(scores, n, min_score, xdrop, out, capacity);
  }

  // Pick up to n_threads-1 split points, evenly spread.
  std::vector<int64_t> bounds{0};
  const size_t want = static_cast<size_t>(n_threads) - 1;
  if (splits.size() <= want) {
    bounds.insert(bounds.end(), splits.begin(), splits.end());
  } else {
    for (size_t k = 1; k <= want; ++k) {
      bounds.push_back(splits[k * splits.size() / (want + 1)]);
    }
    bounds.erase(std::unique(bounds.begin(), bounds.end()), bounds.end());
  }
  bounds.push_back(n);

  const size_t n_blocks = bounds.size() - 1;
  std::vector<std::vector<DgSegment>> results(n_blocks);
  std::vector<std::thread> workers;
  for (size_t b = 0; b < n_blocks; ++b) {
    workers.emplace_back([&, b]() {
      const int64_t lo = bounds[b];
      const int64_t len = bounds[b + 1] - lo;
      std::vector<DgSegment> local(static_cast<size_t>(len / 2 + 1));
      int64_t count = dg_mss_find_all(scores + lo, len, min_score, xdrop,
                                      local.data(),
                                      static_cast<int64_t>(local.size()));
      local.resize(static_cast<size_t>(
          std::min<int64_t>(count, static_cast<int64_t>(local.size()))));
      for (DgSegment &seg : local) {
        seg.start += lo;
        seg.end += lo;
      }
      results[b] = std::move(local);
    });
  }
  for (std::thread &t : workers) t.join();

  int64_t total = 0;
  for (const auto &block : results) {
    for (const DgSegment &seg : block) {
      if (out != nullptr && total < capacity) out[total] = seg;
      ++total;
    }
  }
  return total;
}

namespace {

// Shared segment search + per-segment majority vote (pymss.pyx:46-67
// semantics).  Calls `emit_segment(st, en, major)` for each reported
// segment in order; gap/tail positions keep their raw label (handled by
// the callers, whose output encodings differ).
template <typename EmitSegment>
void ForEachMssSegment(const double *scores, const int64_t *labels,
                       int64_t n, int32_t n_labels, int32_t min_mss_len,
                       int32_t xdrop_len, int32_t n_threads,
                       EmitSegment emit_segment) {
  // Score-space constants of the reference wrapper (pymss.pyx:46-53).
  const double s0 = std::log(0.99 / (1.0 - 0.99));
  const double min_sc = s0 * min_mss_len;
  const double xdrop = (xdrop_len > 0) ? s0 * xdrop_len * 10.0 : -1.0;

  std::vector<DgSegment> segs(n > 0 ? static_cast<size_t>(n / 2 + 1) : 1);
  int64_t n_seg = dg_mss_find_all_mt(scores, n, min_sc, xdrop, n_threads,
                                     segs.data(),
                                     static_cast<int64_t>(segs.size()));
  if (n_seg > static_cast<int64_t>(segs.size()))
    n_seg = static_cast<int64_t>(segs.size());

  std::vector<int64_t> counts(static_cast<size_t>(n_labels));
  for (int64_t s = 0; s < n_seg; ++s) {
    const int64_t st = segs[s].start;
    const int64_t en = segs[s].end;
    std::fill(counts.begin(), counts.end(), 0);
    for (int64_t p = st; p < en; ++p) ++counts[labels[p]];
    int32_t major = 1;
    int64_t major_count = counts[1];
    for (int32_t c = 2; c < n_labels; ++c) {
      if (counts[c] > major_count) {
        major = c;
        major_count = counts[c];
      }
    }
    emit_segment(st, en, major);
  }
}

}  // namespace

extern "C" void dg_find_mss_classes_mt(const double *scores,
                                       const int64_t *labels, int64_t n,
                                       int32_t n_labels, int32_t min_mss_len,
                                       int32_t xdrop_len, int32_t n_threads,
                                       int32_t *classes_out) {
  // Reference-parity MSS labelling (pymss.pyx:31-80), emitted as the class
  // id per position: the argmax of the reference's one-hot row.
  //
  // Both O(n) passes are block-parallel (mirroring dg_mss_find_all_mt's
  // split): the initial labels copy over even position blocks, and the
  // in-segment relabel over even segment blocks (relabels touch disjoint
  // ranges, so no synchronization is needed).
  const int64_t kMinParallel = 1 << 16;
  if (n_threads > 1 && n >= kMinParallel) {
    std::vector<std::thread> workers;
    const int64_t block = (n + n_threads - 1) / n_threads;
    for (int32_t w = 0; w < n_threads; ++w) {
      const int64_t lo = w * block;
      const int64_t hi = std::min<int64_t>(lo + block, n);
      if (lo >= hi) break;
      workers.emplace_back([=]() {
        for (int64_t p = lo; p < hi; ++p) {
          classes_out[p] = static_cast<int32_t>(labels[p]);
        }
      });
    }
    for (std::thread &t : workers) t.join();
  } else {
    for (int64_t p = 0; p < n; ++p) {
      classes_out[p] = static_cast<int32_t>(labels[p]);
    }
  }

  struct Seg {
    int64_t st, en;
    int32_t major;
  };
  std::vector<Seg> segs;
  ForEachMssSegment(scores, labels, n, n_labels, min_mss_len, xdrop_len,
                    n_threads, [&](int64_t st, int64_t en, int32_t major) {
                      segs.push_back({st, en, major});
                    });
  int64_t covered = 0;
  for (const Seg &s : segs) covered += s.en - s.st;
  if (n_threads > 1 && covered >= kMinParallel && segs.size() > 1) {
    std::vector<std::thread> workers;
    const size_t block = (segs.size() + n_threads - 1) / n_threads;
    for (int32_t w = 0; w < n_threads; ++w) {
      const size_t lo = static_cast<size_t>(w) * block;
      const size_t hi = std::min(lo + block, segs.size());
      if (lo >= hi) break;
      workers.emplace_back([=, &segs]() {
        for (size_t s = lo; s < hi; ++s) {
          for (int64_t p = segs[s].st; p < segs[s].en; ++p) {
            if (labels[p] == 0) classes_out[p] = segs[s].major;
          }
        }
      });
    }
    for (std::thread &t : workers) t.join();
  } else {
    for (const Seg &s : segs) {
      for (int64_t p = s.st; p < s.en; ++p) {
        if (labels[p] == 0) classes_out[p] = s.major;
      }
    }
  }
}

namespace {

// One pass of the streaming split scan (deepgrp_native.h, dg_split_scan_*):
// the exact split points of the reset-point decomposition above, found as
// the score track lands, with the open run carried across calls.
template <typename T>
int64_t SplitScan(const T *scores, int64_t lo, int64_t hi, double xdrop,
                  int64_t min_gap, int64_t *state, double *drop_io,
                  int64_t *out) {
  // The strict margin: the vectorised scans of other implementations sum
  // a run in another order, so a run at the threshold is never split.
  const double limit = xdrop + 1e-6 * std::max(1.0, std::fabs(xdrop));
  int64_t run_start = state[0];
  int64_t last_split = state[1];
  double drop = *drop_io;
  int64_t n_out = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const double s = static_cast<double>(scores[i]);
    if (s > 0.0) {
      if (run_start > 0 && drop > limit && i - last_split >= min_gap) {
        out[n_out++] = i;
        last_split = i;
      }
      run_start = -1;
    } else {
      if (run_start < 0) {
        run_start = i;
        drop = 0.0;
      }
      drop -= s;
    }
  }
  state[0] = run_start;
  state[1] = last_split;
  *drop_io = run_start >= 0 ? drop : 0.0;
  return n_out;
}

}  // namespace

extern "C" int64_t dg_split_scan_f32(const float *scores, int64_t lo,
                                     int64_t hi, double xdrop,
                                     int64_t min_gap, int64_t *state,
                                     double *drop, int64_t *out) {
  return SplitScan(scores, lo, hi, xdrop, min_gap, state, drop, out);
}

extern "C" int64_t dg_split_scan_f64(const double *scores, int64_t lo,
                                     int64_t hi, double xdrop,
                                     int64_t min_gap, int64_t *state,
                                     double *drop, int64_t *out) {
  return SplitScan(scores, lo, hi, xdrop, min_gap, state, drop, out);
}
