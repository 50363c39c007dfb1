// Ruzzo–Tompa all-maximal-scoring-subsequences with X-drop reset (host
// side of deepgrp_tpu_torch's prediction post-processing; a copy of the JAX
// package's deepgrp_tpu/native/src/mss.cc).
//
// Re-implemented from the algorithm in Ruzzo & Tompa (1999), "A linear time
// algorithm for finding all maximal scoring subsequences" (ISMB'99), with
// the X-drop early-reset extension whose semantics match the reference
// implementation of the reference DeepGRP (deepgrp/_mss/mss.c, itself
// derived from lh3/dna-nn).
// Bit-parity notes:
//  * the minimum-score filter truncates min_score to an integer before the
//    comparison, because the reference converts the double threshold to the
//    `int min_sc` parameter of its filter routine (mss.c:35) — scores equal
//    to e.g. 229.7 pass a nominal threshold of 229.756,
//  * candidate flushing resets the running maximum to the current prefix
//    (mss.c:78-81) and the X-drop reset fires only when xdrop > 0 and
//    L + S[i] + xdrop < max for a non-positive S[i] (mss.c:89-92).

#include <cmath>
#include <cstdint>
#include <vector>

#include "deepgrp_native.h"

namespace {

struct Candidate {
  int64_t start;
  int64_t end;  // exclusive
  double lprefix;  // cumulative score before `start`
  double rprefix;  // cumulative score after `end - 1`
  int64_t back;    // index of rightmost candidate with smaller lprefix, or -1
};

// Append candidates whose (truncated-threshold) score passes the filter to
// `out`, then drop them all.  Mirrors move_segs (mss.c:35-47).
class SegmentSink {
 public:
  SegmentSink(DgSegment *out, int64_t capacity, int64_t min_sc_trunc)
      : out_(out), capacity_(capacity), min_sc_(min_sc_trunc) {}

  void Flush(std::vector<Candidate> *cands) {
    for (const Candidate &c : *cands) {
      const double score = c.rprefix - c.lprefix;
      if (score >= static_cast<double>(min_sc_)) {
        if (out_ != nullptr && count_ < capacity_) {
          out_[count_].start = c.start;
          out_[count_].end = c.end;
          out_[count_].score = score;
        }
        ++count_;
      }
    }
    cands->clear();
  }

  int64_t count() const { return count_; }

 private:
  DgSegment *out_;
  int64_t capacity_;
  int64_t min_sc_;
  int64_t count_ = 0;
};

constexpr double kNegInf = -1e30;

}  // namespace

extern "C" int64_t dg_mss_find_all(const double *scores, int64_t n,
                                   double min_score, double xdrop,
                                   DgSegment *out, int64_t capacity) {
  SegmentSink sink(out, capacity, static_cast<int64_t>(min_score));
  std::vector<Candidate> cands;

  double prefix = 0.0;       // running cumulative score ("L" in the paper)
  double best = kNegInf;     // running maximum of any rprefix
  int64_t i = 0;
  while (i < n) {
    if (scores[i] > 0.0) {
      // Extend over the maximal run of positive scores.
      int64_t end = i;
      double run_end_prefix = prefix;
      while (end < n && scores[end] > 0.0) {
        run_end_prefix += scores[end];
        ++end;
      }
      if (run_end_prefix > best) best = run_end_prefix;

      Candidate cur{/*start=*/i, /*end=*/end, /*lprefix=*/prefix,
                    /*rprefix=*/run_end_prefix, /*back=*/-1};
      for (;;) {
        // Walk back-pointers to the rightmost candidate whose lprefix is
        // strictly below ours.
        int64_t j = static_cast<int64_t>(cands.size()) - 1;
        while (j >= 0) {
          const Candidate &c = cands[j];
          if (c.lprefix < cur.lprefix) break;
          j = (c.back >= 0) ? c.back : j - 1;
        }
        if (j >= 0 && cands[j].rprefix < cur.rprefix) {
          // Merge: the found candidate is subsumed; extend ours leftwards.
          cur.start = cands[j].start;
          cur.lprefix = cands[j].lprefix;
          cur.back = cands[j].back;
          cands.resize(j);
          continue;
        }
        if (j < 0) {
          // Nothing to the left can ever merge with us: everything pending
          // is maximal.  Emit it and restart the running maximum from here.
          sink.Flush(&cands);
          best = run_end_prefix;
        }
        cur.back = j;
        cands.push_back(cur);
        break;
      }
      prefix = run_end_prefix;
      i = end;
    } else {
      if (xdrop > 0.0 && prefix + scores[i] + xdrop < best) {
        // X-drop reset: the score has fallen too far below the maximum for
        // any pending candidate to be extended profitably.
        sink.Flush(&cands);
        prefix = 0.0;
        best = kNegInf;
      }
      prefix += scores[i];
      ++i;
    }
  }
  sink.Flush(&cands);
  return sink.count();
}
