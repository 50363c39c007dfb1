// Standalone self-test of the port's native host library, built plain and
// under ASAN/UBSAN (native/Makefile).  Exercises the MSS search
// (sequential against multithreaded), the MSS class labelling (every
// thread count, and the majority vote on a hand-made case), N-trimming,
// and the streaming split scan (pieces against one whole call, against a
// restatement of its rule, and float32 against float64); exits non-zero
// on any mismatch.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

#include "deepgrp_native.h"

namespace {

int failures = 0;

void Check(bool ok, const char *what) {
  if (!ok) {
    std::fprintf(stderr, "FAIL: %s\n", what);
    ++failures;
  }
}

const double kS0 = std::log(0.99 / 0.01);

// Scores shaped like the MSS transform's output: positive with
// probability `positive_rate`, else ten times as negative.
std::vector<double> RandomScores(std::mt19937_64 &rng, int64_t n,
                                 double positive_rate) {
  std::uniform_real_distribution<double> unit(0.0, 1.0);
  std::vector<double> scores(n);
  for (int64_t i = 0; i < n; ++i) {
    double t = 0.1 + unit(rng) * (kS0 - 0.1);
    scores[i] = unit(rng) < positive_rate ? t : -10.0 * t;
  }
  return scores;
}

void TestMssStVsMt(uint64_t seed, int64_t n, double positive_rate) {
  std::mt19937_64 rng(seed);
  const std::vector<double> scores = RandomScores(rng, n, positive_rate);
  const double min_sc = kS0 * 50;
  const double xdrop = kS0 * 50 * 10;
  std::vector<DgSegment> st(n / 2 + 1), mt(n / 2 + 1);
  int64_t n_st = dg_mss_find_all(scores.data(), n, min_sc, xdrop, st.data(),
                                 static_cast<int64_t>(st.size()));
  for (int threads : {2, 3, 8}) {
    int64_t n_mt = dg_mss_find_all_mt(scores.data(), n, min_sc, xdrop,
                                      threads, mt.data(),
                                      static_cast<int64_t>(mt.size()));
    Check(n_st == n_mt, "mt segment count");
    for (int64_t i = 0; i < n_st && i < n_mt; ++i) {
      Check(st[i].start == mt[i].start && st[i].end == mt[i].end &&
                st[i].score == mt[i].score,
            "mt segment equality");
    }
  }
}

// dg_find_mss_classes_mt gives the same classes for every thread count,
// and they are the labels relabelled by the segments of dg_mss_find_all:
// in a segment, a position labelled 0 takes the majority class over 1..4.
void TestClasses() {
  const int64_t n = 1 << 17;
  std::mt19937_64 rng(7);
  std::uniform_real_distribution<double> unit(0.0, 1.0);
  // Blocks of 2048 positions, three of four dense in positives: 16
  // segments, covering more than the parallel relabel's threshold.
  std::vector<double> scores(n);
  std::vector<int64_t> labels(n);
  for (int64_t i = 0; i < n; ++i) {
    const double t = 0.1 + unit(rng) * (kS0 - 0.1);
    const double rate = (i >> 11) % 4 ? 0.97 : 0.3;
    scores[i] = unit(rng) < rate ? t : -10.0 * t;
    labels[i] = static_cast<int64_t>(unit(rng) * 5);
  }
  std::vector<int32_t> want(labels.begin(), labels.end());
  std::vector<DgSegment> segs(n / 2 + 1);
  const int64_t n_seg = dg_mss_find_all(
      scores.data(), n, kS0 * 50, kS0 * 50 * 10, segs.data(),
      static_cast<int64_t>(segs.size()));
  Check(n_seg >= 16 && n_seg <= static_cast<int64_t>(segs.size()),
        "classes: segments found");
  for (int64_t s = 0; s < n_seg; ++s) {
    int64_t counts[5] = {0, 0, 0, 0, 0};
    for (int64_t p = segs[s].start; p < segs[s].end; ++p) ++counts[labels[p]];
    int32_t major = 1;
    for (int32_t c = 2; c < 5; ++c) {
      if (counts[c] > counts[major]) major = c;
    }
    for (int64_t p = segs[s].start; p < segs[s].end; ++p) {
      if (labels[p] == 0) want[p] = major;
    }
  }
  for (int threads : {1, 2, 3, 8}) {
    std::vector<int32_t> got(n, -1);
    dg_find_mss_classes_mt(scores.data(), labels.data(), n, 5, 50, 50,
                           threads, got.data());
    Check(got == want, "classes == segments' majority vote");
  }
}

// The majority vote on a hand-made track (min_mss_len 1: segments of score
// >= trunc(s0) = 4; xdrop_len 0: no X-drop reset).  Segments [2, 8),
// [10, 14) and [16, 18) are runs of score 2, split by -50 runs.
void TestMajorityVote() {
  const std::vector<double> scores = {-50, -50, 2, 2, 2, 2, 2, 2, -50,
                                      -50, 2, 2, 2, 2, -50, -50, 2, 2,
                                      -50, -50};
  const std::vector<int64_t> labels = {0, 3, 0, 2, 2, 3, 0, 1, 0, 4,
                                       0, 3, 1, 0, 0, 2, 0, 0, 4, 0};
  // [2, 8): class 2 twice, 3 and 1 once -> the zeros become 2.  [10, 14):
  // 3 and 1 once each, a tie -> the lower class, 1.  [16, 18): no class
  // above 0 -> class 1.  Outside the segments every label stays.
  const std::vector<int32_t> want = {0, 3, 2, 2, 2, 3, 2, 1, 0, 4,
                                     1, 3, 1, 1, 0, 2, 1, 1, 4, 0};
  const int64_t n = static_cast<int64_t>(scores.size());
  for (int threads : {1, 4}) {
    std::vector<int32_t> got(n, -1);
    dg_find_mss_classes_mt(scores.data(), labels.data(), n, 5, 1, 0,
                           threads, got.data());
    Check(got == want, "hand-made majority vote");
  }
}

void TestTrim() {
  const char *seq = "NNACGTXacgtNN";
  int64_t start = 0, end = 0;
  dg_trim_n(seq, static_cast<int64_t>(std::strlen(seq)), &start, &end);
  Check(start == 2 && end == 11, "trim bounds");
  dg_trim_n("NNNN", 4, &start, &end);
  Check(start == end, "trim an all-N sequence to nothing");
}

// The split rule of deepgrp_native.h, restated in two passes: list every
// maximal non-positive run [a, i) that starts after position 0 and ends at
// a positive position i, then keep its end when the run's drop exceeds
// xdrop + 1e-6 * max(1, |xdrop|) and i is min_gap past the previous split
// (the first split counts from 0).
std::vector<int64_t> SplitsByRule(const std::vector<double> &scores,
                                  double xdrop, int64_t min_gap) {
  const double limit = xdrop + 1e-6 * std::max(1.0, std::fabs(xdrop));
  const int64_t n = static_cast<int64_t>(scores.size());
  std::vector<std::pair<int64_t, double>> runs;  // (end, drop)
  int64_t i = 0;
  while (i < n) {
    if (scores[i] > 0.0) {
      ++i;
      continue;
    }
    const int64_t a = i;
    double drop = 0.0;
    while (i < n && scores[i] <= 0.0) drop -= scores[i++];
    if (a > 0 && i < n) runs.emplace_back(i, drop);
  }
  std::vector<int64_t> splits;
  int64_t last = 0;
  for (const auto &run : runs) {
    if (run.second > limit && run.first - last >= min_gap) {
      splits.push_back(run.first);
      last = run.first;
    }
  }
  return splits;
}

struct ScanResult {
  std::vector<int64_t> splits;
  int64_t state[2];
  double drop;
};

// Feed `scores` to dg_split_scan_* in the pieces that `cuts` bounds
// (ascending, from 0 to n), carrying state and drop across the calls.
template <typename T, typename Fn>
ScanResult ScanInPieces(Fn fn, const std::vector<T> &scores, double xdrop,
                        int64_t min_gap, const std::vector<int64_t> &cuts) {
  ScanResult r{{}, {-1, 0}, 0.0};
  for (size_t k = 0; k + 1 < cuts.size(); ++k) {
    const int64_t lo = cuts[k], hi = cuts[k + 1];
    std::vector<int64_t> out((hi - lo) / min_gap + 1);
    const int64_t count =
        fn(scores.data(), lo, hi, xdrop, min_gap, r.state, &r.drop,
           out.data());
    Check(count >= 0 && count <= static_cast<int64_t>(out.size()),
          "split count within the buffer");
    r.splits.insert(r.splits.end(), out.begin(), out.begin() + count);
  }
  return r;
}

bool SameScan(const ScanResult &a, const ScanResult &b) {
  return a.splits == b.splits && a.state[0] == b.state[0] &&
         a.state[1] == b.state[1] && a.drop == b.drop;
}

// One track: pieces against one call, both against the rule, f32 against
// f64.  The scores are multiples of 1/8 below 2^10 in magnitude, exact in
// float32, so the two scans see the same values.
size_t CheckSplitScan(std::mt19937_64 &rng,
                      const std::vector<double> &scores, double xdrop,
                      int64_t min_gap, const char *what) {
  const int64_t n = static_cast<int64_t>(scores.size());
  const std::vector<float> scores32(scores.begin(), scores.end());
  for (int64_t i = 0; i < n; ++i) {
    Check(static_cast<double>(scores32[i]) == scores[i],
          "scores exact in float32");
  }
  const std::vector<int64_t> want = SplitsByRule(scores, xdrop, min_gap);
  const ScanResult whole64 =
      ScanInPieces(dg_split_scan_f64, scores, xdrop, min_gap, {0, n});
  const ScanResult whole32 =
      ScanInPieces(dg_split_scan_f32, scores32, xdrop, min_gap, {0, n});
  if (whole64.splits != want) std::fprintf(stderr, "track: %s\n", what);
  Check(whole64.splits == want, "one call == the rule");
  Check(SameScan(whole32, whole64), "float32 == float64");
  // Random pieces, with pieces of length 0 and 1 among them.
  std::uniform_int_distribution<int64_t> piece(0, 2 * n / 7 + 1);
  std::uniform_int_distribution<int> kind(0, 3);
  for (int trial = 0; trial < 8; ++trial) {
    std::vector<int64_t> cuts = {0};
    while (cuts.back() < n) {
      const int k = kind(rng);
      const int64_t len = k == 0 ? 0 : k == 1 ? 1 : piece(rng);
      cuts.push_back(std::min(n, cuts.back() + len));
    }
    const ScanResult pieces64 =
        ScanInPieces(dg_split_scan_f64, scores, xdrop, min_gap, cuts);
    const ScanResult pieces32 =
        ScanInPieces(dg_split_scan_f32, scores32, xdrop, min_gap, cuts);
    if (!SameScan(pieces64, whole64)) {
      std::fprintf(stderr, "track: %s, %zu pieces\n", what, cuts.size() - 1);
    }
    Check(SameScan(pieces64, whole64), "pieces == one call (float64)");
    Check(SameScan(pieces32, whole64), "pieces == one call (float32)");
  }
  return want.size();
}

// A track of multiples of 1/8: positive with probability `positive_rate`.
std::vector<double> EighthsTrack(std::mt19937_64 &rng, int64_t n,
                                 double positive_rate) {
  std::uniform_real_distribution<double> unit(0.0, 1.0);
  std::uniform_int_distribution<int> eighths(1, 40);
  std::vector<double> scores(n);
  for (int64_t i = 0; i < n; ++i) {
    const double t = eighths(rng) / 8.0;
    scores[i] = unit(rng) < positive_rate ? t : -t;
  }
  return scores;
}

void TestSplitScan() {
  std::mt19937_64 rng(11);
  size_t sparse = 0, dense = 0;
  for (int64_t min_gap : {int64_t{1}, int64_t{7}, int64_t{500}}) {
    for (double xdrop : {0.5, 6.0, 40.0}) {
      sparse += CheckSplitScan(rng, EighthsTrack(rng, 5000, 0.05), xdrop,
                               min_gap, "sparse");
      dense += CheckSplitScan(rng, EighthsTrack(rng, 5000, 0.7), xdrop,
                              min_gap, "dense");
      Check(CheckSplitScan(rng, EighthsTrack(rng, 3000, 0.0), xdrop,
                           min_gap, "all negative") == 0,
            "no split on an all-negative track");
    }
  }
  Check(sparse > 0 && dense > 0, "the random tracks split");
  // All negative: a run that never ends never splits.
  {
    const std::vector<double> scores(1000, -5.0);
    const ScanResult r =
        ScanInPieces(dg_split_scan_f64, scores, 1.0, 1, {0, 400, 1000});
    Check(r.splits.empty() && r.state[0] == 0 && r.drop == 5000.0,
          "an open run carries its start and drop");
  }
  // A run from position 0 never splits; the same run one position later
  // does, at its end.
  {
    std::vector<double> scores = {-4, -4, -4, 1, -4, -4, 1, 1};
    Check(SplitsByRule(scores, 2.0, 1) == std::vector<int64_t>{6},
          "the rule skips the run at 0");
    const ScanResult r = ScanInPieces(dg_split_scan_f64, scores, 2.0, 1,
                                      {0, 1, 1, 3, 4, 8});
    Check(r.splits == std::vector<int64_t>{6}, "no split after a run at 0");
    CheckSplitScan(rng, scores, 2.0, 1, "run at 0");
    scores[0] = 1.0;
    Check(SplitsByRule(scores, 2.0, 1) == std::vector<int64_t>{3, 6},
          "the rule splits a run after 0");
    CheckSplitScan(rng, scores, 2.0, 1, "run after 0");
  }
  // A drop at xdrop, or above it by less than the margin, does not split.
  {
    const std::vector<double> scores = {1, -1, -1, 1, -1, -1.125, 1};
    Check(SplitsByRule(scores, 2.0, 1) == std::vector<int64_t>{6},
          "the margin");
    CheckSplitScan(rng, scores, 2.0, 1, "margin");
    const std::vector<double> inside = {1, -1, -(1 + std::ldexp(1.0, -30)),
                                        1, -1, -1.125, 1};
    Check(SplitsByRule(inside, 2.0, 1) == std::vector<int64_t>{6},
          "the rule's margin");
    Check(ScanInPieces(dg_split_scan_f64, inside, 2.0, 1, {0, 7}).splits ==
              std::vector<int64_t>{6},
          "a drop inside the margin does not split");
  }
}

}  // namespace

int main() {
  for (uint64_t seed : {1u, 2u, 3u}) {
    TestMssStVsMt(seed, 1 << 18, 0.3);
    TestMssStVsMt(seed + 100, 1 << 16, 0.05);
    TestMssStVsMt(seed + 200, 1 << 16, 0.9);
  }
  TestClasses();
  TestMajorityVote();
  TestTrim();
  TestSplitScan();
  if (failures) {
    std::fprintf(stderr, "%d failures\n", failures);
    return 1;
  }
  std::printf("native selftest OK\n");
  return 0;
}
