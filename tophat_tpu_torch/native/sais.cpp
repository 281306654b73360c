// Copy of tophat_tpu/native/sais.cpp (host code), unchanged below this line.
// SA-IS suffix array construction (linear time, induced sorting).
//
// Native replacement for the role of the external `bowtie-build`
// (reference: src/tophat.py:2600 build_idx_from_fa shells out to it); the
// numpy prefix-doubling fallback in index/suffix.py is O(n log^2 n) and too
// slow beyond ~10^7 bases. Exposed to Python via ctypes (tophat_tpu/native/
// __init__.py); built on demand with g++ -O2.
//
// Standard SA-IS over an integer alphabet; the caller passes codes in
// [0, K) and receives the suffix array of text + implicit sentinel
// (sa[0] == n).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

typedef int64_t idx_t;

// Generic SA-IS over s[0..n-1] with alphabet [0, K); s must end with a
// unique smallest sentinel (we arrange that by working on text+1 codes
// with sentinel 0).
template <typename T>
void sais_core(const T* s, idx_t* sa, idx_t n, idx_t K) {
  if (n == 1) { sa[0] = 0; return; }

  std::vector<bool> is_s(n);
  is_s[n - 1] = true;
  for (idx_t i = n - 2; i >= 0; --i)
    is_s[i] = s[i] < s[i + 1] || (s[i] == s[i + 1] && is_s[i + 1]);
  auto is_lms = [&](idx_t i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

  std::vector<idx_t> bkt(K), bkt_heads(K), bkt_tails(K);
  for (idx_t i = 0; i < n; ++i) bkt[s[i]]++;
  auto reset_heads = [&]() {
    idx_t sum = 0;
    for (idx_t c = 0; c < K; ++c) { bkt_heads[c] = sum; sum += bkt[c]; }
  };
  auto reset_tails = [&]() {
    idx_t sum = 0;
    for (idx_t c = 0; c < K; ++c) { sum += bkt[c]; bkt_tails[c] = sum; }
  };

  auto induce = [&](const std::vector<idx_t>& lms) {
    std::memset(sa, -1, sizeof(idx_t) * n);
    reset_tails();
    for (idx_t i = (idx_t)lms.size() - 1; i >= 0; --i)
      sa[--bkt_tails[s[lms[i]]]] = lms[i];
    reset_heads();
    for (idx_t i = 0; i < n; ++i) {
      idx_t j = sa[i] - 1;
      if (sa[i] > 0 && !is_s[j]) sa[bkt_heads[s[j]]++] = j;
    }
    reset_tails();
    for (idx_t i = n - 1; i >= 0; --i) {
      idx_t j = sa[i] - 1;
      if (sa[i] > 0 && is_s[j]) sa[--bkt_tails[s[j]]] = j;
    }
  };

  std::vector<idx_t> lms;
  for (idx_t i = 1; i < n; ++i)
    if (is_lms(i)) lms.push_back(i);

  induce(lms);

  // name LMS substrings in SA order
  idx_t n_lms = (idx_t)lms.size();
  std::vector<idx_t> name_of(n, -1);
  idx_t names = 0, prev = -1;
  for (idx_t i = 0; i < n; ++i) {
    idx_t p = sa[i];
    if (!(p > 0 && is_s[p] && !is_s[p - 1])) continue;
    if (prev == -1) {
      name_of[p] = names++;
    } else {
      // compare LMS substrings at prev and p
      bool same = true;
      for (idx_t d = 0;; ++d) {
        bool l1 = is_lms(prev + d), l2 = is_lms(p + d);
        if (d > 0 && l1 && l2) break;
        if (l1 != l2 || s[prev + d] != s[p + d]) { same = false; break; }
      }
      if (!same) ++names;
      name_of[p] = names - 1;
    }
    prev = p;
  }

  std::vector<idx_t> s1(n_lms), sa1(n_lms);
  for (idx_t i = 0, j = 0; i < n; ++i)
    if (name_of[i] >= 0) s1[j++] = name_of[i];

  if (names < n_lms) {
    sais_core<idx_t>(s1.data(), sa1.data(), n_lms, names);
  } else {
    for (idx_t i = 0; i < n_lms; ++i) sa1[s1[i]] = i;
  }

  std::vector<idx_t> lms_sorted(n_lms);
  for (idx_t i = 0; i < n_lms; ++i) lms_sorted[i] = lms[sa1[i]];
  induce(lms_sorted);
}

}  // namespace

extern "C" {

// text: n codes in [0, 255]; out: n+1 entries; returns 0 on success.
// Builds SA of text + implicit sentinel smaller than all symbols.
int sais_suffix_array(const uint8_t* text, int64_t n, int64_t* out) {
  if (n < 0) return 1;
  if (n == 0) { out[0] = 0; return 0; }
  std::vector<uint8_t> s(n + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = (uint8_t)(text[i] + 1);
  s[n] = 0;  // sentinel
  sais_core<uint8_t>(s.data(), out, n + 1, 257);
  return 0;
}

// BWT from SA in one threaded pass: bwt[i] = text[sa[i]-1] (0 for the
// sentinel row). The gather is memory-latency bound, so threads help even
// on 2 vCPUs and the numpy version's boolean-mask temporaries (3 extra
// O(n) passes) disappear. Returns the primary (sentinel) row index.
int64_t sais_bwt_from_sa(const uint8_t* text, int64_t n, const int64_t* sa,
                         uint8_t* bwt, int nthreads) {
  int64_t m = n + 1;
  int64_t primary = -1;
  if (nthreads < 1) nthreads = 1;
  std::vector<int64_t> prim(nthreads, -1);
  std::vector<std::thread> ts;
  int64_t step = (m + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * step, hi = std::min(m, lo + step);
    ts.emplace_back([&, t, lo, hi]() {
      for (int64_t i = lo; i < hi; ++i) {
        int64_t s = sa[i];
        if (s > 0) bwt[i] = text[s - 1];
        else { bwt[i] = 0; prim[t] = i; }
      }
    });
  }
  for (auto& th : ts) th.join();
  for (int t = 0; t < nthreads; ++t)
    if (prim[t] >= 0) primary = prim[t];
  return primary;
}

// Per-SA-row k-mer key of the row's suffix (-1 where the suffix is
// shorter than k): replaces the numpy build's k rolling O(n) int64
// passes + one fancy-index gather with a single threaded pass that does
// one random text access per row (the following k-1 reads ride the same
// cache lines).
int sais_kmer_vals(const uint8_t* text, int64_t n, const int64_t* sa,
                   int k, int32_t* out, int nthreads) {
  int64_t m = n + 1;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> ts;
  int64_t step = (m + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * step, hi = std::min(m, lo + step);
    ts.emplace_back([&, lo, hi]() {
      for (int64_t i = lo; i < hi; ++i) {
        int64_t s = sa[i];
        if (s + k > n) { out[i] = -1; continue; }
        int32_t v = 0;
        for (int j = 0; j < k; ++j) v = v * 4 + (int32_t)text[s + j];
        out[i] = v;
      }
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

// kv (from sais_kmer_vals, SA order, nondecreasing over valid rows) ->
// per-k-mer SA interval [lo, hi). hi == 0 marks an absent k-mer; the
// caller zeroes those lo entries. Valid runs are contiguous in SA order
// (a shorter suffix sorts before its extensions, never inside one
// k-mer's run), so a single sequential pass suffices and the lo/hi
// writes are cache-local because kv is sorted.
int sais_kmer_table(const int32_t* kv, int64_t m, int64_t K4,
                    int32_t* lo, int32_t* hi) {
  memset(lo, 0, K4 * sizeof(int32_t));
  memset(hi, 0, K4 * sizeof(int32_t));
  for (int64_t i = 0; i < m; ++i) {
    int32_t v = kv[i];
    if (v < 0 || v >= K4) continue;
    if (hi[v] == 0) lo[v] = (int32_t)i;
    hi[v] = (int32_t)(i + 1);
  }
  return 0;
}
}
