// Port of tophat_tpu/native/sais.cpp (host code): the same C interface and
// results, with the suffix sort rewritten to fit a human-scale group.
// SA-IS suffix array construction (linear time, induced sorting).
//
// Native replacement for the role of the external `bowtie-build`
// (reference: src/tophat.py:2600 build_idx_from_fa shells out to it); the
// numpy prefix-doubling fallback in index/suffix.py is O(n log^2 n) and too
// slow beyond ~10^7 bases. Exposed to Python via ctypes (native/
// __init__.py); built on demand with g++ -O2.
//
// The caller passes codes in [0, 255) and receives the suffix array of
// text + implicit sentinel (sa[0] == n). The sort is Nong, Zhang and
// Chan's SA-IS in its compact form: the reduced string and its suffix
// array live inside the output array, each symbol carries its L/S type in
// its top bit, and the induced-sorting scans prefetch the text a few
// dozen rows ahead (their one random access a row). Scratch beyond the
// output is the (n + 1)-byte working text and the buckets: ~1.3 B/base at
// the first reduced level. A text of fewer than 2^31 - 1 symbols sorts
// on 32-bit indexes (sais_suffix_array32), which halves the output and
// every scan's bytes; the BWT and k-mer passes take either width.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <sys/mman.h>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

constexpr int kPrefetch = 32;   // rows a scan reads ahead

inline void prefetch(const void* p) { __builtin_prefetch(p, 0, 0); }

// Ask for transparent huge pages on a large buffer not yet touched: the
// scans' random accesses then miss the TLB far less (advice only; a
// kernel without THP ignores it).
inline void huge_pages(void* p, size_t bytes) {
  uintptr_t a = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(4095);
  uintptr_t e = reinterpret_cast<uintptr_t>(p) + bytes;
  if (bytes >= (size_t(1) << 22))
    madvise(reinterpret_cast<void*>(a), e - a, MADV_HUGEPAGE);
}

// SA-IS over s[0..n-1] (unsigned C symbols in [0, K), s[n-1] == 0 the
// unique smallest) into sa[0..n-1]. The top bit of each s[i] is free on
// entry and holds i's type (S = 1) while this level runs.
template <typename I, typename C>
void sais_core(C* s, I* sa, I n, I K) {
  using U = typename std::make_unsigned<I>::type;
  const C TOP = C(C(1) << (8 * sizeof(C) - 1));
  const C MASK = C(TOP - 1);
  if (n == 1) { sa[0] = 0; return; }

  s[n - 1] = C(s[n - 1] | TOP);
  for (I i = n - 2; i >= 0; --i) {
    C a = s[i] & MASK, b = s[i + 1] & MASK;
    bool st = a < b || (a == b && (s[i + 1] & TOP));
    s[i] = st ? C(a | TOP) : a;
  }
  auto chr = [&](I i) -> I { return I(s[i] & MASK); };
  auto stype = [&](I i) -> bool { return (s[i] & TOP) != 0; };
  auto is_lms = [&](I i) -> bool {
    return i > 0 && stype(i) && !stype(i - 1);
  };

  std::vector<I> cnt(K, 0), bkt(K);
  for (I i = 0; i < n; ++i) cnt[chr(i)]++;
  auto heads = [&]() {
    I sum = 0;
    for (I c = 0; c < K; ++c) { bkt[c] = sum; sum += cnt[c]; }
  };
  auto tails = [&]() {
    I sum = 0;
    for (I c = 0; c < K; ++c) { sum += cnt[c]; bkt[c] = sum; }
  };
  // L-type suffixes from the sorted LMS ones (left to right), then S-type
  // from the L-type (right to left); each row reads s at sa[i] - 1
  auto induce = [&]() {
    heads();
    for (I i = 0; i < n; ++i) {
      if (i + kPrefetch < n) prefetch(&s[sa[i + kPrefetch] - 1]);
      I j = sa[i] - 1;
      if (j >= 0 && !stype(j)) sa[bkt[chr(j)]++] = j;
    }
    tails();
    for (I i = n - 1; i >= 0; --i) {
      if (i >= kPrefetch) prefetch(&s[sa[i - kPrefetch] - 1]);
      I j = sa[i] - 1;
      if (j >= 0 && stype(j)) sa[--bkt[chr(j)]] = j;
    }
  };

  // stage 1: sort the LMS substrings
  std::fill(sa, sa + n, I(-1));
  tails();
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) sa[--bkt[chr(i)]] = i;
  induce();

  // the sorted LMS positions to sa[0..n1)
  I n1 = 0;
  for (I i = 0; i < n; ++i) {
    if (i + kPrefetch < n) prefetch(&s[sa[i + kPrefetch] - 1]);
    if (is_lms(sa[i])) sa[n1++] = sa[i];
  }
  // name them: equal LMS substrings (symbols and types) share a name;
  // the name of position p goes to sa[n1 + p / 2] (LMS positions are at
  // least 2 apart, so the slots are distinct)
  std::fill(sa + n1, sa + n, I(-1));
  I names = 0, prev = -1;
  for (I i = 0; i < n1; ++i) {
    if (i + kPrefetch < n1) prefetch(&s[sa[i + kPrefetch]]);
    I p = sa[i];
    bool diff = prev < 0;
    for (I d = 0; !diff; ++d) {
      if (s[p + d] != s[prev + d]) diff = true;
      else if (d > 0 && (is_lms(p + d) || is_lms(prev + d))) break;
    }
    if (diff) { ++names; prev = p; }
    sa[n1 + p / 2] = names - 1;
  }
  for (I i = n - 1, j = n - 1; i >= n1; --i)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // stage 2: the reduced string s1 (names in text order) at the end of
  // sa, its suffix array sa1 at the front
  I* sa1 = sa;
  U* s1 = reinterpret_cast<U*>(sa + n - n1);
  if (names < n1) {
    sais_core<I, U>(s1, sa1, n1, names);
  } else {
    for (I i = 0; i < n1; ++i) sa1[s1[i]] = i;
  }

  // stage 3: the LMS suffixes in sorted order, then induce the rest
  for (I i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) s1[j++] = U(i);
  for (I i = 0; i < n1; ++i) sa1[i] = I(s1[sa1[i]]);
  std::fill(sa + n1, sa + n, I(-1));
  tails();
  for (I i = n1 - 1; i >= 0; --i) {
    I j = sa[i];
    sa[i] = -1;
    sa[--bkt[chr(j)]] = j;
  }
  induce();
}

// SA of text + implicit sentinel into out[0..n]: the working text holds
// code + 1 (the sentinel is 0) with a free top bit, so codes up to 126
// take one byte a symbol and wider ones two.
template <typename I, typename C>
void sort_text(const uint8_t* text, int64_t n, I* out, int maxc) {
  std::unique_ptr<C[]> s(new C[n + 1]);
  huge_pages(s.get(), sizeof(C) * (n + 1));
  for (int64_t i = 0; i < n; ++i) s[i] = C(text[i] + 1);
  s[n] = 0;
  sais_core<I, C>(s.get(), out, I(n + 1), I(maxc + 2));
}

template <typename I>
int suffix_array(const uint8_t* text, int64_t n, I* out) {
  if (n < 0) return 1;
  if (n == 0) { out[0] = 0; return 0; }
  huge_pages(out, sizeof(I) * (n + 1));
  int maxc = 0;
  for (int64_t i = 0; i < n; ++i) maxc = std::max(maxc, int(text[i]));
  if (maxc + 1 < 128) sort_text<I, uint8_t>(text, n, out, maxc);
  else sort_text<I, uint16_t>(text, n, out, maxc);
  return 0;
}

// BWT from SA in one threaded pass: bwt[i] = text[sa[i]-1] (0 for the
// sentinel row). The gather is memory-latency bound, so threads help even
// on 2 vCPUs and the numpy version's boolean-mask temporaries (3 extra
// O(n) passes) disappear. Returns the primary (sentinel) row index.
template <typename I>
int64_t bwt_from_sa(const uint8_t* text, int64_t n, const I* sa,
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
        if (i + kPrefetch < hi) prefetch(&text[sa[i + kPrefetch] - 1]);
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

// SA interval [lo, hi) of every k-mer (both 0 where it is absent) in one
// threaded pass over the SA rows, one random text access a row (the
// following k-1 reads ride the same cache lines). Along the SA the rows
// of one k-mer form one contiguous run (a suffix shorter than k sorts
// before its extensions, never inside a run), so each thread writes the
// runs that start in its share of the rows: it skips a run that continues
// from the share before and finishes its last run past its end, and no
// two threads write one k-mer.
template <typename I>
int kmer_table(const uint8_t* text, int64_t n, const I* sa, int k,
               int32_t* lo, int32_t* hi, int nthreads) {
  int64_t m = n + 1;
  memset(lo, 0, (size_t(1) << (2 * k)) * sizeof(int32_t));
  memset(hi, 0, (size_t(1) << (2 * k)) * sizeof(int32_t));
  auto key = [&](int64_t i) -> int64_t {   // row i's k-mer, -1 if short
    int64_t s = sa[i];
    if (s + k > n) return -1;
    int64_t v = 0;
    for (int j = 0; j < k; ++j) v = v * 4 + text[s + j];
    return v;
  };
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> ts;
  int64_t step = (m + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t first = t * step, end = std::min(m, first + step);
    ts.emplace_back([&, first, end]() {
      int64_t i = first;
      if (i > 0 && i < end) {
        int64_t prev = key(i - 1);
        while (prev >= 0 && i < end && key(i) == prev) ++i;
      }
      for (int64_t last = -1; i < m; ++i) {
        if (i + kPrefetch < m) prefetch(&text[sa[i + kPrefetch]]);
        int64_t v = key(i);
        if (i >= end && (last < 0 || v != last)) break;
        if (v < 0) { last = -1; continue; }
        if (v != last) { lo[v] = int32_t(i); last = v; }
        hi[v] = int32_t(i + 1);
      }
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

}  // namespace

extern "C" {

// text: n codes in [0, 255); out: n+1 entries; returns 0 on success.
// Builds SA of text + implicit sentinel smaller than all symbols.
int sais_suffix_array(const uint8_t* text, int64_t n, int64_t* out) {
  return suffix_array<int64_t>(text, n, out);
}

// The same on 32-bit indexes: n + 1 + 64 must be below 2^31 (the scans'
// read-ahead indexes stay in range).
int sais_suffix_array32(const uint8_t* text, int64_t n, int32_t* out) {
  if (n + 1 + 64 > INT32_MAX) return 2;
  return suffix_array<int32_t>(text, n, out);
}

int64_t sais_bwt_from_sa(const uint8_t* text, int64_t n, const int64_t* sa,
                         uint8_t* bwt, int nthreads) {
  return bwt_from_sa<int64_t>(text, n, sa, bwt, nthreads);
}

int64_t sais_bwt_from_sa32(const uint8_t* text, int64_t n,
                           const int32_t* sa, uint8_t* bwt, int nthreads) {
  return bwt_from_sa<int32_t>(text, n, sa, bwt, nthreads);
}

int sais_kmer_table(const uint8_t* text, int64_t n, const int64_t* sa,
                    int k, int32_t* lo, int32_t* hi, int nthreads) {
  return kmer_table<int64_t>(text, n, sa, k, lo, hi, nthreads);
}

int sais_kmer_table32(const uint8_t* text, int64_t n, const int32_t* sa,
                      int k, int32_t* lo, int32_t* hi, int nthreads) {
  return kmer_table<int32_t>(text, n, sa, k, lo, hi, nthreads);
}
}
