// SA-IS suffix array construction (Nong, Zhang & Chan 2009), 64-bit,
// low-memory formulation: all per-level scratch (sorted LMS list,
// substring names, reduced problem T1/SA1) lives inside the SA buffer
// itself, as in the published algorithm.  Peak memory = 8n (SA) + n
// (type array) + caller's text — this is what makes human-scale
// genomes (6.2e9 doubled symbols) buildable on a 128 GB host.
//
// Index-construction engine for tpubwa (the role is.c/rope.c play in
// the reference build path, SURVEY.md §2 row 16) — implemented from
// the published induced-sorting algorithm, not ported code.
//
// Convention: the input text must end with a unique smallest sentinel
// (value 0, occurring exactly once, at the end).  SA has the same
// length as the text; SA[0] is the sentinel position.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using i64 = int64_t;

template <typename TChar>
void build_types(const TChar* T, i64 n, std::vector<uint8_t>& is_s) {
  is_s.assign(n, 0);
  is_s[n - 1] = 1;  // sentinel is S-type
  for (i64 i = n - 2; i >= 0; --i)
    is_s[i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && is_s[i + 1])) ? 1 : 0;
}

inline bool is_lms(const std::vector<uint8_t>& is_s, i64 i) {
  return i > 0 && is_s[i] && !is_s[i - 1];
}

template <typename TChar>
void bucket_sizes(const TChar* T, i64 n, i64 K, std::vector<i64>& cnt) {
  cnt.assign(K, 0);
  for (i64 i = 0; i < n; ++i) cnt[T[i]]++;
}

void bucket_heads(const std::vector<i64>& cnt, std::vector<i64>& head) {
  head.resize(cnt.size());
  i64 s = 0;
  for (size_t c = 0; c < cnt.size(); ++c) { head[c] = s; s += cnt[c]; }
}

void bucket_tails(const std::vector<i64>& cnt, std::vector<i64>& tail) {
  tail.resize(cnt.size());
  i64 s = 0;
  for (size_t c = 0; c < cnt.size(); ++c) { s += cnt[c]; tail[c] = s - 1; }
}

template <typename TChar>
void induce(const TChar* T, i64 n, i64 K, const std::vector<uint8_t>& is_s,
            const std::vector<i64>& cnt, i64* SA) {
  std::vector<i64> head, tail;
  // induce L-type left-to-right
  bucket_heads(cnt, head);
  for (i64 i = 0; i < n; ++i) {
    i64 j = SA[i];
    if (j > 0 && !is_s[j - 1]) SA[head[T[j - 1]]++] = j - 1;
  }
  // induce S-type right-to-left
  bucket_tails(cnt, tail);
  for (i64 i = n - 1; i >= 0; --i) {
    i64 j = SA[i];
    if (j > 0 && is_s[j - 1]) SA[tail[T[j - 1]]--] = j - 1;
  }
}

template <typename TChar>
void sais(const TChar* T, i64 n, i64 K, i64* SA) {
  if (n == 1) { SA[0] = 0; return; }
  std::vector<uint8_t> is_s;
  build_types(T, n, is_s);
  std::vector<i64> cnt, tail;
  bucket_sizes(T, n, K, cnt);

  // step 1: place LMS positions at bucket tails, induce-sort so the
  // SA prefix order of LMS positions equals LMS-substring order
  std::memset(SA, -1, sizeof(i64) * n);
  bucket_tails(cnt, tail);
  for (i64 i = n - 1; i >= 1; --i)
    if (is_lms(is_s, i)) SA[tail[T[i]]--] = i;
  induce(T, n, K, is_s, cnt, SA);

  // step 2: compact the sorted LMS positions into SA[0..n1), then name
  // their substrings into SA[n1..) indexed by pos>>1 (LMS positions
  // are never adjacent, so pos>>1 is injective and < n - n1)
  i64 n1 = 0;
  for (i64 i = 0; i < n; ++i)
    if (SA[i] > 0 && is_lms(is_s, SA[i])) SA[n1++] = SA[i];
  i64* names = SA + n1;
  std::fill(names, SA + n, (i64)-1);
  i64 n_names = 0;
  i64 prev = -1;
  for (i64 k = 0; k < n1; ++k) {
    i64 cur = SA[k];
    bool diff = (prev < 0);
    if (!diff) {
      // compare LMS substrings at prev and cur (up to and including
      // the next LMS position)
      for (i64 d = 0;; ++d) {
        bool lp = is_lms(is_s, prev + d), lc = is_lms(is_s, cur + d);
        if (d > 0 && lp && lc) break;            // both ended equal
        if (T[prev + d] != T[cur + d] || is_s[prev + d] != is_s[cur + d]
            || lp != lc) { diff = true; break; }
      }
    }
    if (diff) { ++n_names; prev = cur; }
    names[cur >> 1] = n_names - 1;
  }
  // compact the names (which appear in text order) to the END of SA:
  // T1 = SA[n - n1 .. n)
  for (i64 i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];
  i64* T1 = SA + n - n1;

  // reduced problem: SA1 = SA[0..n1)
  if (n_names < n1) {
    sais<i64>(T1, n1, n_names, SA);
  } else {
    for (i64 k = 0; k < n1; ++k) SA[T1[k]] = k;
  }

  // step 3: map SA1 ranks back to LMS text positions.  T1 is no longer
  // needed, so rebuild the text-order LMS position list in its place.
  {
    i64 j = 0;
    for (i64 i = 1; i < n; ++i)
      if (is_lms(is_s, i)) T1[j++] = i;
  }
  for (i64 k = 0; k < n1; ++k) SA[k] = T1[SA[k]];
  // clear the rest and scatter the sorted LMS suffixes to bucket tails
  std::memset(SA + n1, -1, sizeof(i64) * (n - n1));
  bucket_tails(cnt, tail);
  for (i64 k = n1 - 1; k >= 0; --k) {
    i64 j = SA[k];
    SA[k] = -1;
    SA[tail[T[j]]--] = j;
  }
  induce(T, n, K, is_s, cnt, SA);
}

}  // namespace

extern "C" {

// T: uint8 text of length n ending with a unique smallest 0 sentinel.
// SA: output, length n.  K: alphabet size (max(T)+1).  Returns 0.
int tpubwa_sais_u8(const uint8_t* T, int64_t n, int64_t* SA, int64_t K) {
  if (n <= 0) return -1;
  sais<uint8_t>(T, n, K, SA);
  return 0;
}

}  // extern "C"
