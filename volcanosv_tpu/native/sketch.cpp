// Native (k,w)-minimizer sketch — exact mirror of ops/minimizer.sketch_np:
// strand-canonical rolling 2k-bit hashes, 38→32-bit fold, murmur3 finalizer
// mix, windowed minimum with rightmost tie-break, N-window and palindrome
// masking.  O(L) via a monotonic deque (the numpy path is O(L·w)).
//
// The reference gets this from minimap2's C sketch (SURVEY.md §2.2); this
// is the host-side seeding kernel of the engine's aligner.
#include <cstdint>
#include <vector>

namespace {

inline uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

}  // namespace

extern "C" {

// codes: 2-bit codes with 4 = N.  Outputs sized >= L-k+1 by the caller.
// Returns the number of minimizers (or -1 on bad args).
//
// Single fused pass: the rolling hash feeds a w-bounded monotonic ring
// deque directly (no O(L) temporaries — the earlier two-pass version
// allocated five O(L) arrays per call, which dominated its runtime on
// read-sized inputs).  The window front is the rightmost argmin; its
// position is non-decreasing as the window slides, so emitting on
// front-change yields exactly the two-pass marker set, in order.
int64_t sketch_dna(const int8_t* codes, int64_t L, int32_t k, int32_t w,
                   int64_t* out_pos, uint32_t* out_hash, int8_t* out_strand) {
  if (k < 1 || k > 31 || w < 1) return -1;
  const int64_t n = L - k + 1;
  if (n < w) return 0;
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);

  int64_t cap = 2;                          // pow2 ring ≥ w+1 entries
  while (cap < (int64_t)w + 1) cap <<= 1;
  const int64_t rmask = cap - 1;
  std::vector<int64_t> dpos((std::size_t)cap);
  std::vector<uint32_t> dh((std::size_t)cap);
  std::vector<int8_t> ds((std::size_t)cap);

  uint64_t fwd = 0, rc = 0;
  int64_t last_n = -1;  // last position holding an N
  int64_t head = 0, tail = 0;   // ring indices, [head, tail) mod cap
  int64_t last_emit = -1;
  int64_t m = 0;
  for (int64_t i = 0; i < L; ++i) {
    uint64_t c = static_cast<uint64_t>(codes[i]);
    if (c > 3) {
      last_n = i;
      c = 0;
    }
    fwd = ((fwd << 2) | c) & mask;
    rc = (rc >> 2) | ((c ^ 3ull) << (2 * (k - 1)));
    const int64_t p = i - k + 1;
    if (p < 0) continue;
    if (last_n < p && fwd != rc) {          // valid, non-palindromic
      const int8_t s = rc < fwd ? 1 : 0;
      const uint64_t canon = s ? rc : fwd;
      const uint32_t hp =
          mix32(static_cast<uint32_t>(canon ^ (canon >> 29)));
      // back-pop on >= gives the RIGHTMOST argmin at the front
      while (tail > head && dh[(tail - 1) & rmask] >= hp) --tail;
      dpos[tail & rmask] = p;
      dh[tail & rmask] = hp;
      ds[tail & rmask] = s;
      ++tail;
    }
    const int64_t win_lo = p - w + 1;
    while (tail > head && dpos[head & rmask] < win_lo) ++head;
    if (win_lo >= 0 && tail > head) {
      const int64_t fp = dpos[head & rmask];
      if (fp != last_emit) {
        out_pos[m] = fp;
        out_hash[m] = dh[head & rmask];
        out_strand[m] = ds[head & rmask];
        ++m;
        last_emit = fp;
      }
    }
  }
  return m;
}

}  // extern "C"
