// Batched seed+chain — the aligner's host front-end in one native call.
//
// Per query: minimizer sketch (sketch_dna), sorted-index binary-search
// lookup, anchor expansion (first max_hits hits per minimizer, strand =
// +1 iff index strand == query strand), per-strand (t, q) stable sort,
// windowed chain DP (chain_dp) and greedy backtrack (chain_backtrack) —
// exactly the per-read python path in aligner.Aligner.align /
// ops/minimizer.MinimizerIndex.anchors / ops/chain.chain_anchors, fused so
// a batch of reads costs one ctypes call (GIL released → overlaps the
// python planning thread) and threads across the host cores.
//
// The reference gets all of this from minimap2's C internals
// (Raw_variant_call.py:46-58); this is its host-side counterpart — the
// banded extension DP itself runs on the device.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
int64_t sketch_dna(const int8_t* codes, int64_t L, int32_t k, int32_t w,
                   int64_t* out_pos, uint32_t* out_hash, int8_t* out_strand);
void chain_dp(const int64_t* q, const int64_t* t, int64_t n,
              int32_t k, int32_t max_pred, int64_t max_gap, int64_t bandwidth,
              float gap_scale, float* f, int32_t* pre);
int64_t chain_backtrack(const float* f, const int32_t* pre, int64_t n,
                        float min_score, int32_t min_anchors,
                        int8_t* used, int32_t* out_chain_id,
                        float* out_scores, int64_t max_chains);
}

namespace {

struct ChainOut {
    int32_t query;
    int8_t strand;          // +1 / -1
    float score;
    std::vector<int64_t> aq, at;   // anchors in (t, q) sorted order
};

struct Anchor { int64_t t, q; };

// Primary + non-redundant supplementary selection (the python
// Aligner._select/_anchor_cover logic, moved native): chains are taken in
// score-descending order; one overlapping > sel_frac of its query span
// with the anchor-covered intervals of already-accepted chains is
// dropped.  Anchor cover merges anchors into forward-orientation query
// intervals, leaving holes > sel_hole uncovered.
void select_chains(std::vector<ChainOut>& chains, int64_t qlen, int32_t k,
                   int64_t sel_hole, float sel_frac)
{
    std::stable_sort(chains.begin(), chains.end(),
                     [](const ChainOut& a, const ChainOut& b) {
                         return a.score > b.score;
                     });
    struct IV { int64_t s, e; };
    std::vector<IV> cov;
    std::vector<ChainOut> kept;
    std::vector<int64_t> aq_sorted;
    for (auto& ch : chains) {
        int64_t qs = ch.aq[0], qe = ch.aq[0];
        for (int64_t v : ch.aq) { if (v < qs) qs = v; if (v > qe) qe = v; }
        qe += k;
        const int64_t fq_s = ch.strand == -1 ? qlen - qe : qs;
        const int64_t fq_e = ch.strand == -1 ? qlen - qs : qe;
        int64_t ov = 0;
        for (const auto& iv : cov) {
            const int64_t lo = iv.s > fq_s ? iv.s : fq_s;
            const int64_t hi = iv.e < fq_e ? iv.e : fq_e;
            if (hi > lo) ov += hi - lo;
        }
        if ((float)ov > sel_frac * (float)(fq_e - fq_s)) continue;
        // anchor cover in the oriented frame, then flip if '-'
        aq_sorted.assign(ch.aq.begin(), ch.aq.end());
        std::sort(aq_sorted.begin(), aq_sorted.end());
        int64_t run_s = aq_sorted[0], run_e = aq_sorted[0] + k;
        std::vector<IV> ivs;
        for (std::size_t i = 1; i < aq_sorted.size(); ++i) {
            if (aq_sorted[i] > run_e + sel_hole) {
                ivs.push_back({run_s, run_e});
                run_s = aq_sorted[i];
            }
            run_e = aq_sorted[i] + k;
        }
        ivs.push_back({run_s, run_e});
        for (auto& iv : ivs) {
            if (ch.strand == -1)
                cov.push_back({qlen - iv.e, qlen - iv.s});
            else
                cov.push_back(iv);
        }
        kept.push_back(std::move(ch));
    }
    chains.swap(kept);
}

void run_query(
    int32_t qi_idx, const int8_t* codes, int64_t qlen,
    int32_t k, int32_t w,
    const uint32_t* idx_hash, const int64_t* idx_pos,
    const int8_t* idx_strand, int64_t idx_n, int32_t max_hits,
    int32_t max_pred, int64_t max_gap, int64_t bandwidth, float gap_scale,
    float min_score, int32_t min_anchors, int32_t max_chains,
    int64_t sel_hole, float sel_frac,
    std::vector<ChainOut>& out,
    std::vector<int64_t>& pos_buf, std::vector<uint32_t>& hash_buf,
    std::vector<int8_t>& strand_buf, std::vector<Anchor>& anch,
    std::vector<float>& f_buf, std::vector<int32_t>& pre_buf,
    std::vector<int8_t>& used_buf, std::vector<int32_t>& cid_buf)
{
    const int64_t n_km = qlen - k + 1;
    if (n_km < w) return;
    if ((int64_t)pos_buf.size() < n_km) {
        pos_buf.resize(n_km); hash_buf.resize(n_km); strand_buf.resize(n_km);
    }
    int64_t m = sketch_dna(codes, qlen, k, w, pos_buf.data(),
                           hash_buf.data(), strand_buf.data());
    if (m <= 0) return;

    // expand hits per strand (python: strand = +1 iff idx == query strand,
    // then sel by strand and q' = qlen - k - q for '-')
    std::vector<Anchor>& plus = anch;
    plus.clear();
    std::vector<Anchor> minus;
    for (int64_t i = 0; i < m; ++i) {
        const uint32_t h = hash_buf[i];
        const uint32_t* lo = std::lower_bound(idx_hash, idx_hash + idx_n, h);
        const uint32_t* hi = std::upper_bound(lo, idx_hash + idx_n, h);
        int64_t cnt = hi - lo;
        if (cnt > max_hits) cnt = max_hits;
        const int64_t base = lo - idx_hash;
        for (int64_t j = 0; j < cnt; ++j) {
            const int64_t t = idx_pos[base + j];
            if (idx_strand[base + j] == strand_buf[i])
                plus.push_back({t, pos_buf[i]});
            else
                minus.push_back({t, qlen - k - pos_buf[i]});
        }
    }

    for (int s = 0; s < 2; ++s) {               // python order: +1 then -1
        std::vector<Anchor>& a = s == 0 ? plus : minus;
        const int64_t n = (int64_t)a.size();
        if (n < min_anchors) continue;
        // np.lexsort((q, t)): by t, tie q, stable
        std::stable_sort(a.begin(), a.end(), [](const Anchor& x, const Anchor& y) {
            return x.t != y.t ? x.t < y.t : x.q < y.q;
        });
        if ((int64_t)f_buf.size() < n) {
            f_buf.resize(n); pre_buf.resize(n);
            used_buf.resize(n); cid_buf.resize(n);
        }
        std::vector<int64_t> qs(n), ts(n);
        for (int64_t i = 0; i < n; ++i) { qs[i] = a[i].q; ts[i] = a[i].t; }
        chain_dp(qs.data(), ts.data(), n, k, max_pred, max_gap, bandwidth,
                 gap_scale, f_buf.data(), pre_buf.data());
        std::memset(used_buf.data(), 0, n);
        std::vector<float> scores(max_chains);
        int64_t nc = chain_backtrack(f_buf.data(), pre_buf.data(), n,
                                     min_score, min_anchors, used_buf.data(),
                                     cid_buf.data(), scores.data(),
                                     max_chains);
        if (nc == 0) continue;
        const size_t first = out.size();
        for (int64_t c = 0; c < nc; ++c) {
            out.push_back(ChainOut{qi_idx, (int8_t)(s == 0 ? 1 : -1),
                                   scores[c], {}, {}});
        }
        // chain members in sorted-array index order (== path order)
        for (int64_t i = 0; i < n; ++i) {
            const int32_t c = cid_buf[i];
            if (c >= 0) {
                out[first + c].aq.push_back(qs[i]);
                out[first + c].at.push_back(ts[i]);
            }
        }
    }
    if (sel_frac > 0.0f && !out.empty())
        select_chains(out, qlen, k, sel_hole, sel_frac);
}

}  // namespace

extern "C" {

struct SeedChainResult {
    int64_t n_chains;
    int64_t n_anchors;
    int32_t* chain_query;   // (n_chains,) query index
    int8_t* chain_strand;   // (n_chains,) +1/-1
    float* chain_score;     // (n_chains,)
    int64_t* anchor_off;    // (n_chains+1,)
    int64_t* aq;            // (n_anchors,) strand-oriented query starts
    int64_t* at;            // (n_anchors,) global target starts
};

SeedChainResult* seed_chain_batch(
    const int8_t* codes, const int64_t* q_off, int64_t n_query,
    int32_t k, int32_t w,
    const uint32_t* idx_hash, const int64_t* idx_pos,
    const int8_t* idx_strand, int64_t idx_n, int32_t max_hits,
    int32_t max_pred, int64_t max_gap, int64_t bandwidth, float gap_scale,
    float min_score, int32_t min_anchors, int32_t max_chains,
    int32_t n_threads, int64_t sel_hole, float sel_frac)
{
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > (int)n_query) nt = n_query > 0 ? (int)n_query : 1;

    std::vector<std::vector<ChainOut>> per_q((size_t)n_query);
    auto work = [&](int tid) {
        std::vector<int64_t> pos_buf;
        std::vector<uint32_t> hash_buf;
        std::vector<int8_t> strand_buf;
        std::vector<Anchor> anch;
        std::vector<float> f_buf;
        std::vector<int32_t> pre_buf;
        std::vector<int8_t> used_buf;
        std::vector<int32_t> cid_buf;
        for (int64_t qi = tid; qi < n_query; qi += nt) {
            run_query((int32_t)qi, codes + q_off[qi],
                      q_off[qi + 1] - q_off[qi], k, w,
                      idx_hash, idx_pos, idx_strand, idx_n, max_hits,
                      max_pred, max_gap, bandwidth, gap_scale,
                      min_score, min_anchors, max_chains,
                      sel_hole, sel_frac,
                      per_q[(size_t)qi],
                      pos_buf, hash_buf, strand_buf, anch,
                      f_buf, pre_buf, used_buf, cid_buf);
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ths;
        for (int tid = 0; tid < nt; ++tid) ths.emplace_back(work, tid);
        for (auto& th : ths) th.join();
    }

    int64_t n_chains = 0, n_anchors = 0;
    for (auto& v : per_q)
        for (auto& c : v) { ++n_chains; n_anchors += (int64_t)c.aq.size(); }

    auto* r = (SeedChainResult*)std::malloc(sizeof(SeedChainResult));
    r->n_chains = n_chains;
    r->n_anchors = n_anchors;
    r->chain_query = (int32_t*)std::malloc(sizeof(int32_t) * (n_chains + 1));
    r->chain_strand = (int8_t*)std::malloc(sizeof(int8_t) * (n_chains + 1));
    r->chain_score = (float*)std::malloc(sizeof(float) * (n_chains + 1));
    r->anchor_off = (int64_t*)std::malloc(sizeof(int64_t) * (n_chains + 1));
    r->aq = (int64_t*)std::malloc(sizeof(int64_t) * (n_anchors + 1));
    r->at = (int64_t*)std::malloc(sizeof(int64_t) * (n_anchors + 1));
    int64_t ci = 0, ai = 0;
    for (auto& v : per_q) {
        for (auto& c : v) {
            r->chain_query[ci] = c.query;
            r->chain_strand[ci] = c.strand;
            r->chain_score[ci] = c.score;
            r->anchor_off[ci] = ai;
            std::memcpy(r->aq + ai, c.aq.data(),
                        sizeof(int64_t) * c.aq.size());
            std::memcpy(r->at + ai, c.at.data(),
                        sizeof(int64_t) * c.at.size());
            ai += (int64_t)c.aq.size();
            ++ci;
        }
    }
    r->anchor_off[ci] = ai;
    return r;
}

void seed_chain_free(SeedChainResult* r) {
    if (!r) return;
    std::free(r->chain_query);
    std::free(r->chain_strand);
    std::free(r->chain_score);
    std::free(r->anchor_off);
    std::free(r->aq);
    std::free(r->at);
    std::free(r);
}

}  // extern "C"
