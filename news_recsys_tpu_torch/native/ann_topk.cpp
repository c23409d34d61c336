// Host-side exact inner-product top-k (faiss IndexFlatIP equivalent).
//
// The reference depends on faiss (C++) for ANN over item embeddings
// (src/model/model_utils/TopKSearcher.py:38-47, DSSM/model.py:250-251).
// On TPU the hot path is pure-XLA matmul+top_k (news_recsys_tpu/ops/topk.py);
// this library is the *host/serving* fallback with no TPU attached:
// multithreaded, blocked dot products with a bounded min-heap per query.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libann_topk.so ann_topk.cpp -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct ScoredIdx {
  float score;
  int32_t idx;
};

struct Cmp {
  bool operator()(const ScoredIdx& a, const ScoredIdx& b) const {
    // min-heap on score; tie-break on idx for determinism
    return a.score > b.score || (a.score == b.score && a.idx < b.idx);
  }
};

void topk_range(const float* corpus, int64_t n, int64_t d, const float* queries,
                int64_t q_lo, int64_t q_hi, int64_t k, int32_t* out_idx,
                float* out_scores) {
  std::priority_queue<ScoredIdx, std::vector<ScoredIdx>, Cmp> heap;
  for (int64_t q = q_lo; q < q_hi; ++q) {
    const float* qv = queries + q * d;
    while (!heap.empty()) heap.pop();
    for (int64_t i = 0; i < n; ++i) {
      const float* cv = corpus + i * d;
      float s = 0.f;
      for (int64_t j = 0; j < d; ++j) s += qv[j] * cv[j];
      if ((int64_t)heap.size() < k) {
        heap.push({s, (int32_t)i});
      } else if (s > heap.top().score) {
        heap.pop();
        heap.push({s, (int32_t)i});
      }
    }
    int64_t m = (int64_t)heap.size();
    for (int64_t r = m - 1; r >= 0; --r) {
      out_idx[q * k + r] = heap.top().idx;
      out_scores[q * k + r] = heap.top().score;
      heap.pop();
    }
    for (int64_t r = m; r < k; ++r) {  // n < k: pad
      out_idx[q * k + r] = -1;
      out_scores[q * k + r] = -INFINITY;
    }
  }
}

}  // namespace

extern "C" {

// corpus: (n, d) row-major; queries: (q, d); outputs (q, k).
void ann_topk_ip(const float* corpus, int64_t n, int64_t d,
                 const float* queries, int64_t q, int64_t k,
                 int32_t* out_idx, float* out_scores, int32_t n_threads) {
  if (n_threads <= 1 || q < 2) {
    topk_range(corpus, n, d, queries, 0, q, k, out_idx, out_scores);
    return;
  }
  int64_t nt = std::min<int64_t>(n_threads, q);
  std::vector<std::thread> threads;
  int64_t per = (q + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    int64_t lo = t * per, hi = std::min(q, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(topk_range, corpus, n, d, queries, lo, hi, k,
                         out_idx, out_scores);
  }
  for (auto& th : threads) th.join();
}

// L2-normalize rows in place (for cosine search).
void ann_l2_normalize(float* data, int64_t n, int64_t d) {
  for (int64_t i = 0; i < n; ++i) {
    float* row = data + i * d;
    float s = 0.f;
    for (int64_t j = 0; j < d; ++j) s += row[j] * row[j];
    float inv = s > 0.f ? 1.0f / std::sqrt(s) : 0.f;
    for (int64_t j = 0; j < d; ++j) row[j] *= inv;
  }
}
}
