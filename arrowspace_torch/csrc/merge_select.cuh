// The exact selection both modes of K3 share (merge_topk_tf32.cu and
// merge_topk_bf16.cu): the order of the top-k, and the merge of one
// query's candidates into its sorted top-k list by rank.  Both run the
// same instructions, so the two modes order and tie alike.
#pragma once

namespace asp_merge {

constexpr int kMaxK = 128;

// (sa, ia) before (sb, ib) in the order of the top-k: higher score, then
// lower id.
__device__ __forceinline__ bool ahead(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// One warp merges a query's n_c candidates (cs, ci: unsorted, distinct
// rows, none in the list) into its sorted top-k list (ls, li) by rank:
// a list entry at p lands at p plus the candidates ahead of it, a
// candidate at the list entries ahead of it (a binary search: the list is
// sorted) plus the candidates ahead of it; ranks past k drop out.  The
// list's empty slots (NEG_INF, INT_MAX) lose to every row and keep their
// order among themselves, so the ranks are a permutation.
template <int CAP>
__device__ __forceinline__ void merge_query(float* ls, int* li,
                                            const float* cs, const int* ci,
                                            int k, int n_c, int lane) {
  constexpr int kLM = kMaxK / 32, kCM = CAP / 32;
  float vs[kLM], ws[kCM];
  int vi[kLM], vr[kLM], wi[kCM], wr[kCM];
#pragma unroll
  for (int m = 0; m < kLM; ++m) {
    const int p = m * 32 + lane;
    vr[m] = kMaxK;
    if (p < k) {
      vs[m] = ls[p];
      vi[m] = li[p];
      int r = p;
      for (int c = 0; c < n_c; ++c) r += ahead(cs[c], ci[c], vs[m], vi[m]);
      vr[m] = r;
    }
  }
#pragma unroll
  for (int m = 0; m < kCM; ++m) {
    const int c = m * 32 + lane;
    wr[m] = kMaxK;
    if (c < n_c) {
      ws[m] = cs[c];
      wi[m] = ci[c];
      int lo = 0, hi = k;  // list entries ahead of it: a prefix
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ahead(ls[mid], li[mid], ws[m], wi[m]))
          lo = mid + 1;
        else
          hi = mid;
      }
      int r = lo;
      for (int d = 0; d < n_c; ++d) r += ahead(cs[d], ci[d], ws[m], wi[m]);
      wr[m] = r;
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kLM; ++m)
    if (vr[m] < k) {
      ls[vr[m]] = vs[m];
      li[vr[m]] = vi[m];
    }
#pragma unroll
  for (int m = 0; m < kCM; ++m)
    if (wr[m] < k) {
      ls[wr[m]] = ws[m];
      li[wr[m]] = wi[m];
    }
  __syncwarp();
}

}  // namespace asp_merge
