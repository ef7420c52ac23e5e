// Native minimum-degree ordering — the setup-path hot spot of the direct
// solver (the role cuSolver's csrsymamdHost plays, cusparse.c:72-74).
//
// Quotient-graph formulation (the AMD/MMD data structure): eliminated
// pivots become *elements* carrying their boundary list L_e; variables keep
// a variable-adjacency list A_v plus an element list E_v. Eliminating p
// merges A_p with the boundaries of its elements (which are absorbed), so
// cliques are never materialized — unlike the pure-Python fallback
// (ordering/amd.py), which inserts clique edges and is quadratic in
// practice. Degrees are exact exterior degrees, computed with a mark
// array, so the (degree, node) lexicographic tie-break — and therefore the
// permutation — matches the Python implementation bit-for-bit.
//
// C ABI for ctypes. Input: symmetrized adjacency (no self loops) in CSR.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <queue>
#include <vector>

extern "C" {

int lsb_min_degree(int64_t n, const int64_t *offs, const int32_t *cols,
                   int64_t *perm_out) {
  std::vector<std::vector<int32_t>> A(n), E(n), L(n);
  for (int64_t i = 0; i < n; ++i)
    A[i].assign(cols + offs[i], cols + offs[i + 1]);

  using Entry = std::pair<int64_t, int64_t>;  // (degree, node)
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) {
    deg[i] = (int64_t)A[i].size();
    heap.emplace(deg[i], i);
  }

  std::vector<char> eliminated(n, 0), absorbed(n, 0), in_lp(n, 0);
  std::vector<int64_t> mark(n, -1);
  int64_t stamp = 0, pos = 0;
  std::vector<int32_t> Lp;

  while (!heap.empty()) {
    auto [d, p] = heap.top();
    heap.pop();
    if (eliminated[p] || d != deg[p]) continue;  // stale entry
    eliminated[p] = 1;
    perm_out[pos++] = p;

    // Boundary L_p = (A_p ∪ ∪_{e∈E_p} L_e) \ {p} over live variables.
    ++stamp;
    mark[p] = stamp;
    Lp.clear();
    for (int32_t v : A[p])
      if (!eliminated[v] && mark[v] != stamp) {
        mark[v] = stamp;
        Lp.push_back(v);
      }
    for (int32_t e : E[p]) {
      if (absorbed[e]) continue;
      for (int32_t v : L[e])
        if (!eliminated[v] && mark[v] != stamp) {
          mark[v] = stamp;
          Lp.push_back(v);
        }
      absorbed[e] = 1;
      L[e].clear();
      L[e].shrink_to_fit();
    }
    A[p].clear();
    A[p].shrink_to_fit();
    E[p].clear();
    L[p] = Lp;
    in_lp[p] = 1;
    for (int32_t v : Lp) in_lp[v] = 1;

    // Update each boundary variable: prune its lists, recompute degree.
    for (int32_t v : Lp) {
      // A_v loses members of L_p ∪ {p} (now reached through element p)
      // and any eliminated stragglers.
      auto &av = A[v];
      std::size_t w = 0;
      for (int32_t u : av)
        if (!eliminated[u] && !in_lp[u]) av[w++] = u;
      av.resize(w);
      // E_v drops absorbed elements, gains p.
      auto &ev = E[v];
      w = 0;
      for (int32_t e : ev)
        if (!absorbed[e]) ev[w++] = e;
      ev.resize(w);
      ev.push_back((int32_t)p);
      // Exact exterior degree via a fresh mark pass.
      ++stamp;
      mark[v] = stamp;
      int64_t dv = 0;
      for (int32_t u : av)
        if (mark[u] != stamp) {
          mark[u] = stamp;
          ++dv;
        }
      for (int32_t e : ev)
        for (int32_t u : L[e])
          if (!eliminated[u] && mark[u] != stamp) {
            mark[u] = stamp;
            ++dv;
          }
      deg[v] = dv;
      heap.emplace(dv, (int64_t)v);
    }
    in_lp[p] = 0;
    for (int32_t v : Lp) in_lp[v] = 0;
  }
  return pos == n ? 0 : 1;
}

// Approximate minimum degree (Amestoy-Davis-Duff style) — the algorithm
// class SuiteSparse AMD implements and CHOLMOD's analyze runs
// (cholmod-impl.h:25). Three accelerations over lsb_min_degree's exact
// scheme, which is O(sum of boundary scans) and measured 19-21 s at
// n=262k:
//   1. APPROXIMATE external degrees: per pivot, one "w pass" computes
//      |L_e \ L_p| for every element touching the boundary, so each
//      boundary variable's degree is a sum over its short lists instead
//      of a fresh mark sweep over all reachable boundaries.
//   2. SUPERVARIABLES: indistinguishable boundary variables (identical
//      adjacency) are merged and eliminated together (hash + exact
//      list compare), collapsing the graph as elimination proceeds.
//   3. ELEMENT ABSORPTION: elements whose boundary is covered by L_p
//      (w == 0) are absorbed immediately.
// Deterministic: (degree, node-id) heap tie-break, sorted lists for the
// supervariable compare, members emitted in merge order.

int lsb_amd(int64_t n, const int64_t *offs, const int32_t *cols,
            int64_t *perm_out) {
  std::vector<std::vector<int32_t>> A(n), E(n), L(n), members(n);
  for (int64_t i = 0; i < n; ++i) {
    A[i].assign(cols + offs[i], cols + offs[i + 1]);
    members[i].push_back((int32_t)i);
  }
  std::vector<int64_t> nv(n, 1), deg(n), mark(n, -1), w(n, -1);
  // esize[e]: weight of L_e, maintained INCREMENTALLY (set at element
  // creation; merges move weight within the same elements, eliminations
  // absorb every containing element) — scanning L_e per pivot would
  // reintroduce the exact scheme's dominant term.
  std::vector<int64_t> esize(n, 0);
  std::vector<char> eliminated(n, 0), absorbed(n, 0), in_lp(n, 0);

  using Entry = std::pair<int64_t, int64_t>;  // (degree, node)
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
  for (int64_t i = 0; i < n; ++i) {
    deg[i] = (int64_t)A[i].size();
    heap.emplace(deg[i], i);
  }

  auto alive = [&](int32_t v) { return !eliminated[v] && nv[v] > 0; };

  int64_t stamp = 0, pos = 0;
  std::vector<int32_t> Lp, touched_w;

  while (!heap.empty()) {
    auto [d, p64] = heap.top();
    heap.pop();
    int32_t p = (int32_t)p64;
    if (eliminated[p] || nv[p] == 0 || d != deg[p]) continue;
    eliminated[p] = 1;
    for (int32_t m : members[p]) perm_out[pos++] = m;
    members[p].clear();
    members[p].shrink_to_fit();

    // Boundary L_p over live supervariables.
    ++stamp;
    mark[p] = stamp;
    Lp.clear();
    int64_t lp_weight = 0;
    for (int32_t v : A[p])
      if (alive(v) && mark[v] != stamp) {
        mark[v] = stamp;
        Lp.push_back(v);
        lp_weight += nv[v];
      }
    for (int32_t e : E[p]) {
      if (absorbed[e]) continue;
      for (int32_t v : L[e])
        if (alive(v) && mark[v] != stamp) {
          mark[v] = stamp;
          Lp.push_back(v);
          lp_weight += nv[v];
        }
      absorbed[e] = 1;
      L[e].clear();
      L[e].shrink_to_fit();
    }
    A[p].clear();
    A[p].shrink_to_fit();
    E[p].clear();
    E[p].shrink_to_fit();
    L[p] = Lp;
    esize[p] = lp_weight;

    // w pass: w[e] = |L_e \ L_p| in supervariable weight, for every
    // live element adjacent to the boundary (e ∈ E_v ⇔ v ∈ L_e).
    touched_w.clear();
    for (int32_t v : Lp)
      for (int32_t e : E[v]) {
        if (absorbed[e]) continue;
        if (w[e] < 0) {
          w[e] = esize[e];
          touched_w.push_back(e);
        }
        w[e] -= nv[v];
      }

    for (int32_t v : Lp) in_lp[v] = 1;

    // Update each boundary supervariable.
    for (int32_t v : Lp) {
      auto &av = A[v];
      std::size_t k = 0;
      for (int32_t u : av)
        if (alive(u) && !in_lp[u] && u != p) av[k++] = u;
      av.resize(k);
      auto &ev = E[v];
      k = 0;
      for (int32_t e : ev)
        if (!absorbed[e]) {
          if (w[e] == 0) {
            // Boundary covered by L_p: absorb into element p.
            absorbed[e] = 1;
            L[e].clear();
            L[e].shrink_to_fit();
          } else {
            ev[k++] = e;
          }
        }
      ev.resize(k);
      ev.push_back(p);
      // Approximate external degree (weights).
      int64_t dv = lp_weight - nv[v];
      for (int32_t u : av) dv += nv[u];
      for (int32_t e : ev)
        if (e != p && w[e] >= 0) dv += w[e];
        else if (e != p) dv += esize[e];
      if (dv > n - pos - nv[v]) dv = n - pos - nv[v];
      deg[v] = dv;
    }

    // Supervariable detection: hash boundary variables by their list
    // sums; exact compare (sorted lists) within buckets.
    if (Lp.size() > 1) {
      std::vector<std::pair<uint64_t, int32_t>> hashes;
      hashes.reserve(Lp.size());
      for (int32_t v : Lp) {
        if (!alive(v)) continue;
        uint64_t h = 1469598103934665603ull;
        for (int32_t u : A[v]) h = (h ^ (uint64_t)u) * 1099511628211ull;
        uint64_t h2 = 0;
        for (int32_t e : E[v]) h2 += (uint64_t)(e + 1) * 2654435761u;
        h = h + h2 * 31 + (uint64_t)A[v].size() * 131;
        hashes.emplace_back(h, v);
      }
      std::sort(hashes.begin(), hashes.end());
      for (std::size_t i = 0; i + 1 < hashes.size(); ++i) {
        if (hashes[i].first != hashes[i + 1].first) continue;
        int32_t v = hashes[i].second, u = hashes[i + 1].second;
        if (!alive(v) || !alive(u)) continue;
        auto sorted = [](std::vector<int32_t> x) {
          std::sort(x.begin(), x.end());
          return x;
        };
        if (sorted(A[v]) != sorted(A[u]) || sorted(E[v]) != sorted(E[u]))
          continue;
        // Merge u into v (keep the smaller id for determinism).
        if (u < v) std::swap(u, v);
        deg[v] -= nv[u];
        nv[v] += nv[u];
        nv[u] = 0;
        members[v].insert(members[v].end(), members[u].begin(),
                          members[u].end());
        members[u].clear();
        members[u].shrink_to_fit();
        A[u].clear();
        A[u].shrink_to_fit();
        E[u].clear();
        E[u].shrink_to_fit();
        hashes[i + 1].second = v;
      }
    }

    for (int32_t v : Lp) {
      in_lp[v] = 0;
      if (alive(v)) heap.emplace(deg[v], (int64_t)v);
    }
    for (int32_t e : touched_w) w[e] = -1;
  }
  return pos == n ? 0 : 1;
}

}  // extern "C"
