// Copied from native/planner.cpp (the exact greedy core of the native
// backend, loaded by blance_tpu_torch/plan/native.py).
// Native exact greedy planner — the hot loop of the "greedy" backend in C++.
//
// Replicates blance_tpu/plan/greedy.py's inner pass (itself a faithful
// reimplementation of the reference's planNextMapInnerEx,
// the Go reference's plan.go:60-331) over dense ids, so results are
// bit-identical to the Python planner: same double-precision score
// arithmetic in the same order, same (score, node-position) ordering, same
// hierarchy include/exclude semantics, same warning conditions.
//
// The Python side (blance_tpu/plan/native.py) interns names, computes the
// per-state partition orderings (the partitionSorter, which is string-key
// based), seeds the state-node counts, and decodes results; this file owns
// the O(states * partitions * nodes) scoring loop.
//
// Build: g++ -O3 -shared -fPIC -o _native_planner.so planner.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Ctx {
  int32_t P, N, S, R;
  int32_t num_partitions;          // len(prev_map), the score normalizer
  const int32_t* constraints;     // [S]
  const int32_t* state_priority;  // [S]
  const double* pweights;         // [P]
  const double* nweights;         // [N]  (default 1.0)
  const uint8_t* nweight_set;     // [N]  1 iff the caller specified a weight
  const uint8_t* valid;           // [N]  0 for removed nodes
  const double* stickiness;       // [P*S]
  // Hierarchy: globally interned ancestor ids per level; -1 = missing.
  int32_t levels;                 // number of levels incl. level 0
  const int32_t* aid;             // [levels*N]
  const uint8_t* is_leaf;         // [N] 0 iff the node has hierarchy children
  // Rules per state: offsets into (inc, exc) pair array.
  const int32_t* rule_off;        // [S+1]
  const int32_t* rule_inc;        // [total_rules]
  const int32_t* rule_exc;        // [total_rules]
  uint8_t use_booster;            // cbgt booster: max(-w, stickiness)
  uint8_t has_hierarchy;          // hierarchy_rules option was non-null

  // Partition ordering inputs (the partitionSorter, plan.go:519-562).
  // static_rank: rank by (weight key, name key, name) — a static total
  // order.  cat0[s*P+p]: prev holders of state s sit on removed nodes.
  // The category-1 test (not yet on any added node) depends on the
  // partition's CURRENT assignment, so visit order is recomputed per state.
  const int32_t* static_rank;     // [P]
  const uint8_t* cat0;            // [S*P]
  const uint8_t* add_mask;        // [N]
  uint8_t has_adds;               // nodes_to_add was non-nil

  int32_t* assign;                // [P*S*R] in/out, -1 padded
  double* counts;                 // [S*N] state-node counts (seeded)
  int32_t* shortfall;             // [P*S] out: missing copies per (p,s)
};

struct NodeScore {
  double score;
  int32_t node;  // == position tie-break (ids are nodes_all order)
};

inline bool score_less(const NodeScore& a, const NodeScore& b) {
  if (a.score < b.score) return true;
  if (a.score > b.score) return false;
  return a.node < b.node;
}

// Is candidate c inside anchor a's level-`inc` subtree?  True iff some
// ancestor of c equals a's inc-level ancestor (handles non-uniform depth).
inline bool under(const Ctx& c, int32_t cand, int32_t anc_id) {
  if (anc_id < 0) return false;
  for (int32_t l = 0; l < c.levels; ++l) {
    if (c.aid[l * c.N + cand] == anc_id) return true;
  }
  return false;
}

class Planner {
 public:
  explicit Planner(const Ctx& c) : c_(c) {
    node_partition_counts_.assign(c_.N, 0.0);
    for (int32_t s = 0; s < c_.S; ++s)
      for (int32_t n = 0; n < c_.N; ++n)
        node_partition_counts_[n] += c_.counts[s * c_.N + n];
    held_.assign(c_.N, 0);
    in_flat_.assign(c_.N, 0);
  }

  void run() {
    for (int32_t s = 0; s < c_.S; ++s) {
      if (c_.constraints[s] <= 0) continue;
      assign_state(s);
    }
  }

 private:
  const Ctx& c_;
  std::vector<double> node_partition_counts_;  // maintained incrementally
  // node -> (top-priority-node -> count); reset per state.
  std::unordered_map<int64_t, double> node_to_node_;
  std::vector<uint8_t> held_;   // scratch: nodes of this partition, state s
  std::vector<uint8_t> in_flat_;

  inline double& count_ref(int32_t s, int32_t n) {
    return c_.counts[s * c_.N + n];
  }

  void adjust(int32_t s, int32_t node, double amt) {
    count_ref(s, node) += amt;
    node_partition_counts_[node] += amt;
  }

  // The node score formula (greedy.py default_node_score, plan.go:634-689).
  double score_node(int32_t node, int32_t p, int32_t s, int32_t top_node,
                    double stick) const {
    double lower = 0.0;
    if (c_.num_partitions > 0 && top_node >= -1) {
      auto it = node_to_node_.find(key(top_node, node));
      if (it != node_to_node_.end())
        lower = it->second / static_cast<double>(c_.num_partitions);
    }
    double filled = 0.0;
    if (c_.num_partitions > 0) {
      filled = (0.001 * node_partition_counts_[node]) /
               static_cast<double>(c_.num_partitions);
    }
    double current = 0.0;
    const int32_t* row = &c_.assign[(static_cast<int64_t>(p) * c_.S + s) * c_.R];
    for (int32_t r = 0; r < c_.R; ++r)
      if (row[r] == node) current = stick;

    double v = c_.counts[s * c_.N + node];
    v += lower;
    v += filled;
    if (c_.nweight_set[node]) {
      double w = c_.nweights[node];
      if (w > 0) {
        v /= w;
      } else if (w < 0 && c_.use_booster) {
        double boost = -w;
        if (boost < current) boost = current;  // cbgt: max(-w, stickiness)
        v += boost;
      }
    }
    return v - current;
  }

  static inline int64_t key(int32_t a, int32_t b) {
    return (static_cast<int64_t>(a + 1) << 32) | static_cast<uint32_t>(b);
  }

  // Visit order for one state: ORDER BY category (0: on removed nodes,
  // 1: not yet on any added node, 2: rest), then the static rank.
  std::vector<int32_t> state_order(int32_t s) const {
    std::vector<int64_t> keys(c_.P);
    for (int32_t p = 0; p < c_.P; ++p) {
      int32_t cat = 2;
      if (c_.cat0[s * c_.P + p]) {
        cat = 0;
      } else if (c_.has_adds) {
        bool on_added = false;
        const int32_t* prow =
            &c_.assign[static_cast<int64_t>(p) * c_.S * c_.R];
        for (int32_t i = 0; i < c_.S * c_.R && !on_added; ++i)
          if (prow[i] >= 0 && c_.add_mask[prow[i]]) on_added = true;
        if (!on_added) cat = 1;
      }
      keys[p] = (static_cast<int64_t>(cat) << 40) | c_.static_rank[p];
    }
    std::vector<int32_t> order(c_.P);
    for (int32_t p = 0; p < c_.P; ++p) order[p] = p;
    std::sort(order.begin(), order.end(),
              [&](int32_t a, int32_t b) { return keys[a] < keys[b]; });
    return order;
  }

  void assign_state(int32_t s) {
    node_to_node_.clear();
    const int32_t k = c_.constraints[s];
    const int32_t prio = c_.state_priority[s];
    std::vector<NodeScore> flat;
    std::vector<int32_t> picks;
    flat.reserve(c_.N);
    const std::vector<int32_t> order = state_order(s);

    for (int32_t oi = 0; oi < c_.P; ++oi) {
      const int32_t p = order[oi];
      const double pw = c_.pweights[p];
      int32_t* prow =
          &c_.assign[static_cast<int64_t>(p) * c_.S * c_.R];

      // Top-priority node: first entry of state index 0 (states arrive
      // priority-then-name sorted, matching _top_priority_state_name).
      int32_t top_node = prow[0] >= 0 ? prow[0] : -1;
      const double stick = c_.stickiness[p * c_.S + s];

      // Mark nodes holding an equal-or... strictly higher-priority state
      // of this partition (excludeHigherPriorityNodes, plan.go:146-156).
      std::fill(held_.begin(), held_.end(), 0);
      for (int32_t sj = 0; sj < c_.S; ++sj) {
        if (c_.state_priority[sj] >= prio) continue;
        const int32_t* r2 = &prow[sj * c_.R];
        for (int32_t r = 0; r < c_.R; ++r)
          if (r2[r] >= 0) held_[r2[r]] = 1;
      }

      // Flat candidates: valid nodes minus higher-priority holders, fully
      // ordered by (score, position).
      flat.clear();
      for (int32_t n = 0; n < c_.N; ++n) {
        if (!c_.valid[n] || held_[n]) continue;
        flat.push_back({score_node(n, p, s, top_node, stick), n});
      }
      std::sort(flat.begin(), flat.end(), score_less);

      picks.clear();
      if (c_.has_hierarchy) {
        hierarchy_pass(s, p, k, top_node, stick, flat, &picks);
      }

      // dedupe(picks + flat), truncate to k (plan.go:224-235).
      std::fill(in_flat_.begin(), in_flat_.end(), 0);
      std::vector<int32_t> chosen;
      chosen.reserve(k);
      for (int32_t n : picks) {
        if (!in_flat_[n]) {
          in_flat_[n] = 1;
          if (static_cast<int32_t>(chosen.size()) < k) chosen.push_back(n);
        }
      }
      for (const auto& ns : flat) {
        if (static_cast<int32_t>(chosen.size()) >= k) break;
        if (!in_flat_[ns.node]) {
          in_flat_[ns.node] = 1;
          chosen.push_back(ns.node);
        }
      }
      if (static_cast<int32_t>(chosen.size()) < k)
        c_.shortfall[p * c_.S + s] = k - static_cast<int32_t>(chosen.size());

      // Keep nodeToNodeCounts updated (plan.go:238-245).
      for (int32_t n : chosen) node_to_node_[key(top_node, n)] += 1.0;

      // Uninstall the state's old holders and the newly chosen nodes from
      // every state, adjusting counts (plan.go:290-301).
      remove_from_all_states(p, &prow[s * c_.R], c_.R, pw);
      for (int32_t n : chosen) remove_node_from_all_states(p, n, pw);

      int32_t* srow = &prow[s * c_.R];
      for (int32_t r = 0; r < c_.R; ++r)
        srow[r] = r < static_cast<int32_t>(chosen.size()) ? chosen[r] : -1;
      for (int32_t n : chosen) adjust(s, n, pw);
    }
  }

  // Remove every node currently listed in `nodes` (a state row snapshot)
  // from all states of partition p, decrementing counts for the ones
  // actually present.
  void remove_from_all_states(int32_t p, const int32_t* nodes, int32_t count,
                              double pw) {
    // Snapshot first: the row is about to be mutated.
    int32_t snap[64];
    std::vector<int32_t> heap_snap;
    const int32_t* src = nodes;
    if (count <= 64) {
      std::memcpy(snap, nodes, count * sizeof(int32_t));
      src = snap;
    } else {
      heap_snap.assign(nodes, nodes + count);
      src = heap_snap.data();
    }
    for (int32_t i = 0; i < count; ++i)
      if (src[i] >= 0) remove_node_from_all_states(p, src[i], pw);
  }

  void remove_node_from_all_states(int32_t p, int32_t node, double pw) {
    int32_t* prow = &c_.assign[static_cast<int64_t>(p) * c_.S * c_.R];
    for (int32_t sj = 0; sj < c_.S; ++sj) {
      int32_t* row = &prow[sj * c_.R];
      int32_t w = 0;
      bool removed = false;
      for (int32_t r = 0; r < c_.R; ++r) {
        if (row[r] == node) {
          adjust(sj, node, -pw);
          removed = true;
        } else if (row[r] >= 0) {
          row[w++] = row[r];
        }
      }
      if (removed || w < c_.R) {
        for (int32_t r = w; r < c_.R; ++r) row[r] = -1;
      }
    }
  }

  // The hierarchy pass (plan.go:174-226): per rule, pick k nodes anchored
  // on the primary + picks so far, intersecting include/exclude subtrees.
  void hierarchy_pass(int32_t s, int32_t p, int32_t k, int32_t top_node,
                      double stick, const std::vector<NodeScore>& flat,
                      std::vector<int32_t>* picks) {
    std::vector<NodeScore> hcand;
    const int32_t rb = c_.rule_off[s], re = c_.rule_off[s + 1];
    for (int32_t ri = rb; ri < re; ++ri) {
      const int32_t inc = c_.rule_inc[ri], exc = c_.rule_exc[ri];
      int32_t anchor0 = top_node;
      if (anchor0 < 0 && !picks->empty()) anchor0 = (*picks)[0];
      for (int32_t i = 0; i < k; ++i) {
        hcand.clear();
        const int32_t prio = c_.state_priority[s];
        for (int32_t n = 0; n < c_.N; ++n) {
          if (!c_.valid[n]) continue;
          if (!member(n, anchor0, inc, exc)) continue;
          bool ok = true;
          for (int32_t a : *picks)
            if (!member(n, a, inc, exc)) { ok = false; break; }
          if (!ok) continue;
          // Exclude higher-priority holders.
          bool held = false;
          const int32_t* prow =
              &c_.assign[static_cast<int64_t>(p) * c_.S * c_.R];
          for (int32_t sj = 0; sj < c_.S && !held; ++sj) {
            if (c_.state_priority[sj] >= prio) continue;
            const int32_t* r2 = &prow[sj * c_.R];
            for (int32_t r = 0; r < c_.R; ++r)
              if (r2[r] == n) { held = true; break; }
          }
          if (held) continue;
          hcand.push_back({score_node(n, p, s, top_node, stick), n});
        }
        if (!hcand.empty()) {
          picks->push_back(
              std::min_element(hcand.begin(), hcand.end(), score_less)->node);
        } else if (!flat.empty()) {
          picks->push_back(flat[0].node);
        }
      }
    }
  }

  // Candidate n in include_exclude_nodes(anchor) per api.go:76-105: inside
  // the anchor's inc-level subtree but outside its exc-level subtree.
  // find_leaves (plan.go:764-774) yields leaves only, so interior nodes of
  // the hierarchy never qualify.
  bool member(int32_t n, int32_t anchor, int32_t inc, int32_t exc) const {
    if (anchor < 0 || !c_.is_leaf[n]) return false;
    const int32_t inc_id =
        inc < c_.levels ? c_.aid[inc * c_.N + anchor] : -1;
    const int32_t exc_id =
        exc < c_.levels ? c_.aid[exc * c_.N + anchor] : -1;
    if (!under(c_, n, inc_id)) return false;
    if (exc_id >= 0 && under(c_, n, exc_id)) return false;
    return true;
  }
};

}  // namespace

extern "C" {

void blance_plan_inner(
    int32_t P, int32_t N, int32_t S, int32_t R, int32_t num_partitions,
    const int32_t* constraints, const int32_t* state_priority,
    const double* pweights, const double* nweights,
    const uint8_t* nweight_set, const uint8_t* valid,
    const double* stickiness, int32_t levels, const int32_t* aid,
    const uint8_t* is_leaf, const int32_t* rule_off, const int32_t* rule_inc,
    const int32_t* rule_exc, uint8_t use_booster, uint8_t has_hierarchy,
    const int32_t* static_rank, const uint8_t* cat0, const uint8_t* add_mask,
    uint8_t has_adds, int32_t* assign, double* counts, int32_t* shortfall) {
  Ctx c{P, N, S, R, num_partitions, constraints, state_priority,
        pweights, nweights, nweight_set, valid, stickiness, levels, aid,
        is_leaf, rule_off, rule_inc, rule_exc, use_booster, has_hierarchy,
        static_rank, cat0, add_mask, has_adds, assign, counts, shortfall};
  Planner planner(c);
  planner.run();
}

}  // extern "C"
