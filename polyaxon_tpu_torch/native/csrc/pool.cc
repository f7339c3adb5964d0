#include "pool.h"

#include <algorithm>

namespace sliced {

const char* GangStateName(GangState s) {
  switch (s) {
    case GangState::kPending: return "pending";
    case GangState::kRunning: return "running";
    case GangState::kRestarting: return "restarting";
    case GangState::kFailed: return "failed";
    case GangState::kPreempted: return "preempted";
    case GangState::kReleased: return "released";
  }
  return "unknown";
}

// ---------------------------------------------------------------- inventory
bool Pool::AddSlice(const std::string& name, const std::string& topology,
                    bool preemptible) {
  if (slices_.count(name)) return false;
  Slice slice;
  slice.name = name;
  slice.preemptible = preemptible;
  if (!ParseTopology(topology, &slice.topology)) return false;
  slice.owner.assign(slice.topology.chips(), -1);
  slices_[name] = std::move(slice);
  return true;
}

bool Pool::RemoveSlice(const std::string& name) {
  auto it = slices_.find(name);
  if (it == slices_.end()) return false;
  PreemptSlice(name);
  slices_.erase(it);
  return true;
}

int Pool::FreeChips(const std::string& name) const {
  auto it = slices_.find(name);
  if (it == slices_.end()) return -1;
  int free = 0;
  for (int64_t owner : it->second.owner) free += owner < 0 ? 1 : 0;
  return free;
}

std::vector<std::string> Pool::SliceNames() const {
  std::vector<std::string> names;
  for (const auto& [name, _] : slices_) names.push_back(name);
  return names;
}

// -------------------------------------------------------------- placement
namespace {

// All distinct orderings of `want` padded with 1s onto `ndims` axes.
std::vector<std::array<int, kMaxDims>> ShapePermutations(const Topology& want,
                                                         int ndims) {
  std::array<int, kMaxDims> base{1, 1, 1};
  for (int i = 0; i < want.ndims; ++i) base[i] = want.dims[i];
  std::sort(base.begin(), base.begin() + ndims);
  std::vector<std::array<int, kMaxDims>> perms;
  do {
    perms.push_back(base);
  } while (std::next_permutation(base.begin(), base.begin() + ndims));
  return perms;
}

}  // namespace

std::optional<Placement> Pool::FindPlacementOn(const Slice& slice,
                                               const Topology& want) const {
  if (want.chips() > slice.topology.chips()) return std::nullopt;
  // A request with more (non-trivial) dims than the slice torus cannot
  // be ICI-contiguous there; silently dropping axes would under-allocate.
  for (int d = slice.topology.ndims; d < want.ndims; ++d)
    if (want.dims[d] > 1) return std::nullopt;
  const Topology& topo = slice.topology;
  std::optional<Placement> best;
  int best_score = -1;
  int best_linear = 0;

  for (const auto& shape : ShapePermutations(want, topo.ndims)) {
    bool fits = true;
    for (int d = 0; d < topo.ndims; ++d) fits &= shape[d] <= topo.dims[d];
    if (!fits) continue;

    std::array<int, kMaxDims> offset{0, 0, 0};
    // Enumerate all offsets (wraparound keeps a sub-torus ICI-contiguous).
    auto advance = [&]() {
      for (int d = topo.ndims - 1; d >= 0; --d) {
        if (++offset[d] < topo.dims[d]) return true;
        offset[d] = 0;
      }
      return false;
    };
    do {
      // A full-ring dim only tiles once: skip duplicate rotations.
      bool redundant = false;
      for (int d = 0; d < topo.ndims; ++d)
        redundant |= shape[d] == topo.dims[d] && offset[d] != 0;
      if (redundant) continue;

      std::vector<int> chips;
      chips.reserve(want.chips());
      bool free = true;
      std::array<int, kMaxDims> rel{0, 0, 0};
      auto advance_rel = [&]() {
        for (int d = topo.ndims - 1; d >= 0; --d) {
          if (++rel[d] < shape[d]) return true;
          rel[d] = 0;
        }
        return false;
      };
      do {
        std::array<int, kMaxDims> coord{0, 0, 0};
        for (int d = 0; d < topo.ndims; ++d)
          coord[d] = (offset[d] + rel[d]) % topo.dims[d];
        int idx = CoordToIndex(topo, coord);
        if (slice.owner[idx] >= 0) {
          free = false;
          break;
        }
        chips.push_back(idx);
      } while (advance_rel());
      if (!free) continue;

      int score = 0;  // prefer shape-aligned offsets: less fragmentation
      for (int d = 0; d < topo.ndims; ++d)
        score += offset[d] % shape[d] == 0 ? 1 : 0;
      int linear = CoordToIndex(topo, offset);
      if (score > best_score || (score == best_score && linear < best_linear)) {
        Placement p;
        p.slice = slice.name;
        p.offset = offset;
        p.shape = shape;
        std::sort(chips.begin(), chips.end());
        p.chips = std::move(chips);
        best = std::move(p);
        best_score = score;
        best_linear = linear;
      }
    } while (advance());
  }
  return best;
}

std::optional<Placement> Pool::FindPlacement(const Topology& want) const {
  // Deterministic order; prefer the tightest fit (least leftover chips)
  // so small gangs don't fragment big slices.
  std::vector<const Slice*> order;
  for (const auto& [_, slice] : slices_) order.push_back(&slice);
  std::sort(order.begin(), order.end(), [](const Slice* a, const Slice* b) {
    if (a->topology.chips() != b->topology.chips())
      return a->topology.chips() < b->topology.chips();
    return a->name < b->name;
  });
  for (const Slice* slice : order) {
    auto p = FindPlacementOn(*slice, want);
    if (p) return p;
  }
  return std::nullopt;
}

bool Pool::CanEverFit(const Topology& want) const {
  for (const auto& [_, slice] : slices_) {
    Slice empty = slice;
    std::fill(empty.owner.begin(), empty.owner.end(), -1);
    if (FindPlacementOn(empty, want)) return true;
  }
  return false;
}

void Pool::Occupy(const Placement& p, int64_t gang_id) {
  Slice& slice = slices_.at(p.slice);
  for (int chip : p.chips) slice.owner[chip] = gang_id;
}

void Pool::Vacate(const Placement& p) {
  auto it = slices_.find(p.slice);
  if (it == slices_.end()) return;
  for (int chip : p.chips) it->second.owner[chip] = -1;
}

// ------------------------------------------------------------------ gangs
int64_t Pool::RequestGang(const std::string& run_uuid,
                          const std::string& topology, int priority,
                          int max_restarts) {
  Topology want;
  if (!ParseTopology(topology, &want)) return -1;
  if (!CanEverFit(want)) return -2;
  Gang gang;
  const int64_t id = next_id_++;
  gang.id = id;
  gang.run_uuid = run_uuid;
  gang.requested = want;
  gang.priority = priority;
  gang.max_restarts = max_restarts;
  gangs_[id] = std::move(gang);
  TryPlacePending(0.0);
  return id;
}

bool Pool::ReleaseGang(int64_t id) {
  auto it = gangs_.find(id);
  if (it == gangs_.end()) return false;
  Gang& gang = it->second;
  if (gang.state == GangState::kRunning || gang.state == GangState::kRestarting)
    Vacate(gang.placement);
  gangs_.erase(it);  // a long-lived agent must not accumulate dead gangs
  TryPlacePending(0.0);
  return true;
}

const Gang* Pool::GetGang(int64_t id) const {
  auto it = gangs_.find(id);
  return it == gangs_.end() ? nullptr : &it->second;
}

// ---------------------------------------------------------------- signals
bool Pool::Heartbeat(int64_t id, int proc, double now) {
  auto it = gangs_.find(id);
  if (it == gangs_.end()) return false;
  Gang& gang = it->second;
  if (gang.state != GangState::kRunning && gang.state != GangState::kRestarting)
    return false;
  gang.heartbeats[proc] = now;
  if (gang.state == GangState::kRestarting) gang.state = GangState::kRunning;
  return true;
}

int Pool::PreemptSlice(const std::string& name) {
  auto it = slices_.find(name);
  if (it == slices_.end()) return -1;
  int evicted = 0;
  for (auto& [id, gang] : gangs_) {
    if ((gang.state == GangState::kRunning ||
         gang.state == GangState::kRestarting) &&
        gang.placement.slice == name) {
      Vacate(gang.placement);
      gang.state = GangState::kPreempted;
      gang.heartbeats.clear();
      events_.push_back({id, "PREEMPTED", "slice " + name + " evicted"});
      ++evicted;
    }
  }
  return evicted;
}

// -------------------------------------------------------------- reconcile
bool Pool::TryEvictFor(const Gang& want) {
  // Cheapest eviction: the preemptible slice where removing the fewest
  // strictly-lower-priority gangs frees a placement.
  std::string best_slice;
  std::vector<int64_t> best_victims;
  std::optional<Placement> best_placement;

  for (const auto& [name, slice] : slices_) {
    if (!slice.preemptible) continue;
    std::vector<int64_t> victims;
    for (const auto& [id, gang] : gangs_) {
      if ((gang.state == GangState::kRunning ||
           gang.state == GangState::kRestarting) &&
          gang.placement.slice == name && gang.priority < want.priority)
        victims.push_back(id);
    }
    if (victims.empty()) continue;
    Slice trial = slice;
    for (int64_t v : victims)
      for (int chip : gangs_.at(v).placement.chips) trial.owner[chip] = -1;
    auto p = FindPlacementOn(trial, want.requested);
    if (!p) continue;
    // Minimal victim set: only gangs whose chips the placement actually
    // needs are evicted (greedy — a different offset might overlap even
    // fewer, but never evict a gang the chosen placement doesn't touch).
    std::vector<int64_t> needed;
    for (int64_t v : victims) {
      const auto& chips = gangs_.at(v).placement.chips;
      bool overlaps = false;
      for (int chip : p->chips)
        overlaps |= std::find(chips.begin(), chips.end(), chip) != chips.end();
      if (overlaps) needed.push_back(v);
    }
    if (best_slice.empty() || needed.size() < best_victims.size()) {
      best_slice = name;
      best_victims = needed;
      best_placement = p;
    }
  }
  if (!best_placement) return false;
  for (int64_t v : best_victims) {
    Gang& victim = gangs_.at(v);
    Vacate(victim.placement);
    victim.state = GangState::kPreempted;
    victim.heartbeats.clear();
    events_.push_back(
        {v, "PREEMPTED", "evicted for higher-priority gang " +
                             std::to_string(want.id)});
  }
  return true;
}

void Pool::TryPlacePending(double now) {
  (void)now;
  std::vector<Gang*> pending;
  for (auto& [_, gang] : gangs_)
    if (gang.state == GangState::kPending) pending.push_back(&gang);
  std::sort(pending.begin(), pending.end(), [](const Gang* a, const Gang* b) {
    if (a->priority != b->priority) return a->priority > b->priority;
    return a->id < b->id;
  });
  for (Gang* gang : pending) {
    auto p = FindPlacement(gang->requested);
    if (!p && TryEvictFor(*gang)) p = FindPlacement(gang->requested);
    if (!p) continue;
    gang->placement = *p;
    gang->state = GangState::kRunning;
    Occupy(*p, gang->id);
    events_.push_back({gang->id, "PLACED",
                       p->slice + " offset " +
                           std::to_string(CoordToIndex(
                               slices_.at(p->slice).topology, p->offset))});
  }
}

void Pool::Tick(double now, double heartbeat_timeout) {
  for (auto& [id, gang] : gangs_) {
    if (gang.state != GangState::kRunning || gang.heartbeats.empty()) continue;
    double oldest = now;
    for (const auto& [_, ts] : gang.heartbeats) oldest = std::min(oldest, ts);
    if (now - oldest <= heartbeat_timeout) continue;
    events_.push_back({id, "LOST", "heartbeat stale"});
    if (gang.restarts < gang.max_restarts) {
      ++gang.restarts;
      gang.state = GangState::kRestarting;  // chips stay reserved
      gang.heartbeats.clear();
      events_.push_back({id, "RESTART",
                         "attempt " + std::to_string(gang.restarts) + "/" +
                             std::to_string(gang.max_restarts)});
    } else {
      gang.state = GangState::kFailed;
      Vacate(gang.placement);
      events_.push_back({id, "FAILED", "restarts exhausted"});
    }
  }
  TryPlacePending(now);
}

std::vector<Event> Pool::DrainEvents() {
  std::vector<Event> out;
  out.swap(events_);
  return out;
}

}  // namespace sliced
