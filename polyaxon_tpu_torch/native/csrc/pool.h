// Slice pool: inventory, gang placement, liveness, preemption, restarts.
//
// The reconcile brain of the native daemon. Pure standard C++17, no
// external deps — the C ABI wrapper (capi.cc) and the standalone daemon
// (main.cc) are thin shells over this.
//
// Semantics (gang scheduling and failure detection):
//  - A gang is placed atomically on one slice: every requested chip is
//    ICI-contiguous (sub-torus with wraparound) or the request waits.
//  - Placement prefers aligned offsets (multiples of the request shape)
//    to limit fragmentation, then lower linear offset for determinism.
//  - Priority scheduling: a request may evict lower-priority gangs on
//    preemptible slices when no free placement exists.
//  - Liveness = per-process heartbeats; a stale gang follows its restart
//    policy (restart in place up to max_restarts, then fail).
#pragma once

#include <cstdint>
#include <map>
#include <optional>
#include <string>
#include <vector>

#include "topology.h"

namespace sliced {

enum class GangState { kPending, kRunning, kRestarting, kFailed, kPreempted, kReleased };

const char* GangStateName(GangState s);

struct Slice {
  std::string name;
  Topology topology;
  bool preemptible = false;
  std::vector<int64_t> owner;  // chip index -> gang id (-1 free)
};

struct Placement {
  std::string slice;
  std::array<int, kMaxDims> offset{0, 0, 0};
  std::array<int, kMaxDims> shape{1, 1, 1};  // permuted onto slice dims
  std::vector<int> chips;                    // linear chip indices in slice
};

struct Gang {
  int64_t id = 0;
  std::string run_uuid;
  Topology requested;
  int priority = 0;
  int max_restarts = 0;
  int restarts = 0;
  GangState state = GangState::kPending;
  Placement placement;
  std::map<int, double> heartbeats;  // proc id -> last-seen seconds
  std::string note;
};

struct Event {
  int64_t gang_id;
  std::string kind;  // PLACED | LOST | RESTART | FAILED | PREEMPTED
  std::string detail;
};

class Pool {
 public:
  // Inventory ---------------------------------------------------------
  bool AddSlice(const std::string& name, const std::string& topology,
                bool preemptible);
  bool RemoveSlice(const std::string& name);  // evicts resident gangs
  int FreeChips(const std::string& name) const;
  std::vector<std::string> SliceNames() const;

  // Gangs -------------------------------------------------------------
  // Returns gang id (>0). The gang is placed immediately when capacity
  // exists (state kRunning + PLACED event); otherwise it stays kPending
  // and is retried on every Tick. Returns -1 on malformed topology,
  // -2 when the request can never fit any registered slice.
  int64_t RequestGang(const std::string& run_uuid, const std::string& topology,
                      int priority, int max_restarts);
  bool ReleaseGang(int64_t id);
  const Gang* GetGang(int64_t id) const;

  // Signals -----------------------------------------------------------
  bool Heartbeat(int64_t id, int proc, double now);
  // Slice-level eviction (host maintenance event / spot reclaim).
  int PreemptSlice(const std::string& name);

  // Reconcile ---------------------------------------------------------
  // Advances every state machine: stale-heartbeat detection (gangs with
  // at least one heartbeat older than timeout), restart accounting,
  // pending placement retries (priority order, may evict lower-priority
  // gangs from preemptible slices). Appends events.
  void Tick(double now, double heartbeat_timeout);

  std::vector<Event> DrainEvents();
  // Non-destructive access: callers that must serialize into a bounded
  // buffer peek first and clear only after the write succeeded.
  const std::vector<Event>& PendingEvents() const { return events_; }
  void ClearEvents() { events_.clear(); }

 private:
  std::optional<Placement> FindPlacement(const Topology& want) const;
  std::optional<Placement> FindPlacementOn(const Slice& slice,
                                           const Topology& want) const;
  bool CanEverFit(const Topology& want) const;
  void Occupy(const Placement& p, int64_t gang_id);
  void Vacate(const Placement& p);
  void TryPlacePending(double now);
  bool TryEvictFor(const Gang& want);

  std::map<std::string, Slice> slices_;
  std::map<int64_t, Gang> gangs_;
  std::vector<Event> events_;
  int64_t next_id_ = 1;
};

}  // namespace sliced
