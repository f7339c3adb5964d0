// C ABI over the slice pool, consumed from Python via ctypes
// (polyaxon_tpu_torch/native/sliced.py). String results are written into
// caller-provided buffers as `key=value;` / line records — no JSON
// dependency on either side of the boundary.
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

#include "pool.h"

using sliced::Gang;
using sliced::GangStateName;
using sliced::Pool;

namespace {

struct Handle {
  Pool pool;
  std::mutex mu;  // the Python agent may poll from multiple threads
};

int WriteOut(const std::string& text, char* buf, int len) {
  if (buf == nullptr || len <= 0) return -1;
  if (static_cast<int>(text.size()) + 1 > len) return -1;
  std::memcpy(buf, text.c_str(), text.size() + 1);
  return static_cast<int>(text.size());
}

}  // namespace

extern "C" {

void* sliced_new() { return new Handle(); }

void sliced_free(void* h) { delete static_cast<Handle*>(h); }

int sliced_add_slice(void* h, const char* name, const char* topology,
                     int preemptible) {
  Handle* handle = static_cast<Handle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  return handle->pool.AddSlice(name, topology, preemptible != 0) ? 0 : -1;
}

int sliced_remove_slice(void* h, const char* name) {
  Handle* handle = static_cast<Handle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  return handle->pool.RemoveSlice(name) ? 0 : -1;
}

int sliced_free_chips(void* h, const char* name) {
  Handle* handle = static_cast<Handle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  return handle->pool.FreeChips(name);
}

long long sliced_request_gang(void* h, const char* run_uuid,
                              const char* topology, int priority,
                              int max_restarts) {
  Handle* handle = static_cast<Handle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  return handle->pool.RequestGang(run_uuid, topology, priority, max_restarts);
}

int sliced_release_gang(void* h, long long gang_id) {
  Handle* handle = static_cast<Handle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  return handle->pool.ReleaseGang(gang_id) ? 0 : -1;
}

// gang info as `state=running;slice=a;topology=2x2;offset=0,0,0;
// shape=1,2,2;chips=0,1,8,9;restarts=0;run=uuid`
int sliced_gang_info(void* h, long long gang_id, char* buf, int len) {
  Handle* handle = static_cast<Handle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  const Gang* gang = handle->pool.GetGang(gang_id);
  if (gang == nullptr) return -1;
  std::string out = "state=";
  out += GangStateName(gang->state);
  out += ";slice=" + gang->placement.slice;
  out += ";topology=" + gang->requested.str();
  out += ";offset=";
  for (int d = 0; d < sliced::kMaxDims; ++d) {
    if (d) out += ',';
    out += std::to_string(gang->placement.offset[d]);
  }
  out += ";shape=";
  for (int d = 0; d < sliced::kMaxDims; ++d) {
    if (d) out += ',';
    out += std::to_string(gang->placement.shape[d]);
  }
  out += ";chips=";
  for (size_t i = 0; i < gang->placement.chips.size(); ++i) {
    if (i) out += ',';
    out += std::to_string(gang->placement.chips[i]);
  }
  out += ";restarts=" + std::to_string(gang->restarts);
  out += ";run=" + gang->run_uuid;
  return WriteOut(out, buf, len);
}

int sliced_heartbeat(void* h, long long gang_id, int proc, double now) {
  Handle* handle = static_cast<Handle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  return handle->pool.Heartbeat(gang_id, proc, now) ? 0 : -1;
}

int sliced_preempt_slice(void* h, const char* name) {
  Handle* handle = static_cast<Handle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  return handle->pool.PreemptSlice(name);
}

// Reconcile + drain events; one `gang_id KIND detail` record per line.
// On buffer overflow returns -1 and KEEPS the events queued, so the
// caller can retry with a bigger buffer without losing signals.
int sliced_tick(void* h, double now, double heartbeat_timeout, char* buf,
                int len) {
  Handle* handle = static_cast<Handle*>(h);
  std::lock_guard<std::mutex> lock(handle->mu);
  handle->pool.Tick(now, heartbeat_timeout);
  std::string out;
  for (const auto& event : handle->pool.PendingEvents()) {
    out += std::to_string(event.gang_id) + " " + event.kind + " " +
           event.detail + "\n";
  }
  int written = WriteOut(out, buf, len);
  if (written >= 0) handle->pool.ClearEvents();
  return written;
}

}  // extern "C"
