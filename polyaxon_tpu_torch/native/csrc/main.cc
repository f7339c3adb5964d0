// Standalone slice daemon: a line protocol over stdin/stdout so the
// reconcile loop can run out-of-process (the production shape — the
// Python agent talks to it the way upstream's agent talks to its Go
// operator, but over a pipe instead of the k8s API).
//
// Protocol (one request per line, one reply line per request):
//   ADD <name> <topology> <preemptible:0|1>
//   REQ <run_uuid> <topology> <priority> <max_restarts>   -> gang id
//   REL <gang_id>
//   HB <gang_id> <proc> <now>
//   PRE <slice>
//   INFO <gang_id>
//   TICK <now> <timeout>      -> events, terminated by "."
//   QUIT
#include <iostream>
#include <sstream>
#include <string>

#include "pool.h"

int main() {
  sliced::Pool pool;
  std::string line;
  while (std::getline(std::cin, line)) {
    std::istringstream in(line);
    std::string cmd;
    in >> cmd;
    if (cmd == "QUIT") break;
    if (cmd == "ADD") {
      std::string name, topo;
      int preemptible = 0;
      in >> name >> topo >> preemptible;
      std::cout << (pool.AddSlice(name, topo, preemptible != 0) ? "ok" : "err")
                << "\n";
    } else if (cmd == "REQ") {
      std::string uuid, topo;
      int priority = 0, max_restarts = 0;
      in >> uuid >> topo >> priority >> max_restarts;
      std::cout << pool.RequestGang(uuid, topo, priority, max_restarts) << "\n";
    } else if (cmd == "REL") {
      long long id = 0;
      in >> id;
      std::cout << (pool.ReleaseGang(id) ? "ok" : "err") << "\n";
    } else if (cmd == "HB") {
      long long id = 0;
      int proc = 0;
      double now = 0;
      in >> id >> proc >> now;
      std::cout << (pool.Heartbeat(id, proc, now) ? "ok" : "err") << "\n";
    } else if (cmd == "PRE") {
      std::string name;
      in >> name;
      std::cout << pool.PreemptSlice(name) << "\n";
    } else if (cmd == "INFO") {
      long long id = 0;
      in >> id;
      const sliced::Gang* gang = pool.GetGang(id);
      if (gang == nullptr) {
        std::cout << "err\n";
      } else {
        std::cout << GangStateName(gang->state) << " "
                  << (gang->placement.slice.empty() ? "-"
                                                    : gang->placement.slice)
                  << " restarts=" << gang->restarts << "\n";
      }
    } else if (cmd == "TICK") {
      double now = 0, timeout = 30;
      in >> now >> timeout;
      pool.Tick(now, timeout);
      for (const auto& event : pool.DrainEvents())
        std::cout << event.gang_id << " " << event.kind << " " << event.detail
                  << "\n";
      std::cout << ".\n";
    } else {
      std::cout << "err unknown\n";
    }
    std::cout.flush();
  }
  return 0;
}
