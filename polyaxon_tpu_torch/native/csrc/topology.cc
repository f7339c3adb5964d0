#include "topology.h"

#include <cstdlib>

namespace sliced {

bool ParseTopology(const std::string& text, Topology* out) {
  *out = Topology{};
  if (text.empty()) return false;
  size_t pos = 0;
  while (pos < text.size()) {
    if (out->ndims >= kMaxDims) return false;
    size_t next = text.find('x', pos);
    std::string part =
        text.substr(pos, next == std::string::npos ? std::string::npos : next - pos);
    if (part.empty()) return false;
    char* end = nullptr;
    long value = std::strtol(part.c_str(), &end, 10);
    if (end == nullptr || *end != '\0' || value <= 0) return false;
    out->dims[out->ndims++] = static_cast<int>(value);
    if (next == std::string::npos) break;
    pos = next + 1;
  }
  return out->ndims > 0;
}

int CoordToIndex(const Topology& slice, const std::array<int, kMaxDims>& coord) {
  int index = 0;
  for (int i = 0; i < slice.ndims; ++i) index = index * slice.dims[i] + coord[i];
  return index;
}

}  // namespace sliced
