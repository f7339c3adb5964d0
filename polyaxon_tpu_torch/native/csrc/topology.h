// Torus topology model for slices (the port's copy of the slice pool's
// sources; the code, its C interface and its line protocol are the
// reference daemon's).
//
// A slice is an N-d torus of chips ("8x8", "4x4x4"); a gang request asks
// for a sub-torus and gets chips that are contiguous (wraparound
// allowed). On a GPU host a slice is the host's cards as a
// one-dimensional topology "N", and a request "k" gets k of them.
#pragma once

#include <array>
#include <cstdint>
#include <string>
#include <vector>

namespace sliced {

constexpr int kMaxDims = 3;

struct Topology {
  std::array<int, kMaxDims> dims{1, 1, 1};
  int ndims = 0;

  int chips() const {
    int n = 1;
    for (int i = 0; i < ndims; ++i) n *= dims[i];
    return n == 1 && ndims == 0 ? 0 : n;
  }

  std::string str() const {
    std::string out;
    for (int i = 0; i < ndims; ++i) {
      if (i) out += 'x';
      out += std::to_string(dims[i]);
    }
    return out;
  }
};

// Parse "8", "8x8", "4x4x4". Returns false on malformed input.
bool ParseTopology(const std::string& text, Topology* out);

// Linearize torus coordinates (row-major over ndims of the slice).
int CoordToIndex(const Topology& slice, const std::array<int, kMaxDims>& coord);

}  // namespace sliced
