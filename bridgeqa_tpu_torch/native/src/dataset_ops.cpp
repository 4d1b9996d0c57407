// Native data-loader kernels for the host-side sample assembly hot path.
//
// The reference's per-sample work (lib/dataset.py:496-510 vote computation,
// 447-491 augmentation) runs as Python loops over instances inside the
// torch DataLoader workers; at 40k points per scene this is the per-sample
// CPU bottleneck. These C++ kernels do the same work in one pass over the
// point array and are loaded through ctypes (no pybind11 dependency).
//
// ABI: plain C functions over raw buffers; caller (numpy) owns all memory.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Vote label computation (dataset.py:496-510 semantics):
// group points by instance id; an instance contributes votes iff the
// semantic label of its FIRST point (in array order) is a target class
// (sem_ok != 0); vote = 0.5*(min+max of the instance's points) - point,
// written tiled x3 into votes[n][9]; mask = 1 on contributing points.
//
// points: n*3 float32 (post-augmentation xyz)
// instance_labels: n int32
// sem_ok: n uint8 (1 iff semantic label in nyu40ids)
// votes: n*9 float32 out (caller zero-initialized)
// mask: n float32 out (caller zero-initialized)
// Returns the number of contributing instances.
int compute_votes(const float* points, const int32_t* instance_labels,
                  const uint8_t* sem_ok, int64_t n, float* votes, float* mask) {
  struct Acc {
    float mn[3];
    float mx[3];
    uint8_t ok;
    uint8_t seen;
  };
  std::unordered_map<int32_t, Acc> acc;
  acc.reserve(64);

  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + 3 * i;
    auto it = acc.find(instance_labels[i]);
    if (it == acc.end()) {
      Acc a;
      for (int d = 0; d < 3; ++d) { a.mn[d] = p[d]; a.mx[d] = p[d]; }
      a.ok = sem_ok[i];  // first point in array order decides (dataset.py:503)
      a.seen = 1;
      acc.emplace(instance_labels[i], a);
    } else {
      Acc& a = it->second;
      for (int d = 0; d < 3; ++d) {
        if (p[d] < a.mn[d]) a.mn[d] = p[d];
        if (p[d] > a.mx[d]) a.mx[d] = p[d];
      }
    }
  }

  int contributing = 0;
  for (auto& kv : acc) {
    if (kv.second.ok) ++contributing;
  }

  for (int64_t i = 0; i < n; ++i) {
    const Acc& a = acc[instance_labels[i]];
    if (!a.ok) continue;
    const float* p = points + 3 * i;
    float* v = votes + 9 * i;
    for (int d = 0; d < 3; ++d) {
      float c = 0.5f * (a.mn[d] + a.mx[d]);
      float vote = c - p[d];
      v[d] = vote;
      v[3 + d] = vote;
      v[6 + d] = vote;
    }
    mask[i] = 1.0f;
  }
  return contributing;
}

}  // extern "C"
