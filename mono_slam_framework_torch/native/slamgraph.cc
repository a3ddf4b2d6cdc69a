// slamgraph: native observation/covisibility graph core.
//
// Capability twin of the reference's covisibility bookkeeping
// (slam_pipeline/src/KeyFrame.cc:191-262 UpdateConnections and the
// MapPoint::observations maps, src/MapPoint.cc:98-125): the host-side graph
// builder of the SLAM runtime. The TPU device programs consume padded array
// snapshots; this store maintains the mutable (map-point, keyframe)
// incidence and answers covisibility-count queries in C++ instead of Python
// dict loops (the per-keyframe UpdateConnections scan is the hottest
// host-side operation once maps grow to thousands of points).
//
// Built as a shared library, bound via ctypes (no pybind11 in this image).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libslamgraph.so slamgraph.cc

#include <cstdint>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

using Id = int64_t;

struct Graph {
  // mp -> observing kfs ; kf -> observed mps (values kept unsorted, erase by
  // swap-remove; duplicates prevented on insert)
  std::unordered_map<Id, std::vector<Id>> mp_obs;
  std::unordered_map<Id, std::vector<Id>> kf_obs;
};

bool vec_erase(std::vector<Id>& v, Id x) {
  auto it = std::find(v.begin(), v.end(), x);
  if (it == v.end()) return false;
  *it = v.back();
  v.pop_back();
  return true;
}

}  // namespace

extern "C" {

void* sg_create() { return new Graph(); }

void sg_destroy(void* h) { delete static_cast<Graph*>(h); }

void sg_clear(void* h) {
  auto* g = static_cast<Graph*>(h);
  g->mp_obs.clear();
  g->kf_obs.clear();
}

// returns 1 if inserted, 0 if the pair already existed
int sg_add_obs(void* h, Id mp, Id kf) {
  auto* g = static_cast<Graph*>(h);
  auto& kfs = g->mp_obs[mp];
  if (std::find(kfs.begin(), kfs.end(), kf) != kfs.end()) return 0;
  kfs.push_back(kf);
  g->kf_obs[kf].push_back(mp);
  return 1;
}

int sg_erase_obs(void* h, Id mp, Id kf) {
  auto* g = static_cast<Graph*>(h);
  auto mi = g->mp_obs.find(mp);
  if (mi == g->mp_obs.end() || !vec_erase(mi->second, kf)) return 0;
  auto ki = g->kf_obs.find(kf);
  if (ki != g->kf_obs.end()) vec_erase(ki->second, mp);
  return 1;
}

void sg_erase_mp(void* h, Id mp) {
  auto* g = static_cast<Graph*>(h);
  auto mi = g->mp_obs.find(mp);
  if (mi == g->mp_obs.end()) return;
  for (Id kf : mi->second) {
    auto ki = g->kf_obs.find(kf);
    if (ki != g->kf_obs.end()) vec_erase(ki->second, mp);
  }
  g->mp_obs.erase(mi);
}

void sg_erase_kf(void* h, Id kf) {
  auto* g = static_cast<Graph*>(h);
  auto ki = g->kf_obs.find(kf);
  if (ki == g->kf_obs.end()) return;
  for (Id mp : ki->second) {
    auto mi = g->mp_obs.find(mp);
    if (mi != g->mp_obs.end()) vec_erase(mi->second, kf);
  }
  g->kf_obs.erase(ki);
}

int64_t sg_n_obs_kf(void* h, Id kf) {
  auto* g = static_cast<Graph*>(h);
  auto ki = g->kf_obs.find(kf);
  return ki == g->kf_obs.end() ? 0 : static_cast<int64_t>(ki->second.size());
}

int64_t sg_n_obs_mp(void* h, Id mp) {
  auto* g = static_cast<Graph*>(h);
  auto mi = g->mp_obs.find(mp);
  return mi == g->mp_obs.end() ? 0 : static_cast<int64_t>(mi->second.size());
}

// Covisibility counts for `kf`: number of shared map points with every other
// keyframe observing at least one of kf's points (KeyFrame.cc:196-211).
// Writes up to `cap` (kf_id, weight) pairs; returns the number written (or
// the negated required capacity if cap is too small).
int64_t sg_covis_counts(void* h, Id kf, Id* out_ids, Id* out_weights,
                        int64_t cap) {
  auto* g = static_cast<Graph*>(h);
  auto ki = g->kf_obs.find(kf);
  if (ki == g->kf_obs.end()) return 0;
  std::unordered_map<Id, Id> counts;
  counts.reserve(64);
  for (Id mp : ki->second) {
    auto mi = g->mp_obs.find(mp);
    if (mi == g->mp_obs.end()) continue;
    for (Id other : mi->second) {
      if (other != kf) ++counts[other];
    }
  }
  int64_t n = static_cast<int64_t>(counts.size());
  if (n > cap) return -n;
  int64_t i = 0;
  for (const auto& it : counts) {
    out_ids[i] = it.first;
    out_weights[i] = it.second;
    ++i;
  }
  return n;
}

}  // extern "C"
