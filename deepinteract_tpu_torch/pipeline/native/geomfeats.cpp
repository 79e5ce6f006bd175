// Native geometry kernels for the raw-data pipeline.
//
// TPU-framework equivalent of the reference's native feature toolchain
// (SURVEY.md §2.3): where the reference shells out to DSSP/MSMS/PSAIA
// binaries for the O(atoms^2)-class structural measurements, we compute the
// same quantities in-process. Exposed as a plain C ABI consumed via ctypes
// (deepinteract_tpu_torch/pipeline/native.py), with numpy fallbacks kept in
// residue_features.py as the checked reference implementation.
//
// Kernels:
//   sasa_and_depth  — Shrake-Rupley solvent-accessible surface area per atom
//                     (basis for DSSP-style RSA) + per-atom depth below the
//                     accessible surface (MSMS residue-depth equivalent).
//   min_dist_matrix — per-residue-pair minimum heavy-atom distance (basis
//                     for the PAIRpred similarity matrix -> HSAAC/CN,
//                     dips_plus_utils.py:84-115, and 6 Å interface labels).
//   protrusion_cx   — per-atom protrusion index (PSAIA's CX: ratio of empty
//                     to occupied volume in a 10 Å sphere).
//
// All kernels are brute-force O(n^2) with small constants: the reference
// caps complexes at ATOM_COUNT_LIMIT=2048 atoms, where brute force beats
// any spatial index in practice.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

// Golden-spiral (Fibonacci) unit sphere points. The numpy fallback uses the
// identical formula so the two paths agree to float precision.
static void fibonacci_sphere(int n, std::vector<float>& pts) {
  pts.resize(static_cast<size_t>(n) * 3);
  const float golden = kPi * (3.0f - std::sqrt(5.0f));
  for (int i = 0; i < n; ++i) {
    float y = 1.0f - 2.0f * (static_cast<float>(i) + 0.5f) / static_cast<float>(n);
    float r = std::sqrt(std::fmax(0.0f, 1.0f - y * y));
    float th = golden * static_cast<float>(i);
    pts[3 * i + 0] = std::cos(th) * r;
    pts[3 * i + 1] = y;
    pts[3 * i + 2] = std::sin(th) * r;
  }
}

static inline float sq_dist(const float* a, const float* b) {
  float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return dx * dx + dy * dy + dz * dz;
}

}  // namespace

extern "C" {

// Shrake-Rupley SASA + depth-below-surface, one pass.
//   coords  [n_atoms*3]  heavy-atom coordinates
//   radii   [n_atoms]    van der Waals radii
//   out_sasa  [n_atoms]  A^2 of solvent-accessible area
//   out_depth [n_atoms]  distance from atom center to the nearest accessible
//                        surface sample (0 when the atom itself is exposed
//                        enough); MSMS-equivalent up to the surface
//                        discretization, and consumed min-max normalized.
void sasa_and_depth(const float* coords, const float* radii, int n_atoms,
                    int n_sphere, float probe, float* out_sasa,
                    float* out_depth) {
  std::vector<float> unit;
  fibonacci_sphere(n_sphere, unit);

  // Accessible surface samples, pooled over all atoms for the depth pass.
  std::vector<float> surface;
  surface.reserve(1024 * 3);

  std::vector<int> nbrs;
  nbrs.reserve(64);
  for (int i = 0; i < n_atoms; ++i) {
    const float ri = radii[i] + probe;
    // Neighbors whose probe-inflated spheres can occlude atom i's sphere.
    nbrs.clear();
    for (int j = 0; j < n_atoms; ++j) {
      if (j == i) continue;
      float lim = ri + radii[j] + probe;
      if (sq_dist(coords + 3 * i, coords + 3 * j) < lim * lim) nbrs.push_back(j);
    }
    int accessible = 0;
    for (int s = 0; s < n_sphere; ++s) {
      float p[3] = {coords[3 * i + 0] + ri * unit[3 * s + 0],
                    coords[3 * i + 1] + ri * unit[3 * s + 1],
                    coords[3 * i + 2] + ri * unit[3 * s + 2]};
      bool buried = false;
      for (int j : nbrs) {
        float rj = radii[j] + probe;
        if (sq_dist(p, coords + 3 * j) < rj * rj) {
          buried = true;
          break;
        }
      }
      if (!buried) {
        ++accessible;
        surface.push_back(p[0]);
        surface.push_back(p[1]);
        surface.push_back(p[2]);
      }
    }
    out_sasa[i] = 4.0f * kPi * ri * ri * static_cast<float>(accessible) /
                  static_cast<float>(n_sphere);
  }

  const int n_surf = static_cast<int>(surface.size() / 3);
  for (int i = 0; i < n_atoms; ++i) {
    float best = INFINITY;
    for (int s = 0; s < n_surf; ++s) {
      float d = sq_dist(coords + 3 * i, surface.data() + 3 * s);
      if (d < best) best = d;
    }
    // Depth below the accessible surface: the surface samples sit probe+r
    // away from their parent atom centers, so subtract the probe-inflated
    // shell to make an exposed atom's depth ~0 regardless of its element.
    float shell = radii[i] + probe;
    float depth = n_surf ? std::sqrt(best) - shell : 0.0f;
    out_depth[i] = depth > 0.0f ? depth : 0.0f;
  }
}

// Per-residue-pair minimum heavy-atom distance.
//   res_start [n_res+1] CSR offsets into the atom arrays
//   out       [n_res*n_res] symmetric matrix
void min_dist_matrix(const float* coords, int n_atoms, const int32_t* res_start,
                     int n_res, float* out) {
  (void)n_atoms;
  for (int a = 0; a < n_res; ++a) {
    out[a * n_res + a] = 0.0f;
    for (int b = a + 1; b < n_res; ++b) {
      float best = INFINITY;
      for (int i = res_start[a]; i < res_start[a + 1]; ++i) {
        for (int j = res_start[b]; j < res_start[b + 1]; ++j) {
          float d = sq_dist(coords + 3 * i, coords + 3 * j);
          if (d < best) best = d;
        }
      }
      best = std::sqrt(best);
      out[a * n_res + b] = best;
      out[b * n_res + a] = best;
    }
  }
}

// Cross-structure variant: min heavy-atom distance between residues of two
// different chains (for 6 Å interface labels; atom3's pruned-pair semantics).
void cross_min_dist_matrix(const float* coords1, const int32_t* res_start1,
                           int n_res1, const float* coords2,
                           const int32_t* res_start2, int n_res2, float* out) {
  for (int a = 0; a < n_res1; ++a) {
    for (int b = 0; b < n_res2; ++b) {
      float best = INFINITY;
      for (int i = res_start1[a]; i < res_start1[a + 1]; ++i) {
        for (int j = res_start2[b]; j < res_start2[b + 1]; ++j) {
          float d = sq_dist(coords1 + 3 * i, coords2 + 3 * j);
          if (d < best) best = d;
        }
      }
      out[a * n_res2 + b] = std::sqrt(best);
    }
  }
}

// PSAIA-style protrusion index per atom: CX = (V_sphere - V_int) / V_int
// where V_int = (atoms within `radius`) * atom_volume.
void protrusion_cx(const float* coords, int n_atoms, float radius,
                   float atom_volume, float* out_cx) {
  const float r2 = radius * radius;
  const float v_sphere = 4.0f / 3.0f * kPi * radius * radius * radius;
  for (int i = 0; i < n_atoms; ++i) {
    int count = 0;
    for (int j = 0; j < n_atoms; ++j) {
      if (sq_dist(coords + 3 * i, coords + 3 * j) <= r2) ++count;
    }
    float v_int = static_cast<float>(count) * atom_volume;
    float v_ext = v_sphere - v_int;
    if (v_ext < 0.0f) v_ext = 0.0f;
    out_cx[i] = v_int > 0.0f ? v_ext / v_int : 0.0f;
  }
}

}  // extern "C"
