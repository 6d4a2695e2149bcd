// Native (C++) reference oracle renderer for first_raytracer.
//
// A second, independent implementation of the reference semantics
// (SURVEY.md §2.1) in the reference's own language: the recursive
// ``color()`` integrator [E: main.cpp], linear closest-hit scan
// [E: hitable_list.h], per-material scatter [E: material.h], thin-lens
// camera [E: camera.h] — consuming the SAME counter-based Threefry-2x32-20
// uniforms as core/rng.py, so its per-ray output is directly comparable to
// both the NumPy oracle and the device paths (SURVEY.md §4.1).
//
// Float discipline mirrors oracle/cpu_oracle.py operation for operation:
// f32 arithmetic for vector math, f64 for libm transcendentals with f32
// stores, so C++ and NumPy agree to libm-ulp level.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).

#include <cmath>
#include <cstdint>

namespace {

typedef float f32;
typedef uint32_t u32;

struct V3 {
  f32 x, y, z;
};

inline V3 v3(f32 x, f32 y, f32 z) { return V3{x, y, z}; }
inline V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
inline V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
inline V3 operator*(f32 s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
inline V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
inline f32 dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
inline V3 unit(V3 v) {
  f32 n2 = dot(v, v);
  if (n2 <= 0.0f) return v;
  f32 n = (f32)std::sqrt((double)n2);
  return v3(v.x / n, v.y / n, v.z / n);
}

// ---- Threefry-2x32-20, mirrors core.rng exactly ----
const unsigned kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};

inline u32 rotl(u32 x, unsigned r) { return (x << r) | (x >> (32 - r)); }

inline void threefry2x32(u32 k0, u32 k1, u32 c0, u32 c1, u32* o0, u32* o1) {
  u32 ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  u32 x0 = c0 + k0;
  u32 x1 = c1 + k1;
  for (unsigned g = 0; g < 5; ++g) {
    for (unsigned j = 0; j < 4; ++j) {
      x0 = x0 + x1;
      x1 = rotl(x1, kRot[(4 * g + j) % 8]);
      x1 = x1 ^ x0;
    }
    x0 = x0 + ks[(g + 1) % 3];
    x1 = x1 + ks[(g + 2) % 3] + (u32)(g + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

inline f32 bits_to_unit(u32 b) {
  return (f32)(b >> 8) * (f32)(1.0 / (1 << 24));
}

// 4 uniforms of domain `dom` for ray id `rid` (core.rng._uniforms).
inline void draws4(u32 k0, u32 k1, u32 rid, u32 dom, f32 u[4]) {
  u32 a0, a1, b0, b1;
  threefry2x32(k0, k1, rid, dom * 2u, &a0, &a1);
  threefry2x32(k0, k1, rid, dom * 2u + 1u, &b0, &b1);
  u[0] = bits_to_unit(a0);
  u[1] = bits_to_unit(a1);
  u[2] = bits_to_unit(b0);
  u[3] = bits_to_unit(b1);
}

struct SceneView {
  const f32* sph_center;   // (ns, 3)
  const f32* sph_radius;   // (ns,)
  const int32_t* sph_mat;  // (ns,)
  int64_t ns;
  const f32* tri_v0;       // (nt, 3)
  const f32* tri_v1;
  const f32* tri_v2;
  const int32_t* tri_mat;
  int64_t nt;
  const int32_t* mat_type;  // (nm,)
  const int32_t* tex_type;
  const f32* albedo;   // (nm, 3)
  const f32* albedo2;  // (nm, 3)
  const f32* tex_scale;
  const f32* fuzz;
  const f32* ref_idx;
};

const f32 kBig = 1e30f;

// Linear closest-hit scan [E: hitable_list.h] (== oracle _closest_hit).
inline int64_t closest_hit(const SceneView& s, V3 o, V3 d, f32 t_min,
                           f32* t_out) {
  f32 best_t = kBig;
  int64_t best = -1;
  for (int64_t i = 0; i < s.ns; ++i) {
    V3 c = v3(s.sph_center[3 * i], s.sph_center[3 * i + 1],
              s.sph_center[3 * i + 2]);
    f32 r = s.sph_radius[i];
    V3 oc = o - c;
    f32 b = dot(oc, d);
    f32 cc = dot(oc, oc) - r * r;
    f32 disc = b * b - cc;
    if (disc > 0.0f) {
      f32 sq = (f32)std::sqrt((double)disc);
      f32 roots[2] = {-b - sq, -b + sq};
      for (int k = 0; k < 2; ++k) {
        f32 t = roots[k];
        if (t > t_min && t < best_t) {
          best_t = t;
          best = i;
          break;
        }
      }
    }
  }
  for (int64_t i = 0; i < s.nt; ++i) {
    V3 v0 = v3(s.tri_v0[3 * i], s.tri_v0[3 * i + 1], s.tri_v0[3 * i + 2]);
    V3 v1 = v3(s.tri_v1[3 * i], s.tri_v1[3 * i + 1], s.tri_v1[3 * i + 2]);
    V3 v2 = v3(s.tri_v2[3 * i], s.tri_v2[3 * i + 1], s.tri_v2[3 * i + 2]);
    V3 e1 = v1 - v0;
    V3 e2 = v2 - v0;
    V3 pvec = cross(d, e2);
    f32 det = dot(e1, pvec);
    if (std::fabs(det) <= 1e-9f) continue;
    f32 inv_det = 1.0f / det;
    V3 tvec = o - v0;
    f32 u = dot(tvec, pvec) * inv_det;
    V3 qvec = cross(tvec, e1);
    f32 v = dot(d, qvec) * inv_det;
    f32 t = dot(e2, qvec) * inv_det;
    if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t < best_t) {
      best_t = t;
      best = s.ns + i;
    }
  }
  *t_out = best_t;
  return best;
}

inline V3 texture_value(const SceneView& s, int m, V3 p) {
  if (s.tex_type[m] == 1) {  // checker [E: texture.h]
    f32 sc = s.tex_scale[m];
    double sines = std::sin((double)(sc * p.x)) * std::sin((double)(sc * p.y))
                   * std::sin((double)(sc * p.z));
    const f32* a = (sines < 0.0) ? (s.albedo2 + 3 * m) : (s.albedo + 3 * m);
    return v3(a[0], a[1], a[2]);
  }
  const f32* a = s.albedo + 3 * m;
  return v3(a[0], a[1], a[2]);
}

// Mirror of core.rng.unit_ball_sample / oracle _unit_ball (f64 transcendental
// math, f32 store).
inline V3 unit_ball(const f32 u[4]) {
  f32 z = 1.0f - 2.0f * u[0];
  double r = std::sqrt(std::fmax(0.0, 1.0 - (double)z * (double)z));
  double phi = 2.0 * M_PI * (double)u[1];
  double radius = std::pow((double)u[2], 1.0 / 3.0);
  return v3((f32)(radius * r * std::cos(phi)),
            (f32)(radius * r * std::sin(phi)), (f32)(radius * (double)z));
}

inline V3 reflect(V3 v, V3 n) { return v - (2.0f * dot(v, n)) * n; }

// Per-material scatter [E: material.h] (== oracle _scatter).
inline bool scatter(const SceneView& s, int m, V3 d, V3 p, V3 n,
                    const f32 u[4], V3* new_dir, V3* att) {
  int mtype = s.mat_type[m];
  V3 ball = unit_ball(u);
  if (mtype == 0) {  // lambertian
    *new_dir = unit(n + ball);
    *att = texture_value(s, m, p);
    return true;
  }
  if (mtype == 1) {  // metal
    V3 raw = reflect(d, n) + s.fuzz[m] * ball;
    if (dot(raw, n) <= 0.0f) return false;
    *new_dir = unit(raw);
    *att = texture_value(s, m, p);
    return true;
  }
  // dielectric
  f32 ref_idx = s.ref_idx[m];
  f32 d_dot_n = dot(d, n);
  V3 outward;
  f32 ni_over_nt, cosine;
  if (d_dot_n > 0.0f) {
    outward = v3(-n.x, -n.y, -n.z);
    ni_over_nt = ref_idx;
    cosine = ref_idx * d_dot_n;
  } else {
    outward = n;
    ni_over_nt = 1.0f / ref_idx;
    cosine = -d_dot_n;
  }
  f32 dt = dot(d, outward);
  f32 disc = 1.0f - ni_over_nt * ni_over_nt * (1.0f - dt * dt);
  f32 reflect_prob = 1.0f;
  V3 refracted = v3(0, 0, 0);
  if (disc > 0.0f) {
    refracted = ni_over_nt * (d - dt * outward)
                - (f32)std::sqrt((double)disc) * outward;
    f32 r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
    r0 = r0 * r0;
    f32 om = 1.0f - cosine;
    reflect_prob = r0 + (1.0f - r0) * (f32)std::pow((double)om, 5.0);
  }
  if (u[3] < reflect_prob) {
    *new_dir = unit(reflect(d, n));
  } else {
    *new_dir = unit(refracted);
  }
  *att = v3(1, 1, 1);
  return true;
}

inline V3 sky(V3 d) {
  f32 t = 0.5f * (d.y + 1.0f);
  return v3((1.0f - t) + t * 0.5f, (1.0f - t) + t * 0.7f,
            (1.0f - t) + t * 1.0f);
}

// Recursive color() [E: main.cpp] (== oracle trace_ray_oracle).
V3 color(const SceneView& s, V3 o, V3 d, u32 k0, u32 k1, u32 rid, int depth,
         int max_depth, f32 t_min) {
  f32 t;
  int64_t prim = closest_hit(s, o, d, t_min, &t);
  if (prim < 0) return sky(d);
  V3 p = o + t * d;
  V3 n;
  int m;
  if (prim < s.ns) {
    V3 c = v3(s.sph_center[3 * prim], s.sph_center[3 * prim + 1],
              s.sph_center[3 * prim + 2]);
    f32 r = s.sph_radius[prim];
    n = v3((p.x - c.x) / r, (p.y - c.y) / r, (p.z - c.z) / r);
    m = s.sph_mat[prim];
  } else {
    int64_t i = prim - s.ns;
    V3 v0 = v3(s.tri_v0[3 * i], s.tri_v0[3 * i + 1], s.tri_v0[3 * i + 2]);
    V3 v1 = v3(s.tri_v1[3 * i], s.tri_v1[3 * i + 1], s.tri_v1[3 * i + 2]);
    V3 v2 = v3(s.tri_v2[3 * i], s.tri_v2[3 * i + 1], s.tri_v2[3 * i + 2]);
    n = unit(cross(v1 - v0, v2 - v0));
    m = s.tri_mat[i];
  }
  if (depth >= max_depth) return v3(0, 0, 0);
  f32 u[4];
  draws4(k0, k1, rid, (u32)(1 + depth), u);
  V3 new_dir, att;
  if (!scatter(s, m, d, p, n, u, &new_dir, &att))
    return v3(0, 0, 0);
  return att * color(s, p, new_dir, k0, k1, rid, depth + 1, max_depth, t_min);
}

}  // namespace

extern "C" {

// Renders `n_rays` rays by global id into out (n_rays, 3) f32.
// cam: 19 floats — origin(3), lower_left(3), horizontal(3), vertical(3),
// u(3), v(3), lens_radius.
void frt_render_oracle(
    const f32* sph_center, const f32* sph_radius, const int32_t* sph_mat,
    int64_t ns, const f32* tri_v0, const f32* tri_v1, const f32* tri_v2,
    const int32_t* tri_mat, int64_t nt, const int32_t* mat_type,
    const int32_t* tex_type, const f32* albedo, const f32* albedo2,
    const f32* tex_scale, const f32* fuzz, const f32* ref_idx,
    const f32* cam, int32_t nx, int32_t ny, int32_t spp, int32_t max_depth,
    f32 t_min, u32 key0, u32 key1, const int64_t* ray_ids, int64_t n_rays,
    f32* out) {
  SceneView s{sph_center, sph_radius, sph_mat, ns,
              tri_v0,     tri_v1,     tri_v2,  tri_mat,
              nt,         mat_type,   tex_type, albedo,
              albedo2,    tex_scale,  fuzz,    ref_idx};
  V3 cam_origin = v3(cam[0], cam[1], cam[2]);
  V3 lower_left = v3(cam[3], cam[4], cam[5]);
  V3 horizontal = v3(cam[6], cam[7], cam[8]);
  V3 vertical = v3(cam[9], cam[10], cam[11]);
  V3 cu = v3(cam[12], cam[13], cam[14]);
  V3 cv = v3(cam[15], cam[16], cam[17]);
  f32 lens_radius = cam[18];

  for (int64_t idx = 0; idx < n_rays; ++idx) {
    int64_t rid = ray_ids[idx];
    f32 u[4];
    draws4(key0, key1, (u32)rid, 0u, u);  // camera domain
    int64_t pixel = rid / spp;
    int64_t i = pixel % nx;
    int64_t j = pixel / nx;  // bottom-up row, matching render/camera.py
    f32 sx = ((f32)i + u[0]) / (f32)nx;
    f32 ty = ((f32)j + u[1]) / (f32)ny;
    double r = std::sqrt((double)u[2]);
    double theta = 2.0 * M_PI * (double)u[3];
    f32 rd0 = lens_radius * (f32)(r * std::cos(theta));
    f32 rd1 = lens_radius * (f32)(r * std::sin(theta));
    V3 offset = rd0 * cu + rd1 * cv;
    V3 o = cam_origin + offset;
    V3 d = unit(lower_left + sx * horizontal + ty * vertical
                - cam_origin - offset);
    V3 c = color(s, o, d, key0, key1, (u32)rid, 0, max_depth, t_min);
    out[3 * idx] = c.x;
    out[3 * idx + 1] = c.y;
    out[3 * idx + 2] = c.z;
  }
}

}  // extern "C"
