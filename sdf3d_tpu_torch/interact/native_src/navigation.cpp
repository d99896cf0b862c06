// Native navigation runtime: arcball orbit / pan / zoom with low-pass decay.
//
// TPU-native counterpart of the reference's Neutrino navigation layer — the
// external C++ lib whose API the app drives per frame:
//   gl->mouse_navigation(orbit_rate, pan_rate, decay)    (main.cpp:93)
//   gl->gamepad_navigation(ori_rate, pan_rate, decay_o, decay_p, deadzone)
//                                                        (main.cpp:94)
// Neutrino itself is closed here (linked as libnu.a, CMakeLists.txt:78,91),
// so this is an independent design of the same capability: a stateful
// controller that turns input events (mouse drags, scroll, gamepad axes)
// into a smoothed view matrix, with exponential low-pass decay so motion
// eases out after input stops.  The host frame loop (Python) feeds events
// and steps the filter; the renderer consumes the 4x4 view matrix exactly
// where the reference's shader consumes V_mat (voxel_fragment.frag:180,192).
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstring>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(float s, Vec3 v) { return {s * v.x, s * v.y, s * v.z}; }
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline Vec3 normalize(Vec3 v) {
  float n = std::sqrt(dot(v, v));
  if (n < 1e-12f) return {0.0f, 0.0f, 1.0f};
  return {v.x / n, v.y / n, v.z / n};
}

struct Controller {
  // Orbit state (spherical around the pan target).
  float azimuth = 0.0f;      // radians
  float elevation = 0.0f;    // radians
  float distance = 2.0f;
  Vec3 target{0.0f, 0.0f, 0.0f};

  // Filtered velocities (units/s) — inputs add impulses, decay drains them.
  float v_az = 0.0f, v_el = 0.0f, v_dist = 0.0f;
  Vec3 v_pan{0.0f, 0.0f, 0.0f};

  // Tuning (reference-call parameters, main.cpp:37-45).
  float orbit_rate = 1.0f;
  float pan_rate = 5.0f;
  float decay = 1.25f;       // exponential decay time-constant multiplier
  float deadzone = 0.30f;    // gamepad axis deadzone (30%, main.cpp:45)

  float elevation_limit = 1.55f;  // just under ±π/2: keep `up` well-defined
  float min_distance = 0.05f;
};

inline float apply_deadzone(float v, float dz) {
  float a = std::fabs(v);
  if (a < dz) return 0.0f;
  // Rescale so motion starts at 0 right past the deadzone edge.
  float s = (a - dz) / (1.0f - dz);
  return v < 0.0f ? -s : s;
}

}  // namespace

extern "C" {

void* sdf3d_nav_create() { return new Controller(); }

void sdf3d_nav_destroy(void* c) { delete static_cast<Controller*>(c); }

void sdf3d_nav_configure(void* cv, float orbit_rate, float pan_rate, float decay, float deadzone) {
  Controller& c = *static_cast<Controller*>(cv);
  c.orbit_rate = orbit_rate;
  c.pan_rate = pan_rate;
  c.decay = decay;
  c.deadzone = deadzone;
}

void sdf3d_nav_set_pose(void* cv, float azimuth, float elevation, float distance,
                        float tx, float ty, float tz) {
  Controller& c = *static_cast<Controller*>(cv);
  c.azimuth = azimuth;
  c.elevation = elevation;
  c.distance = distance;
  c.target = {tx, ty, tz};
  c.v_az = c.v_el = c.v_dist = 0.0f;
  c.v_pan = {0.0f, 0.0f, 0.0f};
}

// Mouse drag in NDC deltas; buttons: orbit (left) or pan (right).
void sdf3d_nav_mouse_drag(void* cv, float dx, float dy, int pan_button) {
  Controller& c = *static_cast<Controller*>(cv);
  if (pan_button) {
    // Pan impulse in view plane; resolved to world axes at step time.
    c.v_pan.x += c.pan_rate * dx;
    c.v_pan.y += c.pan_rate * dy;
  } else {
    c.v_az += c.orbit_rate * dx * 3.14159265f;
    c.v_el += c.orbit_rate * dy * 3.14159265f;
  }
}

void sdf3d_nav_scroll(void* cv, float amount) {
  Controller& c = *static_cast<Controller*>(cv);
  c.v_dist -= amount;  // positive scroll zooms in
}

// Gamepad axes in [-1,1]: left stick orbits, right stick pans, triggers zoom.
void sdf3d_nav_gamepad(void* cv, float lx, float ly, float rx, float ry, float zoom) {
  Controller& c = *static_cast<Controller*>(cv);
  c.v_az += c.orbit_rate * apply_deadzone(lx, c.deadzone);
  c.v_el += c.orbit_rate * apply_deadzone(ly, c.deadzone);
  c.v_pan.x += c.pan_rate * 0.2f * apply_deadzone(rx, c.deadzone);
  c.v_pan.y += c.pan_rate * 0.2f * apply_deadzone(ry, c.deadzone);
  c.v_dist += apply_deadzone(zoom, c.deadzone);
}

// Advance the filter by dt seconds: integrate velocities, then decay them
// exponentially (the Neutrino-style ease-out).
void sdf3d_nav_step(void* cv, float dt) {
  Controller& c = *static_cast<Controller*>(cv);
  c.azimuth += c.v_az * dt;
  c.elevation += c.v_el * dt;
  if (c.elevation > c.elevation_limit) c.elevation = c.elevation_limit;
  if (c.elevation < -c.elevation_limit) c.elevation = -c.elevation_limit;
  c.distance *= std::exp(c.v_dist * dt);
  if (c.distance < c.min_distance) c.distance = c.min_distance;

  // Pan in the camera's view plane (right/up axes from current pose).
  float ca = std::cos(c.azimuth), sa = std::sin(c.azimuth);
  float ce = std::cos(c.elevation), se = std::sin(c.elevation);
  Vec3 eye_dir{ce * sa, se, ce * ca};  // unit vector target -> eye
  Vec3 world_up{0.0f, 1.0f, 0.0f};
  Vec3 fwd = normalize(-1.0f * eye_dir);
  Vec3 right = normalize(cross(fwd, world_up));
  Vec3 up = cross(right, fwd);
  Vec3 pan_world = (c.v_pan.x * dt * c.distance) * right + (c.v_pan.y * dt * c.distance) * up;
  c.target = c.target + pan_world;

  float k = std::exp(-c.decay * dt * 10.0f);  // LP decay: ~e-fold in 1/(10·decay) s
  c.v_az *= k;
  c.v_el *= k;
  c.v_dist *= k;
  c.v_pan = k * c.v_pan;
}

// Current eye position and look-at view matrix (row-major 4x4).
void sdf3d_nav_view_matrix(void* cv, float* out16) {
  Controller& c = *static_cast<Controller*>(cv);
  float ca = std::cos(c.azimuth), sa = std::sin(c.azimuth);
  float ce = std::cos(c.elevation), se = std::sin(c.elevation);
  Vec3 eye = c.target + c.distance * Vec3{ce * sa, se, ce * ca};
  Vec3 fwd = normalize(c.target - eye);
  Vec3 right = normalize(cross(fwd, Vec3{0.0f, 1.0f, 0.0f}));
  Vec3 up = cross(right, fwd);
  // Standard look-at view matrix: world -> camera.
  float m[16] = {
      right.x, right.y, right.z, -dot(right, eye),
      up.x, up.y, up.z, -dot(up, eye),
      -fwd.x, -fwd.y, -fwd.z, dot(fwd, eye),
      0.0f, 0.0f, 0.0f, 1.0f,
  };
  std::memcpy(out16, m, sizeof(m));
}

void sdf3d_nav_get_pose(void* cv, float* out6) {
  Controller& c = *static_cast<Controller*>(cv);
  out6[0] = c.azimuth;
  out6[1] = c.elevation;
  out6[2] = c.distance;
  out6[3] = c.target.x;
  out6[4] = c.target.y;
  out6[5] = c.target.z;
}

}  // extern "C"
