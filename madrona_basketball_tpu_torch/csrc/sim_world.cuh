// Per-world simulation body shared by kernel A (fused_step.cu), kernel B
// (fused_rollout.cu) and kernel F (fused_multistep.cu).
//
// `step_world` is one tick of the 19-system chain for ONE world, a
// line-for-line transcription of the JAX `step_fields`
// (madrona_basketball_tpu/ops/fused_step.py:272-943) and of the plain torch
// version (madrona_basketball_tpu_torch/ops/fused_step.py).  It keeps their
// float forms: angle addition instead of atan2, dot < cos(pi/8) instead of
// acos, the half-angle quaternion and the ops/tmath.py polynomials for atan
// and erf, so no libm call of the reference C++ (native/mbb_sim.cpp uses
// acos/atan2/atan/erf) enters the result.  Expressions keep the Python
// evaluation order; the build lets nvcc fuse multiply-adds, so the kernel
// and the plain torch version on the card differ by a few ulp (build_ab.py
// measures this against a --fmad=false build).  The one exception is the
// shot's going-in chain (system 6), which rounds with the _rn intrinsics
// (and __fmaf_rn where the JAX reference's XLA:CPU build fuses a
// multiply-add) so that a made or missed shot is decided as in the plain
// version.
//
// World state lives in the SoA rows of ops/layout.py: SF (72, W) float32
// and SI (59, W) int32, row r of world w at [r * W + w].  The X-macros below
// list the fields in the layout's order (tests/test_torch_layout.py holds
// the two lists together).

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define MBB_HD __device__ __forceinline__
#else
// Host build of the same body (host_step.cpp, tests/test_torch_device_body.py)
#include <cmath>
#include <cstring>
#define MBB_HD inline
#define __restrict__ __restrict
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline float __uint_as_float(uint32_t b) {
    float f;
    std::memcpy(&f, &b, sizeof f);
    return f;
}
inline float __int_as_float(int b) {
    float f;
    std::memcpy(&f, &b, sizeof f);
    return f;
}
inline int __float_as_int(float f) {
    int b;
    std::memcpy(&b, &f, sizeof b);
    return b;
}
// The round-to-nearest intrinsics as plain operations: the host build
// compiles with -ffp-contract=off, so each rounds once, as on the card.
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
#endif

namespace mbb {

#define MBB_AGENT_F32(X)                                                      \
    X(pos_x) X(pos_y) X(pos_z) X(vel_x) X(vel_y) X(vel_z) X(quat_w)            \
    X(quat_x) X(quat_y) X(quat_z) X(reward) X(done) X(cooldown)                \
    X(stat_points) X(stat_fouls) X(max_speed) X(quickness) X(shooting)         \
    X(ft_pct) X(reaction) X(target_x) X(target_y) X(target_z) X(shot_pct)      \
    X(color_r) X(color_g) X(color_b)
#define MBB_AGENT_I32(X)                                                      \
    X(a_move) X(a_angle) X(a_rotate) X(a_grab) X(a_pass) X(a_shoot)            \
    X(m_move) X(m_grab) X(m_pass) X(m_shoot) X(reset) X(cur_step)              \
    X(has_ball) X(held_ball) X(points_worth) X(im_inb) X(allowed_move)         \
    X(team) X(defend_hoop)
#define MBB_BALL_F32(X)                                                       \
    X(bpos_x) X(bpos_y) X(bpos_z) X(bvel_x) X(bvel_y) X(bvel_z) X(bdone)
#define MBB_BALL_I32(X)                                                       \
    X(bgrabbed) X(bholder) X(binflight) X(blt_agent) X(blt_team)               \
    X(bsb_agent) X(bsb_team) X(bspv) X(bsgi) X(breset) X(bcur_step)
#define MBB_GAME_F32(X)                                                       \
    X(period) X(tip) X(t0score) X(t1score) X(gclock) X(sclock) X(sbaskets)     \
    X(oob) X(iclock)
#define MBB_GAME_I32(X) X(ginb) X(glive) X(t0hoop) X(t1hoop) X(is1v1) X(reset_now)
#define MBB_HOOP_F32(X) X(hdone0) X(hdone1)
#define MBB_HOOP_I32(X) X(hcur0) X(hcur1) X(hreset0) X(hreset1)

#define MBB_DECL_F(n) float n;
#define MBB_DECL_I(n) int n;

constexpr int NUM_AGENTS = 2;
constexpr int N_F32_ROWS = 72;
constexpr int N_I32_ROWS = 59;
constexpr int N_NOISE_ROWS = 9;
constexpr int OBS_SIZE = 128;
constexpr int OBS_USED = 103;
constexpr int N_OBS_ROWS = NUM_AGENTS * OBS_SIZE;

constexpr int PLACEHOLDER = 2147483647;
constexpr int HOOP_ID0 = 0;
constexpr int BALL_ID = 2;
MBB_HD int agent_id(int i) { return 3 + i; }

// float32 values of the Python-double constants of ops/fused_step.py
constexpr float DT = 0.016129031777381897f;        // 1/62 in f32
constexpr float TURN_W = 0.9986295104026794f;      // cos(3 deg)
constexpr float TURN_Z = 0.0523359552025795f;      // sin(3 deg)
constexpr float COS_PI_8 = 0.9238795042037964f;
constexpr float S2 = 0.7071067690849304f;          // 1/sqrt(2)
constexpr float ANGLE_STEP = 0.7853981852531433f;  // pi/4
constexpr float TWO_PI = 6.2831854820251465f;
constexpr float SQRT2 = 1.4142135381698608f;
constexpr float HALF_PI = 1.5707963705062866f;
constexpr float ZONE_R = 0.1f;
constexpr float ZONE_R2 = 0.009999999776482582f;   // f32(0.1 * 0.1)
constexpr float HW = 0.21449999511241913f;         // shoulder width / 2
constexpr float HD = 0.05000000074505806f;         // depth / 2
constexpr float FLT_BIG = 3.4028234663852886e+38f;

// Config + constants rounded to f32 on the host
// (ops/fused_step.py::SimParams mirrors this struct field for field).
struct SimParams {
    float grid_w, grid_h, start_x, start_y, time_per_period, shot_clock;
    float h0x, h0y, h1x, h1y;
    float court_min_x, court_max_x, court_min_y, court_max_y;
    float corner_lo_y, corner_hi_y, corner_left_x, corner_right_x;
    float spot_y, grid_x0, grid_x1, grid_y0, reset_qw, reset_qz;
    int tag_mode;
};

struct Agent {
    MBB_AGENT_F32(MBB_DECL_F)
    MBB_AGENT_I32(MBB_DECL_I)
};

struct World {
    Agent ag[NUM_AGENTS];
    MBB_BALL_F32(MBB_DECL_F)
    MBB_BALL_I32(MBB_DECL_I)
    MBB_GAME_F32(MBB_DECL_F)
    MBB_GAME_I32(MBB_DECL_I)
    MBB_HOOP_F32(MBB_DECL_F)
    MBB_HOOP_I32(MBB_DECL_I)
};

MBB_HD void load_world(World &s,
                                           const float *__restrict__ sf,
                                           const int *__restrict__ si,
                                           int W, int w) {
    int rf = 0, ri = 0;
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
#define MBB_LF(n) s.ag[i].n = sf[(size_t)(rf++) * W + w];
#define MBB_LI(n) s.ag[i].n = si[(size_t)(ri++) * W + w];
        MBB_AGENT_F32(MBB_LF)
        MBB_AGENT_I32(MBB_LI)
#undef MBB_LF
#undef MBB_LI
    }
#define MBB_LF(n) s.n = sf[(size_t)(rf++) * W + w];
#define MBB_LI(n) s.n = si[(size_t)(ri++) * W + w];
    MBB_BALL_F32(MBB_LF) MBB_BALL_I32(MBB_LI)
    MBB_GAME_F32(MBB_LF) MBB_GAME_I32(MBB_LI)
    MBB_HOOP_F32(MBB_LF) MBB_HOOP_I32(MBB_LI)
#undef MBB_LF
#undef MBB_LI
}

MBB_HD void store_world(const World &s,
                                            float *__restrict__ sf,
                                            int *__restrict__ si, int W,
                                            int w) {
    int rf = 0, ri = 0;
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
#define MBB_SF(n) sf[(size_t)(rf++) * W + w] = s.ag[i].n;
#define MBB_SI(n) si[(size_t)(ri++) * W + w] = s.ag[i].n;
        MBB_AGENT_F32(MBB_SF)
        MBB_AGENT_I32(MBB_SI)
#undef MBB_SF
#undef MBB_SI
    }
#define MBB_SF(n) sf[(size_t)(rf++) * W + w] = s.n;
#define MBB_SI(n) si[(size_t)(ri++) * W + w] = s.n;
    MBB_BALL_F32(MBB_SF) MBB_BALL_I32(MBB_SI)
    MBB_GAME_F32(MBB_SF) MBB_GAME_I32(MBB_SI)
    MBB_HOOP_F32(MBB_SF) MBB_HOOP_I32(MBB_SI)
#undef MBB_SF
#undef MBB_SI
}

// ---------------------------------------------------------------- Philox

// Philox4x32-10 (Salmon et al., SC'11), the in-kernel noise of kernels B
// and F; ops/fused_rollout.py::philox4x32 is the plain twin.
MBB_HD void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
        const uint32_t lo0 = 0xD2511F53u * c[0];
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
        const uint32_t lo1 = 0xCD9E8D57u * c[2];
        const uint32_t n0 = hi1 ^ c[1] ^ k0;
        const uint32_t n2 = hi0 ^ c[3] ^ k1;
        c[0] = n0;
        c[1] = lo1;
        c[2] = n2;
        c[3] = lo0;
    }
}

// uint32 bits -> float in [0, 1): 23 mantissa bits under 1.0's exponent.
MBB_HD float bits_to_unit(uint32_t b) {
    return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// ---------------------------------------------------------------- helpers

MBB_HD float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}
MBB_HD float rsqrt_safe(float x) {
    return rsqrtf(fmaxf(x, 1e-30f));
}
MBB_HD float signf(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// ops/tmath.py::atan - 11th-order odd minimax polynomial
MBB_HD float t_atan(float x) {
    float ax = fabsf(x);
    bool big = ax > 1.0f;
    float t = big ? 1.0f / fmaxf(ax, 1e-30f) : ax;
    float r = t * t;
    float p = -0.0117212f * r + 0.05265332f;
    p = p * r - 0.11643287f;
    p = p * r + 0.19354346f;
    p = p * r - 0.33262347f;
    p = p * r + 0.99997726f;
    float a = t * p;
    a = big ? HALF_PI - a : a;
    return x < 0.0f ? -a : a;
}

// ops/tmath.py::erf - Abramowitz & Stegun 7.1.26
MBB_HD float t_erf(float x) {
    float s = signf(x);
    float ax = fabsf(x);
    float t = 1.0f / (1.0f + 0.3275911f * ax);
    float p = 1.061405429f * t - 1.453152027f;
    p = p * t + 1.421413741f;
    p = p * t - 0.284496736f;
    p = p * t + 0.254829592f;
    float y = 1.0f - p * t * expf(-ax * ax);
    return s * y;
}

struct Fwd { float x, y, z; };

// rotate (0,1,0) by q
MBB_HD Fwd fwd_from_quat(float qw, float qx, float qy,
                                             float qz) {
    return {2.0f * (qx * qy - qw * qz), 1.0f - 2.0f * (qx * qx + qz * qz),
            2.0f * (qy * qz + qw * qx)};
}

// quat (w, 0, 0, z) aligning (0,1,0) with the unit in-plane (tx, ty)
MBB_HD void rot_fwd_to(float tx, float ty, float &qw,
                                           float &qz) {
    float d = clampf(ty, -1.0f, 1.0f);
    float w = sqrtf(fmaxf((1.0f + d) * 0.5f, 0.0f));
    float z = -signf(tx) * sqrtf(fmaxf((1.0f - d) * 0.5f, 0.0f));
    qw = d > 0.999999f ? 1.0f : (d < -0.999999f ? 0.0f : w);
    qz = d > 0.999999f ? 0.0f : (d < -0.999999f ? 1.0f : z);
}

MBB_HD int shot_point_value(const SimParams &p, float px,
                                                float py, float hx, float hy,
                                                bool left_hoop) {
    float dx = px - hx;
    float dy = py - hy;
    float dist = sqrtf(dx * dx + dy * dy);
    bool in_corner = (py < p.corner_lo_y) || (py > p.corner_hi_y);
    bool corner3 = left_hoop ? (in_corner && px <= p.corner_left_x)
                             : (in_corner && px >= p.corner_right_x);
    return (corner3 || dist >= 7.24f) ? 3 : 2;
}

MBB_HD void to_center(const SimParams &p, float px,
                                          float py, float &cx, float &cy) {
    float dx = p.start_x - px;
    float dy = p.start_y - py;
    float inv = rsqrt_safe(dx * dx + dy * dy);
    cx = dx * inv;
    cy = dy * inv;
}

// src/game.cpp:14-53
MBB_HD void assign_inbounder(World &s, bool active,
                                                 int new_team, float spot_x,
                                                 float spot_y, float spot_z,
                                                 float qw, float qz,
                                                 bool is_oob) {
    bool assigned = false;
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        bool take = active && a.team == new_team && !assigned;
        if (take) {
            a.im_inb = 1;
            a.pos_x = spot_x;
            a.pos_y = spot_y;
            a.pos_z = spot_z;
            a.has_ball = 1;
            a.held_ball = BALL_ID;
            a.quat_w = qw;
            a.quat_x = 0.0f;
            a.quat_y = 0.0f;
            a.quat_z = qz;
            s.bgrabbed = 1;
            s.bholder = agent_id(i);
        }
        assigned = assigned || take;
    }
    bool found = active && assigned;
    if (found) {
        s.tip = (float)new_team;
        s.ginb = 1;
        s.iclock = 5.0f;
    }
    if (is_oob) s.oob = s.oob + (found ? 1.0f : 0.0f);
}

// src/gen.cpp:216-316 + src/helper.cpp:108-160: the resetWorld of one world
MBB_HD void reset_world(const SimParams &p, World &s,
                                            const float *noise) {
    bool rollover = s.gclock <= 0.0f && s.is1v1 == 0;
    bool cont = s.period < 4.0f || s.t0score == s.t1score;
    bool rc = rollover && cont;
    if (rollover) {
        if (rc) {
            s.period = s.period + 1.0f;
            s.gclock = p.time_per_period;
            s.sclock = p.shot_clock;
            s.ginb = 0;
        }
        s.glive = rc ? 1 : 0;
    } else {
        s.period = 1.0f;
        s.gclock = p.time_per_period;
        s.sclock = p.shot_clock;
        s.glive = 1;
        s.ginb = 0;
        s.tip = 0.0f;
        s.t0score = 0.0f;
        s.t1score = 0.0f;
        s.sbaskets = 0.0f;
        s.oob = 0.0f;
        s.iclock = 0.0f;
    }

    bool one = s.is1v1 == 1;
    float x_dev = noise[6] * 5.0f;
    float y_dev = noise[7] * 5.0f;
    float p0x = clampf(p.start_x + x_dev, 0.0f, p.grid_w);
    float p0y = clampf(p.start_y + y_dev, 0.0f, p.grid_h);
    float angle = noise[8] * TWO_PI;
    float p1x = clampf(p0x + 8.0f * cosf(angle), 0.0f, p.grid_w);
    float p1y = clampf(p0y + 8.0f * sinf(angle), 0.0f, p.grid_h);

#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        a.a_move = a.a_angle = a.a_rotate = a.a_grab = a.a_pass =
            a.a_shoot = 0;
        a.m_move = a.m_grab = a.m_pass = a.m_shoot = 0;
        a.reset = 0;
        a.cur_step = 0;
        a.im_inb = 0;
        a.allowed_move = 1;
        a.done = 1.0f;
        a.quat_w = p.reset_qw;
        a.quat_x = 0.0f;
        a.quat_y = 0.0f;
        a.quat_z = (i % 2 == 0) ? -p.reset_qz : p.reset_qz;
        a.cooldown = 0.0f;
        a.stat_points = 0.0f;
        a.stat_fouls = 0.0f;
        a.vel_x = a.vel_y = a.vel_z = 0.0f;
        a.team = i % 2;
        a.color_r = (i % 2 == 0) ? 0.0f : 255.0f;
        a.color_g = (i % 2 == 0) ? 100.0f : 0.0f;
        a.color_b = (i % 2 == 0) ? 255.0f : 100.0f;
        a.defend_hoop = (i % 2 == 0) ? s.t0hoop : s.t1hoop;
        // _setup_agent_positions
        a.pos_x = one ? (i == 0 ? p0x : p1x) : (i == 0 ? p.grid_x0 : p.grid_x1);
        a.pos_y = one ? (i == 0 ? p0y : p1y) : p.grid_y0;
        a.pos_z = 0.0f;
        a.has_ball = i == 0 ? 1 : 0;
        a.held_ball = i == 0 ? BALL_ID : PLACEHOLDER;
        a.points_worth = 2;
        a.max_speed = i == 0 ? 3.0f : 2.799999952316284f;
        a.quickness = 1.0f;
        a.shooting = 0.0f;
        a.ft_pct = 0.0f;
        a.reaction = i * 10.0f;
        a.target_x = a.pos_x;
        a.target_y = a.pos_y;
        a.target_z = a.pos_z;
        a.shot_pct = 0.0f;
    }
    s.bpos_x = one ? s.ag[0].pos_x : p.start_x;
    s.bpos_y = one ? s.ag[0].pos_y : p.start_y;
    s.bpos_z = 0.0f;
    s.breset = 0;
    s.bdone = 1.0f;
    s.bcur_step = 0;
    s.binflight = 0;
    s.blt_agent = s.blt_team = s.bsb_agent = s.bsb_team = PLACEHOLDER;
    s.bspv = 2;
    s.bsgi = 0;
    s.bvel_x = s.bvel_y = s.bvel_z = 0.0f;
    s.bgrabbed = one ? 1 : 0;
    s.bholder = one ? agent_id(0) : PLACEHOLDER;
    s.hdone0 = s.hdone1 = 1.0f;
    s.hcur0 = s.hcur1 = s.hreset0 = s.hreset1 = 0;
}

// One 38-float agent block of the observation (fillObservations,
// src/game.cpp:1175-1461), written at obs rows r0..r0+37 of world w.
MBB_HD void obs_agent_block(const World &s,
                                                const Agent &tgt,
                                                const Agent &rel_to,
                                                bool self_block,
                                                float hoop_x, float hoop_y,
                                                float *__restrict__ obs,
                                                int r0, int W, int w) {
    int r = r0;
    auto put = [&](float v) { obs[(size_t)(r++) * W + w] = v; };
    put(tgt.pos_x);
    put(tgt.pos_y);
    put(tgt.pos_z);
    if (self_block) {
        put(0.0f); put(0.0f); put(0.0f); put(0.0f);
    } else {
        float rx = tgt.pos_x - rel_to.pos_x;
        float ry = tgt.pos_y - rel_to.pos_y;
        float rz = tgt.pos_z - rel_to.pos_z;
        float r2 = rx * rx + ry * ry + rz * rz;
        float inv = rsqrt_safe(r2);
        bool ok = r2 > 1e-6f;
        put(ok ? rx * inv : 0.0f);
        put(ok ? ry * inv : 0.0f);
        put(ok ? rz * inv : 0.0f);
        put(sqrtf(r2));
    }
    put(tgt.quat_w); put(tgt.quat_x); put(tgt.quat_y); put(tgt.quat_z);
    Fwd o = fwd_from_quat(tgt.quat_w, tgt.quat_x, tgt.quat_y, tgt.quat_z);
    put(o.x); put(o.y); put(o.z);
    float vx = tgt.vel_x, vy = tgt.vel_y, vz = tgt.vel_z;
    float v2 = vx * vx + vy * vy + vz * vz;
    float inv = rsqrt_safe(v2);
    bool okv = v2 > 1e-6f;
    float vnx = okv ? vx * inv : 0.0f;
    float vny = okv ? vy * inv : 0.0f;
    float vnz = okv ? vz * inv : 0.0f;
    put(vnx); put(vny); put(vnz); put(sqrtf(v2));
    float dot = okv ? vnx * o.x + vny * o.y + vnz * o.z : 0.0f;
    put(dot);
    put(dot <= 0.8f ? 0.1f : 1.0f);
    float hdx = hoop_x - tgt.pos_x;
    float hdy = hoop_y - tgt.pos_y;
    float hdz = -tgt.pos_z;
    float h2 = hdx * hdx + hdy * hdy + hdz * hdz;
    float hd = sqrtf(h2);
    inv = rsqrt_safe(h2);
    bool okh = hd > 1e-6f;
    put(okh ? hdx * inv : 0.0f);
    put(okh ? hdy * inv : 0.0f);
    put(okh ? hdz * inv : 0.0f);
    put(hd);
    float bdx = s.bpos_x - tgt.pos_x;
    float bdy = s.bpos_y - tgt.pos_y;
    float bdz = s.bpos_z - tgt.pos_z;
    float b2 = bdx * bdx + bdy * bdy + bdz * bdz;
    float bd = sqrtf(b2);
    inv = rsqrt_safe(b2);
    bool okb = bd > 1e-6f;
    put(okb ? bdx * inv : 0.0f);
    put(okb ? bdy * inv : 0.0f);
    put(okb ? bdz * inv : 0.0f);
    put(bd);
    put((float)tgt.im_inb);
    put(tgt.cooldown);
    put(tgt.max_speed);
    put(tgt.quickness);
    put(tgt.shooting);
    put(tgt.ft_pct);
    put(tgt.reaction);
    put(tgt.shot_pct);
    put((float)tgt.points_worth);
    put((float)tgt.has_ball);
}

// System 18, fillObservations (src/game.cpp:1175-1461), for agent i: its
// 128 obs rows i * 128 .. i * 128 + 127 of world w, written to
// obs[r * W + w].
MBB_HD void fill_observations_agent(const SimParams &p, const World &s,
                                    int i, float *__restrict__ obs, int W,
                                    int w) {
    const float h0x = p.h0x, h0y = p.h0y, h1x = p.h1x, h1y = p.h1y;
    int inbounder = -1;
#pragma unroll
    for (int j = 0; j < NUM_AGENTS; ++j)
        if (s.ag[j].im_inb > 0) inbounder = agent_id(j);
    {
        const Agent &a = s.ag[i];
        bool is0 = a.defend_hoop == HOOP_ID0;
        float ax = is0 ? h1x : h0x, ay = is0 ? h1y : h0y;
        float dxh = is0 ? h0x : h1x, dyh = is0 ? h0y : h1y;
        bool own0 = a.team == 0;
        int r = i * OBS_SIZE;
        auto put = [&](float v) { obs[(size_t)(r++) * W + w] = v; };
        put(s.gclock);
        put(s.sclock);
        put(s.period);
        put((float)s.ginb);
        put(s.iclock);
        put(own0 ? s.t0score : s.t1score);
        put(own0 ? s.t1score : s.t0score);
        put(s.bpos_x); put(s.bpos_y); put(s.bpos_z);
        put(s.bvel_x); put(s.bvel_y); put(s.bvel_z);
        put((float)s.bgrabbed);
        put((float)s.binflight);
        put((float)s.bspv);
        put((float)s.blt_team);
        put(ax); put(ay); put(0.0f);
        put(dxh); put(dyh); put(0.0f);
        obs_agent_block(s, a, a, true, ax, ay, obs, r, W, w);
        r += 38;
#pragma unroll
        for (int j = 0; j < NUM_AGENTS; ++j) {
            if (j == i) continue;
            obs_agent_block(s, s.ag[j], a, false, dxh, dyh, obs, r, W, w);
            r += 38;
        }
#pragma unroll
        for (int j = 0; j < NUM_AGENTS; ++j)
            put(s.bholder == agent_id(j) ? 1.0f : 0.0f);
#pragma unroll
        for (int j = 0; j < NUM_AGENTS; ++j)
            put(inbounder == agent_id(j) ? 1.0f : 0.0f);
        while (r < (i + 1) * OBS_SIZE) put(0.0f);
    }
}

// System 18 for both agents: the 256 obs rows of world w.
MBB_HD void fill_observations(const SimParams &p, const World &s,
                              float *__restrict__ obs, int W, int w) {
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i)
        fill_observations_agent(p, s, i, obs, W, w);
}

// One tick of world w.  `noise` holds the 9 noise values of this world
// (rows 0-5 shot deviations, 6-8 reset_u); the 256 obs rows go straight to
// obs[r * W + w].  COMPUTE_OBS = false skips system 18 and leaves obs
// untouched (the JAX step_fields' compute_obs, fused_step.py:273); no other
// system reads the obs, so the state comes out the same either way.
template <bool COMPUTE_OBS = true>
MBB_HD void step_world(const SimParams &p, World &s,
                                           const float *noise,
                                           float *__restrict__ obs, int W,
                                           int w) {
    const float h0x = p.h0x, h0y = p.h0y, h1x = p.h1x, h1y = p.h1y;

    // ---------------- 1. tick (src/game.cpp:969-988)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        bool was = a.reset == 1;
        a.reward = 0.0f;
        a.done = was ? 1.0f : 0.0f;
        a.cur_step = was ? 0 : a.cur_step + 1;
        a.cooldown = fmaxf(a.cooldown - 1.0f, 0.0f);
    }

    // ---------------- 2. actionMask (src/game.cpp:489-533)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        int can_move = 1, can_grab = 1;
        int can_pass = a.has_ball == 1 ? 1 : 0;
        int can_shoot = a.has_ball == 1 ? 1 : 0;
        bool inb = s.ginb == 1;
        if (inb) { can_shoot = 0; can_grab = 0; }
        if (inb && a.im_inb == 1 && s.glive == 0) can_move = 0;
        if (a.cooldown > 0.0f) can_grab = 0;
        if (p.tag_mode) { can_pass = 0; can_grab = 0; }
        a.m_move = can_move;
        a.m_grab = can_grab;
        a.m_pass = can_pass;
        a.m_shoot = can_shoot;
    }

    // ---------------- 3. moveAgent (src/game.cpp:410-486)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        if (a.a_rotate != 0) {
            float tz = a.a_rotate == 1 ? TURN_Z : -TURN_Z;
            float qw = a.quat_w, qx = a.quat_x, qy = a.quat_y, qz = a.quat_z;
            a.quat_w = TURN_W * qw - tz * qz;
            a.quat_x = TURN_W * qx - tz * qy;
            a.quat_y = TURN_W * qy + tz * qx;
            a.quat_z = TURN_W * qz + tz * qw;
        }
        bool active = a.m_move != 0;
        float move_angle = (float)a.a_angle * ANGLE_STEP;
        float scale = a.quickness * (float)a.a_move;
        float dvx = sinf(move_angle) * scale;
        float dvy = -cosf(move_angle) * scale;
        Fwd f = fwd_from_quat(a.quat_w, a.quat_x, a.quat_y, a.quat_z);
        float vx = a.vel_x, vy = a.vel_y, vz = a.vel_z;
        float vlen2 = vx * vx + vy * vy + vz * vz;
        float inv = rsqrt_safe(vlen2);
        float dot = vlen2 > 1e-6f ? (vx * f.x + vy * f.y + vz * f.z) * inv
                                  : 0.0f;
        bool backwards = dot < -0.1f;
        bool sideways = !backwards && dot <= 0.8f;
        float max_speed =
            a.max_speed * (backwards ? 0.1f : (sideways ? 0.7f : 1.0f));
        float dscale = (backwards || sideways) ? 0.1f : 1.0f;
        vx = vx + dvx * dscale;
        vy = vy + dvy * dscale;
        max_speed = max_speed * (a.has_ball == 1 ? 0.9f : 1.0f);
        float speed2 = vx * vx + vy * vy + vz * vz;
        float speed = sqrtf(speed2);
        float shrink = speed > max_speed ? max_speed * rsqrt_safe(speed2)
                                         : 1.0f;
        vx = vx * shrink;
        vy = vy * shrink;
        vz = vz * shrink;
        if (active) {
            a.pos_x = clampf(a.pos_x + vx * DT, 0.0f, p.grid_w);
            a.pos_y = clampf(a.pos_y + vy * DT, 0.0f, p.grid_h);
            a.vel_x = vx * 0.95f;
            a.vel_y = vy * 0.95f;
            a.vel_z = vz * 0.95f;
        }
    }

    // ---------------- 4. grab (src/game.cpp:164-239)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        int aid = agent_id(i);
        bool act = a.m_grab != 0 && a.a_grab != 0;
        if (act) { a.cooldown = 10.0f; a.a_grab = 0; }
        bool ball_act = act && s.binflight != 1;
        bool holding = a.has_ball == 1 && s.bgrabbed == 1 && s.bholder == aid;
        if (ball_act && holding) {
            a.has_ball = 0;
            a.held_ball = PLACEHOLDER;
            s.bgrabbed = 0;
            s.bholder = PLACEHOLDER;
        }
        float dx = s.bpos_x - a.pos_x;
        float dy = s.bpos_y - a.pos_y;
        float dz = s.bpos_z - a.pos_z;
        bool near = sqrtf(dx * dx + dy * dy + dz * dz) <= 0.3f;
        bool reach = ball_act && !holding && near;
        bool turnover = reach && s.is1v1 == 1 && (float)a.team != s.tip;
        if (turnover) s.reset_now = 1;
        bool take = reach && !turnover;
        if (take) {
#pragma unroll
            for (int j = 0; j < NUM_AGENTS; ++j) {
                Agent &v = s.ag[j];
                if (v.held_ball == BALL_ID) {
                    v.has_ball = 0;
                    v.held_ball = PLACEHOLDER;
                    v.cooldown = 62.0f;
                }
            }
            a.has_ball = 1;
            a.held_ball = BALL_ID;
            s.bholder = aid;
            s.bgrabbed = 1;
            s.binflight = 0;
            s.bvel_x = s.bvel_y = s.bvel_z = 0.0f;
            s.bsb_agent = PLACEHOLDER;
            s.bsb_team = PLACEHOLDER;
            s.bspv = 2;
            s.tip = (float)a.team;
            s.glive = 1;
        }
    }

    // ---------------- 5. pass (src/game.cpp:243-270)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        bool act = a.m_pass != 0 && a.a_pass != 0;
        bool hold = act && s.bholder == agent_id(i);
        if (hold) {
            a.has_ball = 0;
            a.held_ball = PLACEHOLDER;
            a.im_inb = 0;
            Fwd f = fwd_from_quat(a.quat_w, a.quat_x, a.quat_y, a.quat_z);
            s.bgrabbed = 0;
            s.bholder = PLACEHOLDER;
            s.bvel_x = f.x * 0.1f;
            s.bvel_y = f.y * 0.1f;
            s.bvel_z = f.z * 0.1f;
            s.ginb = 0;
        }
    }

    // ---------------- 6. shoot (src/game.cpp:273-407)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        int aid = agent_id(i);
        bool act = a.m_shoot != 0 && a.a_shoot != 0;
        bool is0 = a.defend_hoop == HOOP_ID0;
        float ax = is0 ? h1x : h0x, ay = is0 ? h1y : h0y;
        float ix = ax - a.pos_x;
        float iy = ay - a.pos_y;
        // The going-in test below compares dist2 - t_along^2, two ~140 m^2
        // terms, with 0.01 m^2, so one fused multiply-add more or less
        // decides some shots differently.  Every step of that chain (and
        // of the deviation it depends on) rounds as in the plain version,
        // ops/fused_step.py::shot_aim: the _rn intrinsics are never
        // contracted, and __fmaf_rn stands where the JAX reference's
        // XLA:CPU build contracts a sum of products.
        float dist2 = __fmaf_rn(ix, ix, __fmul_rn(iy, iy));
        float dist = sqrtf(dist2);
        float inv = rsqrt_safe(dist2);
        float sin_i = dist > 0.0f ? __fmul_rn(ix, inv) : 0.0f;
        float cos_i = dist > 0.0f ? __fmul_rn(iy, inv) : 1.0f;

        float dev = __fmul_rn(noise[3 * i + 0], __fmul_rn(0.008f, dist));
        float d_def = __builtin_huge_valf();
#pragma unroll
        for (int j = 0; j < NUM_AGENTS; ++j) {
            const Agent &o = s.ag[j];
            float ddx = a.pos_x - o.pos_x;
            float ddy = a.pos_y - o.pos_y;
            float ddz = a.pos_z - o.pos_z;
            float dd = sqrtf(__fadd_rn(
                __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)),
                __fmul_rn(ddz, ddz)));
            if (o.team != a.team) d_def = fminf(d_def, dd);
        }
        // torch evaluates 0.002 / x as reciprocal(x) * 0.002
        dev = __fadd_rn(dev, d_def < 2.0f
                                 ? __fmul_rn(noise[3 * i + 1],
                                             __fmul_rn(__frcp_rn(
                                                 d_def + 0.1f), 0.002f))
                                 : 0.0f);
        float vlen = sqrtf(__fadd_rn(
            __fadd_rn(__fmul_rn(a.vel_x, a.vel_x),
                      __fmul_rn(a.vel_y, a.vel_y)),
            __fmul_rn(a.vel_z, a.vel_z)));
        dev = __fadd_rn(dev, a.a_move > 0
                                 ? __fmul_rn(noise[3 * i + 2],
                                             __fmul_rn(0.001f, vlen))
                                 : 0.0f);
        // (sin(i+dev), cos(i+dev)) by angle addition (src/game.cpp:302,345)
        float sd = sinf(dev), cd = cosf(dev);
        float fvx = __fmaf_rn(sin_i, cd, __fmul_rn(cos_i, sd));
        float fvy = __fmaf_rn(cos_i, cd, -__fmul_rn(sin_i, sd));
        // t_along's own fvx, contracted on the other product (as XLA does
        // where it recomputes fvx inside t_along's fusion)
        float fvx_t = __fmaf_rn(cos_i, sd, __fmul_rn(sin_i, cd));
        float t_along = __fmaf_rn(ix, fvx_t, __fmul_rn(iy, fvy));
        float closest_sq = __fmaf_rn(-t_along, t_along, dist2);
        bool going_in = !(t_along < 0.0f) && closest_sq <= ZONE_R2;

        if (act) {
            float sqw, sqz;
            rot_fwd_to(fvx, fvy, sqw, sqz);
            a.quat_w = sqw;
            a.quat_x = 0.0f;
            a.quat_y = 0.0f;
            a.quat_z = sqz;
        }
        bool hold = act && s.bholder == aid;
        int spv = is0 ? shot_point_value(p, a.pos_x, a.pos_y, h1x, h1y, false)
                      : shot_point_value(p, a.pos_x, a.pos_y, h0x, h0y, true);
        bool made = hold && going_in;
        s.sbaskets = s.sbaskets + (made ? 1.0f : 0.0f);
        a.reward = a.reward + ((hold && !going_in) ? -1.0f : 0.0f);
        if (made) s.bsgi = 1;
        if (hold) {
            a.has_ball = 0;
            a.held_ball = PLACEHOLDER;
            a.im_inb = 0;
            s.bgrabbed = 0;
            s.bholder = PLACEHOLDER;
            // rounded here, so moveBall's bpos + bvel cannot fuse with it
            s.bvel_x = __fmul_rn(fvx, 0.1f);
            s.bvel_y = __fmul_rn(fvy, 0.1f);
            s.bvel_z = 0.0f;
            s.binflight = 1;
            s.bsb_agent = aid;
            s.bsb_team = a.team;
            s.bspv = spv;
            s.blt_agent = aid;
            s.blt_team = a.team;
        }
    }

    // ---------------- 7. moveBall (src/game.cpp:82-125)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        const Agent &a = s.ag[i];
        if (a.has_ball == 1 && s.bgrabbed == 1 && s.bholder == agent_id(i)) {
            s.bpos_x = a.pos_x;
            s.bpos_y = a.pos_y;
            s.bpos_z = a.pos_z;
        }
    }
    {
        float bvlen = sqrtf(s.bvel_x * s.bvel_x + s.bvel_y * s.bvel_y +
                            s.bvel_z * s.bvel_z);
        if (bvlen != 0.0f && s.bgrabbed != 1) {
            s.bpos_x = clampf(s.bpos_x + s.bvel_x, 0.0f, p.grid_w);
            s.bpos_y = clampf(s.bpos_y + s.bvel_y, 0.0f, p.grid_h);
            s.bpos_z = s.bpos_z + s.bvel_z;
        }
    }

    // ---------------- 8. updateCurrentShotPercentage (src/game.cpp:758-809)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        bool is0 = a.defend_hoop == HOOP_ID0;
        float ax = is0 ? h1x : h0x, ay = is0 ? h1y : h0y;
        float dx = ax - a.pos_x;
        float dy = ay - a.pos_y;
        float dist_hoop = sqrtf(dx * dx + dy * dy);
        float d_def = __builtin_huge_valf();
#pragma unroll
        for (int j = 0; j < NUM_AGENTS; ++j) {
            const Agent &o = s.ag[j];
            float ddx = a.pos_x - o.pos_x;
            float ddy = a.pos_y - o.pos_y;
            float dd = sqrtf(ddx * ddx + ddy * ddy);
            if (o.team != a.team) d_def = fminf(d_def, dd);
        }
        float dist_sd = 0.008f * dist_hoop;
        float def_sd = 0.002f / d_def + 1e-4f;
        float vel_sd = 0.001f * sqrtf(a.vel_x * a.vel_x + a.vel_y * a.vel_y +
                                      a.vel_z * a.vel_z);
        float final_sd = sqrtf(dist_sd * dist_sd / 3.0f +
                               def_sd * def_sd / 3.0f +
                               vel_sd * vel_sd / 3.0f);
        float max_make = t_atan(ZONE_R / dist_hoop);
        float pct = t_erf(max_make / final_sd / SQRT2);
        a.shot_pct = a.has_ball == 0 ? 0.0f : pct;
    }

    // ---------------- 9. score (src/game.cpp:873-953)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        const float hx = hi == 0 ? h0x : h1x;
        const float hy = hi == 0 ? h0y : h1y;
        float dx = s.bpos_x - hx;
        float dy = s.bpos_y - hy;
        bool scored = sqrtf(dx * dx + dy * dy) <= ZONE_R && s.binflight == 1;
        int points = s.bspv;
        int inb_team = 0;
#pragma unroll
        for (int j = 0; j < NUM_AGENTS; ++j) {
            Agent &o = s.ag[j];
            bool defends = o.defend_hoop == hi;
            if (defends) inb_team = o.team;
            bool shooter = scored && agent_id(j) == s.bsb_agent;
            float delta = (float)(defends ? -points : points);
            o.stat_points = o.stat_points + (shooter ? delta : 0.0f);
        }
        bool is_t0 = s.t0hoop == hi;
        s.t1score = s.t1score + ((scored && is_t0) ? (float)points : 0.0f);
        s.t0score = s.t0score + ((scored && !is_t0) ? (float)points : 0.0f);
        s.sbaskets = s.sbaskets + (scored ? 1.0f : 0.0f);
        float spot_x = is_t0 ? p.court_min_x : p.court_max_x;
        float spot_y = p.spot_y;
        if (scored) {
            s.binflight = 0;
            s.bvel_x = s.bvel_y = s.bvel_z = 0.0f;
            s.bsb_agent = PLACEHOLDER;
            s.bsb_team = PLACEHOLDER;
            s.bspv = 2;
            s.bsgi = 0;
        }
        bool full = scored && s.is1v1 == 0;
        if (full) {
            s.bpos_x = spot_x;
            s.bpos_y = spot_y;
            s.bpos_z = 0.0f;
        }
        float cx, cy, qw, qz;
        to_center(p, spot_x, spot_y, cx, cy);
        rot_fwd_to(cx, cy, qw, qz);
        assign_inbounder(s, full, inb_team, spot_x, spot_y, 0.0f, qw, qz,
                         false);
        if (scored && s.is1v1 != 0) s.reset_now = 1;
    }

    // ---------------- 10. outOfBounds (src/game.cpp:1055-1113)
    {
        bool oob = s.bpos_x < p.court_min_x || s.bpos_x > p.court_max_x ||
                   s.bpos_y < p.court_min_y || s.bpos_y > p.court_max_y;
        bool trigger = oob && s.ginb == 0;
        bool one = trigger && s.is1v1 == 1;
        bool off1 = (float)s.ag[1].team == s.tip;
        float pen = one ? -100.0f : 0.0f;
        s.ag[0].reward = s.ag[0].reward + (off1 ? 0.0f : pen);
        s.ag[1].reward = s.ag[1].reward + (off1 ? pen : 0.0f);
        if (one) s.reset_now = 1;

        bool full = trigger && s.is1v1 != 1;
        if (full) {
            s.binflight = 0;
            s.bvel_x = s.bvel_y = s.bvel_z = 0.0f;
            s.glive = 0;
        }
        int new_team = 1 - s.blt_team;
#pragma unroll
        for (int i = 0; i < NUM_AGENTS; ++i) {
            Agent &a = s.ag[i];
            bool carrier = full && a.has_ball == 1 && a.held_ball == BALL_ID;
            float cx, cy;
            to_center(p, a.pos_x, a.pos_y, cx, cy);
            if (carrier) {
                a.pos_x = a.pos_x + cx;
                a.pos_y = a.pos_y + cy;
                a.has_ball = 0;
                a.held_ball = PLACEHOLDER;
            }
        }
        float cx, cy, qw, qz;
        to_center(p, s.bpos_x, s.bpos_y, cx, cy);
        rot_fwd_to(cx, cy, qw, qz);
        assign_inbounder(s, full, new_team, s.bpos_x, s.bpos_y, s.bpos_z, qw,
                         qz, true);
    }

    // ---------------- 11. updateLastTouch (src/game.cpp:1034-1051)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        const Agent &a = s.ag[i];
        float dx = s.bpos_x - a.pos_x;
        float dy = s.bpos_y - a.pos_y;
        float dz = s.bpos_z - a.pos_z;
        if (sqrtf(dx * dx + dy * dy + dz * dz) <= 0.2f) {
            s.blt_agent = agent_id(i);
            s.blt_team = a.team;
        }
    }

    // ---------------- 12. clock (src/game.cpp:992-1030)
    {
        bool run = s.glive > 0 && s.gclock > 0.0f;
        if (run) {
            s.gclock = s.gclock - DT;
            s.sclock = s.sclock - DT;
        }
        if (s.ginb > 0) s.iclock = s.iclock - DT;
        bool expire = s.gclock <= 0.0f && s.glive > 0;
        bool off1 = (float)s.ag[1].team == s.tip;
        float bonus = expire ? 10.0f : 0.0f;
        s.ag[0].reward = s.ag[0].reward + (off1 ? 0.0f : bonus);
        s.ag[1].reward = s.ag[1].reward + (off1 ? bonus : 0.0f);
        if (expire) s.reset_now = 1;
        if (s.sclock < 0.0f) s.sclock = 0.0f;
    }

    // ---------------- 13. inboundViolation (src/game.cpp:1116-1157)
    {
        bool trig = s.ginb > 0 && s.iclock <= 0.0f;
        int new_team = 1 - (int)s.tip;
        if (trig) s.glive = 0;
        int ball_to_turnover = PLACEHOLDER;
#pragma unroll
        for (int i = 0; i < NUM_AGENTS; ++i) {
            Agent &a = s.ag[i];
            bool was = trig && a.im_inb > 0;
            float cx, cy;
            to_center(p, a.pos_x, a.pos_y, cx, cy);
            if (was) {
                ball_to_turnover = a.held_ball;
                a.im_inb = 0;
                a.has_ball = 0;
                a.held_ball = PLACEHOLDER;
                a.pos_x = a.pos_x + cx;
                a.pos_y = a.pos_y + cy;
            }
        }
        bool do_t = trig && ball_to_turnover == BALL_ID;
        if (do_t) {
            s.bgrabbed = 0;
            s.bholder = PLACEHOLDER;
        }
        float cx, cy, qw, qz;
        to_center(p, s.bpos_x, s.bpos_y, cx, cy);
        rot_fwd_to(cx, cy, qw, qz);
        assign_inbounder(s, do_t, new_team, s.bpos_x, s.bpos_y, s.bpos_z, qw,
                         qz, true);
    }

    // ---------------- 14. reset (src/game.cpp:957-967)
    if (s.reset_now == 1) {
        reset_world(p, s, noise);
        s.reset_now = 0;
    }

    // ---------------- 15. updatePointsWorth (src/game.cpp:129-161)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        a.points_worth =
            a.defend_hoop == HOOP_ID0
                ? shot_point_value(p, a.pos_x, a.pos_y, h1x, h1y, false)
                : shot_point_value(p, a.pos_x, a.pos_y, h0x, h0y, true);
    }

    // ---------------- 16. agentCollision (src/game.cpp:537-648)
    {
        Agent &a0 = s.ag[0];
        Agent &a1 = s.ag[1];
        Fwd fa = fwd_from_quat(a0.quat_w, a0.quat_x, a0.quat_y, a0.quat_z);
        Fwd fb = fwd_from_quat(a1.quat_w, a1.quat_x, a1.quat_y, a1.quat_z);
        float fxa = fa.x, fya = fa.y, rxa = fa.y, rya = -fa.x;
        float fxb = fb.x, fyb = fb.y, rxb = fb.y, ryb = -fb.x;
        // corners (-d+w, -d-w, +d-w, +d+w), src/game.cpp:564-569
        float vax[4], vay[4], vbx[4], vby[4];
        const float sd[4] = {-1.0f, -1.0f, 1.0f, 1.0f};
        const float sw[4] = {1.0f, -1.0f, -1.0f, 1.0f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            vax[c] = sd[c] < 0.0f
                         ? (sw[c] > 0.0f ? a0.pos_x - fxa * HD + rxa * HW
                                         : a0.pos_x - fxa * HD - rxa * HW)
                         : (sw[c] > 0.0f ? a0.pos_x + fxa * HD + rxa * HW
                                         : a0.pos_x + fxa * HD - rxa * HW);
            vay[c] = sd[c] < 0.0f
                         ? (sw[c] > 0.0f ? a0.pos_y - fya * HD + rya * HW
                                         : a0.pos_y - fya * HD - rya * HW)
                         : (sw[c] > 0.0f ? a0.pos_y + fya * HD + rya * HW
                                         : a0.pos_y + fya * HD - rya * HW);
            vbx[c] = sd[c] < 0.0f
                         ? (sw[c] > 0.0f ? a1.pos_x - fxb * HD + rxb * HW
                                         : a1.pos_x - fxb * HD - rxb * HW)
                         : (sw[c] > 0.0f ? a1.pos_x + fxb * HD + rxb * HW
                                         : a1.pos_x + fxb * HD - rxb * HW);
            vby[c] = sd[c] < 0.0f
                         ? (sw[c] > 0.0f ? a1.pos_y - fyb * HD + ryb * HW
                                         : a1.pos_y - fyb * HD - ryb * HW)
                         : (sw[c] > 0.0f ? a1.pos_y + fyb * HD + ryb * HW
                                         : a1.pos_y + fyb * HD - ryb * HW);
        }
        float axes_x[4] = {rxa, fxa, rxb, fxb};
        float axes_y[4] = {rya, fya, ryb, fyb};
        bool colliding = true;
        float min_ov = FLT_BIG;
        float mtv_x = 0.0f, mtv_y = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float inv = rsqrt_safe(axes_x[k] * axes_x[k] +
                                   axes_y[k] * axes_y[k]);
            float axx = axes_x[k] * inv, axy = axes_y[k] * inv;
            float pa[4], pb[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                pa[c] = vax[c] * axx + vay[c] * axy;
                pb[c] = vbx[c] * axx + vby[c] * axy;
            }
            float pa_min = fminf(fminf(pa[0], pa[1]), fminf(pa[2], pa[3]));
            float pa_max = fmaxf(fmaxf(pa[0], pa[1]), fmaxf(pa[2], pa[3]));
            float pb_min = fminf(fminf(pb[0], pb[1]), fminf(pb[2], pb[3]));
            float pb_max = fmaxf(fmaxf(pb[0], pb[1]), fmaxf(pb[2], pb[3]));
            colliding = colliding && pa_max > pb_min && pb_max > pa_min;
            float overlap = fminf(pa_max, pb_max) - fmaxf(pa_min, pb_min);
            if (overlap < min_ov) {
                min_ov = overlap;
                mtv_x = axx;
                mtv_y = axy;
            }
        }
        if (p.tag_mode) {
            bool hit = colliding && s.tip == (float)a0.team;
            a0.reward = a0.reward + (hit ? -10.0f : 0.0f);
            a1.reward = a1.reward + (hit ? 10.0f : 0.0f);
            if (hit) s.reset_now = 1;
        }
        float c2cx = a1.pos_x - a0.pos_x;
        float c2cy = a1.pos_y - a0.pos_y;
        if (c2cx * mtv_x + c2cy * mtv_y < 0.0f) {
            mtv_x = -mtv_x;
            mtv_y = -mtv_y;
        }
        float corr_x = mtv_x * min_ov * 0.5f;
        float corr_y = mtv_y * min_ov * 0.5f;
        if (colliding) {
            a0.pos_x = a0.pos_x - corr_x;
            a0.pos_y = a0.pos_y - corr_y;
            a1.pos_x = a1.pos_x + corr_x;
            a1.pos_y = a1.pos_y + corr_y;
        }
    }

    // ---------------- 17. hardCodeDefense (src/game.cpp:651-755)
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        bool on_off = s.tip == (float)a.team;
        bool found = false;
        float off_x = 0.0f, off_y = 0.0f;
#pragma unroll
        for (int j = 0; j < NUM_AGENTS; ++j) {
            if (s.ag[j].has_ball == 1 && !found) {
                off_x = s.ag[j].pos_x;
                off_y = s.ag[j].pos_y;
                found = true;
            }
        }
        bool is0 = a.defend_hoop == HOOP_ID0;
        float mhx = is0 ? h0x : h1x;
        float mhy = is0 ? h0y : h1y;
        float hdx = mhx - off_x;
        float hdy = mhy - off_y;
        float hlen2 = hdx * hdx + hdy * hdy;
        float inv = rsqrt_safe(hlen2);
        float gx = hlen2 > 1e-6f ? off_x + 0.2f * hdx * inv : off_x;
        float gy = hlen2 > 1e-6f ? off_y + 0.2f * hdy * inv : off_y;
        bool chase = !on_off && found;
        float interp = a.reaction * DT;
        float tx = chase ? a.target_x + (gx - a.target_x) * interp : a.target_x;
        float ty = chase ? a.target_y + (gy - a.target_y) * interp : a.target_y;
        float mvx = tx - a.pos_x;
        float mvy = ty - a.pos_y;
        float mvz = a.target_z - a.pos_z;
        bool small = (mvx * mvx + mvy * mvy + mvz * mvz) < 0.01f;
        bool act_move = chase && !small;
        float dinv = rsqrt_safe(mvx * mvx + mvy * mvy + mvz * mvz);
        float dx_n = mvx * dinv;
        float dy_n = mvy * dinv;
        const float dir_x[8] = {0.0f, S2, 1.0f, S2, 0.0f, -S2, -1.0f, -S2};
        const float dir_y[8] = {-1.0f, -S2, 0.0f, S2, 1.0f, S2, 0.0f, -S2};
        int best = 0;
        float max_dot = -2.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            float cur = dx_n * dir_x[k] + dy_n * dir_y[k];
            if (cur > max_dot) {
                max_dot = cur;
                best = k;
            }
        }
        Fwd ov = fwd_from_quat(a.quat_w, a.quat_x, a.quat_y, a.quat_z);
        // acos(dot) > pi/8  <=>  dot < cos(pi/8)
        bool big_angle = (ov.x * dx_n + ov.y * dy_n) < COS_PI_8;
        float cross = ov.x * mvy - ov.y * mvx;
        int rot = cross < 0.0f ? -1 : (cross > 0.0f ? 1 : 0);
        rot = big_angle ? rot : 0;
        a.a_move = on_off ? 0 : (!found ? 0 : (small ? 0 : 1));
        if (act_move) {
            a.a_angle = best;
            a.a_rotate = rot;
        }
        if (!on_off) a.a_grab = 1;
        a.target_x = tx;
        a.target_y = ty;
    }

    // ---------------- 18. fillObservations (src/game.cpp:1175-1461)
    if constexpr (COMPUTE_OBS) fill_observations(p, s, obs, W, w);

    // ---------------- 19. reward (src/game.cpp:811-870)
    float new_reward[NUM_AGENTS];
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        const Agent &a = s.ag[i];
        const Agent &o = s.ag[1 - i];
        float ddx = o.pos_x - a.pos_x;
        float ddy = o.pos_y - a.pos_y;
        float ddz = o.pos_z - a.pos_z;
        float dist_other = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
        bool on_off = (float)a.team == s.tip;
        bool off_act = on_off && s.gclock > 5.0f;
        bool mine = s.bsb_agent == agent_id(i);
        bool made = mine && s.bsgi == 1;
        bool missing = mine && s.bsgi == 0 && s.binflight == 1;
        float r = a.reward;
        r = r + ((off_act && made) ? (float)s.bspv : 0.0f);
        r = r - ((off_act && missing) ? 1.0f : 0.0f);
        r = r + (off_act ? a.shot_pct : 0.0f);
        r = r + (!on_off ? -1.0f + expf(-0.4f * dist_other) : 0.0f);
        new_reward[i] = r;
    }
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) s.ag[i].reward = new_reward[i];
}


// ---------------------------------------------------------------- kernel F

// Kernel F (fused_multistep.cu) steps a tile of MS_TILE worlds per CTA for
// K ticks; each world's state stays in the registers of one thread of the
// sim warp.  The pieces below are the work of each warp role, written for
// one lane (world `lane` of the tile) so that the host build
// (host_step.cpp) runs them in the card's order: per tick, the sim warp
// steps its worlds (and, with obs every tick, stores the snapshot of what
// system 18 reads), the noise warp fills the ring slot of the next tick,
// and the obs warps turn the previous tick's snapshot into obs rows in a
// shared-memory tile; then a CTA barrier.
//
// Noise: tick t takes its 9 values from rows t * NOISE_CHUNK .. + 8 of
// `ext` ((K * NOISE_CHUNK, W), the JAX pack_multistep_noise layout) when it
// is not null, else from Philox with key (k0, k1) and counter
// (w, tick_base + t, group, 0), groups 0-2: kernel B's first 9 draws,
// rows 0-7 as 2u - 1 and row 8 as u.  The counter does not depend on K, so
// one K-tick launch equals K one-tick launches.
constexpr int NOISE_CHUNK = 16;
constexpr int MS_TILE = 32;                         // worlds per CTA
constexpr int MS_RING_SLOT = N_NOISE_ROWS * MS_TILE;  // one tick's noise

// What system 18 reads of a world: 22 fields per agent and 18 of the game
// and ball, 62 rows of the snapshot (row-major, MS_TILE lanes a row).
#define MBB_SNAP_AGENT_F32(X)                                                 \
    X(pos_x) X(pos_y) X(pos_z) X(vel_x) X(vel_y) X(vel_z) X(quat_w)            \
    X(quat_x) X(quat_y) X(quat_z) X(cooldown) X(max_speed) X(quickness)        \
    X(shooting) X(ft_pct) X(reaction) X(shot_pct)
#define MBB_SNAP_AGENT_I32(X)                                                 \
    X(im_inb) X(points_worth) X(has_ball) X(team) X(defend_hoop)
#define MBB_SNAP_WORLD_F32(X)                                                 \
    X(gclock) X(sclock) X(period) X(iclock) X(t0score) X(t1score) X(bpos_x)    \
    X(bpos_y) X(bpos_z) X(bvel_x) X(bvel_y) X(bvel_z)
#define MBB_SNAP_WORLD_I32(X)                                                 \
    X(ginb) X(bgrabbed) X(binflight) X(bspv) X(blt_team) X(bholder)
constexpr int SNAP_ROWS = 62;
constexpr int MS_SNAP_SLOT = SNAP_ROWS * MS_TILE;

// Agent blank_agent's six action fields zeroed (-1: none; the per-step
// trainee write of the reference benchmark), by value selects: an indexed
// store would put the World in local memory.
MBB_HD void blank_actions(World &s, int blank_agent) {
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        Agent &a = s.ag[i];
        const bool b = i == blank_agent;
        a.a_move = b ? 0 : a.a_move;
        a.a_angle = b ? 0 : a.a_angle;
        a.a_rotate = b ? 0 : a.a_rotate;
        a.a_grab = b ? 0 : a.a_grab;
        a.a_pass = b ? 0 : a.a_pass;
        a.a_shoot = b ? 0 : a.a_shoot;
    }
}

// Noise warp: tick t's 9 values of world w into a ring slot.
MBB_HD void draw_tick_noise(float *__restrict__ slot, int lane,
                            const float *__restrict__ ext, int t,
                            int tick_base, uint32_t k0, uint32_t k1, int W,
                            int w) {
    if (ext != nullptr) {
        const float *e = ext + (size_t)t * NOISE_CHUNK * W + w;
#pragma unroll
        for (int r = 0; r < N_NOISE_ROWS; ++r)
            slot[r * MS_TILE + lane] = e[(size_t)r * W];
        return;
    }
    float u[12];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
        uint32_t c[4] = {(uint32_t)w, (uint32_t)(tick_base + t), (uint32_t)g,
                         0u};
        philox4x32_10(c, k0, k1);
#pragma unroll
        for (int q = 0; q < 4; ++q) u[4 * g + q] = bits_to_unit(c[q]);
    }
#pragma unroll
    for (int r = 0; r < N_NOISE_ROWS - 1; ++r)
        slot[r * MS_TILE + lane] = 2.0f * u[r] - 1.0f;
    slot[(N_NOISE_ROWS - 1) * MS_TILE + lane] = u[N_NOISE_ROWS - 1];
}

// Sim warp: one tick of the world in registers, noise from the ring slot,
// systems 1-17 and 19 (system 18 runs from the snapshot, or once after the
// last tick).
MBB_HD void sim_tick(const SimParams &p, World &s,
                     const float *__restrict__ slot, int lane,
                     int blank_agent) {
    blank_actions(s, blank_agent);
    float nz[N_NOISE_ROWS];
#pragma unroll
    for (int r = 0; r < N_NOISE_ROWS; ++r) nz[r] = slot[r * MS_TILE + lane];
    step_world<false>(p, s, nz, nullptr, 0, 0);
}

// Sim warp, obs every tick: what system 18 reads of the post-tick state.
// System 19 writes only the rewards, which the obs do not read, so this
// snapshot after the whole tick gives system 18's obs.
MBB_HD void store_obs_snapshot(const World &s, float *__restrict__ snap,
                               int lane) {
    int r = 0;
#define MBB_PF(n) snap[(r++) * MS_TILE + lane] = a.n;
#define MBB_PI(n) snap[(r++) * MS_TILE + lane] = __int_as_float(a.n);
#pragma unroll
    for (int i = 0; i < NUM_AGENTS; ++i) {
        const Agent &a = s.ag[i];
        MBB_SNAP_AGENT_F32(MBB_PF) MBB_SNAP_AGENT_I32(MBB_PI)
    }
#undef MBB_PF
#undef MBB_PI
#define MBB_PF(n) snap[(r++) * MS_TILE + lane] = s.n;
#define MBB_PI(n) snap[(r++) * MS_TILE + lane] = __int_as_float(s.n);
    MBB_SNAP_WORLD_F32(MBB_PF) MBB_SNAP_WORLD_I32(MBB_PI)
#undef MBB_PF
#undef MBB_PI
}

// Obs warp i: agent i's 128 obs rows of world `lane` from a snapshot, into
// the shared tile (row r at tile[r * MS_TILE + lane]).
MBB_HD void obs_from_snapshot(const SimParams &p,
                              const float *__restrict__ snap, int i,
                              float *__restrict__ tile, int lane) {
    World s = {};
    int r = 0;
#define MBB_GF(n) a.n = snap[(r++) * MS_TILE + lane];
#define MBB_GI(n) a.n = __float_as_int(snap[(r++) * MS_TILE + lane]);
#pragma unroll
    for (int j = 0; j < NUM_AGENTS; ++j) {
        Agent &a = s.ag[j];
        MBB_SNAP_AGENT_F32(MBB_GF) MBB_SNAP_AGENT_I32(MBB_GI)
    }
#undef MBB_GF
#undef MBB_GI
#define MBB_GF(n) s.n = snap[(r++) * MS_TILE + lane];
#define MBB_GI(n) s.n = __float_as_int(snap[(r++) * MS_TILE + lane]);
    MBB_SNAP_WORLD_F32(MBB_GF) MBB_SNAP_WORLD_I32(MBB_GI)
#undef MBB_GF
#undef MBB_GI
    // a constant agent index, so that this World stays in registers
    if (i == 0)
        fill_observations_agent(p, s, 0, tile, MS_TILE, lane);
    else
        fill_observations_agent(p, s, 1, tile, MS_TILE, lane);
}

}  // namespace mbb
