// Kernel K7: the event loop of the single-excess-proton water model.
//
// Replaces the event loop of the TPU kernel
// cmdlmc_tpu/ops/water_sweep.py::_make_kernel (pallas_call at
// ops/water_sweep.py:506; ev_iter and frame_body, :169-393) in rows
// semantics. B4 also rebuilds each frame's [N, N] distances and K-nearest
// tables inside every replica tile; here those tables come once per frame
// for all replicas from K5 (csrc/knn_tables.cu, no cutoff) and the transform
// (ops/water_sweep.py::water_tables), [B, K, N] with sites last, and this
// kernel reads them from global memory (L2) by index.
//
// Three kernels, launched back to back by cmdlmc_water_sweep:
//   * water_prefix_kernel, once per block of frames: the site prefix sum
//     after every frame, s[b] = s[b - 1] + minimg(pos[b] - pos[b - 1]), as
//     a [B, N, 3] table (0.66 MB at N=216, 5.3 MB at N=1728, held in L2),
//     and its last row as s_out. One thread per site and axis walks the
//     frames in order, so each row has the reference's additions in the
//     reference's order (kmc_common.cuh::step_prefix) and its bits; it loads
//     eight frames ahead and takes the minimum images without a division
//     (kmc_common.cuh::minimg_near, bit-equal to minimg).
//   * water_pack_kernel: each site's K entries of topd, resc and topi in one
//     48-byte record per frame ([B, N, 3] float4), so that a replica reads
//     its site's row in two 32-byte sectors, not 3 K scattered ones (the
//     loop's loads are gathers at random sites, and their sectors bounded
//     it);
//   * water_sweep_kernel: one thread runs one replica through the whole block
//     of frames; its state is a handful of registers (site, last site, frames
//     since the jump, waiting frames, jumps, events, u, the d_OH correction
//     and the displacement base). It reads the prefix table only at an event
//     (s[b][site] - s[b][dst]), so it has no shared memory and no barrier,
//     and narrow blocks (BLOCK_THREADS) spread the replicas over every SM.
// Per frame, up to max_events event iterations: the 3 candidates of the
// current site (the K table entries at the site; the relaxation blend
// d + clip(fsj / relax, 0, 1) (r - d); the connection back to the last site
// kept rescaled, with the slot-3 -> 2 promotion at K = 4 or, at K = 3,
// check_from_old against the last site's row; the law on the first 3; zero
// while waiting), total = (r0 + r1) + r2, the clock test
// u <= total (dt - phase), the pick [u2 >= r0] + [u2 >= r0 + r1] with
// u2 = draw * total (salt 12, in-tile counter), the displacement rebase
// (s[site] - s[dst]) + minimg(p[dst] - p[site]) from the prefix table and
// the frame's positions in L2, the d_OH step, and a fresh u = -log(draw)
// (salt 13). At frame end the unused budget leaves u, a replica that fired
// on every iteration counts one truncated frame, and the per-frame counters
// move (fsj += 1, wait = max(wait - 1, 0)); replica 0 writes its site to the
// frame's slot of the site trace, the site the CLI prints for that frame.
// B4's any_live skip over a tile is a per-thread loop exit: a done replica's
// iteration changes nothing. Its one-hot matmul gathers are index loads. The
// logical RNG tile `tile` keys the draws and is not the CUDA block.
//
// About 95% of replica-frames have no event, and a frame without one only
// needs its total rate. So WATER_LANES = 8 lanes run each replica: lane g
// evaluates frame b + g's total as if none of the frames before it fired
// (the same site and last site, fsj + g, max(wait - g, 0), that frame's own
// table rows), the lanes swap the totals by shuffles, and every lane walks
// those frames in order, applying each refusal (u -= total dt, the counters)
// until a frame's clock test fires. That frame runs in full (the event
// iterations below, from the same state, so with the same floats), on all
// the replica's lanes alike, and the lookahead starts again after it. The
// lanes give the card eight times the warps (R = 8192 replicas are 256 warps
// alone, under two an SM) to hide the evaluation's dependent loads and
// divisions; one lane writes the state. chip_smoke.py times 4 and 16 lanes
// beside it (-DWATER_LANES). At an event the
// rows, positions and prefix entries of all three candidates are loaded
// before the pick is drawn, so one wait covers them, and the frame's first
// two draws are hashed at its start; after an event the last site's row is
// the row just used at the site. A frame whose loop ended on a refusal
// evaluates its leftover rate from the rates of that refusal (the same
// state, the same values).
//
// Numerics (built with --fmad=false): total = (r0 + r1) + r2, the order of
// XLA's CPU reduction over B4's 8 lanes, so the pick compares the same
// floats; |jump|^2 = (x^2 + y^2) + z^2 and lax.rsqrt as 1.0f / sqrtf (XLA's
// CPU rsqrt is an approximation, so the d_OH correction agrees within a few
// ulps, not bit for bit). A pick that lands on a zero-rate slot (a draw of
// exactly 1.0 makes u2 = total; ROADMAP queue C item 7) takes the last slot
// with a positive rate.
//
// Bound on the H100: operations, a few dozen per candidate evaluation (two
// to five per replica-frame) and about a hundred per event, against bytes
// of the tables and positions read once (12 B x (K + 1) per site and
// frame): a few microseconds at N=216, R=8192, B=256. Each replica is a
// sequential chain (its frames, its events), R=8192 threads are 256 warps,
// about two per SM, so the loop is bound by the latency of its loads and
// draws, not by the card's rates: the design keeps the loads off that chain
// (prefetch) and out of the frames without an event (the prefix table).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "kmc_common.cuh"
#include "rng.cuh"

#ifndef WATER_LANES
#define WATER_LANES 8  // lanes per replica, one frame ahead each
#endif

struct WaterArgs {
  const float* pos;    // [B, N, 3]
  const float4* rows;  // [B, N, 3]: each site's K entries of topd, resc, topi
  const float* s_tab;  // [B, N, 3] site prefix sum after each frame
  int* site;
  int* last;
  int* fsj;
  int* wait;
  int* jumps;
  int* evc;
  float* u;
  float* corr;   // [R, 3]
  float* abase;  // [R, 3]
  int* trunc;
  int* site_trace;  // [B] replica 0's site after each frame
  int R, N, B, K, tile, tile_offset, frame0, max_events, kind, relax, waiting,
      keep_last, check_old;
  float dt, d_oh, lx, ly, lz;
  uint32_t seed;
  float p[6];
};

// One site's K table entries on one frame (the last site's: ci and r of the
// first 3 slots, for check_from_old).
struct WaterRow {
  float d[4], r[4];
  int ci[4];
};

__device__ inline void load_row(const WaterArgs& a, int b, int site, bool full,
                                WaterRow& row) {
  const float4* rec = a.rows + ((size_t)b * a.N + site) * 3;
  if (full) {
    const float4 d = __ldg(rec);
    row.d[0] = d.x;
    row.d[1] = d.y;
    row.d[2] = d.z;
    row.d[3] = d.w;
  }
  const float4 r = __ldg(rec + 1);
  const int4 c = __ldg((const int4*)(rec + 2));
  row.r[0] = r.x;
  row.r[1] = r.y;
  row.r[2] = r.z;
  row.r[3] = r.w;
  row.ci[0] = c.x;
  row.ci[1] = c.y;
  row.ci[2] = c.z;
  row.ci[3] = c.w;
}

// Each site's table entries gathered into one 48-byte record of three
// float4 (distances, rescaled distances, indices; slots past K zero), one
// thread per site and frame: a replica reads its site's row in two 32-byte
// sectors where the [B, K, N] tables spread it over 3 K.
__global__ void water_pack_kernel(const float* __restrict__ topd,
                                  const int* __restrict__ topi,
                                  const float* __restrict__ resc, int B, int K,
                                  int N, float4* __restrict__ rows) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * N) return;
  const long long b = t / N, i = t % N;
  float d[4] = {0.f, 0.f, 0.f, 0.f}, r[4] = {0.f, 0.f, 0.f, 0.f};
  int c[4] = {0, 0, 0, 0};
  for (int s = 0; s < K; ++s) {
    const size_t o = ((size_t)b * K + s) * N + i;
    d[s] = topd[o];
    r[s] = resc[o];
    c[s] = topi[o];
  }
  float4* rec = rows + (size_t)t * 3;
  rec[0] = make_float4(d[0], d[1], d[2], d[3]);
  rec[1] = make_float4(r[0], r[1], r[2], r[3]);
  rec[2] = make_float4(__int_as_float(c[0]), __int_as_float(c[1]), __int_as_float(c[2]),
                       __int_as_float(c[3]));
}

// The 3 candidates of the site whose row is `at` (`old` the last site's row,
// read only for check_from_old): B4's `candidates` for one replica.
__device__ inline void water_candidates(const WaterArgs& a, const WaterRow& at,
                                        const WaterRow& old, int site, int last,
                                        int fsj, int wait, float rates[3],
                                        int cand[3]) {
  const int K = a.K;
  float de[4] = {0.f, 0.f, 0.f, 0.f}, r[4] = {0.f, 0.f, 0.f, 0.f};
  int ci[4] = {0, 0, 0, 0};
  bool is_last[4] = {false, false, false, false};
  float factor = 0.f;
  if (a.relax > 0)
    factor = fminf(fmaxf((float)fsj / (float)a.relax, 0.f), 1.f);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s < K) {
      const float d = at.d[s];
      r[s] = at.r[s];
      ci[s] = at.ci[s];
      de[s] = a.relax > 0 ? d + factor * (r[s] - d) : r[s];
      is_last[s] = a.keep_last && last >= 0 && ci[s] == last;
      if (is_last[s]) de[s] = r[s];
    }
  }
  if (a.keep_last) {
    if (K == 4) {
      // the old neighbor in slot 3 moves to slot 2
      if (is_last[3]) {
        de[2] = de[3];
        ci[2] = ci[3];
      }
    } else if (a.check_old && last >= 0 && !(is_last[0] || is_last[1] || is_last[2])) {
      // the connection exists only old -> new: the farthest active candidate
      // becomes the old site at old's rescaled distance
      int first_eq = -1;
#pragma unroll
      for (int s = 0; s < 3; ++s)
        if (first_eq < 0 && old.ci[s] == site) first_eq = s;
      if (first_eq >= 0) {
        int far = 0;
        if (de[1] > de[far]) far = 1;
        if (de[2] > de[far]) far = 2;
        de[far] = first_eq == 0 ? old.r[0] : first_eq == 1 ? old.r[1] : old.r[2];
        ci[far] = last;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    rates[s] = wait > 0 ? 0.f : apply_law(a.kind, de[s], a.p);
    cand[s] = ci[s];
  }
}

// The site prefix sum after every frame of the block, one thread per site
// and axis: s[b] = s[b - 1] + minimg(pos[b] - pos[b - 1]) with pos[-1] =
// prev and s[-1] = s_in, in frame order (step_prefix's arithmetic); the last
// row also goes to s_out.
__global__ void water_prefix_kernel(const float* __restrict__ pos,
                                    const float* __restrict__ prev,
                                    const float* __restrict__ s_in,
                                    float* __restrict__ s_tab,
                                    float* __restrict__ s_out, int N, int B,
                                    float lx, float ly, float lz) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // 3 * site + axis
  if (t >= 3 * N) return;
  const int axis = t % 3;
  const float len = axis == 0 ? lx : axis == 1 ? ly : lz;
  const float inv = 1.0f / len;
  const size_t row = (size_t)3 * N;
  float s = s_in[t], q = prev[t];
  int b = 0;
  // eight frames' positions loaded, and their moves' minimum images taken,
  // ahead of the additions (minimg_near: minimg's bits without a division)
  for (; b + 8 <= B; b += 8) {
    float p[8], d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = __ldg(pos + (b + u) * row + t);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      d[u] = minimg_near(p[u] - q, len, inv);
      q = p[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s = s + d[u];
      s_tab[(b + u) * row + t] = s;
    }
  }
  for (; b < B; ++b) {
    const float p = __ldg(pos + b * row + t);
    s = s + minimg_near(p - q, len, inv);
    s_tab[b * row + t] = s;
    q = p;
  }
  s_out[t] = s;
}

__global__ void water_sweep_kernel(WaterArgs a) {
  const int N = a.N;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = t / WATER_LANES, lane = t % WATER_LANES;
  const unsigned group = ((1u << WATER_LANES) - 1)  // the replica's lanes
                         << (threadIdx.x & (32 - WATER_LANES));
  if (r >= a.R) return;  // the replica's lanes all return
  int site = a.site[r], last = a.last[r], fsj = a.fsj[r], wait = a.wait[r];
  int jumps = a.jumps[r], evc = a.evc[r], trunc = 0;
  float u = a.u[r];
  float cx = a.corr[3 * r], cy = a.corr[3 * r + 1], cz = a.corr[3 * r + 2];
  float ax = a.abase[3 * r], ay = a.abase[3 * r + 1], az = a.abase[3 * r + 2];
  const uint32_t tile_id = (uint32_t)(r / a.tile + a.tile_offset);
  const uint32_t rin = (uint32_t)(r % a.tile);
  const float c_oh = 2.0f * a.d_oh;
  const int wait0 = a.waiting ? a.waiting + 1 : 0;
  // the last site's row is read only by check_from_old (K = 3)
  const bool need_old = a.keep_last && a.check_old && a.K == 3;

  int b = 0;
  while (b < a.B) {
    // The next WATER_LANES frames' totals, as if none of them fired: lane g
    // evaluates frame b + g, and the lanes swap the totals.
    float mine = 0.f;
    if (b + lane < a.B) {
      WaterRow at = {}, ol = {};
      load_row(a, b + lane, site, true, at);
      if (need_old && last >= 0) load_row(a, b + lane, last, false, ol);
      float rates[3];
      int cand[3];
      water_candidates(a, at, ol, site, last, fsj + lane, wait > lane ? wait - lane : 0,
                       rates, cand);
      mine = (rates[0] + rates[1]) + rates[2];
    }
    float tot[WATER_LANES];
#pragma unroll
    for (int g = 0; g < WATER_LANES; ++g) tot[g] = __shfl_sync(group, mine, g, WATER_LANES);
    bool fires = false;
    // walk them while the clock test refuses; the first that fires runs in full
#pragma unroll
    for (int g = 0; g < WATER_LANES; ++g) {
      if (fires || b >= a.B) continue;
      const float budget = tot[g] * (a.dt - 0.f);
      if (u <= budget && budget > 0.f) {
        fires = true;  // frame b has an event
      } else {
        u = u - tot[g] * (a.dt - 0.f);
        fsj += 1;
        wait = wait > 1 ? wait - 1 : 0;
        if (r == 0 && lane == 0) a.site_trace[b] = site;
        ++b;
      }
    }
    if (!fires) continue;
    WaterRow cur = {}, old = {};
    load_row(a, b, site, true, cur);
    if (need_old && last >= 0) load_row(a, b, last, false, old);
    const float* post = a.pos + (size_t)b * N * 3;
    const float* s = a.s_tab + (size_t)b * N * 3;
    const uint32_t frame_idx = (uint32_t)(a.frame0 + b);
    // the first event iteration's two draws, hashed while the candidates
    // are evaluated (most replica-frames with an event have one)
    float d12 = cmdlmc_u01(cmdlmc_mix_key(a.seed, tile_id, frame_idx, 0, 12), rin);
    float d13 = cmdlmc_u01(cmdlmc_mix_key(a.seed, tile_id, frame_idx, 0, 13), rin);
    float phase = 0.f;
    bool done = false;
    float rates[3];
    int cand[3];
    for (int ev = 0; ev < a.max_events; ++ev) {
      water_candidates(a, cur, old, site, last, fsj, wait, rates, cand);
      const float c1 = rates[0] + rates[1];
      const float total = c1 + rates[2];
      const float budget = total * (a.dt - phase);
      if (!(u <= budget && budget > 0.f)) {
        done = true;
        break;
      }
      // the three candidates' rows, positions and prefix, loaded before the
      // pick is known, so that one wait covers them all
      WaterRow crow[3];
      float cp[3][3], cs[3][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        load_row(a, b, cand[c], true, crow[c]);
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          cp[c][x] = __ldg(post + 3 * cand[c] + x);
          cs[c][x] = __ldg(s + 3 * cand[c] + x);
        }
      }
      const float ps[3] = {__ldg(post + 3 * site), __ldg(post + 3 * site + 1),
                           __ldg(post + 3 * site + 2)};
      const float ss[3] = {__ldg(s + 3 * site), __ldg(s + 3 * site + 1),
                           __ldg(s + 3 * site + 2)};
      if (ev > 0) {
        d12 = cmdlmc_u01(cmdlmc_mix_key(a.seed, tile_id, frame_idx, ev, 12), rin);
        d13 = cmdlmc_u01(cmdlmc_mix_key(a.seed, tile_id, frame_idx, ev, 13), rin);
      }
      const float eph = phase + u / total;
      const float u2 = d12 * total;
      int pick = (u2 >= rates[0] ? 1 : 0) + (u2 >= c1 ? 1 : 0);
      if (!(rates[pick] > 0.f))  // a draw of 1.0: the last positive slot
        pick = rates[2] > 0.f ? 2 : rates[1] > 0.f ? 1 : 0;
      const int dst = cand[pick];
      float pd[3], sd[3];
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        pd[x] = pick == 0 ? cp[0][x] : pick == 1 ? cp[1][x] : cp[2][x];
        sd[x] = pick == 0 ? cs[0][x] : pick == 1 ? cs[1][x] : cs[2][x];
      }
      const float jx = minimg(pd[0] - ps[0], a.lx);
      const float jy = minimg(pd[1] - ps[1], a.ly);
      const float jz = minimg(pd[2] - ps[2], a.lz);
      ax = ax + ((ss[0] - sd[0]) + jx);
      ay = ay + ((ss[1] - sd[1]) + jy);
      az = az + ((ss[2] - sd[2]) + jz);
      if (a.d_oh != 0.f) {
        const float norm2 = (jx * jx + jy * jy) + jz * jz;
        const float inv = 1.0f / sqrtf(fmaxf(norm2, 1e-12f));
        cx = cx - (c_oh * jx) * inv;
        cy = cy - (c_oh * jy) * inv;
        cz = cz - (c_oh * jz) * inv;
      }
      last = site;
      site = dst;
      old = cur;  // the new last site's row: the one just used
      cur = pick == 0 ? crow[0] : pick == 1 ? crow[1] : crow[2];
      fsj = -1;
      wait = wait0;
      jumps += 1;
      evc += 1;
      u = -logf(d13);
      phase = eph;
    }
    if (!done) {  // the budget ran out after an event: the state moved on
      trunc += 1;
      water_candidates(a, cur, old, site, last, fsj, wait, rates, cand);
    }
    u = u - ((rates[0] + rates[1]) + rates[2]) * (a.dt - phase);
    fsj += 1;
    wait = wait > 1 ? wait - 1 : 0;
    if (r == 0 && lane == 0) a.site_trace[b] = site;
    ++b;
  }

  if (lane) return;
  a.site[r] = site;
  a.last[r] = last;
  a.fsj[r] = fsj;
  a.wait[r] = wait;
  a.jumps[r] = jumps;
  a.evc[r] = evc;
  a.u[r] = u;
  a.corr[3 * r] = cx;
  a.corr[3 * r + 1] = cy;
  a.corr[3 * r + 2] = cz;
  a.abase[3 * r] = ax;
  a.abase[3 * r + 1] = ay;
  a.abase[3 * r + 2] = az;
  a.trunc[r] = trunc;
}

// s_tab: [B, N, 3] scratch for the prefix table; rows: [B, N, 12] (48-byte
// records) scratch for the packed tables. B >= 1; R may be 0 (the prefix
// still advances).
extern "C" int cmdlmc_water_sweep(
    const void* pos, const void* topd, const void* topi, const void* resc,
    const void* prev, const void* s_in, void* s_tab, void* rows, void* s_out, void* site,
    void* last, void* fsj, void* wait, void* jumps, void* evc, void* u,
    void* corr, void* abase, void* trunc, void* site_trace, int R, int N,
    int B, int K, int tile, int tile_offset, int frame0, int max_events,
    int kind, int relax, int waiting, int keep_last, int check_old,
    int threads, float dt, float d_oh, float lx, float ly, float lz,
    uint32_t seed, const float* p, void* stream, int device) {
  CmdlmcDeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (K < 3 || K > 4 || N <= K || B < 1 || R < 0 || tile < 1 || R % tile ||
      threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  water_prefix_kernel<<<(3 * N + 127) / 128, 128, 0, st>>>(
      (const float*)pos, (const float*)prev, (const float*)s_in, (float*)s_tab,
      (float*)s_out, N, B, lx, ly, lz);
  int err = (int)cudaGetLastError();
  if (err || R == 0) return err;
  const long long sites = (long long)B * N;
  water_pack_kernel<<<(unsigned)((sites + 255) / 256), 256, 0, st>>>(
      (const float*)topd, (const int*)topi, (const float*)resc, B, K, N, (float4*)rows);
  err = (int)cudaGetLastError();
  if (err) return err;
  WaterArgs a;
  a.pos = (const float*)pos;
  a.rows = (const float4*)rows;
  a.s_tab = (const float*)s_tab;
  a.site = (int*)site;
  a.last = (int*)last;
  a.fsj = (int*)fsj;
  a.wait = (int*)wait;
  a.jumps = (int*)jumps;
  a.evc = (int*)evc;
  a.u = (float*)u;
  a.corr = (float*)corr;
  a.abase = (float*)abase;
  a.trunc = (int*)trunc;
  a.site_trace = (int*)site_trace;
  a.R = R;
  a.N = N;
  a.B = B;
  a.K = K;
  a.tile = tile;
  a.tile_offset = tile_offset;
  a.frame0 = frame0;
  a.max_events = max_events;
  a.kind = kind;
  a.relax = relax;
  a.waiting = waiting;
  a.keep_last = keep_last;
  a.check_old = check_old;
  a.dt = dt;
  a.d_oh = d_oh;
  a.lx = lx;
  a.ly = ly;
  a.lz = lz;
  a.seed = seed;
  for (int i = 0; i < 6; ++i) a.p[i] = p[i];
  const long long lanes = (long long)R * WATER_LANES;
  water_sweep_kernel<<<(unsigned)((lanes + threads - 1) / threads), threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
