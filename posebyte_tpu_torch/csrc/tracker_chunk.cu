// Kernel 3: the tracker recurrence of a whole chunk, K frames, in one launch.
//
// Replaces posebyte_tpu/ops/pallas_tracker.py::tracker_chunk_pallas
// (_tracker_chunk_kernel) for both motion models, cv and kalman136 (a
// template parameter: two kernels), each with or without the appearance
// Re-ID term, with the per-frame advance mask and a leading stream axis.
// Frame by frame it computes what tracker/step.py::tracker_step followed by
// tracker/output.py::extract_outputs_device computes (the plain version,
// ops/tracker_chunk.py::tracker_chunk_plain):
//   1 predict (cv; or kalman136: the third-order filter of every slot, free
//   ones too, the prediction and the gating velocities taken from it),
//   2 pose centres and the spatial gates, 3-5 three auction
//   tiers (full OKS on non-lost tracks, torso OKS, lost-track recovery),
//   each merged so that earlier tiers win and locking what they matched,
//   6 update matched tracks (kalman136: the per-keypoint scalar-gain update,
//   poses from the filter's mean), 7 age unmatched ones, 8 new tracks in
//   free slots by prefix-sum ranks in detection order (kalman136 initiates
//   their filters), 9 dominance dedup, then the per-detection outputs.
//   With Re-ID, tiers 1 and 3 blend the co-visible cosine cost of the
//   track and detection embeddings into the geometric cost, matched
//   tracks' embeddings follow their detections
//   by EMA and new tracks take their detection's (ops/reid.py; the cosine
//   of ops/reid.py::cosine_cost_matrix, 1e-12 inside each square root, not
//   the TPU kernel's variant). A frame whose advance flag is 0 computes its
//   outputs as the TPU kernel does (ids -1, scores 0, emit 0, num_active 0;
//   poses and boxes of the would-be state) and leaves the state as it was.
//
// What bounds it on an H100: neither bytes nor arithmetic but the chain of
// dependent steps. A frame reads ~14 KB of detections and writes ~15 KB of
// outputs; its arithmetic (OKS over the gated track x detection pairs,
// the auction rounds) is a few hundred thousand operations; but the frames
// are sequential and each is ~15 barrier-separated steps plus the auction
// rounds, on one SM per stream. kalman136 adds the filter's 278,528 B of L2
// traffic per frame (read and written by predict; device memory sees it
// once per chunk, 2 x 139,264 B per stream) and 28 operations per
// (slot, keypoint) for the predict of every slot.
//
// Design: one block per stream (grid = S) that loops over the K frames with
// the whole slot pool in shared memory (unpadded [T, 17] keypoint planes;
// 126,728 B at T = 128, D = 64 and 183,944 B at D = 128, so the launcher
// raises the dynamic shared memory limit). Re-ID adds the tracks'
// embeddings as three [T, 17] channel planes and the detections'
// per-keypoint energies [D, 17] (157,192 B at D = 64, 218,760 B at
// D = 128); the detections' embeddings themselves are read from device
// memory through the read-only cache, so that D = 128 stays under the
// 227 KB a block may have. kalman136 adds no shared memory: its filter,
// 16 floats per (slot, keypoint), 139,264 B per stream at T = 128, would
// not fit beside the pool, so the block keeps it in the output buffers
// kf_mean / kf_cov [S, T, 136] (natural layout t * 136 + k * 8 + c; copied
// from the input at the start) and reads and writes each (slot, keypoint)'s
// 8 components as two float4 from the thread that owns it; it stays in L2
// (predict reads and writes all of it each frame, 278,528 B). The vx / vy
// planes hold the filter's velocities and qx / qy the prediction. A
// barrier orders the block's device-memory writes as it orders its shared
// ones. Device memory is otherwise read once for the initial state and once
// per frame for the detections, and written once per frame for the outputs
// and once for the final state. A frame that does not advance first saves
// the state to the output state buffers and restores it afterwards; with
// kalman136 it works on a copy of the filter in the wrapper's scratch buffer
// [S, 2, T, 136] and leaves the outputs' filter as it was. The
// TPU kernel's workarounds (identity-mask transposes, one-hot matmul
// selections, 17 -> 32 lane padding) become indexed reads and writes. OKS
// is evaluated only on the pairs that a tier's gate admits (elsewhere the
// cost is the lock value whatever the OKS). The three tiers call the same
// posebyte::auction_rounds as Kernel 2. Ranks are counts over shared flags,
// no atomics; the only atomic is the order-free 64-bit atomicMax inside
// auction_rounds. Every loop that holds a barrier runs the same number of
// times on every thread (the frame loop, the auction's __syncthreads_or
// exit), and the advance flag is read by every thread, so no barrier is
// skipped.
//
// Arithmetic: built with -fmad=false, IEEE expf, sqrtf and division, and
// keypoints summed in index order, the order of the plain version
// (ops/oks.py::sum_in_order; a keypoint's energy r, g, b; an embedding's
// norm over its 51 components k * 3 + c), so that costs, and with them
// every integer output, agree bit for bit with the plain version on the
// card. The filter follows ops/kalman.py::Kalman136 operation by operation:
// p + v + 0.5 a + (1/6) j left to right with float32(1/6), and the process
// noise as the float32 squares of 1, 0.5, 0.1, 0.05 (0.1f * 0.1f is
// 0.010000000707805157, not the Pallas kernel's literal 0.01), both from
// the launcher's float arguments.

#include <cuda_runtime.h>
#include <stdint.h>

#include "auction.cuh"

namespace {

constexpr int kNumKp = 17;
constexpr int kThreads = 256;
constexpr int kTentative = 0, kConfirmed = 1, kLost = 2;
constexpr float kLock = 1e9f;
constexpr float kBig = 1e9f;

// The torso keypoints 5, 6, 11, 12 (shoulders and hips), j = 0..3.
__host__ __device__ inline int torso_kp(int j) { return j < 2 ? 5 + j : 9 + j; }

// Device pointers, in the order of the launcher's pointer array.
struct Ptrs {
  const float* det_poses;     // [S, K, D, 17, 3]
  const float* det_scores;    // [S, K, D]
  const uint8_t* det_valid;   // [S, K, D]
  const uint8_t* advance;     // [S, K]
  const float* det_emb;       // [S, K, D, 51]; null without Re-ID
  // initial state: poses [S,T,17,3], velocities [S,T,17,2], scores [S,T],
  // ids, states, hits, ages, last_frame [S,T] i32, active [S,T] u8,
  // embeddings [S,T,51], counters [S,2] i32 (next_id, frame),
  // det_track_slot [S,D] i32
  const float* in_poses;
  const float* in_vel;
  const float* in_scores;
  const int32_t* in_ids;
  const int32_t* in_states;
  const int32_t* in_hits;
  const int32_t* in_ages;
  const int32_t* in_last_frame;
  const uint8_t* in_active;
  const float* in_emb;
  const int32_t* in_counters;
  const int32_t* in_slot;
  // final state, same layout
  float* out_poses;
  float* out_vel;
  float* out_scores;
  int32_t* out_ids;
  int32_t* out_states;
  int32_t* out_hits;
  int32_t* out_ages;
  int32_t* out_last_frame;
  uint8_t* out_active;
  float* out_emb;
  int32_t* out_counters;
  int32_t* out_slot;
  // per-frame outputs
  int32_t* o_ids;             // [S, K, D]
  float* o_scores;            // [S, K, D]
  float* o_poses;             // [S, K, D, 17, 3]
  float* o_boxes;             // [S, K, D, 4]
  uint8_t* o_emit;            // [S, K, D]
  int32_t* o_num_active;      // [S, K]
  // kalman136 (null for cv): the filter's mean and covariance diagonal
  // [S, T, 136], initial and final, and the scratch [S, 2, T, 136] of the
  // frames that do not advance
  const float* in_kf_mean;
  const float* in_kf_cov;
  float* out_kf_mean;
  float* out_kf_cov;
  float* kf_scratch;
};
constexpr int kNumPtrs = 40;

struct Cfg {
  int S, K, T, D;
  int min_hits, max_age, lost_dead_age, num_iters, tent_max_age;
  int reid;            // 1: Re-ID on
  int kalman;          // 1: the kalman136 motion model
  float gate_thr, lost_gate_thr, vis_thr, dedup_iou, new_thr;
  float gain, alpha, beta, lost_decay, eps0;
  float sig[kNumKp];   // (2 sigma)^2, the full-OKS tiers
  float sigt[4];       // (3 sigma)^2 of the torso keypoints
  float reid_w, reid_1mw, ema_g, ema_1mg;  // w, 1 - w, gamma, 1 - gamma
  float accel_mem, jerk_mem, sixth;  // kalman136: memories, float32(1/6)
  float noise[4];      // process noise of p, v, a, j: float32 squares
};
constexpr int kNumIntArgs = 11;
constexpr int kNumFloatArgs = 10 + kNumKp + 4 + 4 + 3 + 4;
constexpr int kEmb = kNumKp * 3;  // embedding length
constexpr int kKf4 = kNumKp * 2;  // float4s of one slot's mean (or cov)

// Shared memory, carved from one dynamic buffer.
struct Smem {
  unsigned long long* col_bid;                       // [D]
  float *px, *py, *pc, *vx, *vy, *qx, *qy;           // [T*17]
  float *tsc, *tcx, *tcy, *tw, *th, *tarea, *tspeed;  // [T]
  float *dx, *dy, *dc;                               // [D*17]
  float *er, *eg, *eb;                      // [T*17] (Re-ID, else null)
  float* de;                                // [D*17] (Re-ID, else null)
  float *dsc, *dcx, *dcy, *dw, *dh, *darea, *prices;  // [D]
  float* cost_t;                                     // [D][T]
  int *ids, *st, *hits, *ages, *lf, *row, *row_new, *trank,
      *free_slot;                                    // [T]
  int *col, *col_new, *drank;                        // [D]
  int* misc;                                 // [2] next_id, frame
  uint8_t *act0, *active, *flag;                     // [T]
  uint8_t *dvalid, *newdet;                          // [D]
  uint8_t* gate;                                     // [T*D]
};

template <class P>
__host__ __device__ inline P* take(uintptr_t base, size_t& off, size_t n) {
  off = (off + 7) & ~static_cast<size_t>(7);
  P* p = reinterpret_cast<P*>(base + off);
  off += n * sizeof(P);
  return p;
}

// Lays the arrays out from `base`; returns the bytes used.
__host__ __device__ inline size_t carve(Smem& s, uintptr_t base, int T,
                                        int D, bool reid) {
  size_t o = 0;
  const size_t TK = (size_t)T * kNumKp, DK = (size_t)D * kNumKp;
  s.col_bid = take<unsigned long long>(base, o, D);
  float** tplanes[] = {&s.px, &s.py, &s.pc, &s.vx, &s.vy, &s.qx, &s.qy};
  for (float** p : tplanes) *p = take<float>(base, o, TK);
  float** tvec[] = {&s.tsc, &s.tcx, &s.tcy, &s.tw, &s.th, &s.tarea,
                    &s.tspeed};
  for (float** p : tvec) *p = take<float>(base, o, T);
  float** dplanes[] = {&s.dx, &s.dy, &s.dc};
  for (float** p : dplanes) *p = take<float>(base, o, DK);
  float** eplanes[] = {&s.er, &s.eg, &s.eb};
  for (float** p : eplanes) *p = reid ? take<float>(base, o, TK) : nullptr;
  s.de = reid ? take<float>(base, o, DK) : nullptr;
  float** dvec[] = {&s.dsc, &s.dcx, &s.dcy, &s.dw, &s.dh, &s.darea,
                    &s.prices};
  for (float** p : dvec) *p = take<float>(base, o, D);
  s.cost_t = take<float>(base, o, (size_t)T * D);
  int** tint[] = {&s.ids, &s.st, &s.hits, &s.ages, &s.lf, &s.row,
                  &s.row_new, &s.trank, &s.free_slot};
  for (int** p : tint) *p = take<int>(base, o, T);
  int** dint[] = {&s.col, &s.col_new, &s.drank};
  for (int** p : dint) *p = take<int>(base, o, D);
  s.misc = take<int>(base, o, 2);
  uint8_t** tb[] = {&s.act0, &s.active, &s.flag};
  for (uint8_t** p : tb) *p = take<uint8_t>(base, o, T);
  s.dvalid = take<uint8_t>(base, o, D);
  s.newdet = take<uint8_t>(base, o, D);
  s.gate = take<uint8_t>(base, o, (size_t)T * D);
  return o;
}

// Box of the keypoints above `thr` of one [17] plane triple:
// (min x, min y, max x, max y, count); +-1e9 where none.
__device__ inline int kp_box(const float* x, const float* y, const float* c,
                             float thr, float* b) {
  float mnx = kBig, mny = kBig, mxx = -kBig, mxy = -kBig;
  int n = 0;
  for (int q = 0; q < kNumKp; ++q) {
    if (c[q] > thr) {
      mnx = fminf(mnx, x[q]);
      mny = fminf(mny, y[q]);
      mxx = fmaxf(mxx, x[q]);
      mxy = fmaxf(mxy, y[q]);
      ++n;
    }
  }
  b[0] = mnx;
  b[1] = mny;
  b[2] = mxx;
  b[3] = mxy;
  return n;
}

// Pose centre (cx, cy, w, h), zero with < 2 keypoints above 0.1
// (ops/geometry.py::pose_centers), and the visible-keypoint box area
// (ops/oks.py::_masked_area).
__device__ inline void centre_and_area(const float* x, const float* y,
                                       const float* c, float* cx, float* cy,
                                       float* w, float* h, float* area) {
  float b[4];
  const int n = kp_box(x, y, c, 0.1f, b);
  if (n >= 2) {
    *cx = (b[0] + b[2]) * 0.5f;
    *cy = (b[1] + b[3]) * 0.5f;
    *w = b[2] - b[0];
    *h = b[3] - b[1];
  } else {
    *cx = *cy = *w = *h = 0.0f;
  }
  *area = n > 0 ? fmaxf((b[2] - b[0]) * (b[3] - b[1]), 0.0f) : 0.0f;
}

// Full OKS of predicted track t against detection d (ops/oks.py::
// oks_matrix, sigma_scale 2, min scale^2 1000, >= 3 co-visible keypoints).
__device__ inline float oks_full(const Smem& s, const Cfg& cfg, int t, int d,
                                 float vis) {
  const float den = 2.0f * fmaxf((s.tarea[t] + s.darea[d]) * 0.5f, 1000.0f);
  const float *tx = s.qx + t * kNumKp, *ty = s.qy + t * kNumKp,
              *tc = s.pc + t * kNumKp;
  const float *ex = s.dx + d * kNumKp, *ey = s.dy + d * kNumKp,
              *ec = s.dc + d * kNumKp;
  float sum = 0.0f;
  int n = 0;
  for (int q = 0; q < kNumKp; ++q) {
    if (tc[q] > vis && ec[q] > vis) {
      const float ddx = tx[q] - ex[q], ddy = ty[q] - ey[q];
      const float d2 = ddx * ddx + ddy * ddy;
      sum = sum + expf(-d2 / (den * cfg.sig[q]));
      ++n;
    }
  }
  return n >= 3 ? sum / static_cast<float>(n) : 0.0f;
}

// Torso OKS (ops/oks.py::torso_oks_matrix: keypoints 5, 6, 11, 12,
// conf > 0.1, sigma_scale 3, scale^2 10000, >= 2 co-visible).
__device__ inline float oks_torso(const Smem& s, const Cfg& cfg, int t,
                                  int d) {
  float sum = 0.0f;
  int n = 0;
  for (int j = 0; j < 4; ++j) {
    const int ti = t * kNumKp + torso_kp(j), di = d * kNumKp + torso_kp(j);
    if (s.pc[ti] > 0.1f && s.dc[di] > 0.1f) {
      const float ddx = s.qx[ti] - s.dx[di], ddy = s.qy[ti] - s.dy[di];
      const float d2 = ddx * ddx + ddy * ddy;
      sum = sum + expf(-d2 / (20000.0f * cfg.sigt[j]));
      ++n;
    }
  }
  return n >= 2 ? sum / static_cast<float>(n) : 0.0f;
}

// Re-ID appearance cost of track t against detection d
// (ops/reid.py::cosine_cost_matrix): 1 - cosine over the keypoints whose
// energy exceeds 1e-12 on both sides, 1.0 with none. `emb` is detection
// d's embedding in device memory; each sum runs in keypoint order as
// sum_in_order does, a skipped keypoint adding 0.
__device__ inline float reid_cost(const Smem& s, const float* emb, int t,
                                  int d) {
  float num = 0.0f, tsum = 0.0f, dsum = 0.0f;
  bool any = false;
  for (int q = 0; q < kNumKp; ++q) {
    const int i = t * kNumKp + q;
    const float r = s.er[i], g = s.eg[i], b = s.eb[i];
    const float te = (r * r + g * g) + b * b;
    const float dq = s.de[d * kNumKp + q];
    const bool vis = te > 1e-12f && dq > 1e-12f;
    float xn = 0.0f, xt = 0.0f, xd = 0.0f;
    if (vis) {
      xn = (r * __ldg(emb + q * 3) + g * __ldg(emb + q * 3 + 1)) +
           b * __ldg(emb + q * 3 + 2);
      xt = te;
      xd = dq;
      any = true;
    }
    if (q == 0) {
      num = xn;
      tsum = xt;
      dsum = xd;
    } else {
      num = num + xn;
      tsum = tsum + xt;
      dsum = dsum + xd;
    }
  }
  if (!any) return 1.0f;
  const float tn = sqrtf(tsum + 1e-12f), dn = sqrtf(dsum + 1e-12f);
  return 1.0f - num / fmaxf(tn * dn, 1e-6f);
}

// The channel plane of embedding component k = q * 3 + c.
__device__ inline float* emb_plane(const Smem& s, int c) {
  return c == 0 ? s.er : (c == 1 ? s.eg : s.eb);
}

// Copies the slot pool between shared memory and a state in device memory
// (all threads; the caller synchronises).
__device__ inline void load_state(Smem& s, const Ptrs& p, const Cfg& cfg,
                                  int b, bool from_out) {
  const int T = cfg.T, D = cfg.D, tid = threadIdx.x;
  const size_t TK = (size_t)T * kNumKp;
  const float* poses = (from_out ? p.out_poses : p.in_poses) + b * TK * 3;
  const float* vel = (from_out ? p.out_vel : p.in_vel) + b * TK * 2;
  for (int i = tid; i < T * kNumKp; i += blockDim.x) {
    s.px[i] = poses[i * 3 + 0];
    s.py[i] = poses[i * 3 + 1];
    s.pc[i] = poses[i * 3 + 2];
    s.vx[i] = vel[i * 2 + 0];
    s.vy[i] = vel[i * 2 + 1];
  }
  const size_t bt = (size_t)b * T;
  for (int t = tid; t < T; t += blockDim.x) {
    s.tsc[t] = (from_out ? p.out_scores : p.in_scores)[bt + t];
    s.ids[t] = (from_out ? p.out_ids : p.in_ids)[bt + t];
    s.st[t] = (from_out ? p.out_states : p.in_states)[bt + t];
    s.hits[t] = (from_out ? p.out_hits : p.in_hits)[bt + t];
    s.ages[t] = (from_out ? p.out_ages : p.in_ages)[bt + t];
    s.lf[t] = (from_out ? p.out_last_frame : p.in_last_frame)[bt + t];
    s.active[t] = (from_out ? p.out_active : p.in_active)[bt + t] ? 1 : 0;
  }
  for (int d = tid; d < D; d += blockDim.x)
    s.col[d] = (from_out ? p.out_slot : p.in_slot)[(size_t)b * D + d];
  if (tid < 2)
    s.misc[tid] = (from_out ? p.out_counters : p.in_counters)[b * 2 + tid];
  if (cfg.reid) {
    const float* emb = (from_out ? p.out_emb : p.in_emb) + bt * kEmb;
    for (int i = tid; i < T * kEmb; i += blockDim.x)
      emb_plane(s, i % 3)[i / 3] = emb[i];
  }
}

__device__ inline void store_state(const Smem& s, const Ptrs& p,
                                   const Cfg& cfg, int b) {
  const int T = cfg.T, D = cfg.D, tid = threadIdx.x;
  const size_t TK = (size_t)T * kNumKp;
  float* poses = p.out_poses + b * TK * 3;
  float* vel = p.out_vel + b * TK * 2;
  for (int i = tid; i < T * kNumKp; i += blockDim.x) {
    poses[i * 3 + 0] = s.px[i];
    poses[i * 3 + 1] = s.py[i];
    poses[i * 3 + 2] = s.pc[i];
    vel[i * 2 + 0] = s.vx[i];
    vel[i * 2 + 1] = s.vy[i];
  }
  const size_t bt = (size_t)b * T;
  for (int t = tid; t < T; t += blockDim.x) {
    p.out_scores[bt + t] = s.tsc[t];
    p.out_ids[bt + t] = s.ids[t];
    p.out_states[bt + t] = s.st[t];
    p.out_hits[bt + t] = s.hits[t];
    p.out_ages[bt + t] = s.ages[t];
    p.out_last_frame[bt + t] = s.lf[t];
    p.out_active[bt + t] = s.active[t];
  }
  for (int d = tid; d < D; d += blockDim.x)
    p.out_slot[(size_t)b * D + d] = s.col[d];
  if (tid < 2) p.out_counters[b * 2 + tid] = s.misc[tid];
  // Without Re-ID the embeddings pass through unchanged.
  float* emb = p.out_emb + bt * kEmb;
  for (int i = tid; i < T * kEmb; i += blockDim.x)
    emb[i] = cfg.reid ? emb_plane(s, i % 3)[i / 3] : p.in_emb[bt * kEmb + i];
}

template <bool kKalman>
__global__ void __launch_bounds__(kThreads)
    tracker_chunk_kernel(Ptrs p, Cfg cfg) {
  extern __shared__ unsigned long long smem[];
  Smem s;
  carve(s, reinterpret_cast<uintptr_t>(smem), cfg.T, cfg.D, cfg.reid != 0);
  const int T = cfg.T, D = cfg.D, K = cfg.K, tid = threadIdx.x;
  const int nth = blockDim.x;
  const int b = blockIdx.x;

  load_state(s, p, cfg, b, false);
  // kalman136: the stream's filter, [T * 17] (slot, keypoint) entries of two
  // float4 each (p, v and a, j), worked on in the output buffers
  float4* kf_m = nullptr;
  float4* kf_c = nullptr;
  if constexpr (kKalman) {
    const size_t o = (size_t)b * T * kKf4;
    kf_m = reinterpret_cast<float4*>(p.out_kf_mean) + o;
    kf_c = reinterpret_cast<float4*>(p.out_kf_cov) + o;
    const float4* im = reinterpret_cast<const float4*>(p.in_kf_mean) + o;
    const float4* ic = reinterpret_cast<const float4*>(p.in_kf_cov) + o;
    for (int i = tid; i < T * kKf4; i += nth) {
      kf_m[i] = im[i];
      kf_c[i] = ic[i];
    }
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const size_t f = (size_t)b * K + k;           // frame index
    const bool adv = p.advance[f] != 0;           // same on every thread
    float4* fm = kf_m;                            // the frame's filter
    float4* fc = kf_c;
    if (!adv) {
      store_state(s, p, cfg, b);  // saved; restored after the frame
      if constexpr (kKalman) {    // work on a copy; the outputs' stays
        float4* sm = reinterpret_cast<float4*>(p.kf_scratch) +
                     (size_t)b * 2 * T * kKf4;
        float4* sc = sm + (size_t)T * kKf4;
        for (int i = tid; i < T * kKf4; i += nth) {
          sm[i] = kf_m[i];
          sc[i] = kf_c[i];
        }
        fm = sm;
        fc = sc;
      }
      __syncthreads();
    }

    // ---- detections of the frame; stage 1: predict ---------------------
    const float* dp = p.det_poses + f * D * kNumKp * 3;
    for (int i = tid; i < D * kNumKp; i += nth) {
      s.dx[i] = dp[i * 3 + 0];
      s.dy[i] = dp[i * 3 + 1];
      s.dc[i] = dp[i * 3 + 2];
    }
    for (int d = tid; d < D; d += nth) {
      s.dsc[d] = p.det_scores[f * D + d];
      s.dvalid[d] = p.det_valid[f * D + d] ? 1 : 0;
    }
    // the frame's detection embeddings [D, 51] (Re-ID), in device memory
    const float* femb = cfg.reid ? p.det_emb + f * D * kEmb : nullptr;
    if (cfg.reid) {
      for (int i = tid; i < D * kNumKp; i += nth) {
        const float* e = femb + i * 3;
        const float r = __ldg(e), g = __ldg(e + 1), b = __ldg(e + 2);
        s.de[i] = (r * r + g * g) + b * b;
      }
    }
    for (int t = tid; t < T; t += nth) s.act0[t] = s.active[t];
    if constexpr (kKalman) {
      // third-order predict of every slot, free ones too
      // (Kalman136.predict); the prediction where the track is active
      for (int i = tid; i < T * kNumKp; i += nth) {
        const float4 pv = fm[2 * i], aj = fm[2 * i + 1];
        const float4 cpv = fc[2 * i], caj = fc[2 * i + 1];
        const float4 npv = make_float4(
            ((pv.x + pv.z) + 0.5f * aj.x) + cfg.sixth * aj.z,
            ((pv.y + pv.w) + 0.5f * aj.y) + cfg.sixth * aj.w,
            (pv.z + aj.x) + 0.5f * aj.z, (pv.w + aj.y) + 0.5f * aj.w);
        fm[2 * i] = npv;
        fm[2 * i + 1] =
            make_float4(aj.x * cfg.accel_mem, aj.y * cfg.accel_mem,
                        aj.z * cfg.jerk_mem, aj.w * cfg.jerk_mem);
        fc[2 * i] = make_float4(cpv.x + cfg.noise[0], cpv.y + cfg.noise[0],
                                cpv.z + cfg.noise[1], cpv.w + cfg.noise[1]);
        fc[2 * i + 1] =
            make_float4(caj.x + cfg.noise[2], caj.y + cfg.noise[2],
                        caj.z + cfg.noise[3], caj.w + cfg.noise[3]);
        const bool a = s.active[i / kNumKp] != 0;
        s.vx[i] = npv.z;
        s.vy[i] = npv.w;
        s.qx[i] = a ? npv.x : s.px[i];
        s.qy[i] = a ? npv.y : s.py[i];
      }
    } else {
      for (int i = tid; i < T * kNumKp; i += nth) {
        const int t = i / kNumKp;
        const bool a = s.active[t] != 0;
        s.qx[i] = a ? s.px[i] + s.vx[i] : s.px[i];
        s.qy[i] = a ? s.py[i] + s.vy[i] : s.py[i];
        if (a && s.st[t] == kLost) {
          s.vx[i] = s.vx[i] * cfg.lost_decay;
          s.vy[i] = s.vy[i] * cfg.lost_decay;
        }
      }
    }
    if (tid == 0) s.misc[1] = s.misc[1] + 1;      // frame
    __syncthreads();

    // ---- stage 2: centres, areas, torso speed ----------------------------
    for (int t = tid; t < T; t += nth) {
      const int o = t * kNumKp;
      centre_and_area(s.qx + o, s.qy + o, s.pc + o, &s.tcx[t], &s.tcy[t],
                      &s.tw[t], &s.th[t], &s.tarea[t]);
      float sp = 0.0f;
      for (int j = 0; j < 4; ++j) {
        const float a = s.vx[o + torso_kp(j)], c = s.vy[o + torso_kp(j)];
        const float v = sqrtf(a * a + c * c);
        sp = j == 0 ? v : sp + v;
      }
      s.tspeed[t] = sp * 0.25f;
    }
    for (int d = tid; d < D; d += nth) {
      const int o = d * kNumKp;
      centre_and_area(s.dx + o, s.dy + o, s.dc + o, &s.dcx[d], &s.dcy[d],
                      &s.dw[d], &s.dh[d], &s.darea[d]);
    }
    __syncthreads();

    // ---- spatial gates and the tier-1 cost --------------------------------
    // gate bit 1: tier 1/2 pairs (gate & non-lost track); bit 2: tier 3
    // pairs (lost gate & lost track).
    const int frame = s.misc[1];
    for (int i = tid; i < T * D; i += nth) {
      const int t = i % T, d = i / T;
      uint8_t g = 0;
      if (s.act0[t] && s.dvalid[d]) {
        const bool degen = s.tw[t] < 1.0f || s.th[t] < 1.0f ||
                           s.dw[d] < 1.0f || s.dh[d] < 1.0f;
        const float ex = s.tcx[t] - s.dcx[d], ey = s.tcy[t] - s.dcy[d];
        const float dist = sqrtf(ex * ex + ey * ey);
        const float avg = (((s.tw[t] + s.th[t]) + s.dw[d]) + s.dh[d]) * 0.25f;
        const float ratio = dist / (avg + 1e-6f);
        const float vf = 1.0f + fminf(s.tspeed[t] / (avg + 1e-6f), 2.0f);
        const bool lost = s.st[t] == kLost;
        float thr = cfg.gate_thr * vf, thr_l = cfg.lost_gate_thr * vf;
        if (lost) {
          thr = thr * 2.0f;
          thr_l = thr_l * 2.0f;
        }
        if (!lost && (degen || ratio < thr)) g = 1;
        if (lost && (degen || ratio < thr_l)) g = 2;
      }
      s.gate[t * D + d] = g;
      float c = kLock;
      if (g == 1) {
        c = 1.0f - oks_full(s, cfg, t, d, cfg.vis_thr);
        if (cfg.reid)
          c = cfg.reid_1mw * c +
              cfg.reid_w * reid_cost(s, femb + d * kEmb, t, d);
      }
      s.cost_t[d * T + t] = c;
    }
    __syncthreads();

    // ---- stages 3-5: three auction tiers ---------------------------------
    posebyte::auction_rounds(s.cost_t, s.act0, T, D, cfg.num_iters, cfg.eps0,
                             s.row, s.col, s.prices, s.col_bid);
    for (int tier = 2; tier <= 3; ++tier) {
      for (int i = tid; i < T * D; i += nth) {
        const int t = i % T, d = i / T;
        const uint8_t g = s.gate[t * D + d];
        const bool locked = s.row[t] >= 0 || s.col[d] >= 0;
        float c = kLock;
        if (!locked && tier == 2 && g == 1)
          c = 1.0f - oks_torso(s, cfg, t, d);
        else if (!locked && tier == 3 && g == 2) {
          c = 1.0f - oks_full(s, cfg, t, d, 0.2f);
          if (cfg.reid)
            c = cfg.reid_1mw * c +
                cfg.reid_w * reid_cost(s, femb + d * kEmb, t, d);
        }
        s.cost_t[d * T + t] = c;
      }
      __syncthreads();
      posebyte::auction_rounds(s.cost_t, s.act0, T, D, cfg.num_iters,
                               cfg.eps0, s.row_new, s.col_new, s.prices,
                               s.col_bid);
      for (int t = tid; t < T; t += nth)
        if (s.row[t] < 0) s.row[t] = s.row_new[t];
      for (int d = tid; d < D; d += nth)
        if (s.col[d] < 0) s.col[d] = s.col_new[d];
      __syncthreads();
    }

    // ---- stage 6: update matched; stage 7: age unmatched ------------------
    for (int i = tid; i < T * kNumKp; i += nth) {
      const int t = i / kNumKp;
      if (s.row[t] >= 0 && s.act0[t]) {
        const int j = s.row[t] * kNumKp + (i - t * kNumKp);
        if constexpr (kKalman) {
          // per-keypoint scalar gain (Kalman136.update): R = 5 / (conf +
          // 0.1), keypoints under 0.1 keep their state, both velocities
          // take the x gain; the pose is the filter's position
          float4 pv = fm[2 * i], cpv = fc[2 * i];
          const float c = s.dc[j];
          const bool use = c >= 0.1f;
          const float R = 5.0f / (c + 0.1f);
          const float Kx = cpv.x / (cpv.x + R), Ky = cpv.y / (cpv.y + R);
          const float Kv = 0.5f * Kx;
          const float ix = s.dx[j] - pv.x, iy = s.dy[j] - pv.y;
          pv.x = pv.x + (use ? Kx * ix : 0.0f);
          pv.y = pv.y + (use ? Ky * iy : 0.0f);
          pv.z = pv.z + (use ? Kv * ix : 0.0f);
          pv.w = pv.w + (use ? Kv * iy : 0.0f);
          if (use) {
            cpv.x = (1.0f - Kx) * cpv.x;
            cpv.y = (1.0f - Ky) * cpv.y;
          }
          fm[2 * i] = pv;
          fc[2 * i] = cpv;
          s.px[i] = pv.x;
          s.py[i] = pv.y;
          s.vx[i] = pv.z;
          s.vy[i] = pv.w;
        } else {
          const float ix = s.dx[j] - s.px[i], iy = s.dy[j] - s.py[i];
          s.px[i] = s.px[i] + cfg.gain * ix;
          s.py[i] = s.py[i] + cfg.gain * iy;
          s.vx[i] = cfg.alpha * ix + cfg.beta * s.vx[i];
          s.vy[i] = cfg.alpha * iy + cfg.beta * s.vy[i];
        }
        s.pc[i] = s.dc[j];
      }
    }
    // Re-ID: EMA of matched tracks' embeddings toward their detections,
    // renormalised over the 51 components (ops/reid.py::ema_update); the
    // second pass recomputes the same updated values to scale them.
    for (int t = tid; cfg.reid && t < T; t += nth) {
      if (s.row[t] < 0 || !s.act0[t]) continue;
      const float* e = femb + s.row[t] * kEmb;
      float n2 = 0.0f;
      for (int k = 0; k < kEmb; ++k) {
        const float u = cfg.ema_g * emb_plane(s, k % 3)[t * kNumKp + k / 3] +
                        cfg.ema_1mg * __ldg(e + k);
        n2 = k == 0 ? u * u : n2 + u * u;
      }
      const float nrm = fmaxf(sqrtf(n2), 1e-6f);
      for (int k = 0; k < kEmb; ++k) {
        float* plane = emb_plane(s, k % 3) + t * kNumKp + k / 3;
        const float u = cfg.ema_g * *plane + cfg.ema_1mg * __ldg(e + k);
        *plane = u / nrm;
      }
    }
    for (int t = tid; t < T; t += nth) {
      if (!s.act0[t]) continue;
      if (s.row[t] >= 0) {
        s.tsc[t] = s.dsc[s.row[t]];
        s.hits[t] = s.hits[t] + 1;
        s.ages[t] = 0;
        s.lf[t] = frame;
        if ((s.st[t] == kTentative && s.hits[t] >= cfg.min_hits) ||
            s.st[t] == kLost)
          s.st[t] = kConfirmed;
      } else {
        s.ages[t] = s.ages[t] + 1;
        const int st = s.st[t], age = s.ages[t];
        const bool dead = (st == kTentative && age > cfg.tent_max_age) ||
                          (st == kLost && age > cfg.lost_dead_age);
        if (st == kConfirmed && age > cfg.max_age) s.st[t] = kLost;
        if (dead) s.active[t] = 0;
      }
    }
    for (int d = tid; d < D; d += nth)
      s.newdet[d] = s.dvalid[d] && s.col[d] < 0 && s.dsc[d] >= cfg.new_thr;
    __syncthreads();

    // ---- stage 8: new tracks by prefix-sum ranks --------------------------
    for (int t = tid; t < T; t += nth) {
      int r = 0;
      for (int u = 0; u < t; ++u) r += s.active[u] ? 0 : 1;
      s.trank[t] = r;
    }
    for (int d = tid; d < D; d += nth) {
      int r = 0;
      for (int e = 0; e < d; ++e) r += s.newdet[e];
      s.drank[d] = r;
    }
    __syncthreads();
    const int num_free = s.trank[T - 1] + (s.active[T - 1] ? 0 : 1);
    const int total_new = s.drank[D - 1] + s.newdet[D - 1];
    const int num_new = total_new < num_free ? total_new : num_free;
    const int next_id = s.misc[0];
    for (int t = tid; t < T; t += nth)
      if (!s.active[t]) s.free_slot[s.trank[t]] = t;
    __syncthreads();
    for (int d = tid; d < D; d += nth) {
      if (s.newdet[d] && s.drank[d] < num_free) {
        const int slot = s.free_slot[s.drank[d]];
        s.col[d] = slot;
        s.tsc[slot] = s.dsc[d];
        s.ids[slot] = next_id + s.drank[d];
        s.hits[slot] = 1;
        s.ages[slot] = 0;
        s.st[slot] = kTentative;
        s.lf[slot] = frame;
      }
    }
    for (int i = tid; i < D * kNumKp; i += nth) {
      const int d = i / kNumKp;
      if (s.newdet[d] && s.drank[d] < num_free) {
        const int j = s.free_slot[s.drank[d]] * kNumKp + (i - d * kNumKp);
        s.px[j] = s.dx[i];
        s.py[j] = s.dy[i];
        s.pc[j] = s.dc[i];
        s.vx[j] = 0.0f;
        s.vy[j] = 0.0f;
        if (cfg.reid) {
          s.er[j] = __ldg(femb + i * 3);
          s.eg[j] = __ldg(femb + i * 3 + 1);
          s.eb[j] = __ldg(femb + i * 3 + 2);
        }
        if constexpr (kKalman) {
          // Kalman136.initiate: the detection's position, zero derivatives;
          // position variance 10 (1000 where conf <= 0), the rest 100
          const float pv = s.dc[i] > 0.0f ? 10.0f : 1000.0f;
          fm[2 * j] = make_float4(s.dx[i], s.dy[i], 0.0f, 0.0f);
          fm[2 * j + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          fc[2 * j] = make_float4(pv, pv, 100.0f, 100.0f);
          fc[2 * j + 1] = make_float4(100.0f, 100.0f, 100.0f, 100.0f);
        }
      }
    }
    __syncthreads();
    // (after the barrier: the rank pass above read the old flags)
    for (int d = tid; d < D; d += nth)
      if (s.newdet[d] && s.drank[d] < num_free) s.active[s.col[d]] = 1;
    if (tid == 0) s.misc[0] = next_id + num_new;
    __syncthreads();

    // ---- stage 9: dominance dedup (centres from gating time) ---------------
    for (int t = tid; t < T; t += nth) {
      s.flag[t] = 0;
      if (!(s.active[t] && s.st[t] != kLost && s.hits[t] >= cfg.min_hits))
        continue;
      const float ahw = s.tw[t] * 0.5f, ahh = s.th[t] * 0.5f;
      const float ax1 = s.tcx[t] - ahw, ay1 = s.tcy[t] - ahh;
      const float ax2 = s.tcx[t] + ahw, ay2 = s.tcy[t] + ahh;
      for (int u = 0; u < T; ++u) {
        if (u == t ||
            !(s.active[u] && s.st[u] != kLost && s.hits[u] >= cfg.min_hits))
          continue;
        if (!(s.hits[t] < s.hits[u] ||
              (s.hits[t] == s.hits[u] && s.ids[t] > s.ids[u])))
          continue;
        const float bhw = s.tw[u] * 0.5f, bhh = s.th[u] * 0.5f;
        const float bx1 = s.tcx[u] - bhw, by1 = s.tcy[u] - bhh;
        const float bx2 = s.tcx[u] + bhw, by2 = s.tcy[u] + bhh;
        const float ix = fmaxf(fminf(ax2, bx2) - fmaxf(ax1, bx1), 0.0f);
        const float iy = fmaxf(fminf(ay2, by2) - fmaxf(ay1, by1), 0.0f);
        const float inter = ix * iy;
        const float uni =
            ((ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1)) - inter;
        const float iou = uni > 0.0f ? inter / fmaxf(uni, 1e-9f) : 0.0f;
        if (iou > cfg.dedup_iou) {
          s.flag[t] = 1;
          break;
        }
      }
    }
    __syncthreads();
    for (int t = tid; t < T; t += nth)
      if (s.flag[t]) s.active[t] = 0;
    __syncthreads();

    // ---- outputs (tracker/output.py::extract_outputs_device) -------------
    for (int d = tid; d < D; d += nth) {
      const int slot = s.col[d];
      const int sf = slot < 0 ? 0 : (slot > T - 1 ? T - 1 : slot);
      const int st = s.st[sf];
      const bool emit = slot >= 0 && s.active[sf] &&
                        !(st == kTentative && s.hits[sf] < cfg.min_hits) &&
                        st != kLost && adv;
      const size_t o = f * D + d;
      p.o_ids[o] = emit ? s.ids[sf] : -1;
      p.o_scores[o] = emit ? s.dsc[d] : 0.0f;
      p.o_emit[o] = emit ? 1 : 0;
      float bx[4];
      const int n = kp_box(s.px + sf * kNumKp, s.py + sf * kNumKp,
                           s.pc + sf * kNumKp, 0.2f, bx);
      const float padx = (bx[2] - bx[0]) * 0.1f, pady = (bx[3] - bx[1]) * 0.1f;
      float* ob = p.o_boxes + o * 4;
      ob[0] = n > 0 ? bx[0] - padx : 0.0f;
      ob[1] = n > 0 ? bx[1] - pady : 0.0f;
      ob[2] = n > 0 ? bx[2] + padx : 0.0f;
      ob[3] = n > 0 ? bx[3] + pady : 0.0f;
    }
    float* op = p.o_poses + f * D * kNumKp * 3;
    for (int i = tid; i < D * kNumKp * 3; i += nth) {
      const int d = i / (kNumKp * 3), r = i - d * kNumKp * 3;
      const int slot = s.col[d];
      const int j = (slot < 0 ? 0 : (slot > T - 1 ? T - 1 : slot)) * kNumKp +
                    r / 3;
      const int c = r % 3;
      op[i] = c == 0 ? s.px[j] : (c == 1 ? s.py[j] : s.pc[j]);
    }
    if (tid == 0) {
      int n = 0;
      for (int t = 0; t < T; ++t) n += s.active[t];
      p.o_num_active[f] = adv ? n : 0;
    }
    __syncthreads();
    if (!adv) {
      load_state(s, p, cfg, b, true);
      __syncthreads();
    }
  }
  store_state(s, p, cfg, b);
}

}  // namespace

extern "C" size_t posebyte_tracker_chunk_smem_bytes(int T, int D,
                                                    int reid) {
  Smem s;
  return carve(s, 0, T, D, reid != 0);
}

// ptrs: kNumPtrs device pointers in the order of struct Ptrs (det_emb
// null without Re-ID, the five filter pointers null for cv); iargs: S, K,
// T, D, min_hits, max_age, lost_dead_age (max_age + lost_window),
// num_iters, tent_max_age, reid (0 or 1), kalman (0 or 1); fargs:
// gate_thr, lost_gate_thr, vis_thr, dedup_iou, new_thr, gain, alpha, beta
// (1 - alpha), lost_decay, eps0, the 17 full-OKS and 4 torso
// (sigma scale)^2 values, reid_weight, 1 - reid_weight, reid_ema,
// 1 - reid_ema, then accel_memory, jerk_memory, float32(1/6) and the four
// process noises (p, v, a, j). Launches one block per stream on `stream`
// with the cv or the kalman136 kernel; returns the launch status.
extern "C" cudaError_t posebyte_tracker_chunk(void* const* ptrs,
                                              const int* iargs,
                                              const float* fargs,
                                              void* stream) {
  Ptrs p;
  static_assert(sizeof(Ptrs) == kNumPtrs * sizeof(void*), "pointer table");
  for (int i = 0; i < kNumPtrs; ++i)
    reinterpret_cast<void**>(&p)[i] = ptrs[i];
  Cfg cfg;
  int* ci = &cfg.S;
  for (int i = 0; i < kNumIntArgs; ++i) ci[i] = iargs[i];
  float* cf = &cfg.gate_thr;
  for (int i = 0; i < kNumFloatArgs; ++i) cf[i] = fargs[i];
  if (cfg.S <= 0 || cfg.K <= 0 || cfg.T <= 0 || cfg.D <= 0 ||
      (cfg.reid && p.det_emb == nullptr) ||
      (cfg.kalman && (!p.in_kf_mean || !p.in_kf_cov || !p.out_kf_mean ||
                      !p.out_kf_cov || !p.kf_scratch)))
    return cudaErrorInvalidValue;
  const size_t smem =
      posebyte_tracker_chunk_smem_bytes(cfg.T, cfg.D, cfg.reid);
  void (*kernel)(Ptrs, Cfg) = cfg.kalman ? tracker_chunk_kernel<true>
                                         : tracker_chunk_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<cfg.S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p,
                                                                        cfg);
  return cudaGetLastError();
}
