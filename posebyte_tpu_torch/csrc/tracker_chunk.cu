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
// are sequential and each is ~20 barrier-separated steps plus the auction
// rounds, on one SM per stream. kalman136 adds the filter's 278,528 B of L2
// traffic per frame (read and written by predict; device memory sees it
// once per chunk, 2 x 139,264 B per stream) and 28 operations per
// (slot, keypoint) for the predict of every slot.
//
// Design (v2): one block of kThreads = 256 threads per stream (grid = S)
// that loops over the K frames with the whole slot pool in shared memory
// (unpadded [T, 17] keypoint planes). Each frame first compacts, in index
// order, the tracks active as it enters and its valid detections
// (__ballot_sync / __popc ranks, compact2), and runs the gates, the three
// tiers' costs and auctions on the n_act x n_valid pairs only: an inactive
// row never bids, and a column that is never bid on keeps price 0, so its
// value -1e9 equals the scan's initial second best and leaving it out
// changes no bid; the lists keep index order, so ties still go to the
// lower column and row. The auction (posebyte::auction_rounds, shared with
// Kernel 2) computes each bid with a group of lanes and shuffles. Free
// slots, new detections and dedup candidates are compacted the same way,
// so ranks and counts take two barriers and no serial loop; the dedup runs
// over the confirmed tracks' pairs; num_active is a __syncthreads_count.
// While frame k runs, frame k+1's detections (poses, scores, valid flags,
// and with Re-ID at D = 64 their embeddings) arrive by cp.async in a
// second buffer, waited for at the start of frame k+1; where the second
// buffer does not fit (Re-ID at D = 128: 219 KB of the 227 KB a block may
// have without it) each frame copies its own at its start by cp.async,
// and where the rows are not 16-byte aligned (D not a multiple of 16)
// element by element. Detections stay in their device layout [D, 17, 3]
// in shared memory (a stride of 3 words: no bank conflicts). A tier whose
// costs are all the lock value (no gated, unlocked pair) skips its
// auction, which would assign nothing. kalman136 adds no
// shared memory: its filter, 16 floats per (slot, keypoint), 139,264 B
// per stream at T = 128, would not fit beside the pool, so the block keeps
// it in the output buffers kf_mean / kf_cov [S, T, 136] (natural layout
// t * 136 + k * 8 + c; copied from the input at the start) and reads and
// writes each (slot, keypoint)'s 8 components as two float4 from the
// thread that owns it; it stays in L2. The vx / vy planes hold the
// filter's velocities and qx / qy the prediction. A barrier orders the
// block's device-memory writes as it orders its shared ones. A frame that
// does not advance first saves the state to the output state buffers and
// restores it afterwards; with kalman136 it works on a copy of the filter
// in the wrapper's scratch buffer [S, 2, T, 136] and leaves the outputs'
// filter as it was. The only atomic is the order-free 64-bit atomicMax
// inside auction_rounds. Every loop that holds a barrier or a warp
// collective runs the same number of times on every thread (the frame
// loop, compact2's tiles, the auction's __syncthreads_or exit), and the
// advance flag is read by every thread, so no barrier is skipped.
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
constexpr int kWarps = kThreads / 32;
constexpr int kTentative = 0, kConfirmed = 1, kLost = 2;
constexpr float kLock = 1e9f;
constexpr float kBig = 1e9f;
constexpr int kDetF = kNumKp * 3;  // floats of one detection's pose

#ifndef POSEBYTE_CUDA_EMULATION
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

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
  // [S, kClockCols] int64 or null: the stage clock (StageClock)
  long long* stage_cycles;
};
constexpr int kNumPtrs = 41;

struct Cfg {
  int S, K, T, D;
  int min_hits, max_age, lost_dead_age, num_iters, tent_max_age;
  int reid;            // 1: Re-ID on
  int kalman;          // 1: the kalman136 motion model
  int pre;             // set by the launcher: detections prefetched
  int emb_smem;        // set by the launcher: their embeddings too
  int async_ld;        // set by the launcher: loaded by cp.async
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

// The stage clock: with Ptrs::stage_cycles set, thread 0 reads clock64()
// right after the barrier that ends each stage and adds the cycles since
// the last reading to that stage's counter of its stream; it also counts
// each tier's auction rounds and the frames whose tier used the whole
// round budget. Null on every pipeline path, where it costs one untaken
// branch per stage.
enum Stage {
  kStState, kStDets, kStPredict, kStCentres, kStGate, kStTier1, kStTier2,
  kStTier3, kStUpdate, kStBirths, kStDedup, kStOutputs, kNumStages
};
constexpr int kClockRounds = kNumStages;       // + tier - 1
constexpr int kClockBudget = kNumStages + 3;   // + tier - 1
constexpr int kClockCols = kNumStages + 6;

struct StageClock {
  unsigned long long* acc;  // this stream's row, or null
  long long last;
  __device__ void lap(int stage) {
    if (acc != nullptr && threadIdx.x == 0) {
      const long long now = clock64();
      atomicAdd(acc + stage, static_cast<unsigned long long>(now - last));
      last = now;
    }
  }
  __device__ void rounds(int tier, int n, int budget) {
    if (acc != nullptr && threadIdx.x == 0) {
      atomicAdd(acc + kClockRounds + tier - 1,
                static_cast<unsigned long long>(n));
      if (n >= budget) atomicAdd(acc + kClockBudget + tier - 1, 1ull);
    }
  }
};

// Shared memory, carved from one dynamic buffer. Per-detection arrays
// named [n_val] are indexed by a detection's place in the frame's list of
// valid detections; cost and gate by (place of the track in the list of
// active tracks) * n_val + (place of the detection).
struct Smem {
  unsigned long long* col_bid;                       // [D]
  float *px, *py, *pc, *vx, *vy, *qx, *qy;           // [T*17]
  float *tsc, *tcx, *tcy, *tw, *th, *tarea, *tspeed;  // [T]
  float *er, *eg, *eb;                      // [T*17] (Re-ID, else null)
  float* dpose;        // [nbuf][D*51] the detections' poses, device layout
  float* dscore;       // [nbuf][D]
  uint8_t* dvalid;     // [nbuf][D]
  float* demb;         // [nbuf][D*51] (emb_smem, else null)
  float* de;                                // [D*17] (Re-ID, else null)
  float *dcx, *dcy, *dw, *dh, *darea, *prices;       // [n_val]
  float* cost;                                       // [n_act * n_val]
  int *ids, *st, *hits, *ages, *lf, *row, *ra;       // [T]
  int *act_list, *free_list, *conf_list;             // [T]
  int *col, *ca, *det_list, *new_list;               // [D]
  int* misc;                                 // [2] next_id, frame
  int* warp_sums;                            // [2][kWarps]
  uint8_t *active, *flag;                            // [T]
  uint8_t* gate;                                     // [n_act * n_val]
};

template <class P>
__host__ __device__ inline P* take(uintptr_t base, size_t& off, size_t n) {
  off = (off + 15) & ~static_cast<size_t>(15);  // 16 B: cp.async targets
  P* p = reinterpret_cast<P*>(base + off);
  off += n * sizeof(P);
  return p;
}

// Lays the arrays out from `base`; returns the bytes used. pre: two
// detection buffers instead of one; emb_smem: the detections' embeddings
// in shared memory too.
__host__ __device__ inline size_t carve(Smem& s, uintptr_t base, int T,
                                        int D, bool reid, bool pre,
                                        bool emb_smem) {
  size_t o = 0;
  const size_t TK = (size_t)T * kNumKp, DK = (size_t)D * kNumKp;
  const int nbuf = pre ? 2 : 1;
  s.col_bid = take<unsigned long long>(base, o, D);
  float** tplanes[] = {&s.px, &s.py, &s.pc, &s.vx, &s.vy, &s.qx, &s.qy};
  for (float** p : tplanes) *p = take<float>(base, o, TK);
  float** tvec[] = {&s.tsc, &s.tcx, &s.tcy, &s.tw, &s.th, &s.tarea,
                    &s.tspeed};
  for (float** p : tvec) *p = take<float>(base, o, T);
  float** eplanes[] = {&s.er, &s.eg, &s.eb};
  for (float** p : eplanes) *p = reid ? take<float>(base, o, TK) : nullptr;
  s.dpose = take<float>(base, o, nbuf * D * kDetF);
  s.dscore = take<float>(base, o, nbuf * D);
  s.dvalid = take<uint8_t>(base, o, nbuf * D);
  s.demb = emb_smem ? take<float>(base, o, nbuf * D * kEmb) : nullptr;
  s.de = reid ? take<float>(base, o, DK) : nullptr;
  float** dvec[] = {&s.dcx, &s.dcy, &s.dw, &s.dh, &s.darea, &s.prices};
  for (float** p : dvec) *p = take<float>(base, o, D);
  s.cost = take<float>(base, o, (size_t)T * D);
  int** tint[] = {&s.ids, &s.st, &s.hits, &s.ages, &s.lf, &s.row,
                  &s.ra, &s.act_list, &s.free_list, &s.conf_list};
  for (int** p : tint) *p = take<int>(base, o, T);
  int** dint[] = {&s.col, &s.ca, &s.det_list, &s.new_list};
  for (int** p : dint) *p = take<int>(base, o, D);
  s.misc = take<int>(base, o, 2);
  s.warp_sums = take<int>(base, o, 2 * kWarps);
  s.active = take<uint8_t>(base, o, T);
  s.flag = take<uint8_t>(base, o, T);
  s.gate = take<uint8_t>(base, o, (size_t)T * D);
  return o;
}

// Block-wide stream compaction of two predicates at once, in index order:
// list_a gets the i in [0, n_a) with pred_a(i) in increasing order, list_b
// likewise; returns the two counts (the same on every thread). A tile of
// blockDim.x indices per step: a warp's ballot gives each lane its rank
// among the warp's (the lanes below it), the warps' counts in shared memory
// its warp's offset. Two barriers per tile, the second of which ends the
// call; every thread runs the same number of tiles.
template <class PA, class PB>
__device__ inline int2 compact2(int n_a, PA pred_a, int* list_a, int n_b,
                                PB pred_b, int* list_b, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int2 total = make_int2(0, 0);
  const int n = n_a > n_b ? n_a : n_b;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + tid;
    const bool pa = i < n_a && pred_a(i), pb = i < n_b && pred_b(i);
    const unsigned ba = __ballot_sync(0xffffffffu, pa);
    const unsigned bb = __ballot_sync(0xffffffffu, pb);
    if (lane == 0) {
      warp_sums[warp] = __popc(ba);
      warp_sums[nw + warp] = __popc(bb);
    }
    __syncthreads();
    int oa = total.x, ob = total.y, ta = 0, tb = 0;
    for (int w = 0; w < nw; ++w) {
      const int ca = warp_sums[w], cb = warp_sums[nw + w];
      if (w < warp) {
        oa += ca;
        ob += cb;
      }
      ta += ca;
      tb += cb;
    }
    if (pa) list_a[oa + __popc(ba & below)] = i;
    if (pb) list_b[ob + __popc(bb & below)] = i;
    total.x += ta;
    total.y += tb;
    __syncthreads();  // warp_sums is reused; the lists are complete
  }
  return total;
}

// Box of the keypoints above `thr` of one pose (x, y, c at stride `st`):
// (min x, min y, max x, max y, count); +-1e9 where none.
__device__ inline int kp_box(const float* x, const float* y, const float* c,
                             int st, float thr, float* b) {
  float mnx = kBig, mny = kBig, mxx = -kBig, mxy = -kBig;
  int n = 0;
  for (int q = 0; q < kNumKp; ++q) {
    if (c[q * st] > thr) {
      mnx = fminf(mnx, x[q * st]);
      mny = fminf(mny, y[q * st]);
      mxx = fmaxf(mxx, x[q * st]);
      mxy = fmaxf(mxy, y[q * st]);
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
                                       const float* c, int st, float* cx,
                                       float* cy, float* w, float* h,
                                       float* area) {
  float b[4];
  const int n = kp_box(x, y, c, st, 0.1f, b);
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

// Full OKS of predicted track t against a detection's pose dp [17, 3] of
// area `darea` (ops/oks.py::oks_matrix, sigma_scale 2, min scale^2 1000,
// >= 3 co-visible keypoints).
__device__ inline float oks_full(const Smem& s, const Cfg& cfg, int t,
                                 const float* dp, float darea, float vis) {
  const float den = 2.0f * fmaxf((s.tarea[t] + darea) * 0.5f, 1000.0f);
  const float *tx = s.qx + t * kNumKp, *ty = s.qy + t * kNumKp,
              *tc = s.pc + t * kNumKp;
  float sum = 0.0f;
  int n = 0;
  for (int q = 0; q < kNumKp; ++q) {
    if (tc[q] > vis && dp[q * 3 + 2] > vis) {
      const float ddx = tx[q] - dp[q * 3], ddy = ty[q] - dp[q * 3 + 1];
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
                                  const float* dp) {
  float sum = 0.0f;
  int n = 0;
  for (int j = 0; j < 4; ++j) {
    const int ti = t * kNumKp + torso_kp(j), di = torso_kp(j) * 3;
    if (s.pc[ti] > 0.1f && dp[di + 2] > 0.1f) {
      const float ddx = s.qx[ti] - dp[di], ddy = s.qy[ti] - dp[di + 1];
      const float d2 = ddx * ddx + ddy * ddy;
      sum = sum + expf(-d2 / (20000.0f * cfg.sigt[j]));
      ++n;
    }
  }
  return n >= 2 ? sum / static_cast<float>(n) : 0.0f;
}

// Re-ID appearance cost of track t against a detection's embedding `emb`
// [51] (shared or device memory) with per-keypoint energies `de` [17]
// (ops/reid.py::cosine_cost_matrix): 1 - cosine over the keypoints whose
// energy exceeds 1e-12 on both sides, 1.0 with none; each sum runs in
// keypoint order as sum_in_order does, a skipped keypoint adding 0.
__device__ inline float reid_cost(const Smem& s, const float* emb,
                                  const float* de, int t) {
  float num = 0.0f, tsum = 0.0f, dsum = 0.0f;
  bool any = false;
  for (int q = 0; q < kNumKp; ++q) {
    const int i = t * kNumKp + q;
    const float r = s.er[i], g = s.eg[i], b = s.eb[i];
    const float te = (r * r + g * g) + b * b;
    const float dq = de[q];
    const bool vis = te > 1e-12f && dq > 1e-12f;
    float xn = 0.0f, xt = 0.0f, xd = 0.0f;
    if (vis) {
      xn = (r * emb[q * 3] + g * emb[q * 3 + 1]) + b * emb[q * 3 + 2];
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

// Frame f's detections into buffer `buf`: with cfg.async_ld by cp.async
// (16-byte pieces; committed as one group, waited for by the caller),
// else element by element.
__device__ inline void load_dets(const Smem& s, const Ptrs& p,
                                 const Cfg& cfg, size_t f, int buf) {
  const int D = cfg.D, tid = threadIdx.x, nth = blockDim.x;
  float* dp = s.dpose + (size_t)buf * D * kDetF;
  float* dsc = s.dscore + (size_t)buf * D;
  uint8_t* dv = s.dvalid + (size_t)buf * D;
  const float* gp = p.det_poses + f * D * kDetF;
  const float* gs = p.det_scores + f * D;
  const uint8_t* gv = p.det_valid + f * D;
  if (cfg.async_ld) {
    const int np = D * kDetF / 4, ns = D / 4, nv = D / 16;
    const int ne = cfg.emb_smem ? D * kEmb / 4 : 0;
    float* de = cfg.emb_smem ? s.demb + (size_t)buf * D * kEmb : nullptr;
    const float* ge = cfg.emb_smem ? p.det_emb + f * D * kEmb : nullptr;
    for (int i = tid; i < np + ns + nv + ne; i += nth) {
      if (i < np)
        cp_async_16(dp + 4 * i, gp + 4 * i, 16);
      else if (i < np + ns)
        cp_async_16(dsc + 4 * (i - np), gs + 4 * (i - np), 16);
      else if (i < np + ns + nv)
        cp_async_16(dv + 16 * (i - np - ns), gv + 16 * (i - np - ns), 16);
      else
        cp_async_16(de + 4 * (i - np - ns - nv), ge + 4 * (i - np - ns - nv),
                    16);
    }
    cp_async_commit();
  } else {
#pragma unroll 4
    for (int i = tid; i < D * kDetF; i += nth) dp[i] = gp[i];
    for (int d = tid; d < D; d += nth) {
      dsc[d] = gs[d];
      dv[d] = gv[d] ? 1 : 0;
    }
  }
}

// One block per SM: the register file is the block's (up to 255 a thread,
// no spills in either instantiation; at 512 threads, 128 a thread, both
// spilled 108-140 B).
template <bool kKalman>
__global__ void __launch_bounds__(kThreads, 1)
    tracker_chunk_kernel(Ptrs p, Cfg cfg) {
  extern __shared__ unsigned long long smem[];
  Smem s;
  carve(s, reinterpret_cast<uintptr_t>(smem), cfg.T, cfg.D, cfg.reid != 0,
        cfg.pre != 0, cfg.emb_smem != 0);
  const int T = cfg.T, D = cfg.D, K = cfg.K, tid = threadIdx.x;
  const int nth = blockDim.x;
  const int b = blockIdx.x;
  StageClock clk{p.stage_cycles == nullptr ? nullptr
                     : reinterpret_cast<unsigned long long*>(
                           p.stage_cycles) + (size_t)b * kClockCols,
                 0};
  if (clk.acc != nullptr && tid == 0) clk.last = clock64();

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
  if (cfg.pre) load_dets(s, p, cfg, (size_t)b * K, 0);  // frame 0
  __syncthreads();
  clk.lap(kStState);

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
      clk.lap(kStState);
    }

    // ---- the frame's detections (prefetched while the last frame ran) ---
    const int buf = cfg.pre ? (k & 1) : 0;
    if (!cfg.pre) load_dets(s, p, cfg, f, 0);
    if (cfg.async_ld)
      cp_async_wait<0>();
    __syncthreads();
    clk.lap(kStDets);
    if (cfg.pre && k + 1 < K) load_dets(s, p, cfg, f + 1, buf ^ 1);
    const float* dp = s.dpose + (size_t)buf * D * kDetF;
    const float* dsc = s.dscore + (size_t)buf * D;
    const uint8_t* dval = s.dvalid + (size_t)buf * D;
    // the frame's detection embeddings [D, 51] (Re-ID): in shared memory
    // with emb_smem, else read from device memory
    const float* femb =
        !cfg.reid ? nullptr
        : cfg.emb_smem ? s.demb + (size_t)buf * D * kEmb
                       : p.det_emb + f * D * kEmb;

    // ---- stage 1: predict; the lists of the frame -----------------------
    if (cfg.reid) {
      for (int i = tid; i < D * kNumKp; i += nth) {
        const float* e = femb + i * 3;
        const float r = e[0], g = e[1], b = e[2];
        s.de[i] = (r * r + g * g) + b * b;
      }
    }
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
    // the tracks active as the frame enters and its valid detections
    const int2 nl = compact2(
        T, [&](int t) { return s.active[t] != 0; }, s.act_list, D,
        [&](int d) { return dval[d] != 0; }, s.det_list, s.warp_sums);
    const int n_act = nl.x, n_val = nl.y, n_pair = n_act * n_val;
    clk.lap(kStPredict);

    // ---- stage 2: centres, areas, torso speed ----------------------------
    // (every slot's: the dedup reads a newborn track's from its slot)
    for (int t = tid; t < T; t += nth) {
      const int o = t * kNumKp;
      centre_and_area(s.qx + o, s.qy + o, s.pc + o, 1, &s.tcx[t], &s.tcy[t],
                      &s.tw[t], &s.th[t], &s.tarea[t]);
      float sp = 0.0f;
      for (int j = 0; j < 4; ++j) {
        const float a = s.vx[o + torso_kp(j)], c = s.vy[o + torso_kp(j)];
        const float v = sqrtf(a * a + c * c);
        sp = j == 0 ? v : sp + v;
      }
      s.tspeed[t] = sp * 0.25f;
      s.row[t] = -1;
      s.flag[t] = 0;
    }
    for (int c = tid; c < n_val; c += nth) {
      const float* d = dp + s.det_list[c] * kDetF;
      centre_and_area(d, d + 1, d + 2, 3, &s.dcx[c], &s.dcy[c], &s.dw[c],
                      &s.dh[c], &s.darea[c]);
    }
    for (int d = tid; d < D; d += nth) s.col[d] = -1;
    __syncthreads();
    clk.lap(kStCentres);

    // ---- spatial gates and the tier-1 cost, on the listed pairs ----------
    // gate 1: tier 1/2 pairs (gate & non-lost track); 2: tier 3 pairs
    // (lost gate & lost track).
    const int frame = s.misc[1];
    int gated = 0;  // this thread wrote a pair's cost below the lock
    for (int i = tid; i < n_pair; i += nth) {
      const int r = i / n_val, c = i - r * n_val;
      const int t = s.act_list[r], d = s.det_list[c];
      const bool degen = s.tw[t] < 1.0f || s.th[t] < 1.0f ||
                         s.dw[c] < 1.0f || s.dh[c] < 1.0f;
      const float ex = s.tcx[t] - s.dcx[c], ey = s.tcy[t] - s.dcy[c];
      const float dist = sqrtf(ex * ex + ey * ey);
      const float avg = (((s.tw[t] + s.th[t]) + s.dw[c]) + s.dh[c]) * 0.25f;
      const float ratio = dist / (avg + 1e-6f);
      const float vf = 1.0f + fminf(s.tspeed[t] / (avg + 1e-6f), 2.0f);
      const bool lost = s.st[t] == kLost;
      float thr = cfg.gate_thr * vf, thr_l = cfg.lost_gate_thr * vf;
      if (lost) {
        thr = thr * 2.0f;
        thr_l = thr_l * 2.0f;
      }
      uint8_t g = 0;
      if (!lost && (degen || ratio < thr)) g = 1;
      if (lost && (degen || ratio < thr_l)) g = 2;
      s.gate[i] = g;
      float cst = kLock;
      gated |= g == 1;
      if (g == 1) {
        cst = 1.0f - oks_full(s, cfg, t, dp + d * kDetF, s.darea[c],
                              cfg.vis_thr);
        if (cfg.reid)
          cst = cfg.reid_1mw * cst +
                cfg.reid_w * reid_cost(s, femb + d * kEmb,
                                       s.de + d * kNumKp, t);
      }
      s.cost[i] = cst;
    }
    int bids = __syncthreads_or(gated);  // may any row of tier 1 bid?
    clk.lap(kStGate);

    // ---- stages 3-5: three auction tiers ---------------------------------
    // Each tier's assignment (ra per listed track, ca per listed detection)
    // fills the slots that earlier tiers left unmatched. A tier whose costs
    // are all the lock value would assign nothing: its auction is skipped.
    for (int tier = 1; tier <= 3; ++tier) {
      if (tier > 1) {
        gated = 0;
        for (int i = tid; i < n_pair; i += nth) {
          const int r = i / n_val, c = i - r * n_val;
          const int t = s.act_list[r], d = s.det_list[c];
          const uint8_t g = s.gate[i];
          const bool locked = s.row[t] >= 0 || s.col[d] >= 0;
          float cst = kLock;
          if (!locked && tier == 2 && g == 1)
            cst = 1.0f - oks_torso(s, cfg, t, dp + d * kDetF);
          else if (!locked && tier == 3 && g == 2) {
            cst = 1.0f - oks_full(s, cfg, t, dp + d * kDetF, s.darea[c],
                                  0.2f);
            if (cfg.reid)
              cst = cfg.reid_1mw * cst +
                    cfg.reid_w * reid_cost(s, femb + d * kEmb,
                                           s.de + d * kNumKp, t);
          }
          gated |= cst < kLock;
          s.cost[i] = cst;
        }
        bids = __syncthreads_or(gated);
      }
      if (bids) {  // block-uniform
        clk.rounds(tier,
                   posebyte::auction_rounds(s.cost, nullptr, n_act, n_val,
                                            cfg.num_iters, cfg.eps0, s.ra,
                                            s.ca, s.prices, s.col_bid),
                   cfg.num_iters);
        for (int r = tid; r < n_act; r += nth) {
          const int t = s.act_list[r];
          if (s.row[t] < 0 && s.ra[r] >= 0) s.row[t] = s.det_list[s.ra[r]];
        }
        for (int c = tid; c < n_val; c += nth) {
          const int d = s.det_list[c];
          if (s.col[d] < 0 && s.ca[c] >= 0) s.col[d] = s.act_list[s.ca[c]];
        }
        __syncthreads();
      }
      clk.lap(kStTier1 + tier - 1);
    }

    // ---- stage 6: update matched; stage 7: age unmatched ------------------
    for (int i = tid; i < n_act * kNumKp; i += nth) {
      const int r = i / kNumKp, q = i - r * kNumKp;
      const int t = s.act_list[r], m = s.row[t];
      if (m < 0) continue;
      const int ti = t * kNumKp + q;
      const float* dq = dp + (m * kNumKp + q) * 3;  // x, y, conf
      if constexpr (kKalman) {
        // per-keypoint scalar gain (Kalman136.update): R = 5 / (conf +
        // 0.1), keypoints under 0.1 keep their state, both velocities
        // take the x gain; the pose is the filter's position
        float4 pv = fm[2 * ti], cpv = fc[2 * ti];
        const float c = dq[2];
        const bool use = c >= 0.1f;
        const float R = 5.0f / (c + 0.1f);
        const float Kx = cpv.x / (cpv.x + R), Ky = cpv.y / (cpv.y + R);
        const float Kv = 0.5f * Kx;
        const float ix = dq[0] - pv.x, iy = dq[1] - pv.y;
        pv.x = pv.x + (use ? Kx * ix : 0.0f);
        pv.y = pv.y + (use ? Ky * iy : 0.0f);
        pv.z = pv.z + (use ? Kv * ix : 0.0f);
        pv.w = pv.w + (use ? Kv * iy : 0.0f);
        if (use) {
          cpv.x = (1.0f - Kx) * cpv.x;
          cpv.y = (1.0f - Ky) * cpv.y;
        }
        fm[2 * ti] = pv;
        fc[2 * ti] = cpv;
        s.px[ti] = pv.x;
        s.py[ti] = pv.y;
        s.vx[ti] = pv.z;
        s.vy[ti] = pv.w;
      } else {
        const float ix = dq[0] - s.px[ti], iy = dq[1] - s.py[ti];
        s.px[ti] = s.px[ti] + cfg.gain * ix;
        s.py[ti] = s.py[ti] + cfg.gain * iy;
        s.vx[ti] = cfg.alpha * ix + cfg.beta * s.vx[ti];
        s.vy[ti] = cfg.alpha * iy + cfg.beta * s.vy[ti];
      }
      s.pc[ti] = dq[2];
    }
    for (int r = tid; r < n_act; r += nth) {
      const int t = s.act_list[r], m = s.row[t];
      if (m >= 0) {
        // Re-ID: EMA toward the detection's embedding, renormalised over
        // the 51 components (ops/reid.py::ema_update); the second pass
        // recomputes the same updated values to scale them
        if (cfg.reid) {
          const float* e = femb + m * kEmb;
          float n2 = 0.0f;
          for (int j = 0; j < kEmb; ++j) {
            const float u =
                cfg.ema_g * emb_plane(s, j % 3)[t * kNumKp + j / 3] +
                cfg.ema_1mg * e[j];
            n2 = j == 0 ? u * u : n2 + u * u;
          }
          const float nrm = fmaxf(sqrtf(n2), 1e-6f);
          for (int j = 0; j < kEmb; ++j) {
            float* plane = emb_plane(s, j % 3) + t * kNumKp + j / 3;
            const float u = cfg.ema_g * *plane + cfg.ema_1mg * e[j];
            *plane = u / nrm;
          }
        }
        s.tsc[t] = dsc[m];
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
    const int next_id = s.misc[0];
    __syncthreads();
    clk.lap(kStUpdate);

    // ---- stage 8: new tracks in free slots, in detection order -----------
    const int2 nb = compact2(
        T, [&](int t) { return s.active[t] == 0; }, s.free_list, n_val,
        [&](int c) {
          const int d = s.det_list[c];
          return s.col[d] < 0 && dsc[d] >= cfg.new_thr;
        },
        s.new_list, s.warp_sums);
    const int num_new = nb.y < nb.x ? nb.y : nb.x;
    for (int j = tid; j < num_new; j += nth) {
      const int d = s.det_list[s.new_list[j]], slot = s.free_list[j];
      s.col[d] = slot;
      s.tsc[slot] = dsc[d];
      s.ids[slot] = next_id + j;
      s.hits[slot] = 1;
      s.ages[slot] = 0;
      s.st[slot] = kTentative;
      s.lf[slot] = frame;
      s.active[slot] = 1;
    }
    for (int i = tid; i < num_new * kNumKp; i += nth) {
      const int j = i / kNumKp, q = i - j * kNumKp;
      const int d = s.det_list[s.new_list[j]];
      const int ti = s.free_list[j] * kNumKp + q, di = d * kNumKp + q;
      s.px[ti] = dp[di * 3];
      s.py[ti] = dp[di * 3 + 1];
      s.pc[ti] = dp[di * 3 + 2];
      s.vx[ti] = 0.0f;
      s.vy[ti] = 0.0f;
      if (cfg.reid) {
        s.er[ti] = femb[di * 3];
        s.eg[ti] = femb[di * 3 + 1];
        s.eb[ti] = femb[di * 3 + 2];
      }
      if constexpr (kKalman) {
        // Kalman136.initiate: the detection's position, zero derivatives;
        // position variance 10 (1000 where conf <= 0), the rest 100
        const float pv = dp[di * 3 + 2] > 0.0f ? 10.0f : 1000.0f;
        fm[2 * ti] = make_float4(dp[di * 3], dp[di * 3 + 1], 0.0f, 0.0f);
        fm[2 * ti + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        fc[2 * ti] = make_float4(pv, pv, 100.0f, 100.0f);
        fc[2 * ti + 1] = make_float4(100.0f, 100.0f, 100.0f, 100.0f);
      }
    }
    if (tid == 0) s.misc[0] = next_id + num_new;
    __syncthreads();
    clk.lap(kStBirths);

    // ---- stage 9: dominance dedup over the confirmed tracks' pairs -------
    // (centres from gating time); a track u dominates t when it has more
    // hits, or as many and a lower id
    const int n_conf = compact2(
        T,
        [&](int t) {
          return s.active[t] && s.st[t] != kLost && s.hits[t] >= cfg.min_hits;
        },
        s.conf_list, 0, [](int) { return false; }, nullptr, s.warp_sums).x;
    for (int i = tid; i < n_conf * n_conf; i += nth) {
      const int t = s.conf_list[i / n_conf], u = s.conf_list[i % n_conf];
      if (u == t || !(s.hits[t] < s.hits[u] ||
                      (s.hits[t] == s.hits[u] && s.ids[t] > s.ids[u])))
        continue;
      const float ahw = s.tw[t] * 0.5f, ahh = s.th[t] * 0.5f;
      const float ax1 = s.tcx[t] - ahw, ay1 = s.tcy[t] - ahh;
      const float ax2 = s.tcx[t] + ahw, ay2 = s.tcy[t] + ahh;
      const float bhw = s.tw[u] * 0.5f, bhh = s.th[u] * 0.5f;
      const float bx1 = s.tcx[u] - bhw, by1 = s.tcy[u] - bhh;
      const float bx2 = s.tcx[u] + bhw, by2 = s.tcy[u] + bhh;
      const float ix = fmaxf(fminf(ax2, bx2) - fmaxf(ax1, bx1), 0.0f);
      const float iy = fmaxf(fminf(ay2, by2) - fmaxf(ay1, by1), 0.0f);
      const float inter = ix * iy;
      const float uni =
          ((ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1)) - inter;
      const float iou = uni > 0.0f ? inter / fmaxf(uni, 1e-9f) : 0.0f;
      if (iou > cfg.dedup_iou) s.flag[t] = 1;  // the same value, any order
    }
    __syncthreads();
    clk.lap(kStDedup);

    // ---- outputs (tracker/output.py::extract_outputs_device) -------------
    // A flagged track leaves the pool here: every reader takes
    // active && !flag, which is the same before and after the clear.
    for (int d = tid; d < D; d += nth) {
      const int slot = s.col[d];
      const int sf = slot < 0 ? 0 : (slot > T - 1 ? T - 1 : slot);
      const int st = s.st[sf];
      const bool emit = slot >= 0 && s.active[sf] && !s.flag[sf] &&
                        !(st == kTentative && s.hits[sf] < cfg.min_hits) &&
                        st != kLost && adv;
      const size_t o = f * D + d;
      p.o_ids[o] = emit ? s.ids[sf] : -1;
      p.o_scores[o] = emit ? dsc[d] : 0.0f;
      p.o_emit[o] = emit ? 1 : 0;
      float bx[4];
      const int n = kp_box(s.px + sf * kNumKp, s.py + sf * kNumKp,
                           s.pc + sf * kNumKp, 1, 0.2f, bx);
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
    // the flagged tracks leave; the count of the rest is num_active (its
    // barrier ends the frame's reads and writes)
    int n_active = 0;
    for (int base = 0; base < T; base += nth) {
      const int t = base + tid;
      if (t < T && s.flag[t]) s.active[t] = 0;
      n_active += __syncthreads_count(t < T && s.active[t] != 0);
    }
    if (tid == 0) p.o_num_active[f] = adv ? n_active : 0;
    clk.lap(kStOutputs);
    if (!adv) {
      load_state(s, p, cfg, b, true);
      __syncthreads();
      clk.lap(kStState);
    }
  }
  store_state(s, p, cfg, b);
  if (clk.acc != nullptr) {
    __syncthreads();
    clk.lap(kStState);
  }
}

// How a frame's detections arrive: by cp.async where its pieces are
// 16-byte aligned (D a multiple of 16, base pointers 16-byte aligned), then
// also prefetched into a second buffer where that fits; with Re-ID, their
// embeddings in shared memory where that fits too.
void plan(int T, int D, bool reid, bool aligned, bool* async_ld, bool* pre,
          bool* emb_smem, size_t* bytes) {
  Smem s;
  const size_t limit = 232448;  // the most one block may have (H100)
  *async_ld = aligned && D % 16 == 0;
  *pre = *emb_smem = false;
  *bytes = carve(s, 0, T, D, reid, false, false);
  if (!*async_ld) return;
  const size_t with_emb = carve(s, 0, T, D, reid, true, reid);
  const size_t without = carve(s, 0, T, D, reid, true, false);
  if (reid && with_emb <= limit) {
    *pre = *emb_smem = true;
    *bytes = with_emb;
  } else if (without <= limit) {
    *pre = true;
    *bytes = without;
  }
}

}  // namespace

// Shared memory of one block at (T, D, reid), with the detections'
// prefetch where it fits (the launcher's choice on aligned inputs).
extern "C" size_t posebyte_tracker_chunk_smem_bytes(int T, int D,
                                                    int reid) {
  bool async_ld, pre, emb_smem;
  size_t bytes;
  plan(T, D, reid != 0, true, &async_ld, &pre, &emb_smem, &bytes);
  return bytes;
}

// ptrs: kNumPtrs device pointers in the order of struct Ptrs (det_emb
// null without Re-ID, the five filter pointers null for cv, the stage
// clock null unless it is wanted); iargs: S, K,
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
  auto al = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const bool aligned = al(p.det_poses) && al(p.det_scores) &&
                       al(p.det_valid) && (!cfg.reid || al(p.det_emb));
  bool async_ld, pre, emb_smem;
  size_t smem;
  plan(cfg.T, cfg.D, cfg.reid != 0, aligned, &async_ld, &pre, &emb_smem,
       &smem);
  cfg.async_ld = async_ld;
  cfg.pre = pre;
  cfg.emb_smem = emb_smem;
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
