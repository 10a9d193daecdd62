// Closest-hit BVH traversal kernels for Hopper (sm_90a), plain C ABI.
//
// Built by iris_tpu_torch/geometry/cuda_intersect.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and called through ctypes. Every traversal entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError(); each
// kernel counts its own launches and rays (g_counts).
//
// Every kernel computes what its Pallas kernel of
// iris_tpu/geometry/pallas_intersect.py computes: per ray, the closest hit
// (t, u, v, face_id) with face_id = -1 for a miss. The TPU walks one
// traversal cursor per tile of rays (the union of the tile's paths, every
// lane a vector op). trace_union, trace_paired, trace_ordered and
// trace_dense walk one ray per thread, which is the natural unit on an SM
// and visits a subset of the tile's nodes with the same hits; the three
// streamed kernels (trace_streamed, trace_paired_streamed,
// trace_dense_streamed) keep the TPU's shared cursor, one per packet of 4
// to 32 rays (several packets to a warp; see "packet walks" below).
//
// --fmad=false: no multiply-add contraction, so t/u/v round exactly as the
// plain PyTorch versions (and the JAX package) round them; the kernels are
// held against those versions at zero error on the card.
//
// What bounds them on this card: each visit reads a node (32 B) or a pair
// record (64 B) and each leaf reads leaf_size triangle rows (48 B), all
// from a tree small enough to stay in the 50 MB L2, then spends ~24 FP32
// operations per slab test and ~55 per Moller-Trumbore test. Both counts
// depend on the data (how deep each ray walks). On the sorted bounce rays
// of the 102,014-face scene the walks are bound by the instructions a
// step executes, not by a load's latency: every design that hid latency
// (cp.async prefetches of records and windows, successors loaded ahead)
// measured slower or gained less than one that took instructions or
// branches off a step (PERF.md, Findings). Warp coherence is left to the
// caller's ray order.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTMiss = 3e37f;   // pallas_intersect.py:30
constexpr float kMtEps = 1e-9f;   // pallas_intersect.py:31
// Stack entries of the near-first walks (per thread in local memory; per
// packet, in shared memory, in the packet walks). The host refuses trees
// whose stack need (depth + 4 entries) exceeds it instead of truncating.
constexpr int kStackCap = 128;
// The dynamic shared memory a block gets without opting its kernel in.
constexpr int kDefaultShared = 48 * 1024;
// float4s per 128-float row of the paired layout (pallas_intersect.py:621)
constexpr int kRow4 = 32;
// float4s of the 16 useful floats of a pair row (the compact (R, 16) view)
constexpr int kPair4 = 4;
// Warps per block of the packet walks. A block never synchronises, so the
// size only sets how shared memory is carved and how soon a finished
// block's room is handed on: walks differ several-fold in length, and 4
// (or 2) warps a block measured 5-10% faster than 8.
constexpr int kPacketWarps = 4;
// Shared-memory windows of the pair walk, per lane of a packet so that
// they scale with its width W: W * kPairWinPerLane compact pair records
// (64 bytes each) and one whole leaf per kLanesPerLeaf lanes (leaf_size x
// 48 bytes; a 256-byte slot in the dense layout): 32 records and 8 leaves
// at W = 32. cuda_intersect.py's pair_win_for and leaf_win_for count
// reloads of the same windows.
constexpr int kPairWinPerLane = 1;
constexpr int kLanesPerLeaf = 4;
// The shipped packet widths, rays per cursor: of trace_streamed, and of
// trace_paired_streamed and trace_dense_streamed (one walk): the fastest
// of the instantiated widths on the 518,400 sorted bounce rays of the
// 102,014-face scene (H100; PERF.md has the table). cuda_intersect.py's
// STREAMED_PACKET and PACKET are held against them.
constexpr int kStreamedPacket = 4;
constexpr int kPairPacket = 32;
// float4s of one leaf slot of the dense layout (64 floats; two per
// 128-float row, pallas_intersect.py:1055-1099)
constexpr int kSlot4 = 16;
constexpr unsigned kFullMask = 0xffffffffu;

// What each kernel has run, counted by the kernel itself: thread 0 of a
// launch's first block adds 1 and the launch's n_rays to its kernel's row,
// so a launch replayed from a CUDA graph counts when it runs, as an eager
// one does. Rows in the order of cuda_intersect.py's KERNELS; read and
// cleared by iris_read_counts and iris_reset_counts.
enum CountSlot {
  kCountUnion, kCountStreamed, kCountOrdered, kCountPaired,
  kCountPairedStreamed, kCountDense, kCountDenseStreamed, kCountSlots
};
__device__ unsigned long long g_counts[kCountSlots][2];  // {launches, rays}

__device__ __forceinline__ void count_launch(CountSlot slot, int n_rays) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(&g_counts[slot][0], 1ULL);
    atomicAdd(&g_counts[slot][1], static_cast<unsigned long long>(n_rays));
  }
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

struct Hit {
  float t, u, v;
  int face;
};

// Safe reciprocal direction (pallas_intersect.py:52-53): |d| < 1e-12 -> 1e-12.
__device__ __forceinline__ float safe_rcp(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ orig,
                                        const float* __restrict__ dirs,
                                        int i) {
  Ray r;
  r.ox = __ldg(orig + 3 * i);
  r.oy = __ldg(orig + 3 * i + 1);
  r.oz = __ldg(orig + 3 * i + 2);
  r.dx = __ldg(dirs + 3 * i);
  r.dy = __ldg(dirs + 3 * i + 1);
  r.dz = __ldg(dirs + 3 * i + 2);
  r.ix = safe_rcp(r.dx);
  r.iy = safe_rcp(r.dy);
  r.iz = safe_rcp(r.dz);
  return r;
}

// AABB slab test against the ray's current best t (pallas_intersect.py:61-83).
__device__ __forceinline__ bool slab(const Ray& r, float n0, float n1,
                                     float n2, float n3, float n4, float n5,
                                     float t_best, float* tlo_out) {
  const float tx0 = (n0 - r.ox) * r.ix;
  const float tx1 = (n3 - r.ox) * r.ix;
  const float ty0 = (n1 - r.oy) * r.iy;
  const float ty1 = (n4 - r.oy) * r.iy;
  const float tz0 = (n2 - r.oz) * r.iz;
  const float tz1 = (n5 - r.oz) * r.iz;
  const float tlo =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float thi =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  *tlo_out = tlo;
  return thi >= fmaxf(tlo, 0.0f) && tlo <= t_best;
}

// Moller-Trumbore on one triangle row [v0, e1, e2, face_id, pad, pad]
// (three float4s), folded into the best hit with a strict t < t_best, so
// the first of equal-t hits in visiting order wins (pallas_intersect.py:86-114).
// Padding rows carry face_id < 0 and never hit.
__device__ __forceinline__ void mt_fold(const Ray& r, float4 a, float4 b,
                                        float4 c, Hit& h) {
  const float v0x = a.x, v0y = a.y, v0z = a.z, e1x = a.w;
  const float e1y = b.x, e1z = b.y, e2x = b.z, e2y = b.w;
  const float e2z = c.x, fid = c.y;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok_det = fabsf(det) > kMtEps;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  if (ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
      fid >= 0.0f && t < h.t) {
    h.t = t;
    h.u = u;
    h.v = v;
    h.face = static_cast<int>(fid);
  }
}

__device__ __forceinline__ void store_hit(const Hit& h, int i,
                                          float* __restrict__ t_out,
                                          float* __restrict__ u_out,
                                          float* __restrict__ v_out,
                                          int* __restrict__ f_out) {
  t_out[i] = h.t;
  u_out[i] = h.u;
  v_out[i] = h.v;
  f_out[i] = h.face;
}

// ------------------------------------------------------- per-ray walks
//
// trace_paired, trace_dense and trace_ordered walk one ray per thread,
// near child first, over 64-byte pair records: record p holds both
// children of internal node p (its preorder rank among internal nodes),
// float4s {left min, left max.x}, {left max.yz, left desc', 0}, the same
// two for the right child; desc' > 0 is an internal child whose record is
// desc' - 1, desc' <= 0 a leaf child whose leaf row is -desc'.
// One ray per thread, a warp steps until its longest walk is done: on the
// 518,400 sorted bounce rays of the 102,014-face scene trace_dense pops
// 26.3M records (50.7 a ray) in 1.16M warp steps, so 71% of the lanes of
// a step walk (lane_busy; the plain versions count both).
// Both walks keep the child they visit next in a register and push only
// the far one, which is the visiting order of "push far, push near, pop"
// with the near entry's store and load off the chain of every step. The
// stack is a local array of kStackCap entries (L1-cached, only the
// entries a walk reaches are touched); the host refuses a tree deeper
// than it holds (depth + 4 entries) instead of truncating.
// What was built beside these designs and dropped, timed in one call with
// the previous kernels (H100, median of 20 there / back; PERF.md's Findings
// have every row). On
// trace_dense's 518,400 rays, against 0.3266 / 0.3277 ms for the near child
// in a register, unrolled leaves and a local stack at 128 threads
// (the previous kernel: 0.3592 / 0.3572; shipped, with one-pass folds:
// 0.3068 / 0.3080):
//  - the stack in shared memory, [entry][thread]: 0.3365 / 0.3372;
//  - blocks of 256 threads: 0.3384 / 0.3365 (64: 0.3284 / 0.3282, level);
//  - persistent warps taking 32 rays at a time from a global counter:
//    0.3174 / 0.3200, but 0.0877 / 0.0863 against 0.0798 / 0.0803 on
//    trace_paired's 129,600 rays (the counter's reset, an uneven tail);
//  - the pair walk as a while-while walk (see trace_ordered): 0.4747 /
//    0.4788; a 4-triangle leaf costs little more than a record, so lanes
//    that wait lose more than the joint folds win.
// On trace_ordered's 129,600 rays (the previous kernel 0.2758 / 0.2761;
// shipped 0.0985 / 0.0980), with one-step loops: records staged in shared
// memory 0.1854 / 0.1860 against 0.1722 / 0.1686 read through the L1;
// and leaves folded by 2 or 8 triangles in the while-while walk: 0.1044 /
// 0.1046 and 0.1091 / 0.1085 against 0.0972 / 0.0976 by 4.

// Threads per block of the per-ray walks
constexpr int kWalkThreads = 128;

// The L triangle rows at lf (3 * L float4s), every load issued before the
// folds, folded in order k = 0 .. L - 1.
template <int L>
__device__ __forceinline__ void fold_leaf(const Ray& r,
                                          const float4* __restrict__ lf,
                                          Hit& h) {
  float4 q[3 * L];
#pragma unroll
  for (int k = 0; k < 3 * L; ++k) q[k] = __ldg(lf + k);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    mt_fold(r, q[3 * k], q[3 * k + 1], q[3 * k + 2], h);
  }
}

// trace_union — replaces pallas_ray_trace / _kernel
// (pallas_intersect.py:176, 240). Stackless preorder skip-pointer walk over
// nodes (N, 8) and tris (P, 12): descend to desc on a slab hit, otherwise
// jump to skip; a hit leaf (desc <= 0) tests leaf_size rows from -desc.
// The TPU's tile-union walk visits a superset of this ray's nodes; the
// extra visits are misses for this lane (child boxes nest in parent boxes
// and t_best only shrinks), and triangles are met in the same preorder, so
// the hits and their tie-breaking are the same.
// What bounds it: the instructions a warp executes. A leaf fold (leaf_size
// Moller-Trumbore tests) costs several node visits, and a one-step loop
// runs it for the whole warp whenever any lane stands on a hit leaf: on
// the flagship train step's 518,400 unsorted rays over the 398-face tree
// (17.1 visits and 8.6 triangle tests a ray, lane_busy 0.61) that is
// nearly every step, for a few lanes at a time.
// Design:
//  - The while-while walk (Aila and Laine), as their nested loop: a lane
//    steps through nodes until it finds a hit leaf (its cursor already on
//    the skip pointer) or its walk ends; then the lanes holding a leaf
//    fold it together, once every walking lane holds one. Each lane's own
//    visits and folds keep the one-step walk's order, so the hits are the
//    same bits; lanes past the last ray walk nothing.
//  - Leaves unrolled by leaf size (L = 1-10, fold_leaf<L>, loads first);
//    L = 0 takes any leaf_size by 4 triangles, then by 1.
//  - 128-thread blocks; the tree is read through the L1 (__ldg) and staged
//    nowhere: the flagship's 39 KB tree stays in the L1, a bigger one in
//    the L2.
//  - A step cap (2 * n_nodes + 2 visits) keeps a corrupt tree from hanging
//    the card; the cursor and the leaf's rows are clamped into the arrays.
// Timed on those rays and on the 102K train step's 518,400 sorted rays
// over the 102,014-face preorder tree, which kernel_for sends to
// trace_paired_streamed, not here (H100, ms, medians of 20; each design
// bit-equal to the plain version; PERF.md's Findings have every row):
// this kernel 0.0987; 0.0980 and 1.5329; 1.5382 against the previous
// one's 0.1226; 0.1224 and 1.7748; 1.7558 (chip_smoke.py, change, parent,
// parent, change; the previous kernel staged trees of up to 48 KB in
// shared memory in every 256-thread block and folded in a one-step loop);
// on a Morton tree of the 102K scene, the big tree that does come here,
// 102.80 against 127.24. Built beside it and dropped, each against the
// previous kernel in its own call:
//  - the tree through the L1 instead of staged, one-step loop: 0.1208 (256
//    threads; staging cost 1%), 0.1185 (128);
//  - leaves unrolled, one-step loop: 0.1066 and 1.2489;
//  - both successors loaded while the node is tested (trace_streamed's
//    load): 0.1172 and 1.2034 (more L1 traffic and registers than the
//    latency it hides is worth on a tree in the L1);
//  - a vote loop, where the lanes holding a leaf fold once fold_k x (lanes
//    holding) >= (lanes walking) and the others step on: fold_k 1, 2, 4
//    and 8 took 0.1263, 0.1105, 0.1179 and 0.1289 on the flagship rays,
//    1.7426, 1.0321, 1.0122 and 1.0890 on the sorted 102K rays, and (2
//    and 4) 84.44 and 101.80 on the Morton tree. It wins only on sorted
//    rays, whose neighbouring lanes reach their leaves together, and no
//    path sends sorted rays here today;
//  - staging once per resident block in a persistent grid: 0.1208 at best;
//  - 64 or 256 threads, the leaf's rows loaded when a lane finds it,
//    launch bounds that trade registers for resident blocks: level or
//    slower.
template <int L>
__device__ __forceinline__ void fold_rows(const Ray& r,
                                          const float4* __restrict__ lf,
                                          int leaf_size, Hit& h) {
  if constexpr (L > 0) {
    fold_leaf<L>(r, lf, h);
  } else {
    int k = 0;
    for (; k + 4 <= leaf_size; k += 4) fold_leaf<4>(r, lf + 3 * k, h);
    for (; k < leaf_size; ++k) fold_leaf<1>(r, lf + 3 * k, h);
  }
}

template <int L>
__global__ void __launch_bounds__(kWalkThreads) trace_union_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float4* __restrict__ tris, int n_tri_rows, int leaf_size,
    const float* __restrict__ orig, const float* __restrict__ dirs,
    int n_rays, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ f_out) {
  count_launch(kCountUnion, n_rays);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i - static_cast<int>(threadIdx.x & 31) >= n_rays) return;  // warp
  const bool live = i < n_rays;
  const Ray r = load_ray(orig, dirs, live ? i : n_rays - 1);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  const int rows = L > 0 ? L : leaf_size;  // triangle rows of a leaf
  float4 a = __ldg(nodes);                 // the node under the cursor
  float4 b = __ldg(nodes + 1);
  int cur = 1;
  bool done = !live;
  bool holding = false;  // a hit leaf not folded yet, from triangle row `row`
  int row = 0;
  // a walk of a well-formed tree visits each node at most once
  int steps_left = 2 * n_nodes + 2;
  while (__any_sync(kFullMask, !done)) {
    // nodes until this lane holds a hit leaf, or its walk ends
    while (!done && !holding) {
      float tlo;
      const bool hit = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, &tlo);
      const float desc = b.w;
      const bool leaf = desc <= 0.0f;
      holding = hit && leaf;
      row = min(max(static_cast<int>(-desc), 0), n_tri_rows - rows);
      cur = (hit && !leaf) ? static_cast<int>(desc) : static_cast<int>(b.z);
      const int node = min(max(cur - 1, 0), n_nodes - 1);
      a = __ldg(nodes + 2 * node);
      b = __ldg(nodes + 2 * node + 1);
      --steps_left;
      if (!holding) done = cur <= 0 || steps_left <= 0;
    }
    if (holding) {
      fold_rows<L>(r, tris + 3 * static_cast<size_t>(row), leaf_size, h);
      holding = false;
      done = cur <= 0 || steps_left <= 0;
    }
  }
  if (live) store_hit(h, i, t_out, u_out, v_out, f_out);
}

// trace_paired — replaces pallas_ray_trace_paired / _kernel_paired
// (pallas_intersect.py:675, 782) over the _pack_paired rows (:621): pair
// row r holds the pair record of internal node r in its first 16 floats;
// leaf rows hold a whole leaf (leaf_size x 12 floats) each.
// trace_dense — replaces pallas_ray_trace_dense / _kernel_dense
// (pallas_intersect.py:1102, 1221) over the _pack_dense rows (:1059): pair
// p at row p / 8, lanes 16 * (p % 8) + {0..6, 8..14}; leaf l at row l / 2,
// lanes 64 * (l % 2) + 12 * k + {0..9}. The TPU kernel reads the whole
// 128-lane row and picks the slot with a chain of scalar selects
// (slot_scalar, :1115-1124), because Mosaic cannot index lanes
// dynamically; a thread can, so the slot is addressed: the dense pair
// array is a contiguous run of 64-byte records and the leaf array one of
// 256-byte slots. What "dense" buys on the TPU is residency; this card
// keeps either layout in its 50 MB L2, so the two differ by their strides
// alone.
// Both are pair_walk: take a record, slab-test both children against the
// current t_best, fold the entered leaf children (left, then right) so
// their hits prune what follows, then go on to the near internal child
// and push the far one. Near/far is this ray's own entry distance, where
// the TPU used the tile's mean (:735-741), so equal-t ties may pick
// another face. Record p starts kPairStride4 float4s after record p - 1,
// leaf l kLeaf4 after leaf l - 1; L is the leaf size, so the fold is
// unrolled and its loads issued first. A lane that entered one leaf child
// folds it in the step's first fold pass, the left or the right one alike,
// so the lanes of a warp that entered any leaf fold together; only a lane
// that entered both takes a second pass.
template <int kPairStride4, int kLeaf4, int L>
__device__ __forceinline__ void pair_walk(
    const float4* __restrict__ pairs, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int stack_depth,
    const float* __restrict__ orig, const float* __restrict__ dirs,
    int n_rays, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ f_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(orig, dirs, i);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  int stack[kStackCap];
  int cur = 0;  // the root's record
  int sp = 0;
  // each record is visited at most once per walk; the cap only keeps a
  // corrupt tree from hanging the card
  const int max_steps = 2 * n_pairs + 2;
  for (int step = 0; step < max_steps; ++step) {
    const float4* row = pairs + static_cast<size_t>(cur) * kPairStride4;
    const float4 a = __ldg(row);
    const float4 b = __ldg(row + 1);
    const float4 c = __ldg(row + 2);
    const float4 d = __ldg(row + 3);
    float tlo_l, tlo_r;
    const bool hit_l = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, &tlo_l);
    const bool hit_r = slab(r, c.x, c.y, c.z, c.w, d.x, d.y, h.t, &tlo_r);
    const float dl = b.z;
    const float dr = d.z;
    const bool l_leaf = dl <= 0.0f;
    const bool r_leaf = dr <= 0.0f;
    const bool fold_l = hit_l && l_leaf;
    const bool fold_r = hit_r && r_leaf;
    if (fold_l || fold_r) {
      const int row_l = min(static_cast<int>(-dl), n_leaf_rows - 1);
      const int row_r = min(static_cast<int>(-dr), n_leaf_rows - 1);
      fold_leaf<L>(r, leaves + static_cast<size_t>(fold_l ? row_l : row_r) *
                              kLeaf4, h);
      if (fold_l && fold_r) {
        fold_leaf<L>(r, leaves + static_cast<size_t>(row_r) * kLeaf4, h);
      }
    }
    const bool want_l = hit_l && !l_leaf;
    const bool want_r = hit_r && !r_leaf;
    const int pid_l = min(max(static_cast<int>(dl) - 1, 0), n_pairs - 1);
    const int pid_r = min(max(static_cast<int>(dr) - 1, 0), n_pairs - 1);
    if (want_l && want_r) {
      const bool l_near = tlo_l <= tlo_r;
      // the TPU kernel's clamped push (:745-757); with the host's
      // stack_depth >= depth + 4 the clamp is never reached
      stack[min(sp, stack_depth - 1)] = l_near ? pid_r : pid_l;
      sp = min(sp + 1, stack_depth);
      cur = l_near ? pid_l : pid_r;
    } else if (want_l || want_r) {
      cur = want_l ? pid_l : pid_r;
    } else if (sp > 0) {
      cur = stack[--sp];
    } else {
      break;
    }
  }
  store_hit(h, i, t_out, u_out, v_out, f_out);
}

template <int L>
__global__ void __launch_bounds__(kWalkThreads) trace_paired_kernel(
    const float4* __restrict__ pairs, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int stack_depth,
    const float* __restrict__ orig, const float* __restrict__ dirs,
    int n_rays, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ f_out) {
  count_launch(kCountPaired, n_rays);
  pair_walk<kRow4, kRow4, L>(pairs, n_pairs, leaves, n_leaf_rows,
                             stack_depth, orig, dirs, n_rays, t_out, u_out,
                             v_out, f_out);
}

template <int L>
__global__ void __launch_bounds__(kWalkThreads) trace_dense_kernel(
    const float4* __restrict__ pairs, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int stack_depth,
    const float* __restrict__ orig, const float* __restrict__ dirs,
    int n_rays, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ f_out) {
  count_launch(kCountDense, n_rays);
  pair_walk<kPair4, kSlot4, L>(pairs, n_pairs, leaves, n_leaf_rows,
                               stack_depth, orig, dirs, n_rays, t_out, u_out,
                               v_out, f_out);
}

// Pop the entries of trace_ordered's stack, (desc', tlo) each, until one
// whose box the ray enters no later than its best hit: its desc' into
// code. False when the stack runs out.
__device__ __forceinline__ bool pop_entered(const int2* stack, int& sp,
                                            float t_best, int& code) {
  while (sp > 0) {
    const int2 e = stack[--sp];
    if (__int_as_float(e.y) <= t_best) {
      code = e.x;
      return true;
    }
  }
  return false;
}

// trace_ordered — replaces pallas_ray_trace_ordered / _kernel_ordered
// (pallas_intersect.py:436, 579): the near-first walk with pop-time
// pruning of a preorder tree with any leaf_size, which takes the trees
// whose leaf row is too wide for the paired layout. The TPU kernel walks
// the nodes (N, 8): pop a node and slab-test it against the CURRENT
// t_best; a hit leaf tests its leaf_size triangle rows; a hit internal
// node slab-tests both children (left = desc, right = the left child's
// skip pointer, :498-502) and pushes the far one, then the near one.
// Near/far is this ray's own entry distance, where the TPU used the
// tile's mean (:507-513), so equal-t ties may pick another face.
// Design:
//  - The walk goes over trace_paired's pair records (they exist for any
//    leaf size), so an internal node costs one 64-byte read where the
//    node walk read the node, then its left child, then the right child
//    at the left child's skip pointer: three dependent reads.
//  - Children are pushed with the entry distance tlo of the test that
//    admitted them, so the pop-time test is the compare tlo <= t_best: the
//    full test at the pop would repeat the pushed test's arithmetic,
//    thi >= max(tlo, 0) included, and give the same bit. Only the root
//    (nodes row 0; a leaf in a one-node tree) takes a full test there. The
//    near child stays in a register and is not pushed.
//  - A leaf (16 triangles on the 6,014-face tree, 77% of the walk's FP32
//    work) is folded four triangles at a time, their twelve loads first.
//  - A "while-while" walk (Aila and Laine): every lane steps through
//    records until its next node is a leaf, or its walk ends, and waits
//    there; then the lanes that wait fold their leaves together and pop.
//    In a one-step loop the lanes at a leaf and the lanes at a record take
//    turns every step and a fold runs for few lanes; here a fold pass runs
//    for all the warp's lanes that have reached a leaf. Each lane's own
//    order of visits, folds and pops is the one-step walk's, so the hits
//    are the same bits. Lanes past the last ray take part in the votes.
__global__ void __launch_bounds__(kWalkThreads) trace_ordered_kernel(
    const float4* __restrict__ nodes, const float4* __restrict__ pairs,
    int n_pairs, const float4* __restrict__ tris, int n_leaf_rows,
    int leaf_size, int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out) {
  count_launch(kCountOrdered, n_rays);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i - static_cast<int>(threadIdx.x & 31) >= n_rays) return;  // warp
  const bool live = i < n_rays;
  const Ray r = load_ray(orig, dirs, live ? i : n_rays - 1);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  int2 stack[kStackCap];
  const float4 ra = __ldg(nodes);
  const float4 rb = __ldg(nodes + 1);
  float tlo;
  bool done =
      !live || !slab(r, ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, h.t, &tlo);
  int code = rb.w > 0.0f ? 1 : 0;  // the root: record 0, or leaf row 0
  int sp = 0;
  // each node is visited at most once per walk; the cap only keeps a
  // corrupt tree from hanging the card
  int steps_left = 4 * n_pairs + 4;
  while (__any_sync(kFullMask, !done)) {
    // records until this ray's next node is a leaf, or its walk ends
    while (!done && code > 0) {
      const float4* rec = pairs + 4 * min(code - 1, n_pairs - 1);
      const float4 a = __ldg(rec);
      const float4 b = __ldg(rec + 1);
      const float4 c = __ldg(rec + 2);
      const float4 d = __ldg(rec + 3);
      float tlo_l, tlo_r;
      const bool hit_l = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, &tlo_l);
      const bool hit_r = slab(r, c.x, c.y, c.z, c.w, d.x, d.y, h.t, &tlo_r);
      const int code_l = static_cast<int>(b.z);
      const int code_r = static_cast<int>(d.z);
      if (hit_l && hit_r) {
        const bool l_near = tlo_l <= tlo_r;
        // the TPU kernel's clamped push (:519-531), never reached with
        // the host's stack_depth >= depth + 4
        stack[min(sp, stack_depth - 1)] =
            l_near ? make_int2(code_r, __float_as_int(tlo_r))
                   : make_int2(code_l, __float_as_int(tlo_l));
        sp = min(sp + 1, stack_depth);
        code = l_near ? code_l : code_r;
      } else if (hit_l || hit_r) {
        code = hit_l ? code_l : code_r;
      } else {
        done = !pop_entered(stack, sp, h.t, code);
      }
      done = done || --steps_left <= 0;
    }
    if (done) continue;
    // the lanes whose next node is a leaf fold it together, then pop
    const float4* lf =
        tris + static_cast<size_t>(min(-code, n_leaf_rows - 1)) * 3 * leaf_size;
    int k = 0;
    for (; k + 4 <= leaf_size; k += 4) fold_leaf<4>(r, lf + 3 * k, h);
    for (; k < leaf_size; ++k) fold_leaf<1>(r, lf + 3 * k, h);
    done = !pop_entered(stack, sp, h.t, code) || --steps_left <= 0;
  }
  if (live) store_hit(h, i, t_out, u_out, v_out, f_out);
}

// ------------------------------------------------------------ packet walks
//
// The three streamed kernels keep the TPU's shared cursor: a packet of W
// consecutive rays walks the union of its rays' paths behind one cursor.
// On the TPU a packet is a tile of thousands of lanes; here W is 4, 8, 16
// or 32 lanes of one warp, a template parameter. A warp holds 32 / W
// packets ("groups": aligned runs of W lanes) that step in lockstep
// through the same instructions, each with its own cursor, windows and
// stack. Votes are __ballot_sync over the whole warp, masked to the
// group's lanes; a loop runs while any group of the warp still walks, and
// a finished group idles (its lanes never hit, so they never vote, fold
// or reload). Whatever only one group does (a window reload) synchronises
// with __syncwarp(group mask) alone.
//
// Why narrower packets, and what they give: a packet tests every node any
// of its rays enters; at W = 32 the 102,014-face scene's sorted bounce
// rays spend 84% of trace_streamed's slab tests on nodes the ray's own
// walk never visits. But the groups of a warp step together, so a warp
// takes as many steps as its longest group, and on those rays (spatially
// sorted: neighbours walk nearly the same nodes) a group of 4 visits
// almost as many nodes as a group of 32. Narrow packets therefore pay off
// only where a step is cheap and nothing is reloaded per group
// (trace_streamed, fastest at W = 4); the pair walk, bound by the
// instructions a pop executes, is fastest at W = 32.

// Sum over the W lanes of a group by an xor butterfly, offsets W/2 ... 1:
// every lane gets ((a_i + a_i^(W/2)) + ...), the halving order the plain
// PyTorch version repeats (_halving_sum), so both round the mean alike.
// Called by all 32 lanes; offsets below W never leave an aligned group.
template <int W>
__device__ __forceinline__ float group_sum(float v) {
  for (int off = W / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

template <int W>
__device__ __forceinline__ unsigned group_mask_of(int lane) {
  if constexpr (W == 32) {
    return kFullMask;
  } else {
    return ((1u << W) - 1u) << (lane & ~(W - 1));
  }
}

// Pair records and whole leaves per window of a packet of `width` lanes.
__host__ __device__ constexpr int pair_win_rows(int width) {
  return width * kPairWinPerLane;
}

__host__ __device__ constexpr int leaf_win_rows(int width) {
  return width / kLanesPerLeaf > 0 ? width / kLanesPerLeaf : 1;
}

// float4s of shared memory one group of the pair walk takes: its stack,
// its record window and its leaf window (a leaf is leaf4 float4s long)
__host__ __device__ constexpr long long pair_group4(int width,
                                                    long long leaf4) {
  return kStackCap / 4 + pair_win_rows(width) * kPair4 +
         leaf_win_rows(width) * leaf4;
}

// Make a group's window `buf` hold aligned window `tgt` of an array of
// equal rows (win_rows rows of row4 float4s; the array's last window is
// short). The group's W lanes copy it with cp.async, 16 bytes each, from
// global to shared memory without a register in between, and wait for it
// at once: cp.async completes per thread, so after its own wait every lane
// meets the group in __syncwarp before any lane reads what another copied.
template <int W>
__device__ __forceinline__ void window_load(
    float4* buf, int& held, int tgt, const float4* __restrict__ rows,
    int n_rows, int win_rows, int row4, int gl, unsigned gmask) {
  if (tgt == held) return;  // uniform over the group
  __syncwarp(gmask);        // every lane is done with the old window
  const int base = tgt * win_rows;
  const int n4 = min(win_rows, n_rows - base) * row4;
  const float4* src = rows + static_cast<size_t>(base) * row4;
  for (int k = gl; k < n4; k += W) {
    __pipeline_memcpy_async(buf + k, src + k, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp(gmask);
  held = tgt;
}

// One leaf of the pair walk through the group's leaf window: make the
// window hold row lrow, then every lane whose ray entered the leaf's box
// folds the leaf's triangles, read from shared memory.
template <int W>
__device__ __forceinline__ void group_leaf(
    const Ray& r, bool hit, int lrow, const float4* __restrict__ leaves,
    int n_leaf_rows, int leaf_size, int leaf4, float4* lbuf, int& lwin,
    int gl, unsigned gmask, Hit& h) {
  lrow = min(max(lrow, 0), n_leaf_rows - 1);
  constexpr int kWin = leaf_win_rows(W);
  const int tgt = lrow / kWin;
  window_load<W>(lbuf, lwin, tgt, leaves, n_leaf_rows, kWin, leaf4, gl,
                 gmask);
  if (hit) {
    const float4* lf = lbuf + (lrow - tgt * kWin) * leaf4;
    for (int k = 0; k < leaf_size; ++k) {
      mt_fold(r, lf[3 * k], lf[3 * k + 1], lf[3 * k + 2], h);
    }
  }
}

// The walk of trace_paired_streamed and trace_dense_streamed — replaces
// _kernel_paired_streamed and _kernel_dense_streamed
// (pallas_intersect.py:833, :1271): the near-first paired walk with ONE
// cursor and ONE stack for a packet of W rays. Pop a pair record; every
// lane slab-tests both children against its own t_best and the packet
// votes (any lane); leaf children are intersected at once (left, then
// right) by the lanes that entered their box, so t_best shrinks before the
// pushes; the far internal child is pushed, then the near one, ordered by
// the MEAN entry distance of the lanes that hit each child (:937-947,
// :1385-1391). Pair records are 64 bytes apart in both layouts (the dense
// pair array is the compact (R, 16) rows padded); a whole leaf is kLeaf4
// float4s long, a 256-byte slot (kSlot4) in the dense layout, or, with
// kLeaf4 = 0, the 3 * leaf_size float4s of a compact row. On the TPU the
// dense kernel exists to drop the 8x lane padding of a paired row from
// every DMA; the card never read that padding, so here the layouts differ
// by the leaf stride alone.
//
// What bounded the earlier design (one cursor per warp, a stack in shared
// memory written by lane 0 between two __syncwarps, windows of 32 records
// and 8 leaves reloaded by a __ldg loop between two more): a packet of 32
// made twice the per-ray walk's slab tests and one pop in three reloaded
// its record window.
// What bounds it now, as far as could be measured without a kernel
// profiler: the instructions a pop executes. 1.65M pops in 0.55 ms are one
// pop per SM every ~80 cycles, some 320 scheduler slots, about what two
// slab tests, two ballots, half a leaf fold, the butterflies with their
// two divisions and the pushes come to; so hiding a load's latency buys
// nothing and every added instruction costs. How the compiler schedules a
// pop moves the time by 5-9% either way (see the slab tests below).
// What this design does about it, each step timed beside the earlier
// kernel on the 518,400 sorted bounce rays of the 102,014-face scene
// (H100; PERF.md has the numbers):
//  - A window reload is a cp.async copy that the group waits for at once
//    (window_load): one instruction a row part where the __ldg loop had a
//    load and a store: 8% faster. It is not a prefetch.
//  - Both slab tests are made by every lane and masked by `live`
//    afterwards, with no branch around them.
//  - A whole warp per cursor (kPairPacket = 32) takes no vote on liveness
//    or on the means: both branches are uniform, and the loop is the
//    earlier one's, `while the stack holds an entry`.
//  - Windows scale with the packet, so that a reload costs every lane the
//    same few 16-byte copies at any W and a warp's windows take the same
//    shared memory: kPairWinPerLane records per lane and one whole leaf
//    per kLanesPerLeaf lanes (32 records and 8 leaves at W = 32). The
//    plain versions count reloads of the same windows (pair_win_for,
//    leaf_win_for in cuda_intersect.py).
// What was tried on those rays and dropped:
//  - Sub-warp packets: slower at every W < 32; pops per packet fall only
//    from 65 to 59 between W = 32 and W = 4 on coherent rays, so a warp's
//    steps do not fall while each group reloads windows of its own. The
//    narrow widths stay instantiated (the wrappers' width=) so that this
//    can be measured again on other rays.
//  - No shared stack: after the ballots and the butterfly every pushed id
//    and the order of the pushes are uniform over the group, so each lane
//    can keep its own copy of the stack in local memory (as trace_paired
//    does) and the two barriers and the lane-0 writes of every pop go.
//    Beside the __ldg-loop windows that is as fast as the shared stack
//    beside cp.async windows; beside cp.async windows it is 5% slower
//    (cause not found), so the shared stack stays.
//  - Pops that do not wait: every pushed child's 64-byte record copied by
//    cp.async into a slot indexed by the stack position when it is pushed,
//    the record after the popped one into a "next" buffer, leaves through
//    double-buffered windows: 11-18% slower; the commit, wait and barrier
//    of every pop cost more than one reload in three saved.
//  - Both windows double-buffered, the following window fetched by
//    cp.async while the held one is walked: 11-17% slower; only 38% of the
//    record reloads and 15% of the leaf reloads go to the window right
//    after the one held, the rest waste the prefetch.
//  - No shared memory: a record is 64 bytes at one address for every lane
//    of a group, four broadcast __ldg, both children's records loaded into
//    registers ahead, leaves read by the lanes that hit: 15-20% slower at
//    every width; 12 wide loads a pop and 96-101 registers.
//  - Reading leaves directly beside the record window: level on the dense
//    slots, 8% slower on the compact rows.
template <int W, int kLeaf4>
__device__ __forceinline__ void packet_pair_walk(
    const float4* __restrict__ pairs16, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out) {
  extern __shared__ float4 packet_smem[];
  constexpr int kPairWin = pair_win_rows(W);
  const int leaf4 = kLeaf4 > 0 ? kLeaf4 : 3 * leaf_size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * blockDim.x + warp * 32;
  if (first >= n_rays) return;  // the whole warp is past the end
  const int gl = lane & (W - 1);
  const unsigned gmask = group_mask_of<W>(lane);
  float4* mine =
      packet_smem + (warp * (32 / W) + lane / W) * pair_group4(W, leaf4);
  int* stack = reinterpret_cast<int*>(mine);
  float4* pbuf = mine + kStackCap / 4;
  float4* lbuf = pbuf + kPairWin * kPair4;
  int pwin = -1;  // no window loaded
  int lwin = -1;

  const int i = first + lane;
  const bool live = i < n_rays;  // lanes past the end never vote
  const Ray r = load_ray(orig, dirs, live ? i : n_rays - 1);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  if (gl == 0) stack[0] = 0;  // the root's pair row
  __syncwarp(gmask);
  // a group wholly past the end idles
  int sp = (first + (lane & ~(W - 1)) < n_rays) ? 1 : 0;
  const int max_steps = 2 * n_pairs + 2;
  for (int step = 0; step < max_steps; ++step) {
    const bool active = sp > 0;  // uniform over the group
    // The warp walks while any of its groups does. With several groups
    // the vote is taken on the stacks as this step finds them and read at
    // the step's end, so it is off the dependent chain and the walk ends
    // with one idle step. A single group needs no vote.
    bool go = true;
    if constexpr (W == 32) {
      if (!active) break;
    } else {
      go = __any_sync(kFullMask, active);
    }
    float4 a, b, c, d;
    a = b = c = d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (active) {
      const int row_id = stack[--sp];  // the same for every lane
      const int tgt = row_id / kPairWin;
      window_load<W>(pbuf, pwin, tgt, pairs16, n_pairs, kPairWin, kPair4, gl,
                     gmask);
      const float4* row = pbuf + (row_id - tgt * kPairWin) * kPair4;
      a = row[0];
      b = row[1];
      c = row[2];
      d = row[3];
    }
    float tlo_l = 0.0f, tlo_r = 0.0f;
    // both tests are made by every lane and masked afterwards: no branch
    // around them (testing `active && live` first measured 5-9% slower)
    const bool hit_l =
        slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, &tlo_l) && active && live;
    const bool hit_r =
        slab(r, c.x, c.y, c.z, c.w, d.x, d.y, h.t, &tlo_r) && active && live;
    const unsigned m_l = __ballot_sync(kFullMask, hit_l) & gmask;
    const unsigned m_r = __ballot_sync(kFullMask, hit_r) & gmask;
    const float dl = b.z;
    const float dr = d.z;
    const bool l_leaf = dl <= 0.0f;
    const bool r_leaf = dr <= 0.0f;
    if (active) {
      if (m_l != 0u && l_leaf) {
        group_leaf<W>(r, hit_l, static_cast<int>(-dl), leaves, n_leaf_rows,
                      leaf_size, leaf4, lbuf, lwin, gl, gmask, h);
      }
      if (m_r != 0u && r_leaf) {
        group_leaf<W>(r, hit_r, static_cast<int>(-dr), leaves, n_leaf_rows,
                      leaf_size, leaf4, lbuf, lwin, gl, gmask, h);
      }
    }
    const bool want_l = active && m_l != 0u && !l_leaf;
    const bool want_r = active && m_r != 0u && !r_leaf;
    const int pid_l = min(max(static_cast<int>(dl) - 1, 0), n_pairs - 1);
    const int pid_r = min(max(static_cast<int>(dr) - 1, 0), n_pairs - 1);
    bool l_near = want_l;
    // The butterflies are shuffles of the whole warp: every lane takes
    // them when any group needs its means (running them at every pop
    // instead of voting measured 15% slower at W = 8). A single group
    // needs no vote: the branch is uniform.
    bool means = want_l && want_r;
    if constexpr (W < 32) means = __any_sync(kFullMask, means);
    if (means) {
      const float mean_l = group_sum<W>(hit_l ? tlo_l : 0.0f) /
                           fmaxf(static_cast<float>(__popc(m_l)), 1.0f);
      const float mean_r = group_sum<W>(hit_r ? tlo_r : 0.0f) /
                           fmaxf(static_cast<float>(__popc(m_r)), 1.0f);
      if (want_l && want_r) l_near = mean_l <= mean_r;
    }
    if (active) {
      const int far_id = l_near ? pid_r : pid_l;
      const int near_id = l_near ? pid_l : pid_r;
      const bool push_far = want_l && want_r;
      const bool push_near = want_l || want_r;
      const int sp3 = sp + (push_far ? 1 : 0);
      // same clamped pushes as the TPU kernel (:949-961); with the host's
      // stack_depth >= depth + 4 the clamp is never reached
      __syncwarp(gmask);  // every lane has read its pop before the pushes
      if (gl == 0) {
        if (push_far) stack[min(sp, stack_depth - 1)] = far_id;
        if (push_near) stack[min(sp3, stack_depth - 1)] = near_id;
      }
      __syncwarp(gmask);
      sp = min(sp3 + (push_near ? 1 : 0), stack_depth);
    }
    if (!go) break;
  }
  if (live) store_hit(h, i, t_out, u_out, v_out, f_out);
}

// trace_paired_streamed — replaces pallas_ray_trace_paired_streamed
// (pallas_intersect.py:989): packet_pair_walk over the compact pair rows
// and the tris array's whole leaves (leaf_size x 48 bytes).
template <int W>
__global__ void __launch_bounds__(kPacketWarps * 32)
    trace_paired_streamed_kernel(
    const float4* __restrict__ pairs16, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out) {
  count_launch(kCountPairedStreamed, n_rays);
  packet_pair_walk<W, 0>(pairs16, n_pairs, leaves, n_leaf_rows, leaf_size,
                         stack_depth, orig, dirs, n_rays, t_out, u_out, v_out,
                         f_out);
}

// trace_dense_streamed — replaces pallas_ray_trace_dense_streamed
// (pallas_intersect.py:1437): packet_pair_walk over the dense layout, the
// same 64-byte pair records and leaves in aligned 256-byte slots, so a
// leaf window is always 64 bytes a lane whatever leaf_size.
template <int W>
__global__ void __launch_bounds__(kPacketWarps * 32)
    trace_dense_streamed_kernel(
    const float4* __restrict__ pairs16, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out) {
  count_launch(kCountDenseStreamed, n_rays);
  packet_pair_walk<W, kSlot4>(pairs16, n_pairs, leaves, n_leaf_rows,
                              leaf_size, stack_depth, orig, dirs, n_rays,
                              t_out, u_out, v_out, f_out);
}

// trace_streamed — replaces pallas_ray_trace_streamed / _kernel_streamed
// (pallas_intersect.py:271, 371): the stackless skip-pointer walk of
// trace_union with ONE cursor for a packet of W rays. Visit node cur - 1;
// every lane slab-tests it against its own t_best; a leaf (desc <= 0, leaf
// ordinal -desc / leaf_size) is folded by the lanes whose own test hit;
// the packet descends to desc when any lane hit an internal node, else
// jumps to the skip pointer; cur <= 0 ends the walk. A lane's extra visits
// are misses for it (child boxes nest in parent boxes, t_best only
// shrinks), so each ray gets trace_union's hit, bit for bit, at any packet
// width. The TPU streams the tree through forward-only windows of rows
// padded to 128 floats because its DMA needs that; the card reads the
// compact rows: the 32-byte nodes of the (N, 8) array and whole leaves of
// the tris array.
// What bounded the earlier design (one cursor per warp, shared-memory
// windows of 64 nodes and 8 leaves reloaded by a __ldg loop between two
// __syncwarps): it visits nodes in storage order, not near-first, so
// t_best shrinks late and a packet of 32 walks the union of 32 unpruned
// paths, 875 visits per warp on the 102,014-face scene, 84% of the lane
// tests for rays whose own walk never comes to that node, with ~110
// reloads per packet.
// What this design does about it:
//  - Sub-warp packets: at kStreamedPacket = 4, eight cursors per warp in
//    lockstep, each over the union of 4 rays' paths.
//  - No windows, no shared memory: the node under the cursor is 32 bytes
//    at one address for every lane of a group, two broadcast __ldg. In a
//    preorder tree the cursor can only go to the left child (the next
//    node) or to the skip pointer, both known once the node is read, so
//    both successors are loaded into registers while the node is tested
//    and the one taken becomes the next visit's node: a visit never waits
//    for its node, and nothing is reloaded per group. Leaves are read
//    directly by the lanes that hit, which the L1 serves as one broadcast
//    transaction per float4. 3.1-3.4 ms against the earlier 4.77 on the
//    518,400 sorted bounce rays of the 102,014-face scene (H100).
// What was tried on those rays and dropped (PERF.md has the tables):
//  - The earlier design's windows, scaled with the packet (2 nodes a lane,
//    a leaf per 4 lanes): 4.4-4.8 ms at W = 4, 5.2-5.9 at W = 32.
//  - Asynchronous forward windows: the node cursor and the leaf base only
//    grow along a walk (:277-280), so each window was double-buffered and
//    the following one fetched with cp.async (16-byte copies and
//    per-thread commit groups rather than a bulk copy with an mbarrier: a
//    group of 4-16 lanes shares a window and the groups of a warp reload
//    at different steps, which would take a barrier object per group and
//    buffer) while the group walked the held one. 0.1-0.9 ms slower than
//    the synchronous windows at every width: 45-54% of the node reloads
//    and 9-22% of the leaf reloads go to the window right after the one
//    held (trace_streamed_plain counts them); the others jumped past it,
//    waste the copy and wait as before.
//  - Loading only the left child ahead (the skip target when taken): 8-12%
//    slower than loading both.
// The per-ray walk of the same tree (trace_union, a packet of 1) took
// 1.8-1.9 ms on the same rays before its own redesign (0.95 ms after) and
// beats every width here: chip_smoke.py times it beside this kernel.
template <int W>
__global__ void __launch_bounds__(kPacketWarps * 32) trace_streamed_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    const float* __restrict__ orig, const float* __restrict__ dirs,
    int n_rays, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ f_out) {
  count_launch(kCountStreamed, n_rays);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * blockDim.x + warp * 32;
  if (first >= n_rays) return;  // the whole warp is past the end
  const unsigned gmask = group_mask_of<W>(lane);
  const int leaf4 = 3 * leaf_size;

  const int i = first + lane;
  const bool live = i < n_rays;  // lanes past the end never vote
  const Ray r = load_ray(orig, dirs, live ? i : n_rays - 1);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  // 1-based, the same for every lane of the group; a group wholly past
  // the end idles
  int cur = (first + (lane & ~(W - 1)) < n_rays) ? 1 : 0;
  float4 a = __ldg(nodes);  // the root
  float4 b = __ldg(nodes + 1);
  const int max_steps = 2 * n_nodes + 2;
  for (int step = 0; step < max_steps; ++step) {
    const bool active = cur > 0;  // uniform over the group
    // the warp walks while any group does; the vote is read at the
    // step's end, off the dependent chain (see packet_pair_walk)
    bool go = active;
    if constexpr (W < 32) go = __any_sync(kFullMask, active);
    float4 da = a, db = b, sa = a, sb = b;  // the successors' nodes
    if (active) {
      // the node under the cursor is in registers; both places the cursor
      // can go next (the left child is the next node, the skip pointer
      // leads on) are loaded while it is tested. A leaf's or the last
      // node's clamped successor is a valid node, read and dropped.
      const int child = min(max(static_cast<int>(b.w) - 1, 0), n_nodes - 1);
      const int skip = min(max(static_cast<int>(b.z) - 1, 0), n_nodes - 1);
      da = __ldg(nodes + 2 * child);
      db = __ldg(nodes + 2 * child + 1);
      sa = __ldg(nodes + 2 * skip);
      sb = __ldg(nodes + 2 * skip + 1);
    }
    float tlo;
    const bool hit = active && live &&
                     slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, &tlo);
    const bool any_hit = (__ballot_sync(kFullMask, hit) & gmask) != 0u;
    if (active) {
      const float desc = b.w;
      const bool leaf = desc <= 0.0f;
      if (hit && leaf) {
        const int lrow = min(max(static_cast<int>(-desc) / leaf_size, 0),
                             n_leaf_rows - 1);
        const float4* lf = leaves + static_cast<size_t>(lrow) * leaf4;
        for (int k = 0; k < leaf_size; ++k) {
          mt_fold(r, __ldg(lf + 3 * k), __ldg(lf + 3 * k + 1),
                  __ldg(lf + 3 * k + 2), h);
        }
      }
      const bool descend = any_hit && !leaf;
      cur = descend ? static_cast<int>(desc) : static_cast<int>(b.z);
      a = descend ? da : sa;
      b = descend ? db : sb;
    }
    if (!go) break;
  }
  if (live) store_hit(h, i, t_out, u_out, v_out, f_out);
}

// --------------------------------------------------- packet walk launches

using PairKernel = void (*)(const float4*, int, const float4*, int, int, int,
                            const float*, const float*, int, float*, float*,
                            float*, int*);
using StreamedKernel = void (*)(const float4*, int, const float4*, int, int,
                                const float*, const float*, int, float*,
                                float*, float*, int*);

// The instantiations by packet width, nullptr for a width that has none;
// width 0 asks for the shipped one.
inline StreamedKernel streamed_kernel_of(int width) {
  switch (width == 0 ? kStreamedPacket : width) {
    case 4: return trace_streamed_kernel<4>;
    case 8: return trace_streamed_kernel<8>;
    case 16: return trace_streamed_kernel<16>;
    case 32: return trace_streamed_kernel<32>;
    default: return nullptr;
  }
}

inline PairKernel paired_streamed_kernel_of(int width) {
  switch (width) {
    case 4: return trace_paired_streamed_kernel<4>;
    case 8: return trace_paired_streamed_kernel<8>;
    case 16: return trace_paired_streamed_kernel<16>;
    case 32: return trace_paired_streamed_kernel<32>;
    default: return nullptr;
  }
}

inline PairKernel dense_streamed_kernel_of(int width) {
  switch (width) {
    case 4: return trace_dense_streamed_kernel<4>;
    case 8: return trace_dense_streamed_kernel<8>;
    case 16: return trace_dense_streamed_kernel<16>;
    case 32: return trace_dense_streamed_kernel<32>;
    default: return nullptr;
  }
}

// Dynamic shared memory of one block of the pair walk, in bytes.
inline long long pair_shared_bytes(int width, long long leaf4) {
  return 16LL * kPacketWarps * (32 / width) * pair_group4(width, leaf4);
}

// Make room for a block's dynamic shared memory: checked against the most
// a block may opt into on the current device (227 KB on an H100), and
// past the default limit the kernel is opted in. 0, or the CUDA error the
// wrapper raises on: windows past the card's limit are
// cudaErrorInvalidValue, and a refused opt-in is returned as it came.
inline int reserve_shared(const void* kernel, long long bytes) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int limit = 0;
  rc = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                              dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= kDefaultShared) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit));
}

// Launch of a packet walk over pair records, whole leaves leaf4 float4s
// long.
int launch_packet_pair(PairKernel kernel, int width, long long leaf4,
                       const void* pairs16, int n_pairs, const void* leaves,
                       int n_leaf_rows, int leaf_size, int stack_depth,
                       const void* orig, const void* dirs, int n_rays,
                       void* t_out, void* u_out, void* v_out, void* f_out,
                       void* stream) {
  if (n_rays <= 0) return 0;
  if (kernel == nullptr || stack_depth < 1 || stack_depth > kStackCap ||
      n_pairs < 1 || n_leaf_rows < 1 || leaf_size < 1 ||
      3LL * leaf_size > leaf4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long shared = pair_shared_bytes(width, leaf4);
  const int rc = reserve_shared(reinterpret_cast<const void*>(kernel), shared);
  if (rc != 0) return rc;
  const int threads = kPacketWarps * 32;
  const int blocks = (n_rays + threads - 1) / threads;
  kernel<<<blocks, threads, static_cast<size_t>(shared),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pairs16), n_pairs,
      static_cast<const float4*>(leaves), n_leaf_rows, leaf_size, stack_depth,
      static_cast<const float*>(orig), static_cast<const float*>(dirs), n_rays,
      static_cast<float*>(t_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- per-ray launches

using WalkKernel = void (*)(const float4*, int, const float4*, int, int,
                            const float*, const float*, int, float*, float*,
                            float*, int*);

// The pair walk's instantiations by leaf size: 1-10 triangles in a
// 128-float leaf row, 1-5 in a 64-float dense slot; nullptr otherwise.
inline WalkKernel paired_kernel_of(int leaf_size) {
  switch (leaf_size) {
    case 1: return trace_paired_kernel<1>;
    case 2: return trace_paired_kernel<2>;
    case 3: return trace_paired_kernel<3>;
    case 4: return trace_paired_kernel<4>;
    case 5: return trace_paired_kernel<5>;
    case 6: return trace_paired_kernel<6>;
    case 7: return trace_paired_kernel<7>;
    case 8: return trace_paired_kernel<8>;
    case 9: return trace_paired_kernel<9>;
    case 10: return trace_paired_kernel<10>;
    default: return nullptr;
  }
}

inline WalkKernel dense_kernel_of(int leaf_size) {
  switch (leaf_size) {
    case 1: return trace_dense_kernel<1>;
    case 2: return trace_dense_kernel<2>;
    case 3: return trace_dense_kernel<3>;
    case 4: return trace_dense_kernel<4>;
    case 5: return trace_dense_kernel<5>;
    default: return nullptr;
  }
}

using UnionKernel = void (*)(const float4*, int, const float4*, int, int,
                             const float*, const float*, int, float*, float*,
                             float*, int*);

// The union walk's instantiations: leaves of 1-10 triangles unrolled, any
// other leaf size by the runtime-size fold (L = 0); nullptr for a leaf
// size below 1.
inline UnionKernel union_kernel_of(int leaf_size) {
  switch (leaf_size) {
    case 1: return trace_union_kernel<1>;
    case 2: return trace_union_kernel<2>;
    case 3: return trace_union_kernel<3>;
    case 4: return trace_union_kernel<4>;
    case 5: return trace_union_kernel<5>;
    case 6: return trace_union_kernel<6>;
    case 7: return trace_union_kernel<7>;
    case 8: return trace_union_kernel<8>;
    case 9: return trace_union_kernel<9>;
    case 10: return trace_union_kernel<10>;
    default: return leaf_size >= 1 ? trace_union_kernel<0> : nullptr;
  }
}

// Launch of a pair walk: one ray a thread, kWalkThreads a block.
int launch_pair_walk(WalkKernel kernel, const void* pairs, int n_pairs,
                     const void* leaves, int n_leaf_rows, int stack_depth,
                     const void* orig, const void* dirs, int n_rays,
                     void* t_out, void* u_out, void* v_out, void* f_out,
                     void* stream) {
  if (n_rays <= 0) return 0;
  if (kernel == nullptr || stack_depth < 1 || stack_depth > kStackCap ||
      n_pairs < 1 || n_leaf_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<(n_rays + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pairs), n_pairs,
      static_cast<const float4*>(leaves), n_leaf_rows, stack_depth,
      static_cast<const float*>(orig), static_cast<const float*>(dirs), n_rays,
      static_cast<float*>(t_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int iris_paired_stack_cap() { return kStackCap; }

// {launches, rays} of each kernel on the current device since the library
// was loaded or last reset (g_counts), into out[2 * kCountSlots], once the
// device has finished all its work. 0, or a CUDA error.
int iris_read_counts(unsigned long long* out) {
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess) rc = cudaMemcpyFromSymbol(out, g_counts,
                                                   sizeof(g_counts));
  return static_cast<int>(rc);
}

// Zero g_counts on the current device once it has finished all its work.
int iris_reset_counts() {
  static const unsigned long long zeros[kCountSlots][2] = {};
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_counts, zeros,
                                                 sizeof(zeros));
  return static_cast<int>(rc);
}

int iris_count_slots() { return kCountSlots; }

// nodes: the (N, 8) rows; tris: the (P, 12) rows, P >= leaf_size.
int iris_trace_union(const void* nodes, int n_nodes, const void* tris,
                     int n_tri_rows, int leaf_size, const void* orig, const void* dirs, int n_rays,
                     void* t_out, void* u_out, void* v_out, void* f_out,
                     void* stream) {
  if (n_rays <= 0) return 0;
  const UnionKernel kernel = union_kernel_of(leaf_size);
  if (kernel == nullptr || n_nodes < 1 || n_tri_rows < leaf_size) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<(n_rays + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes), n_nodes,
      static_cast<const float4*>(tris), n_tri_rows, leaf_size,
      static_cast<const float*>(orig), static_cast<const float*>(dirs), n_rays,
      static_cast<float*>(t_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

int iris_trace_paired(const void* pairs, int n_pairs, const void* leaves,
                      int n_leaf_rows, int leaf_size, int stack_depth,
                      const void* orig, const void* dirs, int n_rays,
                      void* t_out, void* u_out, void* v_out, void* f_out,
                      void* stream) {
  return launch_pair_walk(paired_kernel_of(leaf_size), pairs, n_pairs, leaves,
                          n_leaf_rows, stack_depth, orig, dirs, n_rays, t_out,
                          u_out, v_out, f_out, stream);
}

// nodes: the (N, 8) rows, of which the walk reads the root; pairs: the
// _pair_rows records (any pointer when the root is a leaf, n_pairs 0);
// tris: the (P, 12) rows, n_leaf_rows = P / leaf_size whole leaves.
int iris_trace_ordered(const void* nodes, const void* pairs, int n_pairs,
                       const void* tris, int n_leaf_rows, int leaf_size,
                       int stack_depth, const void* orig, const void* dirs,
                       int n_rays, void* t_out, void* u_out, void* v_out,
                       void* f_out, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth < 1 || stack_depth > kStackCap || n_pairs < 0 ||
      n_leaf_rows < 1 || leaf_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  trace_ordered_kernel<<<(n_rays + kWalkThreads - 1) / kWalkThreads,
                         kWalkThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes), static_cast<const float4*>(pairs),
      n_pairs, static_cast<const float4*>(tris), n_leaf_rows, leaf_size,
      stack_depth, static_cast<const float*>(orig),
      static_cast<const float*>(dirs), n_rays, static_cast<float*>(t_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

// The packet walks take the packet width last: one of the instantiated
// widths, or 0 for the shipped one.
int iris_trace_paired_streamed(const void* pairs16, int n_pairs,
                               const void* leaves, int n_leaf_rows,
                               int leaf_size, int stack_depth,
                               const void* orig, const void* dirs, int n_rays,
                               void* t_out, void* u_out, void* v_out,
                               void* f_out, void* stream, int width) {
  if (width == 0) width = kPairPacket;
  return launch_packet_pair(paired_streamed_kernel_of(width), width,
                            3LL * leaf_size, pairs16, n_pairs, leaves,
                            n_leaf_rows, leaf_size, stack_depth, orig, dirs,
                            n_rays, t_out, u_out, v_out, f_out, stream);
}

int iris_trace_dense_streamed(const void* pairs, int n_pairs,
                              const void* leaves, int n_leaf_rows,
                              int leaf_size, int stack_depth, const void* orig,
                              const void* dirs, int n_rays, void* t_out,
                              void* u_out, void* v_out, void* f_out,
                              void* stream, int width) {
  if (width == 0) width = kPairPacket;
  return launch_packet_pair(dense_streamed_kernel_of(width), width, kSlot4,
                            pairs, n_pairs, leaves, n_leaf_rows, leaf_size,
                            stack_depth, orig, dirs, n_rays, t_out, u_out,
                            v_out, f_out, stream);
}

int iris_trace_dense(const void* pairs, int n_pairs, const void* leaves,
                     int n_leaf_rows, int leaf_size, int stack_depth,
                     const void* orig, const void* dirs, int n_rays,
                     void* t_out, void* u_out, void* v_out, void* f_out,
                     void* stream) {
  return launch_pair_walk(dense_kernel_of(leaf_size), pairs, n_pairs, leaves,
                          n_leaf_rows, stack_depth, orig, dirs, n_rays, t_out,
                          u_out, v_out, f_out, stream);
}

int iris_trace_streamed(const void* nodes, int n_nodes, const void* leaves,
                        int n_leaf_rows, int leaf_size, const void* orig,
                        const void* dirs, int n_rays, void* t_out, void* u_out,
                        void* v_out, void* f_out, void* stream, int width) {
  if (n_rays <= 0) return 0;
  const StreamedKernel kernel = streamed_kernel_of(width);
  if (kernel == nullptr || n_nodes < 1 || n_leaf_rows < 1 || leaf_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = kPacketWarps * 32;
  const int blocks = (n_rays + threads - 1) / threads;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes), n_nodes,
      static_cast<const float4*>(leaves), n_leaf_rows, leaf_size,
      static_cast<const float*>(orig), static_cast<const float*>(dirs), n_rays,
      static_cast<float*>(t_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

// What one instantiation of a packet walk takes on the current device:
// kernel 0 = trace_streamed, 1 = trace_paired_streamed, 2 =
// trace_dense_streamed, at packet width `width` (0: the shipped one);
// out = {packet width, dynamic shared memory per block in bytes, resident
// blocks per SM (0 when a block does not fit the card), threads per block,
// the card's opt-in limit in bytes, registers per thread, local memory per
// thread in bytes}. 0, or a CUDA error.
int iris_packet_config(int kernel, int width, int leaf_size, int* out) {
  if (leaf_size < 1 || kernel < 0 || kernel > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 0) width = kernel == 0 ? kStreamedPacket : kPairPacket;
  const void* fn = nullptr;
  long long shared = 0;
  if (kernel == 0) {
    fn = reinterpret_cast<const void*>(streamed_kernel_of(width));
  } else if (kernel == 1) {
    fn = reinterpret_cast<const void*>(paired_streamed_kernel_of(width));
    if (fn != nullptr) shared = pair_shared_bytes(width, 3LL * leaf_size);
  } else {
    fn = reinterpret_cast<const void*>(dense_streamed_kernel_of(width));
    if (fn != nullptr) shared = pair_shared_bytes(width, kSlot4);
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int limit = 0;
  rc = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                              dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int threads = kPacketWarps * 32;
  out[0] = width;
  out[1] = static_cast<int>(shared);
  out[2] = 0;
  out[3] = threads;
  out[4] = limit;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  if (shared > limit) return 0;  // no block of it fits
  const int opt = reserve_shared(fn, shared);
  if (opt != 0) return opt;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], fn, threads, static_cast<size_t>(shared));
  return static_cast<int>(rc);
}

// What the per-ray walk a launch of this leaf size runs takes on the
// current device: kernel 0 = trace_ordered, 1 = trace_paired, 2 =
// trace_dense, 3 = trace_union; out = {threads per block, registers per
// thread, local memory per thread in bytes (stack and spills), static
// shared memory per block in bytes, resident blocks per SM}. 0, or a CUDA
// error.
int iris_walk_config(int kernel, int leaf_size, int* out) {
  const void* fn = nullptr;
  if (kernel == 0 && leaf_size >= 1) {
    fn = reinterpret_cast<const void*>(trace_ordered_kernel);
  } else if (kernel == 1) {
    fn = reinterpret_cast<const void*>(paired_kernel_of(leaf_size));
  } else if (kernel == 2) {
    fn = reinterpret_cast<const void*>(dense_kernel_of(leaf_size));
  } else if (kernel == 3) {
    fn = reinterpret_cast<const void*>(union_kernel_of(leaf_size));
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = kWalkThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], fn,
                                                     kWalkThreads, 0);
  return static_cast<int>(rc);
}

}  // extern "C"
