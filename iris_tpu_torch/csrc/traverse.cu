// Closest-hit BVH traversal kernels for Hopper (sm_90a), plain C ABI.
//
// Built by iris_tpu_torch/geometry/cuda_intersect.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and called through ctypes. Every entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Every kernel computes what its Pallas kernel of
// iris_tpu/geometry/pallas_intersect.py computes: per ray, the closest hit
// (t, u, v, face_id) with face_id = -1 for a miss. The TPU walks one
// traversal cursor per tile of rays (the union of the tile's paths, every
// lane a vector op). trace_union, trace_paired, trace_ordered and
// trace_dense walk one ray per thread, which is the natural unit on an SM
// and visits a subset of the tile's nodes with the same hits; the three
// streamed kernels (trace_streamed, trace_paired_streamed,
// trace_dense_streamed) keep the TPU's shared cursor, one per warp of 32
// rays, and stage the rows they read through shared-memory windows.
//
// --fmad=false: no multiply-add contraction, so t/u/v round exactly as the
// plain PyTorch versions (and the JAX package) round them; the kernels are
// held against those versions at zero error on the card.
//
// What bounds them on this card: each visit reads a node (32 B) or a pair
// row (64 B used) and each leaf reads leaf_size triangle rows (48 B), all
// from a tree small enough to stay in the 50 MB L2, then spends ~24 FP32
// operations per slab test and ~55 per Moller-Trumbore test. Both counts
// depend on the data (how deep each ray walks). The walks are latency
// bound (a dependent load per step) and, one ray per thread, divergent
// (neighbouring rays walk different paths); the designs below shorten the
// dependent chain (shared memory, float4 rows, one coalesced window load
// per warp) and leave warp coherence to the caller's ray order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTMiss = 3e37f;   // pallas_intersect.py:30
constexpr float kMtEps = 1e-9f;   // pallas_intersect.py:31
constexpr int kThreads = 256;
// Stack entries of the near-first walks (per thread, or per warp in the
// packet walk). The host refuses trees whose stack need
// (_auto_stack_depth) exceeds it instead of truncating.
constexpr int kStackCap = 128;
// The union kernel stages the whole tree in shared memory up to this size
// (the default dynamic shared-memory limit; no opt-in attribute needed).
constexpr int kStageBytes = 48 * 1024;
// float4s per 128-float row of the paired layout (pallas_intersect.py:621)
constexpr int kRow4 = 32;
// float4s of the 16 useful floats of a pair row (the compact (R, 16) view)
constexpr int kPair4 = 4;
// Warps (ray packets) per block of the packet walk: each owns a stack and
// two windows in shared memory, so fewer warps leave room for wider leaves.
constexpr int kPacketWarps = 4;
// Rows per shared-memory window of the packet walk: 32 compact pair rows
// (2 KB) and 8 whole leaf rows (1.5 KB at leaf_size 4). The only sizes
// measured so far; cuda_intersect.py's PAIR_WIN/LEAF_WIN count reloads of
// the same windows.
constexpr int kPairWin = 32;
constexpr int kLeafWin = 8;
// Nodes (32 bytes each) per window of the stackless packet walk: 2 KB.
constexpr int kNodeWin = 64;
// float4s of one leaf slot of the dense layout (64 floats; two per
// 128-float row, pallas_intersect.py:1055-1099)
constexpr int kSlot4 = 16;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSharedLimit = 48 * 1024;

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

template <bool kStaged>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (kStaged) {
    return *p;
  } else {
    return __ldg(p);
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

// trace_union — replaces pallas_ray_trace / _kernel
// (pallas_intersect.py:176, 240). Stackless preorder skip-pointer walk over
// nodes (N, 8) and tris (P, 12): descend to desc on a slab hit, otherwise
// jump to skip; a hit leaf (desc <= 0) tests leaf_size rows from -desc.
// The TPU's tile-union walk visits a superset of this ray's nodes; the
// extra visits are misses for this lane (child boxes nest in parent boxes
// and t_best only shrinks), and triangles are met in the same preorder, so
// the hits and their tie-breaking are the same.
// Design: the TPU kernel keeps the tree VMEM-resident; here a tree of up to
// kStageBytes (the flagship scene's is 39 KB) is staged into shared memory
// once per block, so every dependent node/triangle load in the walk is a
// shared-memory read. Rows are read as float4s (2 per node, 3 per
// triangle). Bigger trees are read through the read-only cache.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    trace_union_kernel(const float4* __restrict__ nodes_g, int n_nodes,
                       const float4* __restrict__ tris_g, int n_tri_rows,
                       int leaf_size, const float* __restrict__ orig,
                       const float* __restrict__ dirs, int n_rays,
                       float* __restrict__ t_out, float* __restrict__ u_out,
                       float* __restrict__ v_out, int* __restrict__ f_out) {
  extern __shared__ float4 stage[];
  const float4* nodes = nodes_g;
  const float4* tris = tris_g;
  if constexpr (kStaged) {
    const int nn = 2 * n_nodes;
    const int nt = 3 * n_tri_rows;
    for (int k = threadIdx.x; k < nn; k += blockDim.x) stage[k] = __ldg(nodes_g + k);
    for (int k = threadIdx.x; k < nt; k += blockDim.x) stage[nn + k] = __ldg(tris_g + k);
    __syncthreads();
    nodes = stage;
    tris = stage + nn;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(orig, dirs, i);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  // a walk of a well-formed tree visits each node at most once; the cap
  // only keeps a corrupt tree from hanging the card
  const int max_steps = 2 * n_nodes + 2;
  int cur = 1;
  for (int step = 0; cur > 0 && step < max_steps; ++step) {
    const int node = min(max(cur - 1, 0), n_nodes - 1);
    const float4 a = ld4<kStaged>(nodes + 2 * node);
    const float4 b = ld4<kStaged>(nodes + 2 * node + 1);
    float tlo;
    const bool hit = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, &tlo);
    const float desc = b.w;
    const bool leaf = desc <= 0.0f;
    if (hit && leaf) {
      const int base = static_cast<int>(-desc);
      for (int k = 0; k < leaf_size; ++k) {
        const int row = min(max(base + k, 0), n_tri_rows - 1);
        const float4* tr = tris + 3 * row;
        mt_fold(r, ld4<kStaged>(tr), ld4<kStaged>(tr + 1),
                ld4<kStaged>(tr + 2), h);
      }
    }
    cur = (hit && !leaf) ? static_cast<int>(desc) : static_cast<int>(b.z);
  }
  store_hit(h, i, t_out, u_out, v_out, f_out);
}

// One whole leaf of a per-ray walk: leaf lrow starts kLeaf4 float4s after
// leaf lrow - 1 (a 128-float row of the paired layout, a 64-float slot of
// the dense one).
template <int kLeaf4>
__device__ __forceinline__ void leaf_hits(const Ray& r,
                                          const float4* __restrict__ leaves,
                                          int lrow, int n_leaf_rows,
                                          int leaf_size, Hit& h) {
  lrow = min(max(lrow, 0), n_leaf_rows - 1);
  const float4* lf = leaves + static_cast<size_t>(lrow) * kLeaf4;
  for (int k = 0; k < leaf_size; ++k) {
    mt_fold(r, __ldg(lf + 3 * k), __ldg(lf + 3 * k + 1),
            __ldg(lf + 3 * k + 2), h);
  }
}

// trace_paired — replaces pallas_ray_trace_paired / _kernel_paired
// (pallas_intersect.py:675, 782) over the _pack_paired rows (:621): pair
// row r holds both children of internal node r (lanes 0-5 left box, 6 its
// desc', 8-13 right box, 14 its desc'); desc' > 0 is an internal child
// whose pair row is desc'-1, desc' <= 0 a leaf child whose leaf row is
// -desc'. Leaf rows hold a whole leaf (leaf_size x 12 floats).
// Near-child-first: pop a pair row, slab-test both children against the
// current t_best, intersect leaf children in place (left, then right) so
// their hits prune the pushes, then push the far internal child and the
// near one. Near/far is this ray's own entry distance, where the TPU used
// the tile's mean (:735-741), so equal-t ties may pick another face.
// Design: the tree stays in global memory (the 102K-face scene's paired
// layout is 32 MB of 128-float rows, which the 50 MB L2 holds); each pop is 4 float4 loads and each
// leaf 3 per triangle. The stack is per thread, indexed dynamically, so
// it lives in local memory (L1-cached); its depth is checked on the host.
// The walk of trace_paired and trace_dense: pair record p starts
// kPairStride4 float4s after record p - 1, leaf l kLeaf4 after leaf l - 1.
template <int kPairStride4, int kLeaf4>
__device__ __forceinline__ void pair_walk(
    const float4* __restrict__ pairs, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(orig, dirs, i);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  int stack[kStackCap];
  stack[0] = 0;  // the root's pair row
  int sp = 1;
  // each internal node is pushed at most once per walk; the cap only keeps
  // a corrupt tree from hanging the card
  const int max_steps = 2 * n_pairs + 2;
  for (int step = 0; sp > 0 && step < max_steps; ++step) {
    const int row_id = stack[--sp];
    const float4* row = pairs + static_cast<size_t>(row_id) * kPairStride4;
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
    if (hit_l && l_leaf) {
      leaf_hits<kLeaf4>(r, leaves, static_cast<int>(-dl), n_leaf_rows,
                        leaf_size, h);
    }
    if (hit_r && r_leaf) {
      leaf_hits<kLeaf4>(r, leaves, static_cast<int>(-dr), n_leaf_rows,
                        leaf_size, h);
    }
    const bool want_l = hit_l && !l_leaf;
    const bool want_r = hit_r && !r_leaf;
    const int pid_l = min(max(static_cast<int>(dl) - 1, 0), n_pairs - 1);
    const int pid_r = min(max(static_cast<int>(dr) - 1, 0), n_pairs - 1);
    const bool l_near = (want_l && want_r) ? (tlo_l <= tlo_r) : want_l;
    const int far_id = l_near ? pid_r : pid_l;
    const int near_id = l_near ? pid_l : pid_r;
    const bool push_far = want_l && want_r;
    const bool push_near = want_l || want_r;
    // same clamped pushes as the TPU kernel (:745-757); with the host's
    // stack_depth >= depth + 4 the clamp is never reached
    if (push_far) stack[min(sp, stack_depth - 1)] = far_id;
    const int sp3 = sp + (push_far ? 1 : 0);
    if (push_near) stack[min(sp3, stack_depth - 1)] = near_id;
    sp = min(sp3 + (push_near ? 1 : 0), stack_depth);
  }
  store_hit(h, i, t_out, u_out, v_out, f_out);
}

__global__ void __launch_bounds__(kThreads) trace_paired_kernel(
    const float4* __restrict__ pairs, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out) {
  pair_walk<kRow4, kRow4>(
      pairs, n_pairs, leaves, n_leaf_rows, leaf_size, stack_depth, orig, dirs,
      n_rays, t_out, u_out, v_out, f_out);
}

// trace_dense — replaces pallas_ray_trace_dense / _kernel_dense
// (pallas_intersect.py:1102, 1221) over the _pack_dense rows (:1059): the
// near-first pair walk of trace_paired with every record taken from its
// slot: pair p at row p / 8, lanes 16 * (p % 8) + {0..6, 8..14}; leaf l at
// row l / 2, lanes 64 * (l % 2) + 12 * k + {0..9}. The TPU kernel reads the
// whole 128-lane row and picks the slot with a chain of scalar selects
// (slot_scalar, :1115-1124), because Mosaic cannot index lanes
// dynamically; a thread can, so the slot is addressed: the dense pair
// array is a contiguous run of 64-byte records and the leaf array one of
// 256-byte slots.
// What "dense" buys on the TPU is residency (the 102K-face tree's dense
// layout is 9.7 MB where its paired layout is 30.9 MB). This card keeps
// either layout in its 50 MB L2 and neither in shared memory, so the
// counterpart is trace_paired's per-ray walk with denser rows: a pop is
// the same four 16-byte loads, but eight records share a 512-byte line
// span where trace_paired's rows have one each, and a leaf's triangles
// come from a 256-byte-aligned slot. Bound as trace_paired: a dependent
// load per step, divergent warps. A cp.async prefetch of the near child's
// record while the leaves are folded is where pipelining would go.
__global__ void __launch_bounds__(kThreads) trace_dense_kernel(
    const float4* __restrict__ pairs, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out) {
  pair_walk<kPair4, kSlot4>(
      pairs, n_pairs, leaves, n_leaf_rows, leaf_size, stack_depth, orig, dirs,
      n_rays, t_out, u_out, v_out, f_out);
}

// trace_ordered — replaces pallas_ray_trace_ordered / _kernel_ordered
// (pallas_intersect.py:436, 579). Near-child-first walk with pop-time
// pruning over the unpaired nodes (N, 8) and tris (P, 12) of a preorder
// tree: pop a node and slab-test it against the CURRENT t_best; a hit leaf
// tests its leaf_size triangle rows; a hit internal node slab-tests both
// children (left = desc, right = the left child's skip pointer, the
// preorder invariant of :498-502) and pushes the far one, then the near
// one. Any leaf_size, so it takes the trees whose leaf row is too wide for
// the paired layout. Near/far is this ray's own entry distance, where the
// TPU used the tile's mean (:507-513), so equal-t ties may pick another
// face.
// Design: one ray per thread, as trace_paired; the tree stays in global
// memory and each row is read as float4s (2 per node, 3 per triangle)
// through the read-only cache; a visited internal node costs three
// dependent node reads (itself, left child, right child), which is what
// the paired layout folds into one. The per-thread stack lives in local
// memory; its depth is checked on the host.
__global__ void __launch_bounds__(kThreads)
    trace_ordered_kernel(const float4* __restrict__ nodes, int n_nodes,
                         const float4* __restrict__ tris, int n_tri_rows,
                         int leaf_size, int stack_depth,
                         const float* __restrict__ orig,
                         const float* __restrict__ dirs, int n_rays,
                         float* __restrict__ t_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ f_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(orig, dirs, i);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  int stack[kStackCap];
  stack[0] = 0;  // the root node, 0-based
  int sp = 1;
  // each node is pushed at most once per walk; the cap only keeps a
  // corrupt tree from hanging the card
  const int max_steps = 2 * n_nodes + 2;
  for (int step = 0; sp > 0 && step < max_steps; ++step) {
    const int node = stack[--sp];
    const float4 a = __ldg(nodes + 2 * node);
    const float4 b = __ldg(nodes + 2 * node + 1);
    float tlo;
    if (!slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, &tlo)) continue;
    const float desc = b.w;
    if (desc <= 0.0f) {
      const int base = static_cast<int>(-desc);
      for (int k = 0; k < leaf_size; ++k) {
        const int row = min(max(base + k, 0), n_tri_rows - 1);
        const float4* tr = tris + 3 * row;
        mt_fold(r, __ldg(tr), __ldg(tr + 1), __ldg(tr + 2), h);
      }
      continue;
    }
    const int child_l = min(max(static_cast<int>(desc) - 1, 0), n_nodes - 1);
    const float4 la = __ldg(nodes + 2 * child_l);
    const float4 lb = __ldg(nodes + 2 * child_l + 1);
    const int child_r = min(max(static_cast<int>(lb.z) - 1, 0), n_nodes - 1);
    const float4 ra = __ldg(nodes + 2 * child_r);
    const float4 rb = __ldg(nodes + 2 * child_r + 1);
    float tlo_l, tlo_r;
    const bool hit_l = slab(r, la.x, la.y, la.z, la.w, lb.x, lb.y, h.t, &tlo_l);
    const bool hit_r = slab(r, ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, h.t, &tlo_r);
    const bool l_near = (hit_l && hit_r) ? (tlo_l <= tlo_r) : hit_l;
    const int far_id = l_near ? child_r : child_l;
    const int near_id = l_near ? child_l : child_r;
    const bool push_far = hit_l && hit_r;
    const bool push_near = hit_l || hit_r;
    // same clamped pushes as the TPU kernel (:519-531)
    if (push_far) stack[min(sp, stack_depth - 1)] = far_id;
    const int sp3 = sp + (push_far ? 1 : 0);
    if (push_near) stack[min(sp3, stack_depth - 1)] = near_id;
    sp = min(sp3 + (push_near ? 1 : 0), stack_depth);
  }
  store_hit(h, i, t_out, u_out, v_out, f_out);
}

// Butterfly sum over the warp: every lane gets
// ((a_i + a_i^16) + (a_i^8 + a_i^24)) + ..., the halving order the plain
// PyTorch version repeats, so both round the mean alike.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

// One leaf of a packet walk: make sure the warp's leaf window holds row
// lrow (one coalesced load of up to kLeafWin whole leaf rows when it does
// not), then every lane whose ray entered the leaf's box folds the leaf's
// triangles, read from shared memory. A leaf row is leaf4 float4s long:
// 3 * leaf_size in the compact rows, kSlot4 in the dense layout's slots.
__device__ __forceinline__ void packet_leaf(
    const Ray& r, bool hit, int lrow, const float4* __restrict__ leaves,
    int n_leaf_rows, int leaf_size, int leaf4, int& lwin, float4* lbuf,
    int lane, Hit& h) {
  lrow = min(max(lrow, 0), n_leaf_rows - 1);
  const int tgt = lrow / kLeafWin;
  if (tgt != lwin) {  // warp-uniform
    __syncwarp();     // every lane is done with the old window
    const int base = tgt * kLeafWin;
    const int n4 = min(kLeafWin, n_leaf_rows - base) * leaf4;
    const float4* src = leaves + static_cast<size_t>(base) * leaf4;
    for (int k = lane; k < n4; k += 32) lbuf[k] = __ldg(src + k);
    __syncwarp();
    lwin = tgt;
  }
  if (hit) {
    const float4* lf = lbuf + (lrow - tgt * kLeafWin) * leaf4;
    for (int k = 0; k < leaf_size; ++k) {
      mt_fold(r, lf[3 * k], lf[3 * k + 1], lf[3 * k + 2], h);
    }
  }
}

// trace_paired_streamed — replaces pallas_ray_trace_paired_streamed /
// _kernel_paired_streamed (pallas_intersect.py:833, 989): the near-first
// paired walk with ONE cursor and ONE stack for a packet of rays, and the
// pair and leaf rows fetched through windows of consecutive rows that are
// reloaded when the cursor leaves them. Pop a pair row; every lane
// slab-tests both children against its own t_best and the packet votes
// (any lane); leaf children are intersected at once (left, then right) by
// the lanes that entered their box, so t_best shrinks before the pushes;
// the far internal child is pushed, then the near one, ordered by the
// MEAN entry distance of the lanes that hit each child (:937-947).
// Design: the TPU tile of 8,192 lanes becomes one warp of 32 consecutive
// rays (spatially sorted by the caller on big trees), votes are
// __ballot_sync, means are warp_sum. The stack and both windows are per
// warp in shared memory: a window load is one coalesced read of kPairWin
// compact 64-byte pair rows (the (R, 16) view: the (R, 128) rows are 7/8
// padding) or of kLeafWin whole leaf rows (leaf_size x 48 bytes, the
// tris array itself), after which every row read of the walk is a
// shared-memory broadcast. Windows are aligned (window = row / win) as on
// the TPU; in a preorder tree the left child's pair row is the next row,
// so descents reuse the window and a reload happens mostly at far pops.
// A packet visits the union of its rays' paths, so it does more slab
// tests than trace_paired and fewer, wider memory reads.
// The walk of trace_paired_streamed and trace_dense_streamed: pair records
// are 64 bytes apart in both layouts; a whole leaf is leaf4 float4s long.
__device__ __forceinline__ void packet_pair_walk(
    const float4* __restrict__ pairs16, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out, int leaf4) {
  extern __shared__ float4 packet_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * blockDim.x + warp * 32;
  if (first >= n_rays) return;  // the whole packet is past the end
  const int per_warp4 =
      kStackCap / 4 + kPairWin * kPair4 + kLeafWin * leaf4;
  float4* mine = packet_smem + warp * per_warp4;
  int* stack = reinterpret_cast<int*>(mine);
  float4* pbuf = mine + kStackCap / 4;
  float4* lbuf = pbuf + kPairWin * kPair4;

  const int i = first + lane;
  const bool live = i < n_rays;  // lanes past the end never vote
  const Ray r = load_ray(orig, dirs, live ? i : n_rays - 1);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  if (lane == 0) stack[0] = 0;  // the root's pair row
  __syncwarp();
  int sp = 1;
  int pwin = -1;  // no window loaded
  int lwin = -1;
  const int max_steps = 2 * n_pairs + 2;
  for (int step = 0; sp > 0 && step < max_steps; ++step) {
    const int row_id = stack[--sp];  // the same for every lane
    const int tgt = row_id / kPairWin;
    if (tgt != pwin) {
      __syncwarp();
      const int base = tgt * kPairWin;
      const int n4 = min(kPairWin, n_pairs - base) * kPair4;
      const float4* src = pairs16 + static_cast<size_t>(base) * kPair4;
      for (int k = lane; k < n4; k += 32) pbuf[k] = __ldg(src + k);
      __syncwarp();
      pwin = tgt;
    }
    const float4* row = pbuf + (row_id - tgt * kPairWin) * kPair4;
    const float4 a = row[0];
    const float4 b = row[1];
    const float4 c = row[2];
    const float4 d = row[3];
    float tlo_l, tlo_r;
    const bool hit_l =
        slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, &tlo_l) && live;
    const bool hit_r =
        slab(r, c.x, c.y, c.z, c.w, d.x, d.y, h.t, &tlo_r) && live;
    const unsigned m_l = __ballot_sync(kFullMask, hit_l);
    const unsigned m_r = __ballot_sync(kFullMask, hit_r);
    const float dl = b.z;
    const float dr = d.z;
    const bool l_leaf = dl <= 0.0f;
    const bool r_leaf = dr <= 0.0f;
    if (m_l != 0u && l_leaf) {
      packet_leaf(r, hit_l, static_cast<int>(-dl), leaves, n_leaf_rows,
                  leaf_size, leaf4, lwin, lbuf, lane, h);
    }
    if (m_r != 0u && r_leaf) {
      packet_leaf(r, hit_r, static_cast<int>(-dr), leaves, n_leaf_rows,
                  leaf_size, leaf4, lwin, lbuf, lane, h);
    }
    const bool want_l = m_l != 0u && !l_leaf;
    const bool want_r = m_r != 0u && !r_leaf;
    const int pid_l = min(max(static_cast<int>(dl) - 1, 0), n_pairs - 1);
    const int pid_r = min(max(static_cast<int>(dr) - 1, 0), n_pairs - 1);
    bool l_near = want_l;
    if (want_l && want_r) {
      const float mean_l = warp_sum(hit_l ? tlo_l : 0.0f) /
                           fmaxf(static_cast<float>(__popc(m_l)), 1.0f);
      const float mean_r = warp_sum(hit_r ? tlo_r : 0.0f) /
                           fmaxf(static_cast<float>(__popc(m_r)), 1.0f);
      l_near = mean_l <= mean_r;
    }
    const int far_id = l_near ? pid_r : pid_l;
    const int near_id = l_near ? pid_l : pid_r;
    const bool push_far = want_l && want_r;
    const bool push_near = want_l || want_r;
    const int sp3 = sp + (push_far ? 1 : 0);
    __syncwarp();  // every lane has read its pop before the pushes land
    if (lane == 0) {
      // same clamped pushes as the TPU kernel (:949-961)
      if (push_far) stack[min(sp, stack_depth - 1)] = far_id;
      if (push_near) stack[min(sp3, stack_depth - 1)] = near_id;
    }
    __syncwarp();
    sp = min(sp3 + (push_near ? 1 : 0), stack_depth);
  }
  if (live) store_hit(h, i, t_out, u_out, v_out, f_out);
}

__global__ void __launch_bounds__(kPacketWarps * 32)
    trace_paired_streamed_kernel(
    const float4* __restrict__ pairs16, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out) {
  packet_pair_walk(pairs16, n_pairs, leaves, n_leaf_rows, leaf_size,
                   stack_depth, orig, dirs, n_rays, t_out, u_out, v_out,
                   f_out, 3 * leaf_size);
}

// trace_dense_streamed — replaces pallas_ray_trace_dense_streamed /
// _kernel_dense_streamed (pallas_intersect.py:1271, 1437): trace_dense's
// records walked as trace_paired_streamed walks its own, one cursor and
// stack per packet, the dense rows read through windows counted in dense
// rows (kPairWin / 8 = 4 rows of 8 pair records, kLeafWin / 2 = 4 rows of
// 2 leaf slots); left leaf before right leaf, each with its own window
// check (:1349-1379); near and far by the mean entry distance of the lanes
// that want the child (:1385-1391).
// What is and is not new on this card: the TPU kernel exists because a
// paired row carries one 16-float pair in 128 lanes, an 8x pad on every
// byte that crosses its DMA, and dense rows remove the pad. Here
// trace_paired_streamed already reads compact 64-byte pair records, so
// the pair side of this kernel is the same bytes through the same
// 32-record window. Only the leaf side differs: leaves sit in aligned
// 256-byte slots (a window is always 2 KB, whatever leaf_size) where the
// compact rows are leaf_size x 48 bytes long and unaligned. Same bound as
// trace_paired_streamed: a chain of shared-memory reads, ballots and
// __syncwarps per pop, and the union of 32 rays' paths. A cp.async
// prefetch of the next window (the left child's record is the next one)
// is where pipelining would go.
__global__ void __launch_bounds__(kPacketWarps * 32)
    trace_dense_streamed_kernel(
    const float4* __restrict__ pairs16, int n_pairs,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    int stack_depth, const float* __restrict__ orig,
    const float* __restrict__ dirs, int n_rays, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ f_out) {
  packet_pair_walk(pairs16, n_pairs, leaves, n_leaf_rows, leaf_size,
                   stack_depth, orig, dirs, n_rays, t_out, u_out, v_out,
                   f_out, kSlot4);
}

// trace_streamed — replaces pallas_ray_trace_streamed / _kernel_streamed
// (pallas_intersect.py:271, 371): the stackless skip-pointer walk of
// trace_union with ONE cursor for a packet of rays and the tree read
// through forward-only windows. Visit node cur - 1; every lane slab-tests
// it against its own t_best; a leaf (desc <= 0, leaf ordinal
// -desc / leaf_size) is folded by the lanes whose own test hit; the packet
// descends to desc when any lane hit an internal node, else jumps to the
// skip pointer; cur <= 0 ends the walk. A lane's extra visits are misses
// for it (child boxes nest in parent boxes, t_best only shrinks), so each
// ray gets trace_union's hit, bit for bit.
// Design: the TPU pads every node and leaf to a 128-float row because its
// DMA needs it; the card does not, so the windows hold the compact rows:
// kNodeWin 32-byte nodes of the (N, 8) array and kLeafWin whole leaves of
// the tris array, per warp in shared memory, each reload one coalesced
// read. In a preorder tree both the node cursor and the leaf base only
// grow along a walk (:277-280), so a window never goes back: the next
// one's address is known, which is where a cp.async prefetch would go. No
// stack, so no __syncwarp outside the reloads. What bounds it: it visits
// nodes in storage order, not near-first, so t_best shrinks late and a
// packet walks the union of 32 rays' unpruned paths: the most slab tests
// of the five big-tree kernels, each a dependent shared-memory read.
__global__ void __launch_bounds__(kPacketWarps * 32) trace_streamed_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float4* __restrict__ leaves, int n_leaf_rows, int leaf_size,
    const float* __restrict__ orig, const float* __restrict__ dirs,
    int n_rays, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ f_out) {
  extern __shared__ float4 packet_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * blockDim.x + warp * 32;
  if (first >= n_rays) return;  // the whole packet is past the end
  const int leaf4 = 3 * leaf_size;
  float4* nbuf = packet_smem + warp * (kNodeWin * 2 + kLeafWin * leaf4);
  float4* lbuf = nbuf + kNodeWin * 2;

  const int i = first + lane;
  const bool live = i < n_rays;  // lanes past the end never vote
  const Ray r = load_ray(orig, dirs, live ? i : n_rays - 1);
  Hit h{kTMiss, 0.0f, 0.0f, -1};
  int cur = 1;    // 1-based, the same for every lane
  int nwin = -1;  // no window loaded
  int lwin = -1;
  const int max_steps = 2 * n_nodes + 2;
  for (int step = 0; cur > 0 && step < max_steps; ++step) {
    const int node = min(max(cur - 1, 0), n_nodes - 1);
    const int tgt = node / kNodeWin;
    if (tgt != nwin) {
      __syncwarp();  // every lane is done with the old window
      const int base = tgt * kNodeWin;
      const int n4 = min(kNodeWin, n_nodes - base) * 2;
      const float4* src = nodes + static_cast<size_t>(base) * 2;
      for (int k = lane; k < n4; k += 32) nbuf[k] = __ldg(src + k);
      __syncwarp();
      nwin = tgt;
    }
    const float4 a = nbuf[(node - tgt * kNodeWin) * 2];
    const float4 b = nbuf[(node - tgt * kNodeWin) * 2 + 1];
    float tlo;
    const bool hit =
        slab(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t, &tlo) && live;
    const bool any_hit = __ballot_sync(kFullMask, hit) != 0u;
    const float desc = b.w;
    const bool leaf = desc <= 0.0f;
    if (any_hit && leaf) {
      packet_leaf(r, hit, static_cast<int>(-desc) / leaf_size, leaves,
                  n_leaf_rows, leaf_size, leaf4, lwin, lbuf, lane, h);
    }
    cur = (any_hit && !leaf) ? static_cast<int>(desc)
                             : static_cast<int>(b.z);
  }
  if (live) store_hit(h, i, t_out, u_out, v_out, f_out);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

using PacketPairKernel = void (*)(const float4*, int, const float4*, int, int,
                                  int, const float*, const float*, int, float*,
                                  float*, float*, int*);

// Launch of a packet walk over pair records, whole leaves leaf4 float4s
// long: every warp's stack and two windows go into dynamic shared memory,
// refused past the default 48 KB.
int launch_packet_pair(PacketPairKernel kernel, long long leaf4,
                       const void* pairs16, int n_pairs, const void* leaves,
                       int n_leaf_rows, int leaf_size, int stack_depth,
                       const void* orig, const void* dirs, int n_rays,
                       void* t_out, void* u_out, void* v_out, void* f_out,
                       void* stream) {
  if (n_rays <= 0) return 0;
  const long long shared =
      16LL * kPacketWarps *
      (kStackCap / 4 + kPairWin * kPair4 + kLeafWin * leaf4);
  if (stack_depth < 1 || stack_depth > kStackCap || n_pairs < 1 ||
      n_leaf_rows < 1 || leaf_size < 1 || shared > kSharedLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = kPacketWarps * 32;
  const int blocks = (n_rays + threads - 1) / threads;
  kernel<<<blocks, threads, shared, s>>>(
      static_cast<const float4*>(pairs16), n_pairs,
      static_cast<const float4*>(leaves), n_leaf_rows, leaf_size, stack_depth,
      static_cast<const float*>(orig), static_cast<const float*>(dirs), n_rays,
      static_cast<float*>(t_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int iris_paired_stack_cap() { return kStackCap; }

int iris_trace_union(const void* nodes, int n_nodes, const void* tris,
                     int n_tri_rows, int leaf_size, const void* orig,
                     const void* dirs, int n_rays, void* t_out, void* u_out,
                     void* v_out, void* f_out, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t stage_bytes = static_cast<size_t>(n_nodes) * 32 +
                             static_cast<size_t>(n_tri_rows) * 48;
  const auto* n4 = static_cast<const float4*>(nodes);
  const auto* t4 = static_cast<const float4*>(tris);
  const auto* o = static_cast<const float*>(orig);
  const auto* d = static_cast<const float*>(dirs);
  auto* t = static_cast<float*>(t_out);
  auto* u = static_cast<float*>(u_out);
  auto* v = static_cast<float*>(v_out);
  auto* f = static_cast<int*>(f_out);
  if (stage_bytes <= static_cast<size_t>(kStageBytes)) {
    trace_union_kernel<true><<<blocks_for(n_rays), kThreads, stage_bytes, s>>>(
        n4, n_nodes, t4, n_tri_rows, leaf_size, o, d, n_rays, t, u, v, f);
  } else {
    trace_union_kernel<false><<<blocks_for(n_rays), kThreads, 0, s>>>(
        n4, n_nodes, t4, n_tri_rows, leaf_size, o, d, n_rays, t, u, v, f);
  }
  return static_cast<int>(cudaGetLastError());
}

int iris_trace_paired(const void* pairs, int n_pairs, const void* leaves,
                      int n_leaf_rows, int leaf_size, int stack_depth,
                      const void* orig, const void* dirs, int n_rays,
                      void* t_out, void* u_out, void* v_out, void* f_out,
                      void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth < 1 || stack_depth > kStackCap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  trace_paired_kernel<<<blocks_for(n_rays), kThreads, 0, s>>>(
      static_cast<const float4*>(pairs), n_pairs,
      static_cast<const float4*>(leaves), n_leaf_rows, leaf_size, stack_depth,
      static_cast<const float*>(orig), static_cast<const float*>(dirs), n_rays,
      static_cast<float*>(t_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

int iris_trace_ordered(const void* nodes, int n_nodes, const void* tris,
                       int n_tri_rows, int leaf_size, int stack_depth,
                       const void* orig, const void* dirs, int n_rays,
                       void* t_out, void* u_out, void* v_out, void* f_out,
                       void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth < 1 || stack_depth > kStackCap || n_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  trace_ordered_kernel<<<blocks_for(n_rays), kThreads, 0, s>>>(
      static_cast<const float4*>(nodes), n_nodes,
      static_cast<const float4*>(tris), n_tri_rows, leaf_size, stack_depth,
      static_cast<const float*>(orig), static_cast<const float*>(dirs), n_rays,
      static_cast<float*>(t_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

int iris_trace_paired_streamed(const void* pairs16, int n_pairs,
                               const void* leaves, int n_leaf_rows,
                               int leaf_size, int stack_depth,
                               const void* orig, const void* dirs, int n_rays,
                               void* t_out, void* u_out, void* v_out,
                               void* f_out, void* stream) {
  return launch_packet_pair(trace_paired_streamed_kernel, 3LL * leaf_size,
                            pairs16, n_pairs, leaves, n_leaf_rows, leaf_size,
                            stack_depth, orig, dirs, n_rays, t_out, u_out,
                            v_out, f_out, stream);
}

int iris_trace_dense_streamed(const void* pairs, int n_pairs,
                              const void* leaves, int n_leaf_rows,
                              int leaf_size, int stack_depth, const void* orig,
                              const void* dirs, int n_rays, void* t_out,
                              void* u_out, void* v_out, void* f_out,
                              void* stream) {
  if (3 * leaf_size > kSlot4) return static_cast<int>(cudaErrorInvalidValue);
  return launch_packet_pair(trace_dense_streamed_kernel, kSlot4, pairs,
                            n_pairs, leaves, n_leaf_rows, leaf_size,
                            stack_depth, orig, dirs, n_rays, t_out, u_out,
                            v_out, f_out, stream);
}

int iris_trace_dense(const void* pairs, int n_pairs, const void* leaves,
                     int n_leaf_rows, int leaf_size, int stack_depth,
                     const void* orig, const void* dirs, int n_rays,
                     void* t_out, void* u_out, void* v_out, void* f_out,
                     void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_depth < 1 || stack_depth > kStackCap || n_pairs < 1 ||
      n_leaf_rows < 1 || leaf_size < 1 || 3 * leaf_size > kSlot4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  trace_dense_kernel<<<blocks_for(n_rays), kThreads, 0, s>>>(
      static_cast<const float4*>(pairs), n_pairs,
      static_cast<const float4*>(leaves), n_leaf_rows, leaf_size, stack_depth,
      static_cast<const float*>(orig), static_cast<const float*>(dirs), n_rays,
      static_cast<float*>(t_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

int iris_trace_streamed(const void* nodes, int n_nodes, const void* leaves,
                        int n_leaf_rows, int leaf_size, const void* orig,
                        const void* dirs, int n_rays, void* t_out, void* u_out,
                        void* v_out, void* f_out, void* stream) {
  if (n_rays <= 0) return 0;
  // every warp's node and leaf windows; refused past the default 48 KB
  const long long shared =
      16LL * kPacketWarps * (kNodeWin * 2 + 3LL * kLeafWin * leaf_size);
  if (n_nodes < 1 || n_leaf_rows < 1 || leaf_size < 1 ||
      shared > kSharedLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = kPacketWarps * 32;
  const int blocks = (n_rays + threads - 1) / threads;
  trace_streamed_kernel<<<blocks, threads, shared, s>>>(
      static_cast<const float4*>(nodes), n_nodes,
      static_cast<const float4*>(leaves), n_leaf_rows, leaf_size,
      static_cast<const float*>(orig), static_cast<const float*>(dirs), n_rays,
      static_cast<float*>(t_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
