// The DemuxNet conv trunk after stem1 (or one named segment of it) as ONE
// kernel launch, f32, for sm_90a.
//
// Replaces deepbinner_tpu/models/pallas_apply.py::_mega_kernel, launched by
// _run_segment.  It computes the same function: for one window,
//   early:      stem2 + pool2; per block, conv1 then conv2 + pool2;
//   inceptions: four branches (1x1, k3, k3 dilated 2^(i+1), SAME pool3 then
//               1x1), each with a fused pool2, concatenated over channels;
//   head:       head_conv, then the mean over L (global average pool).
// Every unit is a SAME-padded dilated conv (zeros outside the window at
// each unit's input), the folded BatchNorm affine and a ReLU.  pool3 pads
// with -inf.  A segment is a contiguous run of those stages; its input is
// (N, L, C) and its output (N, head) or (N, L', C') in device memory.  No
// activation inside the segment is written to device memory.
//
// What bounds it on an H100: the FP32 operations, 2 * K * C_in * C_out per
// output row of each unit (about 206 GFLOP for a 2816-window batch of the
// flagship model) against the card's 67 TFLOP/s FP32 peak; the input read
// (the stem1 output) is about a twentieth of that time.  No TF32 and no
// tensor cores: the reference is f32.  So the design is about keeping the
// FMA pipes of every SM fed:
// - Each thread keeps a register tile of RT rows by 4 channels.  RT is the
//   caller's choice per unit (ops/trunk_kernel.plan_segment), from the
//   instances DEEPBINNER_TRUNK_ROW_TILES builds: the one whose (row tile,
//   4-channel group) items take the block the fewest instructions per
//   thread, so that a unit with few rows still fills the block.
// - The "window" loop (the (K, d) pairs path_of names): per input channel
//   a thread loads the RT + (K-1)*d activations its rows need once into
//   registers and runs all K taps on them, one float4 weight load per tap:
//   RT + (K-1)*d + K shared-memory loads feed 4 * RT * K FMAs.  Any other
//   (K, d) takes the "generic" loop (tap outside channel, RT + 1 loads per
//   tap and channel).  No masks: every buffer holds zeros at the window
//   edges (below), so both loops read plain values.
// - An inception module is one pass: its four branches' items, branch-major,
//   share the block, each branch with its own (K, d) and weight slab, and
//   each writes its channel slice of the next buffer (the concat is free).
//   The pool branch takes the window-3 max (-inf outside the window) of the
//   RT + 2 values it loads, so pool3 costs no pass of its own.
//
// Design.  One block of 512 threads per window.  A block has 227 KB of
// shared memory: one window's stem1 output alone (1024 x 48 f32) is 192 KB,
// and the weights (about 700 KB) cannot stay resident.  So:
// - The early units all have K = 3, d = 1.  The block walks the early
//   output in tiles of kTile rows.  For each tile it loads the rows of the
//   segment input that the tile needs (8 * kTile + 26 rows for the flagship)
//   and runs every early unit on a shrinking row range, ping-ponging
//   between two shared buffers.  The halo rows are recomputed by each tile.
//   A row outside the window is written as 0 at every unit's output, so
//   the next unit sees SAME zero padding at the window edge, exactly as a
//   unit that ran on the whole window would.
// - The late part fits per window (flagship: 128 x 96 input, 64 x 128 and
//   32 x 128 inception outputs), so it runs on whole-window buffers with
//   zeroed pad rows above and below.
// - Weights are streamed through a shared stage from one packed buffer that
//   stays hot in the 50 MB L2, in equal chunks of C_in, for each pass of
//   items (every flagship unit takes one pass).  The stage and the tile's
//   input rows are copied with cp.async, so that each thread has all its
//   copies in flight at once: with one block per SM nothing else hides
//   their latency.
// - The early tile, the block size and the weight stage were chosen by
//   timing a grid of them on the card; the block takes about 206 KB of
//   shared memory for the flagship's "all" segment, so one block runs on
//   each SM.
//
// Determinism: every output is summed in one fixed order (C_in chunk, then
// channel, then tap for "window"; chunk, tap, channel for "generic") by one
// thread, and the global average pool is one thread's sum over L in order,
// so results are bit-identical from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxUnits = 40;
constexpr int kUnitInts = 8;     // ints per unit in the C interface's table
constexpr int kTile = 32;        // early-output rows per tile
constexpr int kSlack = 8;        // rows a row tile may read past a buffer
constexpr int kWFloats = 16384;  // weight stage: taps x C_in chunk x C_out
constexpr int kMaxSmem = 232448; // the most a block may opt in to (227 KB)

// The row tiles (rows per thread) built; ops/trunk_kernel.ROW_TILES mirrors
// it.  Even ones only: every pooling unit needs one, and on the card no odd
// one beat its even neighbours at any flagship unit.  A last, partial row
// tile reads up to RT - 1 rows past the rows its unit needs, which kSlack
// covers.
#define DEEPBINNER_TRUNK_ROW_TILES(X) X(2) X(4) X(6) X(8)
constexpr int kMaxRowTile = 8;
static_assert(kSlack >= kMaxRowTile - 1, "kSlack must cover a row tile");

struct Unit {
  int c_in, c_out, taps, dil, pool;
  int w;   // offset of the (taps, c_in, c_out) kernel in params, in floats
  int sb;  // offset of the scale (c_out floats), then the bias (c_out)
  int rt;  // rows per thread (the same for an inception's four branches)
};
static_assert(sizeof(Unit) == kUnitInts * sizeof(int), "one table row");

struct Plan {
  Unit u[kMaxUnits];
  int n_units;
  int n_early, n_inc, head;  // unit counts: n_early + 4 * n_inc + head
  int length, c_in0;         // the segment's input window
  int early_len;             // window length after the early units
  int w_floats;              // weight stage size, at most kWFloats
  int w_at, p0_at, p1_at, b_at;  // shared-memory offsets, in floats
};

// A shared buffer of rows: buffer row r holds window row lo + r.
struct Act {
  float* p;
  int lo;
  int stride;
};

// The same as an offset into shared memory, in floats: what a pass is
// handed, so that it reads through a pointer the compiler knows to be
// shared (a pointer argument of a function that is not inlined would be a
// generic one).
struct Rows {
  int at;
  int lo;
  int stride;
};

__device__ __forceinline__ float* shared_floats() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4);
}

// Where a pass writes: output row j to p[(j - lo) * stride + ch_off + co];
// a row outside [0, len_out) is written as 0 when zero_outside, else skipped.
struct Out {
  float* p;
  int lo, stride, ch_off;
  bool zero_outside;
};

// The inner loops: one per "window" (K, d) pair (ops/trunk_kernel.WINDOW_TAPS
// mirrors them), the generic one and the pool branch's.
enum Path { kGeneric, kTap1, kTap3, kTap3Dil2, kTap3Dil4, kPool3 };

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// An odd row stride puts the row tiles that one warp reads in different
// shared-memory banks.
__host__ __device__ inline int row_stride(int c) { return c | 1; }

__host__ __device__ inline int halo_of(const Unit& u) {
  return (u.taps - 1) / 2 * u.dil;
}

__host__ __device__ inline int path_of(const Unit& u, bool pool3) {
  if (pool3) return kPool3;  // make_plan checks that it has one tap
  if (u.taps == 1 && u.dil == 1) return kTap1;
  if (u.taps == 3 && u.dil == 1) return kTap3;
  if (u.taps == 3 && u.dil == 2) return kTap3Dil2;
  if (u.taps == 3 && u.dil == 4) return kTap3Dil4;
  return kGeneric;
}

// Pad rows the units starting at `first` need on their input.
__host__ __device__ inline int consumer_pad(const Plan& p, int first) {
  const int inc_end = p.n_early + 4 * p.n_inc;
  if (first < inc_end) {
    int pad = 0;
    for (int k = 0; k < 4; ++k) pad = imax(pad, halo_of(p.u[first + k]));
    return pad;
  }
  return p.head ? halo_of(p.u[first]) : 0;
}

// Floats of the weight stage one input channel of a pass takes: the
// (taps, co_pad) slab of each of its units.
__host__ __device__ inline int stage_per_channel(const Unit* br, int n_br) {
  int floats = 0;
  for (int k = 0; k < n_br; ++k) floats += br[k].taps * ((br[k].c_out + 3) & ~3);
  return floats;
}

// Copies from global to shared memory without passing through registers
// (cp.async), so that a thread issues all of its copies back to back;
// copies_done() waits for the calling thread's own.
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src));
}
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src));
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stages w[:, c0:c0+cn, :] as ws[taps][cn][co_pad], zero past c_out.  For
// each tap the source rows are contiguous, and so are the staged ones when
// c_out is a multiple of 4: then it is a copy of 16-byte pieces.
__device__ void stage_weights(const Unit& u, const float* __restrict__ w,
                              int c0, int cn, int co_pad, float* ws) {
  const int tid = threadIdx.x;
  if (co_pad == u.c_out && (u.w & 3) == 0) {
    const int n4 = cn * co_pad / 4;  // 16-byte pieces per tap
    for (int e = tid; e < u.taps * n4; e += kThreads) {
      const int k = e / n4;
      copy16_async(ws + 4 * e, w + (k * u.c_in + c0) * u.c_out + 4 * (e - k * n4));
    }
    return;
  }
  for (int k = 0; k < u.taps; ++k) {
    const float* __restrict__ src = w + (k * u.c_in + c0) * u.c_out;
    float* dst = ws + k * cn * co_pad;
    for (int e = tid; e < cn * co_pad; e += kThreads) {
      const int ci = e / co_pad;
      const int co = e - ci * co_pad;
      dst[e] = co < u.c_out ? src[ci * u.c_out + co] : 0.f;
    }
  }
}

// Every unit's slab of one C_in chunk, back to back.  The caller's barrier
// after it makes the stage visible to the block.
__device__ void stage_chunk(const Unit* br, int n_br,
                            const float* __restrict__ params, int c0, int cn,
                            float* ws) {
  for (int k = 0; k < n_br; ++k) {
    const int co_pad = (br[k].c_out + 3) & ~3;
    stage_weights(br[k], params + br[k].w, c0, cn, co_pad, ws);
    ws += br[k].taps * cn * co_pad;
  }
  copies_done();
}

template <int RT>
__device__ __forceinline__ void fma_rows(float (&acc)[RT][4], int r,
                                         float xv, const float4 wv) {
  acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
  acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
  acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
  acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
}

// x: the thread's first window row (tap 0) at channel c0; w: the float4
// of its column group at (tap 0, channel 0) of the staged slab
// [taps][cn][ncg].
template <int RT, int K, int D>
__device__ __forceinline__ void window_chunk(float (&acc)[RT][4],
                                             const float* __restrict__ x,
                                             int stride,
                                             const float4* __restrict__ w,
                                             int cn, int ncg) {
  constexpr int kWin = RT + (K - 1) * D;
#pragma unroll 4  // 4 beat 2 on the card
  for (int ci = 0; ci < cn; ++ci) {
    float xv[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) xv[j] = x[j * stride + ci];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 wv = w[(k * cn + ci) * ncg];
#pragma unroll
      for (int r = 0; r < RT; ++r) fma_rows<RT>(acc, r, xv[r + k * D], wv);
    }
  }
}

// The pool branch: x is the window row before the thread's first; the
// value of row r is the max of rows r - 1, r, r + 1, with -inf for a row
// outside the window (keep[j] false), as pool3_same pads.
template <int RT>
__device__ __forceinline__ void pool3_chunk(float (&acc)[RT][4],
                                            const float* __restrict__ x,
                                            int stride,
                                            const float4* __restrict__ w,
                                            int cn, int ncg,
                                            const bool (&keep)[RT + 2]) {
#pragma unroll 2
  for (int ci = 0; ci < cn; ++ci) {
    float xv[RT + 2];
#pragma unroll
    for (int j = 0; j < RT + 2; ++j) {
      const float v = x[j * stride + ci];
      xv[j] = keep[j] ? v : -INFINITY;
    }
    const float4 wv = w[ci * ncg];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      fma_rows<RT>(acc, r, fmaxf(fmaxf(xv[r], xv[r + 1]), xv[r + 2]), wv);
    }
  }
}

template <int RT>
__device__ __forceinline__ void generic_chunk(float (&acc)[RT][4],
                                              const float* __restrict__ x,
                                              int stride,
                                              const float4* __restrict__ w,
                                              int cn, int ncg, int taps,
                                              int dil) {
  for (int k = 0; k < taps; ++k) {
    const float* xk = x + k * dil * stride;
    const float4* wk = w + k * cn * ncg;
    for (int ci = 0; ci < cn; ++ci) {
      const float4 wv = wk[ci * ncg];
#pragma unroll
      for (int r = 0; r < RT; ++r) fma_rows<RT>(acc, r, xk[r * stride + ci], wv);
    }
  }
}

// One pass over output rows [a, b) of unit `first`'s window (pooled rows
// when the unit pools), or of an inception's four branches at once (n_br =
// 4; the last is the pool branch).  `in` must hold the input rows [start -
// halo, end + halo) of the pre-pool rows [start, end), zero outside the
// window.  Items are (unit, row tile, 4-channel group), unit-major.
template <int RT>
__device__ __noinline__ void conv_pass(int first, int n_br,
                                       const float* __restrict__ params,
                                       const Rows in, int a, int b,
                                       int len_out, const Out out, int w_at,
                                       int w_floats) {
  float* smem = shared_floats();
  const Unit* br = reinterpret_cast<const Unit*>(smem) + first;
  const float* in_p = smem + in.at;
  float* ws = smem + w_at;
  const int tid = threadIdx.x;
  const bool pool = br[0].pool;
  const int c_in = br[0].c_in;
  const int pstart = pool ? 2 * a : a;
  const int npre = pool ? 2 * (b - a) : b - a;
  const int len_pre = pool ? 2 * len_out : len_out;
  const int row_tiles = (npre + RT - 1) / RT;
  int items = 0;
  for (int k = 0; k < n_br; ++k) items += row_tiles * ((br[k].c_out + 3) >> 2);
  const int per_ci = stage_per_channel(br, n_br);
  const int n_chunks = (c_in + w_floats / per_ci - 1) / (w_floats / per_ci);
  const int chunk = (c_in + n_chunks - 1) / n_chunks;  // equal chunks

  __syncthreads();  // earlier readers of ws and writers of `in` are done
  for (int item0 = 0; item0 < items; item0 += kThreads) {
    const int item = item0 + tid;
    const bool active = item < items;
    int k = 0, base = 0;  // the item's unit and that unit's first item
    while (k + 1 < n_br) {
      const int next = base + row_tiles * ((br[k].c_out + 3) >> 2);
      if (item < next) break;
      base = next;
      ++k;
    }
    const Unit& u = br[k];
    const int ncg = (u.c_out + 3) >> 2;
    const int cg = (item - base) % ncg;
    const int r0 = (item - base) / ncg * RT;  // first pre-pool row, from pstart
    const int path = path_of(u, n_br == 4 && k == 3);
    const int slab = stage_per_channel(br, k);  // floats before u's, per channel
    bool keep[RT + 2];
#pragma unroll
    for (int j = 0; j < RT + 2; ++j) {
      keep[j] = static_cast<unsigned>(pstart + r0 - 1 + j) <
                static_cast<unsigned>(len_pre);
    }
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    for (int c0 = 0; c0 < c_in; c0 += chunk) {
      const int cn = imin(chunk, c_in - c0);
      __syncthreads();  // the previous chunk's readers are done
      stage_chunk(br, n_br, params, c0, cn, ws);
      __syncthreads();
      if (!active) continue;
      const float* x =
          in_p + (pstart - halo_of(u) - in.lo + r0) * in.stride + c0;
      const float4* w = reinterpret_cast<const float4*>(ws + slab * cn) + cg;
      switch (path) {
        case kTap1:
          window_chunk<RT, 1, 1>(acc, x, in.stride, w, cn, ncg);
          break;
        case kTap3:
          window_chunk<RT, 3, 1>(acc, x, in.stride, w, cn, ncg);
          break;
        case kTap3Dil2:
          window_chunk<RT, 3, 2>(acc, x, in.stride, w, cn, ncg);
          break;
        case kTap3Dil4:
          window_chunk<RT, 3, 4>(acc, x, in.stride, w, cn, ncg);
          break;
        case kPool3:
          pool3_chunk<RT>(acc, x - in.stride, in.stride, w, cn, ncg, keep);
          break;
        default:
          generic_chunk<RT>(acc, x, in.stride, w, cn, ncg, u.taps, u.dil);
      }
    }
    if (!active) continue;

    // Epilogue: folded BN affine, ReLU, optional pair max, masked store.
    const float* __restrict__ scale = params + u.sb;
    const float* __restrict__ bias = scale + u.c_out;
    int ch = out.ch_off;
    for (int j = 0; j < k; ++j) ch += br[j].c_out;
    const int co = cg * 4;
    const int left = imin(4, u.c_out - co);
    float s[4], t[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c] = c < left ? scale[co + c] : 0.f;
      t[c] = c < left ? bias[co + c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaxf(fmaf(acc[r][c], s[c], t[c]), 0.f);
      }
    }
    const int step = pool ? 2 : 1;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r % 2 == 1 && pool) continue;
      if (r0 + r >= npre) continue;
      // pstart + r0 + r is even when pooling (RT is even), so the division
      // is exact.
      const int j = (pstart + r0 + r) / step;
      const bool inside = j >= 0 && j < len_out;
      if (!inside && !out.zero_outside) continue;
      float* o = out.p + (j - out.lo) * out.stride + ch + co;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < left) {
          float v = acc[r][c];
          if (pool && r + 1 < RT) v = fmaxf(v, acc[r + 1][c]);
          o[c] = inside ? v : 0.f;
        }
      }
    }
  }
}

// Runs the pass with the row tile its units were planned for (make_plan
// admits only built ones).
__device__ void conv(int first, int n_br, const float* __restrict__ params,
                     const Act in, int a, int b, int len_out, const Out out,
                     int w_at, int w_floats) {
  float* smem = shared_floats();
  const Rows rows{static_cast<int>(in.p - smem), in.lo, in.stride};
  switch (reinterpret_cast<const Unit*>(smem)[first].rt) {
#define DEEPBINNER_TRUNK_CASE(RT)                                           \
  case RT:                                                                  \
    conv_pass<RT>(first, n_br, params, rows, a, b, len_out, out, w_at,      \
                  w_floats);                                                \
    break;
    DEEPBINNER_TRUNK_ROW_TILES(DEEPBINNER_TRUNK_CASE)
#undef DEEPBINNER_TRUNK_CASE
    default:
      break;
  }
}

// Window rows [dst.lo, dst.lo + rows) of x (length, c) into dst; rows
// outside [0, length) are 0.  A barrier after it makes them visible to the
// block.
__device__ void load_rows(const float* __restrict__ x, int length, int c,
                          const Act dst, int rows) {
  for (int i = threadIdx.x; i < rows * c; i += kThreads) {
    const int r = i / c;
    const int ch = i - r * c;
    const int l = dst.lo + r;
    float* to = dst.p + r * dst.stride + ch;
    if (l >= 0 && l < length) {
      copy4_async(to, x + static_cast<long long>(l) * c + ch);
    } else {
      *to = 0.f;
    }
  }
  copies_done();
}

// Zeroes window rows [from, to) of dst, channels [0, c).
__device__ void zero_rows(const Act dst, int from, int to, int c) {
  const int rows = to - from;
  for (int i = threadIdx.x; i < rows * c; i += kThreads) {
    const int r = i / c;
    dst.p[(from - dst.lo + r) * dst.stride + i - r * c] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
trunk_kernel(const float* __restrict__ x, const float* __restrict__ params,
             float* __restrict__ out, const Plan plan) {
  float* smem = shared_floats();
  // The unit table lives at the front of shared memory, where every pass
  // reads it.
  Unit* units = reinterpret_cast<Unit*>(smem);
  for (int i = threadIdx.x; i < plan.n_units * kUnitInts; i += kThreads) {
    reinterpret_cast<int*>(units)[i] =
        reinterpret_cast<const int*>(plan.u)[i];
  }
  __syncthreads();
  const int w_at = plan.w_at;
  const int stage = plan.w_floats;
  const long long n = blockIdx.x;
  const float* xn = x + n * plan.length * plan.c_in0;
  const bool late = plan.n_inc > 0 || plan.head;
  const int pad0 = late ? consumer_pad(plan, plan.n_early) : 0;
  float* bufs[2] = {smem + plan.p0_at, smem + plan.p1_at};

  int len = plan.length;
  int ch = plan.c_in0;
  Act cur;
  if (plan.n_early > 0) {
    const int last = plan.n_early - 1;
    const int len_e = plan.early_len;
    const int c_e = plan.u[last].c_out;
    cur = Act{bufs[0], -pad0, row_stride(c_e)};
    if (late) {
      zero_rows(cur, -pad0, 0, c_e);
      zero_rows(cur, len_e, len_e + pad0, c_e);
    }
    for (int t0 = 0; t0 < len_e; t0 += kTile) {
      // Output rows each early unit must give this tile, from the last back.
      int lo[kMaxUnits], hi[kMaxUnits];
      int a = t0, b = t0 + kTile;
      for (int i = last; i >= 0; --i) {
        lo[i] = a;
        hi[i] = b;
        const int h = halo_of(plan.u[i]);
        if (plan.u[i].pool) {
          a = 2 * a - h;
          b = 2 * b + h;
        } else {
          a -= h;
          b += h;
        }
      }
      __syncthreads();  // the previous tile is done with both buffers
      Act in{smem + plan.p1_at, a, row_stride(plan.c_in0)};
      load_rows(xn, plan.length, plan.c_in0, in, b - a);
      int level = plan.length;
      for (int i = 0; i <= last; ++i) {
        const Unit& u = plan.u[i];
        const int len_out = u.pool ? level / 2 : level;
        if (i < last) {
          const Act o{smem + (i % 2 == 0 ? plan.b_at : plan.p1_at), lo[i],
                      row_stride(u.c_out)};
          conv(i, 1, params, in, lo[i], hi[i], len_out,
               Out{o.p, o.lo, o.stride, 0, true}, w_at, stage);
          in = o;
        } else if (late) {
          conv(i, 1, params, in, lo[i], hi[i], len_out,
               Out{cur.p, cur.lo, cur.stride, 0, false}, w_at, stage);
        } else {
          conv(i, 1, params, in, lo[i], hi[i], len_out,
               Out{out + n * len_e * u.c_out, 0, u.c_out, 0, false}, w_at,
               stage);
        }
        level = len_out;
      }
    }
    len = len_e;
    ch = c_e;
  } else {
    cur = Act{bufs[0], -pad0, row_stride(ch)};
    load_rows(xn, len, ch, cur, len + 2 * pad0);
  }
  if (!late) return;

  int which = 0;  // cur lives in bufs[which]
  for (int j = 0; j < plan.n_inc; ++j) {
    const int first = plan.n_early + 4 * j;
    const Unit* br = plan.u + first;
    const int f = br[0].c_out + br[1].c_out + br[2].c_out + br[3].c_out;
    const int len_out = len / 2;
    Act o;
    __syncthreads();  // earlier readers of bufs[1 - which] are done
    if (j == plan.n_inc - 1 && !plan.head) {
      o = Act{out + n * len_out * f, 0, f};
    } else {
      const int pad = consumer_pad(plan, plan.n_early + 4 * (j + 1));
      o = Act{bufs[1 - which], -pad, row_stride(f)};
      zero_rows(o, -pad, 0, f);
      zero_rows(o, len_out, len_out + pad, f);
    }
    conv(first, 4, params, cur, 0, len_out, len_out,
         Out{o.p, o.lo, o.stride, 0, true}, w_at, stage);
    cur = o;
    len = len_out;
    ch = f;
    which = 1 - which;
  }
  if (plan.head) {
    const int i = plan.n_early + 4 * plan.n_inc;
    const int c_out = plan.u[i].c_out;
    const Act o{bufs[1 - which], 0, row_stride(c_out)};
    conv(i, 1, params, cur, 0, len, len, Out{o.p, 0, o.stride, 0, true},
         w_at, stage);
    __syncthreads();
    for (int c = threadIdx.x; c < c_out; c += kThreads) {
      float sum = 0.f;
      for (int l = 0; l < len; ++l) sum += o.p[l * o.stride + c];
      out[n * c_out + c] = sum / static_cast<float>(len);
    }
  }
}

inline int round4(int v) { return (v + 3) & ~3; }

bool row_tile_built(int rt) {
  switch (rt) {
#define DEEPBINNER_TRUNK_BUILT(RT) case RT:
    DEEPBINNER_TRUNK_ROW_TILES(DEEPBINNER_TRUNK_BUILT)
#undef DEEPBINNER_TRUNK_BUILT
    return true;
    default:
      return false;
  }
}

// Fills `plan` and its shared-memory layout; returns the bytes it needs, or
// -1 when the description is not one this kernel takes (a row tile it was
// not built for, an odd one on a pooling unit, inception branches that do
// not share theirs).
long long make_plan(Plan* plan, int length, int c_in0, int n_early, int n_inc,
                    int head, const int* units, int n_units) {
  if (n_units != n_early + 4 * n_inc + head || n_units <= 0 ||
      n_units > kMaxUnits || length <= 0) {
    return -1;
  }
  plan->n_units = n_units;
  plan->n_early = n_early;
  plan->n_inc = n_inc;
  plan->head = head;
  plan->length = length;
  plan->c_in0 = c_in0;
  for (int i = 0; i < n_units; ++i) {
    const int* v = units + kUnitInts * i;
    plan->u[i] = Unit{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
    const Unit& u = plan->u[i];
    if (u.taps % 2 == 0 || !row_tile_built(u.rt) || (u.pool && u.rt % 2)) {
      return -1;
    }
  }
  // A pass: one early unit or head_conv, or an inception's four branches,
  // which share the input, the row tile and the pool; the last has one tap.
  // A stage holds a whole pass where one fits, so small networks take less
  // shared memory.
  plan->w_floats = 0;
  for (int i = 0; i < n_units;) {
    const bool inception = i >= n_early && i < n_early + 4 * n_inc;
    const int n_br = inception ? 4 : 1;
    const Unit* br = plan->u + i;
    if (inception) {
      for (int k = 1; k < 4; ++k) {
        if (br[k].c_in != br[0].c_in || br[k].rt != br[0].rt ||
            br[k].pool != br[0].pool) {
          return -1;
        }
      }
      if (br[3].taps != 1) return -1;
    }
    const int per_ci = stage_per_channel(br, n_br);
    if (per_ci > kWFloats) return -1;
    plan->w_floats = imax(plan->w_floats, per_ci * br[0].c_in);
    i += n_br;
  }
  plan->w_floats = round4(imin(plan->w_floats, kWFloats));
  const bool late = n_inc > 0 || head;
  int a_need = 0, b_need = 0;
  int len = length;
  int ch = c_in0;
  if (n_early > 0) {
    int a = 0, b = kTile;
    for (int i = n_early - 1; i >= 0; --i) {
      const Unit& u = plan->u[i];
      const int h = halo_of(u);
      a = u.pool ? 2 * a - h : a - h;
      b = u.pool ? 2 * b + h : b + h;
      const int need = (b - a + kSlack) * row_stride(u.c_in);
      if (i % 2 == 0) {
        a_need = imax(a_need, need);
      } else {
        b_need = imax(b_need, need);
      }
    }
    for (int i = 0; i < n_early; ++i) {
      if (plan->u[i].pool) len /= 2;
    }
    ch = plan->u[n_early - 1].c_out;
  }
  plan->early_len = len;
  // The late buffers alternate between p0 (the late input) and p1, which
  // the early tiles' two buffers share.
  int need[2] = {0, 0};
  if (late) {
    need[0] = (len + 2 * consumer_pad(*plan, n_early) + kSlack) *
              row_stride(ch);
    int which = 0;
    for (int j = 0; j < n_inc; ++j) {
      const Unit* br = plan->u + n_early + 4 * j;
      const int f = br[0].c_out + br[1].c_out + br[2].c_out + br[3].c_out;
      len /= 2;
      if (j < n_inc - 1 || head) {
        const int pad = consumer_pad(*plan, n_early + 4 * (j + 1));
        need[1 - which] =
            imax(need[1 - which], (len + 2 * pad + kSlack) * row_stride(f));
      }
      which = 1 - which;
    }
    if (head) {
      const Unit& u = plan->u[n_early + 4 * n_inc];
      need[1 - which] =
          imax(need[1 - which], (len + kSlack) * row_stride(u.c_out));
    }
  }
  plan->w_at = round4(kUnitInts * n_units);  // the unit table comes first
  plan->p0_at = plan->w_at + plan->w_floats;
  plan->p1_at = plan->p0_at + round4(need[0]);
  plan->b_at = plan->p1_at + round4(a_need);
  const int p1 = imax(round4(a_need) + b_need, need[1]);
  return static_cast<long long>(sizeof(float)) * (plan->p1_at + round4(p1));
}

}  // namespace

// C interface, bound with ctypes by deepbinner_tpu_torch/ops/trunk_kernel.py.
//
// `units` holds kUnitInts (8) ints per unit in execution order (c_in,
// c_out, taps, dilation, pool, kernel offset, scale offset, row tile;
// offsets in floats into `params`, the bias following the scale): n_early
// early units, then four branches per inception, then head_conv when
// `head`.  The row tiles are the caller's plan (ops/trunk_kernel.plan_segment);
// the kernel picks none itself.  x is (n, length, c_in0) f32; out is
// (n, head_features) with a head, else (n, length', c').  Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue, launching nothing, for a plan it does
// not take (see make_plan) or that needs more than kMaxSmem.
extern "C" long long deepbinner_trunk_smem_bytes(int length, int c_in0,
                                                 int n_early, int n_inc,
                                                 int head, const int* units,
                                                 int n_units) {
  Plan plan;
  return make_plan(&plan, length, c_in0, n_early, n_inc, head, units,
                   n_units);
}

extern "C" int deepbinner_trunk_segment(const void* x, const void* params,
                                        void* out, int n, int length,
                                        int c_in0, int n_early, int n_inc,
                                        int head, const int* units,
                                        int n_units, void* stream) {
  Plan plan;
  const long long smem = make_plan(&plan, length, c_in0, n_early, n_inc,
                                   head, units, n_units);
  if (smem < 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      trunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  trunk_kernel<<<n, kThreads, static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(params),
      static_cast<float*>(out), plan);
  return static_cast<int>(cudaGetLastError());
}
