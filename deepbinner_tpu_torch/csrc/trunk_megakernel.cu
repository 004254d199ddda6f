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
// tensor cores: the reference is f32.  Each thread keeps a register tile
// of RT rows by 4 channels, so one float4 weight load and RT activation
// loads from shared memory feed 4 * RT FMAs, as in conv1d_bn_relu.cu.
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
//   zeroed pad rows above and below.  Each branch writes its channel slice
//   of the next buffer, which makes the concat free.  pool3 runs in place on
//   the inception input once the three other branches have read it.
// - Weights are streamed through shared memory in chunks of C_in, one unit
//   at a time, from one packed buffer that stays hot in the 50 MB L2.
// - Rows are assigned to threads as (row tile, 4-channel group) items; a
//   unit with few rows takes RT = 4 where that needs fewer passes.
// - The early tile (kTile), the block size and the weight stage were chosen
//   by timing a grid of them on the card: larger tiles and stages mean
//   fewer halo rows and fewer stage-and-synchronise rounds per window, and
//   with them the block takes about 206 KB of shared memory for the
//   flagship's "all" segment, so one block runs on each SM.
//
// Determinism: every output is summed in one fixed order (C_in chunk, tap,
// channel) by one thread, and the global average pool is one thread's sum
// over L in order, so results are bit-identical from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxUnits = 40;
constexpr int kTile = 32;        // early-output rows per tile
constexpr int kSlack = 8;        // rows a row tile may read past a buffer
constexpr int kWFloats = 16384;  // weight stage: taps x C_in chunk x C_out
constexpr int kMaxSmem = 232448; // the most a block may opt in to (227 KB)

struct Unit {
  int c_in, c_out, taps, dil, pool;
  int w;   // offset of the (taps, c_in, c_out) kernel in params, in floats
  int sb;  // offset of the scale (c_out floats), then the bias (c_out)
};

struct Plan {
  Unit u[kMaxUnits];
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

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// An odd row stride puts the row tiles that one warp reads in different
// shared-memory banks.
__host__ __device__ inline int row_stride(int c) { return c | 1; }

__host__ __device__ inline int halo_of(const Unit& u) {
  return (u.taps - 1) / 2 * u.dil;
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

// Stages w[:, c0:c0+cn, :] as ws[taps][cn][co_pad], zero past c_out.  For
// each tap the source rows are contiguous, and so are the staged ones when
// c_out is a multiple of 4: then it is a float4 copy with no index math.
__device__ void stage_weights(const Unit& u, const float* __restrict__ w,
                              int c0, int cn, int co_pad, float* ws) {
  const int tid = threadIdx.x;
  for (int k = 0; k < u.taps; ++k) {
    const float* __restrict__ src = w + (k * u.c_in + c0) * u.c_out;
    float* dst = ws + k * cn * co_pad;
    if (co_pad == u.c_out && (u.w & 3) == 0) {
      const int n4 = cn * co_pad / 4;
      for (int e = tid; e < n4; e += kThreads) {
        reinterpret_cast<float4*>(dst)[e] =
            reinterpret_cast<const float4*>(src)[e];
      }
    } else {
      for (int e = tid; e < cn * co_pad; e += kThreads) {
        const int ci = e / co_pad;
        const int co = e - ci * co_pad;
        dst[e] = co < u.c_out ? src[ci * u.c_out + co] : 0.f;
      }
    }
  }
}

// One unit over output rows [a, b) of its window (pooled rows when
// u.pool).  `in` must hold the input rows [start - halo, end + halo) of the
// pre-pool rows [start, end).  Output row j goes to
// dst[(j - dst_lo) * dst_stride + ch_off + co]; a row outside
// [0, len_out) is written as 0 when zero_outside, else skipped.
template <int RT>
__device__ void conv_rows(const Unit& u, const float* __restrict__ params,
                          const Act in, int a, int b, int len_out,
                          float* dst, int dst_lo, int dst_stride, int ch_off,
                          bool zero_outside, float* ws, int w_floats) {
  const int tid = threadIdx.x;
  const int ncg = (u.c_out + 3) >> 2;
  const int co_pad = ncg * 4;
  const int pstart = u.pool ? 2 * a : a;
  const int npre = u.pool ? 2 * (b - a) : b - a;
  const int items = (npre + RT - 1) / RT * ncg;
  const int chunk = imin(u.c_in, w_floats / (u.taps * co_pad));
  const float* __restrict__ w = params + u.w;
  const float* __restrict__ scale = params + u.sb;
  const float* __restrict__ bias = scale + u.c_out;
  const int in_base = pstart - halo_of(u) - in.lo;

  for (int item0 = 0; item0 < items; item0 += kThreads) {
    const int item = item0 + tid;
    const bool active = item < items;
    const int cg = item % ncg;
    const int r0 = item / ncg * RT;  // first pre-pool row, from pstart
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    for (int c0 = 0; c0 < u.c_in; c0 += chunk) {
      const int cn = imin(chunk, u.c_in - c0);
      __syncthreads();  // earlier readers of ws and writers of `in` are done
      stage_weights(u, w, c0, cn, co_pad, ws);
      __syncthreads();
      if (active) {
        for (int k = 0; k < u.taps; ++k) {
          const float* xk = in.p + (in_base + r0 + k * u.dil) * in.stride + c0;
          const float4* wk =
              reinterpret_cast<const float4*>(ws + k * cn * co_pad) + cg;
          for (int ci = 0; ci < cn; ++ci) {
            const float4 wv = wk[ci * ncg];
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const float xv = xk[r * in.stride + ci];
              acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
              acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
              acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
              acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
            }
          }
        }
      }
    }
    if (!active) continue;

    // Epilogue: folded BN affine, ReLU, optional pair max, masked store.
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
    const int step = u.pool ? 2 : 1;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r % 2 == 1 && u.pool) continue;
      if (r0 + r >= npre) continue;
      // pstart + r0 + r is even when pooling, so the division is exact.
      const int j = (pstart + r0 + r) / step;
      const bool inside = j >= 0 && j < len_out;
      if (!inside && !zero_outside) continue;
      float* o = dst + (j - dst_lo) * dst_stride + ch_off + co;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < left) {
          float v = acc[r][c];
          if (u.pool && r + 1 < RT) v = fmaxf(v, acc[r + 1][c]);
          o[c] = inside ? v : 0.f;
        }
      }
    }
  }
}

// Picks the row-tile height that needs fewer row steps for this unit.
__device__ void conv(const Unit& u, const float* __restrict__ params,
                     const Act in, int a, int b, int len_out, float* dst,
                     int dst_lo, int dst_stride, int ch_off, bool zero_outside,
                     float* ws, int w_floats) {
  const int ncg = (u.c_out + 3) >> 2;
  const int npre = u.pool ? 2 * (b - a) : b - a;
  const int passes8 = ((npre + 7) / 8 * ncg + kThreads - 1) / kThreads;
  const int passes4 = ((npre + 3) / 4 * ncg + kThreads - 1) / kThreads;
  if (passes4 * 4 < passes8 * 8) {
    conv_rows<4>(u, params, in, a, b, len_out, dst, dst_lo, dst_stride,
                 ch_off, zero_outside, ws, w_floats);
  } else {
    conv_rows<8>(u, params, in, a, b, len_out, dst, dst_lo, dst_stride,
                 ch_off, zero_outside, ws, w_floats);
  }
}

// Window rows [dst.lo, dst.lo + rows) of x (length, c) into dst; rows
// outside [0, length) are 0.
__device__ void load_rows(const float* __restrict__ x, int length, int c,
                          const Act dst, int rows) {
  for (int i = threadIdx.x; i < rows * c; i += kThreads) {
    const int r = i / c;
    const int ch = i - r * c;
    const int l = dst.lo + r;
    dst.p[r * dst.stride + ch] =
        (l >= 0 && l < length) ? x[static_cast<long long>(l) * c + ch] : 0.f;
  }
}

// Zeroes window rows [from, to) of dst, channels [0, c).
__device__ void zero_rows(const Act dst, int from, int to, int c) {
  const int rows = to - from;
  for (int i = threadIdx.x; i < rows * c; i += kThreads) {
    const int r = i / c;
    dst.p[(from - dst.lo + r) * dst.stride + i - r * c] = 0.f;
  }
}

// SAME window-3 max over L, in place, on window rows [0, len); -inf pad.
__device__ void pool3_in_place(const Act x, int len, int c_count) {
  __syncthreads();  // the other branches have read x
  for (int c = threadIdx.x; c < c_count; c += kThreads) {
    float* col = x.p - x.lo * x.stride + c;
    float prev = -INFINITY;
    float cur = col[0];
    for (int l = 0; l < len; ++l) {
      const float next = l + 1 < len ? col[(l + 1) * x.stride] : -INFINITY;
      col[l * x.stride] = fmaxf(fmaxf(prev, cur), next);
      prev = cur;
      cur = next;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
trunk_kernel(const float* __restrict__ x, const float* __restrict__ params,
             float* __restrict__ out, const Plan plan) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ws = smem + plan.w_at;
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
          conv(u, params, in, lo[i], hi[i], len_out, o.p, o.lo, o.stride, 0,
               true, ws, stage);
          in = o;
        } else if (late) {
          conv(u, params, in, lo[i], hi[i], len_out, cur.p, cur.lo,
               cur.stride, 0, false, ws, stage);
        } else {
          conv(u, params, in, lo[i], hi[i], len_out,
               out + n * len_e * u.c_out, 0, u.c_out, 0, false, ws, stage);
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
    const Unit* br = plan.u + plan.n_early + 4 * j;
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
    int off = 0;
    for (int k = 0; k < 3; ++k) {
      conv(br[k], params, cur, 0, len_out, len_out, o.p, o.lo, o.stride, off,
           true, ws, stage);
      off += br[k].c_out;
    }
    pool3_in_place(cur, len, ch);
    conv(br[3], params, cur, 0, len_out, len_out, o.p, o.lo, o.stride, off,
         true, ws, stage);
    cur = o;
    len = len_out;
    ch = f;
    which = 1 - which;
  }
  if (plan.head) {
    const Unit& u = plan.u[plan.n_early + 4 * plan.n_inc];
    __syncthreads();
    const Act o{bufs[1 - which], 0, row_stride(u.c_out)};
    conv(u, params, cur, 0, len, len, o.p, 0, o.stride, 0, true, ws, stage);
    __syncthreads();
    for (int c = threadIdx.x; c < u.c_out; c += kThreads) {
      float sum = 0.f;
      for (int l = 0; l < len; ++l) sum += o.p[l * o.stride + c];
      out[n * u.c_out + c] = sum / static_cast<float>(len);
    }
  }
}

inline int round4(int v) { return (v + 3) & ~3; }

// Fills `plan` and its shared-memory layout; returns the bytes it needs, or
// -1 when the description is not one this kernel takes.
long long make_plan(Plan* plan, int length, int c_in0, int n_early, int n_inc,
                    int head, const int* units, int n_units) {
  if (n_units != n_early + 4 * n_inc + head || n_units <= 0 ||
      n_units > kMaxUnits || length <= 0) {
    return -1;
  }
  plan->n_early = n_early;
  plan->n_inc = n_inc;
  plan->head = head;
  plan->length = length;
  plan->c_in0 = c_in0;
  for (int i = 0; i < n_units; ++i) {
    const int* v = units + 7 * i;
    plan->u[i] = Unit{v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
    if (v[2] % 2 == 0 || v[2] * round4(v[1]) > kWFloats) return -1;
  }
  // A stage holds a whole unit where one fits, so small networks take
  // less shared memory.
  plan->w_floats = 0;
  for (int i = 0; i < n_units; ++i) {
    const Unit& u = plan->u[i];
    plan->w_floats = imax(plan->w_floats, u.taps * u.c_in * round4(u.c_out));
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
  plan->w_at = 0;
  plan->p0_at = plan->w_floats;
  plan->p1_at = plan->p0_at + round4(need[0]);
  plan->b_at = plan->p1_at + round4(a_need);
  const int p1 = imax(round4(a_need) + b_need, need[1]);
  return static_cast<long long>(sizeof(float)) * (plan->p1_at + round4(p1));
}

}  // namespace

// C interface, bound with ctypes by deepbinner_tpu_torch/ops/trunk_kernel.py.
//
// `units` holds 7 ints per unit in execution order (c_in, c_out, taps,
// dilation, pool, kernel offset, scale offset; offsets in floats into
// `params`, the bias following the scale): n_early early units, then four
// branches per inception, then head_conv when `head`.  x is (n, length,
// c_in0) f32; out is (n, head_features) with a head, else (n, length', c').
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a plan it does not take.
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
