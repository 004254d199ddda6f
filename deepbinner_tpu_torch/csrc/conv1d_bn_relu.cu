// Fused Conv1D + folded BatchNorm + ReLU (+ stride-2 maxpool), f32, for sm_90a.
//
// Replaces deepbinner_tpu/ops/conv_pallas.py::fused_conv1d_bn_relu (the
// Pallas unit kernel, _conv_kernel -> _conv_tile).  It computes the same
// function: a SAME-padded, dilated 1-D conv written as
//   out[n, l, co] = sum_k sum_ci x[n, l + k*d - halo, ci] * w[k, ci, co]
// with halo = (K-1)/2 * d and zeros outside [0, L), then acc*scale + bias,
// an optional ReLU and an optional max over the row pairs (2j, 2j+1).
//
// What bounds it on an H100: at the wide layers (C_in, C_out >= 48) the
// 2*N*L*K*C_in*C_out FP32 operations against the card's 67 TFLOP/s FP32
// peak; at stem1 (C_in = 1) the bytes, 4*(N*L*C_in + N*L'*C_out), against
// 3.35 TB/s.  The design answers the first: each thread keeps a 16-row
// ("pipelined") or 8-row ("generic") by 4-channel accumulator tile in
// registers and feeds it from shared memory, and on the flagship units no
// thread waits on a global load between its FMAs.
// No TF32 and no tensor cores: the reference is f32 (conv_pallas.py "f32
// everywhere").
//
// Layout and tiling.  x is (N, L, C_in) row-major, seen as N*L rows of
// C_in channels.  A row tile is RowTile consecutive rows of that flattened
// view (they may span several windows when L < RowTile); a column tile is
// CoTile output channels.  CoTile is 32, 48 or 64, picked by the caller's
// planner (ops/conv_kernel.plan_unit) so that it divides C_out at every
// unit of the flagship model: no block computes a column it throws away.
// A thread owns 4 consecutive channels and groups of 8 consecutive rows.
//
// Two loops, one kernel each:
// - "pipelined" (conv1d_bn_relu_kernel_pipelined; (K, d) in {(1,1), (3,1),
//   (3,2), (3,4)}, L % 8 == 0): a persistent grid, about as many blocks as
//   the SMs hold at the plan's occupancy.  A block copies its CoTile
//   columns of w[:, :, :] into shared memory once and keeps them for every
//   row tile it computes (row tiles blockIdx.x, + gridDim.x, ...).  The
//   rows [p0 - halo, p0 + RowTile + halo) of each tile are staged
//   kStageChannels input channels at a time into a ring of kStages buffers
//   by cp.async (16-byte copies where C_in is a multiple of 4, zero-filled
//   outside [0, rows_total)), kStages - 1 stages ahead of the one the
//   threads compute on: one barrier per stage, and the copies of the next
//   stages are in flight while the FMAs run.  A thread owns kPipeRows = 16
//   rows, two groups of 8; per input channel it loads the 16 + (K-1)*d
//   staged values its rows need once into registers and runs all K taps on
//   them, with one float4 weight load per tap for both groups.  Since
//   L % 8 == 0 a group's 8 rows lie in one window, so whether a loaded
//   value lies inside that window depends on the value alone: it is masked
//   once per group.  A staged row holds kStageChannels floats (16-byte
//   aligned for cp.async) and every 8 rows are followed by 4 floats of
//   padding, so the row groups a warp reads (16 rows apart) fall on other
//   banks.
// - "generic" (conv1d_bn_relu_kernel; any odd K, any d, any L): a block per
//   row tile and column tile, 8 rows a thread, which stages rows
//   [p0 - halo, p0 + RowTile + halo) of one 32-channel C_in chunk and the
//   matching weights with plain loads between two barriers (16-byte global
//   loads where C_in, or C_out for the weights, is a multiple of 4); tap
//   outside channel, each of the 8*K reads masked by its own row's window.
//
// Determinism: every output is summed in one fixed order by one thread
// (channel ascending, then tap, for "pipelined"; chunk, tap, channel for
// "generic"), with fmaf, no atomics and no split over C_in, so results are
// bit-identical from run to run.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kCiChunk = 32;  // "generic": input channels staged per pass
constexpr int kRows = 8;      // rows per thread (four pool pairs)
constexpr int kCols = 4;      // channels per thread (one float4)
// "generic": odd row stride, so the row groups of a warp (8 rows apart)
// fall on different banks; a stride that is a multiple of 4 would put them
// on one.
constexpr int kXStride = kCiChunk + 1;
// "pipelined": input channels per stage, stages in the ring, the padding
// after every kRows staged rows (a multiple of 4 floats, so rows stay
// 16-byte aligned) and rows per thread (a multiple of kRows).  16 rows a
// thread halve the weight loads per FMA against 8; 16-channel stages keep
// two blocks on an SM where the weights are large (an H100 sweep of 8 and
// 16 rows, 16 and 32 channels, 2 to 4 stages).
constexpr int kStageChannels = 16;
constexpr int kStages = 2;
constexpr int kGroupPad = 4;
constexpr int kPipeRows = 16;

// What the C entry point returns for a plan it was not built for (CUDA's
// own error codes are positive).
constexpr int kErrNoInstance = -1;    // no template instance for the plan
constexpr int kErrPlanMismatch = -2;  // threads, smem, stages or path do not fit

// __launch_bounds__' blocks per SM.  "generic": 4 caps a 256-thread block
// at 64 registers (a few spilled bytes) and a 192-thread one at 85: more
// warps per SM paid more than the registers cost (a sweep of 1 to 4 on an
// H100).  "pipelined": the most
// blocks per SM a plan may ask for; 2 caps a 256-thread block at 128
// registers (3, at 85, spilled hundreds of bytes).
constexpr int kMinBlocks = 4;
constexpr int kPipelinedBlocks = 2;
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may take
constexpr int kMaxDevices = 64;   // devices whose SM count is cached

// The (CoTile, RowTile) instances built for each loop;
// ops/conv_kernel.ROW_TILES and PIPELINED_ROW_TILES mirror them.
#define DEEPBINNER_CONV_TILES(X) X(32, 256) X(48, 128) X(64, 128)
#define DEEPBINNER_PIPELINED_TILES(X) X(32, 512) X(48, 256) X(64, 256)

__host__ __device__ constexpr int threads_of(int co_tile, int row_tile) {
  return row_tile / kRows * (co_tile / kCols);
}

__host__ __device__ constexpr int pipelined_threads_of(int co_tile,
                                                       int row_tile) {
  return row_tile / kPipeRows * (co_tile / kCols);
}

size_t smem_of(int co_tile, int row_tile, int taps, int dilation) {
  const int halo = (taps - 1) / 2 * dilation;
  return sizeof(float) *
         (static_cast<size_t>(taps) * kCiChunk * co_tile +
          static_cast<size_t>(row_tile + 2 * halo) * kXStride);
}

// Floats of one "pipelined" stage of `rows` staged rows.
__host__ __device__ constexpr int stage_floats(int rows) {
  return rows * kStageChannels + (rows + kRows - 1) / kRows * kGroupPad;
}

// Offset of staged row `row` in a "pipelined" stage.
__device__ __forceinline__ int stage_row(int row) {
  return row * kStageChannels + row / kRows * kGroupPad;
}

size_t pipelined_smem_of(int co_tile, int row_tile, int taps, int dilation,
                         int c_in) {
  const int halo = (taps - 1) / 2 * dilation;
  return sizeof(float) *
         (static_cast<size_t>(taps) * c_in * co_tile +
          static_cast<size_t>(kStages) * stage_floats(row_tile + 2 * halo));
}

struct Args {
  const float* x;
  const float* w;
  const float* scale;
  const float* bias;
  float* out;
  long long rows_total;
  int length, c_in, c_out, taps, dilation, relu, pool;
};

// Stores this thread's kCols channels of one row; `left` = c_out - co > 0.
// A full float4 when all four exist (co is a multiple of 4, so the address
// is 16-byte aligned whenever c_out is a multiple of 4).
__device__ __forceinline__ void store(float* dst, const float (&v)[kCols],
                                      int left) {
  if (left >= kCols && (reinterpret_cast<size_t>(dst) & 15) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < left) dst[c] = v[c];
    }
  }
}

// The epilogue of a thread's 8 rows from flattened row p (p even): folded
// BN affine, ReLU, optional pair max, masked store.
__device__ __forceinline__ void finish(const Args& a, float (&acc)[kRows][kCols],
                                       const float (&s)[kCols],
                                       const float (&b)[kCols], long long p,
                                       int co) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = fmaf(acc[r][c], s[c], b[c]);
      acc[r][c] = a.relu ? fmaxf(v, 0.f) : v;
    }
  }
  if (a.pool) {
    // Rows (2j, 2j+1) of one window are one pool pair: p is even and L is
    // even (the wrapper checks), so a pair never straddles two windows,
    // and its pooled row is p/2 in the flattened output.
#pragma unroll
    for (int r = 0; r < kRows; r += 2) {
      if (p + r < a.rows_total) {
        float v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[c] = fmaxf(acc[r][c], acc[r + 1][c]);
        store(a.out + ((p + r) / 2) * a.c_out + co, v, a.c_out - co);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (p + r < a.rows_total) {
        store(a.out + (p + r) * a.c_out + co, acc[r], a.c_out - co);
      }
    }
  }
}

// Stages channels [c0, c0 + cn) of the block's rows into xs[row][kXStride]
// (zeros outside [0, rows_total)) and of its weights into
// ws[tap][kCiChunk][CoTile] (zeros past c_out).  Only what the inner loops
// read is written: channels past cn are never read.
template <int CoTile, int RowTile>
__device__ __forceinline__ void stage(const Args& a, float* xs, float* ws,
                                      long long p0, int co0, int c0, int cn,
                                      int halo, bool x_vec, bool w_vec) {
  constexpr int kThreads = threads_of(CoTile, RowTile);
  constexpr int kQuads = CoTile / kCols;
  const int tid = threadIdx.x;
  const int x_rows = RowTile + 2 * halo;
  if (x_vec) {  // c_in % 4 == 0, so cn is too; one float4 per thread and step
    constexpr int kChunkQuads = kCiChunk / 4;
    const int quads = cn / 4;
    for (int i = tid; i < x_rows * kChunkQuads; i += kThreads) {
      const int row = i / kChunkQuads;
      const int q = i - row * kChunkQuads;
      if (q >= quads) continue;
      const long long p = p0 - halo + row;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p >= 0 && p < a.rows_total) {
        v = *reinterpret_cast<const float4*>(a.x + p * a.c_in + c0 + 4 * q);
      }
      float* dst = xs + row * kXStride + 4 * q;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int i = tid; i < x_rows * cn; i += kThreads) {
      const int row = i / cn;
      const int c = i - row * cn;
      const long long p = p0 - halo + row;
      float v = 0.f;
      if (p >= 0 && p < a.rows_total) v = a.x[p * a.c_in + c0 + c];
      xs[row * kXStride + c] = v;
    }
  }
  // Weights: thread tid copies column quad tid % kQuads of every
  // (RowTile/8)-th channel row; kThreads is a multiple of kQuads.
  const int q = tid % kQuads;
  const int co = co0 + q * kCols;
  float4* ws4 = reinterpret_cast<float4*>(ws);
  for (int k = 0; k < a.taps; ++k) {
    for (int ci = tid / kQuads; ci < cn; ci += kThreads / kQuads) {
      const float* src =
          a.w + (static_cast<long long>(k) * a.c_in + c0 + ci) * a.c_out + co;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w_vec) {  // c_out % 4 == 0: the quad is all in or all out
        if (co < a.c_out) v = *reinterpret_cast<const float4*>(src);
      } else {
        if (co < a.c_out) v.x = src[0];
        if (co + 1 < a.c_out) v.y = src[1];
        if (co + 2 < a.c_out) v.z = src[2];
        if (co + 3 < a.c_out) v.w = src[3];
      }
      ws4[(k * kCiChunk + ci) * kQuads + q] = v;
    }
  }
}

// The "generic" loop: a block per (row tile, column tile).
template <int CoTile, int RowTile>
__global__ void __launch_bounds__(threads_of(CoTile, RowTile), kMinBlocks)
conv1d_bn_relu_kernel(const Args a, bool x_vec, bool w_vec) {
  constexpr int kQuads = CoTile / kCols;  // column groups of the block
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [taps][kCiChunk][CoTile]
  float* xs = ws + a.taps * kCiChunk * CoTile;  // [RowTile + 2 halo][kXStride]
  const float4* ws4 = smem4;

  const int tid = threadIdx.x;
  const int cg = tid % kQuads;
  const int rg = tid / kQuads;
  const long long p0 = static_cast<long long>(blockIdx.x) * RowTile;
  const int co0 = blockIdx.y * CoTile;
  const int row0 = rg * kRows;  // first of this thread's rows in the tile

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int halo = (a.taps - 1) / 2 * a.dilation;
  int lpos[kRows];  // each row's position inside its own window
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    lpos[r] = static_cast<int>((p0 + row0 + r) % a.length);
  }
  for (int c0 = 0; c0 < a.c_in; c0 += kCiChunk) {
    const int cn = min(kCiChunk, a.c_in - c0);
    __syncthreads();  // the previous chunk's reads are done
    stage<CoTile, RowTile>(a, xs, ws, p0, co0, c0, cn, halo, x_vec, w_vec);
    __syncthreads();
    for (int k = 0; k < a.taps; ++k) {
      const int off = k * a.dilation - halo;
      bool inside[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        inside[r] = static_cast<unsigned>(lpos[r] + off) <
                    static_cast<unsigned>(a.length);
      }
      const float* xk = xs + (row0 + k * a.dilation) * kXStride;
      const float4* wk = ws4 + k * kCiChunk * kQuads + cg;
      for (int ci = 0; ci < cn; ++ci) {
        const float4 wv = wk[ci * kQuads];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = inside[r] ? xk[r * kXStride + ci] : 0.f;
          acc[r][0] = fmaf(xv, wv.x, acc[r][0]);
          acc[r][1] = fmaf(xv, wv.y, acc[r][1]);
          acc[r][2] = fmaf(xv, wv.z, acc[r][2]);
          acc[r][3] = fmaf(xv, wv.w, acc[r][3]);
        }
      }
    }
  }

  const int co = co0 + cg * kCols;
  if (co >= a.c_out) return;
  float s[kCols], b[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const bool ok = co + c < a.c_out;
    s[c] = ok ? a.scale[co + c] : 0.f;
    b[c] = ok ? a.bias[co + c] : 0.f;
  }
  finish(a, acc, s, b, p0 + row0, co);
}

// Copies from global to shared memory without passing through registers.
// With `valid` false nothing is read and the destination is zero-filled
// (cp.async's src-size 0); `src` must still be a mapped address.
__device__ __forceinline__ void copy16_async(float* dst, const float* src,
                                             bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void copy4_async(float* dst, const float* src,
                                            bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most `Pending` of the calling thread's committed groups
// are still in flight.
template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Copies the block's column tile of every weight, w[k, ci, co0:co0+CoTile],
// into ws4[(ci * Taps + k) * kQuads + q] (zeros past c_out).
template <int kThreads, int CoTile, int Taps>
__device__ __forceinline__ void stage_weights(const Args& a, float4* ws4,
                                              int co0, bool w_vec) {
  constexpr int kQuads = CoTile / kCols;
  const int quads = a.c_in * Taps * kQuads;
  for (int i = threadIdx.x; i < quads; i += kThreads) {
    const int q = i % kQuads;
    const int ck = i / kQuads;  // ci * Taps + k
    const int ci = ck / Taps;
    const int k = ck - ci * Taps;
    const int co = co0 + q * kCols;
    const float* src =
        a.w + (static_cast<long long>(k) * a.c_in + ci) * a.c_out + co;
    float* dst = reinterpret_cast<float*>(ws4 + i);
    if (w_vec) {  // c_out % 4 == 0: the quad is all in or all out
      const bool in = co < a.c_out;
      copy16_async(dst, in ? src : a.w, in);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const bool in = co + c < a.c_out;
        copy4_async(dst + c, in ? src + c : a.w, in);
      }
    }
  }
}

// Copies channels [c0, c0 + cn) of rows [p0 - Halo, p0 + RowTile + Halo)
// into one stage (zeros outside [0, rows_total)).  Channels past cn are
// never read.
template <int kThreads, int RowTile, int Halo>
__device__ __forceinline__ void stage_rows(const Args& a, float* xb,
                                           long long p0, int c0, int cn,
                                           bool x_vec) {
  constexpr int kXRows = RowTile + 2 * Halo;
  if (x_vec) {  // c_in % 4 == 0, so cn is too
    constexpr int kStageQuads = kStageChannels / 4;
    const int quads = cn / 4;
    for (int i = threadIdx.x; i < kXRows * kStageQuads; i += kThreads) {
      const int row = i / kStageQuads;
      const int q = i - row * kStageQuads;
      if (q >= quads) continue;
      const long long p = p0 - Halo + row;
      const bool in = p >= 0 && p < a.rows_total;
      copy16_async(xb + stage_row(row) + 4 * q,
                   in ? a.x + p * a.c_in + c0 + 4 * q : a.x, in);
    }
  } else {
    for (int i = threadIdx.x; i < kXRows * cn; i += kThreads) {
      const int row = i / cn;
      const int c = i - row * cn;
      const long long p = p0 - Halo + row;
      const bool in = p >= 0 && p < a.rows_total;
      copy4_async(xb + stage_row(row) + c, in ? a.x + p * a.c_in + c0 + c : a.x,
                  in);
    }
  }
}

// The "pipelined" loop: a persistent block per column tile walks row tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...; its work is a sequence of stages
// (row tile, C_in chunk), chunks ascending inside a tile.  A thread owns
// kPipeRows rows, kGroups groups of 8 that each lie in one window.
template <int CoTile, int RowTile, int Taps, int Dil>
__global__ void __launch_bounds__(pipelined_threads_of(CoTile, RowTile),
                                  kPipelinedBlocks)
conv1d_bn_relu_kernel_pipelined(const Args a, bool x_vec, bool w_vec) {
  constexpr int kThreads = pipelined_threads_of(CoTile, RowTile);
  constexpr int kQuads = CoTile / kCols;  // column groups of the block
  constexpr int kGroups = kPipeRows / kRows;
  constexpr int kHalo = (Taps - 1) / 2 * Dil;
  constexpr int kWin = kRows + 2 * kHalo;       // staged values a group reads
  constexpr int kLoad = kPipeRows + 2 * kHalo;  // ... and a thread
  constexpr int kStage = stage_floats(RowTile + 2 * kHalo);
  extern __shared__ float4 smem4[];
  float4* ws4 = smem4;  // [c_in][Taps][kQuads]
  float* xs = reinterpret_cast<float*>(smem4 + a.c_in * Taps * kQuads);

  const int tid = threadIdx.x;
  const int cg = tid % kQuads;
  const int rg = tid / kQuads;
  const int row0 = rg * kPipeRows;  // first of this thread's rows in a tile
  const int co0 = blockIdx.y * CoTile;
  const int co = co0 + cg * kCols;
  const long long tiles = (a.rows_total + RowTile - 1) / RowTile;
  const int chunks = (a.c_in + kStageChannels - 1) / kStageChannels;
  // The grid has at most `tiles` columns of blocks, so each block has one.
  const int items = static_cast<int>(
      (tiles - 1 - blockIdx.x) / gridDim.x + 1) * chunks;

  // The stage to copy next: item `next`, chunk `next_c` of tile `next_t`.
  int next = 0, next_c = 0;
  long long next_t = blockIdx.x;
  auto issue = [&]() {
    if (next < items) {
      const int c0 = next_c * kStageChannels;
      stage_rows<kThreads, RowTile, kHalo>(
          a, xs + (next % kStages) * kStage, next_t * RowTile, c0,
          min(kStageChannels, a.c_in - c0), x_vec);
      if (++next_c == chunks) {
        next_c = 0;
        next_t += gridDim.x;
      }
    }
    ++next;
    commit_copies();  // an empty group past the last item keeps the count
  };

  stage_weights<kThreads, CoTile, Taps>(a, ws4, co0, w_vec);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue();

  float s[kCols], b[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const bool ok = co + c < a.c_out;
    s[c] = ok ? a.scale[co + c] : 0.f;
    b[c] = ok ? a.bias[co + c] : 0.f;
  }
  float acc[kGroups][kRows][kCols];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[g][r][c] = 0.f;
    }
  }

  // Value j in [0, kLoad) of this thread's staged rows lies at
  // stage_row(row0 + j) = row0 * kStageChannels + rg * kGroups * kGroupPad +
  // j * kStageChannels + j / kRows * kGroupPad: all but the first two terms
  // are known at compile time.
  const int xoff = row0 * kStageChannels + rg * kGroups * kGroupPad;
  long long t = blockIdx.x;
  int c = 0;
  bool keep[kGroups][kWin];  // whether value j of group g is in its window
  for (int it = 0; it < items; ++it) {
    if (c == 0) {
      // Window position of the thread's first row; a group's 8 rows share
      // their window.
      const int lpos0 = static_cast<int>((t * RowTile + row0) % a.length);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int lpos = (lpos0 + g * kRows) % a.length;
#pragma unroll
        for (int j = 0; j < kWin; ++j) {
          keep[g][j] = (j >= kHalo && j < kHalo + kRows) ||
                       static_cast<unsigned>(lpos - kHalo + j) <
                           static_cast<unsigned>(a.length);
        }
      }
    }
    wait_copies<kStages - 2>();  // this thread's copies of stage `it`
    __syncthreads();  // everyone's; and stage it - 1's reads are done
    issue();          // stage it + kStages - 1, into stage it - 1's buffer
    const float* xt = xs + (it % kStages) * kStage + xoff;
    const float4* wt = ws4 + c * kStageChannels * Taps * kQuads + cg;
    const int cn = min(kStageChannels, a.c_in - c * kStageChannels);
#pragma unroll 1  // faster than 2 or 4 (an H100 sweep)
    for (int ci = 0; ci < cn; ++ci) {
      float v[kLoad];
#pragma unroll
      for (int j = 0; j < kLoad; ++j) {
        v[j] = xt[j * kStageChannels + j / kRows * kGroupPad + ci];
      }
      float xv[kGroups][kWin];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int j = 0; j < kWin; ++j) {
          xv[g][j] = keep[g][j] ? v[g * kRows + j] : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < Taps; ++k) {
        const float4 wv = wt[(ci * Taps + k) * kQuads];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float xr = xv[g][r + k * Dil];
            acc[g][r][0] = fmaf(xr, wv.x, acc[g][r][0]);
            acc[g][r][1] = fmaf(xr, wv.y, acc[g][r][1]);
            acc[g][r][2] = fmaf(xr, wv.z, acc[g][r][2]);
            acc[g][r][3] = fmaf(xr, wv.w, acc[g][r][3]);
          }
        }
      }
    }
    if (++c == chunks) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (co < a.c_out) {
          finish(a, acc[g], s, b, t * RowTile + row0 + g * kRows, co);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) acc[g][r][cc] = 0.f;
        }
      }
      c = 0;
      t += gridDim.x;
    }
  }
  wait_copies<0>();  // no copy outlives the block
}

// Raises `kernel`'s dynamic shared memory limit to kSmemMax on the calling
// thread's current device, and with `max_shared` asks for the largest
// shared-memory carveout: once per kernel instance and device, not on
// every launch.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, bool max_shared,
                    std::atomic<bool> (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess && max_shared) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && device < kMaxDevices) {
    done[device].store(true, std::memory_order_release);
  }
  return err;
}

// The calling thread's current device's SM count, read once per device.
int sm_count(int* sms) {
  static std::atomic<int> cached[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kMaxDevices) {
    *sms = cached[device].load(std::memory_order_relaxed);
    if (*sms > 0) return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kMaxDevices) cached[device].store(*sms, std::memory_order_relaxed);
  return 0;
}

// 16-byte global loads and copies need 16-byte aligned rows and base
// pointers.
bool x_vec_of(const Args& a) {
  return a.c_in % 4 == 0 && (reinterpret_cast<size_t>(a.x) & 15) == 0;
}
bool w_vec_of(const Args& a) {
  return a.c_out % 4 == 0 && (reinterpret_cast<size_t>(a.w) & 15) == 0;
}

template <int CoTile, int RowTile>
int launch_generic(const Args& a, size_t smem, cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  if (smem > 48 * 1024) {
    const cudaError_t err =
        prepare(conv1d_bn_relu_kernel<CoTile, RowTile>, false, ready);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((a.rows_total + RowTile - 1) / RowTile),
                  static_cast<unsigned>((a.c_out + CoTile - 1) / CoTile));
  conv1d_bn_relu_kernel<CoTile, RowTile>
      <<<grid, threads_of(CoTile, RowTile), smem, stream>>>(a, x_vec_of(a),
                                                             w_vec_of(a));
  return static_cast<int>(cudaGetLastError());
}

template <int CoTile, int RowTile, int Taps, int Dil>
int launch_pipelined(const Args& a, size_t smem, int blocks_per_sm,
                     cudaStream_t stream) {
  static std::atomic<bool> ready[kMaxDevices];
  const auto kernel = conv1d_bn_relu_kernel_pipelined<CoTile, RowTile, Taps, Dil>;
  // Its occupancy rests on shared memory: the carveout is the largest.
  const cudaError_t err = prepare(kernel, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  // About as many blocks as the SMs hold at the plan's occupancy, split
  // over the column tiles; never more row walkers than row tiles.
  const long long tiles = (a.rows_total + RowTile - 1) / RowTile;
  const int cols = (a.c_out + CoTile - 1) / CoTile;
  const long long walkers =
      (static_cast<long long>(sms) * blocks_per_sm + cols - 1) / cols;
  const dim3 grid(static_cast<unsigned>(walkers < tiles ? walkers : tiles),
                  static_cast<unsigned>(cols));
  kernel<<<grid, pipelined_threads_of(CoTile, RowTile), smem, stream>>>(
      a, x_vec_of(a), w_vec_of(a));
  return static_cast<int>(cudaGetLastError());
}

template <int CoTile, int RowTile>
int launch_window_path(const Args& a, size_t smem, int blocks_per_sm,
                       cudaStream_t stream) {
  if (a.taps == 1 && a.dilation == 1) {
    return launch_pipelined<CoTile, RowTile, 1, 1>(a, smem, blocks_per_sm, stream);
  }
  if (a.taps == 3 && a.dilation == 1) {
    return launch_pipelined<CoTile, RowTile, 3, 1>(a, smem, blocks_per_sm, stream);
  }
  if (a.taps == 3 && a.dilation == 2) {
    return launch_pipelined<CoTile, RowTile, 3, 2>(a, smem, blocks_per_sm, stream);
  }
  if (a.taps == 3 && a.dilation == 4) {
    return launch_pipelined<CoTile, RowTile, 3, 4>(a, smem, blocks_per_sm, stream);
  }
  return kErrNoInstance;
}

}  // namespace

// C interface, bound with ctypes by deepbinner_tpu_torch/ops/conv_kernel.py.
// The last seven ints are the caller's plan (ops/conv_kernel.plan_unit):
// the output-channel tile, the row tile, the block's thread count, whether
// the "pipelined" loop runs (else "generic"), the dynamic shared memory in
// bytes, the stages of x in flight (kStages for "pipelined", 1 for
// "generic") and the blocks per SM the persistent grid is sized for (1 to
// kPipelinedBlocks for "pipelined", 0 for "generic", whose grid has a
// block per row tile).  A plan this library was not built for, or whose
// numbers disagree with the tiles, returns kErrNoInstance or
// kErrPlanMismatch and launches nothing; no other plan is picked instead.
// Launches on `stream`, allocates nothing, and otherwise returns
// cudaGetLastError() (0 on success).  The caller checks shapes, dtype and
// contiguity; `out` is (n, pool ? length/2 : length, c_out) f32.
extern "C" int deepbinner_conv1d_bn_relu(const void* x, const void* w,
                                         const void* scale, const void* bias,
                                         void* out, int n, int length,
                                         int c_in, int c_out, int taps,
                                         int dilation, int relu, int pool,
                                         int co_tile, int row_tile,
                                         int threads, int pipelined,
                                         int smem_bytes, int stages,
                                         int blocks_per_sm, void* stream) {
  const size_t smem = pipelined
      ? pipelined_smem_of(co_tile, row_tile, taps, dilation, c_in)
      : smem_of(co_tile, row_tile, taps, dilation);
  const bool fits =
      pipelined ? threads == pipelined_threads_of(co_tile, row_tile) &&
                      stages == kStages && blocks_per_sm >= 1 &&
                      blocks_per_sm <= kPipelinedBlocks && length % kRows == 0
                : threads == threads_of(co_tile, row_tile) && stages == 1 &&
                      blocks_per_sm == 0;
  if (!fits || smem_bytes < 0 || static_cast<size_t>(smem_bytes) != smem ||
      smem > kSmemMax) {
    return kErrPlanMismatch;
  }
  const Args a{static_cast<const float*>(x), static_cast<const float*>(w),
               static_cast<const float*>(scale),
               static_cast<const float*>(bias), static_cast<float*>(out),
               static_cast<long long>(n) * length, length, c_in, c_out, taps,
               dilation, relu, pool};
  if (a.rows_total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEEPBINNER_CONV_DISPATCH(CO, ROWS)                                    \
  if (!pipelined && co_tile == (CO) && row_tile == (ROWS)) {                  \
    return launch_generic<CO, ROWS>(a, smem, s);                              \
  }
#define DEEPBINNER_PIPELINED_DISPATCH(CO, ROWS)                               \
  if (pipelined && co_tile == (CO) && row_tile == (ROWS)) {                   \
    return launch_window_path<CO, ROWS>(a, smem, blocks_per_sm, s);           \
  }
  DEEPBINNER_CONV_TILES(DEEPBINNER_CONV_DISPATCH)
  DEEPBINNER_PIPELINED_TILES(DEEPBINNER_PIPELINED_DISPATCH)
#undef DEEPBINNER_CONV_DISPATCH
#undef DEEPBINNER_PIPELINED_DISPATCH
  return kErrNoInstance;
}
