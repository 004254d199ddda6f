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
// 3.35 TB/s.  The design answers the first: each thread keeps an 8-row by
// 4-channel accumulator tile in registers and feeds it from shared memory.
// No TF32 and no tensor cores: the reference is f32 (conv_pallas.py "f32
// everywhere").
//
// Layout and tiling.  x is (N, L, C_in) row-major, seen as N*L rows of
// C_in channels.  A block owns RowTile consecutive rows of that flattened
// view (they may span several windows when L < RowTile) and CoTile output
// channels.  CoTile is 32, 48 or 64, picked by the caller's planner
// (ops/conv_kernel.plan_unit) so that it divides C_out at every unit of
// the flagship model: no block computes a column it throws away.  The
// block stages rows [p0 - halo, p0 + RowTile + halo) of one C_in chunk and
// the matching weights w[:, chunk, co_tile] in shared memory (16-byte
// global loads where C_in, or C_out for the weights, is a multiple of 4),
// then every thread accumulates its 8 rows.  The C_in loop is chunked so
// head_conv's 3x128x128 weights never have to fit at once.
//
// Two inner loops, one per template instance:
// - "window" (Taps > 0: (K, d) in {(1,1), (3,1), (3,2), (3,4)}, L % 8 == 0):
//   per input channel a thread loads the 8 + (K-1)*d staged values its 8
//   rows need once into registers and runs all K taps on them, with one
//   float4 weight load per tap.  Since L % 8 == 0 a thread's 8 rows lie in
//   one window, so whether a loaded value lies inside that window depends
//   on the value alone: each is masked once, as it is loaded, and only the
//   2*halo values around the thread's own rows can need it.
// - "generic" (Taps == 0: any odd K, any d, any L): tap outside channel,
//   each of the 8*K reads masked by its own row's window.
//
// Determinism: every output is summed in one fixed order (C_in chunk, then
// channel, then tap for "window"; chunk, tap, channel for "generic") by one
// thread, with no atomics and no split over C_in, so results are
// bit-identical from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kCiChunk = 32;  // input channels staged per pass
constexpr int kRows = 8;      // rows per thread (four pool pairs)
constexpr int kCols = 4;      // channels per thread (one float4)
// Odd row stride: the row groups of a warp (8 rows apart) fall on
// different banks; a stride that is a multiple of 4 would put them on one.
constexpr int kXStride = kCiChunk + 1;

// What the C entry point returns for a plan it was not built for (CUDA's
// own error codes are positive).
constexpr int kErrNoInstance = -1;    // no template instance for the plan
constexpr int kErrPlanMismatch = -2;  // threads, smem or path do not fit

// __launch_bounds__' blocks per SM.  4 caps a 256-thread block at 64
// registers (a few spilled bytes) and a 192-thread one at 85: more warps
// per SM paid more than the registers cost (a sweep of 1 to 4 on an H100).
constexpr int kMinBlocks = 4;

// The (CoTile, RowTile) instances built; ops/conv_kernel.ROW_TILES mirrors it.
#define DEEPBINNER_CONV_TILES(X) X(32, 256) X(48, 128) X(64, 128)

__host__ __device__ constexpr int threads_of(int co_tile, int row_tile) {
  return row_tile / kRows * (co_tile / kCols);
}

size_t smem_of(int co_tile, int row_tile, int taps, int dilation) {
  const int halo = (taps - 1) / 2 * dilation;
  return sizeof(float) *
         (static_cast<size_t>(taps) * kCiChunk * co_tile +
          static_cast<size_t>(row_tile + 2 * halo) * kXStride);
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

// Taps > 0: the "window" loop for that (Taps, Dil); Taps == 0: "generic".
template <int CoTile, int RowTile, int Taps, int Dil>
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

  if constexpr (Taps > 0) {
    constexpr int kHalo = (Taps - 1) / 2 * Dil;
    constexpr int kWin = kRows + 2 * kHalo;
    // Window position of the thread's first row; all 8 share the window.
    const int lpos0 = static_cast<int>((p0 + row0) % a.length);
    bool keep[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      keep[j] = (j >= kHalo && j < kHalo + kRows) ||
                static_cast<unsigned>(lpos0 - kHalo + j) <
                    static_cast<unsigned>(a.length);
    }
    const float* xt = xs + row0 * kXStride;
    for (int c0 = 0; c0 < a.c_in; c0 += kCiChunk) {
      const int cn = min(kCiChunk, a.c_in - c0);
      __syncthreads();  // the previous chunk's reads are done
      stage<CoTile, RowTile>(a, xs, ws, p0, co0, c0, cn, kHalo, x_vec, w_vec);
      __syncthreads();
#pragma unroll 2
      for (int ci = 0; ci < cn; ++ci) {
        float xv[kWin];
#pragma unroll
        for (int j = 0; j < kWin; ++j) {
          const float v = xt[j * kXStride + ci];
          xv[j] = keep[j] ? v : 0.f;
        }
#pragma unroll
        for (int k = 0; k < Taps; ++k) {
          const float4 wv = ws4[(k * kCiChunk + ci) * kQuads + cg];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float xr = xv[r + k * Dil];
            acc[r][0] = fmaf(xr, wv.x, acc[r][0]);
            acc[r][1] = fmaf(xr, wv.y, acc[r][1]);
            acc[r][2] = fmaf(xr, wv.z, acc[r][2]);
            acc[r][3] = fmaf(xr, wv.w, acc[r][3]);
          }
        }
      }
    }
  } else {
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
  }

  // Epilogue: folded BN affine, ReLU, optional pair max, masked store.
  const int co = co0 + cg * kCols;
  if (co >= a.c_out) return;
  float s[kCols], b[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const bool ok = co + c < a.c_out;
    s[c] = ok ? a.scale[co + c] : 0.f;
    b[c] = ok ? a.bias[co + c] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = fmaf(acc[r][c], s[c], b[c]);
      acc[r][c] = a.relu ? fmaxf(v, 0.f) : v;
    }
  }
  if (a.pool) {
    // Rows (2j, 2j+1) of one window are one pool pair: p0 and row0 are
    // even and L is even (the wrapper checks), so a pair never straddles
    // two windows, and its pooled row is p/2 in the flattened output.
#pragma unroll
    for (int r = 0; r < kRows; r += 2) {
      const long long p = p0 + row0 + r;
      if (p < a.rows_total) {
        float v[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[c] = fmaxf(acc[r][c], acc[r + 1][c]);
        store(a.out + (p / 2) * a.c_out + co, v, a.c_out - co);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long p = p0 + row0 + r;
      if (p < a.rows_total) store(a.out + p * a.c_out + co, acc[r], a.c_out - co);
    }
  }
}

template <int CoTile, int RowTile, int Taps, int Dil>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  if (a.rows_total == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv1d_bn_relu_kernel<CoTile, RowTile, Taps, Dil>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte global loads need 16-byte aligned rows and base pointers.
  const bool x_vec = a.c_in % 4 == 0 &&
                     (reinterpret_cast<size_t>(a.x) & 15) == 0;
  const bool w_vec = a.c_out % 4 == 0 &&
                     (reinterpret_cast<size_t>(a.w) & 15) == 0;
  const dim3 grid(static_cast<unsigned>((a.rows_total + RowTile - 1) / RowTile),
                  static_cast<unsigned>((a.c_out + CoTile - 1) / CoTile));
  conv1d_bn_relu_kernel<CoTile, RowTile, Taps, Dil>
      <<<grid, threads_of(CoTile, RowTile), smem, stream>>>(a, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

template <int CoTile, int RowTile>
int launch_path(const Args& a, int window, size_t smem, cudaStream_t stream) {
  if (!window) return launch<CoTile, RowTile, 0, 0>(a, smem, stream);
  if (a.taps == 1 && a.dilation == 1) {
    return launch<CoTile, RowTile, 1, 1>(a, smem, stream);
  }
  if (a.taps == 3 && a.dilation == 1) {
    return launch<CoTile, RowTile, 3, 1>(a, smem, stream);
  }
  if (a.taps == 3 && a.dilation == 2) {
    return launch<CoTile, RowTile, 3, 2>(a, smem, stream);
  }
  if (a.taps == 3 && a.dilation == 4) {
    return launch<CoTile, RowTile, 3, 4>(a, smem, stream);
  }
  return kErrNoInstance;
}

}  // namespace

// C interface, bound with ctypes by deepbinner_tpu_torch/ops/conv_kernel.py.
// The last five ints are the caller's plan (ops/conv_kernel.plan_unit):
// the output-channel tile, the row tile, the block's thread count, whether
// the "window" loop runs (else "generic") and the dynamic shared memory in
// bytes.  A plan this library was not built for, or whose thread count or
// shared memory disagrees with the tiles, returns kErrNoInstance or
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
                                         int threads, int window,
                                         int smem_bytes, void* stream) {
  if (threads != threads_of(co_tile, row_tile) || smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) !=
          smem_of(co_tile, row_tile, taps, dilation) ||
      (window && length % kRows != 0)) {
    return kErrPlanMismatch;
  }
  const Args a{static_cast<const float*>(x), static_cast<const float*>(w),
               static_cast<const float*>(scale),
               static_cast<const float*>(bias), static_cast<float*>(out),
               static_cast<long long>(n) * length, length, c_in, c_out, taps,
               dilation, relu, pool};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEEPBINNER_CONV_DISPATCH(CO, ROWS)                         \
  if (co_tile == (CO) && row_tile == (ROWS)) {                     \
    return launch_path<CO, ROWS>(a, window, smem_bytes, s);        \
  }
  DEEPBINNER_CONV_TILES(DEEPBINNER_CONV_DISPATCH)
#undef DEEPBINNER_CONV_DISPATCH
  return kErrNoInstance;
}
