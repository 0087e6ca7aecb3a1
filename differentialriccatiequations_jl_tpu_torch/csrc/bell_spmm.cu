// Block-ELL sparse times dense-block product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   differentialriccatiequations_jl_tpu/ops/sparse.py::_bell_mm_pallas
// which computes, for a matrix tiled in bs x bs blocks with K block slots
// per block row (block-column index cols[i, k], dense block data[i, k]),
//   Y[i*bs + a, c] = sum_k sum_b data[i, k, a, b] * X[cols[i, k]*bs + b, c].
// The TPU kernel has two branches: a transposed layout with double-buffered
// DMA gathers for q < 128 columns, and a scalar-prefetch grid (nb, K) that
// carries the sum from one grid step to the next for q >= 128.  Here one
// kernel serves every q: the slot loop runs inside the thread block (Hopper
// blocks run in no order, so nothing can carry over between them) and each
// block reads its own cols entries.
//
// What bounds it on the card: bytes.  The dense blocks are mostly zeros
// (on the n = 79841 Rail surrogate, 624 x 7 blocks of 128 x 128 hold 180
// times the 398,639 structural nonzeros: 573 MB in f64), and every call must
// read all of them.  At the widths the Rosenbrock step uses (q = 7, 48, 96)
// that is q/4 multiply-adds per byte of data in f64, under the card's ratio
// of peak operations to memory rate, so the data stream sets the time
// (about 0.17 ms a call at 3.35 TB/s).
//
// Design: a thread block owns BELL_ROWS rows of one bs-row block row and
// all q columns, and reads each data block of its rows exactly once per
// call.  For every slot it stages a BELL_BK-wide slice of its data rows and
// the matching BELL_BK rows of X (all columns) in shared memory; lane l of
// a warp owns rows l and l + 32, warp w owns columns w*8 .. w*8 + 7 of each
// 64-column chunk, and the sums stay in registers across all slots.  The
// data tile is read with lanes on neighbouring addresses; the X slice is
// read along whichever axis of X has unit stride.  Rows of X at or beyond
// n are masked in place, so no padded copy of the operand exists, and rows
// of Y at or beyond n are not written.  X and Y are addressed through
// element strides for both axes, so column-major (n, q) factors and
// transposed views run without copies.  Sums run over k, then b, in order.
// Up to 4 chunks (q <= 256) run in one launch; the wrapper splits wider
// operands into 256-column launches, each reading the data once more (no
// width of the step's path is that wide).  Tensor-core products (DMMA for
// f64, wgmma for f32) and TMA staging are later work.

#include <cuda_runtime.h>

#define BELL_THREADS 256
#define BELL_ROWS 64    // rows of a block row per thread block (2 per lane)
#define BELL_BK 16      // inner-dimension slice staged in shared memory
#define BELL_TC 8       // columns per warp in a chunk
#define BELL_CHUNK 64   // columns per chunk: 8 warps x BELL_TC
#define BELL_MAX_CHUNKS 4

template <typename T> struct Vec16;  // 16-byte vector of T
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };

// Registers are capped so that three blocks (one chunk) or two (two
// chunks) share an SM.
template <typename T, int NCH>
__global__ void __launch_bounds__(BELL_THREADS, NCH == 1 ? 3 : (NCH == 2 ? 2 : 1))
bell_spmm_kernel(const int* __restrict__ cols, const T* __restrict__ data,
                 int K, int bs, int tiles,
                 const T* __restrict__ x, long long x_si, long long x_sc,
                 T* __restrict__ y, long long y_si, long long y_sc,
                 int n, int q) {
    constexpr int QW = NCH * BELL_CHUNK;
    constexpr int XS = QW + 4;  // padded row stride of sX, keeps 16-byte rows
    using V = typename Vec16<T>::type;
    constexpr int VN = sizeof(V) / sizeof(T);
    __shared__ T sD[BELL_ROWS][BELL_BK + 1];
    __shared__ __align__(16) T sX[BELL_BK][XS];

    const int i = blockIdx.x / tiles;                   // block row
    const int r0 = (blockIdx.x % tiles) * BELL_ROWS;    // first row in it
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const bool x_rows_unit = x_si == 1;

    T acc[NCH][2][BELL_TC];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < BELL_TC; ++c) acc[ch][h][c] = T(0);

    for (int k = 0; k < K; ++k) {
        const long long j0 = (long long)cols[(long long)i * K + k] * bs;
        const T* dblk = data + ((long long)i * K + k) * bs * bs;
        for (int b0 = 0; b0 < bs; b0 += BELL_BK) {
            __syncthreads();  // the previous slice has been consumed
            for (int e = t; e < BELL_ROWS * BELL_BK; e += BELL_THREADS) {
                const int r = e / BELL_BK, bb = e % BELL_BK;
                const int row = r0 + r, b = b0 + bb;
                sD[r][bb] = (row < bs && b < bs) ? dblk[(long long)row * bs + b] : T(0);
            }
            for (int e = t; e < BELL_BK * QW; e += BELL_THREADS) {
                int bb, c;
                if (x_rows_unit) {
                    bb = e % BELL_BK;
                    c = e / BELL_BK;
                } else {
                    c = e % QW;
                    bb = e / QW;
                }
                const long long row = j0 + b0 + bb;
                sX[bb][c] = (b0 + bb < bs && row < n && c < q)
                                ? x[row * x_si + (long long)c * x_sc] : T(0);
            }
            __syncthreads();
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch) {
                if (ch * BELL_CHUNK + warp * BELL_TC >= q) continue;  // warp-uniform
#pragma unroll 4
                for (int bb = 0; bb < BELL_BK; ++bb) {
                    const T d0 = sD[lane][bb];
                    const T d1 = sD[lane + 32][bb];
                    union { V v[BELL_TC / VN]; T s[BELL_TC]; } xv;
                    const V* xp = reinterpret_cast<const V*>(
                        &sX[bb][ch * BELL_CHUNK + warp * BELL_TC]);
#pragma unroll
                    for (int u = 0; u < BELL_TC / VN; ++u) xv.v[u] = xp[u];
#pragma unroll
                    for (int c = 0; c < BELL_TC; ++c) {
                        acc[ch][0][c] += d0 * xv.s[c];
                        acc[ch][1][c] += d1 * xv.s[c];
                    }
                }
            }
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = r0 + lane + 32 * h;
        const long long grow = (long long)i * bs + row;
        if (row >= bs || grow >= n) continue;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
            for (int c = 0; c < BELL_TC; ++c) {
                const int col = ch * BELL_CHUNK + warp * BELL_TC + c;
                if (col < q) y[grow * y_si + (long long)col * y_sc] = acc[ch][h][c];
            }
    }
}

template <typename T>
static int launch(const int* cols, const T* data, int nb, int K, int bs,
                  const T* x, long long x_si, long long x_sc,
                  T* y, long long y_si, long long y_sc, int n, int q,
                  void* stream) {
    if (nb < 1 || K < 1 || bs < 1 || n < 1 || q < 1
        || q > BELL_MAX_CHUNKS * BELL_CHUNK
        || (long long)(nb - 1) * bs >= n || (long long)nb * bs < n) {
        return (int)cudaErrorInvalidValue;
    }
    const int tiles = (bs + BELL_ROWS - 1) / BELL_ROWS;
    const dim3 grid((unsigned)nb * (unsigned)tiles);
    const dim3 block(BELL_THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (q <= BELL_CHUNK) {
        bell_spmm_kernel<T, 1><<<grid, block, 0, s>>>(
            cols, data, K, bs, tiles, x, x_si, x_sc, y, y_si, y_sc, n, q);
    } else if (q <= 2 * BELL_CHUNK) {
        bell_spmm_kernel<T, 2><<<grid, block, 0, s>>>(
            cols, data, K, bs, tiles, x, x_si, x_sc, y, y_si, y_sc, n, q);
    } else {
        bell_spmm_kernel<T, 4><<<grid, block, 0, s>>>(
            cols, data, K, bs, tiles, x, x_si, x_sc, y, y_si, y_sc, n, q);
    }
    return (int)cudaGetLastError();
}

// Plain C interface (loaded with ctypes).  `cols` is (nb, K) int32 and
// `data` (nb, K, bs, bs), both contiguous on the device; X and Y have n rows
// (nb = ceil(n / bs)) and q <= 256 columns, addressed as
// base[row * s_i + col * s_c].  Returns the CUDA error code of the launch.
extern "C" int bell_spmm_f64(const void* cols, const void* data, int nb, int K,
                             int bs, const void* x, long long x_si, long long x_sc,
                             void* y, long long y_si, long long y_sc, int n, int q,
                             void* stream) {
    return launch<double>((const int*)cols, (const double*)data, nb, K, bs,
                          (const double*)x, x_si, x_sc, (double*)y, y_si, y_sc,
                          n, q, stream);
}

extern "C" int bell_spmm_f32(const void* cols, const void* data, int nb, int K,
                             int bs, const void* x, long long x_si, long long x_sc,
                             void* y, long long y_si, long long y_sc, int n, int q,
                             void* stream) {
    return launch<float>((const int*)cols, (const float*)data, nb, K, bs,
                         (const float*)x, x_si, x_sc, (float*)y, y_si, y_sc,
                         n, q, stream);
}
