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
// What bounds it on the card: bytes, but only if the arithmetic runs on the
// tensor cores.  The dense blocks are mostly zeros (on the n = 79841 Rail
// surrogate, 624 x 7 blocks of 128 x 128 hold 180 times the 398,639
// structural nonzeros: 573 MB in f64), and every call must read all of
// them: 0.17-0.21 ms at 3.35 TB/s for q = 7..96.  The same call does
// 2 * 71.56 M * q operations: at q = 48 that is 6.9 GFLOP, 0.20 ms at the
// 34 TFLOP/s that f64 FMAs outside the tensor cores peak at, already above
// the bytes bound (0.40 ms at q = 96).  So an FFMA kernel cannot reach the
// bound in f64; the FP64 tensor cores (DMMA, 67 TFLOP/s) can.
//
// Design: a thread block of 8 warps owns a whole 128-row block row (or a
// 128-row tile of a larger block) and a chunk of up to 128 columns (8 * NT,
// NT n8-tiles), so every data block is read once per call for q <= 128 and
// the X slice of each slot is staged once.  The slots' data and X are
// streamed through a ring of 4 stages (3 where 4 do not fit in 227 KB) in
// dynamic shared memory, each holding a 128 x 32 slice of a data block
// (cp.async.cg, 16 bytes, L1 bypassed: it is used once) and the matching
// 32 x (8 NT) slice of X (cp.async.ca of single elements: X has any strides, and a
// (q, n)-backed view or a (n, 7) operand has rows that no 16-byte copy can
// address).  The copy of slice s + STAGES - 1 is in flight while slice s is
// multiplied; one barrier per slice.  Rows and columns beyond bs, n or q
// are zero-filled by the copies (src-size 0), so no padded copy of X
// exists and rows of Y at or beyond n are not written.
//  * f64: warp w computes rows 16w..16w+15 of the tile against all NT
//    n8-tiles with mma.sync.m16n8k16.f64 (DMMA); the sums stay in
//    registers across all slots.  Shared-memory rows are padded by 4
//    elements so the 64-bit fragment loads (ldmatrix has no 64-bit form)
//    are free of bank conflicts: A rows 288 bytes apart put the 4 rows of a
//    half-warp on banks 0, 8, 16, 24; X rows of 8 NT + 4 doubles do the
//    same.  Order of the sum: slots in order, then slices of 16 in
//    order; inside each 16-wide step the tensor core's own order.  A few
//    ulps of the largest entry.
//  * f32: FFMAs (tensor-core f32 means TF32, about three digits; the port
//    keeps TF32 off).  Lane l owns rows l, l + 32, l + 64, l + 96 and reads
//    4 inner elements of each with one 16-byte load (the 4-float padding
//    puts a quarter-warp on distinct banks); warp w owns NT columns.  The
//    sum runs over slots, then b, in order.
// Wider operands take ceil(q / 128) chunks in one launch; the chunks of a
// block row are neighbours in the grid, so they share its data through L2.

#include <cuda_runtime.h>

#include <type_traits>

#define BELL_BM 128       // rows of a block row per thread block
#define BELL_BK 32        // inner slice per pipeline stage
#define BELL_PAD 4        // elements of padding per shared-memory row
#define BELL_MAX_NT 16    // n8-tiles per chunk: 128 columns
#define BELL_SMEM_MAX (227 * 1024)
#define BELL_THREADS 256  // 8 warps
#define BELL_MMA_K 16     // inner depth of one DMMA (m16n8k16)

template <typename T, int NT>
struct BellTile {
    static constexpr int QW = 8 * NT;               // columns of a chunk
    static constexpr int AS = BELL_BK + BELL_PAD;   // row stride of a data slice
    static constexpr int XS = QW + BELL_PAD;        // row stride of an X slice
    static constexpr int STAGE = BELL_BM * AS + BELL_BK * XS;  // elements
    static constexpr int STAGES =
        4 * STAGE * (int)sizeof(T) <= BELL_SMEM_MAX ? 4 : 3;
    static constexpr int SMEM = STAGES * STAGE * (int)sizeof(T);
    static_assert(SMEM <= BELL_SMEM_MAX, "stage ring does not fit");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte copy, L1 bypassed; zero-fills the destination when !ok.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

// One-element copy (4 or 8 bytes); zero-fills the destination when !ok.
template <int B>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(B), "r"(ok ? B : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// D = A (16x16, row) * B (16x8, col) + D on the FP64 tensor cores.
// Fragments (lane = 4 g + t): a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)],
// b[i] = B[t + 4 i][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8],
                                     const double (&b)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Accumulators of one thread: f64 holds NT DMMA fragments (rows g and
// g + 8 of the warp's 16, columns 2t and 2t + 1 of each n8-tile); f32 holds
// 4 rows x NT columns.
template <typename T, int NT> struct BellAcc;
template <int NT> struct BellAcc<double, NT> { double v[NT][4]; };
template <int NT> struct BellAcc<float, NT> { float v[4][NT]; };

template <int NT>
__device__ __forceinline__ void bell_compute(BellAcc<double, NT>& acc, const double* sA,
                                             const double* sX, int lane, int warp, int qc) {
    using L = BellTile<double, NT>;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < BELL_BK; ks += BELL_MMA_K) {
        const double* a = sA + (16 * warp + g) * L::AS + ks + t;
        double af[BELL_MMA_K / 2];
#pragma unroll
        for (int r = 0; r < BELL_MMA_K / 2; ++r) af[r] = a[(r & 1) * 8 * L::AS + (r >> 1) * 4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            if (nt * 8 < qc) {  // uniform over the warp
                const double* b = sX + (ks + t) * L::XS + nt * 8 + g;
                double bf[BELL_MMA_K / 4];
#pragma unroll
                for (int r = 0; r < BELL_MMA_K / 4; ++r) bf[r] = b[r * 4 * L::XS];
                dmma(acc.v[nt], af, bf);
            }
        }
    }
}

template <int NT>
__device__ __forceinline__ void bell_compute(BellAcc<float, NT>& acc, const float* sA,
                                             const float* sX, int lane, int warp, int qc) {
    using L = BellTile<float, NT>;
    if (warp * NT >= qc) return;  // this warp's columns are all padding
#pragma unroll
    for (int k = 0; k < BELL_BK; k += 4) {
        float4 a[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
            a[h] = *reinterpret_cast<const float4*>(sA + (lane + 32 * h) * L::AS + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const float* b = sX + (k + kk) * L::XS + warp * NT;
#pragma unroll
            for (int h = 0; h < 4; ++h) {
                const float av = kk == 0 ? a[h].x : kk == 1 ? a[h].y : kk == 2 ? a[h].z : a[h].w;
#pragma unroll
                for (int c = 0; c < NT; ++c) acc.v[h][c] = fmaf(av, b[c], acc.v[h][c]);
            }
        }
    }
}

template <int NT>
__device__ __forceinline__ void bell_store(const BellAcc<double, NT>& acc, double* y,
                                           long long y_si, long long y_sc, long long row0,
                                           int rows, int lane, int warp, int qc) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const int r = 16 * warp + g + 8 * (v >> 1);
            const int c = nt * 8 + 2 * t + (v & 1);
            if (r < rows && c < qc) y[(row0 + r) * y_si + (long long)c * y_sc] = acc.v[nt][v];
        }
    }
}

template <int NT>
__device__ __forceinline__ void bell_store(const BellAcc<float, NT>& acc, float* y,
                                           long long y_si, long long y_sc, long long row0,
                                           int rows, int lane, int warp, int qc) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
        const int r = lane + 32 * h;
#pragma unroll
        for (int c = 0; c < NT; ++c) {
            const int col = warp * NT + c;
            if (r < rows && col < qc) y[(row0 + r) * y_si + (long long)col * y_sc] = acc.v[h][c];
        }
    }
}

// Grid: one block per (block row i, 128-row tile of it, column chunk),
// the chunk fastest.  VEC: bs is a multiple of 16 bytes' worth of T and
// data is 16-byte aligned, so data slices go by 16-byte copies.
template <typename T, int NT, bool VEC>
__global__ void __launch_bounds__(BELL_THREADS, 1)
bell_spmm_kernel(const int* __restrict__ cols, const T* __restrict__ data,
                 int K, int bs, int tiles, int chunks,
                 const T* __restrict__ x, long long x_si, long long x_sc,
                 T* __restrict__ y, long long y_si, long long y_sc,
                 int n, int q) {
    using L = BellTile<T, NT>;
    extern __shared__ __align__(16) unsigned char bell_smem[];
    T* smem = reinterpret_cast<T*>(bell_smem);

    const int chunk = blockIdx.x % chunks;
    const int tile = (blockIdx.x / chunks) % tiles;
    const int i = blockIdx.x / (chunks * tiles);       // block row
    const int r0 = tile * BELL_BM;                     // first row of the tile in it
    const int c0 = chunk * L::QW;                      // first column of the chunk
    const int qc = min(L::QW, q - c0);                 // columns of the chunk
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nsl = (bs + BELL_BK - 1) / BELL_BK;      // slices per block
    const int items = K * nsl;
    const bool x_rows_unit = x_si == 1 && x_sc != 1;
    const T* xq = x + (long long)c0 * x_sc;

    // Start the copies of item `it` (slot it / nsl, slice it % nsl) into
    // its stage of the ring.
    auto issue = [&](int it) {
        T* sA = smem + (it % L::STAGES) * L::STAGE;
        T* sX = sA + BELL_BM * L::AS;
        const int k = it / nsl, b0 = (it % nsl) * BELL_BK;
        const long long blk = (long long)i * K + k;
        const T* dblk = data + blk * bs * bs;
        const long long j0 = (long long)cols[blk] * bs + b0;  // first X row
        if (VEC) {
            constexpr int VN = 16 / sizeof(T);
            constexpr int PER_ROW = BELL_BK / VN;
            static_assert(BELL_BM * PER_ROW % BELL_THREADS == 0, "uneven data copies");
#pragma unroll
            for (int u = 0; u < BELL_BM * PER_ROW / BELL_THREADS; ++u) {
                const int e = tid + u * BELL_THREADS;
                const int r = e / PER_ROW, b = (e % PER_ROW) * VN;
                const bool ok = r0 + r < bs && b0 + b < bs;
                cp_async_16(sA + r * L::AS + b,
                            ok ? dblk + (long long)(r0 + r) * bs + b0 + b : data, ok);
            }
        } else {
#pragma unroll 4
            for (int u = 0; u < BELL_BM * BELL_BK / BELL_THREADS; ++u) {
                const int e = tid + u * BELL_THREADS;
                const int r = e / BELL_BK, b = e % BELL_BK;
                const bool ok = r0 + r < bs && b0 + b < bs;
                cp_async_elem<sizeof(T)>(sA + r * L::AS + b,
                                         ok ? dblk + (long long)(r0 + r) * bs + b0 + b : data, ok);
            }
        }
        // Lanes along whichever axis of X has unit stride.
        static_assert(BELL_BK * L::QW % BELL_THREADS == 0, "uneven X copies");
#pragma unroll
        for (int u = 0; u < BELL_BK * L::QW / BELL_THREADS; ++u) {
            const int e = tid + u * BELL_THREADS;
            int b, c;
            if (x_rows_unit) {
                b = e % BELL_BK;
                c = e / BELL_BK;
            } else {
                c = e % L::QW;
                b = e / L::QW;
            }
            const long long row = j0 + b;
            const bool ok = b0 + b < bs && row < n && c < qc;
            cp_async_elem<sizeof(T)>(sX + b * L::XS + c,
                                     ok ? xq + row * x_si + (long long)c * x_sc : x, ok);
        }
    };

    BellAcc<T, NT> acc{};  // zeros

#pragma unroll
    for (int s = 0; s < L::STAGES - 1; ++s) {
        if (s < items) issue(s);
        cp_async_commit();
    }
    for (int it = 0; it < items; ++it) {
        cp_async_wait<L::STAGES - 2>();  // item `it` has landed (this thread's copies)
        __syncthreads();                 // ... everyone's; and item it-1 is consumed
        if (it + L::STAGES - 1 < items) issue(it + L::STAGES - 1);
        cp_async_commit();
        const T* sA = smem + (it % L::STAGES) * L::STAGE;
        bell_compute<NT>(acc, sA, sA + BELL_BM * L::AS, lane, warp, qc);
    }
    cp_async_wait<0>();

    const long long row0 = (long long)i * bs + r0;
    const int rows = (int)min((long long)min(BELL_BM, bs - r0), (long long)n - row0);
    bell_store<NT>(acc, y + (long long)c0 * y_sc, y_si, y_sc, row0, rows, lane, warp, qc);
}

// n8-tiles of the variant that serves q columns (chunks of 128 beyond).
static int bell_nt(int q) {
    const int need = (q + 7) / 8;
    const int nts[] = {1, 2, 4, 6, 8, 12, 16};
    for (int nt : nts)
        if (nt >= need) return nt;
    return BELL_MAX_NT;
}

// Calls f(std::integral_constant<int, NT>) for the variant of q columns.
template <typename F>
static int with_nt(int q, F&& f) {
    switch (bell_nt(q)) {
        case 1: return f(std::integral_constant<int, 1>{});
        case 2: return f(std::integral_constant<int, 2>{});
        case 4: return f(std::integral_constant<int, 4>{});
        case 6: return f(std::integral_constant<int, 6>{});
        case 8: return f(std::integral_constant<int, 8>{});
        case 12: return f(std::integral_constant<int, 12>{});
        default: return f(std::integral_constant<int, 16>{});
    }
}

template <typename T>
static int launch(const int* cols, const T* data, int nb, int K, int bs,
                  const T* x, long long x_si, long long x_sc,
                  T* y, long long y_si, long long y_sc, int n, int q,
                  void* stream) {
    if (nb < 1 || K < 1 || bs < 1 || n < 1 || q < 1
        || (long long)(nb - 1) * bs >= n || (long long)nb * bs < n) {
        return (int)cudaErrorInvalidValue;
    }
    const int tiles = (bs + BELL_BM - 1) / BELL_BM;
    const bool vec = bs % (16 / (int)sizeof(T)) == 0 && ((unsigned long long)data & 15) == 0;
    return with_nt(q, [&](auto nt) {
        constexpr int NT = decltype(nt)::value;
        using L = BellTile<T, NT>;
        const int chunks = (q + L::QW - 1) / L::QW;
        const long long blocks = (long long)nb * tiles * chunks;
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        auto kern = vec ? bell_spmm_kernel<T, NT, true> : bell_spmm_kernel<T, NT, false>;
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
        if (err != cudaSuccess) return (int)err;
        kern<<<(unsigned)blocks, BELL_THREADS, L::SMEM, (cudaStream_t)stream>>>(
            cols, data, K, bs, tiles, chunks, x, x_si, x_sc, y, y_si, y_sc, n, q);
        return (int)cudaGetLastError();
    });
}

// Plain C interface (loaded with ctypes).  `cols` is (nb, K) int32 and
// `data` (nb, K, bs, bs), both contiguous on the device; X and Y have n rows
// (nb = ceil(n / bs)) and q columns, addressed as base[row * s_i + col * s_c].
// Returns the CUDA error code of the launch.
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

// The variant a call with q columns takes (for reports): n8-tiles per
// chunk, stages of the ring and dynamic shared memory in bytes.
extern "C" int bell_spmm_plan(int f64, int q, int* nt, int* stages, int* smem_bytes) {
    if (q < 1) return (int)cudaErrorInvalidValue;
    auto plan = [&](auto tag, auto ntc) {
        using L = BellTile<decltype(tag), decltype(ntc)::value>;
        *nt = decltype(ntc)::value;
        *stages = L::STAGES;
        *smem_bytes = L::SMEM;
        return 0;
    };
    return f64 ? with_nt(q, [&](auto ntc) { return plan(0.0, ntc); })
               : with_nt(q, [&](auto ntc) { return plan(0.0f, ntc); });
}
