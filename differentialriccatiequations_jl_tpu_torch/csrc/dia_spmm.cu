// DIA (diagonal-storage) sparse times dense-block product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   differentialriccatiequations_jl_tpu/ops/dia.py::_dia_mm_pallas_t
// which computes, for a banded operator stored one vector per diagonal,
//   Y[c, i] = sum_d data[d, i] * X[c, i + off_d]      (zero outside [0, N))
// with an optional fused epilogue  Y = alpha * Y + beta * Z.
//
// What bounds it on the card: bytes.  Each output element costs ndiag
// multiply-adds and reads ndiag weights (shared by the q columns) and ndiag
// operand values (mostly cache hits).  At the main path's shapes (Rail
// surrogate, N = 79841, 5 diagonals, q = 6..96 columns, f64) one call must
// move 3.2 MB of weights plus q * 1.3 MB of operand and result: 64.5 MB at
// q = 48 (19.3 us at 3.35 TB/s), 12 MB at q = 7.  What keeps a simple
// kernel far from that is memory parallelism and coalescing: one thread per
// row walking all q columns in a runtime loop has only ndiag loads in
// flight, each behind a branch, and in the row-major (N, q) layout its
// lanes read with stride q.
//
// Design: two kernels, chosen by the operand's layout, both with element
// strides for both axes (any layout is correct in either; the choice only
// decides which axis lies along the lanes).
//  * dia_rows_kernel (the problem axis has unit stride: the lane-major
//    (q, N) Krylov state and (N, q) views of it, and any other strides):
//    a 2-D grid, row tiles of DIA_THREADS along x and groups of DIA_COLS
//    columns along y.  A thread loads its weights once per chunk of
//    diagonals, then issues DIA_COLS x D independent loads, fully unrolled;
//    lanes run along i, so every load and store is coalesced.
//  * dia_flat_kernel (the column axis has unit stride: row-major (N, q)
//    factors): the (i, c) pairs are flattened with c fastest, one per
//    thread, so the reads of X[(i + off) * q + c] are contiguous per
//    diagonal and data[d, i] is a broadcast.
// No vector loads: rows of a (q, N) tensor start at 8-byte boundaries for
// odd N, so lanes on neighbouring scalars are the coalesced form that every
// layout allows.  Loads of X outside [0, N) are clamped and their products
// take zero, so no halo-padded copy of the operand exists (the TPU kernel
// built one on every call because BlockSpec cannot express overlapping
// blocks).  The sum runs over d = 0..ndiag-1 in order, as the plain
// PyTorch version does; only FMA contraction differs.  Up to DIA_MAX_DIAGS
// diagonals are taken in chunks whose partial sums stay in registers.

#include <cuda_runtime.h>

#define DIA_MAX_DIAGS 64
#define DIA_THREADS 256
#define DIA_COLS 2      // columns per thread in dia_rows_kernel

struct DiaOffsets {
    int off[DIA_MAX_DIAGS];
};

// Both kernels take the diagonals in chunks of D (a template constant: 3,
// 5 or 8, the smallest that holds them, or 8 for more than 8).  Every load
// of a chunk is unconditional, so all of them can be in flight at once:
// addresses outside [0, N), beyond the last row or column or beyond the
// last diagonal are clamped to real ones, and the multiply-adds then take
// zero for the operand (outside [0, N), as the plain version's zero
// padding does) or are skipped (padding of the last chunk).

template <typename T, int D, int C, bool AXPBY>
__global__ void __launch_bounds__(DIA_THREADS)
dia_rows_kernel(const T* __restrict__ data, DiaOffsets offs, int ndiag,
                const T* __restrict__ x, long long x_si, long long x_sc,
                T* __restrict__ y, long long y_si, long long y_sc,
                const T* __restrict__ z, long long z_si, long long z_sc,
                T alpha, T beta, int N, int q) {
    const int i_out = blockIdx.x * DIA_THREADS + threadIdx.x;
    const int i = min(i_out, N - 1);
    const int c0 = blockIdx.y * C;
    long long xc[C];
    T acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        xc[c] = (long long)min(c0 + c, q - 1) * x_sc;
        acc[c] = T(0);
    }
    for (int d0 = 0; d0 < ndiag; d0 += D) {
        T w[D], xv[C][D];
        long long j[D];
        bool inside[D];
#pragma unroll
        for (int t = 0; t < D; ++t) {
            const int d = min(d0 + t, ndiag - 1);
            const int jj = i + offs.off[d];
            inside[t] = jj >= 0 && jj < N;
            j[t] = (long long)min(max(jj, 0), N - 1) * x_si;
            w[t] = data[(long long)d * N + i];
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
            for (int t = 0; t < D; ++t) xv[c][t] = x[j[t] + xc[c]];
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
            for (int t = 0; t < D; ++t)
                if (d0 + t < ndiag) acc[c] += w[t] * (inside[t] ? xv[c][t] : T(0));
    }
    if (i_out >= N) return;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        if (c0 + c < q) {
            T v = acc[c];
            if (AXPBY) v = alpha * v + beta * z[(long long)i * z_si + (long long)(c0 + c) * z_sc];
            y[(long long)i * y_si + (long long)(c0 + c) * y_sc] = v;
        }
    }
}

template <typename T, int D, bool AXPBY>
__global__ void __launch_bounds__(DIA_THREADS)
dia_flat_kernel(const T* __restrict__ data, DiaOffsets offs, int ndiag,
                const T* __restrict__ x, long long x_si, long long x_sc,
                T* __restrict__ y, long long y_si, long long y_sc,
                const T* __restrict__ z, long long z_si, long long z_sc,
                T alpha, T beta, int N, int q) {
    const unsigned total = (unsigned)N * (unsigned)q;  // < 2^31 (launch checks)
    const unsigned e_out = blockIdx.x * DIA_THREADS + threadIdx.x;
    const unsigned e = min(e_out, total - 1);
    const int i = (int)(e / (unsigned)q);
    const long long xc = (long long)(e - (unsigned)i * (unsigned)q) * x_sc;
    T acc = T(0);
    for (int d0 = 0; d0 < ndiag; d0 += D) {
        T w[D], xv[D];
        bool inside[D];
#pragma unroll
        for (int t = 0; t < D; ++t) {
            const int d = min(d0 + t, ndiag - 1);
            const int jj = i + offs.off[d];
            inside[t] = jj >= 0 && jj < N;
            w[t] = data[(long long)d * N + i];
            xv[t] = x[(long long)min(max(jj, 0), N - 1) * x_si + xc];
        }
#pragma unroll
        for (int t = 0; t < D; ++t)
            if (d0 + t < ndiag) acc += w[t] * (inside[t] ? xv[t] : T(0));
    }
    if (e_out >= total) return;
    const long long c = e - (unsigned)i * (unsigned)q;
    if (AXPBY) acc = alpha * acc + beta * z[(long long)i * z_si + c * z_sc];
    y[(long long)i * y_si + c * y_sc] = acc;
}

template <typename T, int D, bool AXPBY>
static void launch_variant(const T* data, const DiaOffsets& offs, int ndiag,
                           const T* x, long long x_si, long long x_sc,
                           T* y, long long y_si, long long y_sc,
                           const T* z, long long z_si, long long z_sc,
                           T alpha, T beta, int N, int q, cudaStream_t s) {
    const bool flat = x_sc == 1 && x_si != 1 && (long long)N * q < (1LL << 31);
    if (flat) {
        const dim3 grid((unsigned)(((long long)N * q + DIA_THREADS - 1) / DIA_THREADS));
        dia_flat_kernel<T, D, AXPBY><<<grid, DIA_THREADS, 0, s>>>(
            data, offs, ndiag, x, x_si, x_sc, y, y_si, y_sc, z, z_si, z_sc,
            alpha, beta, N, q);
    } else {
        const dim3 grid((unsigned)((N + DIA_THREADS - 1) / DIA_THREADS),
                        (unsigned)((q + DIA_COLS - 1) / DIA_COLS));
        dia_rows_kernel<T, D, DIA_COLS, AXPBY><<<grid, DIA_THREADS, 0, s>>>(
            data, offs, ndiag, x, x_si, x_sc, y, y_si, y_sc, z, z_si, z_sc,
            alpha, beta, N, q);
    }
}

template <typename T, bool AXPBY>
static void launch_chunked(const T* data, const DiaOffsets& offs, int ndiag,
                           const T* x, long long x_si, long long x_sc,
                           T* y, long long y_si, long long y_sc,
                           const T* z, long long z_si, long long z_sc,
                           T alpha, T beta, int N, int q, cudaStream_t s) {
    if (ndiag <= 3) {
        launch_variant<T, 3, AXPBY>(data, offs, ndiag, x, x_si, x_sc, y, y_si, y_sc,
                                    z, z_si, z_sc, alpha, beta, N, q, s);
    } else if (ndiag <= 5) {
        launch_variant<T, 5, AXPBY>(data, offs, ndiag, x, x_si, x_sc, y, y_si, y_sc,
                                    z, z_si, z_sc, alpha, beta, N, q, s);
    } else {
        launch_variant<T, 8, AXPBY>(data, offs, ndiag, x, x_si, x_sc, y, y_si, y_sc,
                                    z, z_si, z_sc, alpha, beta, N, q, s);
    }
}

template <typename T>
static int launch(const T* data, const int* offsets, int ndiag,
                  const T* x, long long x_si, long long x_sc,
                  T* y, long long y_si, long long y_sc,
                  const T* z, long long z_si, long long z_sc,
                  double alpha, double beta, int N, int q, void* stream) {
    if (ndiag < 1 || ndiag > DIA_MAX_DIAGS || N < 1 || q < 1 || q > 65535 * DIA_COLS) {
        return (int)cudaErrorInvalidValue;
    }
    DiaOffsets offs;
    for (int d = 0; d < DIA_MAX_DIAGS; ++d) offs.off[d] = d < ndiag ? offsets[d] : 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (z != nullptr) {
        launch_chunked<T, true>(data, offs, ndiag, x, x_si, x_sc, y, y_si, y_sc,
                                z, z_si, z_sc, (T)alpha, (T)beta, N, q, s);
    } else {
        launch_chunked<T, false>(data, offs, ndiag, x, x_si, x_sc, y, y_si, y_sc,
                                 nullptr, 0, 0, (T)alpha, (T)beta, N, q, s);
    }
    return (int)cudaGetLastError();
}

// Plain C interface (loaded with ctypes).  `data` is (ndiag, N) with row
// stride N; `offsets` is a host array of ndiag ints; X, Y and Z are
// addressed as base[i * s_i + c * s_c] for problem index i and column c.
// `z` may be null (no epilogue).  Returns the CUDA error code of the launch.
extern "C" int dia_spmm_f64(const void* data, const int* offsets, int ndiag,
                            const void* x, long long x_si, long long x_sc,
                            void* y, long long y_si, long long y_sc,
                            const void* z, long long z_si, long long z_sc,
                            double alpha, double beta, int N, int q,
                            void* stream) {
    return launch<double>((const double*)data, offsets, ndiag,
                          (const double*)x, x_si, x_sc, (double*)y, y_si, y_sc,
                          (const double*)z, z_si, z_sc, alpha, beta, N, q, stream);
}

extern "C" int dia_spmm_f32(const void* data, const int* offsets, int ndiag,
                            const void* x, long long x_si, long long x_sc,
                            void* y, long long y_si, long long y_sc,
                            const void* z, long long z_si, long long z_sc,
                            double alpha, double beta, int N, int q,
                            void* stream) {
    return launch<float>((const float*)data, offsets, ndiag,
                         (const float*)x, x_si, x_sc, (float*)y, y_si, y_sc,
                         (const float*)z, z_si, z_sc, alpha, beta, N, q, stream);
}
