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
// operand values (mostly cache hits: neighbouring threads read neighbouring
// addresses of the same rows).  At the main path's shapes (Rail surrogate,
// n = 79841, 5 diagonals, q = 7..96 columns, f64) one call moves 3 MB of
// weights plus q * 1.3 MB of operand and result: 12 MB at q = 7, 64 MB at
// q = 48, against a 50 MB L2.  At small q the launch latency is of the same
// order as the transfer.
//
// Design: one thread per problem index i.  The thread loads its weights and
// neighbour indices for up to DIA_CHUNK diagonals into registers once, then
// loops over the q right-hand-side columns.  Loads of X outside [0, N) are
// masked in place, so no halo-padded copy of the operand exists (the TPU
// kernel had to build one on every call because BlockSpec cannot express
// overlapping blocks).  The kernel takes element strides for the problem
// axis and the column axis, so one kernel serves the lane-major (q, N)
// Krylov state and the column-major (N, q) factors without transposes.
// The sum runs over d = 0..ndiag-1 in order, as the plain PyTorch version
// does; only FMA contraction differs.  More than DIA_CHUNK diagonals are
// handled in chunks whose partial sums pass through Y (same thread, same
// order).

#include <cuda_runtime.h>

#define DIA_MAX_DIAGS 64
#define DIA_CHUNK 16
#define DIA_THREADS 256

struct DiaOffsets {
    int off[DIA_MAX_DIAGS];
};

template <typename T, bool AXPBY>
__global__ void __launch_bounds__(DIA_THREADS)
dia_spmm_kernel(const T* __restrict__ data, DiaOffsets offs, int ndiag,
                const T* __restrict__ x, long long x_si, long long x_sc,
                T* __restrict__ y, long long y_si, long long y_sc,
                const T* __restrict__ z, long long z_si, long long z_sc,
                T alpha, T beta, int N, int q) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    for (int d0 = 0; d0 < ndiag; d0 += DIA_CHUNK) {
        const int dn = min(DIA_CHUNK, ndiag - d0);
        const bool first = d0 == 0;
        const bool last = d0 + DIA_CHUNK >= ndiag;
        T w[DIA_CHUNK];
        long long j[DIA_CHUNK];
        bool inside[DIA_CHUNK];
#pragma unroll
        for (int t = 0; t < DIA_CHUNK; ++t) {
            if (t < dn) {
                w[t] = data[(long long)(d0 + t) * N + i];
                j[t] = i + offs.off[d0 + t];
                inside[t] = j[t] >= 0 && j[t] < N;
            }
        }
        for (int c = 0; c < q; ++c) {
            const long long yo = i * y_si + (long long)c * y_sc;
            T acc = first ? T(0) : y[yo];
#pragma unroll
            for (int t = 0; t < DIA_CHUNK; ++t) {
                if (t < dn) {
                    const T xv = inside[t] ? x[j[t] * x_si + (long long)c * x_sc] : T(0);
                    acc += w[t] * xv;
                }
            }
            if (AXPBY && last) {
                acc = alpha * acc + beta * z[i * z_si + (long long)c * z_sc];
            }
            y[yo] = acc;
        }
    }
}

template <typename T>
static int launch(const T* data, const int* offsets, int ndiag,
                  const T* x, long long x_si, long long x_sc,
                  T* y, long long y_si, long long y_sc,
                  const T* z, long long z_si, long long z_sc,
                  double alpha, double beta, int N, int q, void* stream) {
    if (ndiag < 1 || ndiag > DIA_MAX_DIAGS || N < 1 || q < 1) {
        return (int)cudaErrorInvalidValue;
    }
    DiaOffsets offs;
    for (int d = 0; d < DIA_MAX_DIAGS; ++d) offs.off[d] = d < ndiag ? offsets[d] : 0;
    const dim3 grid((unsigned)((N + DIA_THREADS - 1) / DIA_THREADS));
    const dim3 block(DIA_THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (z != nullptr) {
        dia_spmm_kernel<T, true><<<grid, block, 0, s>>>(
            data, offs, ndiag, x, x_si, x_sc, y, y_si, y_sc, z, z_si, z_sc,
            (T)alpha, (T)beta, N, q);
    } else {
        dia_spmm_kernel<T, false><<<grid, block, 0, s>>>(
            data, offs, ndiag, x, x_si, x_sc, y, y_si, y_sc, nullptr, 0, 0,
            (T)alpha, (T)beta, N, q);
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
